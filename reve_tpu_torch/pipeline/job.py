"""One video job's body, shared by the CLI (`cli.run`), the library
(`api.upscale_video`) and the web service (`service/jobs.py`): the
weights pre-flight, the resume contract, the fresh job state, the engine
and its resolved dtype, the pipeline run and finalize.  The callers keep
only their own surface: the CLI parses argv, asks before resuming,
certifies int8 and turns refusals into exit codes; the API raises; the
service queues jobs, caches engines by their settings and reports
progress.

A job's settings are an object with the attributes of `RESTORED` (the
CLI's argparse namespace, or the API's own): they are saved in
`state.opts` when the job starts, and a resume sets them back to the
saved values, so that resumed segments go through the same weights,
dtype, ensemble and container as the committed ones (the reference's
resume contract, reve-cli/src/main.rs:92-101): `--denoise` jobs restore
their two weight files and strength, and a scene-aligned job its saved
segment plan (`state.plan`).  A workspace records the
package that started it (`state.opts["backend"]`); the port resumes only
its own, so one output never mixes segments of two implementations.

A shard worker (`run(shard_worker=ID)`, the CLI's --shard-worker) shares
the job's segments with other processes, on this host or others, through
the lease files of pipeline/leases.py in the workspace: claim, run,
heartbeat, release, until none is left; exactly one worker that finds
every part committed wins the finalize election and writes the output.
A shard worker never removes the shared workspace.
"""

from __future__ import annotations

import os
from fractions import Fraction
from typing import Callable, Optional

from reve_tpu_torch.pipeline.planner import plan_segments
from reve_tpu_torch.pipeline.state import JobState, Workspace, repair_pending

#: the package's stamp in state.opts["backend"]
BACKEND = "reve_tpu_torch"
#: the settings a job is started with and a resume restores
RESTORED = ("weights", "weights_wdn", "denoise", "dtype", "int8_calib",
            "tta", "io_backend", "allow_random_init")


#: the refusal of --denoise without both weight files (reve_tpu's words)
DENOISE_NEEDS = "--denoise requires --weights and --weights-wdn"


class JobRefused(ValueError):
    """The job cannot run as asked; `code` is the CLI's exit code for it
    (2: a refused request)."""

    def __init__(self, msg: str, code: int = 2):
        super().__init__(msg)
        self.code = code


def part_ext(io_backend: Optional[str]) -> str:
    return ".y4m" if io_backend == "y4m" else ".mp4"


def missing_weights(model: str, scale: int, weights: Optional[str],
                    allow_random_init) -> Optional[str]:
    """The message for a job with no weights that did not opt into random
    init (argument or REVE_TPU_ALLOW_RANDOM_INIT), else None.  Weights are
    a product requirement: a random-init 'upscale' is hours of compute
    emitting plausible-looking garbage, so it is an explicit opt-in, never
    a fallback."""
    from reve_tpu_torch.models import registry

    if weights or registry.random_init_allowed(
            True if allow_random_init else None):
        return None
    if registry.resolve_weights(model, scale) is not None:
        return None
    spec, _ = registry.parse_model_name(model)
    stem = spec.canonical if spec.upscale is not None else \
        f"{spec.canonical}-x{scale}"
    return registry.missing_weights_message(model, scale, stem)


def restore(ws: Workspace, state: JobState, settings, model: str,
            on_note: Optional[Callable[[str], None]] = None) -> JobState:
    """Resume `state` (loaded from `ws`): refuse a workspace another
    package started or one of another model than `model`, set `settings`
    back to the saved ones (saying so through `on_note` where the caller
    asked for others), recreate the workspace keeping its parts and
    return the state with its pending segments repaired (from its saved
    plan, which a scene-aligned job cannot re-derive)."""
    if state.opts.get("backend") != BACKEND:
        # the other package's segments (or calibration) must never be
        # joined to this one's in one output
        started = state.opts.get("backend") or \
            "another implementation (reve_tpu)"
        raise JobRefused(
            f"this workspace was started by {started}, not {BACKEND}: "
            f"resuming it would mix segments of two implementations in one "
            f"output; start the job fresh (remove {ws.root})")
    if state.model != model:
        raise JobRefused(f"workspace holds progress for model "
                         f"{state.model!r}; resume with the same model or "
                         f"start fresh (remove {ws.root})")
    # state files from before these were saved ran without random-init
    # opt-in only if they named weights, without the ensemble and without
    # --denoise
    state.opts.setdefault("allow_random_init", not state.opts.get("weights"))
    state.opts.setdefault("tta", False)
    state.opts.setdefault("weights_wdn", None)
    state.opts.setdefault("denoise", None)
    for key in RESTORED:
        if key not in state.opts or getattr(settings, key) == state.opts[key]:
            continue
        if on_note is not None:
            if key == "dtype" and settings.dtype == "auto":
                on_note(f"resume: continuing on the saved "
                        f"--dtype={state.opts[key]!r} path")
            else:
                on_note(f"resume: using saved --{key.replace('_', '-')}"
                        f"={state.opts[key]!r} (command line said "
                        f"{getattr(settings, key)!r})")
        setattr(settings, key, state.opts[key])
    ws.create(keep_parts=True)
    return repair_pending(state, ws, ext=part_ext(settings.io_backend))


def fresh(ws: Workspace, settings, *, input_path: str, output_path: str,
          scale: int, segment_size: int, model: str, encode: dict,
          scene_align: bool = False,
          on_note: Optional[Callable[[str], None]] = None) -> JobState:
    """Probe the input and start a job: an empty workspace and the state
    with its segment plan and `settings` saved.  `scene_align`: the plan's
    boundaries snap to the scene cuts a pre-pass over the whole clip
    finds (pipeline/scenes.py), said through `on_note`."""
    from reve_tpu_torch.io import probe
    from reve_tpu_torch.models import registry

    info = probe.probe(input_path, backend=settings.io_backend)
    if info.frame_count <= 0:
        raise JobRefused(f"could not determine frame count of "
                         f"{input_path!r}", code=1)
    fps = info.fps or Fraction(30, 1)
    if scene_align:
        from reve_tpu_torch.pipeline import scenes

        pending = scenes.plan_for_video(input_path, settings.io_backend,
                                        info, segment_size)
        if on_note is not None:
            on_note(f"scene-align: {len(pending)} segment(s) planned")
    else:
        pending = plan_segments(info.frame_count, segment_size)
    ws.create(keep_parts=False)
    opts = {key: getattr(settings, key) for key in RESTORED}
    # persist the random-init opt-in (argument or environment): a resume
    # continues the decision the job was started with
    opts.update(backend=BACKEND, allow_random_init=bool(
        registry.random_init_allowed(
            True if settings.allow_random_init else None)))
    return JobState(
        input_path=os.path.abspath(input_path),
        output_path=os.path.abspath(output_path),
        scale=scale,
        segment_size=segment_size,
        frame_count=info.frame_count,
        fps_num=fps.numerator,
        fps_den=fps.denominator,
        width=info.width,
        height=info.height,
        pending=pending,
        plan=list(pending),
        encode=encode,
        model=model,
        opts=opts,
    )


def open_engine(ws: Workspace, state: JobState, settings, device, *,
                mesh=None, batch: int = 4, tile: int = 0, gate_db=None,
                on_note=None, tracer=None, make_engine=None):
    """The job's engine at `settings`, on `device` or, given `mesh`, on
    its devices; `--dtype auto` resolves here (the
    resolved dtype is saved, so that a resume runs the same path) and
    `settings.dtype` becomes it.  With `settings.denoise` the engine runs
    the weights interpolated from `settings.weights_wdn` and
    `settings.weights` (weights/interpolate.py).  `make_engine(dtype,
    int8_calib)`: the caller's engines (the service's cache) in place of
    a new UpscaleEngine on `device` at `batch` and `tile`.  Returns
    (engine, int8 dB certified by the auto rule or None)."""
    from reve_tpu_torch.pipeline import scheduler
    from reve_tpu_torch.pipeline.engine import UpscaleEngine

    preloaded = None
    if settings.denoise is not None:
        from reve_tpu_torch.weights.interpolate import load_dni

        if not (settings.weights and settings.weights_wdn):
            raise JobRefused(DENOISE_NEEDS)

        preloaded = load_dni(settings.weights_wdn, settings.weights,
                             settings.denoise)
        if preloaded[0].upscale != state.scale:
            raise JobRefused(f"--denoise weights are "
                             f"x{preloaded[0].upscale} but -s {state.scale} "
                             f"was requested")

    def new_engine(dtype: str, int8_calib: str) -> UpscaleEngine:
        return UpscaleEngine(
            model=state.model, scale=state.scale, weights=settings.weights,
            batch_size=batch, tile=tile, compute_dtype=dtype,
            int8_calib=int8_calib, tta=settings.tta,
            device=None if mesh is not None else device, mesh=mesh,
            preloaded=preloaded,
            allow_random_init=settings.allow_random_init or None)

    make_engine = make_engine or new_engine
    if settings.dtype != "auto":
        return make_engine(settings.dtype, settings.int8_calib), None
    settings.dtype, engine, int8_db, notes = scheduler.resolve_auto_dtype(
        make_engine, ws, state, io_backend=settings.io_backend,
        gate_db=gate_db,
        platform=(mesh.devices[0] if mesh is not None else device).type,
        on_note=on_note,
        tracer=tracer)
    if on_note is not None:
        for msg in notes:
            on_note(msg)
    state.opts["dtype"] = settings.dtype
    state.opts["int8_calib"] = settings.int8_calib
    ws.save(state)
    if engine is None:
        engine = make_engine(settings.dtype, settings.int8_calib)
    return engine, int8_db


def run(ws: Workspace, state: JobState, engine, settings, *, progress=None,
        tracer=None, profile_dir: Optional[str] = None,
        keep_workspace: bool = False, on_pipeline=None,
        shard_worker: Optional[str] = None,
        stale_after: Optional[float] = None, on_note=None):
    """Run the pending segments and finalize the output; destroys the
    workspace unless `keep_workspace`.  Returns (state, report):
    finalize's report with the job's "dtype" and, when known, its
    "encoder".  On KeyboardInterrupt the pipeline is cancelled (committed
    parts and the state are already on disk) and the interrupt raised.
    `on_pipeline(job)` receives the scheduler.PipelineJob before it runs
    (the service cancels a job through it).

    `shard_worker`: run as the lease-queue worker of that id instead
    (run_shard, `stale_after` its lease timeout, None the default 600 s);
    its report is None when another worker finalizes."""
    from reve_tpu_torch.pipeline import scheduler
    from reve_tpu_torch.utils import trace as trace_mod

    ext = part_ext(settings.io_backend)
    if shard_worker is not None:
        return run_shard(ws, state, engine, settings, shard_worker,
                         stale_after=stale_after, progress=progress,
                         tracer=tracer, profile_dir=profile_dir,
                         on_note=on_note)
    job = scheduler.PipelineJob(state, ws, engine,
                                io_backend=settings.io_backend,
                                part_ext=ext, progress=progress,
                                tracer=tracer)
    if on_pipeline is not None:
        on_pipeline(job)
    try:
        with trace_mod.device_profile(profile_dir):
            state = job.run()
    except KeyboardInterrupt:
        job.cancel()
        raise
    report = scheduler.finalize(state, ws, io_backend=settings.io_backend,
                                part_ext=ext)
    report["dtype"] = settings.dtype
    if job.encoder_desc:
        report["encoder"] = job.encoder_desc
    if not keep_workspace:
        ws.destroy()
    return state, report


def run_shard(ws: Workspace, state: JobState, engine, settings,
              worker_id: str, *, stale_after: Optional[float] = None,
              progress=None, tracer=None, profile_dir: Optional[str] = None,
              on_note=None):
    """The job's segments as lease-queue worker `worker_id`
    (leases.run_sharded: claim, run, heartbeat, release), then, when
    every part is committed and this worker wins the finalize election,
    the output.  Says through `on_note` how many segments it ran and,
    when it does not finalize, why (reve_tpu's lines).  The workspace is
    kept either way: other workers may still read it.  Returns (state,
    report), report None when this worker does not finalize."""
    import dataclasses

    from reve_tpu_torch.pipeline import leases, scheduler
    from reve_tpu_torch.utils import trace as trace_mod

    def note(msg: str) -> None:
        if on_note is not None:
            on_note(msg)

    ext = part_ext(settings.io_backend)
    stale = leases.DEFAULT_STALE_AFTER if stale_after is None \
        else stale_after
    queue = leases.SegmentLeaseQueue(ws, worker_id, stale_after=stale,
                                     part_ext=ext)
    with trace_mod.device_profile(profile_dir):
        done = leases.run_sharded(
            state, ws, engine, worker_id, io_backend=settings.io_backend,
            part_ext=ext, progress=progress, stale_after=stale,
            tracer=tracer, queue=queue)
    note(f"worker {worker_id}: {done} segment(s)")
    if not queue.all_done(state.pending):
        note("other workers still running; not finalizing")
        return state, None
    # every worker that observes all_done reaches here: exactly one
    # finalizes (O_EXCL finalize lease; stale and no output: stealable)
    if not queue.claim_finalize(state.output_path):
        note("another worker is finalizing; exiting")
        return state, None
    state = dataclasses.replace(state, pending=[])
    report = scheduler.finalize(state, ws, io_backend=settings.io_backend,
                                part_ext=ext)
    report["dtype"] = settings.dtype
    return state, report
