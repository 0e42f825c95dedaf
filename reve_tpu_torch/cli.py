"""Drop-in compatible CLI of the PyTorch/CUDA port.

Counterpart of reve_tpu/cli.py with the same argv surface, defaults and
exit codes (flag-for-flag parity with the reference CLI,
reve-shared/src/lib.rs:209-280):

    reve -i <input.mp4|mkv|y4m> -s {2,3,4} [-S segsize] [-c crf] [-p preset]
         [-x x265params] <output.mp4|mkv|y4m>
    reve -i <image.png|bmp|jpg|webp> -s N <output image>     (image mode)
    reve -i <dir of images> -s N <output dir> [-f png|jpg|webp]

Image and directory modes are reve_tpu's (io/image.py routes gray, BGRA
and 16-bit images through the RGB engine, one frame at a time): PNG and
BMP by the port's own codecs, JPEG and WebP only where cv2 imports (else
exit 2 naming the format, before any engine is built).

The port carries the video job: fresh and resumed runs, --dtype
auto|float32|bfloat16|int8 (auto = bfloat16 on CUDA, as reve_tpu's rule
has it off the TPU; int8 with SRVGG and with the RRDB models),
--int8-calib, --int8-gate, --model/--weights/-m (SRVGG from .pth or the
reference's ncnn .param/.bin, and RRDB from .pth at x4:
realesrgan-x4plus, realesrgan-x4plus-anime, realesrnet-x4plus, and x2:
realesrgan-x2plus), --denoise D with --weights-wdn (the weights
interpolated as (1 - D) wdn + D plain, restored on resume), --batch,
--tile N (halo tiles, for SRVGG byte-identical to whole frames; 0 = only
frames past the memory plan, -1 = never), --tta (the 8-transform
self-ensemble, restored on resume), --scene-align (segments snapped to
scene cuts; a resume keeps the saved plan), --device N (cuda:N) or
--device N,M,... (a mesh: each batch split over those devices, one engine
replica each; --batch a multiple of their count), --shard-worker ID and
--lease-stale-after S (the job's segments shared with other processes
through lease files in the workspace, pipeline/leases.py; no single-owner
lock; exactly one worker finalizes), --io-backend, --workspace, --yes,
--keep-workspace, --progress-json, --trace and --profile-dir
(torch.profiler).  --compile-attempts (the JAX package's XLA guard) exits
2: it has no counterpart here and is never silently ignored.

The job's body (the resume contract, the fresh state, the engine, the
run) is `pipeline/job.py`, which `api.upscale_video` shares.  A workspace
records the package that started it (state.opts["backend"]); the port
resumes only its own, so one output never mixes segments of two
implementations.

`run(argv, device=None)`: the `device` keyword is for callers and tests
(e.g. device="cpu"); --device on the command line wins.  With neither,
the job runs on cuda:0 and raises NoCudaDeviceError without CUDA.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional

from reve_tpu_torch.pipeline import job as job_mod
from reve_tpu_torch.pipeline.job import BACKEND  # noqa: F401 (re-export)
from reve_tpu_torch.pipeline.state import Workspace


PRESETS = (
    "ultrafast", "superfast", "veryfast", "faster", "fast", "medium",
    "slow", "slower", "veryslow",
)
VIDEO_EXTS = (".mp4", ".mkv")
#: single-image mode: the surface of the engine reve_tpu replaces
#: (realesrgan-ncnn-vulkan upscales images, `-i in.jpg -o out.png`)
IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")
#: the refusal of --int8-gate in the image modes
IMAGE_GATE = ("--int8-gate applies to video jobs (image mode does not run "
              "certification)")


def _input_validation(s: str) -> str:
    if not os.path.exists(s):
        raise argparse.ArgumentTypeError("input path not found")
    if os.path.isdir(s):
        # directory of images -> batch image mode; content checked in
        # _run_image_dir so the error can name the directory
        return s
    if not s.lower().endswith(VIDEO_EXTS + (".y4m",) + IMAGE_EXTS):
        raise argparse.ArgumentTypeError(
            "valid input formats: mp4/mkv (videos), png/jpg/webp/bmp "
            "(images), or a directory of images"
        )
    return s


def _scale_validation(s: str) -> int:
    v = int(s)
    if v not in (2, 3, 4):
        raise argparse.ArgumentTypeError("upscale ratio must be 2, 3 or 4")
    return v


def _positive_int(name):
    def check(s: str) -> int:
        v = int(s)
        if v <= 0:
            raise argparse.ArgumentTypeError(f"{name} must be positive")
        return v
    return check


def _positive_float(name):
    def check(s: str) -> float:
        v = float(s)
        if v <= 0:
            raise argparse.ArgumentTypeError(f"{name} must be positive")
        return v
    return check


def _crf_validation(s: str) -> int:
    v = int(s)
    if not 0 <= v <= 51:
        raise argparse.ArgumentTypeError("crf must be in 0..51")
    return v


def _int8_calib_validation(s: str) -> str:
    """The grammar the engine accepts ("max" or "p<percentile>")."""
    from reve_tpu_torch.pipeline.engine import parse_int8_calib

    try:
        parse_int8_calib(s)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))
    return s


def _preset_validation(s: str) -> str:
    if s not in PRESETS:
        raise argparse.ArgumentTypeError(
            "valid: " + "/".join(PRESETS)
        )
    return s


def build_parser() -> argparse.ArgumentParser:
    from reve_tpu_torch.version import __version__

    p = argparse.ArgumentParser(
        prog="reve",
        description="Real-ESRGAN video upscaler with resumability "
                    "(PyTorch/CUDA port)",
    )
    p.add_argument("--version", action="version",
                   version=f"reve-tpu-torch {__version__}")
    p.add_argument("-i", "--inputpath", required=True,
                   type=_input_validation, help="input video path (mp4/mkv)")
    p.add_argument("outputpath", help="output video path (mp4/mkv)")
    p.add_argument("-s", "--scale", required=True, type=_scale_validation,
                   help="upscale ratio (2, 3, 4)")
    # the reference's README documents -P while its clap derive implements
    # -S (README.md:54 vs reve-shared/src/lib.rs:220); accept both
    p.add_argument("-S", "-P", "--segmentsize",
                   type=_positive_int("segment size"), default=1000,
                   help="segment size (in frames)")
    p.add_argument("-c", "--crf", type=_crf_validation, default=15,
                   help="video constant rate factor (crf: 51-0)")
    p.add_argument("-p", "--preset", type=_preset_validation, default="slow",
                   help="video encoding preset")
    p.add_argument("-x", "--x265params",
                   default="psy-rd=2:aq-strength=1:deblock=0,0:bframes=8",
                   help="x265 encoding parameters")
    # --- extensions ---
    p.add_argument("--model", default="realesr-animevideov3")
    p.add_argument("--weights", default=None,
                   help="path to .pth weights or an ncnn .param "
                        "(its .bin beside it; SRVGG models)")
    p.add_argument("--weights-wdn", default=None,
                   help="denoise-variant .pth for --denoise interpolation")
    p.add_argument("--denoise", type=float, default=None, metavar="D",
                   help="denoise strength 0..1 (needs --weights and "
                        "--weights-wdn; dni interpolation, (1 - D) * wdn + "
                        "D * plain)")
    p.add_argument("--batch", type=_positive_int("batch"), default=4,
                   help="frames per GPU batch")
    p.add_argument("--tile", type=int, default=0,
                   help="tile size (0=auto, -1=never tile)")
    p.add_argument("--dtype",
                   choices=("auto", "bfloat16", "float32", "int8"),
                   default="auto",
                   help="compute dtype.  auto (default): the int8 turbo "
                        "where it is eligible (TPUs in reve_tpu's rule, or "
                        "REVE_TPU_AUTO_INT8=1) and certifies at 50 dB (or "
                        "--int8-gate) vs float32 on frames sampled across "
                        "this video, else bfloat16; on CUDA auto is "
                        "bfloat16 (and for RRDB in both packages).  int8 "
                        "forces the turbo path (SRVGG: hidden stack and "
                        "head conv in s8; RRDB: the dense-block trunk)")
    p.add_argument("--int8-calib", type=_int8_calib_validation,
                   default=None, dest="int8_calib", metavar="max|p<PCT>",
                   help="int8 calibration statistic for activation "
                        "scales: p<percentile> of |activation| (default "
                        "p99.9) or max")
    p.add_argument("--tta", action="store_true",
                   help="8-transform self-ensemble: the model runs on "
                        "all 8 rotations/flips of each frame and the "
                        "outputs are averaged (8x the model work)")
    p.add_argument("--int8-gate", type=float, default=None, metavar="DB",
                   help="minimum int8-vs-f32 PSNR (dB) measured on frames "
                        "sampled across this video.  With --dtype auto: "
                        "overrides the 50 dB turbo-selection gate.  With "
                        "--dtype int8: refuse to run below DB, exit 3 (the "
                        "turbo PSNR is always reported)")
    p.add_argument("--device", default=None, metavar="N[,M,...]",
                   help="run on CUDA device N (cuda:N; the replaced ncnn "
                        "engine's -g gpu-id, e.g. one --shard-worker per "
                        "card).  A comma list builds a data-parallel mesh "
                        "over those devices (the ncnn engine's multi-GPU "
                        "`-g 0,1,...`): each batch of frames is split "
                        "across them, so --batch must be a multiple of "
                        "the device count")
    p.add_argument("-f", "--format", choices=("png", "jpg", "webp"),
                   default=None,
                   help="image output format for directory mode (the "
                        "replaced ncnn engine's -f switch; default: keep "
                        "each input's extension); in single-image mode it "
                        "must match the output's extension")
    p.add_argument("-m", "--models-dir", default=None, metavar="DIR",
                   dest="models_dir",
                   help="directory searched for --model's weights "
                        "(<name>.pth or <name>.param + .bin).  Replaces "
                        "the default search path ($REVE_TPU_MODELS_DIR, "
                        "then ./models); an "
                        "explicit --weights wins")
    p.add_argument("--allow-random-init", action="store_true",
                   dest="allow_random_init",
                   help="run with deterministic RANDOM weights when no "
                        "trained weights resolve for --model (tests/"
                        "benchmarks only: the output will NOT be a trained "
                        "upscale).  Without this flag (or "
                        "REVE_TPU_ALLOW_RANDOM_INIT=1) a job with no "
                        "weights refuses to start")
    p.add_argument("--compile-attempts", type=_positive_int(
                   "compile-attempts"), default=None, metavar="N",
                   help="best-of-N XLA compiles (the JAX package's TPU "
                        "compile-lottery guard; no counterpart here)")
    p.add_argument("--io-backend", choices=("ffmpeg", "cv2", "y4m"),
                   default=None)
    p.add_argument("--workspace", default=None,
                   help="resume workspace dir (default: <output>.revework)")
    p.add_argument("--yes", action="store_true",
                   help="resume without asking (non-interactive)")
    p.add_argument("--keep-workspace", action="store_true",
                   help="do not delete the workspace after success")
    p.add_argument("--scene-align", action="store_true",
                   help="snap segment boundaries to detected scene cuts")
    p.add_argument("--progress-json", default=None, metavar="FILE",
                   help="append machine-readable JSON progress snapshots "
                        "to FILE (one object per line)")
    p.add_argument("--trace", default=None, metavar="FILE",
                   help="write JSONL stage-timing events to FILE")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="capture a torch.profiler trace into DIR")
    p.add_argument("--shard-worker", default=None, metavar="ID",
                   help="participate as a lease-queue worker (segments "
                        "shared by several processes over one workspace, "
                        "on one host or several); the worker that finds "
                        "all parts complete finalizes")
    p.add_argument("--lease-stale-after",
                   type=_positive_float("lease-stale-after"), default=None,
                   metavar="SECONDS",
                   help="declare a worker's segment lease stale (stealable) "
                        "after this many seconds without a heartbeat "
                        "(default 600; leases renew every few seconds while "
                        "a worker is alive)")
    return p


def _refuse_unported(args) -> Optional[int]:
    """Exit code 2 for a flag with no counterpart in the port."""
    if args.compile_attempts is not None:
        print("--compile-attempts has no counterpart in reve_tpu_torch "
              "(the JAX package's XLA compile-lottery guard)",
              file=sys.stderr)
        return 2
    return None


def _confirm(prompt: str, assume_yes: bool) -> bool:
    """Explicit consent, mirroring the reference's interactive confirms
    (reve-cli/src/main.rs:47-90).  A non-interactive run (no tty) must not
    silently resume or discard prior work: it aborts unless --yes was
    given."""
    if assume_yes:
        return True
    if not sys.stdin.isatty():
        raise SystemExit(
            f"{prompt} — non-interactive session; pass --yes to confirm"
        )
    answer = input(f"{prompt} [Y/n] ").strip().lower()
    return answer in ("", "y", "yes")


def _resolve_device(args, device):
    """--device N -> cuda:N; --device N,M,... -> a parallel.mesh.Mesh of
    cuda:N, cuda:M, ... (the ncnn engine's multi-GPU `-g 0,1,...`: the
    engine splits each batch over them), its --batch a multiple of their
    count; else the caller's `device`; else None (the engine's default,
    cuda:0).  Returns (device, mesh, error_exit_code); at most one of
    device and mesh is set.  Refusals are reve_tpu's words."""
    if args.device is None:
        return device, None, None
    try:
        idxs = [int(t) for t in str(args.device).split(",") if t.strip()]
    except ValueError:
        print(f"--device must be a device index or comma list of "
              f"indices, got {args.device!r}", file=sys.stderr)
        return None, None, 2
    if not idxs:
        print("--device needs at least one device index", file=sys.stderr)
        return None, None, 2
    import torch

    n = torch.cuda.device_count()
    for i in idxs:
        if not 0 <= i < n:
            print(f"--device {i} out of range: this host has {n} CUDA "
                  f"device(s)", file=sys.stderr)
            return None, None, 2
    if len(set(idxs)) != len(idxs):
        print("--device indices must be distinct", file=sys.stderr)
        return None, None, 2
    if len(idxs) == 1:
        return f"cuda:{idxs[0]}", None, None
    if args.batch % len(idxs):
        print(f"--batch {args.batch} must be a multiple of the --device "
              f"count ({len(idxs)}) so each device gets the same share of "
              f"every batch", file=sys.stderr)
        return None, None, 2
    from reve_tpu_torch.parallel.mesh import Mesh

    return None, Mesh([f"cuda:{i}" for i in idxs]), None


def run(argv: Optional[List[str]] = None, device=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if "--list-models" in argv:
        from reve_tpu_torch.models import registry

        dirs = None
        for i, a in enumerate(argv):
            if a in ("-m", "--models-dir") and i + 1 < len(argv):
                dirs = [argv[i + 1]]
            elif a.startswith("--models-dir="):
                dirs = [a.split("=", 1)[1]]
        for name, spec in registry.list_models():
            scales = spec.upscale or "2|3|4"
            found = [s for s in ([spec.upscale] if spec.upscale
                                 else (2, 3, 4))
                     if registry.resolve_weights(name, s, dirs)]
            w = (f"weights: x{'/x'.join(map(str, found))}" if found
                 else "weights: none (jobs refuse to start; "
                      "--allow-random-init to override)")
            print(f"{name}  [{spec.arch}, x{scales}]  {w}")
        return 0
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    err = _refuse_unported(args)
    if err is not None:
        return err
    err = _apply_models_dir(args)
    if err is not None:
        return err
    err = _require_weights(args)
    if err is not None:
        return err
    if args.denoise is not None and not (args.weights and args.weights_wdn):
        # (a resumed job's saved settings are checked in job.open_engine)
        print(job_mod.DENOISE_NEEDS, file=sys.stderr)
        return 2
    if args.dtype not in ("int8", "auto") and args.int8_calib is not None:
        print("--int8-calib requires --dtype int8 or auto (it configures "
              "the int8 turbo path only)", file=sys.stderr)
        return 2
    image_input = os.path.isdir(args.inputpath) or \
        args.inputpath.lower().endswith(IMAGE_EXTS)
    if args.int8_calib is not None and args.dtype == "auto" and image_input:
        # image modes resolve auto to the exact path (no certification on
        # stills), so an explicit calibration knob would configure nothing
        print("--int8-calib has no effect in image mode unless --dtype "
              "int8 forces the turbo path (auto runs the exact path on "
              "stills)", file=sys.stderr)
        return 2
    args.int8_calib = args.int8_calib or "p99.9"
    if os.path.isdir(args.inputpath):
        if args.int8_gate is not None:
            print(IMAGE_GATE, file=sys.stderr)
            return 2
        return _run_image_dir(args, device)
    if os.path.exists(args.outputpath):
        print("output path already exists", file=sys.stderr)
        return 2
    if args.dtype not in ("int8", "auto") and args.int8_gate is not None:
        # a silently ignored quality gate is worse than no gate
        print("--int8-gate requires --dtype int8 or auto (it gates the "
              "int8 turbo path only)", file=sys.stderr)
        return 2
    if image_input:
        if args.int8_gate is not None:
            print(IMAGE_GATE, file=sys.stderr)
            return 2
        return _run_image(args, device)
    if args.format is not None:
        print("--format applies to image/directory modes (video output "
              "format follows the output extension)", file=sys.stderr)
        return 2
    if not args.outputpath.lower().endswith(VIDEO_EXTS + (".y4m",)):
        print("valid output formats: mp4/mkv", file=sys.stderr)
        return 2
    if args.inputpath.lower().endswith(".mkv") and \
            not args.outputpath.lower().endswith(".mkv"):
        # reference refuses mkv -> mp4 (reve-cli/src/main.rs:124-140)
        print("mkv input requires mkv output", file=sys.stderr)
        return 2

    # resolve the device (and a mesh's --batch multiple) BEFORE any
    # workspace exists: a rejected invocation must not leave behind a
    # fresh state file
    device, mesh, err = _resolve_device(args, device)
    if err is not None:
        return err
    if mesh is None:
        from reve_tpu_torch import device as device_mod

        device = device_mod.resolve_device(device)

    ws = Workspace(args.workspace or args.outputpath + ".revework")
    # single-writer guard: a second concurrent run on this workspace would
    # redo every pending segment and race the finalize rename; cooperating
    # writers run as --shard-worker (the lease queue) and take no lock
    if not args.shard_worker and not ws.acquire_owner():
        print(f"another live process is already working on this "
              f"workspace ({ws.owner_path}); wait for it to finish "
              f"or run both as --shard-worker", file=sys.stderr)
        return 2
    try:
        return _run_job(args, ws, device, mesh)
    except job_mod.JobRefused as e:
        print(e, file=sys.stderr)
        return e.code
    finally:
        if not args.shard_worker:
            ws.release_owner()


def _run_job(args, ws: Workspace, device, mesh=None) -> int:
    """The job in `ws` (owned, or shared by shard workers): resume or
    start it, then run it through pipeline/job.py; returns the exit code
    (refusals raise JobRefused)."""
    import time as _time

    from reve_tpu_torch.pipeline.progress import (ConsoleRenderer,
                                                  JsonlRenderer,
                                                  ProgressTracker,
                                                  TeeRenderer)
    from reve_tpu_torch.utils import trace as trace_mod

    def note(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    if ws.has_state() and _confirm("found an interrupted job — resume?",
                                   args.yes):
        state = job_mod.restore(ws, ws.load(), args, args.model,
                                on_note=note)
        if state.scale != args.scale:
            # the reference resumes with its SAVED args wholesale
            # (main.rs:92-101); we match that but say so
            note(f"resume: using saved -s {state.scale} (command line "
                 f"said {args.scale})")
        if args.int8_gate is not None and \
                args.dtype not in ("int8", "auto"):
            # the saved job is not int8: certification never runs
            print("--int8-gate was requested but this workspace's "
                  f"saved job runs --dtype {args.dtype}; resume "
                  "without the gate, or start fresh to run int8",
                  file=sys.stderr)
            return 2
        note(f"resuming: {len(state.pending)} segment(s) remaining")
    else:
        if ws.has_state():
            if not _confirm("discard previous progress and start over?",
                            args.yes):
                return 1
            err = _require_weights(args, skip_if_resumable=False)
            if err is not None:
                return err
        state = job_mod.fresh(
            ws, args, input_path=args.inputpath,
            output_path=args.outputpath, scale=args.scale,
            segment_size=args.segmentsize, model=args.model,
            encode={"crf": args.crf, "preset": args.preset,
                    "x265_params": args.x265params},
            scene_align=args.scene_align, on_note=note)
    ws.save(state)

    tracer = trace_mod.Tracer(args.trace) if args.trace else \
        trace_mod.from_env()
    resolve_t0 = _time.monotonic()
    auto = args.dtype == "auto"
    engine, int8_db = job_mod.open_engine(
        ws, state, args, device, mesh=mesh, batch=args.batch,
        tile=args.tile, gate_db=args.int8_gate, on_note=note, tracer=tracer)
    resolve_s = _time.monotonic() - resolve_t0 if auto else None
    if args.dtype == "int8" and int8_db is None:
        err, int8_db = _certify_int8(args, state, engine, ws)
        if err is not None:
            return err
    if args.dtype == "int8":
        tracer.event("int8", db=int8_db,
                     calibrate_s=engine.stats.calibrate_s,
                     certify_s=engine.stats.certify_s)
    renderer = ConsoleRenderer()
    jsonl = JsonlRenderer(args.progress_json) if args.progress_json \
        else None
    tracker = ProgressTracker(
        total_frames=sum(s.size for s in state.pending),
        total_segments=len(state.pending),
        on_update=TeeRenderer(renderer, jsonl),
        source_fps=state.fps_num / max(state.fps_den, 1),
    )
    run_t0 = _time.monotonic()
    try:
        state, report = job_mod.run(
            ws, state, engine, args, progress=tracker, tracer=tracer,
            profile_dir=args.profile_dir,
            keep_workspace=args.keep_workspace,
            shard_worker=args.shard_worker,
            stale_after=args.lease_stale_after, on_note=note)
    except KeyboardInterrupt:
        # committed parts + state are already on disk (checkpoint
        # after every segment)
        done = len(ws.completed_parts(_part_ext(args)))
        print(f"\ninterrupted — {done} segment(s) committed; rerun the "
              f"same command to resume", file=sys.stderr)
        return 130
    if report is None:
        return 0  # a shard worker that leaves the output to another
    enc_note = f", encoder: {report['encoder']}" if "encoder" in report \
        else ""
    # end-to-end x-realtime for the frames THIS run processed
    rate_note = ""
    elapsed = _time.monotonic() - run_t0
    done_frames = tracker.stages["encode"].done
    src_fps = state.fps_num / max(state.fps_den, 1)
    if elapsed > 0 and done_frames and src_fps > 0:
        e2e_fps = done_frames / elapsed
        rate_note = (f", {e2e_fps:.3g} fps end-to-end = "
                     f"{e2e_fps / src_fps:.3g}x realtime")
    # the compute path and its certificate belong in the done-line
    path_note = f", path: {args.dtype}"
    if args.dtype == "int8" and int8_db is not None:
        path_note = f", path: int8 turbo ({int8_db:.1f} dB certified)"
    if resolve_s is not None:
        path_note += f", auto-resolve {resolve_s:.1f} s"
    print(f"\ndone: {state.output_path} (concat backend: "
          f"{report['backend']}{enc_note}{path_note} on "
          f"{engine.mesh or engine.device}{rate_note})", file=sys.stderr)
    return 0


def _certify_int8(args, state, engine, ws: Workspace):
    """Report (and with --int8-gate, enforce) the int8 turbo's PSNR vs
    float32 on frames sampled across THIS video, with the scales the job
    runs with (persisted in `ws`, so a resume certifies identically).
    Returns (exit_code_or_None, measured_db_or_None)."""
    from reve_tpu_torch.pipeline import scheduler

    try:
        db = scheduler.certify_int8_on_input(engine, ws, state,
                                             io_backend=args.io_backend)
        if db is None:
            return None, None
    except Exception as e:
        if args.int8_gate is not None:
            # an explicit gate fails CLOSED: an unmeasured PSNR cannot
            # clear it
            print(f"refusing: int8 certification failed ({e}) and "
                  f"--int8-gate {args.int8_gate:g} demands a measured "
                  f"PSNR — run without --dtype int8 or without the gate",
                  file=sys.stderr)
            # a shard worker's workspace is shared (leases, calibration,
            # sibling parts): never deleted under live workers
            if not args.shard_worker and \
                    not ws.completed_parts(_part_ext(args)):
                ws.destroy()
            return 3, None
        print(f"int8 certification skipped: {e}", file=sys.stderr)
        return None, None
    ws.save(state)  # persist the sampled indices (opts["calib_frames"])
    n = len(state.opts.get("calib_frames") or ()) or \
        min(engine.batch_size, state.frame_count)
    print(f"int8 turbo: {db:.1f} dB vs f32 on {n} frame(s) sampled "
          f"across the video (quality gate reference: 50 dB)",
          file=sys.stderr)
    if args.int8_gate is not None and db < args.int8_gate:
        print(f"refusing: int8 PSNR {db:.1f} dB is below --int8-gate "
              f"{args.int8_gate:g} — run without --dtype int8 (or lower "
              f"the gate)", file=sys.stderr)
        if not args.shard_worker and \
                not ws.completed_parts(_part_ext(args)):
            ws.destroy()  # nothing committed: leave no resume prompt
        return 3, db
    return None, db


def _require_weights(args, skip_if_resumable: bool = True) -> Optional[int]:
    """Exit 2 for a job with no weights that did not opt into random init
    (--allow-random-init / REVE_TPU_ALLOW_RANDOM_INIT=1), BEFORE any
    workspace/probe/decode (job.missing_weights).

    `skip_if_resumable`: an existing interrupted workspace defers the check
    to the resume path (the saved opts are the contract)."""
    if skip_if_resumable and \
            not args.inputpath.lower().endswith(IMAGE_EXTS) and \
            not os.path.isdir(args.inputpath) and Workspace(
                args.workspace or args.outputpath + ".revework").has_state():
        return None
    msg = job_mod.missing_weights(args.model, args.scale, args.weights,
                                  args.allow_random_init)
    if msg is None:
        return None
    print(msg, file=sys.stderr)
    return 2


def _apply_models_dir(args) -> Optional[int]:
    """--models-dir DIR: resolve --model's weights from DIR into
    args.weights.  An explicitly named directory with no matching weights
    is an error."""
    if args.models_dir is None or args.weights:
        return None
    if not os.path.isdir(args.models_dir):
        print(f"--models-dir {args.models_dir!r} is not a directory",
              file=sys.stderr)
        return 2
    from reve_tpu_torch.models import registry

    w = registry.resolve_weights(args.model, args.scale,
                                 [args.models_dir])
    if w is None:
        print(f"no weights for {args.model!r} (x{args.scale}) in "
              f"{args.models_dir!r} (expected <name>.pth or "
              f"<name>.param + .bin)", file=sys.stderr)
        return 2
    args.weights = w
    return None


def _image_engine(args, device):
    """Build the (shared) engine for image mode on one device; returns
    (engine, err)."""
    if args.device is not None and \
            len([t for t in str(args.device).split(",") if t.strip()]) > 1:
        print("image mode runs one frame at a time on one device; pass "
              "a single --device index", file=sys.stderr)
        return None, 2
    device, _mesh, err = _resolve_device(args, device)
    if err is not None:
        return None, err
    preloaded = None
    if args.denoise is not None:
        from reve_tpu_torch.weights.interpolate import load_dni

        preloaded = load_dni(args.weights_wdn, args.weights, args.denoise)
    from reve_tpu_torch.pipeline.engine import UpscaleEngine

    # image modes run the exact path under --dtype auto: per-content
    # certification is a video-job contract (sampled frames), and a still
    # image is too small to amortize calibration
    dtype = "bfloat16" if args.dtype == "auto" else args.dtype
    return UpscaleEngine(
        model=args.model, scale=args.scale, weights=args.weights,
        batch_size=1, tile=args.tile, compute_dtype=dtype,
        int8_calib=args.int8_calib, tta=args.tta, device=device,
        preloaded=preloaded,
        allow_random_init=args.allow_random_init or None,
    ), None


def _run_image(args, device) -> int:
    """Single-image upscale: the replaced engine's own surface
    (realesrgan-ncnn-vulkan `-i in.jpg -o out.png`).  Grayscale, alpha and
    16-bit layouts route through io/image.py."""
    from reve_tpu_torch.io import image as image_mod

    if not args.outputpath.lower().endswith(IMAGE_EXTS):
        print("image input requires an image output "
              "(png/jpg/webp/bmp)", file=sys.stderr)
        return 2
    if args.format is not None and not _format_matches(
            args.outputpath, args.format):
        # the output path names the format in single-file mode; writing
        # <fmt> bytes under a different extension would lie to every
        # later consumer of the file
        print(f"--format {args.format} conflicts with the output "
              f"extension {os.path.splitext(args.outputpath)[1]!r}; in "
              f"single-image mode the output path decides the format",
              file=sys.stderr)
        return 2
    try:
        img = image_mod.imread(args.inputpath)
    except ValueError as e:  # a refused codec or feature, named
        print(str(e), file=sys.stderr)
        return 2
    if img is None:
        print(f"cannot decode image {args.inputpath!r}", file=sys.stderr)
        return 2
    try:
        mode = image_mod.classify(img)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    if mode == "bgra" and not image_mod.alpha_ok(args.outputpath):
        print("input has an alpha channel; output must be png/webp "
              "to keep it", file=sys.stderr)
        return 2
    msg = image_mod.codec_missing(args.outputpath)
    if msg is not None:
        print(msg, file=sys.stderr)
        return 2
    engine, err = _image_engine(args, device)
    if err is not None:
        return err
    msg, dims = image_mod.upscale_image_file(
        engine, args.inputpath, args.outputpath, img=img)
    if msg is not None:
        print(msg, file=sys.stderr)
        return 2
    print(f"done: {args.outputpath} ({dims[0]}x{dims[1]})",
          file=sys.stderr)
    return 0


def _run_image_dir(args, device) -> int:
    """Directory batch: `-i <dir> -s N <outdir>` upscales every image in
    <dir> (the replaced ncnn engine accepts folders for -i/-o).  One
    engine is shared across files; existing outputs are SKIPPED so an
    interrupted batch re-run continues where it stopped.  Alpha images
    whose extension cannot carry alpha are written as .png with a note."""
    from reve_tpu_torch.io import image as image_mod

    files = sorted(
        f for f in os.listdir(args.inputpath)
        if f.lower().endswith(IMAGE_EXTS)
        and os.path.isfile(os.path.join(args.inputpath, f))
    )
    if not files:
        print(f"no images (png/jpg/webp/bmp) in {args.inputpath!r}",
              file=sys.stderr)
        return 2
    if os.path.isfile(args.outputpath):
        print("output for a directory input must be a directory",
              file=sys.stderr)
        return 2
    if os.path.realpath(args.outputpath) == \
            os.path.realpath(args.inputpath):
        # outputs would collide with the inputs themselves: every target
        # "already exists" and the whole batch silently skips
        print("output directory must differ from the input directory",
              file=sys.stderr)
        return 2
    fmt = args.format
    # a JPEG or WebP file to read or write without cv2: refused before
    # any engine is built
    for name in files + ([f"*.{fmt}"] if fmt else []):
        msg = image_mod.codec_missing(name)
        if msg is not None:
            print(msg, file=sys.stderr)
            return 2
    os.makedirs(args.outputpath, exist_ok=True)
    engine, err = _image_engine(args, device)
    if err is not None:
        return err
    #: owner of each default output name: when --format maps two stems
    #: onto one name, the input whose filename already IS that name owns
    #: it (its output must not be shadowed — the skip-exists check would
    #: silently never upscale it), then sorted-first; everyone else
    #: diverts to <name>.<fmt>
    owner = {}
    for f in files:
        ident = (os.path.splitext(f)[0] + "." + fmt) if fmt else f
        cur = owner.get(ident)
        if cur is None or (f == ident and cur != ident):
            owner[ident] = f
    claimed = set()
    done = failed = skipped = 0
    for name in files:
        in_path = os.path.join(args.inputpath, name)
        stem = os.path.splitext(name)[0]
        own = (stem + "." + fmt) if fmt else name
        out_name = own if owner[own] == name else name + "." + fmt
        if out_name != own:
            print(f"{name}: output name taken -> writing {out_name}",
                  file=sys.stderr)
        try:
            img, err_msg = image_mod.imread(in_path), None
        except ValueError as e:  # a refused feature, named
            img, err_msg = None, str(e)
        if img is not None and img.ndim == 3 and img.shape[2] == 4 \
                and not image_mod.alpha_ok(out_name):
            retarget = stem + ".png"
            if (retarget in owner and owner[retarget] != name) \
                    or retarget in claimed:
                # a sibling input already owns that name — keep the
                # original filename so nothing is shadowed or skipped
                retarget = name + ".png"
            out_name = retarget
            print(f"{name}: alpha channel -> writing {out_name}",
                  file=sys.stderr)
        claimed.add(out_name)
        out_path = os.path.join(args.outputpath, out_name)
        if os.path.exists(out_path):
            skipped += 1
            continue
        msg = err_msg
        if msg is None:
            msg, _ = image_mod.upscale_image_file(engine, in_path, out_path,
                                                  img=img)
        if msg is None:
            done += 1
            print(f"[{done + failed}/{len(files)}] {name}",
                  file=sys.stderr)
        else:
            failed += 1
            print(f"[{done + failed}/{len(files)}] {name}: {msg}",
                  file=sys.stderr)
    summary = f"done: {done} upscaled"
    if skipped:
        summary += f", {skipped} already present (skipped)"
    if failed:
        summary += f", {failed} FAILED"
    print(summary, file=sys.stderr)
    return 0 if not failed else 2


def _format_matches(path: str, fmt: str) -> bool:
    """Does `path`'s extension name the same encoding as --format `fmt`?
    (jpg and jpeg are the same encoder)."""
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    return ext == fmt or (fmt == "jpg" and ext == "jpeg")


def _part_ext(args) -> str:
    return job_mod.part_ext(args.io_backend)


def main() -> None:
    from reve_tpu_torch.device import NoCudaDeviceError

    try:
        sys.exit(run())
    except NoCudaDeviceError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(2)


if __name__ == "__main__":
    main()
