"""Job manager for the web service: queue of upscale jobs, one at a time.

The port's copy of reve_tpu/service/jobs.py.  The reference GUI processes
a multi-selection of videos sequentially, one subprocess at a time
(reve-gui/src/pages/Index.vue:340-353); here jobs run sequentially on a
worker thread through the job body the CLI and the API run
(pipeline/job.py: fresh state, resume contract, engine, run), so a
service job's output is the CLI job's on the same input and settings.

Threads: the engine is built and used on the worker thread; the HTTP
threads only read job state.  Engines are cached by (model, scale, dtype,
int8_calib, tta) for the manager's life, each holding its weights (and
plans) in device memory, as reve_tpu's cache does.  The default factory
builds the port's engine on cuda:0 (the manager's `device`; "cpu" only
where asked for); without CUDA a job errors, it never drifts onto the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import threading
import traceback
from typing import Dict, List, Optional

from reve_tpu_torch.pipeline.progress import ProgressTracker
from reve_tpu_torch.pipeline.state import Workspace


def replace_file_suffix(path: str, factor: int, ext: str = "mp4") -> str:
    """'<stem>.<old>' -> '<stem>_upscaled-{N}x.<ext>' — the reference GUI's
    output naming rule (reve-gui/src-tauri/src/utils.rs:53-57)."""
    stem = os.path.splitext(path)[0]
    return f"{stem}_upscaled-{factor}x.{ext}"


@dataclasses.dataclass
class Job:
    id: int
    input_path: str
    output_path: str
    model: str
    scale: int
    #: auto (default: bfloat16 on CUDA, the certified int8 turbo where
    #: REVE_TPU_AUTO_INT8 makes it eligible — resolved to a concrete
    #: dtype when the job starts) | bfloat16 | float32 | int8
    dtype: str = "auto"
    #: int8 only: calibration statistic ("p<percentile>" or "max")
    int8_calib: str = "p99.9"
    #: 8-transform dihedral self-ensemble (~8x compute)
    tta: bool = False
    status: str = "queued"    # queued | running | done | error | cancelled
    cancel_requested: bool = False
    error: str = ""
    #: --dtype auto resolution notes (which path was chosen and why)
    dtype_note: str = ""
    #: int8 turbo only: measured quantization PSNR (dB) vs f32 on frames
    #: sampled across this video
    int8_psnr: Optional[float] = None
    progress: Optional[ProgressTracker] = None
    result: Optional[dict] = None
    pipeline: object = None   # live PipelineJob while running
    part_ext: str = ".mp4"

    @property
    def workspace_path(self) -> str:
        return os.path.abspath(self.output_path) + ".revework"

    def committed_parts(self) -> list:
        """Progressive output: segment part files already committed to the
        workspace (streamable while the job is still running)."""
        ws = Workspace(self.workspace_path)
        try:
            idxs = ws.completed_parts(self.part_ext)
        except OSError:
            return []
        out = []
        for i in idxs:
            p = ws.part_path(i, self.part_ext)
            try:
                out.append({"index": i, "path": p,
                            "size": os.path.getsize(p)})
            except OSError:
                pass
        return out

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "input": self.input_path,
            "output": self.output_path,
            "model": self.model,
            "scale": self.scale,
            "dtype": self.dtype,
            "int8_calib": self.int8_calib,
            "tta": self.tta,
            "status": self.status,
            "error": self.error,
            "dtype_note": self.dtype_note,
            "int8_psnr": self.int8_psnr,
            "progress": self.progress.snapshot() if self.progress else None,
            "result": self.result,
        }


class JobManager:
    def __init__(self, service_cfg, engine_factory=None, io_backend=None,
                 device=None):
        """`device`: None (cuda:0), a CUDA index or name, or "cpu" (the
        kernels' plain versions; tests): where the default factory builds
        engines, and the platform `--dtype auto` resolves for."""
        self.cfg = service_cfg
        self.engine_factory = engine_factory or self._default_engine_factory
        self.io_backend = io_backend
        self.device = device
        self.jobs: Dict[int, Job] = {}
        self._engines: Dict[tuple, object] = {}
        self._order: List[int] = []
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._worker = threading.Thread(
            target=self._run_loop, name="reve-jobs", daemon=True
        )
        self._worker.start()

    def _default_engine_factory(self, model: str, scale: int,
                                dtype: str = "bfloat16",
                                int8_calib: str = "p99.9",
                                tta: bool = False):
        from reve_tpu_torch.pipeline.engine import UpscaleEngine

        return UpscaleEngine(model=model, scale=scale, compute_dtype=dtype,
                             int8_calib=int8_calib, tta=tta,
                             device=self.device)

    def _get_engine(self, model: str, scale: int, dtype: str = "bfloat16",
                    int8_calib: str = "p99.9", tta: bool = False):
        """Engines are reused across jobs of the same (model, scale, dtype,
        calib, tta): a fresh engine per job would load and cast the
        weights again for every queue entry.

        Custom engine factories with fewer parameters (tests/plugins) keep
        working for the default dtype/calib; a non-default value with such
        a factory is an explicit error rather than a silent fallback."""
        key = (model, scale, dtype, int8_calib, tta)
        engine = self._engines.get(key)
        if engine is None:
            import inspect

            factory = self.engine_factory
            try:
                sig = inspect.signature(factory)
            except (TypeError, ValueError):  # builtins: assume full arity
                sig = None
            # call with the longest positional prefix the factory can BIND
            # (robust to *args/**kwargs and defaults, unlike a raw
            # parameter count); refusing to silently drop a non-default
            # setting stays an explicit error
            for call in ((model, scale, dtype, int8_calib, tta),
                         (model, scale, dtype, int8_calib),
                         (model, scale, dtype),
                         (model, scale)):
                if sig is not None:
                    try:
                        sig.bind(*call)
                    except TypeError:
                        continue
                if len(call) < 5 and tta:
                    raise ValueError(
                        f"engine_factory {factory!r} does not accept a "
                        f"tta argument; cannot run a tta job")
                # int8_calib only matters when the job actually runs int8;
                # the engine's own default is p99.9, so a short factory
                # can still serve default-calibration int8 jobs
                if len(call) < 4 and dtype == "int8" and \
                        int8_calib != "p99.9":
                    raise ValueError(
                        f"engine_factory {factory!r} does not accept an "
                        f"int8_calib argument; cannot run an "
                        f"int8_calib={int8_calib!r} job")
                if len(call) < 3 and dtype != "bfloat16":
                    raise ValueError(
                        f"engine_factory {factory!r} does not accept a "
                        f"dtype argument; cannot run a {dtype} job")
                engine = factory(*call)
                break
            else:
                raise TypeError(
                    f"engine_factory {factory!r} must accept "
                    f"(model, scale[, dtype[, int8_calib[, tta]]])")
            self._engines[key] = engine
        return engine

    def submit(self, input_path: str, scale: Optional[int] = None,
               model: Optional[str] = None,
               output_path: Optional[str] = None,
               dtype: Optional[str] = None,
               int8_calib: Optional[str] = None,
               tta: bool = False) -> Job:
        scale = scale or self.cfg.default_scale
        model = model or self.cfg.default_upscale_type
        if dtype not in (None, "auto", "bfloat16", "float32", "int8"):
            raise ValueError(f"invalid dtype {dtype!r}")
        if int8_calib is not None:
            from reve_tpu_torch.pipeline.engine import parse_int8_calib

            parse_int8_calib(int8_calib)  # raises ValueError -> HTTP 400
        if not isinstance(tta, bool):
            raise ValueError(f"tta must be a boolean, got {tta!r}")
        output_path = output_path or replace_file_suffix(input_path, scale)
        with self._lock:
            job = Job(
                id=next(self._ids), input_path=input_path,
                output_path=output_path, model=model, scale=scale,
                dtype=dtype or "auto",
                int8_calib=int8_calib or "p99.9",
                tta=tta,
            )
            self.jobs[job.id] = job
            self._order.append(job.id)
        self._wake.set()
        return job

    def list_jobs(self) -> List[dict]:
        with self._lock:
            return [self.jobs[i].to_json() for i in self._order]

    def get(self, job_id: int) -> Optional[Job]:
        return self.jobs.get(job_id)

    def cancel(self, job_id: int) -> bool:
        """Cancel a queued or running job; completed parts remain so the
        job can be re-submitted and resume."""
        job = self.jobs.get(job_id)
        if job is None:
            return False
        with self._lock:
            if job.status == "queued":
                job.status = "cancelled"
                return True
        if job.status == "running":
            # the flag covers the probe/engine-build window before
            # job.pipeline is set, and lets the worker classify the
            # outcome as a user cancellation
            job.cancel_requested = True
            if job.pipeline is not None:
                job.pipeline.cancel()
            return True
        return False

    def shutdown(self):
        self._stop = True
        self._wake.set()

    # -- worker ------------------------------------------------------------

    def _next_queued(self) -> Optional[Job]:
        """Claim the next queued job: the queued->running transition
        happens under the lock, so a concurrent cancel() can never be
        overwritten by the worker."""
        with self._lock:
            for jid in self._order:
                if self.jobs[jid].status == "queued":
                    self.jobs[jid].status = "running"
                    return self.jobs[jid]
        return None

    def _run_loop(self):
        while not self._stop:
            job = self._next_queued()
            if job is None:
                self._wake.wait(timeout=0.2)
                self._wake.clear()
                continue
            try:
                job.result = self._run_job(job)
                job.status = "done"
            except Exception as e:  # surfaced via the API
                if job.cancel_requested:
                    job.status = "cancelled"
                else:
                    job.error = f"{e}\n{traceback.format_exc(limit=3)}"
                    job.status = "error"
            finally:
                job.pipeline = None

    def _run_job(self, job: Job) -> dict:
        from reve_tpu_torch import device as device_mod
        from reve_tpu_torch.pipeline import job as job_mod
        from reve_tpu_torch.pipeline import scheduler

        device = device_mod.resolve_device(self.device)
        ws = Workspace(job.workspace_path)
        if not ws.acquire_owner():
            raise RuntimeError(
                f"another live process (e.g. a CLI run) owns this "
                f"workspace ({ws.owner_path}); wait for it to finish")
        settings = argparse.Namespace(
            weights=None, weights_wdn=None, denoise=None, dtype=job.dtype,
            int8_calib=job.int8_calib, tta=job.tta,
            io_backend=self.io_backend, allow_random_init=False)
        try:
            if ws.has_state():
                # re-submitted after cancel/crash: resume from completed
                # parts with the settings the job was STARTED with
                # (job.restore: dtype, int8_calib, tta, io_backend; a
                # workspace of another package is refused)
                st = ws.load()
                if st.model != job.model or st.scale != job.scale:
                    raise RuntimeError(
                        f"workspace {ws.root!r} holds progress for model "
                        f"{st.model!r} x{st.scale}; resubmit with the same "
                        f"settings to resume, or remove the workspace/choose "
                        f"another output to start fresh")
                if st.opts.get("weights") or \
                        st.opts.get("denoise") is not None:
                    # the service's engines load the registry's weights:
                    # resumed segments would not match the committed ones
                    raise RuntimeError(
                        f"workspace {ws.root!r} was started with --weights "
                        f"or --denoise; resume it with the CLI and its "
                        f"original flags, or remove the workspace to start "
                        f"fresh")
                st = job_mod.restore(ws, st, settings, job.model)
                job.dtype, job.int8_calib, job.tta = (
                    settings.dtype, settings.int8_calib, settings.tta)
            else:
                st = job_mod.fresh(
                    ws, settings, input_path=job.input_path,
                    output_path=job.output_path, scale=job.scale,
                    segment_size=self.cfg.segment_size, model=job.model,
                    encode={"crf": self.cfg.crf, "preset": self.cfg.preset})
            job.part_ext = job_mod.part_ext(settings.io_backend)
            ws.save(st)
            notes = []

            def note(msg: str) -> None:
                notes.append(msg)
                job.dtype_note = "; ".join(notes)

            engine, db = job_mod.open_engine(
                ws, st, settings, device, on_note=note,
                make_engine=lambda d, c: self._get_engine(
                    job.model, job.scale, d, c, settings.tta))
            job.dtype = settings.dtype
            if db is not None and job.dtype == "int8":
                # int8_psnr means "ran the turbo, certified N dB"; a bf16
                # fallback's measured dB lives in dtype_note
                job.int8_psnr = round(db, 2)
            if job.dtype == "int8" and job.int8_psnr is None:
                # the quantization cost on THIS video, with the job's
                # persisted scales (the CLI's --dtype int8 report), before
                # the pipeline: certification calibrates as a side effect
                try:
                    db = scheduler.certify_int8_on_input(
                        engine, ws, st, io_backend=settings.io_backend)
                    if db is not None:
                        job.int8_psnr = round(db, 2)
                    ws.save(st)  # persist the sampled calib_frames
                except Exception:
                    pass  # certification must never fail the job
            job.progress = ProgressTracker(
                total_frames=sum(s.size for s in st.pending),
                total_segments=len(st.pending),
                source_fps=st.fps_num / max(st.fps_den, 1),
            )

            def attach(pipeline) -> None:
                job.pipeline = pipeline
                if job.cancel_requested:  # cancelled before the pipeline
                    pipeline.cancel()

            _, report = job_mod.run(ws, st, engine, settings,
                                    progress=job.progress,
                                    on_pipeline=attach)
            return report
        finally:
            ws.release_owner()
