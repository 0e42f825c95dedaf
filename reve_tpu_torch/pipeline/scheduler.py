"""The overlapped decode -> upscale -> encode pipeline.

Counterpart of reve_tpu/pipeline/scheduler.py on the CUDA engine, with
its int8 calibration and certification helpers and `resolve_auto_dtype`.
The auto rule is the reference's: the int8 turbo is eligible on TPUs only
(or where REVE_TPU_AUTO_INT8 forces it), so on CUDA `--dtype auto`
resolves bfloat16 without certification until a measured rule for the
H100 replaces it (ROADMAP.md).

This is the rebuild of the reference's hot loop (reve-cli/src/main.rs:172-350):
there, while segment k upscales on the GPU, segment k+1 is being ffmpeg-
exported on one thread and segment k-1 x265-encoded on another, with
filesystem PNG directories as the hand-off medium and thread::join as the
synchronization.

Here the stages are connected by bounded in-memory queues with backpressure:

    [decode thread] --decode_q--> [main: engine.submit] --encode_q--> [encode thread]

  * decode thread: sequentially reads pending segments' frame ranges,
    batches them (engine.batch_size frames per item).
  * main thread: submits batches to the GPU; `submit` returns immediately
    (async dispatch), so the queue depth of in-flight device batches (not
    host threads) is what overlaps H2D/compute/D2H.
  * encode thread: blocks on each batch's device result, feeds the segment's
    encoder; at segment end commits the part file atomically and persists
    resume state — the reference's per-segment checkpoint
    (main.rs:340-343), made crash-atomic.  Before the first batch the
    engine is asked for the YUV 4:2:0 planes the parts' writer takes
    (y4m: BT.601 at the job's bits; ffmpeg: BT.709 10-bit; cv2: RGB), so
    the device converts (K9) and this thread only writes bytes.

The GPU sets the pace exactly like the reference's GPU does (SURVEY.md §3.3):
if decode is slow the GPU starves (queue empty), if encode is slow
backpressure stalls submission (queue full) — both visible in the progress
rates.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from fractions import Fraction
from typing import Optional

import numpy as np

from reve_tpu_torch.io import concat as concat_mod
from reve_tpu_torch.io import reader as reader_mod
from reve_tpu_torch.io import writer as writer_mod
from reve_tpu_torch.ops.color_np import Planes
from reve_tpu_torch.pipeline.engine import UpscaleEngine, WidthNotServed
from reve_tpu_torch.pipeline.progress import ProgressTracker
from reve_tpu_torch.pipeline.state import JobState, Workspace

log = logging.getLogger(__name__)

_SENTINEL = None


@dataclasses.dataclass
class _DecodedBatch:
    seg_index: int
    frames: np.ndarray          # (n, H, W, 3) uint8
    last_of_segment: bool


@dataclasses.dataclass
class _InferredBatch:
    seg_index: int
    pending: object             # PendingBatch
    last_of_segment: bool


class PipelineError(RuntimeError):
    pass


#: frames sampled (evenly spaced across the whole video) by
#: sample_frame_indices — the calibration and certification sample of the
#: int8 path
CALIB_SAMPLE_FRAMES = 16

#: --dtype auto runs the int8 turbo only when its on-content int8-vs-f32
#: certification clears this PSNR (dB): BASELINE.json's quality gate
AUTO_INT8_GATE_DB = 50.0


def sample_frame_indices(frame_count: int,
                         k: int = CALIB_SAMPLE_FRAMES) -> list:
    """k (or fewer) frame indices evenly spaced across [0, frame_count):
    midpoint-rule strata, deduplicated, ascending.  Pure function of
    frame_count — every worker/resume of one job derives the same list
    (and the job persists it in state.opts['calib_frames'] so the
    contract is auditable)."""
    if frame_count <= 0:
        return []
    k = max(1, min(k, frame_count))
    idx = {min(frame_count - 1, int((i + 0.5) * frame_count / k))
           for i in range(k)}
    return sorted(idx)


def read_sampled_frames(state: JobState, io_backend=None,
                        indices=None) -> "np.ndarray | None":
    """Decode the job's sampled calibration frames with SEEKS — O(strata)
    work, not a sequential decode of ~the whole input (the last stratum
    sits at ~97% of the video; round-4 VERDICT #2).  Sampling needs
    representative frames, not frame-exact ones, and stays deterministic:
    the persisted indices map to the same timestamps/frames on every
    resume/shard worker (reader.read_frames_at documents the per-backend
    mechanics).  Returns (n, H, W, 3) uint8, or None if the input yields
    nothing."""
    if indices is None:
        indices = sample_frame_indices(state.frame_count)
    fps = (Fraction(state.fps_num, max(state.fps_den, 1))
           if state.fps_num else None)
    frames = reader_mod.read_frames_at(
        state.input_path, indices, backend=io_backend,
        width=state.width, height=state.height, fps=fps)
    if not len(frames):
        return None
    return frames


def _calibration_frames(state: JobState,
                        io_backend=None) -> "np.ndarray | None":
    """The job's calibration/certification sample: frames evenly spaced
    across the WHOLE video.  The indices are recorded in
    state.opts['calib_frames'] the first time and reused afterwards; the
    caller that holds the job's canonical state persists it."""
    indices = state.opts.get("calib_frames")
    if not indices:
        indices = sample_frame_indices(state.frame_count)
        state.opts["calib_frames"] = indices
    return read_sampled_frames(state, io_backend, indices)


def ensure_int8_calibrated(engine, workspace: Workspace, state: JobState,
                           io_backend=None) -> None:
    """Calibrate an int8 engine on the job's sampled frames (not on
    whatever batch arrives first).  No-op when the engine already carries
    this job's calibration (persisted first-wins via
    wire_int8_calibration) or is not int8."""
    if not getattr(engine, "_int8", False):
        return
    wire_int8_calibration(engine, workspace)
    if engine.get_calibration() is not None:
        return
    frames = _calibration_frames(state, io_backend)
    if frames is not None:
        engine.calibrate_int8(frames)


def wire_int8_calibration(engine, workspace: Workspace) -> None:
    """One calibration per job, persisted in the workspace: a resumed run
    quantizes with the exact scales the job started with, and an engine
    reused across jobs drops another job's scales.  Idempotent; no-op for
    non-int8 engines."""
    if not getattr(engine, "_int8", False):
        return
    saved = workspace.load_calibration()
    if saved is not None:
        engine.set_calibration(saved)
    else:
        # no persisted calibration: non-provisional scales the engine
        # carries belong to a DIFFERENT job (this job's own hook would
        # have persisted them)
        if engine.get_calibration() is not None and \
                engine.calibration_hook != workspace.claim_calibration:
            engine.reset_calibration()
        engine.calibration_hook = workspace.claim_calibration


def certify_int8_on_input(engine, workspace: Workspace, state: JobState,
                          io_backend=None):
    """int8-vs-f32 PSNR (dB) on frames sampled across the job's own video,
    with the workspace-persisted scales the job runs with — shared by the
    CLI's gate and report and by --dtype auto.  The measured dB is
    published first-wins (claim_int8_cert) and reused by every resume of
    the job.  Returns None when the input yields no frames; raises on
    read/measure errors (each caller decides whether that fails open or
    closed)."""
    wire_int8_calibration(engine, workspace)
    saved = workspace.load_int8_cert()
    if saved is not None and engine.get_calibration() is not None:
        # scales and certificate both persisted: record the frames the
        # inherited certificate was measured on (deterministic in
        # frame_count) and reuse it
        state.opts.setdefault("calib_frames",
                              sample_frame_indices(state.frame_count))
        return saved
    frames = _calibration_frames(state, io_backend)
    if frames is None:
        return None
    return workspace.claim_int8_cert(engine.certify_int8(frames))


def _arch(model: str):
    """The registry's architecture of a model name, or None for a name it
    does not know."""
    from reve_tpu_torch.models import registry

    try:
        return registry.parse_model_name(model)[0].arch
    except ValueError:
        return None


def resolve_auto_dtype(make_engine, workspace: Workspace, state: JobState,
                       io_backend=None, gate_db=None, platform=None,
                       on_note=None, tracer=None):
    """--dtype auto: the int8 turbo when it is eligible here and certifies
    at >= gate_db (default AUTO_INT8_GATE_DB) on this video's sampled
    frames, else bfloat16 (a failed certification falls back to bfloat16:
    the exact path needs no certificate).

    Eligibility is the reference's rule: `platform == "tpu"`, or the
    REVE_TPU_AUTO_INT8 environment variable set to a true value.  The
    port's platform is "cuda", so auto is bfloat16 without certification
    unless the variable forces it.  A model of another architecture than
    SRVGG (RRDB) resolves bfloat16 even when eligible, as in reve_tpu:
    its int8 is opt-in.

    `make_engine(dtype, int8_calib)` builds an engine with the caller's
    full settings (batch, tile, tta, device), so the trial engine is the
    job's engine; on int8 the calibrated trial engine is returned for
    reuse (calibration and certification run whole frames, never tiles
    or transforms).
    Returns (dtype, engine_or_None, db_or_None, notes).  The decision is
    published first-wins through the workspace (claim_resolution), so a
    resume follows the job's resolved dtype.  `on_note` receives a line
    before the certification starts; `tracer` times it as the
    "auto_resolve" span."""
    import time as _time

    from reve_tpu_torch.utils import trace as trace_mod

    gate = AUTO_INT8_GATE_DB if gate_db is None else gate_db
    tracer = tracer or trace_mod.null()

    def follow(res, note):
        """Materialize a previously claimed decision."""
        if res["dtype"] != "int8":
            return (res["dtype"], None, res["db"], [note])
        eng = make_engine("int8", state.opts.get("int8_calib", "p99.9"))
        wire_int8_calibration(eng, workspace)
        return ("int8", eng, res["db"], [note])

    saved = workspace.load_resolution()
    if saved is not None:
        dbtxt = ("" if saved["db"] is None
                 else f", certified {saved['db']:.1f} dB vs f32")
        return follow(saved,
                      f"auto dtype: {saved['dtype']} (inherited this "
                      f"workspace's first-wins resolution{dbtxt})")

    env = os.environ.get("REVE_TPU_AUTO_INT8")
    eligible = (env.strip().lower() not in ("0", "", "off", "false", "no")
                if env is not None else platform == "tpu")

    def decide(dtype, engine, db, note):
        """Publish our decision first-wins; follow whoever won."""
        final = workspace.claim_resolution(dtype, db)
        if final["dtype"] == dtype:
            return (dtype, engine if dtype == "int8" else None, db, [note])
        return follow(final, (
            f"auto dtype: {final['dtype']} (this worker resolved {dtype}, "
            f"but the workspace's first-wins resolution is "
            f"{final['dtype']} — following it so one output never mixes "
            f"compute paths)"))

    if not eligible:
        return decide("bfloat16", None, None,
                      f"auto dtype: bfloat16 (int8 turbo is TPU-only; "
                      f"backend is {platform})")
    if _arch(state.model) not in (None, "srvgg"):
        # reve_tpu's rule: int8 for a non-SRVGG model stays OPT-IN (--dtype
        # int8), so auto keeps the exact path; decided from the model's
        # name, so no int8 engine is built for it
        return decide("bfloat16", None, None,
                      "auto dtype: bfloat16 (int8 for this architecture "
                      "is opt-in via --dtype int8; auto keeps the exact "
                      "path)")
    try:
        engine = make_engine("int8", state.opts.get("int8_calib", "p99.9"))
    except WidthNotServed:
        # an SRVGG width the card's kernels do not take: refused, as
        # --dtype int8 is, not served in bfloat16 instead
        raise
    except (ValueError, NotImplementedError) as e:
        # an architecture without a (ported) int8 path
        return decide("bfloat16", None, None, f"auto dtype: bfloat16 ({e})")
    idx = state.opts.get("calib_frames") or \
        sample_frame_indices(state.frame_count)
    if on_note is not None:
        on_note(f"auto dtype: certifying int8 turbo vs f32 on {len(idx)} "
                f"frame(s) sampled across the video (runs once, before "
                f"upscaling starts)...")
    t0 = _time.monotonic()
    try:
        with tracer.span("auto_resolve", frames=len(idx)):
            db = certify_int8_on_input(engine, workspace, state,
                                       io_backend=io_backend)
    except Exception as e:
        # an unmeasurable certification fails SAFE: the exact path
        return decide("bfloat16", None, None,
                      f"auto dtype: bfloat16 (int8 certification "
                      f"failed: {e})")
    wall = _time.monotonic() - t0
    n = len(state.opts.get("calib_frames") or ())
    if db is None:
        return decide("bfloat16", None, None,
                      "auto dtype: bfloat16 (input yielded no frames to "
                      "certify int8 on)")
    if db >= gate:
        return decide("int8", engine, db,
                      f"auto dtype: int8 turbo (certified {db:.1f} dB vs "
                      f"f32 on {n} sampled frame(s), gate {gate:g} dB; "
                      f"resolved in {wall:.1f} s)")
    return decide("bfloat16", None, db,
                  f"auto dtype: bfloat16 (int8 measured {db:.1f} dB vs "
                  f"f32 on {n} sampled frame(s), below the {gate:g} dB "
                  f"gate; resolved in {wall:.1f} s)")


class PipelineJob:
    """Runs one upscale job (possibly resumed) to completion."""

    def __init__(
        self,
        state: JobState,
        workspace: Workspace,
        engine: UpscaleEngine,
        io_backend: Optional[str] = None,
        part_ext: str = ".mp4",
        progress: Optional[ProgressTracker] = None,
        decode_queue_depth: int = 4,
        device_queue_depth: Optional[int] = None,
        tracer=None,
    ):
        from reve_tpu_torch.utils import trace as trace_mod

        self.state = state
        self.ws = workspace
        self.engine = engine
        self.io_backend = io_backend
        self.part_ext = part_ext
        self.tracer = tracer or trace_mod.from_env()
        self.decode_q: "queue.Queue" = queue.Queue(maxsize=decode_queue_depth)
        #: the YUV 4:2:0 format the engine makes for the parts' writer
        #: (None: it returns RGB and the writer converts); set before the
        #: memory plan, which bills the planes
        self.planes = None
        fmt = writer_mod.planes_format(
            self.ws.part_tmp_path(0, part_ext), self._settings(),
            io_backend)
        if fmt is not None and hasattr(engine, "set_output_format"):
            engine.set_output_format(fmt)
            self.planes = fmt
        if device_queue_depth is None:
            # memory-planned depth: completed batches held beyond the
            # executing one must leave the engine's working set inside
            # device memory — ask the engine's plan; engines without the
            # hook (tests' synthetic engines) get the legacy depth.  An
            # error raised inside a real implementation propagates.
            if hasattr(engine, "recommended_queue_depth"):
                device_queue_depth = engine.recommended_queue_depth(
                    state.height, state.width)
            else:
                device_queue_depth = 3
        self.encode_q: "queue.Queue" = queue.Queue(maxsize=device_queue_depth)
        self.errors: list = []
        #: identity of the encoder actually used (e.g. "ffmpeg:libx265",
        #: "cv2:mp4v") — surfaced in the CLI done-line / job report so a
        #: fallback that cannot honor crf/preset is never invisible
        self.encoder_desc: Optional[str] = None
        self._stop = threading.Event()
        try:
            # calibrate on frames sampled across the whole video; only if
            # sampling itself fails does the engine's lazy first-batch
            # calibration take over (both persist first-wins)
            ensure_int8_calibrated(engine, workspace, state, io_backend)
        except Exception as e:
            log.warning("sampled int8 calibration failed (%s); falling "
                        "back to first-batch calibration", e)
            wire_int8_calibration(engine, workspace)
        remaining = sum(s.size for s in state.pending)
        self.progress = progress or ProgressTracker(
            total_frames=remaining, total_segments=len(state.pending),
            source_fps=state.fps_num / max(state.fps_den, 1),
        )

    # -- stage 1: decode ---------------------------------------------------

    def _decode_loop(self):
        bs = self.engine.batch_size
        try:
            rd = reader_mod.open_reader(
                self.state.input_path, backend=self.io_backend,
                width=self.state.width, height=self.state.height,
            )
            with rd:
                for seg in self.state.pending:
                    buf = []
                    got = 0
                    for frame in rd.read_range(seg.start, seg.stop):
                        buf.append(frame)
                        got += 1
                        self.progress.advance("decode")
                        if len(buf) == bs:
                            last = got == seg.size
                            self._put(self.decode_q, _DecodedBatch(
                                seg.index, np.stack(buf), last))
                            buf = []
                    if got != seg.size:
                        raise PipelineError(
                            f"segment {seg.index}: expected {seg.size} frames "
                            f"[{seg.start},{seg.stop}), decoded {got}"
                        )
                    if buf:
                        self._put(self.decode_q, _DecodedBatch(
                            seg.index, np.stack(buf), True))
        except BaseException as e:  # propagate to main thread
            self.errors.append(e)
            self._stop.set()
        finally:
            self._put_sentinel(self.decode_q, None)

    # -- stage 3: encode ---------------------------------------------------

    def _settings(self) -> "writer_mod.EncodeSettings":
        enc = self.state.encode or {}
        return writer_mod.EncodeSettings(
            crf=enc.get("crf", 15),
            preset=enc.get("preset", "slow"),
            x265_params=enc.get(
                "x265_params", "psy-rd=2:aq-strength=1:deblock=0,0:bframes=8"
            ),
        )

    def _encode_loop(self):
        writer = None
        cur_seg = -1
        seg_frames = 0
        last_commit_t = time.monotonic()
        fps = Fraction(self.state.fps_num, self.state.fps_den)
        out_w = self.state.width * self.state.scale
        out_h = self.state.height * self.state.scale
        settings = self._settings()
        try:
            while True:
                item = self._get(self.encode_q)
                if item is _SENTINEL or item is _ABORT:
                    break
                with self.tracer.span("device_wait", seg=item.seg_index):
                    frames = item.pending.result()  # blocks on device
                planes = isinstance(frames, Planes)
                n = len(frames.y) if planes else len(frames)
                if item.seg_index != cur_seg:
                    assert writer is None, "segment interleave violation"
                    cur_seg = item.seg_index
                    writer = writer_mod.open_writer(
                        self.ws.part_tmp_path(cur_seg, self.part_ext),
                        out_w, out_h, fps, settings=settings,
                        backend=self.io_backend,
                    )
                    self.encoder_desc = writer.describe()
                if planes and writer.planes_format != self.planes:
                    raise PipelineError(
                        f"the engine made {self.planes} planes, the writer "
                        f"takes {writer.planes_format}")
                with self.tracer.span("encode_batch", seg=item.seg_index,
                                      n=n):
                    if planes:
                        for y, u, v in zip(*frames):
                            writer.write_planes(y, u, v)
                    else:
                        for f in frames:
                            writer.write(f)
                seg_frames += n
                self.progress.advance("encode", n)
                if item.last_of_segment:
                    writer.close()
                    writer = None
                    self.ws.commit_part(cur_seg, self.part_ext)
                    # per-segment end-to-end x-realtime (BASELINE.md's
                    # "per segment" report): commit-to-commit wall time —
                    # in steady state the pipeline's true per-segment
                    # throughput with all three stages overlapped —
                    # against the segment's source-time duration
                    now = time.monotonic()
                    wall = now - last_commit_t
                    last_commit_t = now
                    xrt = (seg_frames / float(fps) / wall
                           if wall > 0 and fps > 0 else 0.0)
                    self.tracer.event("segment_commit", seg=cur_seg,
                                      frames=seg_frames,
                                      wall_s=round(wall, 3),
                                      x_realtime=round(xrt, 3))
                    seg_frames = 0
                    # checkpoint: everything not yet on disk is pending
                    done = set(self.ws.completed_parts(self.part_ext))
                    new_pending = [
                        s for s in self.state.pending if s.index not in done
                    ]
                    self.state = dataclasses.replace(
                        self.state, pending=new_pending
                    )
                    self.ws.save(self.state)
                    self.progress.advance("total")
                    cur_seg = -1
        except BaseException as e:
            self.errors.append(e)
            self._stop.set()
            self._drain(self.encode_q)
        finally:
            if writer is not None:
                try:
                    writer.close()
                except Exception:
                    pass

    # -- queue helpers (stop-aware) ---------------------------------------

    def _put(self, q, item):
        while True:
            if self._stop.is_set():
                raise PipelineError("pipeline stopping")
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                pass

    def _put_sentinel(self, q, consumer: Optional[threading.Thread]):
        """Deliver the end-of-stream marker without ever dropping real items:
        block while the consumer drains; if the consumer died, drain the
        stale items ourselves so the sentinel always fits."""
        while True:
            try:
                q.put(_SENTINEL, timeout=0.1)
                return
            except queue.Full:
                dead = consumer is not None and not consumer.is_alive()
                if dead or self._stop.is_set():
                    self._drain(q)

    def _get(self, q):
        while True:
            try:
                return q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return _ABORT

    def _drain(self, q):
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass

    # -- job control -------------------------------------------------------

    def cancel(self) -> None:
        """Request a cooperative stop; run() raises PipelineError.  Already
        committed segments stay on disk, so a cancelled job resumes like a
        crashed one."""
        self.errors.append(PipelineError("cancelled"))
        self._stop.set()

    #: seconds of NO encode progress (no frame encoded, no segment
    #: committed) before the drain declares the encoder hung.  This is a
    #: stall window, not a total budget: a long device_wait or a
    #: slow-codec writer legitimately runs long (cv2/VP9 can spend minutes
    #: flushing its ~25-frame lookahead inside writer.close() on one 4K
    #: segment — under a fixed total budget that honest slowness would
    #: abort a job that was finishing).
    ENCODE_STALL_S = 600.0

    def _drain_encode(self, encode_t: threading.Thread) -> None:
        """Wait for the encode stage to finish, failing only on a STALL
        (ENCODE_STALL_S without any counter movement) — a hung/glacial
        encoder must not look like success (the last segment would be
        truncated, finalize would concat it and destroy the workspace),
        but a slow one that is visibly progressing must be allowed to
        finish."""
        snap = self.progress.snapshot()
        last = (snap["encode"]["done"], snap["total"]["done"])
        stall_t0 = time.monotonic()
        while encode_t.is_alive():
            encode_t.join(timeout=15)
            if not encode_t.is_alive():
                return
            snap = self.progress.snapshot()
            cur = (snap["encode"]["done"], snap["total"]["done"])
            now = time.monotonic()
            if cur != last:
                last, stall_t0 = cur, now
            elif now - stall_t0 > self.ENCODE_STALL_S:
                if not self.errors:
                    self.errors.append(PipelineError(
                        f"encode stage made no progress for "
                        f"{self.ENCODE_STALL_S:.0f} s during drain"))
                self._stop.set()
                return

    def run(self) -> JobState:
        """Process all pending segments; returns the final (empty-pending)
        state. Raises the first stage error if any stage failed."""
        if not self.state.pending:
            return self.state
        decode_t = threading.Thread(
            target=self._decode_loop, name="reve-decode", daemon=True
        )
        encode_t = threading.Thread(
            target=self._encode_loop, name="reve-encode", daemon=True
        )
        decode_t.start()
        encode_t.start()
        try:
            while True:
                item = self._get(self.decode_q)
                if item is _SENTINEL or item is _ABORT:
                    break
                with self.tracer.span("submit", seg=item.seg_index,
                                      n=len(item.frames)):
                    pending = self.engine.submit(item.frames)
                inferred = _InferredBatch(
                    item.seg_index, pending, item.last_of_segment,
                )
                self.progress.advance("upscale", len(item.frames))
                self._put(self.encode_q, inferred)
        except BaseException as e:
            self.errors.append(e)
            self._stop.set()
        finally:
            self._put_sentinel(self.encode_q, encode_t)
            decode_t.join(timeout=30)
            self._drain_encode(encode_t)
        if self.errors:
            raise self.errors[0]
        if self.state.pending:
            raise PipelineError(
                f"{len(self.state.pending)} segment(s) still pending after "
                f"run — refusing to report success")
        return self.state


class _Abort:
    pass


_ABORT = _Abort()


def finalize(state: JobState, workspace: Workspace,
             io_backend: Optional[str] = None,
             part_ext: str = ".mp4") -> dict:
    """Concat all parts + remux A/V from the original into the output
    (reference: Video::concatenate_segments, lib.rs:173-206), then validate
    the output exists and is non-empty (main.rs:355-362)."""
    from reve_tpu_torch.pipeline.planner import plan_segments

    done = workspace.completed_parts(part_ext)
    parts = [workspace.part_path(i, part_ext) for i in done]
    if not parts:
        raise PipelineError("no completed parts to concatenate")
    expected = {s.index for s in (state.plan or plan_segments(
        state.frame_count, state.segment_size))}
    missing = sorted(expected - set(done))
    if missing:
        raise PipelineError(
            f"refusing to concatenate: segment part(s) {missing} missing")
    # concat to a tmp with the same container extension, then rename: the
    # output path existing therefore MEANS finalize completed — which is
    # what claim_finalize's crashed-finalizer takeover relies on, and a
    # killed finalizer never leaves a plausible-looking partial output
    ext = os.path.splitext(state.output_path)[1]
    tmp_out = f"{state.output_path}.tmp{os.getpid()}{ext}"
    try:
        report = concat_mod.concatenate(
            parts, state.input_path, tmp_out,
            Fraction(state.fps_num, state.fps_den), backend=io_backend,
        )
        if not os.path.exists(tmp_out) or os.path.getsize(tmp_out) == 0:
            raise PipelineError(
                f"output {tmp_out!r} missing or empty after concat")
        os.replace(tmp_out, state.output_path)
    finally:
        if os.path.exists(tmp_out):
            try:
                os.unlink(tmp_out)
            except OSError:
                pass
    if not report.get("audio_copied"):
        if state.output_path.endswith(".y4m"):
            log.info("y4m output carries no audio/subtitle tracks")
        else:
            log.warning(
                "audio/subtitles were not carried over (backend %s has no "
                "remux path)", report.get("backend"),
            )
    return report
