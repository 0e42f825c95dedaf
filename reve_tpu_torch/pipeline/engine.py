"""CUDA inference engine: the in-process replacement for the reference's
`realesrgan-ncnn-vulkan` subprocess, on an NVIDIA GPU.

Counterpart of reve_tpu/pipeline/engine.py.  Design:
  * uint8 -> uint8 on the device: frames cross the host link as 3
    bytes/pixel each way; the u8 -> float conversion is fused into the
    first conv kernel (K3) and the u8 rounding + pixel shuffle into the
    head kernel (K2).
  * Async dispatch: `submit` copies a batch into pinned host memory,
    enqueues a non_blocking H2D copy, the model and a non_blocking D2H
    copy into pinned output memory on the engine's CUDA stream, records a
    CUDA event and returns.  `PendingBatch.result()` waits on that event,
    so the caller can keep 2+ batches in flight.
  * A memory plan (`_plan_execution`) splits a batch into chunks of
    frames per model call from `torch.cuda.mem_get_info()` and the
    engine's own byte count per frame.
  * int8 turbo (`compute_dtype="int8"`): the hidden stack and the head
    run in s8 (K4a, K4, K4h), the first conv and the epilogue in
    bfloat16/float32, with activation scales from a float32 calibration
    forward over sampled frames (`calibrate_int8`), persisted first-wins
    through `calibration_hook`; `certify_int8` measures its PSNR against
    the float32 path on the job's own frames.

Not ported yet (each raises NotImplementedError naming its ROADMAP.md
port-queue item): TTA, halo tiling (including frames too large for the
memory plan) and multi-device meshes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from reve_tpu_torch import device as device_mod
from reve_tpu_torch.models import registry, srvgg


#: share of the free device memory (at plan time) the plan may fill
_MEM_FRACTION = 0.85
#: in-flight batch IO sets (pinned-staged u8 input + u8 output on the
#: device) the plan reserves beside the executing chunk
_PLAN_INFLIGHT_SETS = 2
#: live hidden-activation buffers of one model call: a hidden layer's
#: input and output (K1 writes a fresh tensor; the input is freed after)
_ACT_BUFFERS = 2


def parse_int8_calib(int8_calib: str):
    """Validate an int8_calib spec ("max" or "p<percentile>", percentile
    in (0, 100]) and return the percentile as a float, or None for "max".
    Raises ValueError on anything else (the CLI validates --int8-calib with
    it too)."""
    if int8_calib == "max":
        return None
    if not int8_calib.startswith("p"):
        raise ValueError(
            f"int8_calib must be 'max' or 'p<percentile>', "
            f"got {int8_calib!r}")
    try:
        pct = float(int8_calib[1:])
    except ValueError:
        raise ValueError(
            f"invalid int8_calib percentile {int8_calib!r}") from None
    if not 0.0 < pct <= 100.0:
        raise ValueError(
            f"int8_calib percentile out of range: {int8_calib!r}")
    return pct


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported in reve_tpu_torch (ROADMAP.md port "
        f"queue: {item})")


@dataclasses.dataclass
class EngineStats:
    frames: int = 0
    batches: int = 0
    #: model calls (chunks) dispatched
    calls: int = 0
    #: host seconds spent in int8 calibration (float32 forwards and
    #: statistics) and in certification (int8 + float32 passes); each
    #: ends in a device->host read, so the host clock covers the device
    calibrate_s: float = 0.0
    certify_s: float = 0.0


class PendingBatch:
    """Handle to an in-flight batch: a pinned host output buffer that the
    device fills, and the CUDA event recorded after its D2H copy (None
    on the CPU, where the work is already done)."""

    def __init__(self, host_out: torch.Tensor, valid: int,
                 event: Optional[torch.cuda.Event] = None,
                 host_in: Optional[torch.Tensor] = None):
        self._out = host_out
        self._valid = valid
        self._event = event
        # the pinned input must outlive its H2D copy
        self._in = host_in

    def result(self) -> np.ndarray:
        """Block until done; returns (valid, H*s, W*s, 3) uint8."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
            self._in = None
        return self._out.numpy()[: self._valid]


class UpscaleEngine:
    """Batched u8 -> u8 video upscaler on one CUDA device."""

    def __init__(
        self,
        model: str = "realesr-animevideov3",
        scale: int = 2,
        weights: Optional[str] = None,
        batch_size: int = 4,
        tile: int = 0,            # 0 = auto, -1 = never tile
        compute_dtype: str = "bfloat16",
        int8_calib: str = "p99.9",
        tta: bool = False,
        device: device_mod.DeviceLike = None,
        mesh=None,
        preloaded=None,
        allow_random_init: Optional[bool] = None,
    ):
        """`device`: None -> cuda:0 (raises without CUDA); "cpu" runs
        every kernel's plain PyTorch version (tests).  `preloaded`:
        (cfg, params) to use instead of resolving `model`/`weights`
        (params as float32 tensors, e.g. from srvgg.params_from_jax).

        `allow_random_init`: permit the deterministic random-init
        fallback when no weights resolve.  None defers to
        REVE_TPU_ALLOW_RANDOM_INIT; without either, missing weights raise
        registry.MissingWeightsError.

        `compute_dtype="int8"`: the int8 turbo path, its float parts in
        bfloat16.  `int8_calib`: the calibration statistic of fresh
        calibrations, "p<percentile>" of |activation| (default p99.9) or
        "max"; scales injected with set_calibration are used as given."""
        if tta:
            raise _not_ported("tta=True", "TTA, K6")
        if tile > 0:
            raise _not_ported(f"tile={tile}", "tiling")
        if mesh is not None:
            raise _not_ported("a multi-device mesh", "multi-GPU")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._int8 = compute_dtype == "int8"
        self._qbody = None
        self._qbody_provisional = False
        self._act_maxima = None
        self._calib_percentile = parse_int8_calib(int8_calib)
        self.int8_calib = int8_calib
        #: called with freshly calibrated (non-provisional) maxima, returns
        #: the maxima to use: Workspace.claim_calibration makes the first
        #: calibration of a job the one every resume quantizes with
        self.calibration_hook = None
        self.compute_dtype = device_mod.resolve_dtype(
            "bfloat16" if self._int8 else compute_dtype)
        self.device = device_mod.resolve_device(device)
        if preloaded is not None:
            cfg, params = preloaded
        else:
            cfg, params = registry.load_model(
                model, scale, weights, allow_random_init=allow_random_init)
        if not isinstance(cfg, srvgg.SRVGGConfig):
            raise _not_ported(f"architecture {type(cfg).__name__}",
                              "RRDB, K7")
        self.cfg = cfg
        self.params = srvgg.params_to(params, self.device)
        self.scale = cfg.upscale
        self.batch_size = batch_size
        self.stats = EngineStats()
        self._plans = {}
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    # -- memory plan -------------------------------------------------------

    def _bpe(self) -> int:
        return torch.finfo(self.compute_dtype).bits // 8

    def _in_bytes(self, h: int, w: int) -> int:
        return h * w * 3

    def _out_bytes(self, h: int, w: int) -> int:
        return h * w * self.scale ** 2 * 3

    def _frame_bytes(self, h: int, w: int) -> int:
        """Peak device bytes of ONE frame inside a model call: the live
        hidden activations plus the frame's u8 input and output.  The
        kernels keep everything else on chip: K2 and K4h write u8 straight
        from the head conv, with no float32 epilogue tensor, and an int8
        engine's activations are s8 (1 byte) from K4a on."""
        bpe = 1 if self._int8 else self._bpe()
        act = h * w * self.cfg.num_feat * bpe * _ACT_BUFFERS
        return act + self._in_bytes(h, w) + self._out_bytes(h, w)

    def _free_bytes(self) -> int:
        free, _total = torch.cuda.mem_get_info(self.device)
        # memory this process's caching allocator holds but does not use
        # is free to the plan too
        stats = torch.cuda.memory_stats(self.device)
        cached = (stats.get("reserved_bytes.all.current", 0)
                  - stats.get("allocated_bytes.all.current", 0))
        return free + max(cached, 0)

    def _plan_execution(self, h: int, w: int) -> int:
        """Frames per model call at (h, w): the whole batch when it fits,
        else the largest chunk whose working set plus the in-flight IO
        reserve fits the free device memory.  On the CPU, the batch.
        Raises NotImplementedError when not even one frame fits (halo
        tiling is not ported yet)."""
        key = (h, w)
        if key in self._plans:
            return self._plans[key]
        batch = self.batch_size
        if self.device.type != "cuda":
            chunk = batch
        else:
            budget = int(self._free_bytes() * _MEM_FRACTION)
            io_batch = batch * (self._in_bytes(h, w) + self._out_bytes(h, w))
            avail = budget - _PLAN_INFLIGHT_SETS * io_batch
            fits = avail // max(self._frame_bytes(h, w), 1)
            if fits < 1:
                raise _not_ported(
                    f"a {w}x{h} frame past the memory plan "
                    f"({self._frame_bytes(h, w) / 2**30:.2f} GiB/frame, "
                    f"{max(avail, 0) / 2**30:.2f} GiB available)",
                    "tiling")
            # fewest calls first, then the least uneven split
            calls = -(-batch // min(fits, batch))
            chunk = -(-batch // calls)
        self._plans[key] = chunk
        return chunk

    def recommended_queue_depth(self, h: int, w: int) -> int:
        """Completed batches the scheduler may hold beyond the executing
        one: what the free memory left after the plan's working set
        affords in IO sets, clamped to [1, 3]."""
        chunk = self._plan_execution(h, w)
        if self.device.type != "cuda":
            return 2
        io_batch = self.batch_size * (self._in_bytes(h, w)
                                      + self._out_bytes(h, w))
        ws = chunk * self._frame_bytes(h, w)
        headroom = (int(self._free_bytes() * _MEM_FRACTION) - ws) \
            // max(io_batch, 1)
        return int(min(3, max(1, headroom - 1)))

    @property
    def halo(self) -> int:
        """Exact receptive-field radius: 1 px per 3x3 conv."""
        return self.cfg.num_conv + 2

    # -- public API --------------------------------------------------------

    def _on_device(self):
        """The engine's device and stream as the current ones: the int8
        measurement work (calibration, qbody build, certification) runs in
        stream order with the batches that read its results."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _forward(self, u8: torch.Tensor) -> torch.Tensor:
        self.stats.calls += 1
        if self._int8:
            return srvgg.apply_int8(self.params, self._qbody, u8,
                                    cfg=self.cfg,
                                    compute_dtype=self.compute_dtype)
        return srvgg.apply(self.params, u8, cfg=self.cfg,
                           compute_dtype=self.compute_dtype)

    # -- int8 calibration and certification --------------------------------

    def _dp_pad(self, frames: np.ndarray):
        """reve_tpu pads calibration and certification batches to a
        multiple of its mesh's dp size; on one device (the only layout the
        port runs) the batch is used as it is.  Returns (frames, n_real)."""
        return frames, len(frames)

    @staticmethod
    def _calib_crop(frames: np.ndarray) -> np.ndarray:
        """Bound calibration/certification frames to <=720p windows, with
        the crop ANCHOR cycling center/corners per frame so content at the
        frame edges reaches the statistics too.  Deterministic in the
        frame's position within the batch (reve_tpu's crops exactly)."""
        n, h, w, _ = frames.shape
        ch, cw = min(h, 720), min(w, 1280)
        if (ch, cw) == (h, w):
            return frames
        anchors = ((1, 1), (0, 0), (0, 2), (2, 0), (2, 2))  # halves of 2
        out = np.empty((n, ch, cw, 3), frames.dtype)
        for i in range(n):
            ay, ax = anchors[i % len(anchors)]
            y0, x0 = (h - ch) * ay // 2, (w - cw) * ax // 2
            out[i] = frames[i, y0:y0 + ch, x0:x0 + cw]
        return out

    def calibrate_int8(self, frames: np.ndarray) -> None:
        """Calibrate the int8 quantization on `frames` ((n, H, W, 3) u8,
        the pipeline passes frames sampled across the video), through
        calibration_hook like the lazy first-batch calibration."""
        if not self._int8:
            raise ValueError("calibrate_int8 requires an int8 engine")
        self._calibrate_int8(np.asarray(frames, np.uint8),
                             provisional=False)

    #: activation elements (h*w*feat) per calibration chunk: reve_tpu's
    #: budget, kept because the percentile statistic is the max of
    #: per-chunk percentiles, so another chunking gives other scales
    _CALIB_CHUNK_ELEMS = int(2e8)

    def _calibrate_int8(self, frames: np.ndarray, provisional: bool) -> None:
        """Build the quantized body from a calibration batch: the float32
        forward over chunks of the (cropped) frames, per-layer statistics
        max-combined across chunks.  The sample is padded by cyclic frame
        repeats to a chunk multiple, as reve_tpu pads it, so the chunks
        and hence the percentile scales are the reference's."""
        from reve_tpu_torch.weights import quantize

        t0 = time.perf_counter()
        frames, _ = self._dp_pad(self._calib_crop(frames))
        n, h, w, _c = frames.shape
        chunk = max(1, self._CALIB_CHUNK_ELEMS
                    // max(h * w * self.cfg.num_feat, 1))
        pad = (-n) % chunk
        if pad:
            frames = np.concatenate([frames, frames[np.arange(pad) % n]])
        maxima = None
        with self._on_device():
            for i in range(0, len(frames), chunk):
                x = torch.from_numpy(np.ascontiguousarray(
                    frames[i:i + chunk], np.uint8)).to(self.device)
                m = quantize.collect_maxima(
                    self.params, x, cfg=self.cfg,
                    percentile=self._calib_percentile).cpu().numpy()
                maxima = m if maxima is None else np.maximum(maxima, m)
        self.stats.calibrate_s += time.perf_counter() - t0
        if self.calibration_hook is not None and not provisional:
            maxima = np.asarray(self.calibration_hook(maxima), np.float32)
        self._install_qbody(maxima, provisional)

    def _install_qbody(self, maxima: np.ndarray, provisional: bool) -> None:
        from reve_tpu_torch.weights import quantize

        with self._on_device():
            # margin absorbs content hotter than the calibration batch
            self._qbody = quantize.build_qbody(self.params, self.cfg,
                                               np.asarray(maxima),
                                               margin=1.25)
        self._qbody_provisional = provisional
        self._act_maxima = np.asarray(maxima, np.float32)

    def get_calibration(self):
        """The activation maxima the current int8 quantization was built
        from, or None (not int8 / not yet calibrated / provisional)."""
        if not self._int8 or self._qbody_provisional:
            return None
        return self._act_maxima

    def set_calibration(self, maxima) -> None:
        """Quantize with externally provided activation maxima (e.g. the
        job's persisted calibration), so every segment of one output is
        quantized with identical scales."""
        if not self._int8:
            raise ValueError("set_calibration requires an int8 engine")
        maxima = np.asarray(maxima, np.float32)
        if (self._act_maxima is not None and not self._qbody_provisional
                and np.array_equal(self._act_maxima, maxima)):
            return  # already quantized with exactly these scales
        self._install_qbody(maxima, provisional=False)

    def reset_calibration(self) -> None:
        """Drop the int8 calibration so the next real batch recalibrates."""
        self._qbody = None
        self._qbody_provisional = False
        self._act_maxima = None

    def _maybe_calibrate(self, frames: np.ndarray, provisional: bool) -> None:
        if not self._int8:
            return
        if self._qbody is None or (self._qbody_provisional
                                   and not provisional):
            self._calibrate_int8(frames, provisional)

    def certify_int8(self, frames: np.ndarray, crop: bool = True,
                     chunk: "Optional[int]" = None) -> float:
        """PSNR (dB, 8-bit scale) of the int8 turbo path against the
        float32 path on `frames` ((n, H, W, 3) uint8), both u8 -> u8 on
        this engine's kernels, with the scales the job runs with
        (calibrating first if needed).  By default the frames are cropped
        to <=720p windows as calibration crops them; `chunk` = frames per
        model call (None: from _CALIB_CHUNK_ELEMS, as reve_tpu)."""
        if not self._int8:
            raise ValueError("certify_int8 requires an int8 engine")
        self._maybe_calibrate(frames, provisional=False)
        t0 = time.perf_counter()
        measured = self._calib_crop(frames) if crop else \
            np.asarray(frames, np.uint8)
        measured, n_real = self._dp_pad(measured)
        _n, ch, cw, _c = measured.shape
        if chunk is None:
            chunk = max(1, self._CALIB_CHUNK_ELEMS
                        // max(ch * cw * self.cfg.num_feat, 1))
        sse = 0
        with self._on_device():
            for i in range(0, n_real, chunk):
                x = torch.from_numpy(np.ascontiguousarray(
                    measured[i:min(i + chunk, n_real)],
                    np.uint8)).to(self.device)
                y8 = srvgg.apply_int8(self.params, self._qbody, x,
                                      cfg=self.cfg,
                                      compute_dtype=self.compute_dtype)
                yf = srvgg.apply(self.params, x, cfg=self.cfg,
                                 compute_dtype=torch.float32)
                d = y8.int() - yf.int()
                del y8, yf
                # int64 sum of squares: exact at any frame count
                sse += int((d * d).sum())
        self.stats.certify_s += time.perf_counter() - t0
        cnt = n_real * (ch * self.scale) * (cw * self.scale) * 3
        mse = max(sse / max(cnt, 1), 1e-12)
        return float(10.0 * np.log10(255.0 ** 2 / mse))

    # -- batches -----------------------------------------------------------

    def warmup(self, h: int, w: int) -> None:
        """Build the kernels (first use compiles them) and the memory plan
        for a resolution, and run one batch of zeros through the model.
        An int8 engine calibrates provisionally on the zeros; the first
        real batch replaces that calibration."""
        dummy = np.zeros((self.batch_size, h, w, 3), np.uint8)
        self._maybe_calibrate(dummy, provisional=True)
        self._dispatch(dummy, self.batch_size).result()

    def submit(self, frames: np.ndarray) -> PendingBatch:
        """Enqueue a batch; returns a handle. frames: (n<=batch, H, W, 3) u8.

        Short batches are padded to `batch_size` by repeating the last
        frame (a fixed batch shape per job); padding is cropped in
        result().  An int8 engine without a real calibration calibrates
        on the padded batch first."""
        n, h, w, _ = frames.shape
        if n < self.batch_size:
            pad = np.repeat(frames[-1:], self.batch_size - n, axis=0)
            frames = np.concatenate([frames, pad], axis=0)
        elif n > self.batch_size:
            raise ValueError(f"batch {n} > batch_size {self.batch_size}")
        self._maybe_calibrate(frames, provisional=False)
        self.stats.frames += n
        self.stats.batches += 1
        return self._dispatch(frames, n)

    def _dispatch(self, frames: np.ndarray, n: int) -> PendingBatch:
        """Enqueue one padded (batch_size, H, W, 3) u8 batch through the
        memory plan's model calls; `n` frames of it are valid."""
        _bs, h, w, _ = frames.shape
        chunk = self._plan_execution(h, w)
        r = self.scale
        bs = self.batch_size
        if self.device.type != "cuda":
            x = torch.from_numpy(np.ascontiguousarray(frames, np.uint8))
            out = torch.cat([self._forward(x[i:i + chunk])
                             for i in range(0, bs, chunk)])
            return PendingBatch(out, n)
        host_in = torch.empty((bs, h, w, 3), dtype=torch.uint8,
                              pin_memory=True)
        host_in.numpy()[...] = frames
        host_out = torch.empty((bs, h * r, w * r, 3), dtype=torch.uint8,
                               pin_memory=True)
        with self._on_device():
            dev_in = host_in.to(self.device, non_blocking=True)
            for i in range(0, bs, chunk):
                y = self._forward(dev_in[i:i + chunk])
                host_out[i:i + chunk].copy_(y, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return PendingBatch(host_out, n, event, host_in)

    def upscale_frames(self, frames: np.ndarray) -> np.ndarray:
        """Synchronous convenience: (N, H, W, 3) u8 -> (N, H*s, W*s, 3) u8."""
        outs = []
        pending = []
        for i in range(0, len(frames), self.batch_size):
            pending.append(self.submit(frames[i:i + self.batch_size]))
            # keep at most 2 batches in flight
            while len(pending) > 2:
                outs.append(pending.pop(0).result())
        for p in pending:
            outs.append(p.result())
        return np.concatenate(outs, axis=0)
