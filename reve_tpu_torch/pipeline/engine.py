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

Not ported yet (each raises NotImplementedError naming its ROADMAP.md
port-queue item): int8, TTA, halo tiling (including frames too large for
the memory plan) and multi-device meshes.
"""

from __future__ import annotations

import dataclasses
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
        registry.MissingWeightsError."""
        if tta:
            raise _not_ported("tta=True", "TTA, K6")
        if tile > 0:
            raise _not_ported(f"tile={tile}", "tiling")
        if mesh is not None:
            raise _not_ported("a multi-device mesh", "multi-GPU")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.compute_dtype = device_mod.resolve_dtype(compute_dtype)
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
        kernels keep everything else on chip: K2 writes u8 straight from
        the head conv, with no float32 epilogue tensor."""
        act = h * w * self.cfg.num_feat * self._bpe() * _ACT_BUFFERS
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

    def _forward(self, u8: torch.Tensor) -> torch.Tensor:
        self.stats.calls += 1
        return srvgg.apply(self.params, u8, cfg=self.cfg,
                           compute_dtype=self.compute_dtype)

    def warmup(self, h: int, w: int) -> None:
        """Build the kernels (first use compiles them) and the memory plan
        for a resolution, and run one batch of zeros through the model."""
        self.submit(np.zeros((self.batch_size, h, w, 3), np.uint8)).result()
        self.stats.frames -= self.batch_size
        self.stats.batches -= 1

    def submit(self, frames: np.ndarray) -> PendingBatch:
        """Enqueue a batch; returns a handle. frames: (n<=batch, H, W, 3) u8.

        Short batches are padded to `batch_size` by repeating the last
        frame (a fixed batch shape per job); padding is cropped in
        result()."""
        n, h, w, _ = frames.shape
        if n < self.batch_size:
            pad = np.repeat(frames[-1:], self.batch_size - n, axis=0)
            frames = np.concatenate([frames, pad], axis=0)
        elif n > self.batch_size:
            raise ValueError(f"batch {n} > batch_size {self.batch_size}")
        chunk = self._plan_execution(h, w)
        self.stats.frames += n
        self.stats.batches += 1
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
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
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
