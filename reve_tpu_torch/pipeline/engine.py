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
  * A memory plan (`_plan_execution`) runs whole frames, a chunk of them
    per model call, when one frame fits the free device memory beside the
    in-flight IO reserve, and halo tiles (`ops/tiling.py`, byte-identical
    to the whole frame) when one does not or `tile > 0` asks for them.
  * int8 turbo (`compute_dtype="int8"`): SRVGG's hidden stack and head
    run in s8 (K4a, K4, K4h), the first conv and the epilogue in
    bfloat16/float32; RRDB's trunk runs in s8 on K7q with float32
    residuals, conv_first and the head in bfloat16.  Activation scales
    come from a float32 calibration forward over sampled whole frames
    (`calibrate_int8`), persisted first-wins through `calibration_hook`;
    `certify_int8` measures its PSNR against the float32 path on the
    job's own frames.
  * TTA (`tta=True`): the 8-transform dihedral self-ensemble.  Each
    forward transform runs on the device after the H2D copy, each
    transform's model output goes straight into K6 (the inverse transform
    and a 16-bit accumulate), and the 8th K6 writes the u8 mean that the
    one D2H copy reads (`TTAPendingBatch`).
  * Planes out (`set_output_format`): the writers' YUV 4:2:0 codes are
    made on the device by K9 from each piece's u8 output (after the
    tiles' assembly, after TTA's mean), so the D2H copy carries 1.5 B a
    pixel at 8 bits (3 at 10) instead of 3 and the encode thread only
    writes them (reve_tpu/ops/color.py's design).  `upscale_frames` and
    the int8 measurement passes stay RGB.

  * Two architectures: SRVGG (K3, K1, K2) and RRDBNet at x4 and x2 (K3,
    or at x2 K3 at Cin 12 over the unshuffled frame, K7 for the
    dense-block trunk, or K7q in int8, K1 for the up and hr convs, K2's
    conv_last mode), each behind `_forward`, so tiling and TTA reach both
    the same way.  RRDB's halo is reve_tpu's documented approximation (24
    px; its receptive field is far wider, so its tiles are not
    byte-identical to whole frames), and its memory plan bills its own
    allocations (`_rrdb_bytes`).  At x2 every window has even dims (even
    frames, even tile and halo), as the unshuffle needs; odd ones raise,
    as reve_tpu's pixel_unshuffle raises.

  * SRVGG widths: on the card K3, K1 and K2 (bfloat16 and float32) and
    K4a, K4 and K4h (int8) take an SRVGG of 32, 64, 96 or 128 features
    (kernels.conv3x3.WIDTHS), the widths the JAX package's own
    distillation makes (its default student has 128).

  * A mesh (`mesh=`, parallel/mesh.py, the CLI's --device N,M,...): each
    batch is cut into dp equal shares, one a replica (this engine for the
    first device, a replica engine for each other entry: its own params
    and CUDA stream), and the replicas write their frames into slices of
    one pinned output; the handle waits on every replica's event.  Tiles
    and TTA run inside each share.  Each replica plans its share in its
    part of its device's free memory (replicas sharing a device split
    it).  int8 calibration and certification run on the first replica,
    with reve_tpu's mesh semantics: the sample padded cyclically to a dp
    multiple, the statistic over all of it as one chunk; the quantized
    body is installed on every replica.

Not ported yet (raises NotImplementedError naming its ROADMAP.md
port-queue item): RRDB x1, and on the card an SRVGG of another width
(`check_serving_width`).  The CPU's plain path serves every width in
every dtype.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from reve_tpu_torch import device as device_mod
from reve_tpu_torch.kernels import color as color_k
from reve_tpu_torch.kernels import conv3x3
from reve_tpu_torch.kernels import tta as tta_mod
from reve_tpu_torch.models import registry, rrdb, srvgg
from reve_tpu_torch.ops import tiling
from reve_tpu_torch.ops.color import CODE_DTYPES, codes_numpy
from reve_tpu_torch.ops.color_np import Planes, YUVFormat


#: share of the free device memory (at plan time) the plan may fill
_MEM_FRACTION = 0.85
#: in-flight batch IO sets (pinned-staged u8 input + u8 output on the
#: device) the plan reserves beside the executing chunk: the scheduler's
#: queue floor (recommended_queue_depth >= 1) plus the batch being
#: submitted
_PLAN_INFLIGHT_SETS = 2
#: live hidden-activation buffers of one model call: a hidden layer's
#: input and output (K1 writes a fresh tensor; the input is freed after)
_ACT_BUFFERS = 2
#: bytes a float32 conv adds per value of its input: the three bf16
#: planes of the split pass (float32 K1, K2 and K7), live beside the
#: conv's input and output
_SPLIT_BYTES = 6
#: RRDB's tile halo: reve_tpu's documented approximation (24 px of
#: context; the true receptive field spans hundreds of pixels)
RRDB_HALO = 24


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


#: the ROADMAP.md item that serving an SRVGG of another width waits on
SERVING_WIDTHS_ITEM = "Serving at other widths"


def _not_ported(what: str, item: str,
                cls=NotImplementedError) -> NotImplementedError:
    return cls(
        f"{what} is not yet ported in reve_tpu_torch (ROADMAP.md port "
        f"queue: {item})")


class WidthNotServed(NotImplementedError):
    """An SRVGG width the card's kernels do not take: raised before any
    batch, naming SERVING_WIDTHS_ITEM."""


def check_serving_width(cfg, device: torch.device) -> None:
    """Raise WidthNotServed, for a CUDA device, on an SRVGG whose num_feat
    is not one of the WIDTHS that the inference kernels take
    (kernels/conv3x3.py: K3, K1 and K2 in bfloat16 and float32, K4a, K4
    and K4h in int8): before the first batch, not deep in a kernel.  The
    plain path on the CPU serves any width in any dtype."""
    if device.type != "cuda" or not isinstance(cfg, srvgg.SRVGGConfig):
        return
    if cfg.num_feat not in conv3x3.WIDTHS:
        raise _not_ported(
            f"serving an SRVGG of {cfg.num_feat} features on the card (its "
            f"inference kernels K3, K1, K2, K4a, K4 and K4h take "
            f"{', '.join(map(str, conv3x3.WIDTHS))})",
            SERVING_WIDTHS_ITEM, WidthNotServed)


def srvgg_act_bytes(h: int, w: int, num_feat: int,
                    dtype: torch.dtype) -> int:
    """Peak device bytes of one (h, w) frame's activations in srvgg.apply
    (or, at `dtype` int8, apply_int8) on the card: a hidden layer's input
    and output, _ACT_BUFFERS tensors of num_feat values in `dtype` (s8
    from K4a on in int8), and in float32 the three bf16 split planes of
    the input (_SPLIT_BYTES a value) that the split pass writes for K1
    and K2 and that live until the conv returns.  At the wide widths
    float32 K1 reads its input's planes and writes its output's instead
    (12 B a value held, K3's output and its planes 10): within the bill."""
    split = _SPLIT_BYTES if dtype == torch.float32 else 0
    return h * w * num_feat * (dtype.itemsize * _ACT_BUFFERS + split)


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
    """Handle to an in-flight batch: the pinned host output buffer that
    the device fills (RGB, or the three planes of a YUV 4:2:0 batch), and
    the CUDA events recorded after its D2H copies, one a replica (none on
    the CPU, where the work is already done)."""

    def __init__(self, host_out, valid: int, events=(),
                 host_in: Optional[torch.Tensor] = None):
        self._out = host_out
        self._valid = valid
        self._events = list(events)
        # the pinned input must outlive its H2D copies
        self._in = host_in

    def result(self):
        """Block until done; returns (valid, H*s, W*s, 3) uint8, or for a
        planes batch a color_np.Planes of (valid, H*s, W*s) and (valid,
        H*s/2, W*s/2) codes (uint8, or uint16 at 10 bits)."""
        if self._events:
            for event in self._events:
                event.synchronize()
            self._events = []
            self._in = None
        if isinstance(self._out, tuple):
            return Planes(*(codes_numpy(t)[: self._valid]
                            for t in self._out))
        return self._out.numpy()[: self._valid]


class TTAPendingBatch(PendingBatch):
    """Self-ensemble (TTA) batch: the surface of the replaced engine's
    `-x` switch (realesrgan-ncnn-vulkan runs the model on all 8 dihedral
    transforms of the input and averages; the reference CLI never passes
    it).

    `submit` enqueues the whole ensemble on the engine's stream: per
    transform, the forward transform of the device input (torch ops on
    the u8 input), the model in the plan's pieces and K6 on each piece's
    output; the 8th K6 writes the u8 mean, the one tensor the D2H copy
    reads.  Because the 8 transforms are a group, the ensemble is exactly
    dihedral-equivariant: tta(T(x)) == T(tta(x)) byte for byte
    (tests/test_torch_tta.py).  `result()` is one-shot, as the
    reference's is: the pinned output is handed over and released."""

    def result(self) -> np.ndarray:
        if self._out is None:
            raise RuntimeError("TTAPendingBatch.result() is one-shot")
        out = super().result()
        self._out = None
        return out


def _copy_out(host_out, lo: int, hi: int, y: torch.Tensor,
              fmt: Optional[YUVFormat]) -> None:
    """Enqueue the D2H copy of frames lo:hi of a batch: the piece's u8
    output y itself, or with `fmt` the planes K9 makes of it, into the
    pinned host buffers `host_out` (RGB: one; planes: Y, U, V)."""
    outs = (y,) if fmt is None else color_k.rgb_to_yuv420_u8(y, fmt)
    for dst, src in zip(host_out, outs):
        dst[lo:hi].copy_(src, non_blocking=True)


class Plan(NamedTuple):
    """How one batch runs: `tile == 0` whole frames, `per_call` frames per
    model call; `tile > 0` halo tiles of that side, `per_call` windows per
    model call."""

    tile: int
    per_call: int


class UpscaleEngine:
    """Batched u8 -> u8 video upscaler on one CUDA device, or on a mesh
    of them (a replica a device)."""

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
        every kernel's plain PyTorch version (tests).  `mesh`: a
        parallel.mesh.Mesh to split each batch of frames over, one
        replica an entry; batch_size must be a multiple of its dp size;
        exclusive with `device`.  `preloaded`:
        (cfg, params) to use instead of resolving `model`/`weights`
        (params as float32 tensors, e.g. from srvgg.params_from_jax or
        rrdb.params_from_jax).

        `allow_random_init`: permit the deterministic random-init
        fallback when no weights resolve.  None defers to
        REVE_TPU_ALLOW_RANDOM_INIT; without either, missing weights raise
        registry.MissingWeightsError.

        `compute_dtype="int8"`: the int8 turbo path, its float parts in
        bfloat16.  `int8_calib`: the calibration statistic of fresh
        calibrations, "p<percentile>" of |activation| (default p99.9) or
        "max"; scales injected with set_calibration are used as given.

        `tile`: 0 (auto) runs whole frames and halo tiles only a frame
        past the memory plan; N > 0 tiles every frame in N x N tiles; -1
        never tiles (a frame past the plan raises).  `tta`: the
        8-transform self-ensemble."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if mesh is not None:
            if device is not None:
                raise ValueError("device and mesh are mutually exclusive")
            dp = mesh.shape["dp"]
            if batch_size % dp:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by dp={dp}")
            device = mesh.devices[0]
        #: the mesh the batches are split over (None: one device)
        self.mesh = mesh
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
        # the replicas' weights, as loaded: each replica places them
        raw_params = params
        self._rrdb = isinstance(cfg, rrdb.RRDBConfig)
        if not self._rrdb and not isinstance(cfg, srvgg.SRVGGConfig):
            raise TypeError(f"unknown model config {type(cfg).__name__}")
        if self._rrdb:
            rrdb.check_cfg(cfg)  # x1 raises, naming its ROADMAP.md item
        check_serving_width(cfg, self.device)
        self.cfg = cfg
        #: the float32 params that int8 calibration, quantization and
        #: certification read (None off int8)
        self._params_f32 = None
        if self._rrdb:
            # weights cast, and K7's packed, once for every batch; an int8
            # engine also keeps them in float32 (K7's three planes packed)
            # for its float32 measurement passes
            params = rrdb.params_to(params, self.device)
            self.params = rrdb.prepare(params, self.compute_dtype)
            if self._int8:
                self._params_f32 = rrdb.prepare(params, torch.float32)
        else:
            self.params = srvgg.params_to(params, self.device)
            if self._int8:
                self._params_f32 = self.params
            else:
                # weights cast once; the wide kernels' packs made once
                self.params = srvgg.prepare(self.params, self.compute_dtype)
        self.scale = cfg.upscale
        self.batch_size = batch_size
        #: the frames of a batch this replica runs (batch_size / dp)
        self._share = batch_size // (len(mesh) if mesh is not None else 1)
        #: replicas on this replica's device (its memory plan's share)
        self._mem_share = 1 if mesh is None else \
            mesh.devices.count(self.device)
        #: 0 = tile only frames past the memory plan, -1 = never tile,
        #: N > 0 = always tile N x N
        self.tile = tile
        #: the 8-transform self-ensemble (TTAPendingBatch): 8x the model
        #: work for a small quality gain
        self.tta = bool(tta)
        self.stats = EngineStats()
        self._plans = {}
        #: the batches' output: None RGB, else YUV 4:2:0 planes in this
        #: format (set_output_format)
        self.output_format: Optional[YUVFormat] = None
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        #: the engines that run a batch's shares in order: this one, then
        #: a replica for each further mesh entry (sharing these stats)
        self._replicas = [self]
        for d in (mesh.devices[1:] if mesh is not None else ()):
            rep = UpscaleEngine(
                batch_size=self._share, tile=tile,
                compute_dtype=compute_dtype, int8_calib=int8_calib,
                tta=tta, device=d, preloaded=(cfg, raw_params))
            rep._mem_share = mesh.devices.count(rep.device)
            rep.stats = self.stats
            self._replicas.append(rep)

    def set_output_format(self, fmt: Optional[YUVFormat]) -> None:
        """What `submit`'s batches return: None RGB frames, or the planes
        of `fmt` made on the device by K9 (the scheduler asks for its
        writer's format before the first batch)."""
        if fmt is not None:
            if fmt.bits not in CODE_DTYPES or fmt.matrix not in (
                    "bt601", "bt709"):
                raise ValueError(f"output format {fmt}: bits 8 or 10, "
                                 f"matrix bt601 or bt709")
        for rep in self._replicas:
            if fmt != rep.output_format:
                rep.output_format = fmt
                rep._plans = {}  # the plan bills the planes

    # -- memory plan -------------------------------------------------------

    def _in_bytes(self, h: int, w: int) -> int:
        return h * w * 3

    def _out_bytes(self, h: int, w: int) -> int:
        return h * w * self.scale ** 2 * 3

    def _planes_bytes(self, h: int, w: int) -> int:
        """Device bytes of one output frame's YUV planes (0 for RGB)."""
        fmt = self.output_format
        if fmt is None:
            return 0
        return color_k.plane_bytes(h * self.scale, w * self.scale, fmt.bits)

    def _frame_bytes(self, h: int, w: int) -> int:
        """Peak device bytes of ONE frame inside a model call: the live
        hidden activations plus the frame's u8 input and output (and the
        output's planes, which K9 writes beside it).  The
        kernels keep everything else on chip: K2 and K4h write u8 straight
        from the head conv, with no float32 epilogue tensor, and an int8
        engine's activations are s8 (1 byte) from K4a on.  RRDB bills its
        own allocations (_rrdb_bytes), SRVGG srvgg_act_bytes."""
        if self._rrdb:
            act = self._rrdb_bytes(h, w)
        else:
            act = srvgg_act_bytes(
                h, w, self.cfg.num_feat,
                torch.int8 if self._int8 else self.compute_dtype)
        return act + self._in_bytes(h, w) + self._out_bytes(h, w) \
            + self._planes_bytes(h, w)

    def _rrdb_bytes(self, h: int, w: int,
                    dtype: Optional[torch.dtype] = None) -> int:
        """Peak device bytes of one (h, w) frame's activations in
        rrdb.apply (or, on an int8 engine, apply_int8) in `dtype` (None:
        the engine's compute dtype), the largest of its phases, billed a
        pixel of the trunk: (h, w) at x4, (h/2, w/2) at x2, whose up1 then
        runs at (h, w) and up2/hr at (2h, 2w) (float32 adds each conv
        input's split planes):
          trunk   feat + three dense buffers of nf + 4 gc channels (+
                  their three split planes and feat's split while it is
                  copied into the first: 6,400 B a pixel); int8:
                  feat, two s8 dense buffers, three float32 nf-channel
                  chain buffers and the first quantize's float32
                  temporary;
          up1     at 2x: the upsampled input and conv_up1's output (+ its
                  split);
          up2/hr  at 4x: a conv's input and output (+ its split), which
                  peaks: 4096 B per trunk pixel in bfloat16 (and int8),
                  14,336 in float32.
        Each phase frees the last one's tensors before it allocates."""
        dtype = dtype or self.compute_dtype
        bpe = torch.finfo(dtype).bits // 8
        split = _SPLIT_BYTES if dtype == torch.float32 else 0
        nf = self.cfg.num_feat
        per_px = max(self._rrdb_trunk_bytes(dtype),
                     *(r * r * (2 * nf * bpe + nf * split) for r in (2, 4)))
        u = 4 // self.scale  # the unshuffle: 1 at x4, 2 at x2
        return (h // u) * (w // u) * per_px

    def _rrdb_trunk_bytes(self, dtype: torch.dtype) -> int:
        """_rrdb_bytes' trunk phase, bytes a pixel (see there)."""
        bpe = torch.finfo(dtype).bits // 8
        split = _SPLIT_BYTES if dtype == torch.float32 else 0
        nf, cs = self.cfg.num_feat, self.cfg.dense_channels
        if self._int8 and dtype != torch.float32:
            return nf * bpe + 2 * cs + 4 * nf * 4
        return (3 * cs + nf) * (bpe + split)

    def _free_bytes(self) -> int:
        """Device bytes the plan may spend: cudaMemGetInfo's free memory and
        the segments this process's caching allocator holds with nothing
        in them (it releases those before it fails an allocation).  The
        unused parts of segments that a live tensor still holds do not
        count: a tensor larger than such a part cannot use it.  Replicas
        that share the device each get an equal part of it."""
        free, _total = torch.cuda.mem_get_info(self.device)
        stats = torch.cuda.memory_stats(self.device)
        cached = (stats.get("reserved_bytes.all.current", 0)
                  - stats.get("allocated_bytes.all.current", 0)
                  - stats.get("inactive_split_bytes.all.current", 0))
        return (free + max(cached, 0)) // self._mem_share

    def _io_batch_bytes(self, h: int, w: int) -> int:
        """One batch share's IO set on the device: u8 input + u8 output
        (+ its planes)."""
        return self._share * (self._in_bytes(h, w)
                              + self._out_bytes(h, w)
                              + self._planes_bytes(h, w))

    def _tta_bytes(self, h: int, w: int) -> int:
        """What TTA holds beside the model per batch: the 16-bit
        accumulator (2 B per output value), two transforms' u8 outputs in
        flight (the mean K6 writes counts as one) and the transformed
        input."""
        if not self.tta:
            return 0
        return self._share * (4 * self._out_bytes(h, w)
                              + self._in_bytes(h, w))

    def _window(self, h: int, w: int, tile: int):
        """The (rows, columns) of a halo window of `tile` at (h, w)."""
        side = tile + 2 * self.halo
        return min(h, side), min(w, side)

    def _auto_tile(self, h: int, w: int, avail: int) -> int:
        """The largest tile whose window fits `avail` bytes (0: none):
        fewest windows, so the least halo work.  Even at x2, so that even
        frames give even windows (the unshuffle's)."""
        lo, hi = 0, max(h, w)
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self._frame_bytes(*self._window(h, w, mid)) <= avail:
                lo = mid
            else:
                hi = mid - 1
        return lo - lo % 2 if self.scale == 2 and self._rrdb else lo

    def _does_not_fit(self, what: str, need: int, avail: int):
        return RuntimeError(
            f"{what} does not fit the device memory plan "
            f"({need / 2**30:.2f} GiB needed, {max(avail, 0) / 2**30:.2f} "
            f"GiB available beside the in-flight IO reserve)")

    def _plan_execution(self, h: int, w: int) -> Plan:
        """The plan of this replica's share of a batch at (h, w) (the
        whole batch on one device).  Whole frames, the whole share
        per call when it fits, else the largest chunk whose working set
        plus the in-flight IO reserve (and TTA's accumulator) fits the
        free device memory, fewest calls first (also when `tile > 0` but
        one tile covers the frame).  Halo tiles when `tile > 0`, or when
        `tile == 0` and not even one frame fits: the tile as
        given, or the largest whose window fits, and as many windows per
        call as fit beside the executing batch's own IO set.  On the CPU
        the whole batch (or every window) in one call.  Raises
        RuntimeError when nothing fits (with `tile == -1`: when one whole
        frame does not)."""
        key = (h, w)
        if key in self._plans:
            return self._plans[key]
        batch = self._share
        # a given tile whose one window is the whole frame runs as whole
        # frames, in chunks of frames like tile == 0
        n = tiling.plan_tiles(h, w, self.tile, self.halo).num_tiles \
            if self.tile > 0 else 0
        whole = self.tile <= 0 or n == 1
        if self.device.type != "cuda":
            plan = Plan(0, batch) if whole else Plan(self.tile, batch * n)
            self._plans[key] = plan
            return plan
        budget = int(self._free_bytes() * _MEM_FRACTION)
        io_batch = self._io_batch_bytes(h, w)
        avail = budget - _PLAN_INFLIGHT_SETS * io_batch \
            - self._tta_bytes(h, w)
        fits = avail // max(self._frame_bytes(h, w), 1)
        if whole and fits >= 1:
            # fewest calls first, then the least uneven split
            calls = -(-batch // min(fits, batch))
            plan = Plan(0, -(-batch // calls))
        elif self.tile < 0 or n == 1:
            why = "tile=-1: never tile" if self.tile < 0 else \
                f"tile={self.tile}: one window is the whole frame"
            raise self._does_not_fit(f"a {w}x{h} frame ({why})",
                                     self._frame_bytes(h, w), avail)
        else:
            # the executing batch's device input and assembled output
            # stay beside the windows
            avail -= io_batch
            tile = self.tile if self.tile > 0 else \
                self._auto_tile(h, w, avail)
            win = self._frame_bytes(*self._window(h, w, max(tile, 1)))
            per = avail // win
            if tile < 1 or per < 1:
                raise self._does_not_fit(
                    f"a {w}x{h} frame in tiles of {max(tile, 1)}", win,
                    avail)
            n = tiling.plan_tiles(h, w, tile, self.halo).num_tiles
            plan = Plan(tile, int(min(per, batch * n)))
        self._plans[key] = plan
        return plan

    def _plan_replicas(self, h: int, w: int) -> None:
        """Plan every replica's share at (h, w) (and the ensemble's
        rotated (w, h)) before any of them allocates, so that replicas
        sharing a device read its free memory alike."""
        for rep in self._replicas:
            rep._plan_execution(h, w)
            if self.tta and h != w:
                rep._plan_execution(w, h)

    def recommended_queue_depth(self, h: int, w: int) -> int:
        """Completed batches the scheduler may hold beyond the executing
        one: what the free memory left after the plan's working set
        (tiled or whole-frame, with TTA's accumulator) affords in IO sets,
        clamped to [1, 3]; on a mesh the least of the replicas'."""
        if len(self._replicas) > 1:
            self._plan_replicas(h, w)
        return min(rep._queue_depth(h, w) for rep in self._replicas)

    def _queue_depth(self, h: int, w: int) -> int:
        """recommended_queue_depth of this replica's share."""
        plan = self._plan_execution(h, w)
        if self.device.type != "cuda":
            return 2
        io_batch = self._io_batch_bytes(h, w)
        if plan.tile:
            ws = io_batch + plan.per_call \
                * self._frame_bytes(*self._window(h, w, plan.tile))
        else:
            ws = plan.per_call * self._frame_bytes(h, w)
        ws += self._tta_bytes(h, w)
        headroom = (int(self._free_bytes() * _MEM_FRACTION) - ws) \
            // max(io_batch, 1)
        return int(min(3, max(1, headroom - 1)))

    @property
    def halo(self) -> int:
        """Tile halo radius.  SRVGG: the exact receptive-field radius, 1 px
        per 3x3 conv.  RRDB: RRDB_HALO, reve_tpu's approximation."""
        if self._rrdb:
            return RRDB_HALO
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
        if self._rrdb and self._int8:
            return rrdb.apply_int8(self.params, self._qbody, u8,
                                   cfg=self.cfg,
                                   compute_dtype=self.compute_dtype)
        if self._rrdb:
            return rrdb.apply(self.params, u8, cfg=self.cfg,
                              compute_dtype=self.compute_dtype)
        if self._int8:
            return srvgg.apply_int8(self.params, self._qbody, u8,
                                    cfg=self.cfg,
                                    compute_dtype=self.compute_dtype)
        return srvgg.apply(self.params, u8, cfg=self.cfg,
                           compute_dtype=self.compute_dtype)

    # -- int8 calibration and certification --------------------------------

    def _dp_pad(self, frames: np.ndarray):
        """Pad a calibration/certification batch to a multiple of the
        mesh's dp size by repeating frames cyclically, as reve_tpu pads
        it for its sharded placement (without a mesh: as it is).  Returns
        (padded, n_real); duplicates are excluded from the certificate's
        PSNR and only repeat existing content in the statistics."""
        if self.mesh is None:
            return frames, len(frames)
        dp = self.mesh.shape["dp"]
        n = len(frames)
        pad = (-n) % dp
        if pad == 0:
            return frames, n
        reps = frames[np.arange(n, n + pad) % n]
        return np.concatenate([frames, reps]), n

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
        max-combined across chunks (_chunked_maxima).  The sample is
        padded by cyclic frame repeats to a chunk multiple, as reve_tpu
        pads it, so the chunks and hence the percentile scales are the
        reference's.  On a mesh the statistic is reve_tpu's sharded
        calibration's, the dp-padded sample's as one chunk
        (_mesh_maxima).  Every replica installs the body."""
        t0 = time.perf_counter()
        frames, _ = self._dp_pad(self._calib_crop(frames))
        maxima = self._chunked_maxima(frames) if self.mesh is None \
            else self._mesh_maxima(frames)
        self.stats.calibrate_s += time.perf_counter() - t0
        if self.calibration_hook is not None and not provisional:
            maxima = np.asarray(self.calibration_hook(maxima), np.float32)
        self._install_qbody(maxima, provisional)

    def _calib_chunk(self, h: int, w: int) -> int:
        """Frames of a one-device calibration chunk at (h, w): reve_tpu's
        budget of _CALIB_CHUNK_ELEMS activations."""
        return max(1, self._CALIB_CHUNK_ELEMS
                   // max(h * w * self.cfg.num_feat, 1))

    def _chunked_maxima(self, frames: np.ndarray) -> np.ndarray:
        """The one-device statistic: per-layer statistics of each chunk
        max-combined, the sample padded to a chunk multiple."""
        from reve_tpu_torch.weights import quantize

        n, h, w, _c = frames.shape
        chunk = self._calib_chunk(h, w)
        pad = (-n) % chunk
        if pad:
            frames = np.concatenate([frames, frames[np.arange(pad) % n]])
        maxima = None
        with self._on_device():
            for i in range(0, len(frames), chunk):
                x = torch.from_numpy(np.ascontiguousarray(
                    frames[i:i + chunk], np.uint8)).to(self.device)
                m = quantize.collect_maxima(
                    self._params_f32, x, cfg=self.cfg,
                    percentile=self._calib_percentile).cpu().numpy()
                maxima = m if maxima is None else np.maximum(maxima, m)
                del x
            self._release_cache()
        return maxima

    def _mesh_maxima(self, frames: np.ndarray) -> np.ndarray:
        """reve_tpu's sharded calibration: the statistic of the dp-padded
        sample taken as one chunk.  Each replica measures its share (the
        frames a device holds there), in calls of _calib_per_call frames,
        and the parts (maxima, or the frames' elements of the sample's
        strided subsample) are joined on the first replica's device, so
        no device holds more than one call's activations."""
        from reve_tpu_torch.weights import quantize

        n, h, w, _c = frames.shape
        share = n // len(self._replicas)
        parts = []
        for k, rep in enumerate(self._replicas):
            per = rep._calib_per_call(h, w, share)
            with rep._on_device():
                for i in range(k * share, (k + 1) * share, per):
                    x = torch.from_numpy(np.ascontiguousarray(
                        frames[i:min(i + per, (k + 1) * share)],
                        np.uint8)).to(rep.device)
                    parts.append(quantize.collect_maxima(
                        rep._params_f32, x, cfg=rep.cfg,
                        percentile=self._calib_percentile, part=(i, n)))
                    del x
                rep._release_cache()
        with self._on_device():
            return quantize.join_parts(parts, self._calib_percentile,
                                       self.device).cpu().numpy()

    def _calib_per_call(self, h: int, w: int, share: int) -> int:
        """Frames of this replica's calibration share per call: at most a
        one-device chunk and, on CUDA, what its part of the free memory
        holds of the float32 forward's activations (RRDB: its trunk), the
        statistic's |h| copy and the u8 input."""
        per = min(share, self._calib_chunk(h, w))
        if self.device.type == "cuda":
            nf = self.cfg.num_feat
            if self._rrdb:
                u = 4 // self.scale
                act = (h // u) * (w // u) * (
                    self._rrdb_trunk_bytes(torch.float32) + 8 * nf)
            else:
                act = srvgg_act_bytes(h, w, nf, torch.float32) \
                    + 4 * h * w * nf
            need = act + self._in_bytes(h, w)
            per = min(per, int(self._free_bytes() * _MEM_FRACTION) // need)
        return max(1, per)

    def _install_qbody(self, maxima: np.ndarray, provisional: bool) -> None:
        """Quantize every replica's weights with `maxima`."""
        from reve_tpu_torch.weights import quantize

        for rep in self._replicas:
            with rep._on_device():
                # margin absorbs content hotter than the calibration batch
                qbody = quantize.build_qbody(rep._params_f32, rep.cfg,
                                             np.asarray(maxima), margin=1.25)
                # K7q's weights packed once per quantization
                rep._qbody = rrdb.prepare_qbody(qbody) if rep._rrdb \
                    else qbody
            rep._qbody_provisional = provisional
            rep._act_maxima = np.asarray(maxima, np.float32)

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
        for rep in self._replicas:
            rep._qbody = None
            rep._qbody_provisional = False
            rep._act_maxima = None

    def _release_cache(self) -> None:
        """After a chunked pass (a batch's, or the int8 measurement's):
        give the allocator's freed segments back, so that what is
        allocated next does not split one of them and hold it."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

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
        model call (None: from _CALIB_CHUNK_ELEMS, as reve_tpu; the sum
        is chunk-free).  On a mesh it runs on the first replica, the
        dp-pad's repeated frames excluded, as reve_tpu excludes them."""
        if not self._int8:
            raise ValueError("certify_int8 requires an int8 engine")
        self._maybe_calibrate(frames, provisional=False)
        t0 = time.perf_counter()
        measured = self._calib_crop(frames) if crop else \
            np.asarray(frames, np.uint8)
        measured, n_real = self._dp_pad(measured)
        _n, ch, cw, _c = measured.shape
        if chunk is None:
            chunk = self._calib_chunk(ch, cw)
        if self._rrdb and self.device.type == "cuda":
            # the float32 RRDB pass bills ~13 GB a 720p frame: at most the
            # frames that fit the free memory (the sum is chunk-free)
            fit = int(self._free_bytes() * _MEM_FRACTION) // max(
                self._rrdb_bytes(ch, cw, torch.float32)
                + 2 * self._out_bytes(ch, cw) + self._in_bytes(ch, cw), 1)
            chunk = max(1, min(chunk, fit))
        model = rrdb if self._rrdb else srvgg
        sse = 0
        with self._on_device():
            for i in range(0, n_real, chunk):
                x = torch.from_numpy(np.ascontiguousarray(
                    measured[i:min(i + chunk, n_real)],
                    np.uint8)).to(self.device)
                y8 = model.apply_int8(self.params, self._qbody, x,
                                      cfg=self.cfg,
                                      compute_dtype=self.compute_dtype)
                yf = model.apply(self._params_f32, x, cfg=self.cfg,
                                 compute_dtype=torch.float32)
                d = y8.int() - yf.int()
                # each chunk's outputs are freed before the next chunk runs
                del y8, yf, x
                # int64 sum of squares: exact at any frame count
                sse += int((d * d).sum())
                del d
            self._release_cache()
        self.stats.certify_s += time.perf_counter() - t0
        cnt = n_real * (ch * self.scale) * (cw * self.scale) * 3
        mse = max(sse / max(cnt, 1), 1e-12)
        return float(10.0 * np.log10(255.0 ** 2 / mse))

    # -- batches -----------------------------------------------------------

    def warmup(self, h: int, w: int) -> None:
        """Build the kernels (first use compiles them) and the memory plan
        for a resolution, and run one batch of zeros through the model;
        with TTA on, the ensemble also plans and runs the rotated (w, h)
        shape of the odd quarter-turns.  An int8 engine calibrates
        provisionally on the zeros; the first real batch replaces that
        calibration."""
        dummy = np.zeros((self.batch_size, h, w, 3), np.uint8)
        self._maybe_calibrate(dummy, provisional=True)
        self._dispatch(dummy, self.batch_size, self.output_format).result()

    def submit(self, frames: np.ndarray) -> PendingBatch:
        """Enqueue a batch; returns a handle. frames: (n<=batch, H, W, 3) u8.

        Short batches are padded to `batch_size` by repeating the last
        frame (a fixed batch shape per job); padding is cropped in
        result().  An int8 engine without a real calibration calibrates
        on the padded batch first (whole frames, never windows).  With
        TTA on, the handle is a one-shot TTAPendingBatch.  Its result is
        RGB or the planes of `output_format`."""
        return self._submit(frames, self.output_format)

    def _submit(self, frames: np.ndarray,
                fmt: Optional[YUVFormat]) -> PendingBatch:
        n, h, w, _ = frames.shape
        if n < self.batch_size:
            pad = np.repeat(frames[-1:], self.batch_size - n, axis=0)
            frames = np.concatenate([frames, pad], axis=0)
        elif n > self.batch_size:
            raise ValueError(f"batch {n} > batch_size {self.batch_size}")
        self._maybe_calibrate(frames, provisional=False)
        self.stats.frames += n
        self.stats.batches += 1
        return self._dispatch(frames, n, fmt)

    def _pieces(self, x: torch.Tensor):
        """Run the model over the device batch x (B, H, W, 3) u8 in the
        plan's calls; yields (lo, hi, y): y is the u8 output of frames
        lo:hi, which the caller drops before it asks for the next piece.
        Whole frames: one piece per chunk.  Tiles: one piece, the
        windows' cores assembled on the device."""
        b, h, w, _ = x.shape
        plan = self._plan_execution(h, w)
        if plan.tile:
            yield 0, b, tiling.upscale_tiled(
                self._forward, x, scale=self.scale, tile=plan.tile,
                halo=self.halo, chunk=plan.per_call)
            return
        for i in range(0, b, plan.per_call):
            yield i, min(i + plan.per_call, b), \
                self._forward(x[i:i + plan.per_call])
        if plan.per_call < b:
            # the caller has dropped the last chunk's output (each chunk
            # finds the last one's freed segments whole, since nothing is
            # allocated between them): give the segments back, so that
            # nothing allocated before the next pass (TTA's next
            # transformed input, the next batch's) lands in one and splits
            # it, which would keep the next pass's tensors of tens of GB
            # from fitting where free memory suffices
            self._release_cache()

    def _ensemble(self, x: torch.Tensor):
        """The TTA ensemble of the device batch x: per transform, its
        forward transform, the model's pieces and K6 on each piece (exact
        piece by piece: a transform never crosses the batch axis); the
        8th K6 writes the u8 mean.  Yields it as one piece."""
        b, h, w, _ = x.shape
        r = self.scale
        shape = (b, h * r, w * r, 3)
        acc = torch.empty(shape, dtype=tta_mod.ACC_DTYPE, device=x.device)
        mean = torch.empty(shape, dtype=torch.uint8, device=x.device)
        last = len(tta_mod.SPECS) - 1
        for s, (k, flip) in enumerate(tta_mod.SPECS):
            form = tta_mod.FIRST if s == 0 else \
                tta_mod.LAST if s == last else tta_mod.MIDDLE
            for lo, hi, y in self._pieces(
                    tta_mod.forward_transform(x, k, flip)):
                tta_mod.tta_accumulate(y, acc[lo:hi], k, flip, form,
                                       out=mean[lo:hi])
                # freed before the next piece runs (see _dispatch)
                del y
        yield 0, b, mean

    def _dispatch(self, frames: np.ndarray, n: int,
                  fmt: Optional[YUVFormat] = None) -> PendingBatch:
        """Enqueue one padded (batch_size, H, W, 3) u8 batch, a share on
        each replica, through the memory plans' model calls (and, with
        TTA on, the ensemble); `n` frames of it are valid.  With `fmt`, K9
        turns each piece's output into planes on the device and the
        planes are copied out."""
        bs, h, w, _ = frames.shape
        r = self.scale
        cuda = self.device.type == "cuda"
        if cuda:
            host_in = torch.empty((bs, h, w, 3), dtype=torch.uint8,
                                  pin_memory=True)
            host_in.numpy()[...] = frames
        else:
            host_in = torch.from_numpy(np.ascontiguousarray(frames,
                                                            np.uint8))
        if fmt is None:
            host_out = (torch.empty((bs, h * r, w * r, 3), dtype=torch.uint8,
                                    pin_memory=cuda),)
        else:
            host_out = tuple(
                torch.empty(s, dtype=CODE_DTYPES[fmt.bits], pin_memory=cuda)
                for s in color_k.plane_shapes(bs, h * r, w * r))
        if len(self._replicas) > 1:
            self._plan_replicas(h, w)
        share = self._share
        events = [rep._enqueue(host_in[k * share:(k + 1) * share],
                               host_out, k * share, fmt)
                  for k, rep in enumerate(self._replicas)]
        handle = TTAPendingBatch if self.tta else PendingBatch
        return handle(host_out if fmt else host_out[0], n,
                      [e for e in events if e is not None],
                      host_in if cuda else None)

    def _enqueue(self, host_in: torch.Tensor, host_out, offset: int,
                 fmt: Optional[YUVFormat]) -> Optional[torch.cuda.Event]:
        """Enqueue this replica's share `host_in` on its device and
        stream; its frames land at `offset` in the pinned `host_out`.
        Returns the CUDA event recorded after its D2H copies (None on the
        CPU)."""
        event = None
        with self._on_device():
            dev_in = host_in.to(self.device, non_blocking=True)
            pieces = self._ensemble(dev_in) if self.tta else \
                self._pieces(dev_in)
            for lo, hi, y in pieces:
                _copy_out(host_out, offset + lo, offset + hi, y, fmt)
                # a piece's output (and its planes, which _copy_out
                # drops on return) is freed (in stream order) before the
                # next piece runs, so no segment of this piece's large
                # tensors stays held by it: the next piece allocates the
                # same sizes again and finds them whole
                del y
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(self._stream)
        return event

    def upscale_frames(self, frames: np.ndarray) -> np.ndarray:
        """Synchronous convenience: (N, H, W, 3) u8 -> (N, H*s, W*s, 3) u8."""
        outs = []
        pending = []
        for i in range(0, len(frames), self.batch_size):
            pending.append(self._submit(frames[i:i + self.batch_size],
                                        None))
            # keep at most 2 batches in flight
            while len(pending) > 2:
                outs.append(pending.pop(0).result())
        for p in pending:
            outs.append(p.result())
        return np.concatenate(outs, axis=0)
