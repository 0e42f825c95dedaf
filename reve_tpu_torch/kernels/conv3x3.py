"""K1 `conv3x3_bias_prelu` (csrc/conv3x3_tc.cu in bfloat16,
csrc/conv3x3_f32_tc.cu in float32), K3 `conv3x3_u8_bias_prelu`, K4a
`conv3x3_u8_bias_prelu_q8` and K3 at Cin 12 `conv3x3_u8x2_bias`
(csrc/conv3x3.cu), and the weight packing of the tensor-core kernels.

K1 replaces the hidden layers of reve_tpu/models/srvgg.py:apply
(`_prelu(_conv3x3(h, w, b), alpha)`, srvgg.py:88-113, applied at
:205-210); K3 replaces the engine's u8 -> float32 * (1/255) -> compute
dtype cast (reve_tpu/pipeline/engine.py:645, srvgg.py:154) fused with the
first conv + PReLU (srvgg.py:203-204).  Both were one XLA-fused conv graph
on the TPU.  K4a is K3 for the int8 path (srvgg.py:376-379): the same
first conv + PReLU in the compute dtype, then `_quant_s8` (srvgg.py:279-288)
to the s8 input of the first int8 hidden conv.  K3 at Cin 12 is RRDB
x2's conv_first (reve_tpu/models/rrdb.py:192-193, :212; apply_int8
:288-291): reve_tpu/ops/pixel_shuffle.py::pixel_unshuffle by 2 of the u8
frame / 255, then a 3x3 conv 12 -> 64 + bias, no activation; the kernel
reads the unshuffle in place from the x2 frame (K3's template at R = 2,
K = 108 in 112), so no unshuffled copy is written.

Bound per call of 4 1080p frames on an H100 SXM (989 TFLOP/s bf16,
3.35 TB/s): K1 611.5 GFLOP -> 0.618 ms and 2.12 GB -> 0.634 ms (bf16);
K3 25 MB of u8 in and 64 channels out, 1.087 GB in bf16 -> 0.324 ms,
2.148 GB in float32 -> 0.641 ms; K4a 0.556 GB -> 0.166 ms (bytes); K3
at Cin 12 (a trunk of 4 x 540 x 960) 24.9 MB in, 265 MB bf16 out -> 0.087
ms (bytes), float32 six bf16 passes at K = 112, about 178 GFLOP -> 0.18
ms (operations).  All
are implicit GEMMs on the tensor cores (wgmma): K1 in bfloat16 directly
(csrc/conv3x3_tc.cu); in float32 as six bf16 products of its operands
split in three (`split_bf16x3`, then csrc/conv3x3_f32_tc.cu), which keeps
float32 accuracy and is never TF32.  K3 and K4a (csrc/conv3x3.cu) run one
template at K = 27 taps x channels laid out in 32 (`u8conv_k`), A read
into registers from the staged u8 halo (converted, and in float32 split,
once per value), B packed by each block from the HWIO weights (as
`pack_weights_u8conv` lays it out), six bf16 products in float32; their
output, which sets their time, leaves by TMA stores from two staging
buffers.
`bound_ms` in chip_smoke.py is computed from each run's own shapes.

Widths.  K3, K1 and K2 take an SRVGG of any of WIDTHS (32, 64, 96, 128)
features in bfloat16 and float32, and K4a (with K4 and K4h,
kernels/conv3x3_s8.py) in int8.  At 64 they run the kernels above.  K3
and K4a at Cout F are their template's C (the row's GEMM in chunks of 64
output channels, or 32 where F is not a multiple of 64; the output staged
and stored as boxes of 64 bf16 channels in the 128-B swizzle, 32 bf16
channels in the 64-B swizzle, 32 float32 channels, or K4a's 64 s8
channels in the 64-B swizzle and 32 in the 32-B).
K1 and K2 at 32, 96 and 128 run csrc/conv3x3_wide.cuh's templates: the
halo streams in units of 32 input channels (a TMA box of 32 channels in
the 64-B swizzle), since the 64-feature kernels' whole-Cin halos do not
fit a block's shared memory there beside the weights.  K1 keeps its
weights resident where they fit (bf16 at 32 and 96, float32 at 32; two
consumer teams take tiles in turn, so one team's epilogue runs beside
the other's wgmmas); K1 elsewhere and K2 stream them tap by tap through a
ring of four stages.  The weights are packed by `pack_weights_wide`,
once per set of weights (`packed_wide`).  float32 K1 there reads the
split planes of its input and writes those of its output
(`conv3x3_bias_prelu_planes`), so a float32 model runs one split pass a
call, after K3.  Bound per call of 4 1080p frames: K1 bf16 0.317 ms at 32
(bytes), 1.391 ms at 96 and 2.473 ms at 128 (operations, past the card's
ridge), float32 as six bf16 passes 0.93, 8.35 and 14.84 ms; K3 bf16
0.159, 0.475 and 0.634 ms (bytes).

Rounding points follow the JAX reference exactly: weights in the compute
dtype, float32 accumulation, + bias in float32, cast to the compute
dtype, PReLU in the compute dtype with alpha cast to it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from reve_tpu_torch import device as device_mod
from reve_tpu_torch.kernels import LAUNCHES, build
from reve_tpu_torch.ops.pixel_shuffle import pixel_unshuffle

SOURCE = "conv3x3.cu"
#: bfloat16 K1 and K2 on the tensor cores
TC_SOURCE = "conv3x3_tc.cu"
#: float32 K1 and K2 on the tensor cores (bf16x6) and their split pass
F32_SOURCE = "conv3x3_f32_tc.cu"
#: (rows, columns) of those kernels' output tile (TH, TW in TC_SOURCE)
TC_TILE = (4, 64)
#: the channels of the 64-feature kernels and of RRDB's convs
FEAT = 64
#: the SRVGG widths (num_feat) the kernels take: K3, K1 and K2 in
#: bfloat16 and float32, K4a, K4 and K4h in int8; FEAT in the 64-feature
#: kernels, the others in csrc/conv3x3_wide.cuh's (K1, K2),
#: csrc/conv3x3_s8_wide.cuh's (K4, K4h) and K3's template at their Cout
#: (K3, K4a)
WIDTHS = (32, 64, 96, 128)
#: input channels of a unit of the wide forms (CK in conv3x3_wide.cuh):
#: their halo and weights stream unit by unit
WIDE_UNIT = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# -- plain versions ---------------------------------------------------------


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """SAME conv3x3, NHWC x HWIO, float32 accumulation + b in float32,
    cast to x.dtype (reve_tpu srvgg._conv3x3)."""
    device_mod.strict_f32()
    y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                 w.permute(3, 2, 0, 1).float(), padding=1)
    return (y.permute(0, 2, 3, 1) + b.float()).to(x.dtype)


def prelu_plain(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """max(x, 0) + alpha * min(x, 0) in x.dtype (reve_tpu srvgg._prelu)."""
    a = alpha.to(x.dtype)
    return x.clamp_min(0) + a * x.clamp_max(0)


def u8_to_dtype_plain(u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32(u8) * float32(1/255), cast to the compute dtype."""
    return (u8.float() * (1.0 / 255.0)).to(dtype)


def conv3x3_bias_prelu_plain(x, w, b, alpha) -> torch.Tensor:
    return prelu_plain(conv3x3_plain(x, w, b), alpha).contiguous()


def conv3x3_u8_bias_prelu_plain(u8, w, b, alpha) -> torch.Tensor:
    return conv3x3_bias_prelu_plain(u8_to_dtype_plain(u8, w.dtype), w, b,
                                    alpha)


def quant_s8_plain(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """reve_tpu srvgg._quant_s8: round(float32(x) * inv), half to even,
    clipped to +-127, as int8.  `inv` is the float32 tensor 1 / scale (a
    float32 reciprocal, as the reference forms it, never a Python
    double)."""
    return torch.round(x.float() * inv).clamp_(-127, 127).to(torch.int8)


def conv3x3_u8_bias_prelu_q8_plain(u8, w, b, alpha, inv) -> torch.Tensor:
    return quant_s8_plain(conv3x3_u8_bias_prelu_plain(u8, w, b, alpha), inv)


def conv3x3_u8x2_bias_plain(u8, w, b) -> torch.Tensor:
    """K3 at Cin 12's plain version: pixel_unshuffle by 2 of
    dtype(u8 / 255), then conv3x3_plain + b (reve_tpu rrdb.apply's
    conv_first at x2).  Odd dims raise, as reve_tpu's unshuffle does."""
    x = pixel_unshuffle(u8_to_dtype_plain(u8, w.dtype), 2)
    return conv3x3_plain(x, w, b).contiguous()


def split_bf16x3_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 x -> (3, *x.shape) bfloat16 (hi, mid, lo): hi = bf16(x),
    mid = bf16(x - hi), lo = bf16(x - hi - mid).  Each subtraction is
    exact in float32, so hi + mid + lo == x."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return torch.stack([hi, mid, (r - mid.float()).to(torch.bfloat16)])


def merge_bf16x3_plain(planes: torch.Tensor) -> torch.Tensor:
    """(3, ...) bfloat16 planes hi, mid, lo -> float32 (hi + mid) + lo:
    split_bf16x3_plain's value back, exactly (the parts do not overlap,
    so neither addition rounds)."""
    hi, mid, lo = planes.float()
    return (hi + mid) + lo


def padded_n(cout: int) -> int:
    """The N of a wgmma over `cout` output channels: a multiple of 8 (64
    for the hidden convs; 16, 32, 48 for the heads at r = 2, 3, 4)."""
    return (cout + 7) // 8 * 8


def pad_outputs(w: torch.Tensor) -> torch.Tensor:
    """HWIO weights with the output channels padded with zeros to
    padded_n."""
    cout = w.shape[-1]
    return F.pad(w, (0, padded_n(cout) - cout))


#: the K of K3 and K4a's product: tap (dy, dx), channel c at k = 10 dx +
#: 3 dy + c (taps column by column, each column of 9 padded to 10), so
#: k = 9, 19, 29, 30, 31 are zero rows
U8_K = 32
#: the K of K3 at Cin 12: k = 36 dx + 12 dy + c (a column of taps is the
#: 36 values of one unshuffled pixel column), 108 padded to 112
U8X2_K = 112


def _u8conv_slots(cin: int) -> int:
    """Values of one column of taps in the kernel's K order: 9 padded to
    10 at Cin 3, 36 at Cin 12."""
    return 10 if cin == 3 else 3 * cin


def u8conv_k(dy: int, dx: int, c: int, cin: int = 3) -> int:
    return _u8conv_slots(cin) * dx + cin * dy + c


def pack_weights_u8conv(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Cin, C), Cin 3 or 12 (C = 64 at Cin 12; K3's C any of
    WIDTHS), in the compute dtype -> the B operand each block of K3, K4a
    and K3 at Cin 12 packs from those weights in shared memory (the
    kernel's pack_weights; this is its reference, held by the CPU tests):
    (S, K / 8, C, 8) bfloat16 [split][k / 8][n][8], K = U8_K (Cin 3) or
    U8X2_K (Cin 12), with
    packed[s, kb, n, kk] = planes[s, dy, dx, c, n] at k = 8 kb + kk =
    u8conv_k(dy, dx, c, Cin) and 0 at the other k (B K-major in core
    matrices of 8 rows x 16 B).  bfloat16: S = 1, the weights as they
    are; float32: S = 3, split_bf16x3's hi, mid, lo."""
    cin, cout = w.shape[2], w.shape[3]
    kp = U8_K if cin == 3 else U8X2_K
    slots = _u8conv_slots(cin)
    planes = w[None] if w.dtype == torch.bfloat16 else split_bf16x3_plain(w)
    # [s][dx][dy * cin + c][n], each column of taps padded to its slots
    k = F.pad(planes.permute(0, 2, 1, 3, 4).reshape(-1, 3, 3 * cin, cout),
              (0, 0, 0, slots - 3 * cin)).reshape(-1, 3 * slots, cout)
    k = F.pad(k, (0, 0, 0, kp - 3 * slots))
    return k.reshape(-1, kp // 8, 8, cout).permute(0, 1, 3, 2).contiguous()


def pack_weights_bf16x3(w: torch.Tensor) -> torch.Tensor:
    """float32 HWIO (3, 3, Cin, cout) -> the weights float32 K1 and K2
    stream at 64 features (Cin 64), tap by tap: (9, 3, Cin / 8, N, 8)
    bfloat16 [tap][split][k / 8][n][8], N = padded_n(cout), with
    packed[t, s, kb, n, kk] = split_bf16x3(w)[s, t // 3, t % 3, 8 kb + kk,
    n] for n < cout and 0 above (B K-major in core matrices of 8 rows x 16
    B)."""
    cin, n = w.shape[2], padded_n(w.shape[-1])
    s = split_bf16x3_plain(pad_outputs(w)).reshape(3, 9, cin // 8, 8, n)
    return s.permute(1, 0, 2, 4, 3).contiguous()


def pack_weights_wide(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Cin, cout) in the compute dtype, Cin a multiple of
    WIDE_UNIT -> the weights K1 and K2 at 32, 96 and 128 features stream,
    unit by unit and tap by tap (csrc/conv3x3_wide.cuh): (Cin / 32, 9, S,
    4, N, 8) bfloat16 [unit][tap][split][k / 8][n][8], N = padded_n(cout),
    with packed[u, t, s, kb, n, kk] = planes[s, t // 3, t % 3, 32 u + 8 kb
    + kk, n] for n < cout and 0 above (B K-major in core matrices of 8
    rows x 16 B); S = 1, the bfloat16 weights as they are, or 3,
    split_bf16x3's hi, mid, lo of float32 weights."""
    cin, n = w.shape[2], padded_n(w.shape[-1])
    wp = pad_outputs(w)
    planes = wp[None] if w.dtype == torch.bfloat16 else \
        split_bf16x3_plain(wp)
    # [s][tap][u][kb][kk][n] -> [u][tap][s][kb][n][kk]
    s = planes.reshape(-1, 9, cin // WIDE_UNIT, WIDE_UNIT // 8, 8, n)
    return s.permute(2, 1, 0, 3, 5, 4).contiguous()


def packed_once(w: torch.Tensor, pack, attr: str) -> torch.Tensor:
    """pack(w), packed once per set of weights: the pack is kept on `w`
    (as attribute `attr`, one per packer) with the version counter,
    storage, dtype and shape it was packed from, so an in-place update (an
    optimizer step) or new storage gives a fresh pack, never a stale one.
    A tensor without a version counter (made under torch.inference_mode)
    is packed at each call."""
    try:
        key = (w._version, w.data_ptr(), w.dtype, tuple(w.shape))
    except RuntimeError:
        return pack(w)
    held = getattr(w, attr, None)
    if held is not None and held[0] == key:
        return held[1]
    packed = pack(w)
    setattr(w, attr, (key, packed))
    return packed


def packed_wide(w: torch.Tensor) -> torch.Tensor:
    """pack_weights_wide(w), packed once per set of weights
    (`packed_once`)."""
    return packed_once(w, pack_weights_wide, "_reve_wide_pack")


def packed_u8conv(w: torch.Tensor) -> torch.Tensor:
    """pack_weights_u8conv(w), packed once per set of weights
    (`packed_once`): the B that K4a's wide bfloat16 forms copy into each
    block."""
    return packed_once(w, pack_weights_u8conv, "_reve_u8conv_pack")


def packs_u8conv(w: torch.Tensor, q8: bool) -> bool:
    """Whether the u8 kernel of these weights takes them packed
    (packed_u8conv): K4a in bfloat16 at 32, 96 and 128 features (the
    kernel's U8::ROWS forms); the other forms pack the HWIO weights in
    each block."""
    return q8 and w.dtype == torch.bfloat16 and w.shape[-1] != FEAT


# -- kernel wrappers ----------------------------------------------------------


def _check(x: torch.Tensor, w: torch.Tensor, cin: int, in_dtype,
           in_channels=None, cout: int = FEAT) -> None:
    """`cin`, `cout`: the conv's input and output channels (the
    weights'); `in_channels`: the input tensor's, where they differ (K3
    at Cin 12 reads 3-channel frames)."""
    in_channels = cin if in_channels is None else in_channels
    if x.device.type != "cuda":
        raise ValueError(f"tensor on {x.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain version)")
    if w.dtype not in _DTYPE_CODE:
        raise TypeError(f"compute dtype {w.dtype} not supported "
                        f"(float32, bfloat16)")
    if x.dtype != in_dtype:
        raise TypeError(f"input dtype {x.dtype}, expected {in_dtype}")
    if x.dim() != 4 or x.shape[3] != in_channels:
        raise ValueError(f"input shape {tuple(x.shape)}, expected "
                         f"(B, H, W, {in_channels})")
    if tuple(w.shape) != (3, 3, cin, cout):
        raise ValueError(f"weight shape {tuple(w.shape)}, expected "
                         f"(3, 3, {cin}, {cout}) HWIO")
    check_operands(x, w)


def check_operands(*ts: torch.Tensor) -> None:
    """The kernels read their operands as 16-byte vectors of one device."""
    for t in ts:
        if t.device != ts[0].device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous, 16-byte "
                             "aligned and on one device")


def f32_operand(t: torch.Tensor, n: int, device, what: str) -> torch.Tensor:
    """`t` as `n` contiguous float32 values on `device`: a per-channel
    vector or scalar the kernels read."""
    t = t.to(device=device, dtype=torch.float32).contiguous()
    if t.numel() != n:
        raise ValueError(f"{what} must have {n} float32 entries")
    return t


def check_width(feat: int, what: str) -> None:
    """Raise unless `feat` is one of WIDTHS, the SRVGG widths the kernels
    take."""
    if feat not in WIDTHS:
        raise ValueError(f"{what} takes an SRVGG of {WIDTHS} features, got "
                         f"{feat} channels")


def _bias_alpha(b, alpha, dtype, device, n: int = FEAT):
    """b as float32, and alpha as the compute dtype rounds it, widened to
    float32: the per-channel vectors (n each) the kernels read."""
    return (f32_operand(b, n, device, "bias"),
            f32_operand(alpha.to(device).to(dtype), n, device, "alpha"))


def _launch(source: str, entry: str, ins, y: torch.Tensor,
            ints=()) -> None:
    """Call `entry` of `source`'s library: the input tensors' pointers,
    y's, y's B, H, W, then `ints` and the stream; raise on a launch
    error."""
    B, H, W, _ = y.shape
    lib = build.load(source)
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * (len(ins) + 1)
                   + [ctypes.c_int] * (3 + len(ints)) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(*(t.data_ptr() for t in ins), y.data_ptr(), B, H, W, *ints,
             torch.cuda.current_stream(y.device).cuda_stream)
    build.check(lib, err, entry)


def _row_stride(x: torch.Tensor):
    """The stride between the rows (last-dim runs) of x when its leading
    dims walk rows of one stride (a channel slice of contiguous NHWC
    pixels, or a contiguous tensor), else None."""
    if x.dim() == 0 or x.stride(-1) != 1:
        return None
    if x.dim() == 1:
        return x.shape[-1]
    step, want = x.stride(-2), x.stride(-2)
    for n, st in zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])):
        if n > 1 and st != want:
            return None
        want *= n
    return step


def split_bf16x3(x: torch.Tensor) -> torch.Tensor:
    """The split pass of float32 K1, K2 and K7: (..., C) float32 -> (3,
    ..., C) bfloat16 planes hi, mid, lo (see split_bf16x3_plain).  `x` is
    contiguous, or a slice of the leading C channels of contiguous pixels
    (K7's input: the channels its conv reads), C a multiple of 8."""
    if x.device.type == "cpu":
        return split_bf16x3_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"tensor on {x.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain version)")
    if x.dtype != torch.float32:
        raise TypeError(f"split_bf16x3 takes float32, got {x.dtype}")
    if x.is_contiguous():
        # a flat run: rows of 8 values, back to back
        rows, cols, stride = x.numel() // 8, 8, 8
        ok = x.numel() % 8 == 0
        check_operands(x)
    else:
        stride, cols = _row_stride(x), x.shape[-1]
        rows = x.numel() // max(cols, 1)
        ok = stride is not None and cols % 8 == 0 and stride % 4 == 0 \
            and x.data_ptr() % 16 == 0
    if not ok:
        raise ValueError(
            f"split_bf16x3 takes a contiguous tensor of a multiple of 8 "
            f"values or rows of a multiple of 8 values 16-B aligned, got "
            f"shape {tuple(x.shape)} strides {x.stride()}")
    out = torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device)
    lib = build.load(F32_SOURCE)
    fn = lib.reve_split_bf16x3
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), out.data_ptr(), rows, cols, stride,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "split_bf16x3")
    LAUNCHES["split_bf16x3"] += 1
    return out


def conv3x3_bias_prelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       alpha: torch.Tensor) -> torch.Tensor:
    """K1: (B, H, W, F) x (3, 3, F, F) HWIO in the compute dtype, F one of
    WIDTHS -> PReLU(dtype(conv + b)) (B, H, W, F) in the compute dtype.
    float32 launches two kernels: the split pass and the bf16x6 conv
    (conv3x3_bias_prelu_planes takes and gives the planes instead).  F =
    64 runs the 64-feature kernels, the other widths the wide forms
    (csrc/conv3x3_wide.cuh), their weights packed once (packed_wide)."""
    if x.device.type == "cpu":
        return conv3x3_bias_prelu_plain(x, w, b, alpha)
    feat = x.shape[-1] if x.dim() == 4 else FEAT
    check_width(feat, "K1")
    _check(x, w, feat, w.dtype, cout=feat)
    y = torch.empty(x.shape, dtype=w.dtype, device=x.device)
    bb, aa = _bias_alpha(b, alpha, w.dtype, x.device, feat)
    bf16 = w.dtype == torch.bfloat16
    if feat == FEAT and bf16:
        _launch(TC_SOURCE, "reve_conv3x3_bias_prelu_tc", (x, w, bb, aa), y)
    elif feat == FEAT:
        _launch(F32_SOURCE, "reve_conv3x3_bias_prelu_f32tc",
                (split_bf16x3(x), pack_weights_bf16x3(w), bb, aa), y)
    elif bf16:
        _launch(TC_SOURCE, "reve_conv3x3_bias_prelu_wide_tc",
                (x, packed_wide(w), bb, aa), y, (feat,))
    else:
        _launch_wide_f32(split_bf16x3(x), w, bb, aa, y, None)
    LAUNCHES["conv3x3_bias_prelu"] += 1
    return y


def _launch_wide_f32(xp, w, bb, aa, y, planes) -> None:
    """float32 K1 at a wide width on the split planes `xp` of its input:
    its float32 output into `y` and its split planes into `planes` (each
    or None, not both)."""
    _, B, H, W, feat = xp.shape
    lib = build.load(F32_SOURCE)
    fn = lib.reve_conv3x3_bias_prelu_wide_f32tc_planes
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(xp.data_ptr(), packed_wide(w).data_ptr(), bb.data_ptr(),
             aa.data_ptr(), None if y is None else y.data_ptr(),
             None if planes is None else planes.data_ptr(), B, H, W, feat,
             torch.cuda.current_stream(xp.device).cuda_stream)
    build.check(lib, err, "conv3x3_bias_prelu (float32)")


def conv3x3_bias_prelu_planes_plain(xp, w, b, alpha, value: bool = False):
    """conv3x3_bias_prelu_planes' plain version: split_bf16x3_plain of the
    plain float32 K1 on the planes' value (and that output)."""
    y = conv3x3_bias_prelu_plain(merge_bf16x3_plain(xp), w, b, alpha)
    planes = split_bf16x3_plain(y)
    return (planes, y) if value else planes


def conv3x3_bias_prelu_planes(xp: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor, alpha: torch.Tensor,
                              value: bool = False):
    """float32 K1 at the wide widths (32, 96, 128) on split planes: `xp`
    (3, B, H, W, F) bfloat16, the hi, mid and lo planes of its float32
    input (split_bf16x3's, or this function's), `w` (3, 3, F, F) float32
    HWIO -> the planes (3, B, H, W, F) of PReLU(conv + b), bit for bit
    split_bf16x3 of the output conv3x3_bias_prelu gives on that input, so
    the next layer runs no split pass; with `value`, (planes, that float32
    output (B, H, W, F)), both written by the one kernel.  Its launches
    are counted under "conv3x3_bias_prelu_planes", apart from the
    float32-out form's."""
    if xp.device.type == "cpu":
        return conv3x3_bias_prelu_planes_plain(xp, w, b, alpha, value)
    if xp.dtype != torch.bfloat16 or w.dtype != torch.float32:
        raise TypeError(f"K1 on planes takes bfloat16 planes and float32 "
                        f"weights, got {xp.dtype} / {w.dtype}")
    if xp.dim() != 5 or xp.shape[0] != 3:
        raise ValueError(f"planes shape {tuple(xp.shape)}, expected (3, B, "
                         f"H, W, F)")
    feat = xp.shape[-1]
    check_width(feat, "K1")
    if feat == FEAT:
        raise ValueError("K1 on planes takes the wide widths (32, 96, 128); "
                         "at 64 conv3x3_bias_prelu splits its input")
    _check(xp[0], w, feat, torch.bfloat16, cout=feat)
    check_operands(xp, w)
    planes = torch.empty_like(xp)
    y = torch.empty(xp.shape[1:], dtype=torch.float32, device=xp.device) \
        if value else None
    bb, aa = _bias_alpha(b, alpha, torch.float32, xp.device, feat)
    _launch_wide_f32(xp, w, bb, aa, y, planes)
    LAUNCHES["conv3x3_bias_prelu_planes"] += 1
    return (planes, y) if value else planes


def _launch_u8(entry: str, u8, w, b, alpha, inv=None) -> torch.Tensor:
    """K3 (inv None) or K4a at w's Cout: the launch of `entry` of
    csrc/conv3x3.cu in w's dtype (the kernel packs the HWIO weights
    itself, but for the forms that take them packed once:
    packs_u8conv)."""
    B, H, W, _ = u8.shape
    cout = w.shape[-1]
    y = torch.empty((B, H, W, cout),
                    dtype=w.dtype if inv is None else torch.int8,
                    device=u8.device)
    bb, aa = _bias_alpha(b, alpha, w.dtype, u8.device, cout)
    wk = packed_u8conv(w) if packs_u8conv(w, inv is not None) else w
    ins = [u8, wk, bb, aa]
    if inv is not None:
        ins.append(f32_operand(inv, 1, u8.device, "inv (1 / scale)"))
    _launch(SOURCE, entry, ins, y, (_DTYPE_CODE[w.dtype], cout))
    return y


def conv3x3_u8_bias_prelu(u8: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          alpha: torch.Tensor) -> torch.Tensor:
    """K3: (B, H, W, 3) uint8 x (3, 3, 3, F) HWIO in the compute dtype, F
    one of WIDTHS -> PReLU(dtype(conv(dtype(u8 / 255)) + b)) (B, H, W,
    F)."""
    if u8.device.type == "cpu":
        return conv3x3_u8_bias_prelu_plain(u8, w, b, alpha)
    feat = w.shape[-1] if w.dim() == 4 else FEAT
    check_width(feat, "K3")
    _check(u8, w, 3, torch.uint8, cout=feat)
    y = _launch_u8("reve_conv3x3_u8_bias_prelu", u8, w, b, alpha)
    LAUNCHES["conv3x3_u8_bias_prelu"] += 1
    return y


def conv3x3_u8_bias_prelu_q8(u8: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor, alpha: torch.Tensor,
                             inv: torch.Tensor) -> torch.Tensor:
    """K4a: K3, then the s8 quantize of its PReLU output ->
    clip(round(float32(h) * inv), +-127) (B, H, W, F) int8, F one of
    WIDTHS.  `inv`: one float32 value, 1 / act_scale[0]."""
    if u8.device.type == "cpu":
        return conv3x3_u8_bias_prelu_q8_plain(u8, w, b, alpha, inv)
    feat = w.shape[-1] if w.dim() == 4 else FEAT
    check_width(feat, "K4a")
    _check(u8, w, 3, torch.uint8, cout=feat)
    y = _launch_u8("reve_conv3x3_u8_bias_prelu_q8", u8, w, b, alpha, inv)
    LAUNCHES["conv3x3_u8_bias_prelu_q8"] += 1
    return y


def conv3x3_u8x2_bias(u8: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """K3 at Cin 12: (B, 2H, 2W, 3) uint8 x (3, 3, 12, 64) HWIO in the
    compute dtype -> dtype(conv(pixel_unshuffle(dtype(u8 / 255), 2)) + b)
    (B, H, W, 64), the unshuffle read in place by the kernel.  Odd frame
    dims are refused, as reve_tpu's pixel_unshuffle refuses them."""
    if u8.device.type == "cpu":
        return conv3x3_u8x2_bias_plain(u8, w, b)
    if u8.dim() != 4 or u8.shape[1] % 2 or u8.shape[2] % 2:
        raise ValueError(f"input shape {tuple(u8.shape)}: K3 at Cin 12 "
                         f"takes (B, 2H, 2W, 3) frames of even dims")
    _check(u8, w, 12, torch.uint8, in_channels=3)
    B, H2, W2, _ = u8.shape
    y = torch.empty((B, H2 // 2, W2 // 2, FEAT), dtype=w.dtype,
                    device=u8.device)
    # the kernel's PReLU at alpha 1: the identity
    bb, aa = _bias_alpha(b, torch.ones(FEAT, device=u8.device), w.dtype,
                         u8.device)
    _launch(SOURCE, "reve_conv3x3_u8x2_bias", (u8, w, bb, aa), y,
            (_DTYPE_CODE[w.dtype],))
    LAUNCHES["conv3x3_u8x2_bias"] += 1
    return y
