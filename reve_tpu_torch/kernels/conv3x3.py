"""K1 `conv3x3_bias_prelu` (csrc/conv3x3_tc.cu in bfloat16,
csrc/conv3x3_f32_tc.cu in float32), K3 `conv3x3_u8_bias_prelu` and K4a
`conv3x3_u8_bias_prelu_q8` (csrc/conv3x3.cu), and the weight packing of
the tensor-core kernels.

K1 replaces the hidden layers of reve_tpu/models/srvgg.py:apply
(`_prelu(_conv3x3(h, w, b), alpha)`, srvgg.py:88-113, applied at
:205-210); K3 replaces the engine's u8 -> float32 * (1/255) -> compute
dtype cast (reve_tpu/pipeline/engine.py:645, srvgg.py:154) fused with the
first conv + PReLU (srvgg.py:203-204).  Both were one XLA-fused conv graph
on the TPU.  K4a is K3 for the int8 path (srvgg.py:376-379): the same
first conv + PReLU in the compute dtype, then `_quant_s8` (srvgg.py:279-288)
to the s8 input of the first int8 hidden conv.

Bound per call of 4 1080p frames on an H100 SXM (989 TFLOP/s bf16,
3.35 TB/s): K1 611.5 GFLOP -> 0.618 ms and 2.12 GB -> 0.634 ms (bf16);
K3 25 MB of u8 in and 64 channels out, 1.087 GB in bf16 -> 0.324 ms,
2.148 GB in float32 -> 0.641 ms; K4a 0.556 GB -> 0.166 ms (bytes).  All
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

SOURCE = "conv3x3.cu"
#: bfloat16 K1 and K2 on the tensor cores
TC_SOURCE = "conv3x3_tc.cu"
#: float32 K1 and K2 on the tensor cores (bf16x6) and their split pass
F32_SOURCE = "conv3x3_f32_tc.cu"
#: (rows, columns) of those kernels' output tile (TH, TW in TC_SOURCE)
TC_TILE = (4, 64)
FEAT = 64
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


def split_bf16x3_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 x -> (3, *x.shape) bfloat16 (hi, mid, lo): hi = bf16(x),
    mid = bf16(x - hi), lo = bf16(x - hi - mid).  Each subtraction is
    exact in float32, so hi + mid + lo == x."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return torch.stack([hi, mid, (r - mid.float()).to(torch.bfloat16)])


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


def u8conv_k(dy: int, dx: int, c: int) -> int:
    return 10 * dx + 3 * dy + c


def pack_weights_u8conv(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, 3, 64) in the compute dtype -> the B operand each block
    of K3 and K4a packs from those weights in shared memory (the kernel's
    pack_weights; this is its reference, held by the CPU tests): (S, 4,
    64, 8) bfloat16 [split][k / 8][n][8], with packed[s, kb, n, kk] =
    planes[s, dy, dx, c, n] at k = 8 kb + kk = u8conv_k(dy, dx, c) and 0
    at the other k (B K-major in core matrices of 8 rows x 16 B).
    bfloat16: S = 1, the weights as they are; float32: S = 3,
    split_bf16x3's hi, mid, lo."""
    planes = w[None] if w.dtype == torch.bfloat16 else split_bf16x3_plain(w)
    # [s][dx][dy * 3 + c][n], each column of taps padded from 9 to 10
    k = F.pad(planes.permute(0, 2, 1, 3, 4).reshape(-1, 3, 9, FEAT),
              (0, 0, 0, 1)).reshape(-1, 30, FEAT)
    k = F.pad(k, (0, 0, 0, U8_K - 30))
    return k.reshape(-1, U8_K // 8, 8, FEAT).permute(0, 1, 3, 2).contiguous()


def pack_weights_bf16x3(w: torch.Tensor) -> torch.Tensor:
    """float32 HWIO (3, 3, 64, cout) -> the weights float32 K1 and K2
    stream, tap by tap: (9, 3, 8, N, 8) bfloat16 [tap][split][k / 8][n][8],
    N = padded_n(cout), with packed[t, s, kb, n, kk] = split_bf16x3(w)[s,
    t // 3, t % 3, 8 kb + kk, n] for n < cout and 0 above (B K-major in
    core matrices of 8 rows x 16 B)."""
    n = padded_n(w.shape[-1])
    s = split_bf16x3_plain(pad_outputs(w)).reshape(3, 9, FEAT // 8, 8, n)
    return s.permute(1, 0, 2, 4, 3).contiguous()


# -- kernel wrappers ----------------------------------------------------------


def _check(x: torch.Tensor, w: torch.Tensor, cin: int, in_dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"tensor on {x.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain version)")
    if w.dtype not in _DTYPE_CODE:
        raise TypeError(f"compute dtype {w.dtype} not supported "
                        f"(float32, bfloat16)")
    if x.dtype != in_dtype:
        raise TypeError(f"input dtype {x.dtype}, expected {in_dtype}")
    if x.dim() != 4 or x.shape[3] != cin:
        raise ValueError(f"input shape {tuple(x.shape)}, expected "
                         f"(B, H, W, {cin})")
    if tuple(w.shape) != (3, 3, cin, FEAT):
        raise ValueError(f"weight shape {tuple(w.shape)}, expected "
                         f"(3, 3, {cin}, {FEAT}) HWIO")
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


def _bias_alpha(b, alpha, dtype, device):
    """b as float32, and alpha as the compute dtype rounds it, widened to
    float32: the per-channel vectors the kernels read."""
    return (f32_operand(b, FEAT, device, "bias"),
            f32_operand(alpha.to(device).to(dtype), FEAT, device, "alpha"))


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


def split_bf16x3(x: torch.Tensor) -> torch.Tensor:
    """The split pass of float32 K1 and K2: (..., 64) float32 -> (3, ...,
    64) bfloat16 planes hi, mid, lo (see split_bf16x3_plain)."""
    if x.device.type == "cpu":
        return split_bf16x3_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"tensor on {x.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain version)")
    if x.dtype != torch.float32:
        raise TypeError(f"split_bf16x3 takes float32, got {x.dtype}")
    if x.numel() % 8:
        raise ValueError(f"split_bf16x3 takes a multiple of 8 values, got "
                         f"{x.numel()}")
    check_operands(x)
    out = torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device)
    lib = build.load(F32_SOURCE)
    fn = lib.reve_split_bf16x3
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), out.data_ptr(), x.numel(),
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "split_bf16x3")
    LAUNCHES["split_bf16x3"] += 1
    return out


def conv3x3_bias_prelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       alpha: torch.Tensor) -> torch.Tensor:
    """K1: (B, H, W, 64) x (3, 3, 64, 64) HWIO in the compute dtype ->
    PReLU(dtype(conv + b)) (B, H, W, 64) in the compute dtype.  float32
    launches two kernels: the split pass and the bf16x6 conv."""
    if x.device.type == "cpu":
        return conv3x3_bias_prelu_plain(x, w, b, alpha)
    _check(x, w, FEAT, w.dtype)
    y = torch.empty(x.shape, dtype=w.dtype, device=x.device)
    bb, aa = _bias_alpha(b, alpha, w.dtype, x.device)
    if w.dtype == torch.bfloat16:
        _launch(TC_SOURCE, "reve_conv3x3_bias_prelu_tc", (x, w, bb, aa), y)
    else:
        _launch(F32_SOURCE, "reve_conv3x3_bias_prelu_f32tc",
                (split_bf16x3(x), pack_weights_bf16x3(w), bb, aa), y)
    LAUNCHES["conv3x3_bias_prelu"] += 1
    return y


def _launch_u8(entry: str, u8, w, b, alpha, inv=None) -> torch.Tensor:
    """K3 (inv None) or K4a: the launch of `entry` of csrc/conv3x3.cu in
    w's dtype (the kernel packs the HWIO weights itself)."""
    B, H, W, _ = u8.shape
    y = torch.empty((B, H, W, FEAT),
                    dtype=w.dtype if inv is None else torch.int8,
                    device=u8.device)
    bb, aa = _bias_alpha(b, alpha, w.dtype, u8.device)
    ins = [u8, w, bb, aa]
    if inv is not None:
        ins.append(f32_operand(inv, 1, u8.device, "inv (1 / scale)"))
    _launch(SOURCE, entry, ins, y, (_DTYPE_CODE[w.dtype],))
    return y


def conv3x3_u8_bias_prelu(u8: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          alpha: torch.Tensor) -> torch.Tensor:
    """K3: (B, H, W, 3) uint8 x (3, 3, 3, 64) HWIO in the compute dtype ->
    PReLU(dtype(conv(dtype(u8 / 255)) + b)) (B, H, W, 64)."""
    if u8.device.type == "cpu":
        return conv3x3_u8_bias_prelu_plain(u8, w, b, alpha)
    _check(u8, w, 3, torch.uint8)
    y = _launch_u8("reve_conv3x3_u8_bias_prelu", u8, w, b, alpha)
    LAUNCHES["conv3x3_u8_bias_prelu"] += 1
    return y


def conv3x3_u8_bias_prelu_q8(u8: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor, alpha: torch.Tensor,
                             inv: torch.Tensor) -> torch.Tensor:
    """K4a: K3, then the s8 quantize of its PReLU output ->
    clip(round(float32(h) * inv), +-127) (B, H, W, 64) int8.  `inv`: one
    float32 value, 1 / act_scale[0]."""
    if u8.device.type == "cpu":
        return conv3x3_u8_bias_prelu_q8_plain(u8, w, b, alpha, inv)
    _check(u8, w, 3, torch.uint8)
    y = _launch_u8("reve_conv3x3_u8_bias_prelu_q8", u8, w, b, alpha, inv)
    LAUNCHES["conv3x3_u8_bias_prelu_q8"] += 1
    return y
