"""K4 `conv3x3_s8_dq_prelu_q8` (csrc/conv3x3_s8.cu): one hidden layer of
the int8 SRVGG body.  The same source holds K4h, the int8 head (its
wrapper is kernels/head.py's).

Replaces the classic-domain loop of reve_tpu/models/srvgg.py:apply_int8
(srvgg.py:380-382): `_conv3x3_s8` (s8 x s8 -> s32, :268-276), the
`dq_prelu` epilogue (float32(y32) * (act_scale[i] * sw[i]) + b, PReLU in
float32 with float32 alpha, :322-329) and `_quant_s8` to the next layer's
s8 input (:279-288), which XLA fused into one conv on the TPU.

Bound per call of 4 1080p frames on an H100 SXM (1979 TOP/s s8 dense,
3.35 TB/s): 611.5 GOP -> 0.31 ms; 1.06 GB of s8 in + out -> 0.32 ms.  The
kernel is an implicit GEMM on s8 `wgmma` (m64n64k32) with TMA halo loads
(see the .cu header); the wrapper packs the weights for it
(`pack_weights_s8`), once per set of weights (`packed_s8`).

Widths.  K4 and K4h take an SRVGG of any of conv3x3.WIDTHS (32, 64, 96,
128) features.  At 64 they run the kernels above; at 32, 96 and 128
csrc/conv3x3_s8_wide.cuh's template (instantiated by the same source): the
halo streams in units of 32 input channels (a TMA box of 32 s8 channels in
the 32-B swizzle, one k32 step of m64nNk32 wgmma a tap), the weights
packed unit by unit (`pack_weights_s8_wide`, once per set of weights:
`packed_s8_wide`) and resident in shared memory (147 KB for K4 at 128),
consumer teams of warpgroups taking tiles in turn so that one team's
epilogue runs beside another's wgmmas.
Bound per call of 4 1080p frames: K4 at 32 0.158 ms (bytes), at 96 1,376
GOP -> 0.695 ms and at 128 2,446 GOP -> 1.236 ms (operations).

The integer accumulation is exact, so the kernel is bit-exact against its
plain version (at 128 features the s32 sum may pass 2^24, and its float32
conversion rounds to nearest even in both).  CUDA has no integer conv in
torch, so the plain version computes the s8 conv in float64 and rounds to
int32, which is exact here: |sum| <= 9 * 128 * 127^2 < 2^53.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from reve_tpu_torch.kernels import LAUNCHES, build
from reve_tpu_torch.kernels.conv3x3 import (FEAT, WIDE_UNIT,
                                            check_operands, check_width,
                                            f32_operand, pad_outputs,
                                            packed_once, padded_n,
                                            quant_s8_plain)

SOURCE = "conv3x3_s8.cu"


# -- plain versions ---------------------------------------------------------


def conv3x3_s8_plain(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """SAME conv3x3, NHWC s8 x HWIO s8 -> s32 (reve_tpu
    srvgg._conv3x3_s8), computed exactly in float64."""
    y = F.conv2d(x8.permute(0, 3, 1, 2).double(),
                 w8.permute(3, 2, 0, 1).double(), padding=1)
    return y.permute(0, 2, 3, 1).round().to(torch.int32)


def dq_prelu_plain(y32: torch.Tensor, scale: torch.Tensor, b: torch.Tensor,
                   alpha: torch.Tensor) -> torch.Tensor:
    """apply_int8.dq_prelu: float32(y32) * scale + b, then
    max(fy, 0) + alpha * min(fy, 0), all in float32."""
    fy = y32.float() * scale.float() + b.float()
    return fy.clamp_min(0) + alpha.float() * fy.clamp_max(0)


def conv3x3_s8_dq_prelu_q8_plain(x8, w8, scale, b, alpha,
                                 inv_next) -> torch.Tensor:
    return quant_s8_plain(
        dq_prelu_plain(conv3x3_s8_plain(x8, w8), scale, b, alpha),
        inv_next).contiguous()


def pack_weights_s8(w8: torch.Tensor) -> torch.Tensor:
    """s8 HWIO (3, 3, Cin, cout), Cin a multiple of 16 -> (9, Cin / 16, N,
    16) int8 [tap][k / 16][n][16], N = padded_n(cout), packed[t, kb, n, kk]
    = w8[t // 3, t % 3, 16 kb + kk, n] for n < cout and 0 above (B K-major
    in core matrices of 8 rows x 16 B): at Cin 64 the resident weights of
    the 64-feature K4 and K4h."""
    cin, n = w8.shape[2], padded_n(w8.shape[-1])
    return pad_outputs(w8).reshape(9, cin // 16, 16, n) \
        .permute(0, 1, 3, 2).contiguous()


def pack_weights_s8_wide(w8: torch.Tensor) -> torch.Tensor:
    """s8 HWIO (3, 3, Cin, cout), Cin a multiple of WIDE_UNIT -> the
    weights K4 and K4h at 32, 96 and 128 features take, unit by unit and
    tap by tap (csrc/conv3x3_s8_wide.cuh): (Cin / 32, 9, 2, N, 16) int8
    [unit][tap][k / 16][n][16], N = padded_n(cout), with packed[u, t, kb,
    n, kk] = w8[t // 3, t % 3, 32 u + 16 kb + kk, n] for n < cout and 0
    above: pack_weights_s8's blocks regrouped so that a unit's nine taps
    are one contiguous run."""
    cin = w8.shape[2]
    p = pack_weights_s8(w8)
    return p.reshape(9, cin // WIDE_UNIT, WIDE_UNIT // 16, *p.shape[2:]) \
        .permute(1, 0, 2, 3, 4).contiguous()


def packed_s8(w8: torch.Tensor) -> torch.Tensor:
    """pack_weights_s8(w8), packed once per set of weights (as
    conv3x3.packed_wide: kept on `w8` with its version counter, storage,
    dtype and shape, so never stale)."""
    return packed_once(w8, pack_weights_s8, "_reve_s8_pack")


def packed_s8_wide(w8: torch.Tensor) -> torch.Tensor:
    """pack_weights_s8_wide(w8), packed once per set of weights (as
    packed_s8)."""
    return packed_once(w8, pack_weights_s8_wide, "_reve_s8_wide_pack")


# -- kernel wrapper -----------------------------------------------------------


def conv3x3_s8_dq_prelu_q8(x8: torch.Tensor, w8: torch.Tensor,
                           scale: torch.Tensor, b: torch.Tensor,
                           alpha: torch.Tensor,
                           inv_next: torch.Tensor) -> torch.Tensor:
    """K4: (B, H, W, F) int8 x (3, 3, F, F) int8 HWIO, F one of
    conv3x3.WIDTHS -> the next layer's (B, H, W, F) int8 input.  `scale` =
    act_scale[i] * sw[i] (F float32), `b` and `alpha` (F float32),
    `inv_next` = one float32 value, 1 / act_scale[i + 1] — each formed in
    torch as the reference forms it.  F = 64 runs the 64-feature kernel,
    the other widths the wide form (csrc/conv3x3_s8_wide.cuh)."""
    if x8.device.type == "cpu":
        return conv3x3_s8_dq_prelu_q8_plain(x8, w8, scale, b, alpha,
                                            inv_next)
    if x8.device.type != "cuda":
        raise ValueError(f"tensor on {x8.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain version)")
    if x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise TypeError(f"K4 takes int8 activations and weights, got "
                        f"{x8.dtype} / {w8.dtype}")
    feat = x8.shape[3] if x8.dim() == 4 else FEAT
    check_width(feat, "K4")
    if x8.dim() != 4 or tuple(w8.shape) != (3, 3, feat, feat):
        raise ValueError(f"shapes {tuple(x8.shape)} x {tuple(w8.shape)}; "
                         f"expected (B, H, W, {feat}) x (3, 3, {feat}, "
                         f"{feat}) HWIO")
    check_operands(x8, w8)
    dev = x8.device
    ss = f32_operand(scale, feat, dev, "scale")
    bb = f32_operand(b, feat, dev, "b")
    aa = f32_operand(alpha, feat, dev, "alpha")
    inv = f32_operand(inv_next, 1, dev, "inv_next")
    B, H, W, _ = x8.shape
    y = torch.empty_like(x8)
    lib = build.load(SOURCE)
    if feat == FEAT:
        fn, wp, ints = lib.reve_conv3x3_s8_dq_prelu_q8, packed_s8(w8), ()
    else:
        fn, wp, ints = lib.reve_conv3x3_s8_dq_prelu_q8_wide, \
            packed_s8_wide(w8), (feat,)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * (3 + len(ints)) \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x8.data_ptr(), wp.data_ptr(), ss.data_ptr(), bb.data_ptr(),
             aa.data_ptr(), inv.data_ptr(), y.data_ptr(), B, H, W, *ints,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "conv3x3_s8_dq_prelu_q8")
    LAUNCHES["conv3x3_s8_dq_prelu_q8"] += 1
    return y
