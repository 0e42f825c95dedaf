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
(`pack_weights_s8`).

The integer accumulation is exact, so the kernel is bit-exact against its
plain version.  CUDA has no integer conv in torch, so the plain version
computes the s8 conv in float64 and rounds to int32, which is exact here:
|sum| <= 9 * 64 * 127^2 < 2^53.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from reve_tpu_torch.kernels import LAUNCHES, build
from reve_tpu_torch.kernels.conv3x3 import (FEAT, check_operands,
                                            f32_operand, pad_outputs,
                                            padded_n, quant_s8_plain)

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
    """s8 HWIO (3, 3, 64, cout) -> the resident weights of K4 and K4h: (9,
    4, N, 16) int8 [tap][k / 16][n][16], N = padded_n(cout),
    packed[t, kb, n, kk] = w8[t // 3, t % 3, 16 kb + kk, n] for n < cout
    and 0 above (B K-major in core matrices of 8 rows x 16 B)."""
    n = padded_n(w8.shape[-1])
    return pad_outputs(w8).reshape(9, FEAT // 16, 16, n) \
        .permute(0, 1, 3, 2).contiguous()


# -- kernel wrapper -----------------------------------------------------------


def conv3x3_s8_dq_prelu_q8(x8: torch.Tensor, w8: torch.Tensor,
                           scale: torch.Tensor, b: torch.Tensor,
                           alpha: torch.Tensor,
                           inv_next: torch.Tensor) -> torch.Tensor:
    """K4: (B, H, W, 64) int8 x (3, 3, 64, 64) int8 HWIO -> the next
    layer's (B, H, W, 64) int8 input.  `scale` = act_scale[i] * sw[i] (64
    float32), `b` and `alpha` (64 float32), `inv_next` = one float32 value,
    1 / act_scale[i + 1] — each formed in torch as the reference forms it."""
    if x8.device.type == "cpu":
        return conv3x3_s8_dq_prelu_q8_plain(x8, w8, scale, b, alpha,
                                            inv_next)
    if x8.device.type != "cuda":
        raise ValueError(f"tensor on {x8.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain version)")
    if x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise TypeError(f"K4 takes int8 activations and weights, got "
                        f"{x8.dtype} / {w8.dtype}")
    if x8.dim() != 4 or x8.shape[3] != FEAT or \
            tuple(w8.shape) != (3, 3, FEAT, FEAT):
        raise ValueError(f"shapes {tuple(x8.shape)} x {tuple(w8.shape)}; "
                         f"expected (B, H, W, {FEAT}) x (3, 3, {FEAT}, "
                         f"{FEAT}) HWIO")
    check_operands(x8, w8)
    dev = x8.device
    ss = f32_operand(scale, FEAT, dev, "scale")
    bb = f32_operand(b, FEAT, dev, "b")
    aa = f32_operand(alpha, FEAT, dev, "alpha")
    inv = f32_operand(inv_next, 1, dev, "inv_next")
    B, H, W, _ = x8.shape
    y = torch.empty_like(x8)
    lib = build.load(SOURCE)
    fn = lib.reve_conv3x3_s8_dq_prelu_q8
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    wp = pack_weights_s8(w8)
    err = fn(x8.data_ptr(), wp.data_ptr(), ss.data_ptr(), bb.data_ptr(),
             aa.data_ptr(), inv.data_ptr(), y.data_ptr(), B, H, W,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "conv3x3_s8_dq_prelu_q8")
    LAUNCHES["conv3x3_s8_dq_prelu_q8"] += 1
    return y
