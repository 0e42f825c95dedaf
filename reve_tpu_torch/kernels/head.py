"""K2 `head_conv_residual_u8_shuffle` and K4h
`head_conv_s8_residual_u8_shuffle` (csrc/head.cu).

Replaces the SRVGG head of reve_tpu/models/srvgg.py:apply: the last
`_conv3x3` (srvgg.py:211) with `_epilogue(quantize_u8=True)`
(srvgg.py:239-262) and `ops/pixel_shuffle.py:pixel_shuffle`
(pixel_shuffle.py:14-22), which XLA fused into the conv graph on the TPU.

Bound per 1080p frame at r=4 on an H100 SXM (989 TFLOP/s bf16,
3.35 TB/s): 114.7 GFLOP -> 0.116 ms; 265 + 6 + 99.5 MB -> 0.111 ms.  The
kernel writes only the u8 (B, H*r, W*r, 3) output: no float32 head
tensor and no separate shuffle pass.  bfloat16 K2 runs on the tensor
cores (wgmma, csrc/conv3x3_tc.cu, K1's mainloop with N = 3r^2 padded to
a multiple of 8); float32 K2 and K4h on CUDA cores (csrc/head.cu).

Rounding points follow the JAX reference: float32 accumulation + b in
float32, cast to the compute dtype, + repeat(u8 / 255, r^2) in float32,
clip(y * 255 + 0.5, 0, 255) truncated to u8, then the shuffle.

K4h is the int8 path's head (reve_tpu srvgg.py:383-386 with `_epilogue`,
:251-262): the s8 conv 64 -> 3r^2 in s32, dequantized in float32,
float32(y32) * (act_scale[n] * sw_last) + b_last, with NO cast to the
compute dtype, then K2's residual, rounding and shuffle.  Bound at r=4 per
call of 4 1080p frames: 458.6 GOP / 1979 TOP/s = 0.23 ms; 0.95 GB ->
0.29 ms (bytes).
"""

from __future__ import annotations

import ctypes

import torch

from reve_tpu_torch.kernels import LAUNCHES, build
from reve_tpu_torch.kernels.conv3x3 import (FEAT, TC_SOURCE, check_operands,
                                            conv3x3_plain, f32_operand)
from reve_tpu_torch.kernels.conv3x3_s8 import conv3x3_s8_plain
from reve_tpu_torch.ops.pixel_shuffle import pixel_shuffle

SOURCE = "head.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def residual_u8_plain(h: torch.Tensor, u8: torch.Tensor,
                      r: int) -> torch.Tensor:
    """reve_tpu srvgg._epilogue(quantize_u8=True): float32(h) +
    repeat(u8 / 255, r^2) -> u8, then the pixel shuffle."""
    base = (u8.float() * (1.0 / 255.0)).repeat_interleave(r * r, dim=-1)
    y = h.float() + base
    q = torch.clamp(y * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    return pixel_shuffle(q, r).contiguous()


def head_conv_residual_u8_shuffle_plain(h, w, b, u8, r: int) -> torch.Tensor:
    return residual_u8_plain(conv3x3_plain(h, w, b), u8, r)


def head_conv_s8_residual_u8_shuffle_plain(x8, w8, scale, b, u8,
                                           r: int) -> torch.Tensor:
    """The int8 head: float32(conv_s8(x8, w8)) * scale + b (float32, no
    cast), then residual_u8_plain."""
    h = conv3x3_s8_plain(x8, w8).float() * scale.float() + b.float()
    return residual_u8_plain(h, u8, r)


def _check_head(x, w, u8, r: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"tensor on {x.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain version)")
    if r not in (2, 3, 4):
        raise ValueError(f"upscale {r} not supported (2, 3, 4)")
    B, H, W, C = x.shape
    if C != FEAT or tuple(w.shape) != (3, 3, FEAT, 3 * r * r):
        raise ValueError(f"head shapes {tuple(x.shape)} x {tuple(w.shape)}; "
                         f"expected (B, H, W, {FEAT}) x "
                         f"(3, 3, {FEAT}, {3 * r * r})")
    if u8.dtype != torch.uint8 or tuple(u8.shape) != (B, H, W, 3):
        raise ValueError(f"residual input {tuple(u8.shape)} {u8.dtype}; "
                         f"expected ({B}, {H}, {W}, 3) uint8")
    check_operands(x, w, u8)


def head_conv_residual_u8_shuffle(h: torch.Tensor, w: torch.Tensor,
                                  b: torch.Tensor, u8: torch.Tensor,
                                  r: int) -> torch.Tensor:
    """K2: head conv (B, H, W, 64) x (3, 3, 64, 3r^2) HWIO in the compute
    dtype + the u8 residual epilogue -> (B, H*r, W*r, 3) uint8."""
    if h.device.type == "cpu":
        return head_conv_residual_u8_shuffle_plain(h, w, b, u8, r)
    if w.dtype not in _DTYPE_CODE or h.dtype != w.dtype:
        raise TypeError(f"head dtypes {h.dtype}/{w.dtype}; expected one "
                        f"of float32, bfloat16 for both")
    _check_head(h, w, u8, r)
    B, H, W, _ = h.shape
    bb = f32_operand(b, 3 * r * r, h.device, "bias")
    out = torch.empty((B, H * r, W * r, 3), dtype=torch.uint8,
                      device=h.device)
    if w.dtype == torch.bfloat16:
        lib = build.load(TC_SOURCE)
        fn = lib.reve_head_conv_residual_u8_shuffle_tc
    else:
        lib = build.load(SOURCE)
        fn = lib.reve_head_conv_residual_u8_shuffle
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(h.data_ptr(), w.data_ptr(), bb.data_ptr(), u8.data_ptr(),
             out.data_ptr(), B, H, W, r, _DTYPE_CODE[w.dtype],
             torch.cuda.current_stream(h.device).cuda_stream)
    build.check(lib, err, "head_conv_residual_u8_shuffle")
    LAUNCHES["head_conv_residual_u8_shuffle"] += 1
    return out


def head_conv_s8_residual_u8_shuffle(x8: torch.Tensor, w8: torch.Tensor,
                                     scale: torch.Tensor, b: torch.Tensor,
                                     u8: torch.Tensor,
                                     r: int) -> torch.Tensor:
    """K4h: int8 head conv (B, H, W, 64) int8 x (3, 3, 64, 3r^2) int8 HWIO,
    dequantized with `scale` = act_scale[n] * sw_last and `b` (3r^2
    float32 each), + the u8 residual epilogue -> (B, H*r, W*r, 3) uint8."""
    if x8.device.type == "cpu":
        return head_conv_s8_residual_u8_shuffle_plain(x8, w8, scale, b, u8,
                                                      r)
    if x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise TypeError(f"K4h takes int8 activations and weights, got "
                        f"{x8.dtype} / {w8.dtype}")
    _check_head(x8, w8, u8, r)
    B, H, W, _ = x8.shape
    ss = f32_operand(scale, 3 * r * r, x8.device, "scale")
    bb = f32_operand(b, 3 * r * r, x8.device, "bias")
    out = torch.empty((B, H * r, W * r, 3), dtype=torch.uint8,
                      device=x8.device)
    lib = build.load(SOURCE)
    fn = lib.reve_head_conv_s8_residual_u8_shuffle
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x8.data_ptr(), w8.data_ptr(), ss.data_ptr(), bb.data_ptr(),
             u8.data_ptr(), out.data_ptr(), B, H, W, r,
             torch.cuda.current_stream(x8.device).cuda_stream)
    build.check(lib, err, "head_conv_s8_residual_u8_shuffle")
    LAUNCHES["head_conv_s8_residual_u8_shuffle"] += 1
    return out
