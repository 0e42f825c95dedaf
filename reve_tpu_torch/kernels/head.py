"""K2 `head_conv_residual_u8_shuffle` and K4h
`head_conv_s8_residual_u8_shuffle`, the SRVGG heads, all on the tensor
cores: bfloat16 K2 in csrc/conv3x3_tc.cu, float32 K2 in
csrc/conv3x3_f32_tc.cu, K4h in csrc/conv3x3_s8.cu.

Replaces the SRVGG head of reve_tpu/models/srvgg.py:apply: the last
`_conv3x3` (srvgg.py:211) with `_epilogue(quantize_u8=True)`
(srvgg.py:239-262) and `ops/pixel_shuffle.py:pixel_shuffle`
(pixel_shuffle.py:14-22), which XLA fused into the conv graph on the TPU.

Bound per 1080p frame at r=4 on an H100 SXM (989 TFLOP/s bf16,
3.35 TB/s): 114.7 GFLOP -> 0.116 ms; 265 + 6 + 99.5 MB -> 0.111 ms.  Each
kernel writes only the u8 (B, H*r, W*r, 3) output: no float32 head
tensor and no separate shuffle pass.  Each is its source's hidden-conv
mainloop at N = 3r^2 padded to a multiple of 8 (16, 32, 48) with one
shared epilogue (tc.cuh's HeadEpilogue): bfloat16 K2 on bf16 `wgmma`;
float32 K2 as six bf16 products of its operands split in three
(`split_bf16x3`, then the conv: float32 accuracy, never TF32), bound at
6 x 458.6 GFLOP per call of 4 frames -> 2.78 ms; K4h on s8 `wgmma`.

Rounding points follow the JAX reference: float32 accumulation + b in
float32, cast to the compute dtype, + repeat(u8 / 255, r^2) in float32,
clip(y * 255 + 0.5, 0, 255) truncated to u8, then the shuffle.

K4h is the int8 path's head (reve_tpu srvgg.py:383-386 with `_epilogue`,
:251-262): the s8 conv 64 -> 3r^2 in s32, dequantized in float32,
float32(y32) * (act_scale[n] * sw_last) + b_last, with NO cast to the
compute dtype, then K2's residual, rounding and shuffle.  Bound at r=4 per
call of 4 1080p frames: 458.6 GOP / 1979 TOP/s = 0.23 ms; 0.95 GB ->
0.29 ms (bytes).  Its accumulation is exact: it is bit-exact against its
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from reve_tpu_torch.kernels import LAUNCHES, build
from reve_tpu_torch.kernels.conv3x3 import (F32_SOURCE, FEAT, TC_SOURCE,
                                            check_operands, conv3x3_plain,
                                            f32_operand, pack_weights_bf16x3,
                                            split_bf16x3)
from reve_tpu_torch.kernels.conv3x3_s8 import (SOURCE as S8_SOURCE,
                                               conv3x3_s8_plain,
                                               pack_weights_s8)
from reve_tpu_torch.ops.pixel_shuffle import pixel_shuffle

_DTYPES = (torch.float32, torch.bfloat16)


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
    if x.dim() != 4 or x.shape[3] != FEAT or \
            tuple(w.shape) != (3, 3, FEAT, 3 * r * r):
        raise ValueError(f"head shapes {tuple(x.shape)} x {tuple(w.shape)}; "
                         f"expected (B, H, W, {FEAT}) x "
                         f"(3, 3, {FEAT}, {3 * r * r})")
    B, H, W, _ = x.shape
    if u8.dtype != torch.uint8 or tuple(u8.shape) != (B, H, W, 3):
        raise ValueError(f"residual input {tuple(u8.shape)} {u8.dtype}; "
                         f"expected ({B}, {H}, {W}, 3) uint8")
    check_operands(x, w, u8)


def _launch(source: str, entry: str, ins, u8, out, ints, what: str):
    """Call `entry` of `source`'s library: the input tensors' pointers,
    u8's and out's, B, H, W, then `ints` (r) and the stream."""
    B, H, W, _ = u8.shape
    lib = build.load(source)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * (len(ins) + 2) + \
        [ctypes.c_int] * (3 + len(ints)) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*(t.data_ptr() for t in ins), u8.data_ptr(), out.data_ptr(),
             B, H, W, *ints, torch.cuda.current_stream(u8.device).cuda_stream)
    build.check(lib, err, what)


def head_conv_residual_u8_shuffle(h: torch.Tensor, w: torch.Tensor,
                                  b: torch.Tensor, u8: torch.Tensor,
                                  r: int) -> torch.Tensor:
    """K2: head conv (B, H, W, 64) x (3, 3, 64, 3r^2) HWIO in the compute
    dtype + the u8 residual epilogue -> (B, H*r, W*r, 3) uint8.  float32
    launches two kernels: the split pass and the bf16x6 conv."""
    if h.device.type == "cpu":
        return head_conv_residual_u8_shuffle_plain(h, w, b, u8, r)
    if w.dtype not in _DTYPES or h.dtype != w.dtype:
        raise TypeError(f"head dtypes {h.dtype}/{w.dtype}; expected one "
                        f"of float32, bfloat16 for both")
    _check_head(h, w, u8, r)
    B, H, W, _ = h.shape
    bb = f32_operand(b, 3 * r * r, h.device, "bias")
    out = torch.empty((B, H * r, W * r, 3), dtype=torch.uint8,
                      device=h.device)
    if w.dtype == torch.bfloat16:
        _launch(TC_SOURCE, "reve_head_conv_residual_u8_shuffle_tc",
                (h, w, bb), u8, out, (r,), "head_conv_residual_u8_shuffle")
    else:
        _launch(F32_SOURCE, "reve_head_conv_residual_u8_shuffle_f32tc",
                (split_bf16x3(h), pack_weights_bf16x3(w), bb), u8, out,
                (r,), "head_conv_residual_u8_shuffle (float32)")
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
    _launch(S8_SOURCE, "reve_head_conv_s8_residual_u8_shuffle_tc",
            (x8, pack_weights_s8(w8), ss, bb), u8, out, (r,),
            "head_conv_s8_residual_u8_shuffle")
    LAUNCHES["head_conv_s8_residual_u8_shuffle"] += 1
    return out
