"""K2 `head_conv_residual_u8_shuffle` and K4h
`head_conv_s8_residual_u8_shuffle`, the SRVGG heads, on the tensor cores
(bfloat16 K2 in csrc/conv3x3_tc.cu, float32 K2 in csrc/conv3x3_f32_tc.cu,
K4h in csrc/conv3x3_s8.cu), and `conv_last_u8`, RRDBNet's last conv:
bfloat16 as K2's conv_last mode (csrc/conv3x3_tc.cu), float32 in float32
FMAs on the CUDA cores (csrc/conv_last_f32.cu).

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

`conv_last_u8` computes reve_tpu rrdb.apply's conv_last (rrdb.py:232-234)
with the engine's u8 rounding (engine.py:428-429): u8(clip(float32(dtype(
conv + b)) * 255 + 0.5, 0, 255)).  In bfloat16 it is K2's kernel at r = 1
(N = 8) with no residual: the shared epilogue adds a zero base, which
leaves each value as it is.  Bound per call of 4 frames at 7680 x 4320
(the output of 4 1080p frames x4): 2 x 9 x 64 x 3 x 132.7 M = 458.6 GFLOP
-> 0.464 ms at the bf16 rate; 17.0 GB of bf16 in + 0.40 GB u8 out -> 5.19
ms (bytes).  In float32 it is a kernel of its own, csrc/conv_last_f32.cu:
float32 FMAs on the CUDA cores over the input read once by TMA, no split
pass; bound per call of 2 frames (the float32 plan's chunk) 17.0 GB in ->
5.13 ms (bytes; 229 GFLOP -> 3.42 ms at 67 TFLOP/s float32).

At 32, 96 and 128 features (Cin F) K2 in both dtypes is
csrc/conv3x3_wide.cuh's at R = 2, 3, 4 (the halo in units of 32 input
channels; the same HeadEpilogue), its weights packed by
conv3x3.pack_weights_wide: on its resident kernel (the weights copied
once a block, teams of warpgroups taking tiles in turn so that one's
epilogue runs beside another's wgmmas) in bf16 at every form and in
float32 at 32, else on its streamed kernel (float32 at 96 and 128); in
float32 each plane's A read into registers once for its six products;
bound per call of 4 1080p
frames at r = 4 in bf16 0.232, 0.696 and 0.927 ms (operations).  K4h
there is csrc/conv3x3_s8_wide.cuh's template at R = 2, 3, 4 (its weights
packed once by conv3x3_s8.packed_s8_wide; consumer teams taking tiles in
turn, as the resident K2's; the same HeadEpilogue); bound
at r = 4 0.206 and 0.364 ms at 32 and 96 (bytes), 0.464 ms at 128
(operations).  conv_last and K2's conv_last mode take 64 channels only.

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
                                            check_operands, check_width,
                                            conv3x3_plain, f32_operand,
                                            merge_bf16x3_plain,
                                            pack_weights_bf16x3, packed_wide,
                                            split_bf16x3)
from reve_tpu_torch.kernels.conv3x3_s8 import (SOURCE as S8_SOURCE,
                                               conv3x3_s8_plain, packed_s8,
                                               packed_s8_wide)
from reve_tpu_torch.ops.pixel_shuffle import pixel_shuffle

_DTYPES = (torch.float32, torch.bfloat16)
#: float32 conv_last: float32 FMAs, no split pass
LAST_F32_SOURCE = "conv_last_f32.cu"


def residual_u8_plain(h: torch.Tensor, u8: torch.Tensor,
                      r: int) -> torch.Tensor:
    """reve_tpu srvgg._epilogue(quantize_u8=True): float32(h) +
    repeat(u8 / 255, r^2) -> u8, then the pixel shuffle."""
    base = (u8.float() * (1.0 / 255.0)).repeat_interleave(r * r, dim=-1)
    y = h.float() + base
    q = torch.clamp(y * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    return pixel_shuffle(q, r).contiguous()


def _is_planes(h: torch.Tensor, w: torch.Tensor) -> bool:
    """`h` is the split planes (3, B, H, W, F) bfloat16 of a float32
    input to float32 weights (conv3x3.conv3x3_bias_prelu_planes')."""
    return h.dim() == 5 and h.dtype == torch.bfloat16 and \
        w.dtype == torch.float32


def head_conv_residual_u8_shuffle_plain(h, w, b, u8, r: int) -> torch.Tensor:
    if _is_planes(h, w):
        h = merge_bf16x3_plain(h)
    return residual_u8_plain(conv3x3_plain(h, w, b), u8, r)


def conv_last_u8_plain(h, w, b) -> torch.Tensor:
    """RRDBNet's conv_last with the engine's u8 rounding (reve_tpu
    rrdb.apply :232-234 and engine.py:428-429): u8(clip(float32(dtype(conv
    + b)) * 255 + 0.5, 0, 255)), truncated."""
    y = conv3x3_plain(h, w, b).float()
    return torch.clamp(y * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def head_conv_s8_residual_u8_shuffle_plain(x8, w8, scale, b, u8,
                                           r: int) -> torch.Tensor:
    """The int8 head: float32(conv_s8(x8, w8)) * scale + b (float32, no
    cast), then residual_u8_plain."""
    h = conv3x3_s8_plain(x8, w8).float() * scale.float() + b.float()
    return residual_u8_plain(h, u8, r)


def _check_head(x, w, u8, r: int, feat: int = FEAT) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"tensor on {x.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain version)")
    if r not in (2, 3, 4):
        raise ValueError(f"upscale {r} not supported (2, 3, 4)")
    if x.dim() != 4 or x.shape[3] != feat or \
            tuple(w.shape) != (3, 3, feat, 3 * r * r):
        raise ValueError(f"head shapes {tuple(x.shape)} x {tuple(w.shape)}; "
                         f"expected (B, H, W, {feat}) x "
                         f"(3, 3, {feat}, {3 * r * r})")
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
    """K2: head conv (B, H, W, F) x (3, 3, F, 3r^2) HWIO in the compute
    dtype, F one of WIDTHS, + the u8 residual epilogue -> (B, H*r, W*r, 3)
    uint8.  float32 launches two kernels: the split pass and the bf16x6
    conv; given the split planes (3, B, H, W, F) bfloat16 of its input
    (conv3x3.conv3x3_bias_prelu_planes') it launches the conv alone,
    counted as head_conv_residual_u8_shuffle_planes.  F =
    64 runs the 64-feature kernels, the other widths the wide forms
    (csrc/conv3x3_wide.cuh), their weights packed once (packed_wide)."""
    if h.device.type == "cpu":
        return head_conv_residual_u8_shuffle_plain(h, w, b, u8, r)
    planes = None
    if _is_planes(h, w):
        if h.shape[0] != 3:
            raise ValueError(f"head planes {tuple(h.shape)}, expected (3, "
                             f"B, H, W, F)")
        check_operands(h)
        planes, h = h, h[0]
    elif w.dtype not in _DTYPES or h.dtype != w.dtype:
        raise TypeError(f"head dtypes {h.dtype}/{w.dtype}; expected one "
                        f"of float32, bfloat16 for both")
    feat = h.shape[-1] if h.dim() == 4 else FEAT
    check_width(feat, "K2")
    _check_head(h, w, u8, r, feat)
    B, H, W, _ = h.shape
    bb = f32_operand(b, 3 * r * r, h.device, "bias")
    out = torch.empty((B, H * r, W * r, 3), dtype=torch.uint8,
                      device=h.device)
    bf16 = w.dtype == torch.bfloat16
    what = "head_conv_residual_u8_shuffle" + ("" if bf16 else " (float32)")
    if feat == FEAT and bf16:
        _launch(TC_SOURCE, "reve_head_conv_residual_u8_shuffle_tc",
                (h, w, bb), u8, out, (r,), what)
    elif feat == FEAT:
        _launch(F32_SOURCE, "reve_head_conv_residual_u8_shuffle_f32tc",
                (planes if planes is not None else split_bf16x3(h),
                 pack_weights_bf16x3(w), bb), u8, out, (r,), what)
    elif bf16:
        _launch(TC_SOURCE, "reve_head_conv_residual_u8_shuffle_wide_tc",
                (h, packed_wide(w), bb), u8, out, (feat, r), what)
    else:
        _launch(F32_SOURCE, "reve_head_conv_residual_u8_shuffle_wide_f32tc",
                (planes if planes is not None else split_bf16x3(h),
                 packed_wide(w), bb), u8, out, (feat, r), what)
    # the planes form (the float32 model's at the wide widths, with no
    # split pass) counts apart from the float32-input form
    LAUNCHES["head_conv_residual_u8_shuffle" if planes is None
             else "head_conv_residual_u8_shuffle_planes"] += 1
    return out


def conv_last_u8(h: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """RRDBNet's conv_last: (B, H, W, 64) x (3, 3, 64, 3) HWIO in the
    compute dtype, + b, cast to it, then u8 with no residual -> (B, H, W,
    3) uint8.  bfloat16: K2's kernel at r = 1 (its epilogue on a zero
    base); float32: one kernel of float32 FMAs on the input as it is, with
    no split pass (csrc/conv_last_f32.cu)."""
    if h.device.type == "cpu":
        return conv_last_u8_plain(h, w, b)
    if h.device.type != "cuda":
        raise ValueError(f"tensor on {h.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain version)")
    if w.dtype not in _DTYPES or h.dtype != w.dtype:
        raise TypeError(f"conv_last dtypes {h.dtype}/{w.dtype}; expected "
                        f"one of float32, bfloat16 for both")
    if h.dim() != 4 or h.shape[3] != FEAT or tuple(w.shape) != (3, 3, FEAT,
                                                                3):
        raise ValueError(f"conv_last shapes {tuple(h.shape)} x "
                         f"{tuple(w.shape)}; expected (B, H, W, {FEAT}) x "
                         f"(3, 3, {FEAT}, 3)")
    check_operands(h, w)
    B, H, W, _ = h.shape
    bb = f32_operand(b, 3, h.device, "bias")
    out = torch.empty((B, H, W, 3), dtype=torch.uint8, device=h.device)
    if w.dtype == torch.bfloat16:
        source, entry = TC_SOURCE, "reve_conv_last_u8_tc"
    else:
        source, entry = LAST_F32_SOURCE, "reve_conv_last_u8_f32"
    lib = build.load(source)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(h.data_ptr(), w.data_ptr(), bb.data_ptr(), out.data_ptr(), B,
             H, W, torch.cuda.current_stream(h.device).cuda_stream)
    build.check(lib, err, entry)
    LAUNCHES["conv_last_u8"] += 1
    return out


def head_conv_s8_residual_u8_shuffle(x8: torch.Tensor, w8: torch.Tensor,
                                     scale: torch.Tensor, b: torch.Tensor,
                                     u8: torch.Tensor,
                                     r: int) -> torch.Tensor:
    """K4h: int8 head conv (B, H, W, F) int8 x (3, 3, F, 3r^2) int8 HWIO, F
    one of conv3x3.WIDTHS, dequantized with `scale` = act_scale[n] *
    sw_last and `b` (3r^2 float32 each), + the u8 residual epilogue -> (B,
    H*r, W*r, 3) uint8.  F = 64 runs the 64-feature kernel, the other
    widths the wide form (csrc/conv3x3_s8_wide.cuh)."""
    if x8.device.type == "cpu":
        return head_conv_s8_residual_u8_shuffle_plain(x8, w8, scale, b, u8,
                                                      r)
    if x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise TypeError(f"K4h takes int8 activations and weights, got "
                        f"{x8.dtype} / {w8.dtype}")
    feat = x8.shape[-1] if x8.dim() == 4 else FEAT
    check_width(feat, "K4h")
    _check_head(x8, w8, u8, r, feat)
    B, H, W, _ = x8.shape
    ss = f32_operand(scale, 3 * r * r, x8.device, "scale")
    bb = f32_operand(b, 3 * r * r, x8.device, "bias")
    out = torch.empty((B, H * r, W * r, 3), dtype=torch.uint8,
                      device=x8.device)
    what = "head_conv_s8_residual_u8_shuffle"
    if feat == FEAT:
        _launch(S8_SOURCE, "reve_head_conv_s8_residual_u8_shuffle_tc",
                (x8, packed_s8(w8), ss, bb), u8, out, (r,), what)
    else:
        _launch(S8_SOURCE, "reve_head_conv_s8_residual_u8_shuffle_wide_tc",
                (x8, packed_s8_wide(w8), ss, bb), u8, out, (feat, r), what)
    LAUNCHES["head_conv_s8_residual_u8_shuffle"] += 1
    return out
