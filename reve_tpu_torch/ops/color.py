"""Colorspace conversions (YUV 4:2:0 <-> RGB) as plain torch functions.

Counterpart of reve_tpu/ops/color.py, whose conversions run on the
accelerator as part of the inference graph: frames leave the device as
4:2:0 planes (1.5 bytes a pixel at 8 bits, 3 at 10) instead of 3-byte
RGB, and the encode thread only writes them.  BT.601 and BT.709, limited
(studio) and full range, 8 and 10 bits.

These functions are the plain versions of K9 (kernels/color.py,
rgb_to_yuv420_u8): the CPU path and the tests run them, the card's main
path runs the kernel.  Every float32 step is written as the reference's
source writes it and as the host's numpy conversion (ops/color_np.py, the
writers' route) computes it, one rounding an op, so the codes are
color_np's byte for byte (XLA under jit fuses two of the steps otherwise:
tests/test_torch_color.py):
  * the coefficients are Python doubles rounded once to float32, as numpy
    and JAX round a Python scalar against a float32 array;
  * u8 / 255 is a division; the luma is (kr*r + kg*g) + kb*b; the chroma
    (b - y) / f32(2 (1 - kb)), a division;
  * the 2x2 chroma mean is ((a + b) + (c + d)) / 4, a and b the upper
    row's pair: numpy's order for reshape(h/2, 2, w/2, 2).mean((1, 3));
  * codes round half to even, then clip.
A division here divides by a 0-dim tensor on the operand's device, never
by a Python scalar: PyTorch's CUDA division by a host scalar multiplies
by its reciprocal, which rounds differently.

10-bit codes are stored as int16 (CODE_DTYPES): every code <= 1023 has
the same bits as the reference's uint16; `codes_numpy` views them so.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from reve_tpu_torch.ops.color_np import _MATRIX

#: storage dtype of the integer codes per bit depth
CODE_DTYPES = {8: torch.uint8, 10: torch.int16}


def _coeffs(matrix: str) -> Tuple[float, float, float]:
    kr, kb = _MATRIX[matrix]
    kg = 1.0 - kr - kb
    return kr, kg, kb


def _f32(v: float) -> float:
    """A Python double rounded to float32, as a float32 array rounds a
    Python scalar it meets."""
    return float(np.float32(v))


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / f32(c), a true float32 division on x's device."""
    return x / torch.tensor(_f32(c), dtype=torch.float32, device=x.device)


def yuv_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
               matrix: str = "bt709",
               full_range: bool = False) -> torch.Tensor:
    """Same-resolution normalized YUV (y in [0, 1], u/v in [-0.5, 0.5])
    -> RGB float, stacked on a new last axis (range handling happens in
    normalize_yuv)."""
    kr, kg, kb = _coeffs(matrix)
    del full_range
    r = y + _f32(2.0 * (1.0 - kr)) * v
    b = y + _f32(2.0 * (1.0 - kb)) * u
    g = (y - _f32(2.0 * kr * (1.0 - kr) / kg) * v) \
        - _f32(2.0 * kb * (1.0 - kb) / kg) * u
    return torch.stack([r, g, b], dim=-1)


def rgb_to_yuv(rgb: torch.Tensor, *, matrix: str = "bt709"):
    """RGB in [0, 1] -> normalized (y in [0, 1], u/v in [-0.5, 0.5])."""
    kr, kg, kb = _coeffs(matrix)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = (_f32(kr) * r + _f32(kg) * g) + _f32(kb) * b
    u = _div(b - y, 2.0 * (1.0 - kb))
    v = _div(r - y, 2.0 * (1.0 - kr))
    return y, u, v


def normalize_yuv(y8: torch.Tensor, uv8: torch.Tensor, *, bits: int = 8,
                  full_range: bool = False):
    """Integer code values -> normalized float (y in [0, 1], uv in
    [-.5, .5]).  Limited range: Y in [16, 235] << (bits - 8), C in
    [16, 240] << (bits - 8); full range [0, 2^bits - 1], chroma neutral
    at 128 << (bits - 8) exactly."""
    scale = 1 << (bits - 8)
    y8 = y8.to(torch.float32)
    uv8 = uv8.to(torch.float32)
    if full_range:
        maxv = float((1 << bits) - 1)
        return _div(y8, maxv), _div(uv8 - 128.0 * scale, maxv)
    return (_div(y8 - 16.0 * scale, 219.0 * scale),
            _div(uv8 - 128.0 * scale, 224.0 * scale))


def quantize_yuv(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                 bits: int = 8, full_range: bool = False):
    """Normalized YUV -> integer codes, rounded half to even and clipped:
    uint8 at 8 bits, int16 holding the uint16 codes at 10."""
    scale = 1 << (bits - 8)
    if full_range:
        maxv = float((1 << bits) - 1)
        yq = y * maxv
        uq = u * maxv + 128.0 * scale
        vq = v * maxv + 128.0 * scale
    else:
        yq = y * (219.0 * scale) + 16.0 * scale
        uq = u * (224.0 * scale) + 128.0 * scale
        vq = v * (224.0 * scale) + 128.0 * scale
    hi = (1 << bits) - 1
    return tuple(torch.clamp(torch.round(q), 0, hi).to(CODE_DTYPES[bits])
                 for q in (yq, uq, vq))


def upsample_chroma_nearest(c: torch.Tensor) -> torch.Tensor:
    """(..., H/2, W/2) -> (..., H, W) chroma doubling."""
    return c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def downsample_chroma_box(c: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H/2, W/2) by the 2x2 box mean, summed
    ((a + b) + (c + d)) / 4 as numpy sums it."""
    a, b = c[..., 0::2, 0::2], c[..., 0::2, 1::2]
    d0, d1 = c[..., 1::2, 0::2], c[..., 1::2, 1::2]
    return ((a + b) + (d0 + d1)) / 4.0


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                  matrix: str = "bt709", full_range: bool = False,
                  bits: int = 8) -> torch.Tensor:
    """Integer 4:2:0 planes (y (B, H, W), u/v (B, H/2, W/2)) -> RGB
    float32 in [0, 1] (unclipped), (B, H, W, 3)."""
    yn, _ = normalize_yuv(y, y, bits=bits, full_range=full_range)
    _, un = normalize_yuv(u, u, bits=bits, full_range=full_range)
    _, vn = normalize_yuv(v, v, bits=bits, full_range=full_range)
    return yuv_to_rgb(yn, upsample_chroma_nearest(un),
                      upsample_chroma_nearest(vn), matrix=matrix,
                      full_range=full_range)


def rgb_to_yuv420(rgb: torch.Tensor, *, matrix: str = "bt709",
                  full_range: bool = False, bits: int = 10):
    """RGB float32 in [0, 1] (B, H, W, 3) -> integer 4:2:0 planes
    (default 10-bit, the reference's yuv420p10le encode format)."""
    y, u, v = rgb_to_yuv(torch.clamp(rgb, 0.0, 1.0), matrix=matrix)
    return quantize_yuv(y, downsample_chroma_box(u),
                        downsample_chroma_box(v), bits=bits,
                        full_range=full_range)


def rgb_u8_to_yuv420(rgb_u8: torch.Tensor, *, matrix: str = "bt709",
                     full_range: bool = False, bits: int = 10):
    """(B, H, W, 3) uint8 RGB -> (y, u, v) codes: rgb_to_yuv420(u8 / 255),
    as the writers' host conversion (color_np.rgb_to_yuv420_np) computes
    it; K9's plain version."""
    if rgb_u8.shape[-3] % 2 or rgb_u8.shape[-2] % 2:
        raise ValueError(f"yuv420 requires even dimensions, got "
                         f"{rgb_u8.shape[-2]}x{rgb_u8.shape[-3]}")
    return rgb_to_yuv420(_div(rgb_u8.to(torch.float32), 255.0),
                         matrix=matrix, full_range=full_range, bits=bits)


def codes_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU code tensor as numpy: uint8, or the int16 codes as uint16."""
    a = t.numpy()
    return a.view(np.uint16) if a.dtype == np.int16 else a
