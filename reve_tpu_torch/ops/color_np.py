"""numpy host-side colorspace conversions (jax-free).

IO threads (writers/readers) must not touch the accelerator: a per-frame
jit call from an encode thread round-trips the device for work the host
does in microseconds.  A copy of the JAX package's numpy conversions
(reve_tpu/ops/color_np.py, the same math as reve_tpu/ops/color.py's device
conversions), pure numpy; tests/test_torch_pipeline.py holds it against
the JAX package's copy, byte for byte.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# K_r / K_b luma coefficients per matrix (same table as ops.color)
_MATRIX = {
    "bt601": (0.299, 0.114),
    "bt709": (0.2126, 0.0722),
}


class YUVFormat(NamedTuple):
    """A 4:2:0 code format: the matrix ("bt601" or "bt709"), the range
    and the bit depth (8 or 10)."""

    matrix: str = "bt709"
    full_range: bool = False
    bits: int = 10


class Planes(NamedTuple):
    """A batch of 4:2:0 frames on the host: y (n, H, W), u and v (n, H/2,
    W/2), uint8 at 8 bits, uint16 at 10."""

    y: np.ndarray
    u: np.ndarray
    v: np.ndarray


def _coeffs(matrix):
    kr, kb = _MATRIX[matrix]
    return kr, 1.0 - kr - kb, kb


def rgb_to_yuv420_np(rgb_u8: np.ndarray, *, matrix: str = "bt709",
                     full_range: bool = False, bits: int = 10):
    """(H, W, 3) uint8 RGB -> (y, u, v) integer 4:2:0 planes (numpy)."""
    kr, kg, kb = _coeffs(matrix)
    h0, w0 = rgb_u8.shape[:2]
    if h0 % 2 or w0 % 2:
        raise ValueError(
            f"yuv420 requires even dimensions, got {w0}x{h0}")
    rgb = rgb_u8.astype(np.float32) / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = kr * r + kg * g + kb * b
    u = (b - y) / (2.0 * (1.0 - kb))
    v = (r - y) / (2.0 * (1.0 - kr))
    h, w = y.shape
    u = u.reshape(h // 2, 2, w // 2, 2).mean((1, 3))
    v = v.reshape(h // 2, 2, w // 2, 2).mean((1, 3))
    scale = 1 << (bits - 8)
    hi = (1 << bits) - 1
    dtype = np.uint8 if bits == 8 else np.uint16
    if full_range:
        # neutral chroma = code 128<<(bits-8) exactly (see ops/color.py)
        maxv = float(hi)
        planes = (y * maxv, u * maxv + 128.0 * scale,
                  v * maxv + 128.0 * scale)
    else:
        planes = (
            y * (219.0 * scale) + 16.0 * scale,
            u * (224.0 * scale) + 128.0 * scale,
            v * (224.0 * scale) + 128.0 * scale,
        )
    return tuple(
        np.clip(np.round(p), 0, hi).astype(dtype) for p in planes
    )


def yuv420_to_rgb_np(y: np.ndarray, u: np.ndarray, v: np.ndarray, *,
                     matrix: str = "bt709", full_range: bool = False,
                     bits: int = 8) -> np.ndarray:
    """Integer 4:2:0 planes -> (H, W, 3) uint8 RGB (numpy, nearest chroma)."""
    kr, kg, kb = _coeffs(matrix)
    scale = 1 << (bits - 8)
    yf = y.astype(np.float32)
    uf = u.astype(np.float32)
    vf = v.astype(np.float32)
    if full_range:
        scale = 1 << (bits - 8)
        maxv = float((1 << bits) - 1)
        yf = yf / maxv
        uf = (uf - 128.0 * scale) / maxv
        vf = (vf - 128.0 * scale) / maxv
    else:
        yf = (yf - 16.0 * scale) / (219.0 * scale)
        uf = (uf - 128.0 * scale) / (224.0 * scale)
        vf = (vf - 128.0 * scale) / (224.0 * scale)
    uf = uf.repeat(2, axis=-2).repeat(2, axis=-1)
    vf = vf.repeat(2, axis=-2).repeat(2, axis=-1)
    r = yf + 2.0 * (1.0 - kr) * vf
    b = yf + 2.0 * (1.0 - kb) * uf
    g = yf - (2.0 * kr * (1.0 - kr) / kg) * vf \
        - (2.0 * kb * (1.0 - kb) / kg) * uf
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)
