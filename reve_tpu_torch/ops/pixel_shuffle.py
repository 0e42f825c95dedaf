"""Pixel shuffle (depth-to-space) in NHWC, matching torch.nn.PixelShuffle.

torch semantics (NCHW): out[c, h*r+i, w*r+j] = in[c*r*r + i*r + j, h, w].
In NHWC the channel index math is identical on the last axis.
"""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C*r*r) -> (B, H*r, W*r, C)."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    if c * r * r != crr:
        raise ValueError(f"channels {crr} not divisible by r^2={r * r}")
    x = x.reshape(b, h, w, c, r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)  # B, H, r_i, W, r_j, C
    return x.reshape(b, h * r, w * r, c)
