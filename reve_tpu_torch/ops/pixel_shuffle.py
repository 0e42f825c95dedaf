"""Pixel shuffle (depth-to-space) and its inverse in NHWC, matching
torch.nn.PixelShuffle / PixelUnshuffle.

torch semantics (NCHW): out[c, h*r+i, w*r+j] = in[c*r*r + i*r + j, h, w].
In NHWC the channel index math is identical on the last axis.
Counterpart of reve_tpu/ops/pixel_shuffle.py.
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


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H*r, W*r, C) -> (B, H, W, C*r*r), the inverse of pixel_shuffle
    (reve_tpu pixel_unshuffle): channel c*r*r + i*r + j of pixel (h, w)
    is x[h*r + i, w*r + j, c].  RRDBNet x2 unshuffles its input by 2."""
    b, hr, wr, c = x.shape
    h, w = hr // r, wr // r
    if h * r != hr or w * r != wr:
        raise ValueError(f"spatial dims ({hr},{wr}) not divisible by r={r}")
    x = x.reshape(b, h, r, w, r, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # B, H, W, C, r_i, r_j
    return x.reshape(b, h, w, c * r * r)
