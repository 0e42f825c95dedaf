"""Integer-factor resizes matching torch.nn.functional.interpolate
semantics, in NHWC.

Counterpart of reve_tpu/ops/resize.py.
"""

from __future__ import annotations

import torch


def upsample_nearest(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H*r, W*r, C), nearest-neighbor: an exact pixel
    repeat, identical to F.interpolate(mode='nearest', scale_factor=r) and
    to reve_tpu's repeat along H then W.  One copy (a broadcast view
    reshaped), contiguous."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, r, w, r, c).reshape(
        b, h * r, w * r, c)
