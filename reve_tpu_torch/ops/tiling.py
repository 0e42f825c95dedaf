"""Halo-padded spatial tiling for frames the engine runs in windows.

Counterpart of reve_tpu/ops/tiling.py.  Tiled output is byte-identical
to the whole-frame pass (tests/test_torch_tiling.py on the CPU,
tests/test_torch_kernels_cuda.py and chip_smoke.py on the card).

Scheme: **clamped shifted windows**.  Each output tile of side `tile` is
computed from a window of side `tile + 2*halo` that is clamped to lie
fully inside the frame.  Every window edge is then either >= `halo` away
from the pixels that tile owns (so the halo supplies the same real
neighbourhood the whole-frame pass sees) or lies exactly on a frame
border (so the kernels' own zero padding matches the whole-frame pass).
Zero-halo padding at borders would NOT be exact: conv bias + PReLU turn
zero inputs into nonzero activations, which deeper layers would see where
the whole-frame pass sees fresh zero padding.

The geometry (`_Axis`, `_plan_axis`, `TilePlan`, `plan_tiles`) is plain
Python, copied.  Windows are ordered tile-major, the B frames of one tile
after another, as reve_tpu orders them.  `upscale_tiled` runs the model
over chunks of windows in a Python loop (the last chunk is simply
shorter) and copies each window's owned core into one output tensor on
the input's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class _Axis:
    """Tiling geometry along one spatial axis."""

    size: int                      # frame extent
    window: int                    # window extent (<= size)
    # per tile: (window_start, core_offset_in_window, core_size, core_start)
    spans: Tuple[Tuple[int, int, int, int], ...]


def _plan_axis(size: int, tile: int, halo: int) -> _Axis:
    window = min(size, tile + 2 * halo)
    n = max(1, math.ceil(size / tile))
    spans: List[Tuple[int, int, int, int]] = []
    for i in range(n):
        core_start = i * tile
        core_size = min(tile, size - core_start)
        win_start = min(max(core_start - halo, 0), size - window)
        spans.append((win_start, core_start - win_start, core_size,
                      core_start))
    return _Axis(size=size, window=window, spans=tuple(spans))


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Static tiling geometry for one input resolution."""

    height: int
    width: int
    tile: int
    halo: int
    row_axis: _Axis
    col_axis: _Axis

    @property
    def rows(self) -> int:
        return len(self.row_axis.spans)

    @property
    def cols(self) -> int:
        return len(self.col_axis.spans)

    @property
    def num_tiles(self) -> int:
        return self.rows * self.cols

    @property
    def window_shape(self) -> Tuple[int, int]:
        return (self.row_axis.window, self.col_axis.window)

    def tile_spans(self, t: int):
        """(row span, column span) of tile `t` in row-major tile order."""
        return (self.row_axis.spans[t // self.cols],
                self.col_axis.spans[t % self.cols])


def plan_tiles(height: int, width: int, tile: int, halo: int) -> TilePlan:
    return TilePlan(
        height=height,
        width=width,
        tile=tile,
        halo=halo,
        row_axis=_plan_axis(height, tile, halo),
        col_axis=_plan_axis(width, tile, halo),
    )


def _groups(plan: TilePlan, batch: int, start: int, stop: int):
    """Windows start..stop-1 (tile-major: window i is frame i % batch of
    tile i // batch) as runs (tile, first frame, frames) of one tile."""
    i = start
    while i < stop:
        t, b0 = divmod(i, batch)
        n = min(batch - b0, stop - i)
        yield t, b0, n
        i += n


def extract_tiles(x: torch.Tensor, plan: TilePlan, start: int = 0,
                  stop: Optional[int] = None) -> torch.Tensor:
    """(B, H, W, C) -> windows start..stop-1 of the (rows * cols * B,
    win_h, win_w, C) tile-major window batch, as one contiguous tensor."""
    b, h, w, _c = x.shape
    if (h, w) != (plan.height, plan.width):
        raise ValueError(f"frame {h}x{w} does not match the plan's "
                         f"{plan.height}x{plan.width}")
    stop = plan.num_tiles * b if stop is None else stop
    wh, ww = plan.window_shape
    parts = []
    for t, b0, n in _groups(plan, b, start, stop):
        (rs, _, _, _), (cs, _, _, _) = plan.tile_spans(t)
        parts.append(x[b0:b0 + n, rs:rs + wh, cs:cs + ww])
    return torch.cat(parts)


def assemble_tiles(tiles: torch.Tensor, plan: TilePlan, scale: int,
                   batch: int, out: Optional[torch.Tensor] = None,
                   start: int = 0) -> torch.Tensor:
    """Inverse of extract_tiles after the model upscaled each window by
    `scale`: copies the owned core of windows start.. (tiles: (n, win_h *
    scale, win_w * scale, C)) into `out` ((batch, H * scale, W * scale,
    C), allocated on tiles' device when None) and returns it."""
    c = tiles.shape[-1]
    if out is None:
        out = torch.empty((batch, plan.height * scale, plan.width * scale,
                           c), dtype=tiles.dtype, device=tiles.device)
    i = 0
    for t, b0, n in _groups(plan, batch, start, start + len(tiles)):
        (_, ro, rh, rcs), (_, co, cw, ccs) = plan.tile_spans(t)
        out[b0:b0 + n, rcs * scale:(rcs + rh) * scale,
            ccs * scale:(ccs + cw) * scale] = \
            tiles[i:i + n, ro * scale:(ro + rh) * scale,
                  co * scale:(co + cw) * scale]
        i += n
    return out


def upscale_tiled(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    *,
    scale: int,
    tile: int,
    halo: int,
    chunk: int = 0,
) -> torch.Tensor:
    """Run `apply_fn` (an upscale-by-`scale` model) over halo-padded
    windows of x (B, H, W, C).

    Byte-identical to the whole-frame pass when `halo` >= the model's
    receptive-field radius; SRVGGNetCompact's radius is num_conv + 2 (one
    pixel per 3x3 conv).  chunk > 0: at most `chunk` windows per model
    call (bounds the working set); 0: every window in one call."""
    b, h, w, _ = x.shape
    plan = plan_tiles(h, w, tile, halo)
    if plan.num_tiles == 1 and not 0 < chunk < b:
        return apply_fn(x)
    total = plan.num_tiles * b
    step = chunk if chunk > 0 else total
    out = None
    for start in range(0, total, step):
        y = apply_fn(extract_tiles(x, plan, start, min(start + step, total)))
        out = assemble_tiles(y, plan, scale, b, out=out, start=start)
    return out
