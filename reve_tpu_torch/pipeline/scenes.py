"""Scene-cut detection + cut-aligned segment planning.

Counterpart of reve_tpu/pipeline/scenes.py (numpy on the host, copied;
the frames come from the port's own reader).  Segments that end exactly
at scene cuts encode better (the first frame of each part is an intra
frame anyway, so cutting at scene changes costs nothing and avoids
splitting a GOP mid-scene) and make per-segment preview outputs
semantically clean.  The reference splits on a fixed frame count only
(reve-shared/src/lib.rs:59-75); this is a new capability, off by default
(`--scene-align` in the CLI, `scene_align=True` in the API).

Detection: mean absolute luma difference between consecutive frames on a
decimated grid — cheap, codec-free, a pre-pass over the whole clip
before the job; it never touches the device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from reve_tpu_torch.pipeline.planner import Segment


def detect_cuts(reader, frame_count: int, threshold: float = 28.0,
                stride: int = 8, min_gap: int = 12) -> List[int]:
    """Return frame indices that START a new scene (cut points).

    Args:
      reader: a FrameReader; frames [0, frame_count) are scanned once.
      threshold: mean |delta luma| (0..255 scale) above which a cut fires.
      stride: spatial decimation for speed (every stride-th pixel).
      min_gap: minimum frames between reported cuts (debounce).
    """
    cuts: List[int] = []
    prev = None
    last_cut = -min_gap
    for idx, frame in enumerate(reader.read_range(0, frame_count)):
        small = frame[::stride, ::stride].astype(np.int32)
        luma = (small[..., 0] * 299 + small[..., 1] * 587 +
                small[..., 2] * 114) // 1000
        if prev is not None:
            delta = float(np.mean(np.abs(luma - prev)))
            if delta > threshold and idx - last_cut >= min_gap:
                cuts.append(idx)
                last_cut = idx
        prev = luma
    return cuts


def plan_segments_aligned(frame_count: int, segment_size: int,
                          cuts: Sequence[int],
                          snap_window: Optional[int] = None) -> List[Segment]:
    """Tile [0, frame_count) into ~segment_size segments whose boundaries
    snap to the nearest scene cut within `snap_window` frames (default
    segment_size // 4).  Degenerates to the exact fixed plan when no cut is
    near a boundary.  Invariants: no gaps, no overlaps, every segment
    non-empty — same contract as plan_segments."""
    if frame_count <= 0 or segment_size <= 0:
        raise ValueError("frame_count and segment_size must be positive")
    window = snap_window if snap_window is not None else segment_size // 4
    cuts = sorted(c for c in cuts if 0 < c < frame_count)
    segments: List[Segment] = []
    start = 0
    index = 0
    while start < frame_count:
        target = start + segment_size
        end = min(target, frame_count)
        if end < frame_count and window > 0:
            near = [c for c in cuts
                    if abs(c - target) <= window and c > start]
            if near:
                end = min(near, key=lambda c: abs(c - target))
        segments.append(Segment(index=index, start=start, size=end - start))
        start = end
        index += 1
    return segments


def plan_for_video(input_path: str, io_backend, info, segment_size: int,
                   ) -> List[Segment]:
    """The pre-pass shared by the CLI (--scene-align) and the library API
    (scene_align=True): open the input, detect cuts over the whole clip,
    and return the cut-snapped segment plan."""
    from reve_tpu_torch.io import reader as reader_mod

    with reader_mod.open_reader(
        input_path, backend=io_backend,
        width=info.width, height=info.height,
    ) as rd:
        cuts = detect_cuts(rd, info.frame_count)
    return plan_segments_aligned(info.frame_count, segment_size, cuts)
