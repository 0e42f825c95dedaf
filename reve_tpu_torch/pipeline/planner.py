"""Segment planner: split a video into fixed-size frame segments.

Mirrors the reference's `Video::new` segment-list construction
(reve-shared/src/lib.rs:59-75) but frame-exact: the reference sized its last
segment `remainder - 1` and seeked one frame early to compensate for
timestamp-based seeking (lib.rs:94-98, 282-289 — SURVEY.md §2.5 documents the
off-by-one).  Our readers are index-exact (reve_tpu_torch.io.reader), so segments
here tile [0, frame_count) exactly with no compensation, and concat can never
duplicate or drop a boundary frame.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class Segment:
    """Unit of work + checkpointing, like the reference's `Segment`
    (reve-shared/src/lib.rs:10-13) but carrying an explicit frame range."""

    index: int
    start: int   # first frame (inclusive)
    size: int    # number of frames

    @property
    def stop(self) -> int:
        return self.start + self.size

    def to_json(self) -> dict:
        return {"index": self.index, "start": self.start, "size": self.size}

    @staticmethod
    def from_json(d: dict) -> "Segment":
        return Segment(index=d["index"], start=d["start"], size=d["size"])


def plan_segments(frame_count: int, segment_size: int) -> List[Segment]:
    """Tile [0, frame_count) into ceil(frame_count / segment_size) segments."""
    if frame_count <= 0:
        raise ValueError(f"frame_count must be positive, got {frame_count}")
    if segment_size <= 0:
        raise ValueError(f"segment_size must be positive, got {segment_size}")
    segments = []
    start = 0
    index = 0
    while start < frame_count:
        size = min(segment_size, frame_count - start)
        segments.append(Segment(index=index, start=start, size=size))
        start += size
        index += 1
    return segments
