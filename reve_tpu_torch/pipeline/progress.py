"""Progress tracking: structured, machine-readable stage counters.

The reference renders four indicatif bars ([info]/[expo]/[upsc]/[merg]) fed
by counting magic stderr marker lines from child processes
(reve-cli/src/main.rs:176-214, 265-273, 329-339).  With everything
in-process we count real events instead and keep the same four-stage shape.
A console renderer draws bars; a callback hook feeds the web service and
tests.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Callable, Optional

STAGES = ("decode", "upscale", "encode", "total")


@dataclasses.dataclass
class StageCounter:
    done: int = 0
    total: int = 0
    started_at: float = 0.0

    @property
    def rate(self) -> float:
        dt = time.monotonic() - self.started_at
        return self.done / dt if dt > 0 and self.done else 0.0


class ProgressTracker:
    """Thread-safe frame counters for decode/upscale/encode + segment total."""

    def __init__(self, total_frames: int, total_segments: int,
                 on_update: Optional[Callable[["ProgressTracker"], None]] = None,
                 source_fps: float = 0.0):
        now = time.monotonic()
        self.stages = {
            "decode": StageCounter(total=total_frames, started_at=now),
            "upscale": StageCounter(total=total_frames, started_at=now),
            "encode": StageCounter(total=total_frames, started_at=now),
            "total": StageCounter(total=total_segments, started_at=now),
        }
        #: source frame rate; when known, snapshots carry the end-to-end
        #: x-realtime factor (encode rate / source fps — frames fully
        #: through decode->upscale->encode per wall second vs playback).
        #: BASELINE.md's "end-to-end x realtime per segment: report" row.
        self.source_fps = float(source_fps)
        self._lock = threading.Lock()
        # callbacks are serialized on their own lock (decode/submit/encode
        # threads all advance concurrently; renderers and user callbacks
        # are not written to be re-entrant).  Separate from the counter
        # lock so a slow callback never stalls counting.
        self._cb_lock = threading.Lock()
        self._on_update = on_update

    def advance(self, stage: str, n: int = 1) -> None:
        with self._lock:
            self.stages[stage].done += n
        if self._on_update:
            with self._cb_lock:
                self._on_update(self)

    def snapshot(self) -> dict:
        with self._lock:
            snap = {}
            for name, c in self.stages.items():
                d = {"done": c.done, "total": c.total,
                     "rate": round(c.rate, 2)}
                # eta, like the reference's indicatif bars (SURVEY.md §5:
                # elapsed/eta/per_sec per bar)
                rate = c.rate
                if rate > 0 and c.total > c.done:
                    d["eta_s"] = round((c.total - c.done) / rate, 1)
                snap[name] = d
            if self.source_fps > 0:
                snap["x_realtime"] = round(
                    self.stages["encode"].rate / self.source_fps, 3)
            return snap


class ConsoleRenderer:
    """Simple multi-bar console renderer (the reference uses indicatif)."""

    LABELS = {"decode": "expo", "upscale": "upsc", "encode": "merg",
              "total": "info"}

    def __init__(self, stream=None, min_interval: float = 0.2):
        self.stream = stream or sys.stderr
        self.min_interval = min_interval
        self._last = 0.0
        self._lines = 0

    def __call__(self, tracker: ProgressTracker) -> None:
        now = time.monotonic()
        if now - self._last < self.min_interval:
            return
        self._last = now
        snap = tracker.snapshot()
        if self._lines:
            self.stream.write(f"\x1b[{self._lines}A")
        self._lines = 0
        for name in ("total", "decode", "upscale", "encode"):
            c = snap[name]
            frac = c["done"] / c["total"] if c["total"] else 0.0
            bar = "#" * int(frac * 30)
            unit = "seg" if name == "total" else "fps"
            xrt = ""
            if name == "total" and "x_realtime" in snap:
                xrt = f", {snap['x_realtime']}x realtime"
            eta = ""
            if "eta_s" in c:
                s = int(c["eta_s"])
                eta = f", eta {s // 60}m{s % 60:02d}s" if s >= 60 \
                    else f", eta {s}s"
            self.stream.write(
                f"[{self.LABELS[name]}] [{bar:<30}] "
                f"{c['done']}/{c['total']} "
                f"({c['rate']} {unit}{eta}{xrt})\x1b[K\n"
            )
            self._lines += 1
        self.stream.flush()


class JsonlRenderer:
    """Machine-readable progress: one JSON snapshot line per update, rate
    limited — the structured counterpart of the console bars (the reference
    only has human-oriented indicatif output, SURVEY.md §5)."""

    def __init__(self, path: str, min_interval: float = 0.5):
        # append: a resumed run must not truncate the prior run's history
        # (the CLI help documents append semantics)
        import time as _time

        self._f = open(path, "a")
        self._min_interval = min_interval
        self._last = 0.0
        self._time = _time

    def __call__(self, tracker: "ProgressTracker") -> None:
        import json as _json

        now = self._time.monotonic()
        if now - self._last < self._min_interval:
            return
        self._last = now
        self._f.write(_json.dumps(tracker.snapshot()) + "\n")
        self._f.flush()

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


class TeeRenderer:
    """Fan a progress update out to several renderers."""

    def __init__(self, *renderers):
        self._renderers = [r for r in renderers if r is not None]

    def __call__(self, tracker: "ProgressTracker") -> None:
        for r in self._renderers:
            r(tracker)
