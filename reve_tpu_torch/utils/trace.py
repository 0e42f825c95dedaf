"""Structured tracing: machine-readable per-stage events + torch.profiler.

Counterpart of reve_tpu/utils/trace.py: the same `Tracer`, with
`device_profile` on torch.profiler instead of jax.profiler.

The reference's only instrumentation is counting magic stderr lines into
progress bars (reve-cli/src/main.rs:206-214).  SURVEY.md §5 prescribes
structured per-stage timing for the rebuild:

  * `Tracer` writes JSONL events ({"ts": ..., "ev": ..., ...}) — one line
    per event, safe from multiple threads, cheap no-ops when disabled.
  * `Tracer.span("decode", seg=3)` times a with-block.
  * `device_profile(dir)` wraps a block in a torch.profiler trace (CPU +
    CUDA activities) written as `<dir>/trace.json` (Chrome trace format,
    viewable in Perfetto).

Enable via CLI `--trace FILE` or env REVE_TPU_TRACE=FILE.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional


class Tracer:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f = open(path, "a") if path else None
        self._lock = threading.Lock()
        self._t0 = time.monotonic()

    @property
    def enabled(self) -> bool:
        return self._f is not None

    def event(self, ev: str, **fields) -> None:
        if self._f is None:
            return
        rec = {"ts": round(time.monotonic() - self._t0, 6), "ev": ev}
        rec.update(fields)
        line = json.dumps(rec)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    @contextlib.contextmanager
    def span(self, ev: str, **fields):
        if self._f is None:
            yield
            return
        start = time.monotonic()
        try:
            yield
        finally:
            self.event(ev, dur=round(time.monotonic() - start, 6), **fields)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


_NULL = Tracer(None)


def from_env() -> Tracer:
    path = os.environ.get("REVE_TPU_TRACE")
    return Tracer(path) if path else _NULL


def null() -> Tracer:
    return _NULL


@contextlib.contextmanager
def device_profile(log_dir: Optional[str]):
    """torch.profiler trace of the enclosed block (no-op when dir is None)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
