"""File-lease segment queue: shard segments across workers/hosts.

Segments are embarrassingly parallel (SURVEY.md §2.3-2.4), so the multi-host
strategy is a shared work queue, not collectives.  Coordination uses atomic
lease files in the shared workspace — the same file-based state idiom the
reference uses for resume — so it works over any shared filesystem (NFS/GCS
fuse) with no extra services:

  * claim:   O_CREAT|O_EXCL create of `leases/<idx>.lease` containing the
             worker id; EEXIST means another worker owns it.
  * renew:   touch the lease file (mtime heartbeat) while working.
  * release: delete the lease (after the part file is committed).
  * steal:   a lease older than `stale_after` seconds whose part has not
             appeared is deleted and re-claimed (crash takeover).

Completion is defined by the part file existing (the same source of truth
`repair_pending` uses), so the queue and resume logic can never disagree.

The port's copy of reve_tpu/pipeline/leases.py, unchanged but for its
imports: the port's Workspace, Segment and scheduler.PipelineJob.  The
CLI's `--shard-worker` runs it through pipeline/job.py (`run_shard`).
"""

from __future__ import annotations

import errno
import logging
import os
import threading
import time
from typing import List, Optional

from reve_tpu_torch.pipeline.planner import Segment
from reve_tpu_torch.pipeline.state import Workspace

log = logging.getLogger(__name__)

LEASES_DIR = "leases"

#: Leases are heartbeat-renewed every few seconds while a segment runs
#: (see _Heartbeat), so staleness only needs to cover a crashed worker's
#: detection latency — but it must also survive a worker whose *process*
#: is alive while a single renewal is delayed (GC pause, NFS hiccup,
#: first-compile stalls of 10-150 s that block the dispatch thread).
#: 10 min is comfortably above anything observed.
DEFAULT_STALE_AFTER = 600.0
HEARTBEAT_INTERVAL = 5.0


class SegmentLeaseQueue:
    def __init__(self, workspace: Workspace, worker_id: str,
                 stale_after: float = DEFAULT_STALE_AFTER,
                 part_ext: str = ".mp4"):
        self.ws = workspace
        self.worker_id = worker_id
        self.stale_after = stale_after
        self.part_ext = part_ext
        self.dir = os.path.join(workspace.root, LEASES_DIR)
        os.makedirs(self.dir, exist_ok=True)

    def _lease_path(self, index: int) -> str:
        return os.path.join(self.dir, f"{index:06d}.lease")

    def _try_create(self, path: str) -> bool:
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except OSError as e:
            if e.errno == errno.EEXIST:
                return False
            raise
        with os.fdopen(fd, "w") as f:
            f.write(self.worker_id)
        return True

    def _is_stale(self, path: str) -> bool:
        try:
            return time.time() - os.path.getmtime(path) > self.stale_after
        except OSError:
            return False  # vanished: owner released or finished

    def _owner(self, path: str) -> Optional[str]:
        try:
            with open(path) as f:
                return f.read()
        except OSError:
            return None

    def _steal(self, path: str) -> bool:
        """Take over a stale lease atomically: rename wins exactly once
        among racing stealers (the losers get ENOENT), so two workers can
        never both unlink-and-recreate the same stale lease."""
        grave = f"{path}.stolen.{os.getpid()}.{time.monotonic_ns()}"
        try:
            os.rename(path, grave)
        except OSError:
            return False  # someone else stole (or owner released) first
        try:
            os.unlink(grave)
        except OSError:
            pass
        return self._try_create(path)

    def claim(self, segments: List[Segment]) -> Optional[Segment]:
        """Claim the first unowned, uncompleted segment; None if none left
        to claim (they may still be in-flight on other workers)."""
        done = set(self.ws.completed_parts(self.part_ext))
        for seg in segments:
            if seg.index in done:
                continue
            path = self._lease_path(seg.index)
            if self._try_create(path):
                return seg
            if self._is_stale(path) and self._steal(path):
                return seg
        return None

    def renew(self, seg: Segment) -> bool:
        """Heartbeat — but only while we still own the lease: a worker
        that was presumed dead (lease stolen) must not freshen the
        thief's lease file.

        Returns False when ownership was lost (the lease was stolen or
        released) so the caller can abandon the segment instead of
        racing the new owner.  The owner is re-read AFTER the utime:
        a steal landing between the first check and the touch would
        otherwise freshen the thief's lease undetected — the freshening
        itself is harmless (the thief is alive and heartbeating), but
        the loss must surface."""
        path = self._lease_path(seg.index)
        if self._owner(path) != self.worker_id:
            return False
        try:
            os.utime(path)
        except OSError:
            pass
        return self._owner(path) == self.worker_id

    def release(self, seg: Segment) -> None:
        """Delete our lease.  Owner-checked: a stalled worker that resumes
        after its lease was stolen must not delete the new owner's lease
        (which would open the segment to a third claimant)."""
        path = self._lease_path(seg.index)
        if self._owner(path) != self.worker_id:
            return
        try:
            os.unlink(path)
        except OSError:
            pass

    def all_done(self, segments: List[Segment]) -> bool:
        done = set(self.ws.completed_parts(self.part_ext))
        return all(s.index in done for s in segments)

    # -- single-finalizer election ---------------------------------------

    def _finalize_lease_path(self) -> str:
        return os.path.join(self.dir, "finalize.lease")

    def claim_finalize(self, output_path: str) -> bool:
        """Elect exactly one finalizer among workers that all observe
        `all_done` (two workers finishing near-simultaneously must not both
        write the output).  O_EXCL create wins; a stale finalize lease with
        no output yet means the elected finalizer crashed — steal it.
        scheduler.finalize writes the output atomically (concat to a tmp,
        then rename), so `output exists` reliably means `finalize
        completed` and a crashed finalizer never blocks takeover."""
        path = self._finalize_lease_path()
        if self._try_create(path):
            return True
        if self._is_stale(path) and not os.path.exists(output_path):
            return self._steal(path)
        return False


class _Heartbeat:
    """Daemon thread that touches a segment's lease file while the owning
    worker runs it, so a live worker is never mistaken for a crashed one
    and its lease stolen mid-segment (which would let two workers write the
    same part file).

    If a renewal discovers the lease was stolen anyway (this worker
    stalled past stale_after — SIGSTOP, VM pause), `lost` is set and
    `on_lost` fires once so the worker loop can abort the segment: the
    takeover worker owns it now, and two workers must not keep encoding
    the same part."""

    def __init__(self, queue: SegmentLeaseQueue, seg: Segment,
                 interval: float = HEARTBEAT_INTERVAL,
                 on_lost=None):
        self._queue = queue
        self._seg = seg
        self._interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.lost = False
        self.on_lost = on_lost

    def _run(self):
        while not self._stop.wait(self._interval):
            if not self._queue.renew(self._seg):
                self.lost = True
                if self.on_lost is not None:
                    self.on_lost()
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)


def run_sharded(state, workspace: Workspace, engine, worker_id: str,
                io_backend: Optional[str] = None, part_ext: str = ".mp4",
                progress=None,
                stale_after: float = DEFAULT_STALE_AFTER,
                tracer=None, queue: Optional[SegmentLeaseQueue] = None
                ) -> int:
    """Worker loop: claim segments one at a time and run them through the
    standard pipeline until the queue is exhausted, heartbeat-renewing the
    lease throughout.  Returns the number of segments this worker
    completed.  Exactly one worker then finalizes (claim_finalize).

    `queue`: pass a pre-built SegmentLeaseQueue so the caller's later
    all_done/claim_finalize checks share this construction (one place to
    keep the parameters in sync)."""
    import dataclasses

    from reve_tpu_torch.pipeline.scheduler import PipelineJob

    if queue is None:
        queue = SegmentLeaseQueue(workspace, worker_id,
                                  stale_after=stale_after,
                                  part_ext=part_ext)
    all_segments = list(state.pending)
    completed = 0
    while True:
        seg = queue.claim(all_segments)
        if seg is None:
            return completed
        try:
            hb_interval = min(HEARTBEAT_INTERVAL, stale_after / 4)
            job = PipelineJob(
                dataclasses.replace(state, pending=[seg]),
                workspace, engine, io_backend=io_backend,
                part_ext=part_ext, progress=progress, tracer=tracer,
            )
            hb = _Heartbeat(queue, seg, interval=hb_interval,
                            on_lost=job.cancel)
            try:
                with hb:
                    job.run()
                completed += 1
            except Exception as e:
                if not hb.lost:
                    raise
                # lease stolen mid-segment (we stalled past stale_after):
                # the takeover worker owns this segment now — abandon it
                # and move on; release() below is owner-checked so it
                # cannot touch the new owner's lease.  The exception is
                # USUALLY the cancellation we triggered, but a genuine
                # failure can race the loss — log it rather than judge
                log.warning(
                    "segment %d abandoned after lease loss (takeover by "
                    "another worker); the aborting error was: %s",
                    seg.index, e)
        finally:
            queue.release(seg)
