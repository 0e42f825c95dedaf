"""The port's segment lease queue (reve_tpu_torch.pipeline.leases) with
the port's Workspace and PipelineJob: each lease test of
tests/test_parallel.py run against the port's copy, and shard jobs of
the port's CPU engine whose output is the one-worker job's, byte for
byte.

The kill -9 case runs this file as its worker process
(`python tests/test_torch_leases.py worker ...`): a lease-queue worker
over a fake engine that sleeps a little a batch, so the kill lands
mid-segment.
"""

import dataclasses
import fractions
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from reve_tpu_torch.io import reader, writer  # noqa: E402
from reve_tpu_torch.pipeline import (leases, planner,  # noqa: E402
                                     scheduler, state)


class FakeEngine:
    batch_size = 3
    scale = 2

    def __init__(self, delay: float = 0.0):
        self.delay = delay

    def submit(self, frames):
        if self.delay:
            time.sleep(self.delay)
        out = np.repeat(np.repeat(frames, 2, axis=1), 2, axis=2)

        class _P:
            def result(self):
                return out

        return _P()


def _write_input(path, num_frames, step=8, base=20):
    with writer.Y4MWriter(path, 32, 24, fractions.Fraction(24)) as wr:
        for i in range(num_frames):
            wr.write(np.full((24, 32, 3), base + step * i, np.uint8))


def _make_job(tmp_path, num_frames=24, seg=4):
    path = str(tmp_path / "in.y4m")
    _write_input(path, num_frames)
    ws = state.Workspace(str(tmp_path / "work"))
    ws.create()
    st = state.JobState(
        input_path=path, output_path=str(tmp_path / "out.y4m"),
        scale=2, segment_size=seg, frame_count=num_frames,
        fps_num=24, fps_den=1, width=32, height=24,
        pending=planner.plan_segments(num_frames, seg),
    )
    ws.save(st)
    return ws, st


def _lumas(path, n):
    rd = reader.Y4MReader(path)
    assert rd.frame_count() == n
    return [int(f[12, 16, 0]) for f in rd.read_range(0, n)]


def test_lease_claim_release(tmp_path):
    ws, st = _make_job(tmp_path)
    q1 = leases.SegmentLeaseQueue(ws, "w1", part_ext=".y4m")
    q2 = leases.SegmentLeaseQueue(ws, "w2", part_ext=".y4m")
    s1 = q1.claim(st.pending)
    s2 = q2.claim(st.pending)
    assert s1.index != s2.index  # no double-claim
    q1.release(s1)
    s3 = q2.claim(st.pending)
    assert s3.index == s1.index  # released -> claimable
    assert sorted(os.listdir(q1.dir)) == sorted(
        f"{s.index:06d}.lease" for s in (s2, s3))


def test_lease_skips_completed(tmp_path):
    ws, st = _make_job(tmp_path)
    with open(ws.part_tmp_path(0, ".y4m"), "w") as f:
        f.write("x")
    ws.commit_part(0, ".y4m")
    q = leases.SegmentLeaseQueue(ws, "w1", part_ext=".y4m")
    assert q.claim(st.pending).index == 1


def test_stale_lease_takeover(tmp_path):
    ws, st = _make_job(tmp_path)
    q1 = leases.SegmentLeaseQueue(ws, "w1", stale_after=0.2, part_ext=".y4m")
    s = q1.claim(st.pending)
    # w1 "crashes" (no renew); w2 takes over after staleness
    q2 = leases.SegmentLeaseQueue(ws, "w2", stale_after=0.2, part_ext=".y4m")
    assert q2.claim(st.pending).index != s.index  # fresh lease not stolen
    time.sleep(0.3)
    stolen = q2.claim(st.pending)
    assert stolen.index == s.index
    with open(q2._lease_path(s.index)) as f:
        assert f.read() == "w2"


def test_renew_reports_lost_ownership(tmp_path):
    ws, st = _make_job(tmp_path)
    q1 = leases.SegmentLeaseQueue(ws, "w1", stale_after=0.2, part_ext=".y4m")
    s = q1.claim(st.pending)
    assert q1.renew(s) is True
    time.sleep(0.3)
    q2 = leases.SegmentLeaseQueue(ws, "w2", stale_after=0.2, part_ext=".y4m")
    assert q2.claim(st.pending).index == s.index  # stolen
    assert q1.renew(s) is False                   # w1 must notice
    with open(q1._lease_path(s.index)) as f:
        assert f.read() == "w2"


def test_heartbeat_lost_lease_aborts_segment(tmp_path):
    """A worker whose lease is stolen mid-segment cancels its pipeline
    (on_lost -> job.cancel); run_sharded neither raises nor counts the
    abandoned segment, and its owner-checked release leaves the thief's
    lease."""
    ws, st = _make_job(tmp_path, num_frames=4, seg=4)  # 1 segment
    q1 = leases.SegmentLeaseQueue(ws, "w1", stale_after=0.2, part_ext=".y4m")
    stop_thief = threading.Event()

    def thief():
        time.sleep(0.3)
        q2 = leases.SegmentLeaseQueue(ws, "w2", stale_after=0.2,
                                      part_ext=".y4m")
        q2._steal(q2._lease_path(0))
        seg0 = st.pending[0]
        while not stop_thief.wait(0.05):
            q2.renew(seg0)

    t = threading.Thread(target=thief)
    t.start()
    done = leases.run_sharded(st, ws, FakeEngine(delay=0.8), "w1",
                              io_backend="y4m", part_ext=".y4m",
                              stale_after=0.2, queue=q1)
    stop_thief.set()
    t.join()
    assert done == 0
    assert ws.completed_parts(".y4m") == []
    with open(q1._lease_path(0)) as f:
        assert f.read() == "w2"


def test_two_workers_complete_job(tmp_path):
    """Two concurrent workers share one segment queue; every frame appears
    exactly once in the final concat."""
    ws, st = _make_job(tmp_path, num_frames=24, seg=4)  # 6 segments
    counts = {}

    def worker(wid):
        counts[wid] = leases.run_sharded(
            st, ws, FakeEngine(), wid, io_backend="y4m", part_ext=".y4m")

    ts = [threading.Thread(target=worker, args=(w,)) for w in ("w1", "w2")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert sum(counts.values()) == 6
    q = leases.SegmentLeaseQueue(ws, "main", part_ext=".y4m")
    assert q.all_done(st.pending)
    scheduler.finalize(dataclasses.replace(st, pending=[]), ws,
                       io_backend="y4m", part_ext=".y4m")
    for i, v in enumerate(_lumas(str(tmp_path / "out.y4m"), 24)):
        assert abs(v - (20 + 8 * i)) <= 2, (i, v)


def test_finalize_election(tmp_path):
    ws, st = _make_job(tmp_path)
    out = st.output_path
    q1 = leases.SegmentLeaseQueue(ws, "w1", stale_after=0.3, part_ext=".y4m")
    q2 = leases.SegmentLeaseQueue(ws, "w2", stale_after=0.3, part_ext=".y4m")
    assert [q.claim_finalize(out) for q in (q1, q2)] == [True, False]
    # winner crashed without producing output: stale -> stealable
    time.sleep(0.4)
    assert not os.path.exists(out)
    assert q2.claim_finalize(out) is True
    # with the output present, nobody re-finalizes even when stale
    with open(out, "w") as f:
        f.write("x")
    time.sleep(0.4)
    assert q1.claim_finalize(out) is False


def test_heartbeat_prevents_steal(tmp_path):
    ws, st = _make_job(tmp_path)
    q1 = leases.SegmentLeaseQueue(ws, "w1", stale_after=0.5, part_ext=".y4m")
    q2 = leases.SegmentLeaseQueue(ws, "w2", stale_after=0.5, part_ext=".y4m")
    seg = q1.claim(st.pending)
    with leases._Heartbeat(q1, seg, interval=0.1):
        time.sleep(1.2)  # well past stale_after
        other = q2.claim(st.pending)
        assert other is not None and other.index != seg.index
        q2.release(other)
    time.sleep(0.7)  # heartbeat stopped: stale, stealable
    stolen = q2.claim(st.pending)
    assert stolen is not None and stolen.index == seg.index


def test_stolen_lease_owner_checks(tmp_path):
    ws, st = _make_job(tmp_path)
    q1 = leases.SegmentLeaseQueue(ws, "w1", stale_after=0.2, part_ext=".y4m")
    s = q1.claim(st.pending)
    time.sleep(0.3)
    q2 = leases.SegmentLeaseQueue(ws, "w2", stale_after=0.2, part_ext=".y4m")
    assert q2.claim(st.pending).index == s.index  # stolen
    path = q2._lease_path(s.index)
    q1.release(s)  # a no-op on w2's lease
    assert os.path.exists(path)
    with open(path) as f:
        assert f.read() == "w2"
    old = os.path.getmtime(path)
    os.utime(path, (old - 100, old - 100))
    q1.renew(s)  # must not freshen it
    assert os.path.getmtime(path) < old - 50
    q2.renew(s)  # the owner's renew does
    assert os.path.getmtime(path) >= old - 1


def test_clean_stale_tmp_keeps_live_workers_tmps(tmp_path):
    ws, st = _make_job(tmp_path)
    own = ws.part_tmp_path(0, ".y4m")
    alive = os.path.join(ws.parts_dir, "000001.tmp1.y4m")      # pid 1 lives
    dead = os.path.join(ws.parts_dir, "000002.tmp999999.y4m")  # no such pid
    for p in (own, alive, dead):
        with open(p, "w") as f:
            f.write("x")
    assert ws.clean_stale_tmp() == 2
    assert os.path.exists(alive)
    assert not os.path.exists(own) and not os.path.exists(dead)


def test_finalize_refuses_missing_parts(tmp_path):
    ws, st = _make_job(tmp_path)
    with writer.Y4MWriter(ws.part_tmp_path(0, ".y4m"), 32, 32,
                          fractions.Fraction(24)) as wr:
        wr.write(np.zeros((32, 32, 3), np.uint8))
    ws.commit_part(0, ".y4m")
    with pytest.raises(scheduler.PipelineError, match="missing"):
        scheduler.finalize(st, ws, io_backend="y4m", part_ext=".y4m")


def test_cross_process_kill9_takeover(tmp_path):
    """Two OS-process workers; the first is SIGKILLed mid-segment.  The
    survivor steals the stale lease, completes every segment and wins
    the finalize election; the output is frame-exact."""
    n, seg = 24, 4
    inp = str(tmp_path / "in.y4m")
    _write_input(inp, n, step=4, base=10)
    ws = state.Workspace(str(tmp_path / "work"))
    ws.create()
    ws.save(state.JobState(
        input_path=inp, output_path=str(tmp_path / "out.y4m"), scale=2,
        segment_size=seg, frame_count=n, fps_num=24, fps_den=1, width=32,
        height=24, pending=planner.plan_segments(n, seg)))

    def spawn(wid, delay):
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", ws.root,
             wid, str(delay)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=str(tmp_path))

    p1 = spawn("w1", 0.5)
    lease_dir = os.path.join(ws.root, leases.LEASES_DIR)
    deadline = time.time() + 60
    while not (os.path.isdir(lease_dir) and any(
            f.endswith(".lease") for f in os.listdir(lease_dir))):
        if time.time() > deadline or p1.poll() is not None:
            p1.kill()
            raise AssertionError(f"w1 never claimed a lease: "
                                 f"{p1.communicate()[0]}")
        time.sleep(0.02)
    os.kill(p1.pid, signal.SIGKILL)
    p1.wait(timeout=30)
    assert ws.completed_parts(".y4m") == []  # killed mid-segment
    p2 = spawn("w2", 0.0)
    out, _ = p2.communicate(timeout=120)
    assert p2.returncode == 0, out[-2000:]
    assert "RESULT 6 finalized" in out
    lumas = _lumas(str(tmp_path / "out.y4m"), n)
    assert all(abs(v - (10 + 4 * i)) <= 2 for i, v in enumerate(lumas)), \
        lumas
    with open(os.path.join(lease_dir, "finalize.lease")) as f:
        assert f.read() == "w2"


def _worker(root, wid, delay):
    """The kill -9 case's worker: run the workspace's job as lease-queue
    worker `wid` (stale after 1 s) on FakeEngine, then the election."""
    ws = state.Workspace(root)
    st = ws.load()
    q = leases.SegmentLeaseQueue(ws, wid, stale_after=1.0, part_ext=".y4m")
    done = leases.run_sharded(st, ws, FakeEngine(delay=delay), wid,
                              io_backend="y4m", part_ext=".y4m",
                              stale_after=1.0, queue=q)
    won = q.all_done(st.pending) and q.claim_finalize(st.output_path)
    if won:
        scheduler.finalize(dataclasses.replace(st, pending=[]), ws,
                           io_backend="y4m", part_ext=".y4m")
    print(f"RESULT {done} {'finalized' if won else 'left'}", flush=True)


# -- shard jobs on the port's CPU engine -------------------------------------

PTH = os.path.join(REPO, "models", "realesr-animevideov3-x4.pth")
JOB = ["-s", "4", "--io-backend", "y4m", "--weights", PTH, "-S", "2",
       "--batch", "2", "--dtype", "float32", "--yes"]


def _cpu_input(tmp_path, frames=6):
    path = str(tmp_path / "in.y4m")
    rs = np.random.RandomState(0)
    with writer.Y4MWriter(path, 32, 24, fractions.Fraction(24)) as wr:
        for _ in range(frames):
            wr.write(rs.randint(0, 256, (24, 32, 3), np.uint8))
    return path


def test_two_thread_shard_job_writes_the_one_worker_bytes(tmp_path,
                                                          monkeypatch):
    """One job's state, two threads each running it through the job body
    as a shard worker on its own CPU engine: the segments split between
    them, exactly one finalizes, and the output is the one-worker CLI
    job's, byte for byte; the shared workspace stays."""
    import argparse

    import torch

    from reve_tpu_torch import cli
    from reve_tpu_torch.pipeline import job as job_mod
    from reve_tpu_torch.pipeline.engine import UpscaleEngine

    torch.set_num_threads(2)
    monkeypatch.chdir(tmp_path)
    inp = _cpu_input(tmp_path)
    one = str(tmp_path / "one.y4m")
    assert cli.run(["-i", inp, one] + JOB, device="cpu") == 0
    out = str(tmp_path / "out.y4m")
    ws = state.Workspace(out + ".revework")
    settings = argparse.Namespace(
        weights=PTH, weights_wdn=None, denoise=None, dtype="float32",
        int8_calib="p99.9", tta=False, io_backend="y4m",
        allow_random_init=False)
    st = job_mod.fresh(ws, settings, input_path=inp, output_path=out,
                       scale=4, segment_size=2, model="realesr-animevideov3",
                       encode={})
    ws.save(st)
    results, notes = {}, []
    go = threading.Barrier(2)

    def worker(wid):
        engine = UpscaleEngine(weights=PTH, scale=4, batch_size=2,
                               compute_dtype="float32", device="cpu")
        go.wait()
        results[wid] = job_mod.run(ws, st, engine, settings,
                                   shard_worker=wid, on_note=notes.append)

    ts = [threading.Thread(target=worker, args=(w,)) for w in ("w1", "w2")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    reports = [r for _s, r in results.values() if r is not None]
    assert len(results) == 2 and len(reports) == 1
    assert reports[0]["dtype"] == "float32"
    done = sorted(int(n.split(": ")[1].split()[0]) for n in notes
                  if n.startswith("worker "))
    assert sum(done) == 3 and len(done) == 2
    with open(out, "rb") as a, open(one, "rb") as b:
        assert a.read() == b.read()
    assert os.path.isdir(ws.root)  # never removed by a shard worker


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(sys.argv[2], sys.argv[3], float(sys.argv[4]))
