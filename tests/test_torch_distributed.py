"""The port's multi-process bootstrap (reve_tpu_torch.parallel.distributed)
for real: two processes take their identities from the launcher's
environment (RANK, WORLD_SIZE, LOCAL_RANK, as torchrun sets it) and
shard one job's segments through the lease queue on the CPU engine.  The worker is this file itself (`python
tests/test_torch_distributed.py worker ROOT`), so no helper file is
needed.
"""

import dataclasses
import fractions
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: the job's engine in both the workers and the one-worker reference
ENGINE = dict(scale=2, batch_size=4, device="cpu", allow_random_init=True,
              compute_dtype="float32")


def test_initialize_without_the_environment_is_the_single_process(
        monkeypatch):
    import torch.distributed as dist

    from reve_tpu.parallel import distributed as jdist
    from reve_tpu_torch.parallel import distributed

    for k in distributed.ENV:
        monkeypatch.delenv(k, raising=False)
    ident = distributed.initialize()
    assert (ident.process_index, ident.process_count, ident.local_rank) == \
        (0, 1, 0)
    assert ident.worker_id == f"{socket.gethostname()}-p0" == \
        jdist.initialize().worker_id
    assert not dist.is_initialized()
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.initialize().local_rank == 3


@pytest.mark.parametrize("rank,world,local", [(0, 2, 0), (3, 4, 1),
                                              (7, 8, 3)])
def test_initialize_reads_the_launchers_environment(monkeypatch, rank, world,
                                                    local):
    """RANK, WORLD_SIZE and LOCAL_RANK as torchrun sets them give the
    identity, its worker id from the rank; no process group is joined."""
    import torch.distributed as dist

    from reve_tpu_torch.parallel import distributed

    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setenv("LOCAL_RANK", str(local))
    assert distributed.initialize() == distributed.Identity(
        worker_id=f"{socket.gethostname()}-p{rank}", process_index=rank,
        process_count=world, local_rank=local)
    assert not dist.is_initialized()


def _job(root, out, inp, n=24, seg=4):
    from reve_tpu_torch.pipeline import planner, state

    ws = state.Workspace(root)
    ws.create()
    ws.save(state.JobState(
        input_path=inp, output_path=out, scale=2, segment_size=seg,
        frame_count=n, fps_num=24, fps_den=1, width=32, height=24,
        pending=planner.plan_segments(n, seg)))
    return ws


def _shard(ws, worker_id):
    """Run the workspace's job as lease-queue worker `worker_id` on the
    CPU engine, then the finalize election; (segments, finalized).  The
    queue is read as a resume reads it (the parts on disk, not the saved
    pending list, which another worker's segments may have emptied)."""
    from reve_tpu_torch.pipeline import leases, scheduler, state
    from reve_tpu_torch.pipeline.engine import UpscaleEngine

    st = state.repair_pending(ws.load(), ws, ext=".y4m")
    q = leases.SegmentLeaseQueue(ws, worker_id, part_ext=".y4m")
    done = leases.run_sharded(st, ws, UpscaleEngine(**ENGINE), worker_id,
                              io_backend="y4m", part_ext=".y4m", queue=q)
    won = q.all_done(st.pending) and q.claim_finalize(st.output_path)
    if won:
        scheduler.finalize(dataclasses.replace(st, pending=[]), ws,
                           io_backend="y4m", part_ext=".y4m")
    return done, won


def test_two_gloo_processes_shard_a_job(tmp_path):
    """Two processes of one launch, distinct worker ids from their
    RANKs, share the 6 segments of a 24-frame job: every segment run
    once, one finalizer, and the output byte for byte the one-worker
    job's."""
    import torch

    from reve_tpu_torch.io import writer

    torch.set_num_threads(2)
    inp = str(tmp_path / "in.y4m")
    rs = np.random.RandomState(0)
    with writer.Y4MWriter(inp, 32, 24, fractions.Fraction(24)) as wr:
        for _ in range(24):
            wr.write(rs.randint(0, 256, (24, 32, 3), np.uint8))
    one = str(tmp_path / "one.y4m")
    assert _shard(_job(str(tmp_path / "one_ws"), one, inp), "solo") == (6,
                                                                         True)
    out = str(tmp_path / "out.y4m")
    root = str(tmp_path / "ws")
    _job(root, out, inp)
    env = dict(os.environ, WORLD_SIZE="2", OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", root],
        env=dict(env, RANK=str(i), LOCAL_RANK=str(i)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    results = []
    try:
        for p in procs:
            log, _ = p.communicate(timeout=120)
            assert p.returncode == 0, log[-2000:]
            line = [ln for ln in log.splitlines() if ln.startswith("RESULT ")]
            assert line, log[-2000:]
            results.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert sorted((r["index"], r["count"], r["local_rank"])
                  for r in results) == [(0, 2, 0), (1, 2, 1)]
    assert len({r["worker_id"] for r in results}) == 2
    assert sum(r["segments"] for r in results) == 6
    assert sum(r["finalized"] for r in results) == 1
    with open(out, "rb") as a, open(one, "rb") as b:
        assert a.read() == b.read()


def _worker(root):
    import torch

    from reve_tpu_torch.parallel import distributed
    from reve_tpu_torch.pipeline import state

    torch.set_num_threads(2)
    ident = distributed.initialize()
    done, won = _shard(state.Workspace(root), ident.worker_id)
    print("RESULT " + json.dumps({
        "worker_id": ident.worker_id, "index": ident.process_index,
        "count": ident.process_count, "local_rank": ident.local_rank,
        "segments": done, "finalized": won}), flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(sys.argv[2])
