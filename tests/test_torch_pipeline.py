"""The port's scheduler helpers, tracer and y4m concat against the JAX
package's (or their stated contract), on the CPU."""

import fractions
import json
import os

import numpy as np
import pytest
import torch

from reve_tpu.pipeline import scheduler as jscheduler
from reve_tpu_torch.io import concat, reader, writer
from reve_tpu_torch.pipeline import scheduler
from reve_tpu_torch.pipeline.planner import plan_segments
from reve_tpu_torch.pipeline.state import JobState, Workspace
from reve_tpu_torch.utils import trace

torch.set_num_threads(2)


def _y4m(path, frames=5, w=16, h=12):
    with writer.Y4MWriter(str(path), w, h, fractions.Fraction(24)) as wr:
        for i in range(frames):
            wr.write(reader.SyntheticReader.frame(i, h, w))
    return str(path)


def _state(inp, frames=5, w=16, h=12):
    return JobState(input_path=inp, output_path=inp + ".out.y4m", scale=2,
                    segment_size=2, frame_count=frames, fps_num=24,
                    fps_den=1, width=w, height=h,
                    pending=plan_segments(frames, 2))


@pytest.mark.parametrize("n", [0, 1, 7, 16, 17, 1000, 4321])
def test_sample_frame_indices_match_jax(n):
    assert scheduler.sample_frame_indices(n) == \
        jscheduler.sample_frame_indices(n)


def test_read_sampled_frames_seeks_the_right_frames(tmp_path):
    inp = _y4m(tmp_path / "in.y4m")
    got = scheduler.read_sampled_frames(_state(inp), "y4m", [1, 3])
    want = list(reader.Y4MReader(inp).read_range(0, 5))
    np.testing.assert_array_equal(got, np.stack([want[1], want[3]]))


def test_auto_dtype_resolves_bf16_first_wins(tmp_path, monkeypatch):
    """On CUDA (not eligible in the reference's rule) auto resolves
    bfloat16 without building an engine or certifying; the decision is
    first-wins, and a workspace resolved to int8 is followed (its engine
    built as int8 with the persisted calibration wired in)."""
    monkeypatch.delenv("REVE_TPU_AUTO_INT8", raising=False)
    built = []

    class _Int8Engine:
        _int8 = True
        calibration_hook = None

        def get_calibration(self):
            return None

    def make_engine(dtype, calib):
        built.append((dtype, calib))
        return _Int8Engine()

    ws = Workspace(str(tmp_path / "ws"))
    ws.create()
    st = _state("unused.y4m")
    dtype, eng, db, notes = scheduler.resolve_auto_dtype(
        make_engine, ws, st, platform="cuda")
    assert (dtype, eng, db) == ("bfloat16", None, None)
    assert "TPU-only" in notes[0] and "cuda" in notes[0] and not built
    dtype, eng, db, notes = scheduler.resolve_auto_dtype(
        make_engine, ws, st, platform="cuda")
    assert dtype == "bfloat16" and "inherited" in notes[0]
    ws2 = Workspace(str(tmp_path / "ws2"))
    ws2.create()
    ws2.claim_resolution("int8", 55.0)
    dtype, eng, db, notes = scheduler.resolve_auto_dtype(
        make_engine, ws2, st, platform="cuda")
    assert (dtype, db) == ("int8", 55.0) and built == [("int8", "p99.9")]
    assert eng.calibration_hook == ws2.claim_calibration


def test_fresh_workspace_drops_the_old_jobs_int8_files(tmp_path):
    """A fresh start (keep_parts=False) drops the discarded job's int8
    calibration, certificate and auto-dtype resolution with its state; a
    resume (keep_parts=True) keeps them.  (reve_tpu's Workspace.create
    keeps them, so a first-wins claim hands them to the new job.)"""
    ws = Workspace(str(tmp_path / "ws"))
    ws.create()
    ws.save(_state("unused.y4m"))
    ws.claim_calibration([1.0, 2.0])
    ws.claim_int8_cert(61.0)
    ws.claim_resolution("int8", 61.0)
    ws.create(keep_parts=True)
    assert ws.load_calibration() == [1.0, 2.0] and ws.has_state()
    assert ws.load_int8_cert() == 61.0 and ws.load_resolution()
    ws.create(keep_parts=False)
    assert not ws.has_state() and ws.load_calibration() is None
    assert ws.load_int8_cert() is None and ws.load_resolution() is None
    assert ws.claim_calibration([3.0]) == [3.0]


class _Engine:
    batch_size = 2


def test_queue_depth_hook_is_optional_but_not_swallowed(tmp_path):
    """Engines without recommended_queue_depth get the legacy depth; an
    AttributeError raised INSIDE a real implementation propagates."""
    inp = _y4m(tmp_path / "in.y4m")
    ws = Workspace(str(tmp_path / "ws"))
    ws.create()
    job = scheduler.PipelineJob(_state(inp), ws, _Engine())
    assert job.encode_q.maxsize == 3

    class Broken(_Engine):
        def recommended_queue_depth(self, h, w):
            return self.no_such_attribute

    with pytest.raises(AttributeError, match="no_such_attribute"):
        scheduler.PipelineJob(_state(inp), ws, Broken())


def test_y4m_concat_is_byte_exact_and_checks_headers(tmp_path):
    a = _y4m(tmp_path / "a.y4m", frames=2)
    b = _y4m(tmp_path / "b.y4m", frames=3)
    out = str(tmp_path / "out.y4m")
    report = concat.concatenate([a, b], a, out, fractions.Fraction(24))
    assert report == {"backend": "native", "audio_copied": False}
    with open(a, "rb") as fa, open(b, "rb") as fb, open(out, "rb") as fo:
        head = fa.readline()
        fb.readline()
        assert fo.read() == head + fa.read() + fb.read()
    assert reader.Y4MReader(out).frame_count() == 5
    c = _y4m(tmp_path / "c.y4m", frames=1, w=8, h=8)
    with pytest.raises(ValueError, match="header"):
        concat.y4m_concat([a, c], str(tmp_path / "bad.y4m"))


def test_tracer_and_torch_profile(tmp_path):
    path = str(tmp_path / "t.jsonl")
    tr = trace.Tracer(path)
    with tr.span("submit", seg=1):
        pass
    tr.close()
    rec = json.loads(open(path).read())
    assert rec["ev"] == "submit" and rec["seg"] == 1 and "dur" in rec
    prof_dir = str(tmp_path / "prof")
    with trace.device_profile(prof_dir):
        torch.ones(8).sum()
    assert os.path.getsize(os.path.join(prof_dir, "trace.json")) > 0
    with trace.device_profile(None):
        pass


def test_owner_pidfile_steal_has_exactly_one_winner_under_race(tmp_path,
                                                               monkeypatch):
    """With flock unsupported, eight threads contend for a lock whose pid
    file names a dead process: in every round exactly one acquires.  Each
    contender's flock attempt first creates an empty owner.lock if the
    path is absent, which can land between a stealer's unlink and its
    link; a stealer must not give up on such an artifact."""
    import concurrent.futures
    import errno
    import fcntl
    import subprocess
    import sys
    import time

    def no_flock(fd, op):
        raise OSError(errno.ENOLCK, "No locks available")

    monkeypatch.setattr(fcntl, "flock", no_flock)
    root = str(tmp_path / "w")
    os.makedirs(root)
    rs = np.random.RandomState(0)

    def contend(ws_delay):
        # starts staggered over 2 ms, so that some flock attempts land
        # between a steal's unlink and its link
        ws, delay = ws_delay
        time.sleep(delay)
        return ws.acquire_owner()

    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    winners = []
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        for _ in range(200):
            contenders = [Workspace(root) for _ in range(8)]
            with open(contenders[0].owner_path, "w") as f:
                json.dump({"pid": dead.pid}, f)
            delays = rs.uniform(0, 0.002, 8)
            winners.append(sum(ex.map(contend, zip(contenders, delays))))
            for w in contenders:
                w.release_owner()
    assert winners == [1] * len(winners), \
        {n: winners.count(n) for n in set(winners)}


@pytest.mark.parametrize("matrix", ["bt601", "bt709"])
@pytest.mark.parametrize("bits,full_range", [(8, False), (10, False),
                                             (10, True)])
def test_color_np_copy_matches_the_jax_packages(matrix, bits, full_range):
    """The port's copy of the host colour conversions (ops/color_np.py)
    gives the JAX package's bytes: the same numpy arithmetic, both ways."""
    from reve_tpu.ops import color_np as jcolor_np
    from reve_tpu_torch.ops import color_np

    rgb = np.random.RandomState(3).randint(0, 256, (12, 18, 3), np.uint8)
    got = color_np.rgb_to_yuv420_np(rgb, matrix=matrix, bits=bits,
                                    full_range=full_range)
    want = jcolor_np.rgb_to_yuv420_np(rgb, matrix=matrix, bits=bits,
                                      full_range=full_range)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    y, u, v = want
    np.testing.assert_array_equal(
        color_np.yuv420_to_rgb_np(y, u, v, matrix=matrix, bits=bits,
                                  full_range=full_range),
        jcolor_np.yuv420_to_rgb_np(y, u, v, matrix=matrix, bits=bits,
                                   full_range=full_range))
