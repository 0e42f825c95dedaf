"""Scene-aligned segments in the port (reve_tpu_torch.pipeline.scenes,
`--scene-align` in the CLI, `scene_align=True` in the API, and the
resume of such a job) against the JAX package on the same frames, on the
CPU.  Host-only numpy on both sides, so every comparison is exact: the
cuts, the plans and the state's saved plan equal; the jobs' 10-bit
samples agree to 1 as tests/test_torch_cli.py holds the hermetic job
(float32 convs summed in another order), and the port's scene-aligned
job writes the bytes of its unaligned one (a segment's boundaries move
no frame's result).
"""

import fractions
import json
import os

import numpy as np
import pytest

from reve_tpu import cli as jcli
from reve_tpu.io import reader as jreader
from reve_tpu.pipeline import planner as jplanner
from reve_tpu.pipeline import scenes as jscenes
from reve_tpu_torch import cli, upscale_video
from reve_tpu_torch.io import reader, writer
from reve_tpu_torch.pipeline import planner, scenes
from reve_tpu_torch.pipeline.state import Workspace
from test_torch_cli import JOB, jax_native_core  # noqa: F401

N, CUT, SEG = 24, 10, 8


def _scene_clip(tmp_path, n=N, cuts=(CUT,), w=32, h=24, seed=0):
    """A y4m clip whose scenes start at `cuts`: each scene a seeded
    gradient at its own brightness, drifting a pixel a frame, with small
    noise (mean |delta luma| in a scene far below the detector's 28, at a
    cut far above)."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    path = str(tmp_path / "scenes.y4m")
    with writer.Y4MWriter(path, w, h, fractions.Fraction(24)) as wr:
        for i in range(n):
            s = sum(i >= c for c in cuts)
            base = 40 + 150 * (s % 2) + (yy * 3 + (xx + i) * 2) % 40
            wr.write(np.clip(base[..., None] + rs.randint(-4, 5, (h, w, 3)),
                             0, 255).astype(np.uint8))
    return path


def _plan(segs):
    return [(s.index, s.start, s.size) for s in segs]


@pytest.mark.parametrize("kw", [{}, {"threshold": 200.0}, {"min_gap": 30},
                                {"stride": 3}])
def test_detect_cuts_matches_jax(tmp_path, kw):
    path = _scene_clip(tmp_path, cuts=(5, 17))
    with reader.Y4MReader(path) as rd:
        got = scenes.detect_cuts(rd, N, **kw)
    with jreader.Y4MReader(path) as rd:
        want = jscenes.detect_cuts(rd, N, **kw)
    assert got == want
    if not kw or "stride" in kw:
        assert got == [5, 17]


def test_plan_segments_aligned_matches_jax():
    """Seeded plans across clip lengths, segment sizes, cut sets and snap
    windows: the same segments as the JAX package's, tiling the clip with
    no gap, no overlap and no empty segment."""
    rs = np.random.RandomState(1)
    for _ in range(300):
        n = int(rs.randint(1, 400))
        seg = int(rs.randint(1, 60))
        cuts = sorted(set(rs.randint(-5, n + 5, rs.randint(0, 12))))
        window = None if rs.rand() < 0.5 else int(rs.randint(0, 20))
        got = scenes.plan_segments_aligned(n, seg, cuts, window)
        want = jscenes.plan_segments_aligned(n, seg, cuts, window)
        assert _plan(got) == _plan(want)
        assert got[0].start == 0 and all(s.size > 0 for s in got)
        assert all(a.start + a.size == b.start for a, b in zip(got, got[1:]))
        assert got[-1].start + got[-1].size == n
    # no cut near a boundary: the fixed plan
    assert _plan(scenes.plan_segments_aligned(30, 8, [])) == \
        _plan(planner.plan_segments(30, 8)) == \
        _plan(jplanner.plan_segments(30, 8))
    for args in ((0, 8, []), (8, 0, [])):
        for mod in (scenes, jscenes):
            with pytest.raises(ValueError, match="must be positive"):
                mod.plan_segments_aligned(*args)


def test_plan_for_video_matches_jax(tmp_path):
    path = _scene_clip(tmp_path)
    from reve_tpu.io import probe as jprobe
    from reve_tpu_torch.io import probe

    got = scenes.plan_for_video(path, "y4m", probe.probe(path, "y4m"), SEG)
    want = jscenes.plan_for_video(path, "y4m", jprobe.probe(path, "y4m"),
                                  SEG)
    assert _plan(got) == _plan(want) == [(0, 0, 10), (1, 10, 8), (2, 18, 6)]


def _saved_plan(out):
    with open(os.path.join(out + ".revework", "state.json")) as f:
        return [(s["index"], s["start"], s["size"])
                for s in json.load(f)["plan"]]


@pytest.mark.usefixtures("jax_native_core")
def test_cli_scene_align_job_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """--scene-align through both CLIs: the same snapped plan in
    state.json and the same samples; the port's job writes the bytes of
    its unaligned job, whose plan is the fixed one; the API with
    scene_align=True plans and writes the same."""
    monkeypatch.chdir(tmp_path)
    inp = _scene_clip(tmp_path)
    job = [a if a != "3" else str(SEG) for a in JOB] + ["--keep-workspace"]
    want, got, fixed = (str(tmp_path / f"{n}.y4m")
                        for n in ("jax", "torch", "fixed"))
    assert jcli.run(["-i", inp, want, "--scene-align"] + job) == 0
    capsys.readouterr()
    assert cli.run(["-i", inp, got, "--scene-align"] + job,
                   device="cpu") == 0
    assert "scene-align: 3 segment(s) planned" in capsys.readouterr().err
    assert _saved_plan(got) == _saved_plan(want) == \
        [(0, 0, 10), (1, 10, 8), (2, 18, 6)]
    assert cli.run(["-i", inp, fixed] + job, device="cpu") == 0
    assert _saved_plan(fixed) == [(0, 0, 8), (1, 8, 8), (2, 16, 8)]
    gh, want_frames = _frames_of(want)
    _, got_frames = _frames_of(got)
    assert len(got_frames) == len(want_frames) == N
    for g, w in zip(got_frames, want_frames):
        assert np.abs(g - w).max() <= 1
    with open(fixed, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    api_out = str(tmp_path / "api.y4m")
    upscale_video(inp, api_out, 4, weights=job[job.index("--weights") + 1],
                  segment_size=SEG, batch=2, dtype="float32",
                  io_backend="y4m", device="cpu", scene_align=True,
                  keep_workspace=True)
    assert _saved_plan(api_out) == _saved_plan(got)
    with open(api_out, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


def _frames_of(path):
    """(header, [frame sample arrays]) of a 4:2:0 y4m file."""
    from test_torch_cli import _samples

    header, _bits, frames = _samples(path)
    return header, frames


def test_scene_aligned_resume_keeps_the_saved_plan(tmp_path, monkeypatch,
                                                   capsys):
    """A crashed scene-aligned job (its middle segment not committed)
    resumes from a command line without --scene-align, and one with a
    different -S: the saved plan's segment runs again, and the output is
    byte-identical to the uninterrupted run, as in reve_tpu (a
    scene-aligned plan cannot be re-derived from the frame count and
    segment size)."""
    monkeypatch.chdir(tmp_path)
    inp = _scene_clip(tmp_path)
    job = [a if a != "3" else str(SEG) for a in JOB]
    full = str(tmp_path / "full.y4m")
    assert cli.run(["-i", inp, full, "--scene-align"] + job,
                   device="cpu") == 0
    out = str(tmp_path / "out.y4m")
    assert cli.run(["-i", inp, out, "--scene-align", "--keep-workspace"]
                   + job, device="cpu") == 0
    os.unlink(out)
    ws = Workspace(out + ".revework")
    state = ws.load()
    os.unlink(ws.part_path(1, ".y4m"))
    state.pending = [s for s in state.plan if s.index == 1]
    ws.save(state)
    capsys.readouterr()
    assert cli.run(["-i", inp, out, "--keep-workspace"]
                   + [a if a != str(SEG) else "5" for a in job],
                   device="cpu") == 0
    assert "resuming: 1 segment(s) remaining" in capsys.readouterr().err
    assert _saved_plan(out) == [(0, 0, 10), (1, 10, 8), (2, 18, 6)]
    with open(out, "rb") as a, open(full, "rb") as b:
        assert a.read() == b.read()
    # the API resumes it the same way (its plan is the state's)
    os.unlink(out)
    os.unlink(ws.part_path(2, ".y4m"))
    state = ws.load()
    state.pending = [s for s in state.plan if s.index == 2]
    ws.save(state)
    upscale_video(inp, out, 4, weights=job[job.index("--weights") + 1],
                  segment_size=3, batch=2, dtype="float32",
                  io_backend="y4m", device="cpu")
    with open(out, "rb") as a, open(full, "rb") as b:
        assert a.read() == b.read()
