"""The port's quality tool (reve_tpu_torch.utils.quality, a numpy copy
of reve_tpu.utils.quality reading through the port's own readers)
against reve_tpu's on the same inputs: PSNR, SSIM, the video comparison
and the temporal-consistency metrics within 1e-9, and the module's
command line printing reve_tpu's JSON."""

import fractions
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from reve_tpu.utils import quality as jquality
from reve_tpu_torch.io import writer
from reve_tpu_torch.utils import quality

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _img(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape, np.uint8)


@pytest.mark.parametrize("shape", [(32, 32, 3), (24, 40, 3), (20, 30),
                                   (16, 16, 1)])
def test_psnr_and_ssim_match_reve_tpu(shape):
    a = _img(shape, 0)
    for b in (a, _img(shape, 1),
              np.clip(a.astype(int) + 3, 0, 255).astype(np.uint8)):
        assert quality.psnr(a, b) == pytest.approx(jquality.psnr(a, b),
                                                   rel=0, abs=1e-9)
        assert quality.ssim(a, b) == pytest.approx(jquality.ssim(a, b),
                                                   rel=0, abs=1e-9)
    assert quality.psnr(a, a) == float("inf")
    assert quality.ssim(a, a) == pytest.approx(1.0, abs=1e-9)


def _videos(tmp_path, n=5, jitter=2):
    pa, pb = str(tmp_path / "a.y4m"), str(tmp_path / "b.y4m")
    rs = np.random.RandomState(2)
    frames = [(rs.rand(24, 32, 3) * 200 + 20).astype(np.uint8)
              for _ in range(n)]
    for path, j in ((pa, 0), (pb, jitter)):
        with writer.Y4MWriter(path, 32, 24, fractions.Fraction(24)) as wr:
            for f in frames:
                wr.write(np.clip(f.astype(int) + j, 0, 255).astype(np.uint8))
    return pa, pb


@pytest.mark.parametrize("limit,with_ssim", [(None, True), (3, True),
                                             (None, False)])
def test_compare_videos_matches_reve_tpu(tmp_path, limit, with_ssim):
    pa, pb = _videos(tmp_path)
    got = quality.compare_videos(pa, pb, limit, with_ssim=with_ssim)
    want = jquality.compare_videos(pa, pb, limit, with_ssim=with_ssim)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-9), k
    assert got["frames"] == (limit or 5)
    pairs = list(quality.frame_pairs(pa, pb, 2))
    for (ga, gb), (wa, wb) in zip(pairs, jquality.frame_pairs(pa, pb, 2)):
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gb, wb)
    assert len(pairs) == 2


def test_compare_videos_refuses_what_reve_tpu_refuses(tmp_path):
    pa, _ = _videos(tmp_path)
    pc = str(tmp_path / "c.y4m")
    with writer.Y4MWriter(pc, 16, 24, fractions.Fraction(24)) as wr:
        wr.write(np.zeros((24, 16, 3), np.uint8))
    for mod in (quality, jquality):
        with pytest.raises(ValueError, match="frame shape mismatch"):
            mod.compare_videos(pa, pc)


@pytest.mark.parametrize("with_ref", [False, True])
def test_temporal_consistency_matches_reve_tpu(with_ref):
    rs = np.random.RandomState(0)
    base = rs.randint(0, 200, (16, 16, 3)).astype(np.uint8)
    for frames in ([base + i for i in range(5)],
                   [(base.astype(np.int32) + rs.randint(-40, 40, base.shape))
                    .clip(0, 255).astype(np.uint8) for _ in range(5)]):
        ref = [f[::2, ::2] for f in frames] if with_ref else None
        got = quality.temporal_consistency(frames, ref, scale=2)
        want = jquality.temporal_consistency(frames, ref, scale=2)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=0, abs=1e-9), k
    # a still input: no ratio, as in reve_tpu
    still = [base, base]
    assert quality.temporal_consistency(still, still, scale=1)[
        "flicker_ratio"] is None


def test_module_prints_reve_tpus_json(tmp_path):
    pa, pb = _videos(tmp_path)
    r = subprocess.run([sys.executable, "-m", "reve_tpu_torch.utils.quality",
                        pa, pb, "3"], capture_output=True, text=True,
                       cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == \
        jquality.compare_videos(pa, pb, 3)
    r = subprocess.run([sys.executable, "-m", "reve_tpu_torch.utils.quality",
                        pa], capture_output=True, text=True, cwd=REPO,
                       timeout=120)
    assert r.returncode == 2 and "usage:" in r.stderr
