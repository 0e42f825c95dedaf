"""Halo tiling of the port (reve_tpu_torch.ops.tiling and the engine's
tiled plan) against the JAX package's (reve_tpu.ops.tiling and its
engine's tiled path), on the CPU, and against the port's own whole
frames.

The geometry is a copy: spans equal. The tiled engine's u8 output against
reve_tpu's tiled engine: |d| <= 1 (reve_tpu runs the windows to float and
rounds afterwards, the port's kernels round each window's output; the
float32 sums may differ in order).  Against the port's own whole frames:
the plain float versions use F.conv2d, which may block its sums
differently by size, so the tiled output is held exactly where it holds
and otherwise at |d| <= 1 on at most 0.1% of the bytes (measured here:
none differ); plain int8 tiles equal plain int8 whole frames.
"""

import numpy as np
import pytest
import torch

from reve_tpu.models import srvgg as jsrvgg
from reve_tpu.ops import tiling as jtiling
from reve_tpu.pipeline.engine import UpscaleEngine as JaxEngine
from reve_tpu_torch.models import srvgg
from reve_tpu_torch.ops import tiling
from reve_tpu_torch.pipeline.engine import Plan, UpscaleEngine

torch.set_num_threads(2)


def _pair(tile, dtype="float32", batch_size=2, num_conv=3, seed=0):
    """The port's engine and reve_tpu's with the same weights (16
    features, x2; halo num_conv + 2)."""
    import jax

    jcfg = jsrvgg.SRVGGConfig(num_feat=16, num_conv=num_conv, upscale=2)
    jparams = jsrvgg.init_params(jax.random.key(seed), jcfg)
    cfg = srvgg.SRVGGConfig(num_feat=16, num_conv=num_conv, upscale=2)
    mine = UpscaleEngine(device="cpu", compute_dtype=dtype, tile=tile,
                         batch_size=batch_size,
                         preloaded=(cfg, srvgg.params_from_jax(jparams)))
    ref = JaxEngine(compute_dtype=dtype, tile=tile, batch_size=batch_size,
                    preloaded=(jcfg, jparams))
    return mine, ref


def _frames(n, h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3),
                                               np.uint8)


@pytest.mark.parametrize("size", [1, 20, 33, 64, 100, 1080, 1920])
@pytest.mark.parametrize("tile", [8, 16, 32, 512])
@pytest.mark.parametrize("halo", [0, 1, 5, 18])
def test_plan_spans_equal_jax(size, tile, halo):
    mine = tiling.plan_tiles(size, size + 7, tile, halo)
    ref = jtiling.plan_tiles(size, size + 7, tile, halo)
    assert mine.row_axis.spans == ref.row_axis.spans
    assert mine.col_axis.spans == ref.col_axis.spans
    assert mine.window_shape == ref.window_shape
    assert mine.num_tiles == ref.num_tiles


def test_plan_geometry():
    plan = tiling.plan_tiles(1080, 1920, tile=512, halo=18)
    assert (plan.rows, plan.cols) == (3, 4)
    assert plan.window_shape == (548, 548)
    covered = [0] * 1080
    for (ws, _off, size, start) in plan.row_axis.spans:
        assert 0 <= ws and ws + plan.window_shape[0] <= 1080
        for i in range(start, start + size):
            covered[i] += 1
    assert all(c == 1 for c in covered)


def test_small_frame_single_window():
    plan = tiling.plan_tiles(20, 100, tile=32, halo=8)
    assert plan.rows == 1 and plan.window_shape[0] == 20


@pytest.mark.parametrize("start,stop", [(0, None), (0, 1), (3, 11),
                                        (5, 6)])
def test_extract_and_assemble_equal_jax(start, stop):
    """extract_tiles gives the reference's windows (any run of them), and
    assemble_tiles puts the reference's windows where its assemble_tiles
    puts them."""
    x = _frames(3, 20, 28, seed=1)
    plan = tiling.plan_tiles(20, 28, 8, 3)
    jplan = jtiling.plan_tiles(20, 28, 8, 3)
    want = np.asarray(jtiling.extract_tiles(x, jplan))
    got = tiling.extract_tiles(torch.from_numpy(x), plan, start, stop)
    np.testing.assert_array_equal(got.numpy(), want[start:stop])
    up = np.repeat(np.repeat(want, 2, axis=1), 2, axis=2)
    whole = np.asarray(jtiling.assemble_tiles(up, jplan, 2, 3))
    mine = tiling.assemble_tiles(torch.from_numpy(up), plan, 2, 3)
    np.testing.assert_array_equal(mine.numpy(), whole)


@pytest.mark.parametrize("scale", [2, 3])
@pytest.mark.parametrize("chunk", [0, 1, 5])
def test_extract_assemble_identity(scale, chunk):
    """halo 0 and a nearest-upsampling "model": the assembled output is
    the upsampled frame, in any chunking of the windows."""
    x = torch.from_numpy(_frames(2, 20, 28, seed=2))

    def up(t):
        return t.repeat_interleave(scale, 1).repeat_interleave(scale, 2)
    out = tiling.upscale_tiled(up, x, scale=scale, tile=8, halo=0,
                               chunk=chunk)
    assert torch.equal(out, up(x))


@pytest.mark.parametrize("hw", [(33, 47), (64, 64), (30, 100)])
@pytest.mark.parametrize("tile", [16, 32])
def test_tiled_engine_matches_jax_tiled_engine(hw, tile):
    mine, ref = _pair(tile)
    frames = _frames(2, *hw, seed=3)
    got = mine.submit(frames).result()
    want = ref.submit(frames).result()
    assert got.shape == want.shape == (2, hw[0] * 2, hw[1] * 2, 3)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    assert mine._plans[hw] == Plan(tile, 2 * tiling.plan_tiles(
        *hw, tile, mine.halo).num_tiles)


@pytest.mark.parametrize("hw", [(33, 47), (64, 64), (30, 100)])
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_engine_matches_its_whole_frames(hw, tile, dtype):
    tiled, _ = _pair(tile, dtype)
    whole, _ = _pair(-1, dtype)
    frames = _frames(2, *hw, seed=4)
    got = tiled.submit(frames).result()
    want = whole.submit(frames).result()
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and int((d > 0).sum()) <= d.size // 1000, \
        int((d > 0).sum())


def test_int8_tiles_equal_int8_whole_frames(monkeypatch):
    """Calibration runs on whole frames, never windows: both engines hold
    the same scales, and the tiled int8 output equals the whole-frame
    one.  (Calibration pads its sample to a chunk of _CALIB_CHUNK_ELEMS
    activations: two frames here.)"""
    monkeypatch.setattr(UpscaleEngine, "_CALIB_CHUNK_ELEMS", 2 * 40 * 52 * 16)
    tiled, _ = _pair(16, "int8")
    whole, _ = _pair(-1, "int8")
    frames = _frames(2, 40, 52, seed=5)
    want = whole.submit(frames).result()
    got = tiled.submit(frames).result()
    np.testing.assert_array_equal(tiled.get_calibration(),
                                  whole.get_calibration())
    np.testing.assert_array_equal(got, want)


def test_chunked_windows_are_exact():
    """Windows in calls of 1, 5 or all: the same bytes, and the model
    calls the plan says."""
    frames = _frames(2, 33, 47, seed=6)
    tiled, _ = _pair(16)
    n = 2 * tiling.plan_tiles(33, 47, 16, tiled.halo).num_tiles
    want = tiled.submit(frames).result()
    for per_call in (1, 5):
        tiled._plans[(33, 47)] = Plan(16, per_call)
        calls = tiled.stats.calls
        np.testing.assert_array_equal(tiled.submit(frames).result(), want)
        assert tiled.stats.calls - calls == -(-n // per_call)


def test_insufficient_halo_differs():
    """With a halo under the receptive-field radius, seams appear: the
    exactness above is not an accident of the sizes."""
    mine, _ = _pair(16)
    x = torch.from_numpy(_frames(1, 40, 40, seed=7))
    whole = mine._forward(x)
    tiled = tiling.upscale_tiled(mine._forward, x, scale=2, tile=16,
                                 halo=1)
    assert not torch.equal(tiled, whole)
    exact = tiling.upscale_tiled(mine._forward, x, scale=2, tile=16,
                                 halo=mine.halo)
    assert torch.equal(exact, whole)
