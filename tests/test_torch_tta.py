"""The port's TTA self-ensemble (K6's plain version in
reve_tpu_torch.kernels.tta and the engine's TTAPendingBatch) against the
JAX package's (reve_tpu.pipeline.engine's _tta_* and TTAPendingBatch), on
the CPU.  Each engine case mirrors one of tests/test_tta.py.

Tolerances: K6's plain version and the transforms are exact against the
reference (integer arithmetic and data movement).  The port's TTA engine
against reve_tpu's, in float32: u8 |d| <= 1 on at most 0.1% of the bytes
(each of the 8 model outputs may differ by 1 where a float32 sum in
another order meets a rounding boundary, and the mean of 8 such terms by
at most 1).  Against its own manual ensemble, and under a dihedral
transform of its input, the port's ensemble is exact.
"""

import numpy as np
import pytest
import torch

from reve_tpu.models import srvgg as jsrvgg
from reve_tpu.pipeline import engine as jengine
from reve_tpu_torch.kernels import tta
from reve_tpu_torch.models import srvgg
from reve_tpu_torch.pipeline.engine import Plan, TTAPendingBatch, UpscaleEngine

torch.set_num_threads(2)


def _source_pixel(i, j, k, flip, ho, wo):
    """The pixel (p, q) of y that output pixel (i, j) of an (ho, wo) frame
    reads: a copy of csrc/tta.cu's `source`."""
    if k == 0:
        p, zq = i, j
    elif k == 1:
        p, zq = wo - 1 - j, i
    elif k == 2:
        p, zq = ho - 1 - i, wo - 1 - j
    else:
        p, zq = j, ho - 1 - i
    wy = ho if k & 1 else wo
    return p, (wy - 1 - zq if flip else zq)


def _params(seed=0):
    import jax

    jcfg = jsrvgg.SRVGGConfig(num_feat=16, num_conv=3, upscale=2)
    jparams = jsrvgg.init_params(jax.random.key(seed), jcfg)
    cfg = srvgg.SRVGGConfig(num_feat=16, num_conv=3, upscale=2)
    return (jcfg, jparams), (cfg, srvgg.params_from_jax(jparams))


def _engine(tta_on=False, dtype="float32", batch_size=2, **kw):
    _, mine = _params()
    return UpscaleEngine(device="cpu", compute_dtype=dtype, tta=tta_on,
                         batch_size=batch_size, preloaded=mine, **kw)


def _frames(n, h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3),
                                               np.uint8)


def _manual_tta(engine, frames):
    """The ensemble by hand: the non-TTA engine on each forward-transformed
    batch, inverse-transformed and averaged by K6's plain version."""
    x = torch.from_numpy(frames)
    acc = mean = None
    for s, (k, flip) in enumerate(tta.SPECS):
        y = torch.from_numpy(engine.upscale_frames(
            tta.forward_transform(x, k, flip).numpy()).copy())
        if acc is None:
            n, ho, wo, _ = tta.inverse_term_plain(y, k, flip).shape
            acc = torch.empty((n, ho, wo, 3), dtype=tta.ACC_DTYPE)
            mean = torch.empty((n, ho, wo, 3), dtype=torch.uint8)
        form = tta.FIRST if s == 0 else tta.LAST if s == 7 else tta.MIDDLE
        tta.tta_accumulate(y, acc, k, flip, form, out=mean)
    return mean.numpy()


def test_specs_and_transforms_equal_jax():
    """The same 8 transforms in the same order; forward and inverse equal
    the reference's and undo each other."""
    assert tta.SPECS == jengine._TTA_SPECS
    x = _frames(2, 6, 9, seed=0)
    seen = set()
    for k, flip in tta.SPECS:
        t = tta.forward_transform(torch.from_numpy(x), k, flip)
        np.testing.assert_array_equal(t.numpy(), jengine._tta_fwd(x, k, flip))
        np.testing.assert_array_equal(
            tta.inverse_term_plain(t, k, flip).numpy(), x)
        np.testing.assert_array_equal(
            tta.inverse_term_plain(t, k, flip).numpy(),
            jengine._tta_inv(t.numpy(), k, flip))
        seen.add(t.numpy().tobytes() + str(t.shape).encode())
    assert len(seen) == 8


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 5, 7), (3, 12, 8)])
def test_k6_plain_equals_jax_accumulate_and_mean(shape):
    """All 8 transforms through the three forms against _tta_acc_device /
    _tta_mean_device, on non-square frames and B > 1."""
    b, ho, wo = shape
    rs = np.random.RandomState(ho * wo)
    acc = torch.empty((b, ho, wo, 3), dtype=tta.ACC_DTYPE)
    mean = torch.empty((b, ho, wo, 3), dtype=torch.uint8)
    jacc = None
    for s, (k, flip) in enumerate(tta.SPECS):
        ys = (b, wo, ho, 3) if k & 1 else (b, ho, wo, 3)
        y = rs.randint(0, 256, ys).astype(np.uint8)
        form = tta.FIRST if s == 0 else tta.LAST if s == 7 else tta.MIDDLE
        tta.tta_accumulate(torch.from_numpy(y), acc, k, flip, form,
                           out=mean)
        jacc = jengine._tta_acc_device(jacc, y, k=k, flip=flip)
        if form != tta.LAST:
            np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(
        mean.numpy(), np.asarray(jengine._tta_mean_device(jacc)))


@pytest.mark.parametrize("spec", tta.SPECS, ids=str)
def test_k6_index_arithmetic_and_tiles(spec):
    """csrc/tta.cu's `source` (copied as _source_pixel) gathers the term
    inverse_term_plain computes, and each 32 x 32 output tile's y pixels
    lie in the rectangle spanned by its two corners' sources, which is
    at most 32 x 32 (the kernel's staging buffer)."""
    k, flip = spec
    ho, wo, t = 37, 70, 32
    ys = (wo, ho) if k & 1 else (ho, wo)
    y = torch.arange(ys[0] * ys[1]).reshape(1, *ys, 1)
    ref = tta.inverse_term_plain(y, k, flip)[0, ..., 0]
    for i in range(ho):
        for j in range(wo):
            p, q = _source_pixel(i, j, k, flip, ho, wo)
            assert ref[i, j] == y[0, p, q, 0]
    for i0 in range(0, ho, t):
        for j0 in range(0, wo, t):
            i1, j1 = min(i0 + t, ho), min(j0 + t, wo)
            pa, qa = _source_pixel(i0, j0, k, flip, ho, wo)
            pb, qb = _source_pixel(i1 - 1, j1 - 1, k, flip, ho, wo)
            p0, q0 = min(pa, pb), min(qa, qb)
            rows, cols = abs(pa - pb) + 1, abs(qa - qb) + 1
            assert rows <= t and cols <= t
            for i in range(i0, i1):
                for j in range(j0, j1):
                    p, q = _source_pixel(i, j, k, flip, ho, wo)
                    assert 0 <= p - p0 < rows and 0 <= q - q0 < cols


def test_tta_engine_matches_jax_tta_engine():
    (jcfg, jparams), _ = _params()
    ref = jengine.UpscaleEngine(compute_dtype="float32", batch_size=2,
                                tta=True, preloaded=(jcfg, jparams))
    frames = _frames(2, 20, 28, seed=1)
    got = _engine(True).submit(frames).result()
    want = ref.submit(frames).result()
    assert got.shape == want.shape == (2, 40, 56, 3)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


def test_tta_matches_manual_ensemble():
    frames = _frames(2, 20, 28, seed=1)
    plain = _engine()
    got = _engine(True).submit(frames).result()
    np.testing.assert_array_equal(got, _manual_tta(plain, frames))
    # the ensemble averaged something
    assert not np.array_equal(got, plain.upscale_frames(frames))


def test_tta_dihedral_equivariance_exact():
    """tta(T(x)) == T(tta(x)) byte for byte on non-square frames."""
    frames = _frames(2, 16, 24, seed=2)
    e = _engine(True)
    base = torch.from_numpy(e.submit(frames).result().copy())
    x = torch.from_numpy(frames)
    for k, flip in ((1, False), (2, False), (0, True), (3, True)):
        got = e.submit(tta.forward_transform(x, k, flip).numpy()).result()
        np.testing.assert_array_equal(
            got, tta.forward_transform(base, k, flip).numpy(),
            err_msg=f"equivariance broken for rot{k * 90}, flip={flip}")


def test_tta_result_is_one_shot():
    pending = _engine(True).submit(_frames(2, 8, 8, seed=7))
    assert isinstance(pending, TTAPendingBatch)
    pending.result()
    with pytest.raises(RuntimeError, match="one-shot"):
        pending.result()


def test_tta_short_batch_padding_and_stats():
    e = _engine(True, batch_size=2)
    out = e.submit(_frames(1, 12, 12, seed=3)).result()
    assert out.shape == (1, 24, 24, 3)
    assert e.stats.frames == 1 and e.stats.batches == 1
    # 8 transforms, one model call each
    assert e.stats.calls == 8


def test_tta_upscale_frames_multi_batch():
    frames = _frames(5, 10, 14, seed=4)
    e = _engine(True, batch_size=2)
    np.testing.assert_array_equal(e.upscale_frames(frames),
                                  _manual_tta(_engine(batch_size=2), frames))


def test_tta_int8(monkeypatch):
    """TTA composes with the int8 turbo: calibration runs once, on the
    untransformed frames; all 8 passes quantize with its scales (the
    ensemble equals the manual one on an engine holding the same scales)
    and a resubmission gives the same bytes."""
    monkeypatch.setattr(UpscaleEngine, "_CALIB_CHUNK_ELEMS", 2 * 16 * 16 * 16)
    frames = _frames(2, 16, 16, seed=5)
    e = _engine(True, "int8")
    out1 = e.submit(frames).result()
    assert out1.shape == (2, 32, 32, 3)
    maxima = e.get_calibration()
    assert maxima is not None
    np.testing.assert_array_equal(e.submit(frames).result(), out1)
    np.testing.assert_array_equal(e.get_calibration(), maxima)
    plain = _engine(False, "int8")
    plain.set_calibration(maxima)
    np.testing.assert_array_equal(out1, _manual_tta(plain, frames))


def test_tta_warmup_plans_the_rotated_shape():
    e = _engine(True)
    e.warmup(10, 14)
    assert {(10, 14), (14, 10)} <= set(e._plans)
    assert e.stats.frames == 0 and e.stats.batches == 0


def test_tta_chunked_pieces_accumulate_exactly():
    """TTA when the plan splits each batch into 1-frame pieces (both
    orientations): K6 accumulates piece by piece, the result equals the
    unchunked ensemble byte for byte, with 8 model calls per piece."""
    frames = _frames(2, 12, 20, seed=6)
    expected = _engine(True).submit(frames).result()
    e = _engine(True)
    e._plans[(12, 20)] = e._plans[(20, 12)] = Plan(0, 1)
    np.testing.assert_array_equal(e.submit(frames).result(), expected)
    assert e.stats.calls == 8 * 2


def test_tta_on_tiles_equals_tta_on_whole_frames():
    """Both new paths at once: halo tiles of 8 under each of the 8
    transforms (the odd ones on the rotated frame's own tile plan)."""
    frames = _frames(2, 21, 30, seed=8)
    whole = _engine(True, tile=-1).submit(frames).result()
    e = _engine(True, tile=8)
    np.testing.assert_array_equal(e.submit(frames).result(), whole)
    assert e._plans[(21, 30)].tile == e._plans[(30, 21)].tile == 8
