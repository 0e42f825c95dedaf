"""The port's int8 turbo path (reve_tpu_torch.weights.quantize,
models.srvgg.apply_int8, the engine's calibration and certification)
against the JAX package's on the same numpy inputs, on the CPU.

Tolerances, each with its reason:
  * quantization from the same maxima: identical (float32 elementwise
    math on both sides);
  * calibration maxima from the same frames: rtol 1e-5 (the float32
    calibration forward sums in another order; measured ~2e-7);
  * the kernels' plain versions against the reference's ops on identical
    inputs: exact (integer convs, float32 epilogues rounded at the same
    points);
  * apply_int8, float32: exact.  bfloat16: exact with the int8 head; with
    the float head (int8_head=False) |du8| <= 1 on <= 2% of samples, since
    the bf16 head conv is a float32 sum taken in another order and then
    rounded to bf16, whose ulp near the head's output is about half a u8
    step (the float32 run of the same path is exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reve_tpu.models import srvgg as jsrvgg
from reve_tpu.pipeline.engine import UpscaleEngine as JaxEngine
from reve_tpu.weights import quantize as jquantize
from reve_tpu_torch.kernels import conv3x3, conv3x3_s8, head
from reve_tpu_torch.models import srvgg
from reve_tpu_torch.pipeline import engine as engine_mod
from reve_tpu_torch.pipeline.engine import UpscaleEngine
from reve_tpu_torch.weights import quantize

torch.set_num_threads(2)


def _cfgs(r=2, num_conv=4):
    return (jsrvgg.SRVGGConfig(num_feat=16, num_conv=num_conv, upscale=r),
            srvgg.SRVGGConfig(num_feat=16, num_conv=num_conv, upscale=r))


def _u8(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


@pytest.fixture(scope="module")
def small():
    jcfg, cfg = _cfgs(r=2)
    jparams = jsrvgg.init_params(jax.random.key(0), jcfg)
    u8 = _u8((2, 17, 24, 3))  # odd H
    x = jnp.asarray(u8).astype(jnp.float32) / 255.0
    maxima = np.asarray(jquantize.collect_act_maxima(jparams, x, cfg=jcfg))
    return jcfg, cfg, jparams, srvgg.params_from_jax(jparams), u8, maxima


def test_quantize_hidden_equals_jax_from_the_same_maxima(small):
    jcfg, cfg, jparams, params, _u, maxima = small
    want = jquantize.quantize_hidden(jparams, jcfg, maxima, margin=1.25)
    got = quantize.quantize_hidden(params, cfg, maxima, margin=1.25)
    for name in ("w8", "sw", "b", "alpha"):
        assert len(getattr(got, name)) == cfg.num_conv
        for g, w in zip(getattr(got, name), getattr(want, name)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for name in ("act_scale", "w8_last", "sw_last", "b_last"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert got.w8[0].dtype == torch.int8 and \
        int(got.w8[0].abs().max()) == 127
    with pytest.raises(ValueError, match="act_maxima"):
        quantize.quantize_hidden(params, cfg, np.ones(3))
    # qbody_from_jax carries the same numbers
    carried = quantize.qbody_from_jax(want)
    np.testing.assert_array_equal(carried.w8_last.numpy(),
                                  got.w8_last.numpy())


@pytest.mark.parametrize("percentile", [None, 99.9])
def test_collect_act_maxima_matches_jax(small, percentile):
    jcfg, cfg, jparams, params, u8, _m = small
    x = jnp.asarray(u8).astype(jnp.float32) / 255.0
    want = np.asarray(jquantize.collect_act_maxima(
        jparams, x, cfg=jcfg, percentile=percentile))
    got = quantize.collect_act_maxima(params, torch.from_numpy(u8), cfg=cfg,
                                      percentile=percentile)
    assert got.shape == (cfg.num_conv + 1,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_stat_subsamples_with_the_reference_stride():
    """Above 2^22 elements the percentile is taken on every
    (n // 2^22)-th element (here a stride of 3), as reve_tpu does."""
    n = 3 * (1 << 22) + 5
    a = np.random.RandomState(1).standard_normal(n).astype(np.float32)
    got = quantize._stat(torch.from_numpy(a), 99.9).item()
    want = float(jquantize._stat(jnp.asarray(a), 99.9))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        got, float(jnp.percentile(jnp.abs(jnp.asarray(a))[::3], 99.9)),
        rtol=1e-6)
    assert quantize._stat(torch.from_numpy(a), None).item() == \
        float(np.abs(a).max())


def _jax_dq_prelu(y32, scale, b, alpha):
    # reve_tpu srvgg.apply_int8.dq_prelu (a closure there), classic domain
    fy = y32.astype(jnp.float32) * scale + b
    return jnp.maximum(fy, 0) + alpha * jnp.minimum(fy, 0)


def test_plain_kernels_equal_the_reference_ops(small):
    """K4a, K4 and K4h's plain versions against the reference's ops on
    identical inputs: exact."""
    jcfg, cfg, jparams, params, u8, maxima = small
    jqb = jquantize.quantize_hidden(jparams, jcfg, maxima, margin=1.25)
    qb = quantize.qbody_from_jax(jqb)
    sx = qb.act_scale
    inv = 1.0 / sx
    jsx = jqb.act_scale
    # K4a: first conv + PReLU (float32) + _quant_s8
    x = jnp.asarray(u8).astype(jnp.float32) * (1.0 / 255.0)
    jh = jsrvgg._prelu(jsrvgg._conv3x3(x, jparams["convs"][0]["w"],
                                       jparams["convs"][0]["b"]),
                       jparams["prelus"][0]["alpha"])
    jq = jsrvgg._quant_s8(jh, jsx[0])
    q = conv3x3.conv3x3_u8_bias_prelu_q8(
        torch.from_numpy(u8), params["convs"][0]["w"],
        params["convs"][0]["b"], params["prelus"][0]["alpha"], inv[0:1])
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    # K4: s8 conv + dq_prelu + _quant_s8, on the reference's own input
    jy = jsrvgg._quant_s8(_jax_dq_prelu(
        jsrvgg._conv3x3_s8(jq, jqb.w8[0]), jsx[0] * jqb.sw[0], jqb.b[0],
        jqb.alpha[0]), jsx[1])
    y = conv3x3_s8.conv3x3_s8_dq_prelu_q8(q, qb.w8[0], sx[0] * qb.sw[0],
                                          qb.b[0], qb.alpha[0], inv[1:2])
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(
        conv3x3_s8.conv3x3_s8_plain(q, qb.w8[0]).numpy(),
        np.asarray(jsrvgg._conv3x3_s8(jq, jqb.w8[0])))
    # K4h: s8 head, float32 dequant, _epilogue(quantize_u8)
    n = cfg.num_conv
    jh = (jsrvgg._conv3x3_s8(jy, jqb.w8_last).astype(jnp.float32)
          * (jsx[n] * jqb.sw_last) + jqb.b_last)
    jout = jsrvgg._epilogue(jh, x, jcfg, quantize_u8=True)
    out = head.head_conv_s8_residual_u8_shuffle(
        y, qb.w8_last, sx[n] * qb.sw_last, qb.b_last, torch.from_numpy(u8),
        cfg.upscale)
    assert out.shape == (2, 34, 48, 3) and out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize("int8_head", [True, False])
@pytest.mark.parametrize("s2d", [True, False])
@pytest.mark.parametrize("r", [2, 4])
def test_apply_int8_matches_jax(r, s2d, int8_head):
    jcfg, cfg = _cfgs(r=r, num_conv=3)
    jparams = jsrvgg.init_params(jax.random.key(r), jcfg)
    u8 = _u8((2, 15, 22, 3), seed=r)  # odd H
    x = jnp.asarray(u8).astype(jnp.float32) / 255.0
    jqb = jquantize.quantize_hidden(
        jparams, jcfg, jquantize.collect_act_maxima(jparams, x, cfg=jcfg),
        margin=1.25)
    params, qb = srvgg.params_from_jax(jparams), quantize.qbody_from_jax(jqb)
    xm = jnp.asarray(u8).astype(jnp.float32) * (1.0 / 255.0)
    for jdt, dt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jsrvgg.apply_int8(
            jparams, jqb, xm, cfg=jcfg, compute_dtype=jdt, quantize_u8=True,
            s2d=s2d, int8_head=int8_head)).astype(np.int16)
        got = srvgg.apply_int8(params, qb, torch.from_numpy(u8), cfg=cfg,
                               compute_dtype=dt, int8_head=int8_head)
        assert got.dtype == torch.uint8 and got.shape == want.shape == \
            (2, 15 * r, 22 * r, 3)
        d = np.abs(got.numpy().astype(np.int16) - want)
        if dt == torch.float32 or int8_head:
            assert d.max() == 0, (dt, d.max(), (d > 0).mean())
        else:
            assert d.max() <= 1 and (d > 0).mean() <= 0.02, \
                (d.max(), (d > 0).mean())
    # plain=True is the same function
    np.testing.assert_array_equal(
        srvgg.apply_int8(params, qb, torch.from_numpy(u8), cfg=cfg,
                         int8_head=int8_head, plain=True).numpy(),
        got.numpy())


# -- the engine ---------------------------------------------------------------


@pytest.fixture(autouse=True)
def _small_calibration_chunks(monkeypatch):
    """Both engines pad a calibration sample to a whole chunk of
    _CALIB_CHUNK_ELEMS activations (2e8: ~39k frames of 16x20 at 16
    features).  Tests set the same budget of 4 such frames on both, so
    their chunks, and hence their scales, still correspond."""
    for cls in (UpscaleEngine, JaxEngine):
        monkeypatch.setattr(cls, "_CALIB_CHUNK_ELEMS", 4 * 16 * 20 * 16)


def _engines(batch_size=2, r=2, seed=0, **kw):
    jcfg, cfg = _cfgs(r=r, num_conv=3)
    jparams = jsrvgg.init_params(jax.random.key(seed), jcfg)
    mine = UpscaleEngine(device="cpu", compute_dtype="int8",
                         batch_size=batch_size,
                         preloaded=(cfg, srvgg.params_from_jax(jparams)),
                         **kw)
    ref = JaxEngine(compute_dtype="int8", batch_size=batch_size,
                    preloaded=(jcfg, jparams), **kw)
    return mine, ref


def test_engine_provisional_calibration_replaced_by_first_batch():
    mine, _ = _engines()
    frames = _u8((2, 16, 20, 3), seed=2)
    mine.warmup(16, 20)
    assert mine._qbody_provisional and mine.get_calibration() is None
    assert mine.stats.frames == 0 and mine.stats.batches == 0
    out = mine.upscale_frames(frames)
    assert not mine._qbody_provisional
    fresh, _ = _engines()
    np.testing.assert_array_equal(fresh.upscale_frames(frames), out)
    np.testing.assert_array_equal(fresh.get_calibration(),
                                  mine.get_calibration())
    mine.reset_calibration()
    assert mine.get_calibration() is None


def test_engine_chunked_calibration_matches_jax(monkeypatch):
    """The chunked calibration (cyclic padding to a chunk multiple,
    max-of-chunk percentiles) gives the reference's maxima."""
    mine, ref = _engines()
    frames = _u8((5, 16, 20, 3), seed=3)
    # 2 frames per chunk: 5 frames pad to 6, three chunks
    for cls in (UpscaleEngine, JaxEngine):
        monkeypatch.setattr(cls, "_CALIB_CHUNK_ELEMS", 2 * 16 * 20 * 16)
    mine.calibrate_int8(frames)
    ref.calibrate_int8(frames)
    np.testing.assert_allclose(mine.get_calibration(), ref.get_calibration(),
                               rtol=1e-5)
    one, _ = _engines()
    monkeypatch.setattr(UpscaleEngine, "_CALIB_CHUNK_ELEMS",
                        6 * 16 * 20 * 16)
    one.calibrate_int8(frames)
    # percentile-of-chunks is not the percentile of the whole sample
    assert not np.array_equal(one.get_calibration(), mine.get_calibration())


def test_engine_matches_jax_engine_with_its_calibration():
    mine, ref = _engines(batch_size=2, r=2, seed=4)
    frames = _u8((3, 14, 18, 3), seed=4)
    want = ref.upscale_frames(frames)
    mine.set_calibration(ref.get_calibration())
    got = mine.upscale_frames(frames)
    assert got.shape == want.shape == (3, 28, 36, 3)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    # the same maxima quantize identically
    q = mine._qbody
    jq = jquantize.quantize_hidden(ref.params, ref.cfg,
                                   ref.get_calibration(), margin=1.25)
    np.testing.assert_array_equal(q.act_scale.numpy(),
                                  np.asarray(jq.act_scale))


def test_certify_int8_matches_jax():
    mine, ref = _engines(batch_size=2, r=2, seed=5)
    frames = _u8((3, 16, 20, 3), seed=5)
    db_ref = ref.certify_int8(frames)
    mine.set_calibration(ref.get_calibration())
    db = mine.certify_int8(frames)
    assert abs(db - db_ref) <= 0.05, (db, db_ref)
    # chunking does not change the measurement
    assert mine.certify_int8(frames, chunk=1) == pytest.approx(db, abs=1e-9)
    with pytest.raises(ValueError, match="int8 engine"):
        UpscaleEngine(device="cpu", compute_dtype="float32",
                      preloaded=(mine.cfg, mine.params)).certify_int8(frames)


@pytest.mark.parametrize("spec,want", [("max", None), ("p99.9", 99.9),
                                       ("p100", 100.0)])
def test_parse_int8_calib(spec, want):
    assert engine_mod.parse_int8_calib(spec) == want


@pytest.mark.parametrize("bad", ["p", "q99", "p0", "p101", "pxyz"])
def test_parse_int8_calib_refuses(bad):
    with pytest.raises(ValueError):
        engine_mod.parse_int8_calib(bad)
    with pytest.raises(ValueError):
        UpscaleEngine(device="cpu", compute_dtype="int8", int8_calib=bad,
                      allow_random_init=True)


def test_int8_memory_plan_counts_s8_activations():
    mine, _ = _engines(batch_size=1)
    # 2 hidden buffers of 16 s8 channels + 3 u8 in + 12 u8 out
    assert mine._frame_bytes(10, 10) == 100 * (2 * 16 + 3 + 12)
    assert mine.compute_dtype is torch.bfloat16
