"""RRDB's int8 turbo in the port (weights.quantize's RRDB part, K7q's
plain versions, rrdb.apply_int8, the engine's calibration and
certification, the CLI job and its resume) against the JAX package's on
the same numbers, on the CPU, at 1 block on frames of at most 24 x 32.

Tolerances, each with its reason:
  * quantize_rrdb from the same maxima: identical (float32 elementwise
    math on both sides);
  * collect_act_maxima_rrdb, max and p99.9: rtol 1e-5 (the float32
    calibration forward sums in another order; measured ~1e-6);
  * one dense block through K7q's plain forms against the reference's
    `_rdb_int8` run op by op (each multiply and add rounded on its own,
    as the ops are written and as K7q rounds): s8 codes identical, the
    float32 chain exact;
  * apply_int8: float32 u8 |d| <= 1 with at least 99.9% of bytes equal
    (measured: all equal; the reference's jitted dequant may contract a
    multiply and add into an FMA, which can move an s8 code); bfloat16
    at >= 50 dB against the JAX package's (measured: one byte in 30,720
    off by 1: the bf16 first conv sums in another order);
  * the engines and the CLI job: the float parts in bfloat16 as above,
    so 10-bit samples |d| <= 4 on at most 2% (one u8 step is up to 4
    steps of a 10-bit sample), the certificate within 0.05 dB.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reve_tpu import cli as jcli
from reve_tpu.models import rrdb as jrrdb
from reve_tpu.models import srvgg as jsrvgg
from reve_tpu.pipeline.engine import UpscaleEngine as JaxEngine
from reve_tpu.weights import quantize as jquantize
from reve_tpu_torch import cli, upscale_video
from reve_tpu_torch.io import reader
from reve_tpu_torch.kernels import rrdb as k7
from reve_tpu_torch.models import rrdb
from reve_tpu_torch.pipeline.engine import UpscaleEngine
from reve_tpu_torch.pipeline.state import Workspace
from reve_tpu_torch.weights import quantize
from test_torch_cli import jax_native_core  # noqa: F401
from test_torch_rrdb import (_frames, _jparams, _max_diff, _port, _psnr,
                             _save_upstream_pth, _y4m, _y4m_samples)

torch.set_num_threads(2)

NF, GC, CS = 64, 32, 192


def _x(u8):
    """The JAX engine's model input: u8 * float32(1 / 255)."""
    return jnp.asarray(u8).astype(jnp.float32) * (1.0 / 255.0)


@pytest.fixture(scope="module")
def one_block():
    """1 block with seeded biases, 2 frames of 16 x 20, and the JAX
    package's p99.9 maxima on them."""
    jcfg, jp = _jparams(1, seed=1, biased=True)
    cfg, params = _port(jcfg, jp)
    u8 = _frames((2, 16, 20, 3), seed=7)
    maxima = np.asarray(jquantize.collect_act_maxima_rrdb(
        jp, _x(u8), cfg=jcfg, percentile=99.9))
    return jcfg, jp, cfg, params, u8, maxima


def _qbody_numpy(jqb):
    return jax.tree_util.tree_map(np.asarray, jqb)


# -- quantization -------------------------------------------------------------


def test_quantize_rrdb_equals_jax_from_the_same_maxima(one_block):
    jcfg, jp, cfg, params, _u8, maxima = one_block
    assert quantize.rrdb_num_stats(cfg) == \
        jquantize.rrdb_num_stats(jcfg) == 16
    want = rrdb.qbody_from_jax(_qbody_numpy(
        jquantize.quantize_rrdb(jp, jcfg, maxima, margin=1.25)))
    got = quantize.build_qbody(params, cfg, maxima, margin=1.25)
    for gb, wb in zip(got["body"], want["body"], strict=True):
        for g, w in zip(gb, wb, strict=True):
            for key in ("w8", "sw", "b"):
                for a, b in zip(g[key], w[key], strict=True):
                    assert a.dtype == b.dtype
                    assert torch.equal(a, b), key
    for key in ("w8", "sw", "b"):
        assert torch.equal(got["conv_body"][key], want["conv_body"][key])
    assert torch.equal(got["act_scale"], want["act_scale"])
    assert got["body"][0][0]["w8"][4].shape == (3, 3, CS, NF)
    assert int(got["body"][0][2]["w8"][2].abs().max()) == 127
    with pytest.raises(ValueError, match="act_maxima"):
        quantize.quantize_rrdb(params, cfg, maxima[:-1])


@pytest.mark.parametrize("percentile,cap", [(None, None), (99.9, None),
                                            (99.9, 1000)],
                         ids=["max", "p99.9", "p99.9-strided"])
def test_collect_act_maxima_rrdb_matches_jax(one_block, monkeypatch,
                                             percentile, cap):
    """The maxima in both statistics; "strided" lowers both packages'
    sample cap so that every percentile walks a strided subsample (a
    growth slice of 2 x 16 x 20 x 32 values: every 20th): the port takes
    it over the slice alone, made contiguous, as the reference holds
    it."""
    jcfg, jp, cfg, params, u8, _m = one_block
    if cap is not None:
        u8 = u8[:1]  # a shape of its own: a fresh trace reads the cap
        for mod in (quantize, jquantize):
            monkeypatch.setattr(mod, "_PCT_SAMPLE_CAP", cap)
    want = np.asarray(jquantize.collect_act_maxima_rrdb(
        jp, _x(u8), cfg=jcfg, percentile=percentile))
    got = quantize.collect_maxima(params, torch.from_numpy(u8), cfg=cfg,
                                  percentile=percentile)
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # the float32-prepared params (the engine's) give the same numbers
    again = quantize.collect_maxima(rrdb.prepare(params, torch.float32),
                                    torch.from_numpy(u8), cfg=cfg,
                                    percentile=percentile, plain=True)
    assert torch.equal(again, got)


# -- K7q's plain forms --------------------------------------------------------


def _dense_case(seed):
    """A dense block's int8 operands: the float32 input, a qrdb of random
    s8 weights with per-channel sw and b, the 5 scales [x, h1..h4] and
    the next one."""
    rs = np.random.RandomState(seed)
    x_f = (rs.standard_normal((2, 9, 13, NF)) * 0.6).astype(np.float32)
    b_in = (rs.standard_normal((2, 9, 13, NF)) * 0.6).astype(np.float32)
    q = {"w8": [], "sw": [], "b": []}
    for i in range(5):
        cin, cout = NF + GC * i, GC if i < 4 else NF
        q["w8"].append(rs.randint(-127, 128, (3, 3, cin, cout))
                       .astype(np.int8))
        q["sw"].append(rs.uniform(2e-6, 8e-6, cout).astype(np.float32))
        q["b"].append(rs.uniform(-0.05, 0.05, cout).astype(np.float32))
    scales = rs.uniform(0.01, 0.03, 6).astype(np.float32)
    return x_f, b_in, q, scales


@pytest.mark.parametrize("epi", ["rdb", "rrdb"])
def test_dense_block_plain_forms_match_jax_rdb_int8(epi):
    """One dense block from identical inputs: the reference's `_rdb_int8`
    (op by op, with its quantize recorded) and, for rrdb, `out * 0.2 +
    b_in`, then the quantize with the next scale, against K7q's lrelu_q,
    rdb and rrdb forms through the wrapper (the plain version on CPU
    tensors)."""
    x_f, b_in, q, scales = _dense_case(11 if epi == "rdb" else 12)
    codes = []

    def quant(v, s):
        codes.append(np.asarray(jsrvgg._quant_s8(v, s)))
        return jnp.asarray(codes[-1])

    jq = {k: [jnp.asarray(a) for a in v] for k, v in q.items()}
    out = jrrdb._rdb_int8(jnp.asarray(x_f), jq, jnp.asarray(scales[:5]),
                          lambda v8, w8, parts: jsrvgg._conv3x3_s8(v8, w8),
                          quant, NF, GC, 1)
    if epi == "rrdb":
        out = out * 0.2 + jnp.asarray(b_in)
    quant(out, jnp.asarray(scales[5]))
    out = np.asarray(out)

    t = {k: [torch.from_numpy(a) for a in v] for k, v in q.items()}
    inv = 1.0 / torch.from_numpy(scales)
    buf = torch.zeros((2, 9, 13, CS), dtype=torch.int8)
    other = torch.zeros_like(buf)
    rrdb._quant_into(buf[..., :NF], torch.from_numpy(x_f), inv[0])
    for i in range(4):
        k7.dense_conv_s8(buf, NF + GC * i, t["w8"][i], t["sw"][i],
                         t["b"][i], "lrelu_q", inv=inv[i + 1], out8=buf,
                         out8_off=NF + GC * i)
    res2 = torch.from_numpy(b_in)
    chain = res2.clone() if epi == "rrdb" else torch.zeros_like(res2)
    k7.dense_conv_s8(buf, CS, t["w8"][4], t["sw"][4], t["b"][4], epi,
                     inv=inv[5], out8=other, res=torch.from_numpy(x_f),
                     res2=chain if epi == "rrdb" else None, out=chain)
    for i in range(5):
        lo = 0 if i == 0 else NF + GC * (i - 1)
        hi = NF if i == 0 else lo + GC
        np.testing.assert_array_equal(buf[..., lo:hi].numpy(), codes[i])
    np.testing.assert_array_equal(other[..., :NF].numpy(), codes[5])
    np.testing.assert_array_equal(chain.numpy(), out)
    assert (buf > 0).any() and (buf < 0).any()  # both signs
    assert not other[..., NF:].any()  # only the first nf channels


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_conv_body_add_form_matches_jax(name):
    """conv_body: feat.astype(f32) + _dq(y32), cast to the compute dtype
    (rrdb.py:324-327), over feat in place."""
    dt, jdt = getattr(torch, name), getattr(jnp, name)
    _x_f, _b, q, scales = _dense_case(13)
    rs = np.random.RandomState(14)
    x8 = rs.randint(-127, 128, (2, 9, 13, CS)).astype(np.int8)
    w8 = rs.randint(-127, 128, (3, 3, NF, NF)).astype(np.int8)
    sw, b = q["sw"][4], q["b"][4]
    feat = rs.standard_normal((2, 9, 13, NF)).astype(np.float32)
    jfeat = jnp.asarray(feat).astype(jdt)
    y32 = jsrvgg._conv3x3_s8(jnp.asarray(x8[..., :NF]), jnp.asarray(w8))
    want = (jfeat.astype(jnp.float32) + jrrdb._dq(
        y32, jnp.asarray(sw), jnp.asarray(b), 1)).astype(jdt)
    tf = torch.from_numpy(feat.copy()).to(dt)  # written in place
    k7.dense_conv_s8(torch.from_numpy(x8), NF, torch.from_numpy(w8),
                     torch.from_numpy(sw), torch.from_numpy(b), "add",
                     res=tf, out=tf)
    np.testing.assert_array_equal(
        tf.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("cin,cout", [(64, 32), (96, 32), (160, 32),
                                      (192, 64)])
def test_pack_weights_dense_s8_layout(cin, cout):
    """K7q's resident B operand against its index formula: packed[c, t,
    kb, n, kk] = w8[t // 3, t % 3, 64 c + 16 kb + kk, n], zeros past
    Cin."""
    rs = np.random.RandomState(cin)
    w8 = torch.from_numpy(rs.randint(-127, 128, (3, 3, cin, cout))
                          .astype(np.int8))
    got = k7.pack_weights_dense_s8(w8)
    chunks = -(-cin // 64)
    assert got.shape == (chunks, 9, 4, cout, 16) and \
        got.dtype == torch.int8 and got.is_contiguous()
    for _ in range(300):
        c, t, kb = rs.randint(chunks), rs.randint(9), rs.randint(4)
        n, kk = rs.randint(cout), rs.randint(16)
        k = 64 * c + 16 * kb + kk
        want = w8[t // 3, t % 3, k, n] if k < cin else 0
        assert got[c, t, kb, n, kk] == want
    with pytest.raises(ValueError, match="int8 weights"):
        k7.pack_weights_dense_s8(w8.float())


def test_dense_conv_s8_refusals_before_any_launch():
    """The wrapper's checks, before any launch: a meta tensor is refused
    (the kernel takes CUDA tensors), and on small CPU tensors K7q writes
    into its own input only past the channels it reads, at a 16-B aligned
    channel offset, takes Cin in multiples of 32, and its forms need their
    scale and residuals."""
    meta = torch.empty((1, 4, 4, CS), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k7.dense_conv_s8(meta, 64, meta[0, 0, :3, :32], meta, meta,
                         "lrelu_q")
    buf, other = (torch.zeros((1, 4, 4, CS), dtype=torch.int8)
                  for _ in range(2))
    w = torch.zeros((3, 3, 64, 32), dtype=torch.int8)
    w5 = torch.zeros((3, 3, CS, NF), dtype=torch.int8)
    f32, g32 = (torch.zeros((1, 4, 4, NF)) for _ in range(2))
    inv = torch.ones(())
    # conv 1 and conv 5: fine
    k7._check_s8(buf, 64, w, "lrelu_q", inv, buf, 64, None, None, None)
    k7._check_s8(buf, CS, w5, "rrdb", inv, other, 0, f32, g32, g32)
    checks = [
        ((buf, 64, w, "lrelu_q", inv, buf, 32, None, None, None),
         "past the ones it reads"),
        ((buf, CS, w5, "rdb", inv, buf, 0, f32, None, g32),
         "past the ones it reads"),
        ((buf, 64, w, "lrelu_q", None, buf, 64, None, None, None),
         "needs inv"),
        # the s8 codes go out by TMA stores, 16-B aligned
        ((buf, 64, w, "lrelu_q", inv, other, 8, None, None, None),
         "offset that is a multiple of 16"),
        ((buf, CS, w5, "rrdb", inv, other, 0, f32, None, g32),
         "needs residuals"),
        ((buf, CS, w5, "rdb", inv, other, 0, f32.bfloat16(), None, g32),
         "needs residuals"),
        ((buf, 48, w[:, :, :48], "lrelu_q", inv, buf, 64, None, None,
          None), "multiple of 32"),
        ((buf, CS, w5, "gelu", inv, other, 0, f32, None, g32), "unknown"),
    ]
    for args, match in checks:
        with pytest.raises(ValueError, match=match):
            k7._check_s8(*args)


# -- the model --------------------------------------------------------------


@pytest.mark.parametrize("s2d", [False, True], ids=["classic", "s2d"])
def test_apply_int8_matches_jax(one_block, s2d):
    jcfg, jp, cfg, params, u8, maxima = one_block
    jqb = jquantize.quantize_rrdb(jp, jcfg, maxima, margin=1.25)
    qb = rrdb.qbody_from_jax(_qbody_numpy(jqb))
    for jdt, dt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jrrdb.apply_int8(
            jp, jqb, _x(u8), cfg=jcfg, compute_dtype=jdt, quantize_u8=True,
            s2d=s2d))
        got = rrdb.apply_int8(params, qb, torch.from_numpy(u8), cfg=cfg,
                              compute_dtype=dt).numpy()
        assert got.shape == want.shape == (2, 64, 80, 3) and \
            got.dtype == np.uint8
        if dt == torch.float32:
            assert _max_diff(got, want) <= 1
            assert (got == want).mean() >= 0.999
        else:
            assert _psnr(got, want) >= 50.0
    # plain=True and the prepared forms are the same function
    prepared = rrdb.prepare(params, torch.bfloat16)
    same = rrdb.apply_int8(prepared, rrdb.prepare_qbody(qb),
                           torch.from_numpy(u8), cfg=cfg, plain=True)
    assert np.array_equal(same.numpy(), got)
    with pytest.raises(ValueError, match="scales"):
        rrdb.apply_int8(params, dict(qb, act_scale=qb["act_scale"][:-1]),
                        torch.from_numpy(u8), cfg=cfg)


# -- the engine -----------------------------------------------------------------


@pytest.fixture
def small_calib_chunks(monkeypatch):
    """Both engines pad a calibration sample to a whole chunk of
    _CALIB_CHUNK_ELEMS activations (2e8: tens of thousands of these
    frames); both get the same budget of 2 frames of 16 x 20 at 64
    features, so their chunks, and hence their scales, correspond."""
    for cls in (UpscaleEngine, JaxEngine):
        monkeypatch.setattr(cls, "_CALIB_CHUNK_ELEMS", 2 * 16 * 20 * NF)


def test_engine_chunked_calibration_matches_jax(small_calib_chunks):
    """The chunked calibration (5 frames padded to 6, three chunks of 2,
    max-of-chunk p99.9) gives the JAX engine's maxima; the engine
    quantizes its float32 weights with them, its batches are
    apply_int8's with that quantization (apply_int8 is held against the
    JAX package's above; the certificate and the job's output in the CLI
    test), and its certificate does not depend on the chunking."""
    jcfg, jp = _jparams(1, seed=3, biased=True)
    mine = UpscaleEngine(device="cpu", compute_dtype="int8", batch_size=2,
                         preloaded=_port(jcfg, jp))
    ref = JaxEngine(compute_dtype="int8", batch_size=2,
                    preloaded=(jcfg, jp))
    assert mine.compute_dtype is torch.bfloat16
    frames = _frames((5, 16, 20, 3), seed=9)
    mine.calibrate_int8(frames)
    ref.calibrate_int8(frames)
    np.testing.assert_allclose(mine.get_calibration(), ref.get_calibration(),
                               rtol=1e-5)
    mine.set_calibration(ref.get_calibration())
    assert torch.equal(mine._qbody["body"][0][1]["w8"][3], quantize.
                       build_qbody(_port(jcfg, jp)[1], mine.cfg,
                                   ref.get_calibration(), margin=1.25)
                       ["body"][0][1]["w8"][3])
    got = mine.upscale_frames(frames)
    want = rrdb.apply_int8(mine.params, mine._qbody,
                           torch.from_numpy(frames), cfg=mine.cfg)
    assert got.shape == (5, 64, 80, 3)
    assert np.array_equal(got, want.numpy())
    db = mine.certify_int8(frames)
    assert mine.certify_int8(frames, chunk=1) == pytest.approx(db, abs=1e-9)
    assert mine.stats.calibrate_s > 0 and mine.stats.certify_s > 0


def test_engine_int8_tta_is_the_ensemble_of_apply_int8(small_calib_chunks):
    """--tta reaches the int8 trunk: the engine's ensemble is K6's mean of
    apply_int8 over the 8 transforms, and a tiled engine whose one window
    is the whole frame gives the whole-frame bytes."""
    from reve_tpu_torch.kernels import tta as tta_mod

    jcfg, jp = _jparams(1, seed=4, biased=True)
    preloaded = _port(jcfg, jp)
    frames = _frames((2, 12, 16, 3), seed=10)
    whole = UpscaleEngine(device="cpu", compute_dtype="int8", batch_size=2,
                          preloaded=preloaded)
    out = whole.upscale_frames(frames)
    maxima = whole.get_calibration()
    ens = UpscaleEngine(device="cpu", compute_dtype="int8", batch_size=2,
                        tta=True, preloaded=preloaded)
    ens.set_calibration(maxima)
    x = torch.from_numpy(frames)
    acc = torch.empty((2, 48, 64, 3), dtype=tta_mod.ACC_DTYPE)
    mean = torch.empty((2, 48, 64, 3), dtype=torch.uint8)
    for s, (k, flip) in enumerate(tta_mod.SPECS):
        form = tta_mod.FIRST if s == 0 else tta_mod.LAST \
            if s == len(tta_mod.SPECS) - 1 else tta_mod.MIDDLE
        y = rrdb.apply_int8(whole.params, whole._qbody,
                            tta_mod.forward_transform(x, k, flip),
                            cfg=whole.cfg)
        tta_mod.tta_accumulate(y, acc, k, flip, form, out=mean)
    assert np.array_equal(ens.upscale_frames(frames), mean.numpy())
    tiled = UpscaleEngine(device="cpu", compute_dtype="int8", batch_size=2,
                          tile=64, preloaded=preloaded)
    tiled.set_calibration(maxima)
    assert np.array_equal(tiled.upscale_frames(frames), out)


def test_int8_memory_plan_bills_the_s8_trunk():
    """An int8 RRDB frame: the trunk (feat in bf16, two s8 dense buffers,
    three float32 chain buffers and the first quantize's temporary)
    stays below the bf16 head at 4x, which sets the bill as in bf16."""
    jcfg, jp = _jparams(1)
    eng = UpscaleEngine(device="cpu", compute_dtype="int8", batch_size=1,
                        preloaded=_port(jcfg, jp))
    h, w = 1080, 1920
    assert eng._rrdb_bytes(h, w) == h * w * 16 * 2 * NF * 2
    trunk = NF * 2 + 2 * CS + 3 * NF * 4 + NF * 4
    assert trunk == 1536 < 16 * 2 * NF * 2
    assert eng._frame_bytes(h, w) == h * w * (16 * 2 * NF * 2 + 3 + 48)
    # the certification's float32 pass is billed in float32
    assert eng._rrdb_bytes(h, w, torch.float32) == \
        h * w * 16 * (2 * NF * 4 + NF * 6)


# -- the CLI -------------------------------------------------------------------


JOB = ["-s", "4", "--model", "realesrgan-x4plus", "--io-backend", "y4m",
       "-S", "2", "--batch", "2", "--dtype", "int8", "--yes"]


@pytest.fixture
def rrdb_pth(tmp_path):
    _, jp = _jparams(1, seed=5, biased=True)
    path = str(tmp_path / "rrdb1.pth")
    _save_upstream_pth(path, jp)
    return path


@pytest.mark.usefixtures("jax_native_core")
def test_cli_rrdb_int8_job_matches_jax_cli(tmp_path, monkeypatch, capsys,
                                           rrdb_pth, small_calib_chunks):
    """The hermetic y4m job with --dtype int8 through both CLIs (3 frames
    of 16 x 20, a 1-block upstream-keyed .pth): the port's own
    calibration on the job's sampled frames matches the JAX job's
    persisted one (rtol 1e-5); quantizing with the JAX job's, as a resume
    of one job would, the port certifies within 0.05 dB of it and writes
    the same samples."""
    monkeypatch.chdir(tmp_path)
    inp = _y4m(tmp_path)
    job = JOB + ["--weights", rrdb_pth, "--keep-workspace"]
    want, own, got = (str(tmp_path / f"{n}.y4m")
                      for n in ("jax", "own", "torch"))
    assert jcli.run(["-i", inp, want] + job) == 0
    jws = want + ".revework"
    with open(os.path.join(jws, "int8_calibration.json")) as f:
        maxima = json.load(f)["act_maxima"]
    with open(os.path.join(jws, "int8_cert.json")) as f:
        cert = json.load(f)["db"]
    assert len(maxima) == 16
    assert cli.run(["-i", inp, own] + job, device="cpu") == 0
    np.testing.assert_allclose(
        Workspace(own + ".revework").load_calibration(), maxima, rtol=1e-5)
    monkeypatch.setattr(Workspace, "load_calibration", lambda self: maxima)
    capsys.readouterr()
    assert cli.run(["-i", inp, got] + job, device="cpu") == 0
    err = capsys.readouterr().err
    assert "int8 turbo:" in err and "path: int8 turbo (" in err
    assert abs(Workspace(got + ".revework").load_int8_cert() - cert) <= 0.05
    rd = reader.Y4MReader(got)
    assert (rd.width, rd.height, rd.frame_count()) == (80, 64, 3)
    gh, got_frames = _y4m_samples(got)
    wh, want_frames = _y4m_samples(want)
    assert gh == wh and len(got_frames) == len(want_frames) == 3
    for g, w in zip(got_frames, want_frames):
        d = np.abs(g - w)
        assert d.max() <= 4 and (d > 0).mean() <= 0.02


def test_cli_rrdb_int8_resume_and_gate(tmp_path, monkeypatch, capsys,
                                       rrdb_pth, small_calib_chunks):
    """A crashed RRDB int8 job (segment 1 of 2 not committed) resumes with
    its persisted calibration and certificate, byte-identical to the
    uninterrupted run, and so is the same job through
    upscale_video(dtype="int8"); --int8-gate above the certificate exits
    3 and leaves no workspace; realesrgan-x2plus with a 1-block x2 .pth
    runs the same int8 job at x2 (until RRDB x2 was ported it exited
    2)."""
    monkeypatch.chdir(tmp_path)
    inp = _y4m(tmp_path)
    job = JOB + ["--weights", rrdb_pth]
    full = str(tmp_path / "full.y4m")
    assert cli.run(["-i", inp, full] + job, device="cpu") == 0
    api_out = str(tmp_path / "api.y4m")
    report = upscale_video(inp, api_out, 4, model="realesrgan-x4plus",
                           weights=rrdb_pth, segment_size=2, batch=2,
                           dtype="int8", io_backend="y4m", device="cpu")
    assert report["dtype"] == "int8"
    with open(api_out, "rb") as a, open(full, "rb") as b:
        assert a.read() == b.read()
    out = str(tmp_path / "out.y4m")
    assert cli.run(["-i", inp, out, "--keep-workspace"] + job,
                   device="cpu") == 0
    os.unlink(out)
    ws = Workspace(out + ".revework")
    saved, cert = ws.load_calibration(), ws.load_int8_cert()
    state = ws.load()
    assert len(saved) == 16 and state.opts["dtype"] == "int8"
    os.unlink(ws.part_path(1, ".y4m"))
    state.pending = [s for s in state.plan if s.index == 1]
    ws.save(state)
    capsys.readouterr()
    # the resumed job runs its saved path whatever the command line says
    assert cli.run(["-i", inp, out, "--keep-workspace"]
                   + [a if a != "int8" else "bfloat16" for a in job],
                   device="cpu") == 0
    err = capsys.readouterr().err
    assert "resuming: 1 segment(s) remaining" in err
    assert f"int8 turbo ({cert:.1f} dB certified)" in err
    assert ws.load_calibration() == saved
    with open(out, "rb") as a, open(full, "rb") as b:
        assert a.read() == b.read()
    gated = str(tmp_path / "gated.y4m")
    assert cli.run(["-i", inp, gated, "--int8-gate", "99"] + job,
                   device="cpu") == 3
    assert "refusing" in capsys.readouterr().err
    assert not os.path.exists(gated + ".revework")
    _, jp2 = _jparams(1, seed=5, biased=True, upscale=2)
    pth2 = str(tmp_path / "rrdb1_x2.pth")
    _save_upstream_pth(pth2, jp2)
    x2 = [{"realesrgan-x4plus": "realesrgan-x2plus", "4": "2",
           rrdb_pth: pth2}.get(a, a) for a in job]
    out2 = str(tmp_path / "x2.y4m")
    assert cli.run(["-i", inp, out2] + x2, device="cpu") == 0
    assert "path: int8 turbo (" in capsys.readouterr().err
    rd = reader.Y4MReader(out2)
    assert (rd.width, rd.height, rd.frame_count()) == (40, 32, 3)


def test_auto_dtype_still_resolves_rrdb_to_bf16():
    """--dtype auto keeps RRDB on bfloat16 (tests/test_torch_rrdb.py holds
    the note against the reference's); the engine built for it is not
    int8."""
    jcfg, jp = _jparams(1)
    eng = UpscaleEngine(device="cpu", compute_dtype="auto",
                        preloaded=_port(jcfg, jp))
    assert eng.compute_dtype is torch.bfloat16 and not eng._int8
    assert dataclasses.asdict(eng.cfg)["num_block"] == 1
