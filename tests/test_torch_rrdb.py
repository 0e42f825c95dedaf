"""RRDBNet in the port (reve_tpu_torch.models.rrdb, K7's and the conv_last
mode's plain versions, the registry, the engine, the CLI, the auto dtype
rule) against the JAX package's on the same numbers, on the CPU.

Weights come from reve_tpu's own init_params (its scales: 0.1 in the
dense blocks, zero biases), carried across with params_from_jax; the
"biased" cases add seeded biases to every conv (conv_last's near 0.45),
so that the u8 output spans the range instead of clipping to 0 (the
random-init net's output is near zero).  Inputs are seeded numpy arrays
handed to both packages.

Tolerances:
  * float32 u8 |d| <= 1 (model, engine whole / tiled / TTA, CLI file):
    the two packages' convs sum in other orders, which can move y * 255 +
    0.5 across an integer (on these inputs they agree exactly);
  * bfloat16 model: the port's bf16-vs-float32 PSNR is at most 1 dB below
    the JAX package's own bf16-vs-float32 PSNR on the same input, both
    against the JAX float32 output (measured: +0.02 dB at 2 blocks);
  * K7's epilogues and conv_last against the JAX sub-expressions: float32
    max |d| <= 2e-6 (summation order), bfloat16 <= 2 bf16 ulp (measured
    exact but for one value near zero);
  * the leaky ReLU that K1 computes as PReLU at alpha bf16(0.2): equal to
    reve_tpu's where(x >= 0, x, 0.2 * x) for every finite bf16 value.
"""

import dataclasses
import fractions
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reve_tpu import cli as jcli
from reve_tpu.models import rrdb as jrrdb
from reve_tpu.pipeline import scheduler as jscheduler
from reve_tpu.pipeline.engine import UpscaleEngine as JaxEngine
from reve_tpu.pipeline.state import JobState as JaxJobState
from reve_tpu.pipeline.state import Workspace as JaxWorkspace
from reve_tpu_torch import cli
from reve_tpu_torch.io import reader, writer
from reve_tpu_torch.kernels import conv3x3, head
from reve_tpu_torch.kernels import rrdb as k7
from reve_tpu_torch.models import registry, rrdb
from reve_tpu_torch.pipeline import scheduler
from reve_tpu_torch.pipeline.engine import Plan, UpscaleEngine
from reve_tpu_torch.pipeline.planner import plan_segments
from reve_tpu_torch.pipeline.state import JobState, Workspace
from test_torch_cli import jax_native_core  # noqa: F401

torch.set_num_threads(2)

#: the port's bf16-vs-float32 PSNR may sit this far below the JAX
#: package's own on the same input (dB)
BF16_PSNR_MARGIN_DB = 1.0


def _jparams(num_block, seed=0, biased=False, upscale=4):
    """(jax cfg, jax params) at nf 64, gc 32, x4 (or `upscale`: x2 reads
    12 channels): reve_tpu's init, with seeded biases on every conv when
    `biased`."""
    cfg = jrrdb.RRDBConfig(num_block=num_block, upscale=upscale)
    params = jrrdb.init_params(jax.random.key(seed), cfg)
    if biased:
        rs = np.random.RandomState(seed + 100)
        leaves, tree = jax.tree_util.tree_flatten_with_path(params)
        new = []
        for path, leaf in leaves:
            name = jax.tree_util.keystr(path)
            if name.endswith("['b']"):
                v = rs.uniform(-0.05, 0.05, leaf.shape).astype(np.float32)
                leaf = jnp.asarray(v + (0.45 if "conv_last" in name else 0))
            new.append(leaf)
        params = jax.tree_util.tree_unflatten(tree, new)
    return cfg, params


def _port(jcfg, jparams):
    cfg = rrdb.RRDBConfig(**dataclasses.asdict(jcfg))
    return cfg, rrdb.params_from_jax(jparams)


def _frames(shape, seed=1):
    return np.random.RandomState(seed).randint(0, 256, shape, np.uint8)


def _jax_u8(jparams, jcfg, u8, dtype, s2d):
    """The JAX engine's RRDB call: apply(u8 / 255), clip(y * 255 + 0.5)
    truncated (reve_tpu/pipeline/engine.py:426-429)."""
    x = jnp.asarray(u8.astype(np.float32) * (1.0 / 255.0))
    y = jrrdb.apply(jparams, x, cfg=jcfg, compute_dtype=dtype, s2d=s2d)
    return np.asarray(jnp.clip(y * 255.0 + 0.5, 0.0, 255.0)
                      .astype(jnp.uint8))


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def _max_diff(a, b):
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


# -- the model ---------------------------------------------------------------


@pytest.mark.parametrize("biased", [False, True], ids=["init", "biased"])
def test_apply_matches_jax_float32_both_domains(biased):
    jcfg, jp = _jparams(2, biased=biased)
    cfg, params = _port(jcfg, jp)
    u8 = _frames((2, 16, 20, 3))
    got = rrdb.apply(params, torch.from_numpy(u8), cfg=cfg,
                     compute_dtype=torch.float32).numpy()
    assert got.shape == (2, 64, 80, 3) and got.dtype == np.uint8
    for s2d in (False, True):
        assert _max_diff(got, _jax_u8(jp, jcfg, u8, jnp.float32, s2d)) <= 1


def test_apply_bf16_within_the_jax_packages_own_bf16_error():
    jcfg, jp = _jparams(2, biased=True)
    cfg, params = _port(jcfg, jp)
    u8 = _frames((2, 16, 20, 3))
    got = rrdb.apply(params, torch.from_numpy(u8), cfg=cfg,
                     compute_dtype=torch.bfloat16).numpy()
    for s2d in (False, True):
        ref = _jax_u8(jp, jcfg, u8, jnp.float32, s2d)
        jax_db = _psnr(_jax_u8(jp, jcfg, u8, jnp.bfloat16, s2d), ref)
        assert _psnr(got, ref) >= jax_db - BF16_PSNR_MARGIN_DB


def test_apply_at_full_depth_matches_jax():
    """23 blocks (realesrgan-x4plus's depth) on one 8 x 8 frame."""
    jcfg, jp = _jparams(23, biased=True)
    cfg, params = _port(jcfg, jp)
    u8 = _frames((1, 8, 8, 3), seed=2)
    got = rrdb.apply(params, torch.from_numpy(u8), cfg=cfg,
                     compute_dtype=torch.float32).numpy()
    assert _max_diff(got, _jax_u8(jp, jcfg, u8, jnp.float32, False)) <= 1


def test_apply_bf16_at_full_depth_with_the_registrys_random_weights():
    """realesrgan-x4plus as the registry builds it without weights (seed
    0, reve_tpu's init scales: what chip_smoke.py's rrdb job runs):
    bf16 through 23 blocks is itself far from float32 (the JAX package's
    own bf16-vs-float32 PSNR is below the 50-dB gate here), and the port's
    bf16 sits within the same margin of it as at 2 blocks."""
    cfg, params = registry.load_model("realesrgan-x4plus", 4,
                                      allow_random_init=True)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     params)
    jcfg = jrrdb.RRDBConfig()
    u8 = _frames((1, 16, 24, 3), seed=6)
    ref = _jax_u8(jparams, jcfg, u8, jnp.float32, False)
    jax_db = _psnr(_jax_u8(jparams, jcfg, u8, jnp.bfloat16, False), ref)
    got = rrdb.apply(params, torch.from_numpy(u8), cfg=cfg,
                     compute_dtype=torch.bfloat16).numpy()
    assert jax_db < 50.0
    assert _psnr(got, ref) >= jax_db - BF16_PSNR_MARGIN_DB


def test_apply_kernel_path_equals_plain_on_cpu_and_prepare_is_free():
    """On CPU tensors every wrapper runs its plain version: the kernel
    path, the plain path and the prepared params give the same bytes."""
    jcfg, jp = _jparams(1, biased=True)
    cfg, params = _port(jcfg, jp)
    u8 = torch.from_numpy(_frames((1, 12, 10, 3)))
    for dt in (torch.float32, torch.bfloat16):
        a = rrdb.apply(params, u8, cfg=cfg, compute_dtype=dt)
        b = rrdb.apply(params, u8, cfg=cfg, compute_dtype=dt, plain=True)
        prepared = rrdb.prepare(params, dt)
        c = rrdb.apply(prepared, u8, cfg=cfg, compute_dtype=dt)
        assert torch.equal(a, b) and torch.equal(a, c)
        assert "packed" not in prepared["conv_body"]  # packs on CUDA only
        assert prepared["conv_hr"]["w"].dtype == dt
    with pytest.raises(NotImplementedError, match="RRDB x1"):
        rrdb.apply(params, u8, cfg=dataclasses.replace(cfg, upscale=1))


# -- K7's epilogues, conv_last, the leaky ReLU --------------------------------


def _close(got, want, dt):
    got, want = got.float(), want.float()
    if dt == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
        return
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -10)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert bool(((got - want).abs() <= 2 * ulp).all())


@pytest.mark.parametrize("cin,cout,epi", [
    (64, 32, "lrelu"), (96, 32, "lrelu"), (128, 32, "lrelu"),
    (160, 32, "lrelu"), (192, 64, "rdb"), (192, 64, "rrdb"),
    (64, 64, "add")])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_dense_conv_plain_matches_jax_subexpression(name, cin, cout, epi):
    """Each K7 form's plain version against the JAX expression it
    replaces: _lrelu(_raw_conv) (rrdb.py:160-163), feats[-1] * 0.2 + x
    (:165), then out * 0.2 + x (:172), feat + conv (:229)."""
    dt, jdt = getattr(torch, name), getattr(jnp, name)
    rs = np.random.RandomState(cin + cout)
    buf = rs.uniform(-1, 1, (2, 9, 13, 192)).astype(np.float32)
    r2 = rs.uniform(-1, 1, (2, 9, 13, 64)).astype(np.float32)
    w = (rs.uniform(-1, 1, (3, 3, cin, cout)) * 0.3 / np.sqrt(9 * cin)) \
        .astype(np.float32)
    b = rs.uniform(-0.1, 0.1, (cout,)).astype(np.float32)
    jb, jr2 = jnp.asarray(buf).astype(jdt), jnp.asarray(r2).astype(jdt)
    h = jrrdb._raw_conv(jb[..., :cin], jnp.asarray(w).astype(jdt),
                        jnp.asarray(b), jdt)
    x, k = jb[..., :cout], jnp.asarray(0.2, jdt)
    want = {"lrelu": lambda: jrrdb._lrelu(h), "add": lambda: x + h,
            "rdb": lambda: h * k + x,
            "rrdb": lambda: (h * k + x) * k + jr2}[epi]()
    tb = torch.from_numpy(buf).to(dt)
    out = tb.clone() if epi == "lrelu" else torch.zeros(
        (2, 9, 13, 64), dtype=dt)
    off = cin if epi == "lrelu" else 0
    k7.dense_conv_plain(tb, cin, torch.from_numpy(w).to(dt),
                        torch.from_numpy(b), out, off, epi, res=tb,
                        res2=torch.from_numpy(r2).to(dt))
    _close(out[..., off:off + cout],
           torch.from_numpy(np.array(want.astype(jnp.float32))), dt)
    if epi == "lrelu":  # the channels the conv read are untouched
        assert torch.equal(out[..., :cin], tb[..., :cin])


@pytest.mark.parametrize("cin,cout,epi", [
    (96, 32, "lrelu"), (192, 64, "rdb"), (192, 64, "rrdb"), (64, 64, "add")])
def test_dense_conv_plain_writes_the_split_of_what_it_writes(cin, cout,
                                                             epi):
    """float32: `out_planes` receives split_bf16x3_plain of the channels
    the conv writes, bit for bit, and nothing else of it changes; the
    output is the same as without planes."""
    rs = np.random.RandomState(cin + 7)
    buf = torch.from_numpy(rs.uniform(-1, 1, (2, 7, 9, 192))
                           .astype(np.float32))
    w = torch.from_numpy((rs.uniform(-1, 1, (3, 3, cin, cout)) * 0.3
                          / np.sqrt(9 * cin)).astype(np.float32))
    b = torch.from_numpy(rs.uniform(-0.1, 0.1, (cout,)).astype(np.float32))
    r2 = torch.from_numpy(rs.uniform(-1, 1, (2, 7, 9, 64))
                          .astype(np.float32))
    off = cin if epi == "lrelu" else 0
    outs = []
    for with_planes in (False, True):
        out = buf.clone() if epi == "lrelu" else r2.clone()
        planes = torch.full((3, *out.shape), 7.0, dtype=torch.bfloat16) \
            if with_planes else None
        k7.dense_conv(out if epi == "lrelu" else buf, cin, w, b, out, off,
                      epi, res=buf if epi != "add" else r2, res2=r2,
                      out_planes=planes)
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    written = outs[1][..., off:off + cout]
    assert torch.equal(planes[..., off:off + cout],
                       conv3x3.split_bf16x3_plain(written))
    assert bool((planes[..., :off] == 7).all())
    assert bool((planes[..., off + cout:] == 7).all())
    # hi + mid + lo is the float32 value
    assert torch.equal(planes[..., off:off + cout].float().sum(0), written)


def test_float32_trunk_on_planes_matches_jax_trunk():
    """dense_trunk in float32 on the kernel path (CPU tensors: the plain
    versions, with every dense buffer's split planes written by the convs
    that write it) against the JAX package's trunk (_rrdb per block,
    rrdb.py:168-172) on the same feat: max |d| <= 2e-6 (float32 sums in
    another order through 30 convs; measured 2.4e-7); equal to the plain
    path's, and the
    returned planes are the split of the returned buffer, every channel."""
    jcfg, jp = _jparams(2, biased=True)
    cfg, params = _port(jcfg, jp)
    feat = np.random.RandomState(7).uniform(-1, 1, (2, 11, 13, 64)) \
        .astype(np.float32)
    body = jnp.asarray(feat)
    for block in jp["body"]:
        body = jrrdb._rrdb(body, block, jnp.float32,
                           lambda v, p, dt, parts: jrrdb._conv(v, p, dt),
                           cfg.num_feat, cfg.num_grow_ch)
    a, planes = rrdb.dense_trunk(params, torch.from_numpy(feat), cfg=cfg,
                                 compute_dtype=torch.float32)
    torch.testing.assert_close(a[..., :64], torch.from_numpy(np.array(body)),
                               atol=2e-6, rtol=0)
    assert planes.shape == (3, 2, 11, 13, 192)
    assert torch.equal(planes, conv3x3.split_bf16x3_plain(a))
    a_plain, none = rrdb.dense_trunk(params, torch.from_numpy(feat),
                                     cfg=cfg, compute_dtype=torch.float32,
                                     plain=True)
    assert none is None and torch.equal(a, a_plain)
    # bfloat16 keeps no planes
    assert rrdb.dense_trunk(params, torch.from_numpy(feat).bfloat16(),
                            cfg=cfg, compute_dtype=torch.bfloat16)[1] is None


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_conv_last_plain_matches_jax(name):
    dt, jdt = getattr(torch, name), getattr(jnp, name)
    rs = np.random.RandomState(5)
    h = rs.uniform(-1, 1, (2, 11, 17, 64)).astype(np.float32)
    w = (rs.uniform(-1, 1, (3, 3, 64, 3)) / 24).astype(np.float32)
    b = rs.uniform(0.3, 0.6, (3,)).astype(np.float32)
    y = jrrdb._raw_conv(jnp.asarray(h).astype(jdt),
                        jnp.asarray(w).astype(jdt), jnp.asarray(b), jdt)
    want = np.asarray(jnp.clip(y.astype(jnp.float32) * 255.0 + 0.5, 0.0,
                               255.0).astype(jnp.uint8))
    got = head.conv_last_u8(torch.from_numpy(h).to(dt),
                            torch.from_numpy(w).to(dt), torch.from_numpy(b))
    assert got.dtype == torch.uint8 and got.shape == (2, 11, 17, 3)
    assert _max_diff(got.numpy(), want) <= 1


def test_k1_prelu_at_bf16_slope_is_the_jax_leaky_relu():
    """Every finite bf16 value whose leaky ReLU is a normal number (or
    zero): K1's plain PReLU with alpha = 0.2 (cast to bf16, max(x, 0) +
    alpha * min(x, 0)) equals reve_tpu's _lrelu, where(x >= 0, x, 0.2 *
    x), in bf16; and in float32 on random values.  (XLA's CPU backend
    flushes subnormal results to zero, which the torch side does not: the
    values below 2^-123, whose 0.2 x is subnormal, are left out.)"""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    vals = bits.view(np.float32)
    vals = vals[np.isfinite(vals) & ((vals == 0)
                                     | (np.abs(vals) >= 2.0 ** -123))]
    x = torch.from_numpy(vals).to(torch.bfloat16)
    alpha = torch.full((1,), k7.SLOPE)
    got = conv3x3.prelu_plain(x, alpha).float().numpy()
    want = np.asarray(jrrdb._lrelu(jnp.asarray(vals).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    np.testing.assert_array_equal(got, want)
    xf = np.random.RandomState(0).standard_normal(10000).astype(np.float32)
    np.testing.assert_array_equal(
        conv3x3.prelu_plain(torch.from_numpy(xf), alpha).numpy(),
        np.asarray(jrrdb._lrelu(jnp.asarray(xf))))


@pytest.mark.parametrize("cin,cout", [(64, 32), (160, 32), (192, 64)])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_pack_weights_dense_layout(name, cin, cout):
    """K7's B operand against its index formula: packed[c, t, s, kb, n,
    kk] = planes[s][t // 3, t % 3, 16 c + 8 kb + kk, n] (16-channel
    chunks)."""
    dt = getattr(torch, name)
    w = torch.from_numpy(np.random.RandomState(cin).standard_normal(
        (3, 3, cin, cout)).astype(np.float32)).to(dt)
    planes = w[None] if dt == torch.bfloat16 else \
        conv3x3.split_bf16x3_plain(w)
    got = k7.pack_weights_dense(w)
    s_n = planes.shape[0]
    assert got.shape == (cin // 16, 9, s_n, 2, cout, 8)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    rs = np.random.RandomState(1)
    for _ in range(200):
        c, t, s, kb = (rs.randint(cin // 16), rs.randint(9),
                       rs.randint(s_n), rs.randint(2))
        n, kk = rs.randint(cout), rs.randint(8)
        assert got[c, t, s, kb, n, kk] == \
            planes[s, t // 3, t % 3, 16 * c + 8 * kb + kk, n]
    with pytest.raises(ValueError, match="chunks of 32"):
        k7.pack_weights_dense(w[:, :, :48])


def test_dense_conv_refusals_before_any_launch():
    """The wrapper's checks on meta tensors (no data, no launch): K7 writes
    into its own input only past the channels it reads, takes Cin in
    chunks of 32 and Cout 32 or 64, and its residual forms need their
    residuals."""
    buf = torch.empty((1, 4, 4, 192), dtype=torch.bfloat16, device="meta")
    w = torch.empty((3, 3, 64, 32), dtype=torch.bfloat16, device="meta")
    w5 = torch.empty((3, 3, 192, 64), dtype=torch.bfloat16, device="meta")
    b = torch.empty((64,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k7.dense_conv(buf, 64, w, b, buf, 64, "lrelu")
    k7._check(buf, 64, w, buf, 64, "lrelu", None, None)  # conv 1: fine
    checks = [
        (buf, 64, w, buf, 32, "lrelu", None, "past the ones it reads"),
        (buf, 192, w5, buf, 0, "rdb", buf, "past the ones it reads"),
        (buf, 48, w[:, :, :48], buf, 64, "lrelu", None, "chunks of 32"),
        (buf, 192, w5, buf[..., :64].contiguous(), 0, "rrdb", buf,
         "needs residuals"),
        (buf, 64, w, buf, 100, "lrelu", None, "multiple of 8"),
    ]
    for src, cin, ww, out, off, epi, res, match in checks:
        with pytest.raises(ValueError, match=match):
            k7._check(src, cin, ww, out, off, epi, res, None)


# -- weights and the registry ---------------------------------------------------


def _save_upstream_pth(path, jparams):
    """An upstream-keyed RRDBNet state dict (OIHW) under params_ema."""
    sd = {}

    def put(name, p):
        sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(np.asarray(p["w"]),
                                              (3, 2, 0, 1))))
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(p["b"]).copy())

    put("conv_first", jparams["conv_first"])
    for i, block in enumerate(jparams["body"]):
        for j, rdb_p in enumerate(block["rdbs"]):
            for k, conv in enumerate(rdb_p["convs"]):
                put(f"body.{i}.rdb{j + 1}.conv{k + 1}", conv)
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr",
                 "conv_last"):
        put(name, jparams[name])
    torch.save({"params_ema": sd}, path)


def test_load_pth_matches_jax_load_pth(tmp_path):
    _, jp = _jparams(2, seed=3, biased=True)
    path = str(tmp_path / "rrdb.pth")
    _save_upstream_pth(path, jp)
    cfg, params = rrdb.load_pth(path)
    jcfg, jparams = jrrdb.load_pth(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.num_block, cfg.num_feat, cfg.num_grow_ch, cfg.upscale) == \
        (2, 64, 32, 4)
    want = rrdb.params_from_jax(jparams)
    got_leaves = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), params))
    want_leaves = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), want))
    # w and b of conv_first, 2 blocks x 15 dense convs, conv_body and
    # the 4 head convs
    assert len(got_leaves) == len(want_leaves) == 2 * (1 + 2 * 15 + 1 + 4)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, w)


def test_registry_names_and_refusals(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # no models/ here
    for name, blocks in (("realesrgan-x4plus", 23),
                         ("realesrgan-x4plus-anime", 6),
                         ("realesrnet-x4plus", 23)):
        cfg, params = registry.load_model(name, 4, allow_random_init=True)
        assert isinstance(cfg, rrdb.RRDBConfig)
        assert (cfg.num_block, cfg.upscale, cfg.num_feat) == (blocks, 4, 64)
        assert len(params["body"]) == blocks
        rrdb.check_cfg(cfg)
    # x4 and x2 are ported (in every dtype: the int8 path runs the same
    # configs), x1 (no registered name) stays refused where a config
    # reaches the model, the engine or the CLI
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*RRDB x1"):
        rrdb.check_cfg(dataclasses.replace(cfg, upscale=1))
    cfg, params = registry.load_model("realesrgan-x2plus", 2,
                                      allow_random_init=True)
    assert (cfg.upscale, cfg.num_block) == (2, 23)
    assert tuple(params["conv_first"]["w"].shape) == (3, 3, 12, 64)
    monkeypatch.delenv("REVE_TPU_ALLOW_RANDOM_INIT", raising=False)
    with pytest.raises(registry.MissingWeightsError,
                       match="RealESRGAN_x4plus"):
        registry.load_model("realesrgan-x4plus", 4)
    # ncnn files hold SRVGG graphs: an explicit one for an RRDB refuses
    with pytest.raises(ValueError, match="ncnn"):
        registry.load_model("realesrgan-x4plus", 4, weights="m.param")


def test_init_params_scales_and_seed():
    cfg = rrdb.RRDBConfig(num_block=1)
    a = rrdb.init_params(cfg, torch.Generator().manual_seed(7))
    b = rrdb.init_params(cfg, torch.Generator().manual_seed(7))
    torch.testing.assert_close(a["body"][0]["rdbs"][2]["convs"][4]["w"],
                               b["body"][0]["rdbs"][2]["convs"][4]["w"])
    conv5 = a["body"][0]["rdbs"][0]["convs"][4]["w"]
    assert tuple(conv5.shape) == (3, 3, 192, 64)
    assert float(conv5.abs().max()) <= 0.1 / np.sqrt(9 * 192)
    assert float(a["conv_up1"]["w"].abs().max()) <= 1 / np.sqrt(9 * 64)
    assert float(a["conv_up1"]["w"].abs().max()) > 0.1 / np.sqrt(9 * 64)
    assert all(float(c["b"].abs().max()) == 0 for c in
               a["body"][0]["rdbs"][1]["convs"])


# -- the engine --------------------------------------------------------------


def _engines(tile=0, tta=False, dtype="float32", batch_size=2):
    jcfg, jp = _jparams(1, biased=True)
    mine = UpscaleEngine(device="cpu", compute_dtype=dtype, tile=tile,
                         tta=tta, batch_size=batch_size,
                         preloaded=_port(jcfg, jp))
    ref = JaxEngine(compute_dtype=dtype, tile=tile, tta=tta,
                    batch_size=batch_size, preloaded=(jcfg, jp))
    return mine, ref


@pytest.mark.parametrize("mode", ["whole", "tiled", "tta"])
def test_engine_matches_jax_engine(mode):
    """Whole frames, halo tiles (tile 16 at RRDB's halo 24 on 32 x 80
    frames: ten 32 x 64 windows a frame; not byte-identical to whole
    frames, so held against the JAX package's tiles) and the TTA
    ensemble."""
    mine, ref = _engines(tile=16 if mode == "tiled" else 0,
                         tta=mode == "tta")
    assert mine.halo == ref.halo == 24
    shape = (3, 32, 80, 3) if mode == "tiled" else (3, 12, 16, 3)
    frames = _frames(shape, seed=4)
    got = mine.upscale_frames(frames)
    want = ref.upscale_frames(frames)
    assert got.shape == want.shape == (3, shape[1] * 4, shape[2] * 4, 3)
    assert _max_diff(got, want) <= 1
    if mode == "tiled":
        assert mine._plan_execution(32, 80) == Plan(16, 2 * 10)


def test_engine_refuses_rrdb_int8_and_x2():
    """RRDB int8 is ported: the engine builds it (bfloat16 float parts,
    the float32 weights kept for its measurement passes); RRDB x2 is
    ported too, in int8 as well (tests/test_torch_rrdb_x2.py); x1 stays
    refused, in int8 too."""
    jcfg, jp = _jparams(1)
    eng = UpscaleEngine(device="cpu", compute_dtype="int8",
                        preloaded=_port(jcfg, jp))
    assert eng._int8 and eng.compute_dtype is torch.bfloat16
    assert eng._params_f32["conv_body"]["w"].dtype == torch.float32
    cfg, params = _port(jcfg, jp)
    for dtype in ("bfloat16", "int8"):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md.*RRDB x1"):
            UpscaleEngine(device="cpu", compute_dtype=dtype, preloaded=(
                dataclasses.replace(cfg, upscale=1), params))


def _gpu_plan(engine, monkeypatch, free_bytes):
    monkeypatch.setattr(engine, "device", torch.device("cuda", 0))
    monkeypatch.setattr(engine, "_free_bytes", lambda: free_bytes)
    engine._plans.clear()


def test_frame_bytes_and_plan_on_an_80_gb_card(monkeypatch):
    """RRDB bills its own allocations: the 4x head's conv input and
    output (+ float32's split planes) peak, past the trunk's three dense
    buffers.  Under the free memory of an 80 GB card (79 GiB, stubbed) a
    batch of 4 1080p frames runs in one call in bfloat16 and in two calls
    of 2 frames in float32."""
    mine, _ = _engines(batch_size=4)
    h, w = 1080, 1920
    io = h * w * (3 + 48)
    assert mine._frame_bytes(h, w) == h * w * 16 * (2 * 64 * 4 + 64 * 6) \
        + io
    bf = UpscaleEngine(device="cpu", compute_dtype="bfloat16",
                       batch_size=4, preloaded=(mine.cfg, rrdb.init_params(
                           mine.cfg)))
    assert bf._frame_bytes(h, w) == h * w * 16 * 2 * 64 * 2 + io
    # the trunk (3 x 192 + 64 channels) stays below the head
    assert bf._rrdb_bytes(h, w) > h * w * (3 * 192 + 64) * 2
    assert bf._rrdb_trunk_bytes(torch.bfloat16) == (3 * 192 + 64) * 2
    free = 79 * 2 ** 30
    _gpu_plan(bf, monkeypatch, free)
    assert bf._plan_execution(h, w) == Plan(0, 4)
    _gpu_plan(mine, monkeypatch, free)
    assert mine._plan_execution(h, w) == Plan(0, 2)
    # a 4K frame in float32 does not fit whole: halo tiles at halo 24
    plan = mine._plan_execution(2160, 3840)
    assert plan.tile > 0 and plan.per_call >= 1
    assert mine._frame_bytes(*mine._window(2160, 3840, plan.tile)) \
        * plan.per_call <= int(free * 0.85)


def test_float32_trunk_bill_holds_the_plane_buffers():
    """The float32 trunk bills feat, the three dense buffers and their
    three split planes, and feat's split while it is copied into the
    first planes: 6,400 B a pixel, the bytes dense_trunk allocates, and
    still below the float32 head at 4x (14,336 B), which sets the bill."""
    mine, _ = _engines(batch_size=1)
    trunk = mine._rrdb_trunk_bytes(torch.float32)
    assert trunk == 64 * 4 + 3 * 192 * 4 + 3 * 192 * 6 + 64 * 6 == 6400
    head_4x = 16 * (2 * 64 * 4 + 64 * 6)
    assert trunk < head_4x
    assert mine._rrdb_bytes(10, 12) == 10 * 12 * head_4x
    cfg = rrdb.RRDBConfig(num_block=1)
    feat = torch.zeros((1, 10, 12, 64))
    a, planes = rrdb.dense_trunk(rrdb.init_params(cfg), feat, cfg=cfg,
                                 compute_dtype=torch.float32)
    held = 3 * (a.nbytes + planes.nbytes) + feat.nbytes \
        + conv3x3.split_bf16x3(feat).nbytes
    assert held == trunk * 10 * 12


def test_free_bytes_leaves_out_the_free_parts_of_held_segments(
        monkeypatch):
    """The plan's free memory is cudaMemGetInfo's and the allocator's wholly
    free segments; the free parts of segments a live tensor holds (the
    allocator's inactive split bytes) are left out, so a float32 batch
    under fragmented segments plans what really fits: here 1 frame a
    call, where counting every cached byte would give 2."""
    mine, _ = _engines(batch_size=4)
    g = 2 ** 30
    stats = {"reserved_bytes.all.current": 40 * g,
             "allocated_bytes.all.current": 2 * g,
             "inactive_split_bytes.all.current": 30 * g}
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (40 * g, 80 * g))
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda device=None: dict(stats))
    monkeypatch.setattr(mine, "device", torch.device("cuda", 0))
    mine._plans.clear()
    assert mine._free_bytes() == 48 * g
    h, w = 1080, 1920
    assert mine._plan_execution(h, w) == Plan(0, 1)
    assert mine._frame_bytes(h, w) <= int(48 * g * 0.85)
    stats["inactive_split_bytes.all.current"] = 0
    mine._plans.clear()
    assert mine._free_bytes() == 78 * g
    assert mine._plan_execution(h, w) == Plan(0, 2)


# -- the auto dtype rule ---------------------------------------------------------


def test_auto_dtype_keeps_rrdb_on_bf16_in_both_packages(tmp_path,
                                                        monkeypatch):
    """With REVE_TPU_AUTO_INT8=1 an RRDB job resolves bfloat16 with the
    same note in both packages; the port builds no int8 engine for it
    (the JAX package builds one and inspects its config)."""
    monkeypatch.setenv("REVE_TPU_AUTO_INT8", "1")
    fields = dict(input_path="in.y4m", output_path="out.y4m", scale=4,
                  segment_size=2, frame_count=4, fps_num=24, fps_den=1,
                  width=16, height=12, model="realesrgan-x4plus")
    built = []

    def make_engine(dtype, calib):
        built.append(dtype)
        raise AssertionError("no engine is built for an RRDB auto job")

    ws = Workspace(str(tmp_path / "ws"))
    ws.create()
    dtype, eng, db, notes = scheduler.resolve_auto_dtype(
        make_engine, ws, JobState(pending=plan_segments(4, 2), **fields),
        platform="cuda")
    assert (dtype, eng, db, built) == ("bfloat16", None, None, [])

    class _JaxInt8Engine:
        cfg = jrrdb.RRDBConfig()

    jws = JaxWorkspace(str(tmp_path / "jws"))
    jws.create()
    from reve_tpu.pipeline.planner import plan_segments as jplan

    jdtype, jeng, jdb, jnotes = jscheduler.resolve_auto_dtype(
        lambda dtype, calib: _JaxInt8Engine(), jws,
        JaxJobState(pending=jplan(4, 2), **fields))
    assert (jdtype, jeng, jdb) == ("bfloat16", None, None)
    assert notes == jnotes and "opt-in via --dtype int8" in notes[0]


# -- the CLI -----------------------------------------------------------------


def _y4m(tmp_path, frames=3, w=20, h=16):
    path = str(tmp_path / "in.y4m")
    rs = np.random.RandomState(0)
    yy, xx = np.mgrid[0:h, 0:w]
    with writer.Y4MWriter(path, w, h, fractions.Fraction(24)) as wr:
        for i in range(frames):
            grad = np.stack([yy * 11 + i * 20, xx * 9, (yy + xx) * 5 + i],
                            -1) % 256
            wr.write(np.clip(grad + rs.randint(-12, 13, grad.shape), 0,
                             255).astype(np.uint8))
    return path


def _y4m_samples(path):
    """(header, [frame sample arrays]) of a 4:2:0 y4m file, raw planes in
    the file's own units (8- or 10-bit)."""
    with open(path, "rb") as f:
        header = f.readline()
        data = f.read()
    fields = dict((t[:1], t[1:]) for t in header.split()[1:])
    w, h = int(fields[b"W"]), int(fields[b"H"])
    bpp = 2 if b"p10" in fields.get(b"C", b"") else 1
    n = (w * h + 2 * (w // 2) * (h // 2)) * bpp
    frames, pos = [], 0
    while pos < len(data):
        assert data[pos:pos + 6] == b"FRAME\n"
        frames.append(np.frombuffer(data[pos + 6:pos + 6 + n],
                                    "<u2" if bpp == 2 else np.uint8)
                      .astype(np.int32))
        pos += 6 + n
    return header, frames


@pytest.mark.usefixtures("jax_native_core")
def test_cli_rrdb_job_matches_jax_cli(tmp_path, monkeypatch):
    """The y4m job through both CLIs: --model realesrgan-x4plus with an
    upstream-keyed .pth (1 block), x4, float32; the two output files'
    10-bit samples agree to 1."""
    monkeypatch.chdir(tmp_path)
    _, jp = _jparams(1, biased=True)
    pth = str(tmp_path / "rrdb1.pth")
    _save_upstream_pth(pth, jp)
    inp = _y4m(tmp_path)
    job = ["-s", "4", "--model", "realesrgan-x4plus", "--weights", pth,
           "--io-backend", "y4m", "-S", "2", "--batch", "2", "--dtype",
           "float32", "--yes"]
    want, got = str(tmp_path / "jax.y4m"), str(tmp_path / "torch.y4m")
    assert jcli.run(["-i", inp, want] + job) == 0
    assert cli.run(["-i", inp, got] + job, device="cpu") == 0
    rd = reader.Y4MReader(got)
    assert (rd.width, rd.height, rd.frame_count()) == (80, 64, 3)
    gh, got_frames = _y4m_samples(got)
    wh, want_frames = _y4m_samples(want)
    assert gh == wh and len(got_frames) == len(want_frames) == 3
    for g, w in zip(got_frames, want_frames):
        assert np.abs(g - w).max() <= 1
