"""RRDBNet x2 (`realesrgan-x2plus`) in the port against the JAX package on
the same numbers, on the CPU: ops.pixel_shuffle.pixel_unshuffle, K3 at
Cin 12 (kernels/conv3x3.py conv3x3_u8x2_bias: its plain version, its
weight packer and an emulation of how csrc/conv3x3.cu stages the
unshuffle in place), rrdb.apply and apply_int8 at x2, the calibration at
x2, the registry, the engine (whole frames, halo tiles, TTA, odd dims,
the memory bill), and the job through both CLIs and the API.

Weights come from reve_tpu's own init_params at x2 (conv_first reads 12
channels) with seeded biases, carried across with params_from_jax;
inputs are seeded numpy arrays handed to both packages.

Tolerances, each with its reason:
  * pixel_unshuffle: exact (a reindex);
  * K3 at Cin 12's plain version and the kernel's emulation against
    reve_tpu's unshuffle + conv_first: float32 atol 2e-5, rtol 1e-5 (a
    sum of 108 products in another order, as float32 K1's); bfloat16
    within 2 bf16 ulp, the ulp taken at 2^-10 or more (a float32 sum
    rounded once to bf16 may land one step apart);
  * rrdb.apply float32: u8 |d| <= 1 against both of the JAX package's
    domains (the convs sum in other orders, which can move y * 255 + 0.5
    across an integer); bfloat16: the port's PSNR against the JAX float32
    output at most BF16_PSNR_MARGIN_DB below the JAX package's own bf16
    PSNR, as tests/test_torch_rrdb.py holds x4;
  * the calibration's maxima at x2: rtol 1e-5 (tests/test_torch_rrdb_int8
    .py's reason); quantize_rrdb from the same maxima: identical;
    apply_int8 with that quantization: float32 u8 |d| <= 1, bfloat16 at
    >= 50 dB against the JAX package's (the bf16 first conv sums in
    another order);
  * the CLI and API jobs: float32 10-bit samples |d| <= 1; int8 with the
    JAX job's persisted calibration |d| <= 4 on at most 2% (one u8 step is
    up to 4 steps of a 10-bit sample), as at x4.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reve_tpu import cli as jcli
from reve_tpu.models import rrdb as jrrdb
from reve_tpu.ops import pixel_shuffle as jps
from reve_tpu.pipeline.engine import UpscaleEngine as JaxEngine
from reve_tpu.weights import quantize as jquantize
from reve_tpu_torch import cli, upscale_video
from reve_tpu_torch.io import reader
from reve_tpu_torch.kernels import LAUNCHES, conv3x3
from reve_tpu_torch.models import registry, rrdb
from reve_tpu_torch.ops import tiling
from reve_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from reve_tpu_torch.pipeline.engine import Plan, UpscaleEngine
from reve_tpu_torch.pipeline.state import Workspace
from reve_tpu_torch.weights import quantize
from test_torch_cli import jax_native_core  # noqa: F401
from test_torch_rrdb import (BF16_PSNR_MARGIN_DB, _frames, _jax_u8,
                             _jparams, _max_diff, _port, _psnr,
                             _save_upstream_pth, _y4m, _y4m_samples)
from test_torch_tc_layouts import BF16X6_PAIRS

torch.set_num_threads(2)

NF = 64
#: K3 at Cin 12's tiles: output rows a tile by compute dtype (the
#: kernel's U8::TH at R = 2); a tile's halo pixel holds its TH + 2 rows x 12
#: channels (float32: and 8 zeros; SLOTS), of which an output row reads 3
#: rows (WIN)
TILE_ROWS = {torch.bfloat16: 4, torch.float32: 2}
WIN = 36
#: the compute dtypes: (JAX dtype, torch dtype)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _x(u8):
    """The JAX engine's model input: u8 * float32(1 / 255)."""
    return jnp.asarray(u8).astype(jnp.float32) * (1.0 / 255.0)


def _bf16_ulp_ok(got, want, ulps=2):
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -10)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return bool((np.abs(got - want) <= ulps * ulp).all())


def _conv_first_case(seed):
    rs = np.random.RandomState(seed)
    u8 = rs.randint(0, 256, (2, 10, 14, 3)).astype(np.uint8)
    w = rs.uniform(-0.3, 0.3, (3, 3, 12, NF)).astype(np.float32)
    b = rs.uniform(-0.1, 0.1, NF).astype(np.float32)
    return u8, w, b


def _jax_conv_first(u8, w, b, jdt):
    """reve_tpu rrdb.apply's classic conv_first at x2."""
    h = jps.pixel_unshuffle(_x(u8), 2).astype(jdt)
    y = jrrdb._conv(h, {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jdt)
    return np.asarray(jnp.asarray(y).astype(jnp.float32))


def _close(got, want, name):
    if name == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    else:
        assert _bf16_ulp_ok(got, want)


# -- pixel_unshuffle and K3 at Cin 12 -----------------------------------------


@pytest.mark.parametrize("r", [2, 4])
def test_pixel_unshuffle_matches_jax(r):
    x = np.random.RandomState(r).standard_normal(
        (2, 3 * r, 5 * r, 3)).astype(np.float32)
    got = pixel_unshuffle(torch.from_numpy(x), r)
    want = np.asarray(jps.pixel_unshuffle(jnp.asarray(x), r))
    assert got.shape == (2, 3, 5, 3 * r * r)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(pixel_shuffle(got, r), torch.from_numpy(x))
    for bad in ((2, 3 * r + 1, 5 * r, 3), (2, 3 * r, 5 * r - 1, 3)):
        with pytest.raises(ValueError, match="not divisible"):
            pixel_unshuffle(torch.zeros(bad), r)
        with pytest.raises(ValueError, match="not divisible"):
            jps.pixel_unshuffle(jnp.zeros(bad), r)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_k3x2_plain_matches_jax_conv_first(name):
    jdt, tdt = DTYPES[name]
    u8, w, b = _conv_first_case(3)
    got = conv3x3.conv3x3_u8x2_bias_plain(
        torch.from_numpy(u8), torch.from_numpy(w).to(tdt),
        torch.from_numpy(b))
    assert got.dtype == tdt and got.shape == (2, 5, 7, NF)
    _close(got.float().numpy(), _jax_conv_first(u8, w, b, jdt), name)
    # the wrapper on CPU tensors is the plain version, launching nothing
    again = conv3x3.conv3x3_u8x2_bias(torch.from_numpy(u8),
                                      torch.from_numpy(w).to(tdt),
                                      torch.from_numpy(b))
    assert torch.equal(again, got) and LAUNCHES["conv3x3_u8x2_bias"] == 0
    with pytest.raises(ValueError, match="not divisible"):
        conv3x3.conv3x3_u8x2_bias(torch.from_numpy(u8[:, :9]),
                                  torch.from_numpy(w).to(tdt),
                                  torch.from_numpy(b))


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_k3x2_weight_packer_matches_its_index_formula(name):
    """K3 at Cin 12's B: row k = 36 dx + 12 dy + c holds tap (dy, dx),
    unshuffled channel c (the 36 values of an unshuffled pixel column);
    rows 108..111 are zero.  bfloat16 packs the weights as they are,
    float32 their three bf16 splits."""
    tdt = DTYPES[name][1]
    w = torch.from_numpy(np.random.RandomState(9).standard_normal(
        (3, 3, 12, NF)).astype(np.float32)).to(tdt)
    p = conv3x3.pack_weights_u8conv(w)
    planes = w[None] if tdt == torch.bfloat16 else conv3x3.split_bf16x3(w)
    assert p.dtype == torch.bfloat16 and p.is_contiguous()
    assert p.shape == (planes.shape[0], conv3x3.U8X2_K // 8, NF, 8)
    real = {conv3x3.u8conv_k(dy, dx, c, 12): (dy, dx, c)
            for dy in range(3) for dx in range(3) for c in range(12)}
    assert sorted(real) == list(range(108)) and conv3x3.U8X2_K == 112
    for s in range(p.shape[0]):
        for k in range(conv3x3.U8X2_K):
            got = p[s, k // 8, :, k % 8]
            if k in real:
                dy, dx, c = real[k]
                assert torch.equal(got, planes[s, dy, dx, c])
            else:
                assert not got.any()


def _k3x2_emulation(u8, w, b):
    """K3 at Cin 12's product on the CPU as csrc/conv3x3.cu (R = 2) lays
    it out: tiles of TH output rows, each tile's halo staged as the
    kernel's `stage` places it (conv input pixel X - 1 of row y0 - 1 + dy
    at halo pixel X, its unshuffled channel 4 c + 2 i + j, from u8 row i
    and pixel j of its 2 x 2 block, at slot 12 dy + 4 c + 2 i + j of
    SLOTS = 12 (TH + 2), and 8 zeros after them in float32), A of output
    pixel p of the tile's row i the halo value SLOTS p + 12 i + k +
    (SLOTS - WIN) dx for k = WIN dx + 12
    dy + c (the zero-weight k 108..111 at dx 2), B as pack_weights_u8conv
    lays it out, float32 sums (float32: the pairs of BF16X6_PAIRS,
    smallest first), + b in float32, cast to the compute dtype."""
    dt = w.dtype
    TH = TILE_ROWS[dt]
    SLOTS = 12 * (TH + 2) + (8 if dt == torch.float32 else 0)
    B, H2, W2, _ = u8.shape
    H, W = H2 // 2, W2 // 2
    ty = -(-H // TH)
    x = u8.float() * (1.0 / 255.0)
    planes = x.to(torch.bfloat16)[None] if dt == torch.bfloat16 \
        else conv3x3.split_bf16x3(x)
    S = planes.shape[0]
    # the unshuffled input with a zero border: pixel (y, x) at (y + 1, x +
    # 1), channel 4 c + 2 i + j; rows past the last tile's halo zero
    xu = torch.zeros(S, B, ty * TH + 2, W + 3, 12)
    xu[:, :, 1:H + 1, 1:W + 1] = planes.float().view(
        S, B, H, 2, W, 2, 3).permute(0, 1, 2, 4, 6, 3, 5).reshape(
            S, B, H, W, 12)
    k = torch.arange(conv3x3.U8X2_K)
    off = k + (SLOTS - WIN) * torch.where(k < 3 * WIN, k // WIN, 2)
    rows = []
    for yt in range(ty):
        # the tile's halo, halo pixel by halo pixel (each padded to SLOTS),
        # and 8 zeros past it
        halo = torch.nn.functional.pad(torch.nn.functional.pad(
            xu[:, :, yt * TH:yt * TH + TH + 2].permute(0, 1, 3, 2, 4)
            .reshape(S, B, W + 3, -1), (0, SLOTS - 12 * (TH + 2)))
            .reshape(S, B, -1), (0, 8))
        for i in range(min(TH, H - yt * TH)):
            rows.append(halo[:, :, SLOTS * torch.arange(W)[:, None]
                             + 12 * i + off])
    cols = torch.stack(rows, 2)
    bp = conv3x3.pack_weights_u8conv(w).permute(0, 1, 3, 2).reshape(
        -1, conv3x3.U8X2_K, NF).float()
    pairs = ((0, 0),) if dt == torch.bfloat16 else BF16X6_PAIRS
    acc = None
    for i, j in reversed(pairs):
        t = cols[i] @ bp[j]
        acc = t if acc is None else acc + t
    return (acc + b).to(dt)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_k3x2_emulation_matches_jax_conv_first(name):
    jdt, tdt = DTYPES[name]
    u8, w, b = _conv_first_case(4)
    got = _k3x2_emulation(torch.from_numpy(u8), torch.from_numpy(w).to(tdt),
                          torch.from_numpy(b))
    assert got.shape == (2, 5, 7, NF)
    _close(got.float().numpy(), _jax_conv_first(u8, w, b, jdt), name)


# -- the model ----------------------------------------------------------------


@pytest.fixture(scope="module")
def x2_model():
    """1 block at x2 with seeded biases, in both packages."""
    jcfg, jp = _jparams(1, seed=2, biased=True, upscale=2)
    return jcfg, jp, *_port(jcfg, jp)


def test_apply_x2_matches_jax_float32_both_domains(x2_model):
    jcfg, jp, cfg, params = x2_model
    assert tuple(params["conv_first"]["w"].shape) == (3, 3, 12, NF)
    u8 = _frames((2, 16, 20, 3))
    got = rrdb.apply(params, torch.from_numpy(u8), cfg=cfg,
                     compute_dtype=torch.float32).numpy()
    assert got.shape == (2, 32, 40, 3) and got.dtype == np.uint8
    assert 20 < got.mean() < 235
    for s2d in (False, True):
        assert _max_diff(got, _jax_u8(jp, jcfg, u8, jnp.float32, s2d)) <= 1


def test_apply_x2_bf16_within_the_jax_packages_own_bf16_error(x2_model):
    jcfg, jp, cfg, params = x2_model
    u8 = _frames((2, 16, 20, 3), seed=3)
    got = rrdb.apply(params, torch.from_numpy(u8), cfg=cfg,
                     compute_dtype=torch.bfloat16).numpy()
    ref = _jax_u8(jp, jcfg, u8, jnp.float32, False)
    jax_db = _psnr(_jax_u8(jp, jcfg, u8, jnp.bfloat16, False), ref)
    assert _psnr(got, ref) >= jax_db - BF16_PSNR_MARGIN_DB


def test_x2_calibration_and_int8_match_jax(x2_model):
    """At x2 the RRDB part of weights/quantize.py takes its 16 statistics
    (rrdb_num_stats: nothing scale-specific, as in reve_tpu) after the
    unshuffled conv_first, as the JAX package does; from one persisted
    calibration both packages quantize identically, and apply_int8
    agrees."""
    jcfg, jp, cfg, params = x2_model
    u8 = _frames((2, 16, 20, 3), seed=5)
    assert quantize.rrdb_num_stats(cfg) == jquantize.rrdb_num_stats(jcfg) \
        == 16
    assert quantize.rrdb_num_stats(dataclasses.replace(cfg, num_block=23)) \
        == 346
    want = np.asarray(jquantize.collect_act_maxima_rrdb(
        jp, _x(u8), cfg=jcfg, percentile=99.9))
    got = quantize.collect_maxima(params, torch.from_numpy(u8), cfg=cfg,
                                  percentile=99.9)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    jqb = jquantize.quantize_rrdb(jp, jcfg, want, margin=1.25)
    qb = quantize.build_qbody(params, cfg, want, margin=1.25)
    assert torch.equal(qb["act_scale"],
                       torch.from_numpy(np.array(jqb["act_scale"])))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        mine = rrdb.apply_int8(params, qb, torch.from_numpy(u8), cfg=cfg,
                               compute_dtype=dt).numpy()
        ref = np.asarray(jrrdb.apply_int8(jp, jqb, _x(u8), cfg=jcfg,
                                          compute_dtype=jdt,
                                          quantize_u8=True, s2d=False))
        assert mine.shape == ref.shape == (2, 32, 40, 3)
        if dt == torch.float32:
            assert _max_diff(mine, ref) <= 1
        else:
            assert _psnr(mine, ref) >= 50.0


def test_registry_and_load_pth_at_x2(tmp_path, monkeypatch, x2_model):
    """realesrgan-x2plus resolves to an x2 RRDBNet (its conv_first at Cin
    12); load_pth infers x2 from that Cin, as reve_tpu's does; weights of
    another scale are refused; x1 (Cin 48) stays refused by name."""
    monkeypatch.chdir(tmp_path)
    jcfg, jp, _cfg, _params = x2_model
    path = str(tmp_path / "x2.pth")
    _save_upstream_pth(path, jp)
    cfg, params = rrdb.load_pth(path)
    assert (cfg.upscale, cfg.num_block) == (2, 1)
    jcfg2, _jp2 = jrrdb.load_pth(path)
    assert jcfg2.upscale == cfg.upscale == 2
    cfg, _ = registry.load_model("realesrgan-x2plus", 2, weights=path)
    assert cfg.upscale == 2
    with pytest.raises(ValueError, match="x2, requested x4"):
        registry.load_model("realesrgan-x4plus", 4, weights=path)
    rrdb.check_cfg(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*RRDB x1"):
        rrdb.apply(params, torch.zeros((1, 8, 8, 3), dtype=torch.uint8),
                   cfg=dataclasses.replace(cfg, upscale=1))
    with pytest.raises(ValueError, match="x1, x2 or x4"):
        rrdb.check_cfg(dataclasses.replace(cfg, upscale=3))


# -- the engine ---------------------------------------------------------------


@pytest.mark.parametrize("mode", ["whole", "tiled", "tta"])
def test_engine_x2_matches_jax_engine(x2_model, mode):
    """Whole frames, halo tiles (tile 16 on 32 x 80 frames at RRDB's halo
    24: windows of 32 x 64, even, as the unshuffle needs; held against
    the JAX package's tiles, its approximation, and each window equal to
    itself run alone as a whole frame) and the TTA ensemble, float32."""
    jcfg, jp, cfg, params = x2_model
    tile = 16 if mode == "tiled" else 0
    mine = UpscaleEngine(device="cpu", compute_dtype="float32", tile=tile,
                         tta=mode == "tta", batch_size=2,
                         preloaded=(cfg, params))
    ref = JaxEngine(compute_dtype="float32", tile=tile, tta=mode == "tta",
                    batch_size=2, preloaded=(jcfg, jp))
    shape = (2, 32, 80, 3) if mode == "tiled" else (2, 12, 16, 3)
    frames = _frames(shape, seed=8)
    got = mine.upscale_frames(frames)
    assert got.shape == (2, shape[1] * 2, shape[2] * 2, 3)
    assert _max_diff(got, ref.upscale_frames(frames)) <= 1
    if mode == "tiled":
        plan = mine._plan_execution(32, 80)
        assert plan.tile == 16 and plan.per_call >= 1
        assert tiling.plan_tiles(32, 80, 16, mine.halo).window_shape \
            == (32, 64)
        whole = UpscaleEngine(device="cpu", compute_dtype="float32",
                              tile=-1, batch_size=1, preloaded=(cfg, params))
        alone = tiling.upscale_tiled(whole._forward, torch.from_numpy(frames),
                                     scale=2, tile=16, halo=mine.halo,
                                     chunk=1)
        assert np.array_equal(got, alone.numpy())


@pytest.mark.parametrize("shape,tile", [((1, 15, 20, 3), 0),
                                        ((1, 32, 80, 3), 15)],
                         ids=["odd_frame", "odd_window"])
def test_engine_x2_refuses_odd_dims_as_jax(x2_model, shape, tile):
    """An odd frame, or an odd tile whose windows come out odd (15 + 2 x
    24 = 63 columns): the unshuffle refuses them in both packages."""
    jcfg, jp, cfg, params = x2_model
    frames = _frames(shape)
    mine = UpscaleEngine(device="cpu", compute_dtype="float32", tile=tile,
                         preloaded=(cfg, params))
    ref = JaxEngine(compute_dtype="float32", tile=tile,
                    preloaded=(jcfg, jp))
    with pytest.raises(ValueError, match="not divisible"):
        mine.upscale_frames(frames)
    with pytest.raises(ValueError, match="not divisible"):
        ref.upscale_frames(frames)


def test_engine_x2_bills_the_trunk_at_half_size(x2_model, monkeypatch):
    """At x2 the trunk runs at (h/2, w/2), up1 at (h, w) and up2/hr at
    (2h, 2w): the bill is x4's at (h/2, w/2); an auto tile is even, so
    even frames give even windows."""
    _jcfg, _jp, cfg, params = x2_model
    x2 = UpscaleEngine(device="cpu", compute_dtype="float32",
                       preloaded=(cfg, params))
    x4 = UpscaleEngine(device="cpu", compute_dtype="float32",
                       preloaded=_port(*_jparams(1)))
    for dt in (torch.float32, torch.bfloat16):
        assert x2._rrdb_bytes(1080, 1920, dt) == \
            x4._rrdb_bytes(540, 960, dt)
    assert x2._frame_bytes(1080, 1920) == x4._rrdb_bytes(540, 960) \
        + 1080 * 1920 * 3 * (1 + 4)
    for avail in (3 * 10 ** 9, 5 * 10 ** 9 + 1, 7 * 10 ** 9 + 3):
        tile = x2._auto_tile(2160, 3840, avail)
        assert tile > 0 and tile % 2 == 0
        assert x2._frame_bytes(*x2._window(2160, 3840, tile)) <= avail
    g = 2 ** 30
    monkeypatch.setattr(x2, "device", torch.device("cuda", 0))
    monkeypatch.setattr(x2, "_free_bytes", lambda: 12 * g)
    plan = x2._plan_execution(2160, 3840)
    assert plan.tile > 0 and plan.tile % 2 == 0 and plan != Plan(0, 1)


# -- the job ------------------------------------------------------------------


JOB = ["-s", "2", "--model", "realesrgan-x2plus", "--io-backend", "y4m",
       "-S", "2", "--batch", "2", "--yes"]


@pytest.fixture
def x2_pth(tmp_path, x2_model):
    path = str(tmp_path / "rrdb1_x2.pth")
    _save_upstream_pth(path, x2_model[1])
    return path


@pytest.fixture
def small_calib_chunks(monkeypatch):
    """Both engines' calibration chunks of 2 frames of 16 x 20 (see
    tests/test_torch_rrdb_int8.py)."""
    for cls in (UpscaleEngine, JaxEngine):
        monkeypatch.setattr(cls, "_CALIB_CHUNK_ELEMS", 2 * 16 * 20 * NF)


def _samples_close(got, want, worst, share):
    gh, got_frames = _y4m_samples(got)
    wh, want_frames = _y4m_samples(want)
    assert gh == wh and len(got_frames) == len(want_frames) == 3
    for g, w in zip(got_frames, want_frames):
        d = np.abs(g - w)
        assert d.max() <= worst and (d > 0).mean() <= share


@pytest.mark.usefixtures("jax_native_core")
def test_cli_x2_job_matches_jax_cli_float32(tmp_path, monkeypatch, x2_pth):
    """The y4m job through both CLIs, --model realesrgan-x2plus with a
    1-block upstream-keyed x2 .pth, float32: samples agree to 1; the API
    writes the port CLI's bytes."""
    monkeypatch.chdir(tmp_path)
    inp = _y4m(tmp_path)
    job = JOB + ["--weights", x2_pth, "--dtype", "float32"]
    want, got = str(tmp_path / "jax.y4m"), str(tmp_path / "torch.y4m")
    assert jcli.run(["-i", inp, want] + job) == 0
    assert cli.run(["-i", inp, got] + job, device="cpu") == 0
    rd = reader.Y4MReader(got)
    assert (rd.width, rd.height, rd.frame_count()) == (40, 32, 3)
    _samples_close(got, want, 1, 1.0)
    api_out = str(tmp_path / "api.y4m")
    report = upscale_video(inp, api_out, 2, model="realesrgan-x2plus",
                           weights=x2_pth, segment_size=2, batch=2,
                           dtype="float32", io_backend="y4m", device="cpu")
    assert report["dtype"] == "float32"
    with open(api_out, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.usefixtures("jax_native_core")
def test_cli_x2_int8_job_matches_jax_cli(tmp_path, monkeypatch, capsys,
                                         x2_pth, small_calib_chunks):
    """--dtype int8 at x2 through both CLIs: the port's own calibration
    matches the JAX job's persisted one (rtol 1e-5); quantizing with the
    JAX job's, the port writes the same samples (as at x4)."""
    monkeypatch.chdir(tmp_path)
    inp = _y4m(tmp_path)
    job = JOB + ["--weights", x2_pth, "--dtype", "int8", "--keep-workspace"]
    want, own, got = (str(tmp_path / f"{n}.y4m")
                      for n in ("jax", "own", "torch"))
    assert jcli.run(["-i", inp, want] + job) == 0
    with open(os.path.join(want + ".revework",
                           "int8_calibration.json")) as f:
        maxima = json.load(f)["act_maxima"]
    assert len(maxima) == 16
    assert cli.run(["-i", inp, own] + job, device="cpu") == 0
    np.testing.assert_allclose(
        Workspace(own + ".revework").load_calibration(), maxima, rtol=1e-5)
    monkeypatch.setattr(Workspace, "load_calibration", lambda self: maxima)
    capsys.readouterr()
    assert cli.run(["-i", inp, got] + job, device="cpu") == 0
    assert "path: int8 turbo (" in capsys.readouterr().err
    _samples_close(got, want, 4, 0.02)
