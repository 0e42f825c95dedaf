"""What K3, K1 and K2 take at the SRVGG widths besides 64 (32, 96 and 128
features), held on the CPU: their weight packers against the index
formulas (K3's B, pack_weights_u8conv, at Cout 32, 96, 128; the wide
forms' units, pack_weights_wide, in both dtypes; pack_weights_bf16x3 at
Cin 96 and 128), and an emulation of the wide K1's and K2's arithmetic
(csrc/conv3x3_wide.cuh: units of 32 input channels, the nine taps of
each, A the halo's planes, B as pack_weights_wide lays it out, bf16
products or the six bf16 pair products with hi.hi apart) against
reve_tpu's `_conv3x3` + `_prelu` and its head `_epilogue`; and the
engine's refusal, under --dtype auto, of int8 at widths no kernel
takes.

Tolerances (test_torch_tc_layouts.py's): float32 atol 2e-5, rtol 1e-5,
scaled by 2^8 with the inputs; bfloat16 within 2 bf16 ulp (the ulp taken
at 2^-10 or more) as the card tests hold the kernels; through the head
epilogue u8 |d| <= 1 on under 1% of the samples (a sum that differs in
its last bits may round y * 255 + 0.5 to the neighbouring integer).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from reve_tpu.models import srvgg as jsrvgg
from reve_tpu_torch.kernels import LAUNCHES, conv3x3, head
from reve_tpu_torch.models import srvgg
from reve_tpu_torch.pipeline import engine as engine_mod
from reve_tpu_torch.pipeline import scheduler
from reve_tpu_torch.pipeline.state import JobState, Workspace

torch.set_num_threads(2)

#: the widths besides 64 that the card serves
NEW_WIDTHS = (32, 96, 128)
#: the (activation, weight) split pairs the float32 forms sum (hi = 0,
#: mid = 1, lo = 2), as conv3x3_wide.cuh's mma_step
BF16X6_PAIRS = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def test_widths_are_the_distillation_widths():
    """The kernels take what the training kernels train (kernels.train
    .WIDTHS), 64 among them: every width the port distils it serves."""
    from reve_tpu_torch.kernels import train

    assert conv3x3.WIDTHS == train.WIDTHS
    assert conv3x3.FEAT in conv3x3.WIDTHS
    assert set(NEW_WIDTHS) == set(conv3x3.WIDTHS) - {conv3x3.FEAT}
    assert all(f % conv3x3.WIDE_UNIT == 0 for f in NEW_WIDTHS)


@pytest.mark.parametrize("feat", NEW_WIDTHS)
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_u8conv_weight_packer_at_other_widths(name, feat):
    """K3's B at Cout F: (S, 4, F, 8), row k = 10 dx + 3 dy + c holding
    tap (dy, dx), channel c of every output channel; the other rows
    zero."""
    tdt = DTYPES[name][1]
    rs = np.random.RandomState(feat)
    w = torch.from_numpy(rs.standard_normal((3, 3, 3, feat)).astype(
        np.float32)).to(tdt)
    p = conv3x3.pack_weights_u8conv(w)
    planes = w[None] if tdt == torch.bfloat16 else conv3x3.split_bf16x3(w)
    assert p.dtype == torch.bfloat16 and p.is_contiguous()
    assert p.shape == (planes.shape[0], conv3x3.U8_K // 8, feat, 8)
    real = {conv3x3.u8conv_k(dy, dx, c): (dy, dx, c)
            for dy in range(3) for dx in range(3) for c in range(3)}
    for s in range(p.shape[0]):
        for k in range(conv3x3.U8_K):
            col = p[s, k // 8, :, k % 8]
            if k in real:
                dy, dx, c = real[k]
                assert torch.equal(col, planes[s, dy, dx, c])
            else:
                assert not col.any()


#: (Cin, Cout) of the wide forms: the hidden convs and the heads at r =
#: 2, 3, 4 of each width
WIDE_PAIRS = [(f, co) for f in NEW_WIDTHS for co in (f, 12, 27, 48)]


@pytest.mark.parametrize("cin, cout", WIDE_PAIRS)
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_wide_weight_packer_matches_its_index_formula(name, cin, cout):
    """packed[u, t, s, kb, n, kk] = planes[s, t // 3, t % 3, 32 u + 8 kb +
    kk, n] for n < Cout, 0 above (N = Cout padded to a multiple of 8);
    one unit-tap is one contiguous run of the kernel's TAP_BYTES."""
    tdt = DTYPES[name][1]
    rs = np.random.RandomState(cin + cout)
    w = torch.from_numpy(rs.standard_normal((3, 3, cin, cout)).astype(
        np.float32)).to(tdt)
    p = conv3x3.pack_weights_wide(w)
    planes = w[None] if tdt == torch.bfloat16 else conv3x3.split_bf16x3(w)
    S, n_pad = planes.shape[0], conv3x3.padded_n(cout)
    assert p.shape == (cin // 32, 9, S, 4, n_pad, 8)
    assert p.dtype == torch.bfloat16 and p.is_contiguous()
    flat = p.reshape(-1)
    for u, t, s, kb, n, kk in zip(*(rs.randint(0, m, 400) for m in (
            cin // 32, 9, S, 4, n_pad, 8))):
        want = planes[s, t // 3, t % 3, 32 * u + 8 * kb + kk, n] \
            if n < cout else 0
        assert p[u, t, s, kb, n, kk] == want
        tap_vals = S * 32 * n_pad  # one unit-tap's values
        at = (u * 9 + t) * tap_vals + ((s * 4 + kb) * n_pad + n) * 8 + kk
        assert flat[at] == p[u, t, s, kb, n, kk]
    assert not p[:, :, :, :, cout:].any()


@pytest.mark.parametrize("cin", [96, 128])
@pytest.mark.parametrize("cout", [48, 96, 128])
def test_bf16x3_weight_packer_at_other_widths(cin, cout):
    """pack_weights_bf16x3 (the 64-feature float32 forms' tap-major
    layout) at other Cin: (9, 3, Cin / 8, N, 8) by the same formula."""
    rs = np.random.RandomState(cin * cout)
    w = torch.from_numpy(rs.standard_normal((3, 3, cin, cout)).astype(
        np.float32))
    p = conv3x3.pack_weights_bf16x3(w)
    s = conv3x3.split_bf16x3(w)
    n_pad = conv3x3.padded_n(cout)
    assert p.shape == (9, 3, cin // 8, n_pad, 8)
    for t, sp, kb, n, kk in zip(*(rs.randint(0, m, 400) for m in (
            9, 3, cin // 8, n_pad, 8))):
        want = s[sp, t // 3, t % 3, 8 * kb + kk, n] if n < cout else 0
        assert p[t, sp, kb, n, kk] == want


def _wide_sum(x, w):
    """The wide forms' product on the CPU: for each unit of 32 input
    channels and each tap, the planes of the input's shifted halo (bf16
    x, or split_bf16x3's hi, mid, lo of float32 x) times that unit-tap of
    pack_weights_wide, float32 sums; float32 sums the pairs of
    BF16X6_PAIRS, smallest first, hi.hi apart.  Returns the (B, H, W,
    Cout) float32 sum before the bias."""
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    n = conv3x3.padded_n(cout)
    planes = x[None] if x.dtype == torch.bfloat16 else \
        conv3x3.split_bf16x3(x)
    xp = F.pad(planes, (0, 0, 1, 1, 1, 1))
    packed = conv3x3.pack_weights_wide(w)
    S = planes.shape[0]
    pairs = ((0, 0),) if S == 1 else BF16X6_PAIRS
    acc = torch.zeros(B, H, W, n)
    cor = torch.zeros(B, H, W, n)
    for u in range(cin // conv3x3.WIDE_UNIT):
        for t in range(9):
            dy, dx = t // 3, t % 3
            a = xp[:, :, dy:dy + H, dx:dx + W, 32 * u:32 * u + 32].float()
            bm = packed[u, t].permute(0, 1, 3, 2).reshape(S, 32, n).float()
            for i, j in reversed(pairs):
                if (i, j) == (0, 0):
                    acc += a[i] @ bm[j]
                else:
                    cor += a[i] @ bm[j]
    return (acc + cor)[..., :cout]


def _inputs(seed, cin, cout, scale=1.0, B=2, H=9, W=13):
    rs = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(9 * cin)
    return {
        "x": ((rs.rand(B, H, W, cin) * 2 - 0.5) * scale).astype(np.float32),
        "w": rs.uniform(-bound, bound, (3, 3, cin, cout)).astype(np.float32),
        "b": rs.uniform(-0.1, 0.1, (cout,)).astype(np.float32),
        "alpha": rs.uniform(0.05, 0.4, (cout,)).astype(np.float32),
        "u8": rs.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
    }


def _close(got, want, name, scale=1.0):
    if name == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=1e-5)
        return
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                     2.0 ** -10 * scale)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert (np.abs(got - want) <= 2 * ulp).all(), np.abs(got - want).max()


@pytest.mark.parametrize("scale", [1.0, 2.0 ** 8])
@pytest.mark.parametrize("cin", [96, 128])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_wide_k1_emulation_matches_jax_conv_prelu(name, cin, scale):
    """The wide K1's sum, + b in float32, cast to the dtype, PReLU in it
    (the kernel's epilogue), against reve_tpu's `_prelu(_conv3x3(x, w,
    b), alpha)` at Cin = Cout."""
    jdt, tdt = DTYPES[name]
    d = _inputs(cin + int(scale), cin, cin, scale)
    want = np.asarray(jsrvgg._prelu(jsrvgg._conv3x3(
        jnp.asarray(d["x"]).astype(jdt), jnp.asarray(d["w"]).astype(jdt),
        jnp.asarray(d["b"])), jnp.asarray(d["alpha"])).astype(jnp.float32))
    x = torch.from_numpy(d["x"]).to(tdt)
    w = torch.from_numpy(d["w"]).to(tdt)
    f = (_wide_sum(x, w) + torch.from_numpy(d["b"])).to(tdt)
    got = conv3x3.prelu_plain(f, torch.from_numpy(d["alpha"]))
    _close(got.float().numpy(), want, name, scale)


@pytest.mark.parametrize("scale", [1.0, 2.0 ** 8])
@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("cin", [96, 128])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_wide_k2_emulation_matches_jax_head(name, cin, r, scale):
    """The wide K2's sum at 3r^2 outputs, + b (cast to bf16 in bfloat16),
    then the head epilogue, against reve_tpu's `_conv3x3` +
    `_epilogue(quantize_u8=True)` (the pixel shuffle included)."""
    jdt, tdt = DTYPES[name]
    d = _inputs(10 * r + cin, cin, 3 * r * r, scale)
    h = np.maximum(d["x"], 0) * 0.5  # a hidden activation, as K1 hands it
    cfg = jsrvgg.SRVGGConfig(num_feat=cin, num_conv=1, upscale=r)
    orig = jnp.asarray(d["u8"]).astype(jnp.float32) * (1.0 / 255.0)
    want = np.asarray(jsrvgg._epilogue(
        jsrvgg._conv3x3(jnp.asarray(h).astype(jdt),
                        jnp.asarray(d["w"]).astype(jdt),
                        jnp.asarray(d["b"])), orig, cfg, quantize_u8=True))
    hv = _wide_sum(torch.from_numpy(h).to(tdt),
                   torch.from_numpy(d["w"]).to(tdt)) + torch.from_numpy(
                       d["b"])
    got = head.residual_u8_plain(hv.to(tdt), torch.from_numpy(d["u8"]),
                                 r).numpy()
    assert got.shape == want.shape == (2, 9 * r, 13 * r, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01, (diff > 0).mean()
    if scale == 1.0:  # not clipped flat: the comparison has something
        assert np.unique(want).size > 64


def test_split_pass_is_width_agnostic():
    """The split pass reads a contiguous tensor as a flat run of 8-value
    rows: its planes at 32, 96 and 128 channels are those of the same
    values at any other shape."""
    rs = np.random.RandomState(9)
    flat = torch.from_numpy(rs.standard_normal(2 * 5 * 7 * 96 * 4).astype(
        np.float32))
    want = conv3x3.split_bf16x3(flat)
    for feat in (32, 64, 96, 128):
        x = flat.reshape(-1, 5, 7, feat)
        got = conv3x3.split_bf16x3(x)
        assert got.shape == (3, *x.shape)
        assert torch.equal(got.reshape(3, -1), want)
    assert all(v == 0 for v in LAUNCHES.values())


@pytest.mark.parametrize("feat", [16, 48, 80])
def test_auto_dtype_refuses_int8_at_other_widths(tmp_path, monkeypatch,
                                                 feat):
    """--dtype auto with REVE_TPU_AUTO_INT8 set (eligible for the int8
    turbo) at a width the card's kernels do not take: the trial int8
    engine refuses before any batch, and auto passes the refusal on
    rather than serving bfloat16 instead."""
    monkeypatch.setenv("REVE_TPU_AUTO_INT8", "1")
    monkeypatch.setattr(engine_mod.device_mod, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    cfg = srvgg.SRVGGConfig(num_feat=feat, num_conv=1, upscale=2)
    params = srvgg.init_params(cfg)

    def make_engine(dtype, calib):
        return engine_mod.UpscaleEngine(compute_dtype=dtype,
                                        int8_calib=calib,
                                        preloaded=(cfg, params))

    ws = Workspace(str(tmp_path / "ws"))
    ws.create()
    st = JobState(input_path="unused.y4m", output_path="out.y4m", scale=2,
                  segment_size=2, frame_count=4, fps_num=24, fps_den=1,
                  width=16, height=16, pending=[])
    with pytest.raises(engine_mod.WidthNotServed,
                       match=engine_mod.SERVING_WIDTHS_ITEM):
        scheduler.resolve_auto_dtype(make_engine, ws, st, platform="cuda")
    # at the kernels' widths the same check passes: only the width is
    # refused
    for served in conv3x3.WIDTHS:
        engine_mod.check_serving_width(
            srvgg.SRVGGConfig(num_feat=served, num_conv=1, upscale=2),
            torch.device("cuda", 0))
