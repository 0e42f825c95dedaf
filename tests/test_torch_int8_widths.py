"""The int8 turbo path at the SRVGG widths besides 64 (32, 96 and 128
features), held on the CPU against the JAX package: srvgg.apply_int8 and
the int8 engine against reve_tpu's from the same maxima, the s8 weight
packers of K4 and K4h (pack_weights_s8 at any Cin, pack_weights_s8_wide)
against their index formulas, and an emulation of the wide K4's and K4h's
walk (csrc/conv3x3_s8_wide.cuh: units of 32 input channels, the nine taps
of each one k32 step, B as pack_weights_s8_wide lays it out, s32 sums,
then the float32 epilogue rounded where the kernel rounds) against
reve_tpu's `_conv3x3_s8`, `dq_prelu`, `_quant_s8` and the int8 head's
`_epilogue`, including at +-127 codes and at the quantize's ties.

Tolerances: the integer sums and float32 epilogues exact against the
reference's ops; the engine u8 |d| <= 1, and the scales from the same
maxima identical; apply_int8 u8 |d| <= 1 on <= 2% of the samples in both
dtypes, the int8 head included (tests/test_torch_int8.py holds it exact
at 16 features, where no sample happens to sit on a boundary).  A value
next to a rounding boundary may be rounded otherwise than the
reference's jitted graph rounds it, moving a code by one, which the
later layers carry.  In its bfloat16 compilation reve_tpu's jitted
apply_int8 contracts a hidden layer's dequant, float32(y32) * scale + b,
into one fused multiply-add on the CPU (XLA's fusion): at 96 features x4
three samples of 12,096 differ, and the port's hidden layers computed
with that fused multiply-add match the reference there exactly.  In
float32 (0.008-0.06% of samples at 96 features x4 with the float head
and at 16 convs) the cause is not traced: the first and head convs sum
in another order, or the same contraction.  The port, like the kernels
(__fmul_rn, __fadd_rn), rounds the product and the sum apart, as the
reference's ops one by one do (the emulation tests hold that exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from reve_tpu.models import srvgg as jsrvgg
from reve_tpu.pipeline.engine import UpscaleEngine as JaxEngine
from reve_tpu.weights import quantize as jquantize
from reve_tpu_torch.kernels import conv3x3, conv3x3_s8, head
from reve_tpu_torch.models import srvgg
from reve_tpu_torch.pipeline.engine import UpscaleEngine
from reve_tpu_torch.weights import quantize

torch.set_num_threads(2)

#: the widths besides 64 that the card serves in int8
NEW_WIDTHS = (32, 96, 128)
#: (Cin, Cout) of the wide int8 forms: K4 and K4h at r = 2, 3, 4
S8_PAIRS = [(f, co) for f in NEW_WIDTHS for co in (f, 12, 27, 48)]


def _u8(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def _models(feat, r, num_conv, seed):
    jcfg = jsrvgg.SRVGGConfig(num_feat=feat, num_conv=num_conv, upscale=r)
    cfg = srvgg.SRVGGConfig(num_feat=feat, num_conv=num_conv, upscale=r)
    jparams = jsrvgg.init_params(jax.random.key(seed), jcfg)
    return jcfg, cfg, jparams


def _apply_int8_case(feat, r, int8_head, num_conv, shape, seed):
    jcfg, cfg, jparams = _models(feat, r, num_conv, seed)
    u8 = _u8(shape, seed=seed)
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
            int8_head=int8_head)).astype(np.int16)
        got = srvgg.apply_int8(params, qb, torch.from_numpy(u8), cfg=cfg,
                               compute_dtype=dt, int8_head=int8_head)
        B, H, W, _ = shape
        assert got.dtype == torch.uint8 and got.shape == want.shape == \
            (B, H * r, W * r, 3)
        d = np.abs(got.numpy().astype(np.int16) - want)
        assert d.max() <= 1 and (d > 0).mean() <= 0.02, \
            (dt, d.max(), (d > 0).mean())
        # not clipped flat: the comparison has something to hold
        assert np.unique(want).size > 32


@pytest.mark.parametrize("int8_head", [True, False])
@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("feat", NEW_WIDTHS)
def test_apply_int8_at_other_widths_matches_jax(feat, r, int8_head):
    """The port's apply_int8 (K4a, K4 and K4h's plain versions on the CPU,
    the same functions the wrappers hold the kernels to) against
    reve_tpu's apply_int8 from the same maxima, in float32 and bfloat16,
    at an odd height."""
    _apply_int8_case(feat, r, int8_head, num_conv=2, shape=(2, 9, 14, 3),
                     seed=feat + r)


@pytest.mark.slow
def test_default_student_apply_int8_matches_jax_at_a_production_depth():
    """The default distillation's student (128 features x 16 convs, x2)
    in int8 against reve_tpu's, with the int8 head, at both dtypes."""
    _apply_int8_case(128, 2, True, num_conv=16, shape=(1, 36, 64, 3),
                     seed=7)


# -- the engine ---------------------------------------------------------------


@pytest.mark.parametrize("feat", NEW_WIDTHS)
def test_int8_engine_at_other_widths_matches_jax_engine(monkeypatch, feat):
    """The port's int8 engine at 32, 96 and 128 features against
    reve_tpu's with its calibration: the scales from the same maxima are
    identical and the frames within one u8 step.  Both engines pad a
    calibration sample to a chunk of _CALIB_CHUNK_ELEMS activations; the
    same small budget is set on both, so their chunks correspond."""
    h, w = 12, 17
    for cls in (UpscaleEngine, JaxEngine):
        monkeypatch.setattr(cls, "_CALIB_CHUNK_ELEMS", 4 * h * w * feat)
    jcfg, cfg, jparams = _models(feat, 2, 2, seed=feat)
    mine = UpscaleEngine(device="cpu", compute_dtype="int8", batch_size=2,
                         preloaded=(cfg, srvgg.params_from_jax(jparams)))
    ref = JaxEngine(compute_dtype="int8", batch_size=2,
                    preloaded=(jcfg, jparams))
    frames = _u8((3, h, w, 3), seed=feat)
    want = np.asarray(ref.upscale_frames(frames))
    mine.set_calibration(ref.get_calibration())
    got = mine.upscale_frames(frames)
    assert got.shape == want.shape == (3, 2 * h, 2 * w, 3)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    jq = jquantize.quantize_hidden(ref.params, ref.cfg,
                                   ref.get_calibration(), margin=1.25)
    np.testing.assert_array_equal(mine._qbody.act_scale.numpy(),
                                  np.asarray(jq.act_scale))
    for got_w, want_w in zip(mine._qbody.w8, jq.w8):
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


# -- the packers ----------------------------------------------------------------


def _w8(cin, cout, seed):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        -127, 128, (3, 3, cin, cout)).astype(np.int8))


@pytest.mark.parametrize("cin, cout", S8_PAIRS)
def test_s8_weight_packer_at_any_cin(cin, cout):
    """pack_weights_s8: packed[t, kb, n, kk] = w8[t // 3, t % 3, 16 kb +
    kk, n] for n < Cout, 0 above (N = Cout padded to a multiple of 8)."""
    w8 = _w8(cin, cout, cin + cout)
    p = conv3x3_s8.pack_weights_s8(w8)
    n_pad = conv3x3.padded_n(cout)
    assert p.shape == (9, cin // 16, n_pad, 16) and p.dtype == torch.int8
    assert p.is_contiguous()
    rs = np.random.RandomState(cout)
    for t, kb, n, kk in zip(*(rs.randint(0, m, 400) for m in (
            9, cin // 16, n_pad, 16))):
        want = w8[t // 3, t % 3, 16 * kb + kk, n] if n < cout else 0
        assert p[t, kb, n, kk] == want
    assert not p[:, :, cout:].any()


@pytest.mark.parametrize("cin, cout", S8_PAIRS)
def test_s8_wide_weight_packer_matches_its_index_formula(cin, cout):
    """pack_weights_s8_wide: packed[u, t, kb, n, kk] = w8[t // 3, t % 3,
    32 u + 16 kb + kk, n] for n < Cout, 0 above; a unit's nine taps are one
    contiguous run of 9 x 32 x N bytes (the kernel's UNIT_W) and a tap 32
    N bytes (TAP_W)."""
    w8 = _w8(cin, cout, cin * cout)
    p = conv3x3_s8.pack_weights_s8_wide(w8)
    n_pad = conv3x3.padded_n(cout)
    assert p.shape == (cin // 32, 9, 2, n_pad, 16) and p.is_contiguous()
    flat = p.reshape(-1)
    rs = np.random.RandomState(cin)
    for u, t, kb, n, kk in zip(*(rs.randint(0, m, 400) for m in (
            cin // 32, 9, 2, n_pad, 16))):
        want = w8[t // 3, t % 3, 32 * u + 16 * kb + kk, n] \
            if n < cout else 0
        assert p[u, t, kb, n, kk] == want
        at = (u * 9 + t) * 32 * n_pad + (kb * n_pad + n) * 16 + kk
        assert flat[at] == p[u, t, kb, n, kk]
    assert not p[..., cout:, :].any()


# -- the wide K4's and K4h's arithmetic -------------------------------------------


def _wide_s8_sum(x8, w8):
    """The wide forms' product on the CPU, unit by unit and tap by tap as
    the kernel walks it: the unit's 32 channels of the tap-shifted halo
    (zeros outside the frame, as TMA fills them) times the unit-tap of
    pack_weights_s8_wide as its (32, N) B, summed in int64.  Returns the
    (B, H, W, Cout) s32 sum, held to fit s32."""
    B, H, W, cin = x8.shape
    cout = w8.shape[-1]
    n = conv3x3.padded_n(cout)
    xp = F.pad(x8.long(), (0, 0, 1, 1, 1, 1))
    packed = conv3x3_s8.pack_weights_s8_wide(w8).long()
    acc = torch.zeros(B, H, W, n, dtype=torch.long)
    for u in range(cin // conv3x3.WIDE_UNIT):
        for t in range(9):
            dy, dx = t // 3, t % 3
            a = xp[:, dy:dy + H, dx:dx + W, 32 * u:32 * u + 32]
            bm = packed[u, t].permute(0, 2, 1).reshape(32, n)
            acc += a @ bm
    assert acc.abs().max() < 2 ** 31
    return acc[..., :cout].int()


def _dq(acc, scale, b):
    """The epilogues' dequant: float32(acc) * scale, then + b, each a
    float32 op rounded on its own (__fmul_rn, __fadd_rn)."""
    return acc.float() * scale + b


def _k4_emulated(x8, w8, scale, b, alpha, inv):
    """The wide K4: the unit walk, the dequant, PReLU (fy > 0 ? fy : alpha
    * fy) and reve::quant_s8 (round half to even, clipped to +-127)."""
    fy = _dq(_wide_s8_sum(x8, w8), scale, b)
    p = torch.where(fy > 0, fy, alpha * fy)
    return torch.round(p * inv).clamp(-127, 127).to(torch.int8)


def _jax_k4(x8, w8, scale, b, alpha, act_scale_next):
    y32 = jsrvgg._conv3x3_s8(jnp.asarray(x8.numpy()),
                             jnp.asarray(w8.numpy()))
    fy = y32.astype(jnp.float32) * jnp.asarray(scale.numpy()) \
        + jnp.asarray(b.numpy())
    p = jnp.maximum(fy, 0) + jnp.asarray(alpha.numpy()) * jnp.minimum(fy, 0)
    return np.asarray(jsrvgg._quant_s8(p, jnp.asarray(act_scale_next)))


def _k4_case(feat, kind, seed):
    """(x8, w8, scale, b, alpha, act_scale_next) of one K4 layer:
    `ordinary`, codes and scales as a calibrated layer has them;
    `saturated`, codes and weights at +-127, sums past 2^24 at 128
    features and most outputs clipped to +-127; `ties`, small codes with scale 1, b 0
    and act_scale 2, so that every odd sum lands on a quantize tie."""
    rs = np.random.RandomState(seed)
    if kind == "saturated":
        # codes of 127 with a few others, and half the output channels'
        # weights 127 (their interior sums 9 F 127^2 of nearly all
        # aligned products), the other half +-127
        x8 = np.full((2, 7, 9, feat), 127)
        few = rs.rand(*x8.shape) < 0.05
        x8[few] = rs.randint(-127, 128, few.sum())
        w8 = np.full((3, 3, feat, feat), 127)
        w8[..., feat // 2:] = rs.choice([-127, 127],
                                        (3, 3, feat, feat - feat // 2))
        scale = rs.uniform(2e-6, 2e-5, feat)
        b = rs.uniform(-0.1, 0.1, feat)
        act_next = 0.02
    elif kind == "ties":
        x8 = rs.randint(-1, 2, (2, 7, 9, feat))
        w8 = rs.randint(-2, 3, (3, 3, feat, feat))
        scale, b, act_next = np.ones(feat), np.zeros(feat), 2.0
    else:
        x8 = rs.randint(-127, 128, (2, 7, 9, feat))
        w8 = rs.randint(-127, 128, (3, 3, feat, feat))
        scale = rs.uniform(2e-6, 2e-5, feat)
        b = rs.uniform(-0.1, 0.1, feat)
        act_next = 0.02
    alpha = rs.uniform(0.05, 0.4, feat)
    if kind == "ties":
        alpha[:] = 0.5  # alpha * fy: halves, ties again below zero
    return (torch.from_numpy(x8.astype(np.int8)),
            torch.from_numpy(w8.astype(np.int8)),
            torch.from_numpy(scale.astype(np.float32)),
            torch.from_numpy(b.astype(np.float32)),
            torch.from_numpy(alpha.astype(np.float32)),
            np.float32(act_next))


@pytest.mark.parametrize("kind", ["ordinary", "saturated", "ties"])
@pytest.mark.parametrize("feat", NEW_WIDTHS)
def test_wide_k4_emulation_matches_jax(feat, kind):
    """The wide K4's unit walk and epilogue against reve_tpu's
    `_conv3x3_s8` + `dq_prelu` + `_quant_s8`: exact, also at +-127 codes
    (s32 sums past 2^24 at 128 features, whose float32 conversion rounds
    to nearest even on both sides) and at the quantize's ties (half to
    even, not away from zero); and the wrapper on CPU tensors (the plain
    version the card's kernel is held to) gives the same codes."""
    x8, w8, scale, b, alpha, act_next = _k4_case(feat, kind, feat)
    inv = 1.0 / torch.tensor([act_next])  # float32, as apply_int8 forms it
    got = _k4_emulated(x8, w8, scale, b, alpha, inv)
    want = _jax_k4(x8, w8, scale, b, alpha, act_next)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        conv3x3_s8.conv3x3_s8_dq_prelu_q8(x8, w8, scale, b, alpha,
                                          inv).numpy(), want)
    acc = _wide_s8_sum(x8, w8)
    if kind == "saturated":
        assert (np.abs(want) == 127).mean() > 0.5
        if feat == 128:
            assert acc.abs().max() > 2 ** 24
    if kind == "ties":
        p = torch.where(acc.float() > 0, acc.float(), 0.5 * acc.float())
        half = (p * 0.5) - torch.floor(p * 0.5) == 0.5
        assert half.float().mean() > 0.2  # ties, both signs
        # half to even differs from half away from zero on them
        away = torch.sign(p * 0.5) * torch.floor(torch.abs(p * 0.5) + 0.5)
        assert (away.clamp(-127, 127).to(torch.int8).numpy() != want).any()


@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("feat", NEW_WIDTHS)
def test_wide_k4h_emulation_matches_jax_head(feat, r):
    """The wide K4h: the unit walk at N = 3r^2 padded to 16, 32, 48, the
    float32 dequant with no cast, then the residual, u8 rounding and pixel
    shuffle, against reve_tpu's int8 head (apply_int8's `_conv3x3_s8` *
    (act_scale * sw_last) + b_last, `_epilogue(quantize_u8=True)`): exact,
    also with every code at +-127."""
    rs = np.random.RandomState(feat * r)
    cout = 3 * r * r
    cfg = jsrvgg.SRVGGConfig(num_feat=feat, num_conv=1, upscale=r)
    u8 = rs.randint(0, 256, (2, 7, 9, 3)).astype(np.uint8)
    orig = jnp.asarray(u8).astype(jnp.float32) * (1.0 / 255.0)
    for x8 in (rs.randint(-127, 128, (2, 7, 9, feat)),
               rs.choice([-127, 127], (2, 7, 9, feat))):
        x8 = torch.from_numpy(x8.astype(np.int8))
        w8 = _w8(feat, cout, feat + r)
        scale = torch.from_numpy(rs.uniform(1e-8, 1e-7, cout).astype(
            np.float32))
        b = torch.from_numpy(rs.uniform(-0.1, 0.1, cout).astype(np.float32))
        got = head.residual_u8_plain(_dq(_wide_s8_sum(x8, w8), scale, b),
                                     torch.from_numpy(u8), r)
        jh = (jsrvgg._conv3x3_s8(jnp.asarray(x8.numpy()),
                                 jnp.asarray(w8.numpy())).astype(jnp.float32)
              * jnp.asarray(scale.numpy()) + jnp.asarray(b.numpy()))
        want = np.asarray(jsrvgg._epilogue(jh, orig, cfg, quantize_u8=True))
        assert got.shape == want.shape == (2, 7 * r, 9 * r, 3)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            head.head_conv_s8_residual_u8_shuffle(
                x8, w8, scale, b, torch.from_numpy(u8), r).numpy(), want)
        assert np.unique(want).size > 32
