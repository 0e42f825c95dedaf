"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a CUDA device (the
kernels have no CPU mode; their plain versions are held to the JAX
package by test_torch_kernels.py).  This file imports neither jax nor
reve_tpu, so it runs on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

Every conv runs on the tensor cores: K1 and K2 (both dtypes), K4 and K4h
(csrc/conv3x3_tc.cu, csrc/conv3x3_f32_tc.cu, csrc/conv3x3_s8.cu; tiles of
conv3x3.TC_TILE pixels, K4 and K4h of 2 x 64), and K3 and K4a (both
compute dtypes, csrc/conv3x3.cu; tiles of 1 x 64, the output by TMA
stores): they are held at the tile edges, ragged and whole, and at large
activations; K4 at each of its nine taps alone; K3 and K4a also at a
batch of 4 1080p frames, far more tiles than the persistent grid's
blocks, so each block's staging buffers serve many stores.

Tolerances: float32 max |d| <= 1e-4 (float32 accumulation order; float32
K1 sums six bf16 products on the tensor cores, which add in their own
order), scaled with the inputs at +-2^8 activations; the split pass
exact;
bfloat16 <= 2 bf16 ulp relative (the kernel and the plain version may
round a float32 sum that differs in its last bits to neighbouring bf16
values, and PReLU rounds once more), the ulp taken at 2^-10 or more (a
sum that cancels to near zero may change sign between two summation
orders); uint8 |d| <= 1.  The int8 kernels: K4 exact (integer sums, the
same float32 epilogue); K4a |d| <= 1 s8 code, in both compute dtypes (its
float conv sums in another order before the quantize, so a value near a
rounding boundary may land on the next code); K4h exact (integer sums,
the same
float32 epilogue); P1 s8 exact, bf16 within 1e-4 of the largest |value|
(its float32 sum is sum(even dots) + sum(odd dots), each dot's k steps
added in order).
float32 K2 sums six bf16 products like float32 K1: u8 |d| <= 1, at
ordinary and at +-2^8 activations.  K7 (csrc/rrdb.cu, RRDB's dense
convs): float32 max |d| <= 2e-6 at the model's weight scale (0.1 /
sqrt(9 Cin)) and activations in [-1, 1], scaled with the inputs at
+-2^8; bfloat16 <= 2 bf16 ulp of the largest operand of its epilogue
(the conv value, its residuals, the result): a residual add can cancel,
so a conv value rounded to the neighbouring bf16 lands on a result near
zero.  K7q (csrc/rrdb_s8.cu, RRDB's int8 dense convs): exact (s8 codes
and float outputs; integer sums and the same float32 steps) at the
ragged edges of its tiles (8 x 64 at Cout 32, 4 x 64 at 64), also past
|acc| = 2^24 and at the quantize's clip; its TMA-stored s8 codes land in
their Cout channels only, and a build off its register budget refuses
to launch; the int8 RRDB model u8 |d| <= 1
(its bf16 conv_first and head sum in another order) and one call's peak
memory within the engine's bill.  conv_last in both dtypes (bfloat16:
K2's conv_last mode; float32: csrc/conv_last_f32.cu, float32 FMAs, at the
edges of its 64 x 64 work items and at +-2^8 activations): u8 |d| <= 1,
and no split pass.  K6 (csrc/tta.cu) moves bytes and adds
integers: exact, for each of the 8 transforms and its three forms, on
ragged shapes and batches.  The engine's halo tiles are byte-identical to
its whole frames on the card in bfloat16, float32 and int8 (the kernels
compute each output pixel by the same sum wherever it sits), and its TTA
ensemble equals the manual one and is exactly dihedral-equivariant.
K3 at Cin 12 (RRDB x2's conv_first, csrc/conv3x3.cu at R = 2): at K3's
tolerances in both dtypes, at its tile edges on even frames, and it
refuses odd ones; the RRDB x2 model on the card against its plain path
(float32 u8 |d| <= 1, bfloat16 >= 50 dB, int8 u8 |d| <= 1), and its
engine's halo windows byte-identical to the windows run whole.
T1-T3 (the training path's float32 convs, on bf16 wgmma as six products
of their split operands, csrc/conv3x3_train_tc.cu) at every channel pair
they take, on a
ragged pixel count, a step's 8 x 64 x 64 and the edges of the 2 x 64
tiles (1 x 1 x 1, 3 x 7 x 63, 1 x 65 x 129): max |d| <= 1e-5 of the
plain version's largest |value| (float32 sums in another order, up to
1,728 taps x channels or every pixel of the batch), T2 and T3 at the
other shapes against the plain versions in float64 (the float32 plain
weight gradient's own sums drift to 2.6e-5 of its largest value over
32,768 pixels: H100 run, float64 reference), with z exactly 0 at some pixels
(PReLU' = (1 + alpha) / 2 there); T1, T2 and T3 bit-identical run to
run; T2 also with weights scaled differently at each tap and each
32-channel unit of Cout (a wrong mirror or unit offset is exact at the
centre tap only); each of the 27 kernels holds wgmma (HGMMA) and no TF32
or float atomic; the conv stack's gradients on the kernels against torch
autograd through F.conv2d on a 2-conv model, at the same tolerance.
K4a, K4 and K4h at 32, 96 and 128 features (K4 and K4h
csrc/conv3x3_s8_wide.cuh, 4 x 64 tiles over units of 32 input channels
in the 32-B swizzle; K4a K3's template with the s8 epilogue): K4 and K4h
exact, K4a within 1 s8 code, at the tile edges, at 1080p, at codes and
weights of +-127 (sums past 2^24 at 128 features) and, for K4, at each
tap alone; the int8 model at each width >= 60 dB against its plain
path; the 64-feature int8 forms' outputs equal to their bytes before
the wide forms (sha256 of perf_conv_widths' seeded forms); a planned
float32 call of a 128-feature SRVGG peaks within the memory plan's bill,
which holds each K1's and K2's split planes.
K9 (csrc/color.cu, the engine's output to the writers' YUV 4:2:0
codes): exact (n_diff 0) against its plain version in all 8 forms, at
ragged and frame-sized shapes, its byte and vector forms; no contracted
multiply-add in its PTX or SASS; a y4m job on the card writes its planes
and the RGB route's bytes.
"""

import os

import numpy as np
import pytest
import torch

from reve_tpu_torch.kernels import (LAUNCHES, conv3x3, conv3x3_s8,
                                    dot_probe, head, rrdb as k7, train, tta)
from reve_tpu_torch.kernels import color as color_k
from reve_tpu_torch.ops.color_np import YUVFormat
from reve_tpu_torch.models import rrdb, srvgg
from reve_tpu_torch.pipeline.engine import UpscaleEngine
from reve_tpu_torch.weights import quantize

torch.set_num_threads(2)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _inputs(seed, B, H, W, cin=64, cout=64):
    rs = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(9 * cin)
    return {
        "x": torch.from_numpy(rs.rand(B, H, W, cin).astype(np.float32)
                              * 2 - 0.5),
        "u8": torch.from_numpy(rs.randint(0, 256, (B, H, W, 3)).astype(
            np.uint8)),
        "w": torch.from_numpy(rs.uniform(-bound, bound, (3, 3, cin, cout))
                              .astype(np.float32)),
        "b": torch.from_numpy(rs.uniform(-0.1, 0.1, (cout,)).astype(
            np.float32)),
        "alpha": torch.from_numpy(rs.uniform(0.05, 0.4, (cout,)).astype(
            np.float32)),
    }


def _close(got, want, name, floor=2.0 ** -10):
    if name == "float32":
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        return
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(floor)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert bool(((g - w).abs() <= 2 * ulp).all()), (g - w).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(19, 45), (8, 32), (1, 1)])
@pytest.mark.parametrize("name", list(DTYPES))
def test_conv_kernels_match_plain(name, hw):
    dev = _cuda()
    dt = DTYPES[name]
    d = _inputs(0, 2, *hw)
    x, w = d["x"].to(dev, dt), d["w"].to(dev, dt)
    b, a, u8 = d["b"].to(dev), d["alpha"].to(dev), d["u8"].to(dev)
    w3 = w[:, :, :3].contiguous()
    before = dict(LAUNCHES)
    _close(conv3x3.conv3x3_bias_prelu(x, w, b, a),
           conv3x3.conv3x3_bias_prelu_plain(x, w, b, a), name)
    _close(conv3x3.conv3x3_u8_bias_prelu(u8, w3, b, a),
           conv3x3.conv3x3_u8_bias_prelu_plain(u8, w3, b, a), name)
    torch.cuda.synchronize()
    assert LAUNCHES["conv3x3_bias_prelu"] == \
        before["conv3x3_bias_prelu"] + 1
    assert LAUNCHES["conv3x3_u8_bias_prelu"] == \
        before["conv3x3_u8_bias_prelu"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("name", list(DTYPES))
def test_head_kernel_matches_plain(name, r):
    dev = _cuda()
    dt = DTYPES[name]
    d = _inputs(r, 2, 21, 70, cout=3 * r * r)
    h = d["x"].clamp_min(0).to(dev, dt)
    w, b, u8 = d["w"].to(dev, dt), d["b"].to(dev), d["u8"].to(dev)
    before = LAUNCHES["head_conv_residual_u8_shuffle"]
    got = head.head_conv_residual_u8_shuffle(h, w, b, u8, r)
    want = head.head_conv_residual_u8_shuffle_plain(h, w, b, u8, r)
    torch.cuda.synchronize()
    assert got.shape == (2, 21 * r, 70 * r, 3) and got.dtype == torch.uint8
    assert (got.int() - want.int()).abs().max().item() <= 1
    assert LAUNCHES["head_conv_residual_u8_shuffle"] == before + 1


# tile-edge shapes of the tensor-core kernels (conv3x3.TC_TILE = TH x TW):
# a lone pixel, ragged tiles, one whole tile, one tile plus a row and a
# column, and a full-width strip of 30 tiles
TC_SHAPES = [(1, 1), (19, 45), conv3x3.TC_TILE,
             (conv3x3.TC_TILE[0] + 1, conv3x3.TC_TILE[1] + 1), (8, 1920)]


@pytest.mark.cuda
@pytest.mark.parametrize("hw", TC_SHAPES)
@pytest.mark.parametrize("B", [1, 3])
def test_tensor_core_k1_matches_plain_at_tile_edges(B, hw):
    dev = _cuda()
    d = _inputs(7, B, *hw)
    x, w = d["x"].to(dev, torch.bfloat16), d["w"].to(dev, torch.bfloat16)
    b, a = d["b"].to(dev), d["alpha"].to(dev)
    before = LAUNCHES["conv3x3_bias_prelu"]
    got = conv3x3.conv3x3_bias_prelu(x, w, b, a)
    want = conv3x3.conv3x3_bias_prelu_plain(x, w, b, a)
    torch.cuda.synchronize()
    assert got.shape == (B, *hw, 64) and got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")
    assert LAUNCHES["conv3x3_bias_prelu"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("hw", TC_SHAPES)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("r", [2, 3, 4])
def test_tensor_core_k2_matches_plain_at_tile_edges(r, B, hw):
    dev = _cuda()
    d = _inputs(10 + r, B, *hw, cout=3 * r * r)
    h = d["x"].clamp_min(0).to(dev, torch.bfloat16)
    w, b = d["w"].to(dev, torch.bfloat16), d["b"].to(dev)
    u8 = d["u8"].to(dev)
    before = LAUNCHES["head_conv_residual_u8_shuffle"]
    got = head.head_conv_residual_u8_shuffle(h, w, b, u8, r)
    want = head.head_conv_residual_u8_shuffle_plain(h, w, b, u8, r)
    torch.cuda.synchronize()
    assert got.shape == (B, hw[0] * r, hw[1] * r, 3)
    assert (got.int() - want.int()).abs().max().item() <= 1
    assert LAUNCHES["head_conv_residual_u8_shuffle"] == before + 1


@pytest.mark.cuda
def test_tensor_core_kernels_at_large_activations():
    """Activations up to +-2^8: the float32 epilogues (bias, PReLU, the
    residual, the u8 clip) see sums far from the usual range."""
    dev = _cuda()
    d = _inputs(21, 2, 19, 45)
    x = ((d["x"] - 0.5) * 2 ** 8).to(dev, torch.bfloat16)
    w, b, a = d["w"].to(dev, torch.bfloat16), d["b"].to(dev), \
        d["alpha"].to(dev)
    # the ulp floor scales with the inputs: a sum of 576 products of
    # 2^8 times the usual size carries 2^8 times the order noise
    _close(conv3x3.conv3x3_bias_prelu(x, w, b, a),
           conv3x3.conv3x3_bias_prelu_plain(x, w, b, a), "bfloat16",
           floor=2.0 ** -2)
    dh = _inputs(22, 2, 19, 45, cout=48)
    wh, bh = dh["w"].to(dev, torch.bfloat16), dh["b"].to(dev)
    u8 = dh["u8"].to(dev)
    got = head.head_conv_residual_u8_shuffle(x, wh, bh, u8, 4)
    want = head.head_conv_residual_u8_shuffle_plain(x, wh, bh, u8, 4)
    torch.cuda.synchronize()
    assert (got.int() - want.int()).abs().max().item() <= 1
    # most outputs clip at 0 or 255 at this range
    assert ((got == 0) | (got == 255)).float().mean().item() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("hw", TC_SHAPES)
@pytest.mark.parametrize("B", [1, 3])
def test_f32_tensor_core_k1_matches_plain_at_tile_edges(B, hw):
    dev = _cuda()
    d = _inputs(8, B, *hw)
    x, w = d["x"].to(dev), d["w"].to(dev)
    b, a = d["b"].to(dev), d["alpha"].to(dev)
    before = dict(LAUNCHES)
    got = conv3x3.conv3x3_bias_prelu(x, w, b, a)
    want = conv3x3.conv3x3_bias_prelu_plain(x, w, b, a)
    torch.cuda.synchronize()
    assert got.shape == (B, *hw, 64) and got.dtype == torch.float32
    _close(got, want, "float32")
    # one float32 K1 call is the split pass and the bf16x6 conv
    assert LAUNCHES["conv3x3_bias_prelu"] == \
        before["conv3x3_bias_prelu"] + 1
    assert LAUNCHES["split_bf16x3"] == before["split_bf16x3"] + 1


@pytest.mark.cuda
def test_f32_tensor_core_k1_at_large_activations():
    """Activations up to +-2^8: float32 K1 stays within the float32
    tolerance scaled by the inputs (a sum of 576 products 2^8 times the
    usual size carries 2^8 times the order noise)."""
    dev = _cuda()
    d = _inputs(23, 2, 19, 45)
    x = ((d["x"] - 0.5) * 2 ** 8).to(dev)
    w, b, a = d["w"].to(dev), d["b"].to(dev), d["alpha"].to(dev)
    got = conv3x3.conv3x3_bias_prelu(x, w, b, a)
    want = conv3x3.conv3x3_bias_prelu_plain(x, w, b, a)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4 * 2 ** 8, rtol=0)
    assert want.abs().max().item() > 2 ** 6  # the range was reached


@pytest.mark.cuda
def test_split_pass_is_exact():
    """The split pass gives the plain version's planes bit for bit, and
    they add back to the input, at ordinary values, +-2^8, +-2^-20 and
    zeros."""
    dev = _cuda()
    rs = np.random.RandomState(4)
    x = rs.standard_normal((2, 5, 7, 64)).astype(np.float32)
    x[0, 0] = 2.0 ** 8 * rs.choice([-1, 1], 64)
    x[0, 1] = 2.0 ** -20 * rs.uniform(-1, 1, 64)
    x[0, 2] = 0.0
    x = torch.from_numpy(x).to(dev)
    before = LAUNCHES["split_bf16x3"]
    got = conv3x3.split_bf16x3(x)
    want = conv3x3.split_bf16x3_plain(x)
    torch.cuda.synchronize()
    assert got.shape == (3, *x.shape) and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    back = got[0].float() + got[1].float() + got[2].float()
    assert torch.equal(back, x)
    assert LAUNCHES["split_bf16x3"] == before + 1


@pytest.mark.cuda
def test_split_pass_of_a_channel_slice_is_exact():
    """The split pass over the leading Cin channels of 192-channel pixels
    (float32 K7's input: rows of Cin values 192 apart) and over a
    contiguous tensor whose last dim is not a multiple of 8 (a flat run)
    gives the plain version's planes bit for bit."""
    dev = _cuda()
    rs = np.random.RandomState(5)
    buf = torch.from_numpy(rs.standard_normal((2, 5, 7, 192)).astype(
        np.float32)).to(dev)
    cases = [buf[..., :cin] for cin in (64, 96, 128, 160, 192)]
    cases.append(torch.from_numpy(rs.standard_normal((10, 4)).astype(
        np.float32)).to(dev))
    for x in cases:
        before = LAUNCHES["split_bf16x3"]
        got = conv3x3.split_bf16x3(x)
        want = conv3x3.split_bf16x3_plain(x)
        torch.cuda.synchronize()
        assert got.shape == (3, *x.shape)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        assert LAUNCHES["split_bf16x3"] == before + 1


@pytest.mark.cuda
def test_model_kernels_match_plain_path():
    dev = _cuda()
    cfg = srvgg.SRVGGConfig(num_feat=64, num_conv=3, upscale=4)
    params = srvgg.params_to(srvgg.init_params(cfg), dev)
    u8 = _inputs(5, 2, 17, 33)["u8"].to(dev)
    got = srvgg.apply(params, u8, cfg=cfg, compute_dtype=torch.float32)
    want = srvgg.apply(params, u8, cfg=cfg, compute_dtype=torch.float32,
                       plain=True)
    assert (got.int() - want.int()).abs().max().item() <= 1


#: the SRVGG widths besides 64 that K3, K1 and K2 take
#: (csrc/conv3x3_wide.cuh for K1 and K2, K3's template at Cout F)
WIDE_FEATS = (32, 96, 128)


def _width_forms(d, dev, dt, feat, scale=1.0):
    """(name, kernel call, plain call) of K3, K1 and K2 at x2, x3, x4 on
    `d` (seeded at Cin = Cout = feat), in `dt`."""
    x = ((d["x"] - 0.5) * scale + 0.5).to(dev, dt) if scale != 1.0 else \
        d["x"].to(dev, dt)
    w, b, a, u8 = d["w"].to(dev, dt), d["b"].to(dev), d["alpha"].to(dev), \
        d["u8"].to(dev)
    w3 = w[:, :, :3].contiguous()
    h = x.clamp_min(0)
    forms = [("conv3x3_u8_bias_prelu",
              lambda: conv3x3.conv3x3_u8_bias_prelu(u8, w3, b, a),
              lambda: conv3x3.conv3x3_u8_bias_prelu_plain(u8, w3, b, a)),
             ("conv3x3_bias_prelu",
              lambda: conv3x3.conv3x3_bias_prelu(x, w, b, a),
              lambda: conv3x3.conv3x3_bias_prelu_plain(x, w, b, a))]
    # the heads' weights from the conv's, doubled along Cout for Cout 48
    # at 32 features
    w2, b2 = torch.cat([w, w.flip(-1)], -1), torch.cat([b, b.flip(-1)])
    for r in (2, 3, 4):
        wh = w2[..., :3 * r * r].contiguous()
        bh = b2[:3 * r * r].contiguous()
        forms.append(("head_conv_residual_u8_shuffle",
                      lambda wh=wh, bh=bh, r=r:
                      head.head_conv_residual_u8_shuffle(h, wh, bh, u8, r),
                      lambda wh=wh, bh=bh, r=r:
                      head.head_conv_residual_u8_shuffle_plain(
                          h, wh, bh, u8, r)))
    return forms


def _hold_width_forms(forms, name, floor=2.0 ** -10, atol=1e-4):
    for kname, kernel, plain in forms:
        before = dict(LAUNCHES)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype
        if got.dtype == torch.uint8:
            assert (got.int() - want.int()).abs().max().item() <= 1, kname
        elif name == "float32":
            torch.testing.assert_close(got, want, atol=atol, rtol=0)
        else:
            _close(got, want, name, floor=floor)
        # one launch of the form (float32 K1 and K2: and their split pass)
        assert LAUNCHES[kname] == before[kname] + 1
        split = name == "float32" and kname != "conv3x3_u8_bias_prelu"
        assert LAUNCHES["split_bf16x3"] == before["split_bf16x3"] + split


@pytest.mark.cuda
@pytest.mark.parametrize("hw", TC_SHAPES)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("feat", WIDE_FEATS)
def test_width_kernels_match_plain_at_tile_edges(feat, name, B, hw):
    """K3, K1 and K2 at x2, x3, x4 at 32, 96 and 128 features against
    their plain versions at the tile edges (K1 and K2: 4 x 64 tiles, 2 x
    64 in float32 at 96 and 128; K3: rows of 64), to the 64-feature
    forms' tolerances."""
    dev = _cuda()
    d = _inputs(feat + B, B, *hw, cin=feat, cout=feat)
    _hold_width_forms(_width_forms(d, dev, DTYPES[name], feat), name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("feat", WIDE_FEATS)
def test_width_kernels_match_plain_at_1080p(feat, name):
    """... on a 1080p frame: far more tiles than the persistent grid's
    blocks, so every halo slot and weight stage is reused many times."""
    dev = _cuda()
    d = _inputs(feat, 1, 1080, 1920, cin=feat, cout=feat)
    _hold_width_forms(_width_forms(d, dev, DTYPES[name], feat), name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("feat", WIDE_FEATS)
def test_width_kernels_at_large_activations(feat, name):
    """Activations up to +-2^8 at the wide widths: the tolerance scales
    with the inputs (a sum of 9 F products 2^8 times the usual size
    carries 2^8 times the order noise)."""
    dev = _cuda()
    d = _inputs(feat + 5, 2, 19, 45, cin=feat, cout=feat)
    forms = _width_forms(d, dev, DTYPES[name], feat, scale=2.0 ** 8)
    _hold_width_forms(forms[1:], name, floor=2.0 ** -2, atol=1e-4 * 2 ** 8)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("feat", WIDE_FEATS)
def test_width_model_matches_plain_path(feat, r):
    """A whole SRVGG at 32, 96 and 128 features on the kernels against
    its plain path: float32 u8 |d| <= 1, bfloat16 at the engine's 50 dB
    floor against the plain bf16 path; the launches 1 K3, num_conv K1
    and 1 K2."""
    dev = _cuda()
    cfg = srvgg.SRVGGConfig(num_feat=feat, num_conv=2, upscale=r)
    params = srvgg.params_to(srvgg.init_params(
        cfg, torch.Generator().manual_seed(feat + r)), dev)
    u8 = _inputs(5, 2, 17, 70)["u8"].to(dev)
    for name, dt in DTYPES.items():
        before = dict(LAUNCHES)
        got = srvgg.apply(params, u8, cfg=cfg, compute_dtype=dt)
        torch.cuda.synchronize()
        assert {k: LAUNCHES[k] - before[k] for k in (
            "conv3x3_u8_bias_prelu", "conv3x3_bias_prelu",
            "head_conv_residual_u8_shuffle")} == {
                "conv3x3_u8_bias_prelu": 1, "conv3x3_bias_prelu": 2,
                "head_conv_residual_u8_shuffle": 1}
        want = srvgg.apply(params, u8, cfg=cfg, compute_dtype=dt,
                           plain=True)
        d = (got.int() - want.int()).abs()
        if name == "float32":
            assert d.max().item() <= 1
        else:
            mse = (d.double() ** 2).mean().item()
            assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 50.0


@pytest.mark.cuda
def test_width_wrappers_reject_what_the_kernels_do_not_take():
    """A width none of the kernels take (48), and K1 of Cin != Cout, are
    refused before a launch."""
    dev = _cuda()
    before = dict(LAUNCHES)
    for dt in DTYPES.values():
        x = torch.zeros((1, 4, 8, 48), device=dev, dtype=dt)
        with pytest.raises(ValueError, match="features"):
            conv3x3.conv3x3_bias_prelu(
                x, torch.zeros((3, 3, 48, 48), device=dev, dtype=dt),
                torch.zeros(48), torch.zeros(48))
        with pytest.raises(ValueError, match="features"):
            conv3x3.conv3x3_u8_bias_prelu(
                torch.zeros((1, 4, 8, 3), device=dev, dtype=torch.uint8),
                torch.zeros((3, 3, 3, 48), device=dev, dtype=dt),
                torch.zeros(48), torch.zeros(48))
        with pytest.raises(ValueError, match="features"):
            head.head_conv_residual_u8_shuffle(
                x, torch.zeros((3, 3, 48, 12), device=dev, dtype=dt),
                torch.zeros(12), torch.zeros((1, 4, 8, 3), device=dev,
                                             dtype=torch.uint8), 2)
        with pytest.raises(ValueError, match="expected"):
            conv3x3.conv3x3_bias_prelu(
                torch.zeros((1, 4, 8, 96), device=dev, dtype=dt),
                torch.zeros((3, 3, 96, 128), device=dev, dtype=dt),
                torch.zeros(128), torch.zeros(128))
    assert LAUNCHES == before


def _width_int8_forms(seed, B, H, W, feat, edge=False):
    """(name, kernel call, plain call) of K4a (both compute dtypes), K4
    and K4h at x2, x3, x4 at `feat` features on seeded inputs: s8 codes
    and weights uniform in [-127, 127], K4's scale 2e-6..2e-5 and K4h's
    1e-8..1e-7.  `edge`: codes and weights at the s8 range's ends (all
    127 but a few, and half the output channels' weights 127: interior
    sums of 9 F 127^2, past 2^24 at 128 features), most K4 outputs
    clipped to +-127, and K4a's inv large enough to clip its codes at
    both ends."""
    dev = _cuda()
    rs = np.random.RandomState(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(dev, dt)

    if edge:
        x8 = np.full((B, H, W, feat), 127)
        few = rs.rand(*x8.shape) < 0.05
        x8[few] = rs.randint(-127, 128, few.sum())
        w8 = np.full((3, 3, feat, feat), 127)
        w8[..., feat // 2:] = rs.choice([-127, 127],
                                        (3, 3, feat, feat - feat // 2))
    else:
        x8 = rs.randint(-127, 128, (B, H, W, feat))
        w8 = rs.randint(-127, 128, (3, 3, feat, feat))
    x8, w8 = t(x8, torch.int8), t(w8, torch.int8)
    u8 = t(rs.randint(0, 256, (B, H, W, 3)), torch.uint8)
    w3 = t(rs.uniform(-0.3, 0.3, (3, 3, 3, feat)))
    b, a = t(rs.uniform(-0.1, 0.1, feat)), t(rs.uniform(0.05, 0.4, feat))
    scale = t(rs.uniform(2e-6, 2e-5, feat))
    inv = torch.tensor([1 / (0.002 if edge else 0.01)], device=dev)
    inv8 = torch.tensor([1 / 0.02], device=dev)
    forms = []
    for dt in DTYPES.values():
        forms.append(("conv3x3_u8_bias_prelu_q8",
                      lambda w=w3.to(dt): conv3x3.conv3x3_u8_bias_prelu_q8(
                          u8, w, b, a, inv),
                      lambda w=w3.to(dt):
                      conv3x3.conv3x3_u8_bias_prelu_q8_plain(
                          u8, w, b, a, inv)))
    forms.append(("conv3x3_s8_dq_prelu_q8",
                  lambda: conv3x3_s8.conv3x3_s8_dq_prelu_q8(
                      x8, w8, scale, b, a, inv8),
                  lambda: conv3x3_s8.conv3x3_s8_dq_prelu_q8_plain(
                      x8, w8, scale, b, a, inv8)))
    for r in (2, 3, 4):
        wh = t(rs.randint(-127, 128, (3, 3, feat, 3 * r * r)), torch.int8)
        sh = t(rs.uniform(1e-8, 1e-7, 3 * r * r))
        bh = t(rs.uniform(-0.1, 0.1, 3 * r * r))
        forms.append(("head_conv_s8_residual_u8_shuffle",
                      lambda wh=wh, sh=sh, bh=bh, r=r:
                      head.head_conv_s8_residual_u8_shuffle(
                          x8, wh, sh, bh, u8, r),
                      lambda wh=wh, sh=sh, bh=bh, r=r:
                      head.head_conv_s8_residual_u8_shuffle_plain(
                          x8, wh, sh, bh, u8, r)))
    return forms


def _hold_width_int8_forms(forms):
    """K4 and K4h exact, K4a within 1 s8 code on a few values (its float
    conv sums in another order before the quantize); one launch each."""
    for kname, kernel, plain in forms:
        before = LAUNCHES[kname]
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype, kname
        if kname == "conv3x3_u8_bias_prelu_q8":
            _u8_close(got, want, None, True)
        else:
            assert torch.equal(got, want), kname
        assert LAUNCHES[kname] == before + 1, kname
        del got, want


@pytest.mark.cuda
@pytest.mark.parametrize("hw", TC_SHAPES)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("feat", WIDE_FEATS)
def test_width_int8_kernels_match_plain_at_tile_edges(feat, B, hw):
    """K4a, K4 and K4h (x2, x3, x4) at 32, 96 and 128 features against
    their plain versions at the tile edges (K4 and K4h: 4 x 64 tiles, K4a
    rows of 64): K4 and K4h exact, K4a within 1 s8 code."""
    _hold_width_int8_forms(_width_int8_forms(feat + B + hw[1], B, *hw,
                                             feat))


@pytest.mark.cuda
@pytest.mark.parametrize("feat", WIDE_FEATS)
def test_width_int8_kernels_match_plain_at_1080p(feat):
    """... on a 1080p frame: far more tiles than the persistent grid's
    blocks, so every halo slot (and at 128 features every streamed weight
    unit) is reused many times."""
    _hold_width_int8_forms(_width_int8_forms(feat, 1, 1080, 1920, feat))


@pytest.mark.cuda
@pytest.mark.parametrize("feat", WIDE_FEATS)
def test_width_int8_kernels_at_the_s8_edges(feat):
    """Codes and weights at +-127 (2^7's edge): K4's s32 sums past 2^24 at
    128 features (their float32 conversion rounds to nearest even in the
    kernel and in torch alike) and its codes clipped at +-127, K4a's
    codes clipped at both ends; exact (K4a within 1 code)."""
    forms = _width_int8_forms(feat + 1, 2, 19, 45, feat, edge=True)
    _hold_width_int8_forms(forms)
    k4 = next(f for f in forms if f[0] == "conv3x3_s8_dq_prelu_q8")
    y = k4[1]()
    assert (y.abs() == 127).float().mean().item() > 0.5
    q = forms[0][1]()
    assert bool((q == 127).any()) and bool((q == -127).any())
    if feat == 128:
        x8 = torch.full((1, 3, 3, feat), 127, dtype=torch.int8,
                        device=y.device)
        w8 = torch.full((3, 3, feat, feat), 127, dtype=torch.int8,
                        device=y.device)
        assert int(conv3x3_s8.conv3x3_s8_plain(x8, w8).max()) > 2 ** 24


@pytest.mark.cuda
@pytest.mark.parametrize("tap", range(9))
@pytest.mark.parametrize("feat", WIDE_FEATS)
def test_width_k4_each_tap_alone_under_the_32b_swizzle(feat, tap):
    """Weights nonzero at one tap only: the A operand of tap (dy, dx) is
    the unit's halo started dy * 66 + dx 32-B rows later in the 32-B
    swizzle, and each start must read what TMA wrote (ragged shape,
    exact)."""
    dev = _cuda()
    rs = np.random.RandomState(tap)
    x8 = torch.from_numpy(rs.randint(-127, 128, (2, 19, 45, feat)).astype(
        np.int8)).to(dev)
    w8 = torch.zeros((3, 3, feat, feat), dtype=torch.int8, device=dev)
    w8[tap // 3, tap % 3] = torch.from_numpy(rs.randint(
        -127, 128, (feat, feat)).astype(np.int8)).to(dev)
    f = torch.full((feat,), 0.2, device=dev)
    scale = torch.full((feat,), 2e-5, device=dev)
    inv = torch.tensor([1 / 0.02], device=dev)
    got = conv3x3_s8.conv3x3_s8_dq_prelu_q8(x8, w8, scale, f, f, inv)
    want = conv3x3_s8.conv3x3_s8_dq_prelu_q8_plain(x8, w8, scale, f, f,
                                                   inv)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert want.unique().numel() > 64  # not clipped flat


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("feat", WIDE_FEATS)
def test_width_int8_model_matches_plain_path(feat, r):
    """A whole int8 SRVGG at 32, 96 and 128 features on K4a, K4 and K4h
    against its plain path, quantized from its own float32 calibration on
    the card: >= 60 dB in both compute dtypes (a K4a code that differs by
    one may move later codes), with the int8 head exact wherever K4a's
    codes agree; the launches 1 K4a, num_conv K4 and 1 K4h."""
    dev = _cuda()
    cfg = srvgg.SRVGGConfig(num_feat=feat, num_conv=2, upscale=r)
    params = srvgg.params_to(srvgg.init_params(
        cfg, torch.Generator().manual_seed(feat + r)), dev)
    u8 = _inputs(7, 2, 17, 70)["u8"].to(dev)
    maxima = quantize.collect_act_maxima(params, u8, cfg=cfg,
                                         percentile=99.9)
    qb = quantize.build_qbody(params, cfg, maxima, margin=1.25)
    for dt in DTYPES.values():
        before = dict(LAUNCHES)
        got = srvgg.apply_int8(params, qb, u8, cfg=cfg, compute_dtype=dt)
        torch.cuda.synchronize()
        assert {k: LAUNCHES[k] - before[k] for k in (
            "conv3x3_u8_bias_prelu_q8", "conv3x3_s8_dq_prelu_q8",
            "head_conv_s8_residual_u8_shuffle")} == {
                "conv3x3_u8_bias_prelu_q8": 1, "conv3x3_s8_dq_prelu_q8": 2,
                "head_conv_s8_residual_u8_shuffle": 1}
        want = srvgg.apply_int8(params, qb, u8, cfg=cfg, compute_dtype=dt,
                                plain=True)
        assert got.shape == want.shape == (2, 17 * r, 70 * r, 3)
        mse = ((got.double() - want.double()) ** 2).mean().item()
        assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 60.0


@pytest.mark.cuda
def test_float32_srvgg_call_peaks_within_its_memory_bill():
    """One planned float32 call of a 128-feature SRVGG (2 frames of 540 x
    960): the memory it allocates above what was allocated before it stays
    within the plan's bill for its frames, which holds the split planes of
    each K1's and K2's input; the bill without them is short of what the
    call allocates."""
    dev = _cuda()
    cfg = srvgg.SRVGGConfig(num_feat=128, num_conv=4, upscale=4)
    params = srvgg.params_to(srvgg.init_params(cfg), dev)
    eng = UpscaleEngine(compute_dtype="float32", batch_size=2,
                        preloaded=(cfg, params))
    h, w = 540, 960
    frames = np.random.RandomState(3).randint(0, 256, (2, h, w, 3),
                                              np.uint8)
    plan = eng._plan_execution(h, w)
    assert plan == (0, 2)
    x = torch.from_numpy(frames).to(dev)
    with eng._on_device():
        eng._forward(x[:1])  # the packed weights' first allocations
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with eng._on_device():
        y = eng._forward(x[:plan.per_call])
    torch.cuda.synchronize()
    del y
    peak = torch.cuda.max_memory_allocated() - base
    bill = plan.per_call * eng._frame_bytes(h, w)
    assert peak <= bill, (peak, bill)
    no_planes = bill - plan.per_call * h * w * cfg.num_feat * 6
    assert peak > no_planes, (peak, no_planes)


#: sha256 (the first 16 hex digits) of each 64-feature int8 form's output
#: in perf_conv_widths --dtypes int8 --widths 64 on the parent of the
#: change that gave K4a, K4 and K4h their wide forms (H100, that script's
#: seeded inputs): the 64-feature kernels must give the same bytes
INT8_64_SHA256 = {"k4a": "f295c1bb5f103180", "k4": "b00e569916f054b4",
                  "k4h_x2": "4a54b36a7af04176",
                  "k4h_x3": "e1c5c74012705525",
                  "k4h_x4": "b92b5e29a573cc0b", "model": "64d67a05c78604d0"}


@pytest.mark.cuda
def test_64_feature_int8_forms_are_unchanged():
    """K4a, K4, K4h (x2, x3, x4) and the int8 model at 64 features give
    the bytes they gave before their wide forms were added."""
    from reve_tpu_torch.scripts import perf_conv_widths as perf

    _cuda()
    got = {}
    for form, fn in perf.int8_forms(64, (2, 3, 4)).items():
        got[form] = perf.digest(fn())
    torch.cuda.synchronize()
    assert got == INT8_64_SHA256


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    x = torch.zeros((1, 4, 4, 32), device=dev)  # 32 channels, not 64
    with pytest.raises(ValueError, match="expected"):
        conv3x3.conv3x3_bias_prelu(x, torch.zeros((3, 3, 32, 64), device=dev),
                                   torch.zeros(64), torch.zeros(64))
    with pytest.raises(ValueError, match="expected"):
        conv3x3.conv3x3_bias_prelu(
            x.to(torch.bfloat16),
            torch.zeros((3, 3, 32, 64), device=dev, dtype=torch.bfloat16),
            torch.zeros(64), torch.zeros(64))
    x = torch.zeros((1, 4, 4, 64), device=dev)
    with pytest.raises(ValueError, match="expected"):
        head.head_conv_residual_u8_shuffle(
            x.to(torch.bfloat16),
            torch.zeros((3, 3, 64, 12), device=dev, dtype=torch.bfloat16),
            torch.zeros(12), torch.zeros((1, 4, 5, 3), dtype=torch.uint8,
                                         device=dev), 2)
    with pytest.raises(TypeError):
        conv3x3.conv3x3_bias_prelu(
            x, torch.zeros((3, 3, 64, 64), device=dev, dtype=torch.float16),
            torch.zeros(64), torch.zeros(64))


@pytest.mark.cuda
def test_tensor_core_wrappers_reject_what_the_kernels_do_not_take():
    """float32 K1, its split pass and K4 refuse what their kernels do not
    take, and nothing is launched; the CUDA-core float32 K1 is gone."""
    dev = _cuda()
    before = dict(LAUNCHES)
    w = torch.zeros((3, 3, 64, 64), device=dev)
    x = torch.zeros((1, 4, 8, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3.conv3x3_bias_prelu(x.transpose(1, 2), w, torch.zeros(64),
                                   torch.zeros(64))
    with pytest.raises(TypeError):
        conv3x3.split_bf16x3(x.double())
    with pytest.raises(ValueError, match="multiple of 8"):
        conv3x3.split_bf16x3(torch.zeros(12, device=dev))
    x8 = torch.zeros((1, 4, 8, 64), dtype=torch.int8, device=dev)
    w8 = torch.zeros((3, 3, 64, 64), dtype=torch.int8, device=dev)
    f = torch.ones(64, device=dev)
    inv = torch.ones(1, device=dev)
    with pytest.raises(TypeError):
        conv3x3_s8.conv3x3_s8_dq_prelu_q8(x8.to(torch.uint8), w8, f, f, f,
                                          inv)
    with pytest.raises(ValueError, match="expected"):
        conv3x3_s8.conv3x3_s8_dq_prelu_q8(x8[..., :32].contiguous(), w8, f,
                                          f, f, inv)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_s8.conv3x3_s8_dq_prelu_q8(x8.transpose(1, 2), w8, f, f, f,
                                          inv)
    assert LAUNCHES == before
    from reve_tpu_torch.kernels import build
    assert not hasattr(build.load(conv3x3.SOURCE), "reve_conv3x3_bias_prelu")


def _s8_inputs(seed, B, H, W, cout=64):
    rs = np.random.RandomState(seed)
    return {
        "x8": torch.from_numpy(rs.randint(-127, 128, (B, H, W, 64)).astype(
            np.int8)),
        "w8": torch.from_numpy(rs.randint(-127, 128, (3, 3, 64, cout))
                               .astype(np.int8)),
        "scale": torch.from_numpy(rs.uniform(2e-6, 2e-5, (cout,)).astype(
            np.float32)),
        "b": torch.from_numpy(rs.uniform(-0.1, 0.1, (cout,)).astype(
            np.float32)),
        "alpha": torch.from_numpy(rs.uniform(0.05, 0.4, (cout,)).astype(
            np.float32)),
        "inv": torch.tensor([1.0 / 0.02], dtype=torch.float32),
        "u8": torch.from_numpy(rs.randint(0, 256, (B, H, W, 3)).astype(
            np.uint8)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(19, 45), (8, 32), (1, 1)])
def test_s8_conv_kernel_is_exact(hw):
    dev = _cuda()
    d = {k: v.to(dev) for k, v in _s8_inputs(1, 2, *hw).items()}
    args = (d["x8"], d["w8"], d["scale"], d["b"], d["alpha"], d["inv"])
    before = LAUNCHES["conv3x3_s8_dq_prelu_q8"]
    got = conv3x3_s8.conv3x3_s8_dq_prelu_q8(*args)
    want = conv3x3_s8.conv3x3_s8_dq_prelu_q8_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert torch.equal(got, want)
    assert LAUNCHES["conv3x3_s8_dq_prelu_q8"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("hw", TC_SHAPES)
@pytest.mark.parametrize("B", [1, 3])
def test_s8_tensor_core_k4_is_exact_at_tile_edges(B, hw):
    dev = _cuda()
    d = {k: v.to(dev) for k, v in _s8_inputs(30 + B, B, *hw).items()}
    args = (d["x8"], d["w8"], d["scale"], d["b"], d["alpha"], d["inv"])
    before = LAUNCHES["conv3x3_s8_dq_prelu_q8"]
    got = conv3x3_s8.conv3x3_s8_dq_prelu_q8(*args)
    want = conv3x3_s8.conv3x3_s8_dq_prelu_q8_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (B, *hw, 64) and got.dtype == torch.int8
    assert torch.equal(got, want)
    assert LAUNCHES["conv3x3_s8_dq_prelu_q8"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("tap", range(9))
def test_s8_k4_each_tap_alone_under_the_64b_swizzle(tap):
    """Weights nonzero at one tap only: the A operand of tap (dy, dx) is
    the halo started dy * 66 + dx 64-B rows later in the 64-B swizzle, and
    each start must read what TMA wrote (ragged shape, exact)."""
    dev = _cuda()
    d = {k: v.to(dev) for k, v in _s8_inputs(40 + tap, 2, 19, 45).items()}
    w8 = torch.zeros_like(d["w8"])
    w8[tap // 3, tap % 3] = d["w8"][tap // 3, tap % 3]
    args = (d["x8"], w8, d["scale"], d["b"], d["alpha"], d["inv"])
    got = conv3x3_s8.conv3x3_s8_dq_prelu_q8(*args)
    want = conv3x3_s8.conv3x3_s8_dq_prelu_q8_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert want.unique().numel() > 64  # not clipped flat


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DTYPES))
def test_u8_conv_q8_kernel_matches_plain(name):
    dev = _cuda()
    d = _inputs(2, 2, 19, 45)
    w3 = d["w"][:, :, :3].contiguous().to(dev, DTYPES[name])
    u8, b, a = d["u8"].to(dev), d["b"].to(dev), d["alpha"].to(dev)
    inv = torch.tensor([1.0 / 0.01], device=dev)
    before = LAUNCHES["conv3x3_u8_bias_prelu_q8"]
    got = conv3x3.conv3x3_u8_bias_prelu_q8(u8, w3, b, a, inv)
    want = conv3x3.conv3x3_u8_bias_prelu_q8_plain(u8, w3, b, a, inv)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8
    assert (got.int() - want.int()).abs().max().item() <= 1
    assert LAUNCHES["conv3x3_u8_bias_prelu_q8"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 3, 4])
def test_s8_head_kernel_matches_plain(r):
    dev = _cuda()
    d = {k: v.to(dev) for k, v in _s8_inputs(r, 2, 21, 70,
                                             cout=3 * r * r).items()}
    args = (d["x8"], d["w8"], d["scale"] * 1e-2, d["b"], d["u8"], r)
    before = LAUNCHES["head_conv_s8_residual_u8_shuffle"]
    got = head.head_conv_s8_residual_u8_shuffle(*args)
    want = head.head_conv_s8_residual_u8_shuffle_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (2, 21 * r, 70 * r, 3) and got.dtype == torch.uint8
    assert torch.equal(got, want)
    assert LAUNCHES["head_conv_s8_residual_u8_shuffle"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("hw", TC_SHAPES)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("r", [2, 3, 4])
def test_s8_tensor_core_k4h_is_exact_at_tile_edges(r, B, hw):
    """K4h on s8 wgmma at N = 3r^2 padded to 16, 32, 48: exact."""
    dev = _cuda()
    d = {k: v.to(dev) for k, v in _s8_inputs(50 + r + B, B, *hw,
                                             cout=3 * r * r).items()}
    args = (d["x8"], d["w8"], d["scale"] * 1e-2, d["b"], d["u8"], r)
    before = LAUNCHES["head_conv_s8_residual_u8_shuffle"]
    got = head.head_conv_s8_residual_u8_shuffle(*args)
    want = head.head_conv_s8_residual_u8_shuffle_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (B, hw[0] * r, hw[1] * r, 3)
    assert torch.equal(got, want)
    assert LAUNCHES["head_conv_s8_residual_u8_shuffle"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("hw", TC_SHAPES)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("r", [2, 3, 4])
def test_f32_tensor_core_k2_matches_plain_at_tile_edges(r, B, hw):
    """float32 K2: the split pass, then the bf16x6 head on wgmma."""
    dev = _cuda()
    d = _inputs(60 + r + B, B, *hw, cout=3 * r * r)
    h = d["x"].clamp_min(0).to(dev)
    w, b, u8 = d["w"].to(dev), d["b"].to(dev), d["u8"].to(dev)
    before = dict(LAUNCHES)
    got = head.head_conv_residual_u8_shuffle(h, w, b, u8, r)
    want = head.head_conv_residual_u8_shuffle_plain(h, w, b, u8, r)
    torch.cuda.synchronize()
    assert got.shape == (B, hw[0] * r, hw[1] * r, 3)
    assert (got.int() - want.int()).abs().max().item() <= 1
    assert LAUNCHES["head_conv_residual_u8_shuffle"] == \
        before["head_conv_residual_u8_shuffle"] + 1
    assert LAUNCHES["split_bf16x3"] == before["split_bf16x3"] + 1


@pytest.mark.cuda
def test_f32_tensor_core_k2_at_large_activations():
    """Activations up to +-2^8 into float32 K2: the six-pass sums far
    from the usual range, and the u8 clip at both ends."""
    dev = _cuda()
    d = _inputs(24, 2, 19, 45, cout=48)
    x = ((d["x"] - 0.5) * 2 ** 8).to(dev)
    w, b, u8 = d["w"].to(dev), d["b"].to(dev), d["u8"].to(dev)
    got = head.head_conv_residual_u8_shuffle(x, w, b, u8, 4)
    want = head.head_conv_residual_u8_shuffle_plain(x, w, b, u8, 4)
    torch.cuda.synchronize()
    assert (got.int() - want.int()).abs().max().item() <= 1
    assert ((got == 0) | (got == 255)).float().mean().item() > 0.5
    assert ((got > 0) & (got < 255)).any()


@pytest.mark.cuda
def test_head_wrappers_reject_what_the_kernels_do_not_take():
    """float32 K2 and K4h refuse what their kernels do not take, and
    nothing is launched; no library exports the CUDA-core heads' entry
    points (their source is gone)."""
    dev = _cuda()
    before = dict(LAUNCHES)
    h = torch.zeros((1, 4, 8, 64), device=dev)
    w = torch.zeros((3, 3, 64, 48), device=dev)
    b = torch.zeros(48, device=dev)
    u8 = torch.zeros((1, 4, 8, 3), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="upscale"):
        head.head_conv_residual_u8_shuffle(h, w, b, u8, 5)
    with pytest.raises(ValueError, match="expected"):
        head.head_conv_residual_u8_shuffle(h, w[..., :27].contiguous(),
                                           b[:27], u8, 4)
    with pytest.raises(ValueError, match="contiguous"):
        head.head_conv_residual_u8_shuffle(
            h.transpose(1, 2).contiguous().transpose(1, 2), w, b, u8, 4)
    with pytest.raises(TypeError):
        head.head_conv_residual_u8_shuffle(h.double(), w, b, u8, 4)
    with pytest.raises(ValueError, match="uint8"):
        head.head_conv_residual_u8_shuffle(h, w, b, u8.float(), 4)
    x8 = h.to(torch.int8)
    w8 = w.to(torch.int8)
    with pytest.raises(TypeError):
        head.head_conv_s8_residual_u8_shuffle(x8.to(torch.uint8), w8, b, b,
                                              u8, 4)
    with pytest.raises(ValueError, match="expected"):
        head.head_conv_s8_residual_u8_shuffle(x8, w8, b, b, u8[:, :3], 4)
    with pytest.raises(ValueError, match="48 float32"):
        head.head_conv_s8_residual_u8_shuffle(x8, w8, b[:12], b, u8, 4)
    torch.cuda.synchronize()
    assert LAUNCHES == before
    from reve_tpu_torch.kernels import build
    for source in build.SOURCES:
        lib = build.load(source)
        assert not hasattr(lib, "reve_head_conv_residual_u8_shuffle")
        assert not hasattr(lib, "reve_head_conv_s8_residual_u8_shuffle")


def _probe_case(name, shape):
    """P1 and its plain version on seeded operands of `shape` (m, k, n,
    loops); k "step" is the dtype's k step (32 for s8, 16 for bf16)."""
    dev = _cuda()
    m, k, n, loops = shape
    if k == "step":
        k = 32 if name == "int8" else 16
    rs = np.random.RandomState(m + n + k + loops)
    if name == "int8":
        x = torch.from_numpy(rs.randint(-127, 128, (m, k)).astype(np.int8))
        w = torch.from_numpy(rs.randint(-127, 128, (2 * k, n)).astype(
            np.int8))
    else:
        x = torch.from_numpy(rs.rand(m, k).astype(np.float32) - 0.5).to(
            torch.bfloat16)
        w = torch.from_numpy(rs.rand(2 * k, n).astype(np.float32) - 0.5
                             ).to(torch.bfloat16)
    x, w = x.to(dev), w.to(dev)
    before = LAUNCHES["dot_loop"]
    got = dot_probe.dot_loop(x, w, loops)
    want = dot_probe.dot_loop_plain(x, w, loops)
    torch.cuda.synchronize()
    assert LAUNCHES["dot_loop"] == before + 1
    assert got.shape == (m, n) and got.dtype == want.dtype
    if name == "int8":
        assert torch.equal(got, want)
    else:
        tol = 1e-4 * want.abs().max().item()
        assert (got - want).abs().max().item() <= tol
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 256, 128, 4), (4224, 256, 128, 64),
                                   (128, 64, 64, 3)])
@pytest.mark.parametrize("name", ["int8", "bfloat16"])
def test_dot_probe_kernel_matches_plain(name, shape):
    _probe_case(name, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (64, "step", 64, 0), (64, "step", 64, 1), (64, "step", 192, 2),
    (128, 96, 64, 5), (64, 256, 64, 1), (192, 128, 320, 7)])
@pytest.mark.parametrize("name", ["int8", "bfloat16"])
def test_dot_probe_kernel_at_its_edges(name, shape):
    """loops 0 (zeros) and 1 (the second warpgroup of the loop's split
    runs no dot), K of one k step, N = 64 and 192 (not multiples of 128),
    M = 64 (one tile), odd loops."""
    got = _probe_case(name, shape)
    if shape[3] == 0:
        assert not got.any()


@pytest.mark.cuda
def test_dot_probe_kernel_refuses_and_runs_on_wgmma():
    """P1 refuses N = 96 and K = 288 (and the C entry by itself), launches
    nothing for them, and its library holds s8 and bf16 wgmma (IGMMA,
    HGMMA) in every kernel and no mma.sync (HMMA, IMMA)."""
    import ctypes
    import os
    import re
    import subprocess

    from reve_tpu_torch.kernels import build

    dev = _cuda()
    before = LAUNCHES["dot_loop"]
    for dt in (torch.int8, torch.bfloat16):
        x = torch.zeros((64, 256), dtype=dt, device=dev)
        with pytest.raises(ValueError, match="multiples of 64"):
            dot_probe.dot_loop(x, torch.zeros((512, 96), dtype=dt,
                                              device=dev), 1)
        with pytest.raises(ValueError, match="K <= 256"):
            dot_probe.dot_loop(torch.zeros((64, 288), dtype=dt, device=dev),
                               torch.zeros((576, 128), dtype=dt, device=dev),
                               1)
    with pytest.raises(TypeError):
        dot_probe.dot_loop(torch.zeros((64, 32), device=dev),
                           torch.zeros((64, 64), device=dev), 1)
    lib = build.load(dot_probe.SOURCE)
    fn = lib.reve_dot_loop
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = torch.zeros(1 << 20, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for m, n, k, dtype in ((64, 96, 256, 0), (64, 128, 288, 0),
                           (64, 128, 48, 0), (64, 128, 288, 1),
                           (100, 128, 64, 1), (64, 128, 64, 2)):
        assert fn(buf.data_ptr(), buf.data_ptr(), buf.data_ptr(), m, n, k, 1,
                  dtype, stream) != 0
    torch.cuda.synchronize()
    assert LAUNCHES["dot_loop"] == before
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build.build_info[
        dot_probe.SOURCE]["path"]], check=True, capture_output=True,
        text=True).stdout
    kernels = re.split(r"\n\s*Function : ", sass)[1:]
    assert len(kernels) == 8 + 16  # one for each count of 32-B k steps
    for k in kernels:
        assert ("IGMMA" in k) != ("HGMMA" in k), k.split()[0]
    assert not re.search(r"\b[HI]MMA\b", sass)


@pytest.mark.cuda
def test_int8_model_kernels_match_plain_path():
    dev = _cuda()
    cfg = srvgg.SRVGGConfig(num_feat=64, num_conv=3, upscale=4)
    params = srvgg.params_to(srvgg.init_params(cfg), dev)
    u8 = _inputs(6, 2, 17, 33)["u8"].to(dev)
    maxima = quantize.collect_act_maxima(params, u8, cfg=cfg,
                                         percentile=99.9)
    plain = quantize.collect_act_maxima(params, u8, cfg=cfg,
                                        percentile=99.9, plain=True)
    torch.testing.assert_close(maxima, plain, rtol=1e-5, atol=0)
    qb = quantize.build_qbody(params, cfg, maxima, margin=1.25)
    for dt in DTYPES.values():
        got = srvgg.apply_int8(params, qb, u8, cfg=cfg, compute_dtype=dt)
        want = srvgg.apply_int8(params, qb, u8, cfg=cfg, compute_dtype=dt,
                                plain=True)
        # a K4a code that differs by one (float conv order) may move
        # later codes too: held by PSNR, as chip_smoke.py holds the job
        mse = ((got.double() - want.double()) ** 2).mean().item()
        assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 60.0


def _u8_case(seed, B, hw, name, q8):
    """K3 (q8 False) or K4a, kernel and plain version, on one input."""
    dev = _cuda()
    d = _inputs(seed, B, *hw)
    w3 = d["w"][:, :, :3].contiguous().to(dev, DTYPES[name]) * 4
    u8, b, a = d["u8"].to(dev), d["b"].to(dev), d["alpha"].to(dev)
    if q8:
        inv = torch.tensor([1.0 / 0.01], device=dev)
        return (conv3x3.conv3x3_u8_bias_prelu_q8(u8, w3, b, a, inv),
                conv3x3.conv3x3_u8_bias_prelu_q8_plain(u8, w3, b, a, inv))
    return (conv3x3.conv3x3_u8_bias_prelu(u8, w3, b, a),
            conv3x3.conv3x3_u8_bias_prelu_plain(u8, w3, b, a))


def _u8_close(got, want, name, q8):
    if q8:
        assert got.dtype == torch.int8
        d = (got.int() - want.int()).abs()
        assert d.max().item() <= 1
        # n_diff: a few codes, where the value sits at a rounding boundary
        assert int((d > 0).sum()) <= max(2, 1e-3 * d.numel())
    else:
        assert got.dtype == DTYPES[name]
        _close(got, want, name)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", TC_SHAPES)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("q8", [False, True], ids=["k3", "k4a"])
@pytest.mark.parametrize("name", list(DTYPES))
def test_u8_conv_kernels_match_plain_at_tile_edges(name, q8, B, hw):
    """K3 and K4a on the tensor cores, in both compute dtypes: tiles of one
    row of 64 pixels, the halo read as 4-B words of rows of W * 3 bytes
    (ragged at every width but 1920), the ragged right edge clipped by the
    TMA store."""
    key = "conv3x3_u8_bias_prelu" + ("_q8" if q8 else "")
    before = LAUNCHES[key]
    got, want = _u8_case(70 + B + hw[1], B, hw, name, q8)
    torch.cuda.synchronize()
    assert got.shape == (B, *hw, 64)
    _u8_close(got, want, name, q8)
    assert LAUNCHES[key] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DTYPES))
def test_u8_conv_kernels_at_1080p(name):
    """A batch of 4 1080p frames: many more tiles than the persistent
    grid has blocks, so every block reuses its two staging buffers (and
    waits on their stores) many times over."""
    B, H, W = 4, 1080, 1920
    sms = torch.cuda.get_device_properties(_cuda()).multi_processor_count
    assert B * H * (W // 64) > 16 * sms
    for q8 in (False, True):
        got, want = _u8_case(80, B, (H, W), name, q8)
        torch.cuda.synchronize()
        _u8_close(got, want, name, q8)
        del got, want


@pytest.mark.cuda
def test_u8_conv_wrappers_refuse_and_no_cuda_core_form_is_left():
    """K3/K4a refuse what their kernel does not take, and launch nothing;
    their library exports K3 and K4a only, and each of its kernels holds
    wgmma (HGMMA) in its SASS: no CUDA-core form of K3 or K4a is left."""
    import os
    import re
    import subprocess

    from reve_tpu_torch.kernels import build

    dev = _cuda()
    before = dict(LAUNCHES)
    u8 = torch.zeros((1, 4, 8, 3), dtype=torch.uint8, device=dev)
    w = torch.zeros((3, 3, 3, 64), device=dev)
    f = torch.zeros(64, device=dev)
    inv = torch.ones(1, device=dev)
    with pytest.raises(TypeError):
        conv3x3.conv3x3_u8_bias_prelu(u8.float(), w, f, f)
    with pytest.raises(TypeError):
        conv3x3.conv3x3_u8_bias_prelu(u8, w.half(), f, f)
    with pytest.raises(ValueError, match="expected"):
        conv3x3.conv3x3_u8_bias_prelu(u8, w[:, :, :2].contiguous(), f, f)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3.conv3x3_u8_bias_prelu_q8(u8.transpose(1, 2), w, f, f, inv)
    with pytest.raises(ValueError, match="1 float32"):
        conv3x3.conv3x3_u8_bias_prelu_q8(u8, w, f, f, f)
    torch.cuda.synchronize()
    assert LAUNCHES == before
    lib = build.load(conv3x3.SOURCE)
    assert hasattr(lib, "reve_conv3x3_u8_bias_prelu")
    assert hasattr(lib, "reve_conv3x3_u8_bias_prelu_q8")
    assert hasattr(lib, "reve_conv3x3_u8x2_bias")
    assert not hasattr(lib, "reve_conv3x3_bias_prelu")
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build.build_info[
        conv3x3.SOURCE]["path"]], check=True, capture_output=True,
        text=True).stdout
    kernels = re.split(r"\n\s*Function : ", sass)[1:]
    # K3 and K4a at Cout 32, 64, 96 and 128, and K3 at Cin 12, each in
    # both compute dtypes
    assert len(kernels) == 18
    for k in kernels:  # (a CUDA-core conv would be thousands of FFMA)
        assert "HGMMA" in k and k.count("FFMA") < 8, k.split()[0]


#: (B, 2H, 2W) frames of K3 at Cin 12: a lone trunk pixel, ragged tiles,
#: a whole tile's row (64 trunk pixels), a row and a column past it, and
#: the x2 trunk's 540 rows, ragged against the trunk's 8-row K7 tiles;
#: then heights 6 and 7, ragged against its own 4-row (bfloat16) tiles
#: as 19 and 5 are against its 2-row (float32) ones
U8X2_SHAPES = [(1, 2, 2), (3, 2 * 19, 2 * 45), (2, 16, 128),
               (1, 2 * 5, 2 * 65), (1, 1080, 1920), (2, 2 * 6, 2 * 65),
               (1, 2 * 7, 2 * 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", U8X2_SHAPES, ids=str)
@pytest.mark.parametrize("name", list(DTYPES))
def test_u8x2_conv_kernel_matches_plain_at_tile_edges(name, shape):
    """K3 at Cin 12 (RRDB x2's conv_first, the 2x2 unshuffle read in place
    from the u8 frames: a tile's halo is 6 u8 rows of 132 pixels) against
    its plain version, in both compute dtypes."""
    dev = _cuda()
    B, H2, W2 = shape
    rs = np.random.RandomState(H2 + W2)
    u8 = torch.from_numpy(rs.randint(0, 256, (B, H2, W2, 3), np.uint8)).to(
        dev)
    w = torch.from_numpy(rs.uniform(-0.3, 0.3, (3, 3, 12, 64)).astype(
        np.float32)).to(dev, DTYPES[name])
    b = torch.from_numpy(rs.uniform(-0.1, 0.1, 64).astype(np.float32)).to(
        dev)
    before = LAUNCHES["conv3x3_u8x2_bias"]
    got = conv3x3.conv3x3_u8x2_bias(u8, w, b)
    want = conv3x3.conv3x3_u8x2_bias_plain(u8, w, b)
    torch.cuda.synchronize()
    assert got.shape == (B, H2 // 2, W2 // 2, 64)
    assert got.dtype == DTYPES[name]
    _close(got, want, name)
    assert LAUNCHES["conv3x3_u8x2_bias"] == before + 1


@pytest.mark.cuda
def test_u8x2_conv_wrapper_refuses_odd_dims_and_bad_operands():
    """K3 at Cin 12 refuses odd frame dims (as reve_tpu's unshuffle
    does), 3-channel weights and non-u8 frames, and launches nothing."""
    dev = _cuda()
    before = dict(LAUNCHES)
    w = torch.zeros((3, 3, 12, 64), device=dev)
    f = torch.zeros(64, device=dev)
    for hw in ((5, 8), (4, 7)):
        with pytest.raises(ValueError, match="even dims"):
            conv3x3.conv3x3_u8x2_bias(
                torch.zeros((1, *hw, 3), dtype=torch.uint8, device=dev), w,
                f)
    u8 = torch.zeros((1, 4, 8, 3), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="expected"):
        conv3x3.conv3x3_u8x2_bias(u8, w[:, :, :3].contiguous(), f)
    with pytest.raises(TypeError):
        conv3x3.conv3x3_u8x2_bias(u8.float(), w, f)
    torch.cuda.synchronize()
    assert LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 37, 70), (2, 64, 33),
                                   (1, 5, 300), (4, 400, 510)])
@pytest.mark.parametrize("spec", tta.SPECS, ids=str)
def test_tta_kernel_is_exact(spec, shape):
    """K6's three forms against the plain version, for each transform, on
    tiles that are ragged (37, 70, 33, 5, 300, 400, 510 against 32),
    batches > 1 and hundreds of tiles; the FIRST form never reads acc
    and LAST never writes it."""
    dev = _cuda()
    k, flip = spec
    b, ho, wo = shape
    rs = np.random.RandomState(k * 2 + flip)
    ys = (b, wo, ho, 3) if k & 1 else (b, ho, wo, 3)
    y = torch.from_numpy(rs.randint(0, 256, ys).astype(np.uint8)).to(dev)
    acc0 = torch.from_numpy(rs.randint(0, 1786, (b, ho, wo, 3)).astype(
        np.int16)).to(dev)
    before = LAUNCHES["tta_accumulate"]
    for form in (tta.FIRST, tta.MIDDLE, tta.LAST):
        acc, acc_p = acc0.clone(), acc0.clone()
        out = torch.full((b, ho, wo, 3), 7, dtype=torch.uint8, device=dev)
        out_p = out.clone()
        got = tta.tta_accumulate(y, acc, k, flip, form, out=out)
        want = tta.tta_accumulate_plain(y, acc_p, k, flip, form, out=out_p)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want), form
        assert torch.equal(acc, acc_p) and torch.equal(out, out_p)
    assert LAUNCHES["tta_accumulate"] == before + 3


@pytest.mark.cuda
def test_tta_kernel_refuses_what_it_does_not_take():
    dev = _cuda()
    y = torch.zeros((1, 4, 6, 3), dtype=torch.uint8, device=dev)
    acc = torch.zeros((1, 4, 6, 3), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError, match="expected"):
        tta.tta_accumulate(y, acc, 1, False, tta.MIDDLE)  # needs (1, 6, 4)
    with pytest.raises(ValueError, match="LAST"):
        tta.tta_accumulate(y, acc, 0, False, tta.LAST)
    with pytest.raises(ValueError, match="contiguous"):
        tta.tta_accumulate(y, acc.transpose(1, 2).contiguous().transpose(
            1, 2), 0, False, tta.MIDDLE)


def _engines(dtype, **kw):
    """A whole-frame engine and one with `kw` on the card, on one small
    model (64 features, 3 hidden convs, x4: halo 5)."""
    dev = _cuda()
    cfg = srvgg.SRVGGConfig(num_feat=64, num_conv=3, upscale=4)
    params = srvgg.params_to(srvgg.init_params(cfg), dev)

    def make(**extra):
        return UpscaleEngine(compute_dtype=dtype, batch_size=3, device=dev,
                             preloaded=(cfg, params), **extra)
    return make(tile=-1), make(**kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_tiled_engine_is_byte_identical_to_whole_frames(dtype):
    """Halo tiles of 32 (windows of 42, clamped at the borders) against
    whole frames, both through the kernels; int8 quantizes both with the
    scales the whole-frame engine calibrated."""
    whole, tiled = _engines(dtype, tile=32)
    frames = np.random.RandomState(9).randint(0, 256, (3, 70, 101, 3),
                                              np.uint8)
    if dtype == "int8":
        whole.calibrate_int8(frames)
        tiled.set_calibration(whole.get_calibration())
    calls = tiled.stats.calls
    want = whole.submit(frames).result()
    got = tiled.submit(frames).result()
    assert tiled._plans[(70, 101)].tile == 32
    assert tiled.stats.calls > calls
    assert got.shape == want.shape == (3, 280, 404, 3)
    assert int((got != want).sum()) == 0


@pytest.mark.cuda
def test_tta_engine_equals_manual_ensemble_and_is_equivariant():
    """The ensemble on the card (K6 after each transform's model call)
    against the whole-frame engine on the 8 transformed batches, inverse
    transformed and averaged by K6's plain version; then tta(rot90(x)) ==
    rot90(tta(x)) and the same for a flip, on non-square frames."""
    plain, ens = _engines("bfloat16", tta=True)
    frames = np.random.RandomState(10).randint(0, 256, (3, 24, 40, 3),
                                               np.uint8)
    before = LAUNCHES["tta_accumulate"]
    got = ens.submit(frames).result()
    assert LAUNCHES["tta_accumulate"] == before + 8
    x = torch.from_numpy(frames)
    acc = torch.empty((3, 96, 160, 3), dtype=tta.ACC_DTYPE)
    mean = torch.empty((3, 96, 160, 3), dtype=torch.uint8)
    for s, (k, flip) in enumerate(tta.SPECS):
        y = plain.submit(tta.forward_transform(x, k, flip).numpy()).result()
        form = tta.FIRST if s == 0 else tta.LAST if s == 7 else tta.MIDDLE
        tta.tta_accumulate_plain(torch.from_numpy(y.copy()), acc, k, flip,
                                 form, out=mean)
    np.testing.assert_array_equal(got, mean.numpy())
    for k, flip in ((1, False), (0, True)):
        t = tta.forward_transform(x, k, flip).numpy()
        np.testing.assert_array_equal(
            ens.submit(t).result(),
            tta.forward_transform(torch.from_numpy(got), k, flip).numpy())


# -- RRDB: K7, K2's conv_last mode, K1 past 2^31 elements, the model --------

#: K7's forms on the model's path: (Cin, Cout, epilogue)
K7_FORMS = [(64, 32, "lrelu"), (96, 32, "lrelu"), (128, 32, "lrelu"),
            (160, 32, "lrelu"), (192, 64, "rdb"), (192, 64, "rrdb"),
            (64, 64, "add")]
#: ragged and whole tiles of K7's tiles: 4 x 64 (float32), 8 x 64
#: (bfloat16)
#: (the last: more tiles than the persistent grid has blocks, so each
#: block's staging buffer and residual loads serve several tiles)
K7_SHAPES = [(1, 1, 1), (2, 19, 45), (1, 4, 64), (3, 5, 65), (1, 9, 130),
             (3, 7, 63), (1, 8, 64), (2, 9, 65), (1, 17, 129), (3, 16, 128),
             (2, 70, 1930)]


def _k7_case(seed, B, H, W, cin, cout, epi, dev, dt, scale=1.0):
    """Operands of one K7 call: a 192-channel buffer in [-1, 1) x scale,
    weights at the model's scale, the output tensor and residuals as the
    model lays them out (convs 1-4 into their own buffer, conv 5 into
    another, the rrdb form over its residual, conv_body over feat)."""
    rs = np.random.RandomState(seed)
    buf = torch.from_numpy((rs.uniform(-1, 1, (B, H, W, 192)) * scale)
                           .astype(np.float32)).to(dev, dt)
    w = torch.from_numpy((rs.uniform(-1, 1, (3, 3, cin, cout)) * 0.1
                          / np.sqrt(9 * cin)).astype(np.float32)).to(dev, dt)
    b = torch.from_numpy(rs.uniform(-0.1, 0.1, cout).astype(np.float32)) \
        .to(dev)
    other = torch.from_numpy((rs.uniform(-1, 1, (B, H, W, 192)) * scale)
                             .astype(np.float32)).to(dev, dt)
    if epi == "lrelu":
        return dict(buf=buf, w=w, b=b, out=buf, off=cin, res=None,
                    res2=None)
    if epi == "add":
        feat = other[..., :64].contiguous()
        return dict(buf=buf, w=w, b=b, out=feat, off=0, res=feat, res2=None)
    return dict(buf=buf, w=w, b=b, out=other if epi == "rrdb" else
                torch.zeros_like(other), off=0, res=buf,
                res2=other if epi == "rrdb" else None)


def _k7_run(c, cin, epi, plain, planes=False):
    """K7 or its plain version with a copy of the case's output (and of
    whichever operand is that same tensor); returns (the written
    channels, the plain pre-epilogue conv value, the residuals at those
    channels).  `planes` (float32): the kernel reads the split planes of
    its input and writes those of its output (the model's path), and the
    planes it wrote are held to the split of its output, bit for bit,
    and the rest of them to what was there."""
    out = c["out"].clone()

    def swap(t):
        return out if t is c["out"] else t

    cout, off = c["w"].shape[-1], c["off"]
    kw = {}
    if planes:
        # the output's planes hold the split of its old values; those of
        # the input are the same tensor when the conv writes into it
        out_planes = conv3x3.split_bf16x3_plain(out)
        kw = dict(planes=out_planes if c["buf"] is c["out"] else
                  conv3x3.split_bf16x3_plain(c["buf"]),
                  out_planes=out_planes)
        before = out_planes.clone()
    if plain:
        k7.dense_conv_plain(swap(c["buf"]), cin, c["w"], c["b"], out, off,
                            epi, swap(c["res"]), swap(c["res2"]))
    else:
        k7.dense_conv(swap(c["buf"]), cin, c["w"], c["b"], out, off, epi,
                      swap(c["res"]), swap(c["res2"]), **kw)
    if planes:
        got = kw["out_planes"]
        assert torch.equal(got[..., off:off + cout],
                           conv3x3.split_bf16x3_plain(
                               out[..., off:off + cout]))
        assert torch.equal(got[..., :off], before[..., :off])
        assert torch.equal(got[..., off + cout:], before[..., off + cout:])
    y = conv3x3.conv3x3_plain(c["buf"][..., :cin], c["w"], c["b"])
    ops = [t[..., :cout] for t in (c["res"], c["res2"]) if t is not None]
    return out[..., off:off + cout], y, ops


def _k7_close(got, want, y, ops, name, scale=1.0):
    if name == "float32":
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=2e-6 * scale, rtol=0)
        return
    mag = torch.stack([t.float().abs() for t in [got, want, y, *ops]]) \
        .amax(0).clamp_min(2.0 ** -10 * scale)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    d = (got.float() - want.float()).abs()
    assert bool((d <= 2 * ulp).all()), float(d.max())


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,epi", K7_FORMS)
@pytest.mark.parametrize("name", list(DTYPES))
def test_k7_matches_plain_at_tile_edges(name, cin, cout, epi):
    """Every form at ragged and whole tiles against its plain version;
    float32 on the planes of its input, writing those of its output (no
    split pass: the model's path), and alone (the split pass first)."""
    dev = _cuda()
    dt = DTYPES[name]
    modes = (True, False) if name == "float32" else (False,)
    for i, (B, H, W) in enumerate(K7_SHAPES):
        c = _k7_case(cin + i, B, H, W, cin, cout, epi, dev, dt)
        want, _, _ = _k7_run(c, cin, epi, plain=True)
        for planes in modes:
            before = dict(LAUNCHES)
            got, y, ops = _k7_run(c, cin, epi, plain=False, planes=planes)
            torch.cuda.synchronize()
            _k7_close(got, want, y, ops, name)
            assert LAUNCHES["dense_conv"] == before["dense_conv"] + 1
            # float32 without planes: one split pass over the channels
            # the conv reads; with them, none
            assert LAUNCHES["split_bf16x3"] == before["split_bf16x3"] + \
                (name == "float32" and not planes)


#: forms the wrapper takes that the model does not run: the residual
#: forms at Cout 32 and the leaky ReLU at Cout 64
K7_OFF_PATH_FORMS = [(64, 32, "rdb"), (96, 32, "rrdb"), (64, 32, "add"),
                     (64, 64, "lrelu"), (128, 64, "lrelu")]


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,epi", K7_OFF_PATH_FORMS)
@pytest.mark.parametrize("name", list(DTYPES))
def test_k7_off_path_forms_match_plain(name, cin, cout, epi):
    """The wrapper's other forms against the plain version, at ragged
    tiles and at more tiles than blocks (float32 on planes)."""
    dev = _cuda()
    dt = DTYPES[name]
    for i, (B, H, W) in enumerate([(2, 19, 45), (2, 70, 1930)]):
        c = _k7_case(cin + cout + i, B, H, W, cin, cout, epi, dev, dt)
        want, _, _ = _k7_run(c, cin, epi, plain=True)
        got, y, ops = _k7_run(c, cin, epi, plain=False,
                              planes=name == "float32")
        torch.cuda.synchronize()
        _k7_close(got, want, y, ops, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DTYPES))
def test_k7_in_place_forms_leave_the_rest_untouched(name):
    """Convs 1-4 write only their growth slice of the buffer they read;
    the rrdb form writes over its residual's first 64 channels only."""
    dev = _cuda()
    dt = DTYPES[name]
    f32 = name == "float32"
    c = _k7_case(3, 2, 19, 45, 96, 32, "lrelu", dev, dt)
    before = c["buf"].clone()
    pl = conv3x3.split_bf16x3_plain(c["buf"]) if f32 else None
    pl_before = None if pl is None else pl.clone()
    k7.dense_conv(c["buf"], 96, c["w"], c["b"], c["buf"], 96, "lrelu",
                  planes=pl, out_planes=pl)
    torch.cuda.synchronize()
    assert torch.equal(c["buf"][..., :96], before[..., :96])
    assert torch.equal(c["buf"][..., 128:], before[..., 128:])
    if f32:
        assert torch.equal(pl[..., :96], pl_before[..., :96])
        assert torch.equal(pl[..., 128:], pl_before[..., 128:])
    c = _k7_case(4, 2, 19, 45, 192, 64, "rrdb", dev, dt)
    before = c["out"].clone()
    pl = conv3x3.split_bf16x3_plain(c["buf"]) if f32 else None
    opl = conv3x3.split_bf16x3_plain(c["out"]) if f32 else None
    opl_before = None if opl is None else opl.clone()
    k7.dense_conv(c["buf"], 192, c["w"], c["b"], c["out"], 0, "rrdb",
                  c["res"], c["res2"], planes=pl, out_planes=opl)
    torch.cuda.synchronize()
    assert torch.equal(c["out"][..., 64:], before[..., 64:])
    if f32:
        assert torch.equal(opl[..., 64:], opl_before[..., 64:])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DTYPES))
def test_k7_at_large_activations(name):
    """Activations at +-2^8: the tolerance and the ulp floor scale with
    the inputs."""
    dev = _cuda()
    dt = DTYPES[name]
    for cin, cout, epi in ((160, 32, "lrelu"), (192, 64, "rrdb")):
        c = _k7_case(5, 2, 19, 45, cin, cout, epi, dev, dt, scale=2.0 ** 8)
        got, y, ops = _k7_run(c, cin, epi, plain=False)
        want, _, _ = _k7_run(c, cin, epi, plain=True)
        torch.cuda.synchronize()
        _k7_close(got, want, y, ops, name, scale=2.0 ** 8)


@pytest.mark.cuda
def test_k7_refusals():
    dev = _cuda()
    c = _k7_case(6, 1, 8, 8, 192, 64, "rdb", dev, torch.bfloat16)
    with pytest.raises(ValueError, match="past the ones it reads"):
        k7.dense_conv(c["buf"], 192, c["w"], c["b"], c["buf"], 0, "rdb",
                      c["buf"])
    with pytest.raises(ValueError, match="needs residuals"):
        k7.dense_conv(c["buf"], 192, c["w"], c["b"], c["out"], 0, "rdb")
    with pytest.raises(TypeError, match="dtypes"):
        k7.dense_conv(c["buf"].float(), 192, c["w"], c["b"], c["out"], 0,
                      "rdb", c["res"])
    with pytest.raises(ValueError, match="packed weights"):
        k7.dense_conv(c["buf"], 192, c["w"], c["b"], c["out"], 0, "rdb",
                      c["res"], packed=k7.pack_weights_dense(c["w"]
                                                             .float()))


def _conv_last_case(seed, B, H, W, dev, dt, scale=1.0):
    """Operands of one conv_last call: activations in [-2, 2) x scale,
    weights at 8 the model's scale, divided by 1.37 scale where scale is
    not 1 (not a power of 2: the products then round otherwise than at
    scale 1), the bias near 0.45, so that the u8 outputs spread over
    their range."""
    d = _inputs(seed, B, H, W, cout=3)
    ws = 8.0 if scale == 1.0 else 8.0 / (1.37 * scale)
    return ((d["x"] * 2 - 1) * scale).to(dev, dt), \
        (d["w"] * ws).to(dev, dt), (d["b"] + 0.45).to(dev)


def _conv_last_check(h, w, b):
    """One conv_last launch against its plain version (u8 |d| <= 1), with
    no split pass."""
    before = dict(LAUNCHES)
    got = head.conv_last_u8(h, w, b)
    want = head.conv_last_u8_plain(h, w, b)
    torch.cuda.synchronize()
    assert got.shape == h.shape[:3] + (3,) and got.dtype == torch.uint8
    assert (got.int() - want.int()).abs().max().item() <= 1
    assert LAUNCHES["conv_last_u8"] == before["conv_last_u8"] + 1
    # float32 reads its input as it is: no split pass
    assert LAUNCHES["split_bf16x3"] == before["split_bf16x3"]
    assert 0 < want.float().mean().item() < 255


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DTYPES))
def test_conv_last_mode_matches_plain(name):
    dev = _cuda()
    for i, (B, H, W) in enumerate(K7_SHAPES):
        _conv_last_check(*_conv_last_case(30 + i, B, H, W, dev,
                                          DTYPES[name]))


#: float32 conv_last's work items are 64 columns x 64 rows, walked in
#: steps of 4 rows: ragged and whole items and steps, rows past the
#: frame, and (the last) more items than the persistent grid has blocks
F32_LAST_SHAPES = [(1, 1, 1), (1, 3, 2), (1, 4, 64), (1, 63, 65),
                   (2, 64, 64), (1, 65, 127), (3, 130, 66), (1, 129, 1),
                   (2, 300, 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("B, H, W", F32_LAST_SHAPES)
def test_f32_conv_last_at_its_work_item_edges(B, H, W):
    dev = _cuda()
    _conv_last_check(*_conv_last_case(50 + H + W, B, H, W, dev,
                                      torch.float32))


@pytest.mark.cuda
def test_f32_conv_last_at_large_activations():
    """Activations to +-2^9 (x 2^8), the weights scaled down to match."""
    dev = _cuda()
    _conv_last_check(*_conv_last_case(60, 2, 19, 130, dev, torch.float32,
                                      scale=2.0 ** 8))


@pytest.mark.cuda
def test_k1_and_conv_last_past_2_31_elements():
    """Two 7680 x 4320 frames of 64 bf16 channels (4.2e9 values, past
    2^31: RRDB's conv_up2 / conv_hr input at a batch of 2 1080p frames):
    K1 and the conv_last mode in one call each, and the float32
    conv_last on the same values in float32, against their plain
    versions frame by frame (the same function; one frame at a time
    keeps the plain version's float32 copies in memory)."""
    dev = _cuda()
    B, H, W = 2, 4320, 7680
    assert B * H * W * 64 > 2 ** 31
    gen = torch.Generator(device=dev).manual_seed(0)
    x = (torch.rand((B, H, W, 64), device=dev, generator=gen) * 2 - 1) \
        .to(torch.bfloat16)
    d = _inputs(40, 1, 1, 1)
    w, b = d["w"].to(dev, torch.bfloat16), d["b"].to(dev)
    alpha = torch.full((64,), 0.2, device=dev)
    y = conv3x3.conv3x3_bias_prelu(x, w, b, alpha)
    for i in range(B):
        want = conv3x3.conv3x3_bias_prelu_plain(x[i:i + 1], w, b, alpha)
        # compared a strip of rows at a time: the check's float32
        # temporaries of a whole frame would not fit beside the tensors
        for r in range(0, H, 540):
            _close(y[i:i + 1, r:r + 540], want[:, r:r + 540], "bfloat16")
        del want
    del y
    dl = _inputs(41, 1, 1, 1, cout=3)
    wl, bl = (dl["w"] * 8).to(dev, torch.bfloat16), (dl["b"] + 0.45).to(dev)
    # the conv_last mode in both dtypes (float32: 17 GB, the float32
    # RRDB plan's chunk of 2 frames)
    for dt in (torch.bfloat16, torch.float32):
        if dt == torch.float32:
            x = x.float()
        u8 = head.conv_last_u8(x, wl.to(dt), bl)
        for i in range(B):
            want = head.conv_last_u8_plain(x[i:i + 1], wl.to(dt), bl)
            assert (u8[i:i + 1].int() - want.int()).abs().max().item() <= 1
            del want
        del u8
    torch.cuda.synchronize()


def _rrdb_small(num_block=2, seed=0):
    cfg = rrdb.RRDBConfig(num_block=num_block)
    params = rrdb.init_params(cfg, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    for c in ([params["conv_first"], params["conv_body"]]
              + [params[n] for n in rrdb.HEAD]):
        c["b"] = torch.rand(c["b"].shape, generator=gen) * 0.1 - 0.05
    params["conv_last"]["b"] += 0.45
    return cfg, params


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DTYPES))
def test_rrdb_model_kernels_match_plain(name):
    """The model through K3, K7 (15 per block + conv_body), K1 x 3 and the
    conv_last mode against its plain path on the card: float32 u8 |d| <=
    1; bfloat16 >= 50 dB against the plain float32 path."""
    dev = _cuda()
    dt = DTYPES[name]
    cfg, params = _rrdb_small()
    params = rrdb.params_to(params, dev)
    u8 = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (2, 24, 70, 3), np.uint8)).to(dev)
    before = dict(LAUNCHES)
    got = rrdb.apply(rrdb.prepare(params, dt), u8, cfg=cfg, compute_dtype=dt)
    torch.cuda.synchronize()
    n = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    assert (n["conv3x3_u8_bias_prelu"], n["dense_conv"],
            n["conv3x3_bias_prelu"], n["conv_last_u8"]) == (
        1, 15 * cfg.num_block + 1, 3, 1)
    # float32: feat's split once, then the head's three K1 each split
    # their input; the trunk's convs write the planes they read, and
    # conv_last reads its float32 input as it is
    assert n["split_bf16x3"] == (1 + 3 if name == "float32" else 0)
    ref = rrdb.apply(params, u8, cfg=cfg, compute_dtype=torch.float32,
                     plain=True)
    assert got.shape == ref.shape == (2, 96, 280, 3)
    d = (got.int() - ref.int()).abs()
    if name == "float32":
        assert d.max().item() <= 1
    else:
        mse = (d.double() ** 2).mean().item()
        assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 50.0


def _rrdb_x2_small(num_block=2, seed=0):
    """_rrdb_small at x2: conv_first reads the 12 unshuffled channels."""
    cfg = rrdb.RRDBConfig(num_block=num_block, upscale=2)
    base = _rrdb_small(num_block, seed)[1]
    first = rrdb.init_params(cfg, torch.Generator().manual_seed(seed))
    return cfg, dict(base, conv_first=dict(first["conv_first"],
                                           b=base["conv_first"]["b"]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DTYPES))
def test_rrdb_x2_model_kernels_match_plain(name):
    """RRDB x2 through K3 at Cin 12, K7 (on a trunk of 27 x 35, ragged
    against its 8-row tiles), K1 x 3 and the conv_last mode against its
    plain path on the card: float32 u8 |d| <= 1; bfloat16 >= 50 dB
    against the plain float32 path; int8 u8 |d| <= 1 against its plain
    path."""
    dev = _cuda()
    dt = DTYPES[name]
    cfg, params = _rrdb_x2_small()
    params = rrdb.params_to(params, dev)
    u8 = torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (2, 54, 70, 3), np.uint8)).to(dev)
    before = dict(LAUNCHES)
    got = rrdb.apply(rrdb.prepare(params, dt), u8, cfg=cfg, compute_dtype=dt)
    torch.cuda.synchronize()
    n = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    assert (n["conv3x3_u8x2_bias"], n["conv3x3_u8_bias_prelu"],
            n["dense_conv"], n["conv3x3_bias_prelu"], n["conv_last_u8"]) \
        == (1, 0, 15 * cfg.num_block + 1, 3, 1)
    ref = rrdb.apply(params, u8, cfg=cfg, compute_dtype=torch.float32,
                     plain=True)
    assert got.shape == ref.shape == (2, 108, 140, 3)
    d = (got.int() - ref.int()).abs()
    if name == "float32":
        assert d.max().item() <= 1
        maxima = quantize.collect_maxima(params, u8, cfg=cfg)
        qb = quantize.build_qbody(params, cfg, maxima, margin=1.25)
        got8 = rrdb.apply_int8(params, rrdb.prepare_qbody(qb), u8, cfg=cfg)
        want8 = rrdb.apply_int8(params, qb, u8, cfg=cfg, plain=True)
        assert (got8.int() - want8.int()).abs().max().item() <= 1
    else:
        mse = (d.double() ** 2).mean().item()
        assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 50.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_rrdb_x2_engine_windows_are_byte_identical_to_whole_frames(dtype):
    """RRDB x2 through the engine's halo tiles (tile 16 at halo 24 on
    2 x 40 x 88 frames: windows of 40 x 64, even, as the unshuffle needs)
    on the card: byte-identical to each window run alone as a whole frame
    on a whole-frame engine (the kernels sum each output pixel the same
    way wherever it sits), in each dtype (int8 with the whole-frame
    engine's calibration)."""
    from reve_tpu_torch.ops import tiling

    _cuda()
    cfg, params = _rrdb_x2_small()
    frames = np.random.RandomState(12).randint(0, 256, (2, 40, 88, 3),
                                               np.uint8)
    kw = dict(compute_dtype=dtype, batch_size=2, preloaded=(cfg, params))
    whole = UpscaleEngine(tile=-1, **kw)
    tiled = UpscaleEngine(tile=16, **kw)
    if dtype == "int8":
        whole.calibrate_int8(frames)
        tiled.set_calibration(whole.get_calibration())
    got = tiled.upscale_frames(frames)
    assert tiled._plans[(40, 88)].tile == 16
    with whole._on_device():
        want = tiling.upscale_tiled(
            whole._forward, torch.from_numpy(frames).cuda(), scale=2,
            tile=16, halo=whole.halo, chunk=1).cpu().numpy()
    assert got.shape == want.shape == (2, 80, 176, 3)
    assert np.array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tiled", "tta"])
def test_rrdb_engine_tiles_and_tta_match_the_cpu_engine(mode):
    """RRDB through the engine's halo tiles (tile 16 at halo 24 on 40 x 72
    frames: windows of 40 x 64) and its TTA ensemble, on the card's
    kernels and on the CPU's plain versions, float32: u8 |d| <= 1."""
    _cuda()
    cfg, params = _rrdb_small()
    frames = np.random.RandomState(11).randint(0, 256, (3, 40, 72, 3),
                                               np.uint8)
    kw = dict(compute_dtype="float32", batch_size=2,
              tile=16 if mode == "tiled" else 0, tta=mode == "tta",
              preloaded=(cfg, params))
    card = UpscaleEngine(**kw)
    cpu = UpscaleEngine(device="cpu", **kw)
    got = card.upscale_frames(frames)
    want = cpu.upscale_frames(frames)
    assert got.shape == want.shape == (3, 160, 288, 3)
    assert int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max()) \
        <= 1
    if mode == "tiled":
        assert card._plans[(40, 72)].tile == 16


_CHUNKED_F32_RRDB = """
import json, sys
import numpy as np, torch
from reve_tpu_torch.models import rrdb
from reve_tpu_torch.pipeline.engine import UpscaleEngine
cfg = rrdb.RRDBConfig(num_block=1)
params = rrdb.init_params(cfg, torch.Generator().manual_seed(0))
frames = np.random.RandomState(0).randint(0, 256, (4, 1080, 1920, 3),
                                          np.uint8)
want = rrdb.apply(rrdb.params_to(params, "cuda"),
                  torch.from_numpy(frames[:1]).cuda(), cfg=cfg,
                  compute_dtype=torch.float32, plain=True).cpu().numpy()
torch.cuda.empty_cache()
out = {}
for tta in (False, True):
    eng = UpscaleEngine(compute_dtype="float32", batch_size=4, tta=tta,
                        preloaded=(cfg, params))
    free = eng._free_bytes()
    plan = eng._plan_execution(1080, 1920)
    a = eng.submit(frames).result()
    b = eng.submit(frames).result()
    out[str(tta)] = dict(plan=list(plan), calls=eng.stats.calls,
                         same=bool(np.array_equal(a, b)), free=free)
    if not tta:
        out["max_d"] = int(np.abs(a[:1].astype(np.int16)
                                  - want.astype(np.int16)).max())
    del eng, a, b
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


@pytest.mark.cuda
def test_chunked_float32_rrdb_runs_with_fixed_allocator_segments():
    """A float32 RRDB batch of 4 1080p frames, past one call on an 80 GB
    card, runs in the plan's chunks twice in a row, and with TTA, under
    PYTORCH_CUDA_ALLOC_CONF=expandable_segments:False (the allocator's
    fixed segments: a tensor left in a freed segment of a chunk would keep
    the next chunk's tens of gigabytes from fitting), in a process of its
    own: the second batch is byte-identical to the first and frame 0 is
    within u8 |d| <= 1 of the plain float32 path."""
    import json
    import os
    import subprocess
    import sys

    _cuda()
    # this process's cached segments would leave the child little memory
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:"
               "False", PYTHONPATH=root)
    run = subprocess.run([sys.executable, "-c", _CHUNKED_F32_RRDB],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    for tta in ("False", "True"):
        tile, per_call = out[tta]["plan"]
        assert tile == 0 and 1 <= per_call < 4, out
        assert out[tta]["same"], out
    assert out["False"]["calls"] == 2 * -(-4 // out["False"]["plan"][1])
    assert out["max_d"] <= 1, out


# -- RRDB int8: K7q, the model, the engine's memory -----------------------------

#: K7q's forms on the model's path: (Cin, Cout, epilogue); "add" once with
#: a float32 and once with a bfloat16 feat
K7Q_FORMS = [(64, 32, "lrelu_q"), (96, 32, "lrelu_q"), (128, 32, "lrelu_q"),
             (160, 32, "lrelu_q"), (192, 64, "rdb"), (192, 64, "rrdb"),
             (64, 64, "add"), (64, 64, "add_bf16")]


def _k7q_case(seed, B, H, W, cin, cout, epi, dev, x_max=127, w_max=127):
    """Operands of one K7q call: a random s8 192-channel buffer, s8
    weights, per-channel sw and b at the model's scale, 1 / s_next, and
    float32 residuals (add: feat, float32 or bfloat16)."""
    rs = np.random.RandomState(seed)

    def s8(shape, m):
        return torch.from_numpy(rs.randint(-m, m + 1, shape)
                                .astype(np.int8)).to(dev)

    def f32(shape, lo, hi):
        return torch.from_numpy(rs.uniform(lo, hi, shape)
                                .astype(np.float32)).to(dev)

    c = dict(buf=s8((B, H, W, 192), x_max), w8=s8((3, 3, cin, cout), w_max),
             sw=f32(cout, 2e-6, 8e-6), b=f32(cout, -0.05, 0.05),
             inv=1.0 / f32((), 0.01, 0.03), res=f32((B, H, W, cout), -2, 2),
             res2=f32((B, H, W, cout), -2, 2))
    if epi == "add_bf16":
        c["res"] = c["res"].bfloat16()
    return c


def _k7q_run(c, cin, epi, plain):
    """K7q or its plain version on copies of the case's tensors; returns
    (the s8 buffer it read, the other s8 buffer, the float output)."""
    buf, other = c["buf"].clone(), torch.zeros_like(c["buf"])
    kw = dict(inv=c["inv"], out8=other)
    if epi == "lrelu_q":
        kw.update(out8=buf, out8_off=cin)
        out = None
    elif epi == "rdb":
        out = torch.zeros_like(c["res"])
        kw.update(res=c["res"], out=out)
    elif epi == "rrdb":
        out = c["res2"].clone()  # written over in place
        kw.update(res=c["res"], res2=out, out=out)
    else:
        out = c["res"].clone()  # feat, written over in place
        kw = dict(res=out, out=out)
    fn = k7.dense_conv_s8_plain if plain else k7.dense_conv_s8
    fn(buf, cin, c["w8"], c["sw"], c["b"], epi.replace("_bf16", ""), **kw)
    return buf, other, out


def _k7q_exact(got, want):
    for g, w in zip(got, want):
        if g is not None:
            assert int((g != w).sum()) == 0, (g.dtype, int((g != w).sum()))


#: K7q's tiles are 8 x 64 at Cout 32 and 4 x 64 at Cout 64: K7's shapes,
#: and frames smaller than one tile, one row short of two and one past
#: them, a tile wide, one pixel wider and one narrower
K7Q_SHAPES = K7_SHAPES + [(1, 3, 30), (2, 7, 64), (1, 15, 65),
                          (3, 12, 127), (1, 33, 191)]


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,epi", K7Q_FORMS)
def test_k7q_matches_plain_at_tile_edges(cin, cout, epi):
    """Each K7q form exact against its plain version (s8 codes n_diff 0,
    float32 and bfloat16 outputs bit-identical: integer sums and the same
    float32 steps, each rounded on its own) on ragged and whole tiles,
    the rrdb form in place over res2, add over feat."""
    dev = _cuda()
    for i, (B, H, W) in enumerate(K7Q_SHAPES):
        c = _k7q_case(cin + i, B, H, W, cin, cout, epi, dev)
        before = LAUNCHES["dense_conv_s8"]
        got = _k7q_run(c, cin, epi, plain=False)
        want = _k7q_run(c, cin, epi, plain=True)
        torch.cuda.synchronize()
        _k7q_exact(got, want)
        assert LAUNCHES["dense_conv_s8"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,epi,shape", [
    (96, 32, "lrelu_q", (2, 9, 70)), (96, 32, "lrelu_q", (1, 5, 129)),
    (160, 32, "lrelu_q", (2, 9, 70)), (160, 32, "lrelu_q", (1, 5, 129)),
    (192, 64, "rdb", (2, 9, 70)), (192, 64, "rdb", (1, 5, 129)),
    (192, 64, "rrdb", (2, 9, 70))])
def test_k7q_at_saturation_and_past_2_24(cin, cout, epi, shape):
    """Inputs and weights at +-127 of one sign make |acc| up to 9 x 192 x
    127^2 > 2^24, where float32(acc) rounds (to nearest even, in both),
    and drive the quantize into its clip at +-127: still exact, on frames
    of ragged tiles.  (rrdb's residuals damp its sum by 0.04: at (1, 5,
    129) these seeds reach no clip, so it runs at the first shape only.)"""
    dev = _cuda()
    c = _k7q_case(7, *shape, cin, cout, epi, dev, x_max=1, w_max=1)
    c["buf"] = c["buf"].clamp(0, 1) * 127
    c["w8"] = torch.where(c["w8"] >= 0, 127, -127).to(torch.int8)
    got = _k7q_run(c, cin, epi, plain=False)
    want = _k7q_run(c, cin, epi, plain=True)
    torch.cuda.synchronize()
    _k7q_exact(got, want)
    written = got[0][..., cin:cin + cout] if epi == "lrelu_q" else \
        got[1][..., :cout]
    assert bool((written.abs() == 127).any())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 19, 45), (1, 9, 130)])
def test_k7q_writes_only_its_channels(shape):
    """The TMA-stored s8 codes land only in their Cout channels of the
    192-B pixels: lrelu_q its growth slice of the buffer it reads, at
    every offset the model writes; rdb and rrdb the first 64 channels of
    the other buffer; every pixel of the frame written, none past it."""
    dev = _cuda()
    for cin in (64, 96, 128, 160):
        c = _k7q_case(3 + cin, *shape, cin, 32, "lrelu_q", dev)
        buf = c["buf"].clone()
        k7.dense_conv_s8(buf, cin, c["w8"], c["sw"], c["b"], "lrelu_q",
                         inv=c["inv"], out8=buf, out8_off=cin)
        want = c["buf"].clone()
        k7.dense_conv_s8_plain(want, cin, c["w8"], c["sw"], c["b"],
                               "lrelu_q", inv=c["inv"], out8=want,
                               out8_off=cin)
        torch.cuda.synchronize()
        assert torch.equal(buf, want), cin
    for epi in ("rdb", "rrdb"):
        c = _k7q_case(4, *shape, 192, 64, epi, dev)
        other = c["buf"].flip(0).contiguous()
        before = other.clone()
        out = c["res2"].clone()
        k7.dense_conv_s8(c["buf"], 192, c["w8"], c["sw"], c["b"], epi,
                         inv=c["inv"], out8=other, res=c["res"],
                         res2=out if epi == "rrdb" else None, out=out)
        torch.cuda.synchronize()
        assert torch.equal(other[..., 64:], before[..., 64:])
        assert not torch.equal(other[..., :64], before[..., :64])


@pytest.mark.cuda
def test_k7q_refuses_a_kernel_off_its_register_budget(tmp_path):
    """setmaxnreg hands the producer's registers to the consumers, which
    hangs the card unless the block holds them: a build of rrdb_s8.cu
    whose check expects another register count than ptxas gave refuses
    every launch with an error (cudaErrorLaunchOutOfResources), writes
    nothing, and the wrapper's check raises."""
    import ctypes
    import os
    import subprocess

    from reve_tpu_torch.kernels import build

    dev = _cuda()
    with open(os.path.join(build.CSRC, k7.S8_SOURCE)) as f:
        text = f.read()
    check = "if (attr.numRegs != LAUNCH_REGS)"
    assert text.count(check) == 1
    cu = tmp_path / "rrdb_s8_budget.cu"
    cu.write_text(text.replace(check, "if (attr.numRegs != LAUNCH_REGS + 8)"))
    so = str(tmp_path / "librrdb_s8_budget.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC,
                    "-o", so, str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    fn = lib.reve_dense_conv_s8
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for cin, cout, epi in K7Q_FORMS[:1] + K7Q_FORMS[4:6]:
        c = _k7q_case(9, 2, 19, 45, cin, cout, epi, dev)
        buf, other = c["buf"].clone(), torch.zeros_like(c["buf"])
        out = c["res2"].clone()
        wp = k7.pack_weights_dense_s8(c["w8"])
        lrelu = epi == "lrelu_q"
        inv = c["inv"].reshape(1).contiguous()
        err = fn(buf.data_ptr(), wp.data_ptr(), c["sw"].data_ptr(),
                 c["b"].data_ptr(), inv.data_ptr(),
                 None if lrelu else c["res"].data_ptr(),
                 out.data_ptr() if epi == "rrdb" else None,
                 None if lrelu else out.data_ptr(),
                 buf.data_ptr() + cin if lrelu else other.data_ptr(),
                 2, 19, 45, cin, 192, cout, 192,
                 k7.EPILOGUES_S8.index(epi), 0,
                 torch.cuda.current_stream(dev).cuda_stream)
        torch.cuda.synchronize()
        assert err == 701, err  # cudaErrorLaunchOutOfResources
        with pytest.raises(RuntimeError):
            build.check(lib, err, "dense_conv_s8")
        assert torch.equal(buf, c["buf"]) and not other.any()
        assert torch.equal(out, c["res2"])


def _rrdb_int8_small(dev, num_block=2):
    """A 2-block RRDB (seeded biases) with a quantization calibrated on
    seeded frames on the card: (cfg, float32 params, bf16-prepared
    params, K7q-prepared qbody)."""
    cfg, params = _rrdb_small(num_block)
    params = rrdb.params_to(params, dev)
    u8 = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, (2, 24, 70, 3), np.uint8)).to(dev)
    maxima = quantize.collect_maxima(rrdb.prepare(params, torch.float32), u8,
                                     cfg=cfg, percentile=99.9)
    qb = rrdb.prepare_qbody(quantize.build_qbody(params, cfg, maxima,
                                                 margin=1.25))
    return cfg, params, rrdb.prepare(params, torch.bfloat16), qb


@pytest.mark.cuda
def test_rrdb_int8_model_kernels_match_plain():
    """apply_int8 through K3, K7q (15 per block + conv_body), K1 x 3 and
    the conv_last mode against its plain path on the card: the s8 trunk
    is exact, the bf16 head sums in another order (u8 |d| <= 1, >= 60
    dB)."""
    dev = _cuda()
    cfg, params, prepared, qb = _rrdb_int8_small(dev)
    u8 = torch.from_numpy(np.random.RandomState(6).randint(
        0, 256, (2, 24, 70, 3), np.uint8)).to(dev)
    before = dict(LAUNCHES)
    got = rrdb.apply_int8(prepared, qb, u8, cfg=cfg)
    torch.cuda.synchronize()
    n = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    assert (n["conv3x3_u8_bias_prelu"], n["dense_conv_s8"],
            n["dense_conv"], n["conv3x3_bias_prelu"],
            n["conv_last_u8"]) == (1, 15 * cfg.num_block + 1, 0, 3, 1)
    ref = rrdb.apply_int8(params, qb, u8, cfg=cfg, plain=True)
    assert got.shape == ref.shape == (2, 96, 280, 3)
    d = (got.int() - ref.int()).abs()
    mse = (d.double() ** 2).mean().item()
    assert d.max().item() <= 1
    assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 60.0


@pytest.mark.cuda
def test_rrdb_int8_engine_peak_memory_within_its_bill():
    """One call of an int8 RRDB engine (2 frames of 540 x 960) peaks at
    most at what the memory plan bills for it (_rrdb_bytes: the bf16 head
    at 4x, past the s8 trunk); its calibration and certification (the
    float32 model) leave the allocator's cache empty."""
    dev = _cuda()
    cfg, params = _rrdb_small()
    eng = UpscaleEngine(compute_dtype="int8", batch_size=2,
                        preloaded=(cfg, params))
    frames = np.random.RandomState(8).randint(0, 256, (2, 540, 960, 3),
                                              np.uint8)
    assert eng.certify_int8(frames) > 0
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved() - torch.cuda.memory_allocated() \
        < 2 ** 28
    plan = eng._plan_execution(540, 960)
    x = torch.from_numpy(frames).to(dev)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with eng._on_device():
        y = eng._forward(x[:plan.per_call])
    torch.cuda.synchronize()
    del y
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= plan.per_call * eng._frame_bytes(540, 960), peak


# -- T1-T3, the training kernels ---------------------------------------------

TRAIN_PAIRS = list(train.PAIRS)


def _rel_close(got, want, what, rel=1e-5):
    err = float((got - want).abs().max())
    ref = float(want.abs().max())
    assert err <= rel * ref, f"{what}: max |d| {err} > {rel} x {ref}"


def _train_inputs(dev, cin, cout, shape=(2, 19, 45), seed=0):
    B, H, W = shape
    rs = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(9 * cin)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    z_prev = rs.randn(B, H, W, cin)
    z_prev[rs.rand(B, H, W, cin) < 0.05] = 0.0  # PReLU's tie
    return {"x": t(rs.rand(B, H, W, cin) * 2 - 0.5),
            "w": t(rs.uniform(-bound, bound, (3, 3, cin, cout))),
            "b": t(rs.uniform(-0.1, 0.1, (cout,))),
            "alpha": t(rs.uniform(0.05, 0.4, (cout,))),
            "dz": t(rs.randn(B, H, W, cout) * 1e-3),
            "z_prev": t(z_prev),
            "alpha_prev": t(rs.uniform(0.05, 0.4, (cin,)))}


#: the ragged pixel count first; then a training step's 8 x 64 x 64 and the
#: edges of T1's and T3's 2 x 64 tiles
TRAIN_SHAPES = [(2, 19, 45), (8, 64, 64), (1, 1, 1), (3, 7, 63),
                (1, 65, 129)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
@pytest.mark.parametrize("cin,cout", TRAIN_PAIRS)
def test_training_kernels_match_plain(cin, cout, shape):
    dev = _cuda()
    d = _train_inputs(dev, cin, cout, shape)
    for alpha, save_z in ((d["alpha"], True), (d["alpha"], False),
                          (None, True)):
        before = LAUNCHES["conv3x3_fwd_train"]
        y, z = train.conv3x3_fwd_train(d["x"], d["w"], d["b"], alpha, save_z)
        assert LAUNCHES["conv3x3_fwd_train"] == before + 1
        y0, z0 = train.conv3x3_fwd_train_plain(d["x"], d["w"], d["b"], alpha,
                                               save_z)
        _rel_close(y, y0, f"T1 y ({alpha is None}, {save_z})")
        assert (z is None) == (z0 is None)
        if z is not None:
            _rel_close(z, z0, "T1 z")
        y2, z2 = train.conv3x3_fwd_train(d["x"], d["w"], d["b"], alpha,
                                         save_z)
        assert torch.equal(y, y2) and (z is None or torch.equal(z, z2))
    dzp, da = train.conv3x3_dgrad(d["dz"], d["w"], d["z_prev"],
                                  d["alpha_prev"])
    # the plain versions at the other shapes in float64 (T2's too: its
    # d(alpha) sums every pixel)
    f = (lambda t: t) if shape == TRAIN_SHAPES[0] else (lambda t: t.double())
    dzp0, da0 = train.conv3x3_dgrad_plain(f(d["dz"]), f(d["w"]),
                                          f(d["z_prev"]),
                                          f(d["alpha_prev"]))
    _rel_close(dzp, dzp0, "T2 dz_prev")
    _rel_close(da, da0, "T2 dalpha")
    dzp2, da2 = train.conv3x3_dgrad(d["dz"], d["w"], d["z_prev"],
                                    d["alpha_prev"])
    assert torch.equal(dzp, dzp2) and torch.equal(da, da2)
    dw, db = train.conv3x3_wgrad(d["x"], d["dz"])
    dw0, db0 = train.conv3x3_wgrad_plain(f(d["x"]), f(d["dz"]))
    _rel_close(dw, dw0, "T3 dw")
    _rel_close(db, db0, "T3 db")
    dw2, db2 = train.conv3x3_wgrad(d["x"], d["dz"])
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 64, 64), (2, 19, 45)])
@pytest.mark.parametrize("cin,cout", TRAIN_PAIRS)
def test_t2_matches_plain_with_weights_distinct_per_tap_and_unit(
        cin, cout, shape):
    """T2 with each tap's weights and each 32-channel unit of Cout scaled
    by its own factor (1 + tap + 9 unit: a unit or tap read from the wrong
    place, or a wrong mirror, shows beyond the tolerance), z_prev exactly 0
    at some pixels, against its plain version in float64; launched twice,
    bit for bit; one launch counted each."""
    dev = _cuda()
    d = _train_inputs(dev, cin, cout, shape, seed=7)
    unit = torch.arange(cout, device=dev) // 32
    tap = torch.arange(9, device=dev).view(3, 3, 1, 1)
    w = (d["w"] * (1 + tap + 9 * unit)).contiguous()
    before = LAUNCHES["conv3x3_dgrad"]
    dzp, da = train.conv3x3_dgrad(d["dz"], w, d["z_prev"], d["alpha_prev"])
    dzp2, da2 = train.conv3x3_dgrad(d["dz"], w, d["z_prev"],
                                    d["alpha_prev"])
    torch.cuda.synchronize()
    assert LAUNCHES["conv3x3_dgrad"] == before + 2
    assert torch.equal(dzp, dzp2) and torch.equal(da, da2)
    dzp0, da0 = train.conv3x3_dgrad_plain(
        d["dz"].double(), w.double(), d["z_prev"].double(),
        d["alpha_prev"].double())
    _rel_close(dzp, dzp0, "T2 dz_prev")
    _rel_close(da, da0, "T2 dalpha")


@pytest.mark.cuda
def test_t1_and_t3_run_on_wgmma_in_each_kernel():
    """Each of T1's, T2's and T3's 23 kernels (one a channel pair of
    train.PAIRS) holds wgmma (HGMMA) in its SASS, and the training library
    no TF32 product or float atomic: no CUDA-core form of T1, T2 or T3 is
    left (train.sass_faults, the check the smoke's build phase runs).
    ptxas's spill bytes by kernel are printed."""
    _cuda()
    assert train.sass_faults() == []
    print({k: n for k, n in train.build.spills(train.SOURCE).items() if n})


@pytest.mark.cuda
@pytest.mark.parametrize("feat,r", [(64, 2), (64, 3), (32, 3), (96, 2)])
def test_training_steps_repeat_bit_for_bit_at_x2_and_x3(feat, r):
    """Three Trainer steps of a seeded SRVGG (2 hidden convs) at x2 and x3
    and 32 and 96 features on T1-T3, twice: the losses and the params bit
    for bit; each loss within 1e-4 of the same steps on the plain
    versions; T1-T3 launched as the depth says."""
    from reve_tpu_torch import kernels
    from reve_tpu_torch.train import trainer

    dev = _cuda()
    cfg = srvgg.SRVGGConfig(num_feat=feat, num_conv=2, upscale=r)
    params = srvgg.init_params(cfg, torch.Generator().manual_seed(r))
    rs = np.random.RandomState(feat + r)
    batches = []
    for _ in range(3):
        hr = rs.rand(4, 24 * r, 40 * r, 3).astype(np.float32)
        batches.append((hr.reshape(4, 24, r, 40, r, 3).mean((2, 4)), hr))
    runs = []
    for plain in (False, False, True):
        tr = trainer.Trainer(cfg, params=params, device=dev, plain=plain)
        kernels.reset_launches()
        losses = [tr.step(lr, hr) for lr, hr in batches]
        launches = {k: kernels.LAUNCHES[k] for k in (
            "conv3x3_fwd_train", "conv3x3_dgrad", "conv3x3_wgrad")}
        runs.append((losses, trainer.leaves(tr.params), launches))
    (l0, p0, n0), (l1, p1, _), (lp, _, np_) = runs
    assert l0 == l1 and all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert n0 == {"conv3x3_fwd_train": 3 * 4, "conv3x3_dgrad": 3 * 3,
                  "conv3x3_wgrad": 3 * 4}
    assert not any(np_.values())
    for a, b in zip(l0, lp):
        assert np.isfinite(a) and abs(a - b) <= 1e-4 * abs(b), (l0, lp)


@pytest.mark.cuda
def test_training_kernels_refuse_other_widths():
    dev = _cuda()
    x = torch.zeros(1, 4, 4, 32, device=dev)
    w = torch.zeros(3, 3, 32, 64, device=dev)
    with pytest.raises(ValueError, match=train.WIDTHS_ITEM):
        train.conv3x3_fwd_train(x, w, torch.zeros(64, device=dev))


@pytest.mark.cuda
def test_conv_stack_gradients_match_torch_autograd():
    """The Function on T1-T3 against torch autograd through F.conv2d and
    PReLU as torch ops: a 2-conv model (3 -> 64 + PReLU, 64 -> 48)."""
    dev = _cuda()
    rs = np.random.RandomState(3)
    cfg = srvgg.SRVGGConfig(num_feat=64, num_conv=0, upscale=4)
    params = srvgg.params_to(srvgg.init_params(cfg), dev)
    flat = train.flat_params(params)
    for t in flat:
        t.requires_grad_(True)
    x = torch.from_numpy(rs.rand(4, 32, 40, 3).astype(np.float32)).to(dev)
    ct = torch.from_numpy(rs.randn(4, 32, 40, 48).astype(np.float32)).to(dev)
    out = train.conv_stack(x, params)
    got = torch.autograd.grad((out * ct).sum(), flat)

    def conv(h, w, b):
        return torch.nn.functional.conv2d(
            h.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
            padding=1).permute(0, 2, 3, 1) + b

    torch.backends.cudnn.allow_tf32 = False
    w0, b0, a0, w1, b1 = flat
    h = conv(x, w0, b0)
    ref_out = conv(h.clamp_min(0) + a0 * h.clamp_max(0), w1, b1)
    want = torch.autograd.grad((ref_out * ct).sum(), flat)
    _rel_close(out.detach(), ref_out.detach(), "stack output")
    for name, g, w in zip(("w0", "b0", "alpha0", "w1", "b1"), got, want):
        _rel_close(g, w, name)


# -- K9: RGB u8 -> YUV 4:2:0 codes (csrc/color.cu) -------------------------

K9_FORMS = [YUVFormat(m, fr, b) for m in ("bt601", "bt709")
            for fr in (False, True) for b in (8, 10)]
K9_IDS = [f"{f.matrix}-{'full' if f.full_range else 'limited'}-{f.bits}"
          for f in K9_FORMS]


def _k9_n_diff(x, fmt):
    got = color_k.rgb_to_yuv420_u8(x, fmt)
    want = color_k.rgb_to_yuv420_u8_plain(x, fmt)
    assert [g.dtype for g in got] == [w.dtype for w in want]
    assert [g.shape for g in got] == [w.shape for w in want]
    return sum(int((g != w).sum()) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2, 2), (3, 2, 66), (2, 18, 130),
                                   (1, 1080, 1920), (4, 4320, 7680)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("fmt", K9_FORMS, ids=K9_IDS)
def test_k9_is_exact_against_plain(fmt, shape):
    """K9 gives the plain version's codes, bit for bit (n_diff 0), in
    every form: the byte form (W % 16 != 0) and the vector form, a
    batch slice whose rows start off the 16-B grid, and values at every
    u8 level."""
    dev = _cuda()
    b, h, w = shape
    rs = np.random.RandomState(h * w % 977)
    x = torch.from_numpy(rs.randint(0, 256, (b, h, w, 3), np.uint8)).to(dev)
    n = min(768, x.numel())
    x.view(-1)[:n] = torch.arange(n, device=dev).to(torch.uint8)
    before = LAUNCHES["rgb_to_yuv420_u8"]
    assert _k9_n_diff(x, fmt) == 0
    assert LAUNCHES["rgb_to_yuv420_u8"] == before + 1
    if b > 1:
        assert _k9_n_diff(x[1:], fmt) == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_k9_refuses_what_it_does_not_take():
    dev = _cuda()
    fmt = YUVFormat("bt601", False, 8)
    x = torch.zeros(1, 4, 6, 3, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="even"):
        color_k.rgb_to_yuv420_u8(x[:, :3], fmt)
    with pytest.raises(ValueError, match="even"):
        color_k.rgb_to_yuv420_u8(x[:, :, :5], fmt)
    with pytest.raises(ValueError, match="uint8"):
        color_k.rgb_to_yuv420_u8(x.float(), fmt)
    with pytest.raises(ValueError, match="contiguous"):
        color_k.rgb_to_yuv420_u8(x.transpose(1, 2), fmt)
    with pytest.raises(ValueError, match="bits"):
        color_k.rgb_to_yuv420_u8(x, YUVFormat("bt601", False, 12))


@pytest.mark.cuda
def test_k9_contracts_no_multiply_add():
    """The PTX holds only the _rn float ops and no fma; the SASS as many
    FFMA as a build with -fmad=false (the divisions' own)."""
    _cuda()
    assert color_k.contraction_faults() == []


@pytest.mark.cuda
def test_y4m_job_on_the_card_encodes_planes_made_by_k9(tmp_path,
                                                       monkeypatch):
    """A y4m CLI job on the card: every batch's planes come from K9 (one
    launch a piece: a whole-frame chunk each here), the encode thread
    never converts colour on the host, and the file equals the RGB
    route's (the writer's own write(rgb)) byte for byte."""
    import fractions

    from reve_tpu_torch import cli, kernels
    from reve_tpu_torch.io import writer
    from reve_tpu_torch.ops import color_np

    _cuda()
    inp = str(tmp_path / "in.y4m")
    rs = np.random.RandomState(0)
    with writer.Y4MWriter(inp, 64, 48, fractions.Fraction(24)) as wr:
        for _ in range(5):
            wr.write(rs.randint(0, 256, (48, 64, 3), np.uint8))
    pth = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "models", "realesr-animevideov3-x4.pth")
    argv = ["-s", "4", "--io-backend", "y4m", "--weights", pth, "-S", "3",
            "--batch", "2", "--yes"]
    monkeypatch.chdir(tmp_path)

    def no_host_conversion(*a, **k):
        raise AssertionError("color_np ran on the encode thread")

    with monkeypatch.context() as m:
        m.setattr(color_np, "rgb_to_yuv420_np", no_host_conversion)
        kernels.reset_launches()
        assert cli.run(["-i", inp, str(tmp_path / "planes.y4m")] + argv) \
            == 0
        launched = dict(kernels.LAUNCHES)
    # 5 frames in segments of 3 at batches of 2: 3 batches, each one call
    assert launched["head_conv_residual_u8_shuffle"] == 3
    assert launched["rgb_to_yuv420_u8"] == 3
    with monkeypatch.context() as m:
        m.setattr(writer, "planes_format", lambda *a, **k: None)
        assert cli.run(["-i", inp, str(tmp_path / "rgb.y4m")] + argv) == 0
    assert open(tmp_path / "planes.y4m", "rb").read() == \
        open(tmp_path / "rgb.y4m", "rb").read()
