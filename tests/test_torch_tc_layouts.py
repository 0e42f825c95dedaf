"""What the tensor-core kernels take, held on the CPU: the bf16x3 split
and six-pass product of float32 K1 and K2 (csrc/conv3x3_f32_tc.cu)
against the JAX package's float32 conv and head epilogue, and the weight
packers of float32 K1/K2 and K4/K4h (csrc/conv3x3_s8.cu) against their
index formulas, at every N the kernels take (64 for the hidden convs;
16, 32, 48 for the heads at r = 2, 3, 4, zero-padded).

Tolerances: the split is exact (hi + mid + lo == x); the six-pass
emulation, float32 convs of each bf16 pair summed in float32, is held to
reve_tpu's `_conv3x3` at float32 (Precision.HIGHEST) at the bound of
test_torch_kernels.py's float32 cases, atol 2e-5, rtol 1e-5, scaled by
2^8 with the inputs; through the head epilogue, u8 |d| <= 1 (a sum that
differs in its last bits may round y * 255 + 0.5 to the neighbouring
integer), on under 1% of the samples.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reve_tpu.models import srvgg as jsrvgg
from reve_tpu_torch.kernels import LAUNCHES, build, conv3x3, conv3x3_s8, head
from reve_tpu_torch.scripts import perf_conv_tc_parts

torch.set_num_threads(2)

#: the (activation, weight) split pairs float32 K1 sums on the tensor
#: cores (csrc/conv3x3_f32_tc.cu, mma_bf16x6): every product of parts
#: above 2^-24 of the result (hi = 0, mid = 1, lo = 2)
BF16X6_PAIRS = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))


def _values(kind, rs, n=4096):
    if kind == "random":
        return (rs.standard_normal(n) * np.exp2(rs.uniform(-30, 30, n)))
    if kind == "pm2^8":
        return rs.choice([-1.0, 1.0], n) * 2.0 ** 8 * rs.uniform(1, 2, n)
    if kind == "pm2^-20":
        return rs.choice([-1.0, 1.0], n) * 2.0 ** -20 * rs.uniform(1, 2, n)
    return np.zeros(n)


@pytest.mark.parametrize("kind", ["random", "pm2^8", "pm2^-20", "zeros"])
def test_split_bf16x3_reconstructs_float32_exactly(kind):
    rs = np.random.RandomState(len(kind))
    x = torch.from_numpy(_values(kind, rs).astype(np.float32))
    s = conv3x3.split_bf16x3(x)  # a CPU tensor: the plain version
    assert s.shape == (3, x.numel()) and s.dtype == torch.bfloat16
    hi, mid, lo = s.float()
    assert torch.equal(hi + mid + lo, x)
    assert torch.equal(hi, x.to(torch.bfloat16).float())
    # each part is below half an ulp of the one before
    assert bool((mid.abs() <= hi.abs() * 2.0 ** -8).all())
    assert bool((lo.abs() <= mid.abs() * 2.0 ** -8).all())
    assert all(v == 0 for v in LAUNCHES.values())


def _inputs(seed, B=2, H=9, W=13, scale=1.0, cout=64):
    rs = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(9 * 64)
    return {
        "x": ((rs.rand(B, H, W, 64) * 2 - 0.5) * scale).astype(np.float32),
        "w": rs.uniform(-bound, bound, (3, 3, 64, cout)).astype(np.float32),
        "b": rs.uniform(-0.1, 0.1, (cout,)).astype(np.float32),
        "u8": rs.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
    }


def _conv_bf16_pairs(x, w, b, pairs):
    """float32 conv of each (activation, weight) bf16 pair of the splits,
    summed smallest first in float32, + b: the products float32 K1 sums
    on the tensor cores."""
    xs, ws = conv3x3.split_bf16x3(x), conv3x3.split_bf16x3(w)
    zero = torch.zeros(w.shape[-1])
    acc = None
    for i, j in reversed(pairs):
        t = conv3x3.conv3x3_plain(xs[i].float(), ws[j].float(), zero)
        acc = t if acc is None else acc + t
    return acc + b


@pytest.mark.parametrize("scale", [1.0, 2.0 ** 8])
def test_bf16x6_product_matches_jax_float32_conv(scale):
    d = _inputs(3, scale=scale)
    want = np.asarray(jsrvgg._conv3x3(jnp.asarray(d["x"]),
                                      jnp.asarray(d["w"]),
                                      jnp.asarray(d["b"])))
    got = _conv_bf16_pairs(torch.from_numpy(d["x"]), torch.from_numpy(d["w"]),
                           torch.from_numpy(d["b"]), BF16X6_PAIRS)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * scale,
                               rtol=1e-5)


@pytest.mark.parametrize("scale", [1.0, 2.0 ** 8])
@pytest.mark.parametrize("r", [2, 3, 4])
def test_bf16x6_head_matches_jax_float32_head(r, scale):
    """float32 K2's six-pass product at 3r^2 outputs, then the head
    epilogue, against reve_tpu's float32 `_conv3x3` + `_epilogue(
    quantize_u8=True)` (the pixel shuffle included)."""
    d = _inputs(10 + r, scale=scale, cout=3 * r * r)
    h = np.maximum(d["x"], 0) * 0.5  # a hidden activation, as K1 hands it
    cfg = jsrvgg.SRVGGConfig(num_feat=64, num_conv=1, upscale=r)
    orig = jnp.asarray(d["u8"]).astype(jnp.float32) * (1.0 / 255.0)
    want = np.asarray(jsrvgg._epilogue(
        jsrvgg._conv3x3(jnp.asarray(h), jnp.asarray(d["w"]),
                        jnp.asarray(d["b"])), orig, cfg, quantize_u8=True))
    hv = _conv_bf16_pairs(torch.from_numpy(h), torch.from_numpy(d["w"]),
                          torch.from_numpy(d["b"]), BF16X6_PAIRS)
    got = head.residual_u8_plain(hv, torch.from_numpy(d["u8"]), r).numpy()
    assert got.shape == want.shape == (2, 9 * r, 13 * r, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01, (diff > 0).mean()
    if scale == 1.0:  # not clipped flat: the comparison has something
        assert np.unique(want).size > 64


def test_bf16_alone_is_not_float32():
    """The hi.hi product alone (a bf16 conv) misses the tolerance the six
    passes meet: the split is what carries float32 accuracy."""
    d = _inputs(4)
    want = np.asarray(jsrvgg._conv3x3(jnp.asarray(d["x"]),
                                      jnp.asarray(d["w"]),
                                      jnp.asarray(d["b"])))
    got = _conv_bf16_pairs(torch.from_numpy(d["x"]), torch.from_numpy(d["w"]),
                           torch.from_numpy(d["b"]), ((0, 0),))
    assert np.abs(got.numpy() - want).max() > 1e-3


#: output channels -> the N the kernels run at: the hidden convs (64) and
#: the heads at r = 2, 3, 4 (3r^2 padded to a multiple of 8)
COUTS = {64: 64, 12: 16, 27: 32, 48: 48}


@pytest.mark.parametrize("cout", sorted(COUTS))
def test_bf16x3_weight_packer_matches_its_index_formula(cout):
    rs = np.random.RandomState(5)
    n_pad = COUTS[cout]
    assert conv3x3.padded_n(cout) == n_pad
    w = torch.from_numpy(rs.standard_normal((3, 3, 64, cout)).astype(
        np.float32))
    p = conv3x3.pack_weights_bf16x3(w)
    s = conv3x3.split_bf16x3(w)
    assert p.shape == (9, 3, 8, n_pad, 8) and p.dtype == torch.bfloat16
    assert p.is_contiguous()
    for t, sp, kb, n, kk in zip(*(rs.randint(0, m, 500)
                                  for m in (9, 3, 8, n_pad, 8))):
        want = s[sp, t // 3, t % 3, 8 * kb + kk, n] if n < cout else 0
        assert p[t, sp, kb, n, kk] == want
    # the padded outputs are zero in every tap, split and k
    assert not p[:, :, :, cout:].any()


@pytest.mark.parametrize("cout", sorted(COUTS))
def test_s8_weight_packer_matches_its_index_formula(cout):
    rs = np.random.RandomState(6)
    n_pad = COUTS[cout]
    w8 = torch.from_numpy(rs.randint(-127, 128, (3, 3, 64, cout)).astype(
        np.int8))
    p = conv3x3_s8.pack_weights_s8(w8)
    assert p.shape == (9, 4, n_pad, 16) and p.dtype == torch.int8
    flat = p.reshape(-1)
    for t, kb, n, kk in zip(*(rs.randint(0, m, 500)
                              for m in (9, 4, n_pad, 16))):
        want = w8[t // 3, t % 3, 16 * kb + kk, n] if n < cout else 0
        assert p[t, kb, n, kk] == want
        # as [k / 16][n][16] bytes, k = tap * 64 + ci
        k = t * 64 + 16 * kb + kk
        assert flat[((k // 16) * n_pad + n) * 16 + k % 16] == \
            p[t, kb, n, kk]
    assert not p[:, :, cout:].any()
    if cout == 64:  # K4's packing: the layout it always had
        assert torch.equal(p, w8.reshape(9, 4, 16, 64).permute(0, 1, 3, 2))


def test_every_header_is_in_the_build_key():
    """Each csrc/*.cuh is hashed into every library's name (tc.cuh, the
    tensor-core kernels' shared header, among them), and the tensor-core
    sources are built."""
    on_disk = {f for f in os.listdir(build.CSRC) if f.endswith(".cuh")}
    assert on_disk == set(build.HEADERS)
    assert {conv3x3.TC_SOURCE, conv3x3.F32_SOURCE,
            conv3x3_s8.SOURCE} <= set(build.SOURCES)


@pytest.mark.parametrize("source, entries", [
    ("conv3x3_tc.cu", ("reve_conv3x3_bias_prelu_tc",
                       "reve_head_conv_residual_u8_shuffle_tc")),
    ("conv3x3_f32_tc.cu", ("reve_split_bf16x3",
                           "reve_conv3x3_bias_prelu_f32tc",
                           "reve_head_conv_residual_u8_shuffle_f32tc")),
    ("conv3x3_s8.cu", ("reve_conv3x3_s8_dq_prelu_q8",
                       "reve_head_conv_s8_residual_u8_shuffle_tc")),
])
def test_heads_live_beside_their_hidden_convs(source, entries):
    """Each head is its source's mainloop with the head epilogue: the
    source defines the C entry the wrapper calls, the kernel is one
    template on R, and the head epilogue is tc.cuh's, shared."""
    with open(os.path.join(build.CSRC, source)) as f:
        src = f.read()
    for entry in entries:
        assert f'extern "C" int {entry}(' in src
    if "head" in " ".join(entries):
        assert "HeadEpilogue<R>" in src and "residual_u8(" not in src


@pytest.mark.parametrize("source", sorted(perf_conv_tc_parts.PATCHES))
def test_parts_script_variants_still_apply(source):
    """Every variant of the parts timer finds the text it replaces once in
    the source, so the script keeps timing the kernel as it is."""
    with open(os.path.join(build.CSRC, source)) as f:
        original = f.read()
    for variant in perf_conv_tc_parts.PATCHES[source]:
        text = perf_conv_tc_parts.variant_source(source, variant)
        assert (text == original) == (variant == "full")


def test_split_pass_refuses_non_cuda_devices():
    x = torch.empty((1, 2, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3.split_bf16x3(x)
    assert all(v == 0 for v in LAUNCHES.values())
    assert not build._libs
