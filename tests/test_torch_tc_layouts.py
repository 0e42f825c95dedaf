"""What the tensor-core kernels take, held on the CPU: float32 K1's bf16x3
split and six-pass product (csrc/conv3x3_f32_tc.cu) against the JAX
package's float32 conv, and the weight packers of float32 K1 and K4
(csrc/conv3x3_s8.cu) against their index formulas.

Tolerances: the split is exact (hi + mid + lo == x); the six-pass
emulation, float32 convs of each bf16 pair summed in float32, is held to
reve_tpu's `_conv3x3` at float32 (Precision.HIGHEST) at the bound of
test_torch_kernels.py's float32 cases, atol 2e-5, rtol 1e-5, scaled by
2^8 with the inputs.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reve_tpu.models import srvgg as jsrvgg
from reve_tpu_torch.kernels import LAUNCHES, build, conv3x3, conv3x3_s8
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


def _inputs(seed, B=2, H=9, W=13, scale=1.0):
    rs = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(9 * 64)
    return {
        "x": ((rs.rand(B, H, W, 64) * 2 - 0.5) * scale).astype(np.float32),
        "w": rs.uniform(-bound, bound, (3, 3, 64, 64)).astype(np.float32),
        "b": rs.uniform(-0.1, 0.1, (64,)).astype(np.float32),
    }


def _conv_bf16_pairs(x, w, b, pairs):
    """float32 conv of each (activation, weight) bf16 pair of the splits,
    summed smallest first in float32, + b: the products float32 K1 sums
    on the tensor cores."""
    xs, ws = conv3x3.split_bf16x3(x), conv3x3.split_bf16x3(w)
    zero = torch.zeros(64)
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


def test_bf16x3_weight_packer_matches_its_index_formula():
    rs = np.random.RandomState(5)
    w = torch.from_numpy(rs.standard_normal((3, 3, 64, 64)).astype(
        np.float32))
    p = conv3x3.pack_weights_bf16x3(w)
    s = conv3x3.split_bf16x3(w)
    assert p.shape == (9, 3, 8, 64, 8) and p.dtype == torch.bfloat16
    assert p.is_contiguous()
    for t, sp, kb, n, kk in zip(*(rs.randint(0, m, 500)
                                  for m in (9, 3, 8, 64, 8))):
        assert p[t, sp, kb, n, kk] == s[sp, t // 3, t % 3, 8 * kb + kk, n]


def test_s8_weight_packer_matches_its_index_formula():
    rs = np.random.RandomState(6)
    w8 = torch.from_numpy(rs.randint(-127, 128, (3, 3, 64, 64)).astype(
        np.int8))
    p = conv3x3_s8.pack_weights_s8(w8)
    assert p.shape == (9, 4, 64, 16) and p.dtype == torch.int8
    flat = p.reshape(-1)
    for t, kb, n, kk in zip(*(rs.randint(0, m, 500) for m in (9, 4, 64, 16))):
        assert p[t, kb, n, kk] == w8[t // 3, t % 3, 16 * kb + kk, n]
        # as [k / 16][n][16] bytes, k = tap * 64 + ci
        k = t * 64 + 16 * kb + kk
        assert flat[((k // 16) * 64 + n) * 16 + k % 16] == p[t, kb, n, kk]


def test_every_header_is_in_the_build_key():
    """Each csrc/*.cuh is hashed into every library's name (tc.cuh, the
    tensor-core kernels' shared header, among them), and the tensor-core
    sources are built."""
    on_disk = {f for f in os.listdir(build.CSRC) if f.endswith(".cuh")}
    assert on_disk == set(build.HEADERS)
    assert {conv3x3.TC_SOURCE, conv3x3.F32_SOURCE,
            conv3x3_s8.SOURCE} <= set(build.SOURCES)


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
