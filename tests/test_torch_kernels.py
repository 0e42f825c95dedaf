"""The port's kernel modules (K1 conv3x3_bias_prelu, K3
conv3x3_u8_bias_prelu, K2 head_conv_residual_u8_shuffle) against the JAX
package's own ops, on the CPU.

On the CPU every wrapper runs its kernel's plain PyTorch version; these
tests hold that version to reve_tpu's `_conv3x3`/`_prelu`/`_epilogue` +
`pixel_shuffle` on the same numpy inputs:
  * float32: atol 2e-5, rtol 1e-5 (the bound of test_srvgg_model.py);
  * bfloat16: at most 1 bf16 ulp (2^-7 relative: both sides round the
    same float32 sum once, which differs only by accumulation order);
  * uint8: at most 1, on a handful of values whose float32 y*255+0.5
    lands within accumulation-order noise of an integer.
The CUDA kernels themselves are held to the plain versions by
tests/test_torch_kernels_cuda.py (marked `cuda`, skipped without a card)
and by chip_smoke.py.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reve_tpu.models import srvgg as jsrvgg
from reve_tpu_torch.kernels import LAUNCHES, build, conv3x3, head

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B=2, H=9, W=13, cin=64, cout=64):
    rs = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(9 * cin)
    return {
        "x": rs.rand(B, H, W, cin).astype(np.float32) * 2 - 0.5,
        "u8": rs.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
        "w": rs.uniform(-bound, bound, (3, 3, cin, cout)).astype(np.float32),
        "b": rs.uniform(-0.1, 0.1, (cout,)).astype(np.float32),
        "alpha": rs.uniform(0.05, 0.4, (cout,)).astype(np.float32),
    }


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_bf16_ulp(got, want, ulps=1):
    got = got.astype(np.float32)
    want = want.astype(np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    over = np.abs(got - want) > ulps * ulp
    assert not over.any(), (
        f"{over.sum()} values beyond {ulps} bf16 ulp; worst "
        f"{np.abs(got - want).max()}")


def _compare(got_t, want_j, name):
    got = got_t.float().numpy()
    want = _f32(want_j)
    if name == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    else:
        _assert_bf16_ulp(got, want)


@pytest.mark.parametrize("name", list(DTYPES))
def test_k1_plain_matches_jax_conv_prelu(name):
    jdt, tdt = DTYPES[name]
    d = _inputs(0)
    xj = jnp.asarray(d["x"]).astype(jdt)
    want = jsrvgg._prelu(
        jsrvgg._conv3x3(xj, jnp.asarray(d["w"]).astype(jdt),
                        jnp.asarray(d["b"])), jnp.asarray(d["alpha"]))
    got = conv3x3.conv3x3_bias_prelu(
        torch.from_numpy(d["x"]).to(tdt), torch.from_numpy(d["w"]).to(tdt),
        torch.from_numpy(d["b"]), torch.from_numpy(d["alpha"]))
    assert got.dtype == tdt and got.shape == (2, 9, 13, 64)
    _compare(got, want, name)


@pytest.mark.parametrize("name", list(DTYPES))
def test_k3_plain_matches_jax_u8_first_conv(name):
    """K3 = the engine's u8 * (1/255) (engine.py:645) cast to the compute
    dtype (srvgg.py:154), then the first conv + PReLU."""
    jdt, tdt = DTYPES[name]
    d = _inputs(1, cin=3)
    x = jnp.asarray(d["u8"]).astype(jnp.float32) * (1.0 / 255.0)
    want = jsrvgg._prelu(
        jsrvgg._conv3x3(x.astype(jdt), jnp.asarray(d["w"]).astype(jdt),
                        jnp.asarray(d["b"])), jnp.asarray(d["alpha"]))
    got = conv3x3.conv3x3_u8_bias_prelu(
        torch.from_numpy(d["u8"]), torch.from_numpy(d["w"]).to(tdt),
        torch.from_numpy(d["b"]), torch.from_numpy(d["alpha"]))
    _compare(got, want, name)


@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("name", list(DTYPES))
def test_k2_plain_matches_jax_epilogue(name, r):
    """K2 = head _conv3x3 + _epilogue(quantize_u8=True) + pixel_shuffle."""
    jdt, tdt = DTYPES[name]
    d = _inputs(2 + r, cout=3 * r * r)
    # a hidden activation in the compute dtype, as K1 would hand it over
    h = np.maximum(d["x"], 0) * 0.5
    cfg = jsrvgg.SRVGGConfig(num_feat=64, num_conv=1, upscale=r)
    hj = jnp.asarray(h).astype(jdt)
    orig = jnp.asarray(d["u8"]).astype(jnp.float32) * (1.0 / 255.0)
    want = np.asarray(jsrvgg._epilogue(
        jsrvgg._conv3x3(hj, jnp.asarray(d["w"]).astype(jdt),
                        jnp.asarray(d["b"])), orig, cfg, quantize_u8=True))
    got = head.head_conv_residual_u8_shuffle(
        torch.from_numpy(h).to(tdt), torch.from_numpy(d["w"]).to(tdt),
        torch.from_numpy(d["b"]), torch.from_numpy(d["u8"]), r).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == \
        (2, 9 * r, 13 * r, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    # rounding-boundary hits only: a tiny fraction of the samples
    assert (diff > 0).mean() < 0.01, (diff > 0).mean()


def test_residual_epilogue_is_exact_on_identical_head():
    """With the conv taken out (the same head tensor on both sides), the
    u8 epilogue + shuffle is bit-exact against reve_tpu's."""
    rs = np.random.RandomState(9)
    r = 3
    cfg = jsrvgg.SRVGGConfig(num_feat=16, num_conv=1, upscale=r)
    h = (rs.rand(1, 5, 7, 3 * r * r).astype(np.float32) - 0.5) * 0.6
    u8 = rs.randint(0, 256, (1, 5, 7, 3)).astype(np.uint8)
    orig = jnp.asarray(u8).astype(jnp.float32) * (1.0 / 255.0)
    want = np.asarray(jsrvgg._epilogue(jnp.asarray(h), orig, cfg,
                                       quantize_u8=True))
    got = head.residual_u8_plain(torch.from_numpy(h), torch.from_numpy(u8),
                                 r).numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    d = _inputs(4, B=1, H=5, W=6)
    x, w = torch.from_numpy(d["x"]), torch.from_numpy(d["w"])
    b, a = torch.from_numpy(d["b"]), torch.from_numpy(d["alpha"])
    before = dict(LAUNCHES)
    y = conv3x3.conv3x3_bias_prelu(x, w, b, a)
    torch.testing.assert_close(
        y, conv3x3.conv3x3_bias_prelu_plain(x, w, b, a), atol=0, rtol=0)
    u8 = torch.from_numpy(d["u8"])
    y3 = conv3x3.conv3x3_u8_bias_prelu(u8, w[:, :, :3], b, a)
    torch.testing.assert_close(
        y3, conv3x3.conv3x3_u8_bias_prelu_plain(u8, w[:, :, :3], b, a),
        atol=0, rtol=0)
    wh = torch.from_numpy(_inputs(5, cout=12)["w"])
    o = head.head_conv_residual_u8_shuffle(y, wh, b[:12], u8, 2)
    torch.testing.assert_close(
        o, head.head_conv_residual_u8_shuffle_plain(y, wh, b[:12], u8, 2),
        atol=0, rtol=0)
    assert LAUNCHES == before
    assert all(v == 0 for v in LAUNCHES.values())
    assert not build._libs  # nothing was built or loaded


def test_kernel_modules_import_without_nvcc_or_triton(monkeypatch):
    """Importing the kernel modules builds nothing: nvcc and triton are
    needed only when a CUDA tensor reaches a wrapper."""
    import importlib

    monkeypatch.setenv("PATH", "")
    monkeypatch.setitem(sys.modules, "triton", None)
    for mod in ("reve_tpu_torch.kernels.build",
                "reve_tpu_torch.kernels.conv3x3",
                "reve_tpu_torch.kernels.head"):
        importlib.reload(importlib.import_module(mod))
    assert not build._libs


def test_non_cuda_device_tensors_raise_instead_of_falling_back():
    """A tensor that is neither on the CPU nor on a CUDA device reaches
    the kernel path and is refused: there is no silent fallback."""
    x = torch.empty((1, 4, 4, 64), device="meta")
    w = torch.empty((3, 3, 64, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3.conv3x3_bias_prelu(x, w, torch.zeros(64), torch.zeros(64))
    with pytest.raises(ValueError, match="CUDA"):
        head.head_conv_residual_u8_shuffle(
            x, torch.empty((3, 3, 64, 12), device="meta"), torch.zeros(12),
            torch.empty((1, 4, 4, 3), dtype=torch.uint8, device="meta"), 2)
    assert all(v == 0 for v in LAUNCHES.values())


def test_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    """The library name changes with the source, so an edited kernel
    rebuilds instead of loading a stale library."""
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    (tmp_path / "common.cuh").write_text("// header\n")
    (tmp_path / "conv3x3.cu").write_text("// v1\n")
    p1 = build._lib_path("conv3x3.cu")
    (tmp_path / "conv3x3.cu").write_text("// v2\n")
    p2 = build._lib_path("conv3x3.cu")
    (tmp_path / "common.cuh").write_text("// header v2\n")
    p3 = build._lib_path("conv3x3.cu")
    assert len({p1, p2, p3}) == 3
    assert all(p.startswith(build.BUILD_DIR) for p in (p1, p2, p3))
