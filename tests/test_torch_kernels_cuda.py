"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a CUDA device (the
kernels have no CPU mode; their plain versions are held to the JAX
package by test_torch_kernels.py).  This file imports neither jax nor
reve_tpu, so it runs on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

Tolerances: float32 max |d| <= 1e-4 (float32 accumulation order);
bfloat16 <= 2 bf16 ulp relative (the kernel and the plain version may
round a float32 sum that differs in its last bits to neighbouring bf16
values, and PReLU rounds once more), the ulp taken at 2^-10 or more (a
sum that cancels to near zero may change sign between two summation
orders); uint8 |d| <= 1.
"""

import numpy as np
import pytest
import torch

from reve_tpu_torch.kernels import LAUNCHES, conv3x3, head
from reve_tpu_torch.models import srvgg

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


def _close(got, want, name):
    if name == "float32":
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        return
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -10)
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


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    x = torch.zeros((1, 4, 4, 32), device=dev)  # 32 channels, not 64
    with pytest.raises(ValueError, match="expected"):
        conv3x3.conv3x3_bias_prelu(x, torch.zeros((3, 3, 32, 64), device=dev),
                                   torch.zeros(64), torch.zeros(64))
    x = torch.zeros((1, 4, 4, 64), device=dev)
    with pytest.raises(TypeError):
        conv3x3.conv3x3_bias_prelu(
            x, torch.zeros((3, 3, 64, 64), device=dev, dtype=torch.float16),
            torch.zeros(64), torch.zeros(64))
