"""The port's SRVGG model (reve_tpu_torch.models.srvgg) against the JAX
package's (reve_tpu.models.srvgg) on the same numpy inputs, with the
weights carried across by params_from_jax.

The port's `apply` is u8 -> u8 (the engine's public boundary), so it is
held against `srvgg.apply(params, u8 / 255, quantize_u8=True)`, in both of
the JAX package's modes (the row space-to-depth form is exact):
  * float32: |du8| <= 1, on a tiny fraction of samples (float32
    accumulation-order noise next to a rounding boundary);
  * bfloat16: held to the JAX package's own bf16-vs-f32 error on the same
    input (the rule of test_srvgg_model.py::test_bfloat16_close_to_f32):
    the port's bf16 output must be no further from JAX's float32 output
    than JAX's bf16 output is, plus one u8 step, and lose at most 1 dB of
    PSNR against it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reve_tpu.models import srvgg as jsrvgg
from reve_tpu.weights.torch_loader import load_srvgg_pth as jload_pth
from reve_tpu_torch.models import registry, srvgg
from reve_tpu_torch.weights.torch_loader import load_srvgg_pth

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PTH = os.path.join(REPO, "models", "realesr-animevideov3-x4.pth")


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def _jax_u8(params, u8, cfg, dtype=jnp.float32, s2d=True):
    x = jnp.asarray(u8).astype(jnp.float32) * (1.0 / 255.0)
    return np.asarray(jsrvgg.apply(params, x, cfg=cfg, compute_dtype=dtype,
                                   quantize_u8=True, s2d=s2d))


def _port_u8(jparams, u8, cfg, dtype=torch.float32):
    tcfg = srvgg.SRVGGConfig(num_in_ch=cfg.num_in_ch,
                             num_out_ch=cfg.num_out_ch,
                             num_feat=cfg.num_feat, num_conv=cfg.num_conv,
                             upscale=cfg.upscale)
    return srvgg.apply(srvgg.params_from_jax(jparams),
                       torch.from_numpy(u8), cfg=tcfg,
                       compute_dtype=dtype).numpy()


@pytest.mark.parametrize("s2d", [True, False])
@pytest.mark.parametrize("r", [2, 3, 4])
def test_f32_matches_jax(r, s2d):
    cfg = jsrvgg.SRVGGConfig(num_feat=16, num_conv=3, upscale=r)
    params = jsrvgg.init_params(jax.random.key(r), cfg)
    u8 = np.random.RandomState(r).randint(0, 256, (2, 11, 13, 3)).astype(
        np.uint8)  # odd H and W
    want = _jax_u8(params, u8, cfg, s2d=s2d)
    got = _port_u8(params, u8, cfg)
    assert got.dtype == np.uint8 and got.shape == want.shape == \
        (2, 11 * r, 13 * r, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3, (diff > 0).mean()


@pytest.mark.parametrize("s2d", [True, False])
@pytest.mark.parametrize("r", [2, 4])
def test_bf16_within_jax_own_bf16_error(r, s2d):
    cfg = jsrvgg.SRVGGConfig(num_feat=16, num_conv=4, upscale=r)
    params = jsrvgg.init_params(jax.random.key(10 + r), cfg)
    u8 = np.random.RandomState(2).randint(0, 256, (1, 15, 17, 3)).astype(
        np.uint8)
    ref = _jax_u8(params, u8, cfg, jnp.float32, s2d=s2d).astype(np.int16)
    jbf = _jax_u8(params, u8, cfg, jnp.bfloat16, s2d=s2d).astype(np.int16)
    got = _port_u8(params, u8, cfg, torch.bfloat16).astype(np.int16)
    jax_err = np.abs(jbf - ref).max()
    assert np.abs(got - ref).max() <= jax_err + 1
    assert _psnr(got, ref) >= _psnr(jbf, ref) - 1.0


def test_bf16_psnr_floor_on_trained_weights():
    """The product model (64 feat, 16 convs, x4, shipped .pth): JAX's own
    bf16 path and the port's both clear BF16_PSNR_FLOOR_DB against JAX's
    float32 path — the floor chip_smoke.py holds the card to."""
    jcfg, jparams = jload_pth(PTH)
    rs = np.random.RandomState(3)
    yy, xx = np.mgrid[0:24, 0:32]
    grad = np.stack([yy * 9, xx * 7, (yy + xx) * 4], -1) % 256
    u8 = np.clip(grad + rs.randint(-20, 21, grad.shape), 0, 255).astype(
        np.uint8)[None]
    ref = _jax_u8(jparams, u8, jcfg, jnp.float32, s2d=False)
    jbf = _jax_u8(jparams, u8, jcfg, jnp.bfloat16, s2d=False)
    got = _port_u8(jparams, u8, jcfg, torch.bfloat16)
    jax_db, port_db = _psnr(jbf, ref), _psnr(got, ref)
    assert jax_db >= srvgg.BF16_PSNR_FLOOR_DB, jax_db
    assert port_db >= srvgg.BF16_PSNR_FLOOR_DB, port_db
    assert port_db >= jax_db - 1.0, (port_db, jax_db)
    # and float32 agrees with JAX to the u8 step
    f32 = _port_u8(jparams, u8, jcfg, torch.float32)
    assert np.abs(f32.astype(np.int16) - ref.astype(np.int16)).max() <= 1


def test_pth_loads_equal_through_both_loaders():
    jcfg, jparams = jload_pth(PTH)
    cfg, params = load_srvgg_pth(PTH)
    assert (cfg.num_in_ch, cfg.num_out_ch, cfg.num_feat, cfg.num_conv,
            cfg.upscale) == (jcfg.num_in_ch, jcfg.num_out_ch,
                             jcfg.num_feat, jcfg.num_conv, jcfg.upscale)
    assert (cfg.num_feat, cfg.num_conv, cfg.upscale) == (64, 16, 4)
    carried = srvgg.params_from_jax(jparams)
    for group, keys in (("convs", ("w", "b")), ("prelus", ("alpha",))):
        assert len(params[group]) == len(jparams[group])
        for i, jp in enumerate(jparams[group]):
            for k in keys:
                np.testing.assert_array_equal(params[group][i][k].numpy(),
                                              np.asarray(jp[k]))
                np.testing.assert_array_equal(
                    carried[group][i][k].numpy(), np.asarray(jp[k]))


def test_registry_resolves_the_same_weights(monkeypatch):
    monkeypatch.chdir(REPO)
    cfg, params = registry.load_model("realesr-animevideov3", 4)
    assert cfg.num_conv == 16 and cfg.upscale == 4
    assert registry.resolve_weights("realesr-animevideov3-x4") == \
        os.path.join("models", "realesr-animevideov3-x4.pth")
    monkeypatch.delenv("REVE_TPU_ALLOW_RANDOM_INIT", raising=False)
    with pytest.raises(registry.MissingWeightsError,
                       match="REVE_TPU_ALLOW_RANDOM_INIT"):
        registry.load_model("realesr-general-x4v3", 4)
    # an RRDB model beside them: x2plus resolves no weights here and runs
    # on random init only when allowed
    with pytest.raises(registry.MissingWeightsError,
                       match="RealESRGAN_x2plus"):
        registry.load_model("realesrgan-x2plus", 2)


def test_init_params_is_seeded_by_generator():
    cfg = srvgg.SRVGGConfig(num_feat=16, num_conv=2, upscale=3)
    a = srvgg.init_params(cfg, torch.Generator().manual_seed(7))
    b = srvgg.init_params(cfg, torch.Generator().manual_seed(7))
    c = srvgg.init_params(cfg, torch.Generator().manual_seed(8))
    assert [tuple(p["w"].shape) for p in a["convs"]] == [
        (3, 3, 3, 16), (3, 3, 16, 16), (3, 3, 16, 16), (3, 3, 16, 27)]
    assert len(a["prelus"]) == 3
    torch.testing.assert_close(a["convs"][1]["w"], b["convs"][1]["w"])
    assert not torch.equal(a["convs"][1]["w"], c["convs"][1]["w"])


def test_plain_flag_runs_the_same_function_on_cpu():
    cfg = srvgg.SRVGGConfig(num_feat=16, num_conv=2, upscale=2)
    params = srvgg.init_params(cfg)
    u8 = torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (1, 7, 9, 3)).astype(np.uint8))
    torch.testing.assert_close(
        srvgg.apply(params, u8, cfg=cfg),
        srvgg.apply(params, u8, cfg=cfg, plain=True), atol=0, rtol=0)
    with pytest.raises(TypeError):
        srvgg.apply(params, u8.float(), cfg=cfg)
