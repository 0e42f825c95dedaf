"""The port's UpscaleEngine at the SRVGG widths the card serves besides 64
(32, 96 and 128 features) against the JAX package's engine, on the CPU:
the same numpy-seeded params (reve_tpu's init, carried across by
params_from_jax) and frames, at x2, x3 and x4, in bfloat16 and float32.
On the card the same engine runs K3, K1 and K2 at these widths
(chip_smoke.py's `widths` phase holds them against the plain path).

Tolerances (test_torch_engine.py's and test_torch_srvgg.py's rules):
float32 u8 |d| <= 1 on under 0.1% of the samples (float32 accumulation
order next to a rounding boundary); bfloat16 no further from reve_tpu's
float32 engine than reve_tpu's own bfloat16 engine is, plus one u8 step,
and at most 1 dB of PSNR below it.
"""

import numpy as np
import pytest
import torch

from reve_tpu.models import srvgg as jsrvgg
from reve_tpu.pipeline.engine import UpscaleEngine as JaxEngine
from reve_tpu_torch.models import srvgg
from reve_tpu_torch.pipeline.engine import UpscaleEngine

torch.set_num_threads(2)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("feat", [32, 96, 128])
def test_engine_at_other_widths_matches_jax_engine(feat, name, r):
    import jax

    jcfg = jsrvgg.SRVGGConfig(num_feat=feat, num_conv=1, upscale=r)
    jparams = jsrvgg.init_params(jax.random.key(feat + r), jcfg)
    cfg = srvgg.SRVGGConfig(num_feat=feat, num_conv=1, upscale=r)
    frames = np.random.RandomState(feat * r).randint(
        0, 256, (2, 11, 13, 3), np.uint8)
    mine = UpscaleEngine(device="cpu", compute_dtype=name, batch_size=2,
                         preloaded=(cfg, srvgg.params_from_jax(jparams)))
    got = mine.upscale_frames(frames).astype(np.int16)
    assert got.shape == (2, 11 * r, 13 * r, 3)
    assert mine.stats.frames == 2 and mine.stats.batches == 1
    ref = np.asarray(JaxEngine(compute_dtype="float32", batch_size=2,
                               preloaded=(jcfg, jparams)).upscale_frames(
                                   frames)).astype(np.int16)
    if name == "float32":
        diff = np.abs(got - ref)
        assert diff.max() <= 1
        assert (diff > 0).mean() < 1e-3, (diff > 0).mean()
        return
    jbf = np.asarray(JaxEngine(compute_dtype="bfloat16", batch_size=2,
                               preloaded=(jcfg, jparams)).upscale_frames(
                                   frames)).astype(np.int16)
    assert np.abs(got - ref).max() <= np.abs(jbf - ref).max() + 1
    assert _psnr(got, ref) >= _psnr(jbf, ref) - 1.0
