"""The port's UpscaleEngine (reve_tpu_torch.pipeline.engine) against the
JAX package's on the same frames and weights, on the CPU.

Frames are u8 in and u8 out on both sides; float32 outputs may differ by
1 where an accumulation-order difference moves y*255+0.5 across an
integer.  The memory plan's GPU branch is driven here with a stubbed free
memory figure (the plan reads the device only through `_free_bytes`).
"""

import numpy as np
import pytest
import torch

from reve_tpu.models import srvgg as jsrvgg
from reve_tpu.pipeline.engine import UpscaleEngine as JaxEngine
from reve_tpu_torch import device as device_mod
from reve_tpu_torch.models import srvgg
from reve_tpu_torch.pipeline import engine as engine_mod
from reve_tpu_torch.pipeline.engine import UpscaleEngine

torch.set_num_threads(2)


def _pair(batch_size=2, r=2, seed=0):
    import jax

    jcfg = jsrvgg.SRVGGConfig(num_feat=16, num_conv=3, upscale=r)
    jparams = jsrvgg.init_params(jax.random.key(seed), jcfg)
    cfg = srvgg.SRVGGConfig(num_feat=16, num_conv=3, upscale=r)
    mine = UpscaleEngine(device="cpu", compute_dtype="float32",
                         batch_size=batch_size,
                         preloaded=(cfg, srvgg.params_from_jax(jparams)))
    ref = JaxEngine(compute_dtype="float32", batch_size=batch_size,
                    preloaded=(jcfg, jparams))
    return mine, ref


def _frames(n, h=13, w=18, seed=1):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3),
                                               np.uint8)


@pytest.mark.parametrize("r", [2, 3])
def test_engine_matches_jax_engine(r):
    mine, ref = _pair(batch_size=2, r=r)
    frames = _frames(5)  # 2 full batches + a short one
    got = mine.upscale_frames(frames)
    want = ref.upscale_frames(frames)
    assert got.dtype == np.uint8 and got.shape == want.shape == \
        (5, 13 * r, 18 * r, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3
    assert mine.stats.frames == 5 and mine.stats.batches == 3


def test_short_batch_padding_repeats_last_frame():
    mine, _ = _pair(batch_size=3)
    frames = _frames(2, seed=2)
    out = mine.submit(frames).result()
    assert out.shape == (2, 26, 36, 3)  # padding cropped
    padded = np.concatenate([frames, frames[-1:]])
    full = mine.submit(padded).result()
    np.testing.assert_array_equal(out, full[:2])
    with pytest.raises(ValueError, match="batch 4 > batch_size 3"):
        mine.submit(_frames(4))


def test_queue_depth_halo_and_warmup():
    mine, ref = _pair(batch_size=2)
    assert mine.recommended_queue_depth(32, 48) >= 1
    assert mine.halo == ref.halo == 5
    mine.warmup(8, 8)
    assert mine.stats.frames == 0 and mine.stats.batches == 0


def test_pending_batch_result_on_cpu():
    mine, _ = _pair()
    p = mine.submit(_frames(2))
    np.testing.assert_array_equal(p.result(), p.result())
    assert p.result().shape == (2, 26, 36, 3)


def test_engine_raises_without_cuda(monkeypatch):
    """No device requested and no CUDA: raise, never drift to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.NoCudaDeviceError, match="device='cpu'"):
        UpscaleEngine(allow_random_init=True)
    with pytest.raises(device_mod.NoCudaDeviceError):
        UpscaleEngine(device=0, allow_random_init=True)
    with pytest.raises(device_mod.NoCudaDeviceError):
        device_mod.resolve_device("cuda:1")
    assert device_mod.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("kw,item", [
    # int8 is ported; int8 of an architecture that is not still raises
    pytest.param({"compute_dtype": "int8", "model": "realesrgan-x4plus",
                  "scale": 4}, "RRDB", id="kw0-int8"),
    ({"tta": True}, "TTA"),
    ({"tile": 64}, "tiling"),
    ({"mesh": object()}, "multi-GPU"),
    ({"model": "realesrgan-x4plus", "scale": 4}, "RRDB"),
])
def test_unported_modes_raise(kw, item):
    base = dict(device="cpu", allow_random_init=True)
    base.update(kw)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        UpscaleEngine(**base)


def test_dtype_names():
    assert device_mod.resolve_dtype("auto") is torch.bfloat16
    assert device_mod.resolve_dtype("bf16") is torch.bfloat16
    assert device_mod.resolve_dtype("float32") is torch.float32
    with pytest.raises(ValueError):
        device_mod.resolve_dtype("float16")


def _as_gpu_plan(engine, monkeypatch, free_bytes):
    """Drive the plan's CUDA branch on the CPU: only the device type and
    the free-memory reading are consulted."""
    monkeypatch.setattr(engine, "device", torch.device("cuda", 0))
    monkeypatch.setattr(engine, "_free_bytes", lambda: free_bytes)
    engine._plans.clear()


def test_memory_plan_chunks_and_refuses(monkeypatch):
    mine, _ = _pair(batch_size=8)
    h, w = 1080, 1920
    per = mine._frame_bytes(h, w)
    io = 8 * (mine._in_bytes(h, w) + mine._out_bytes(h, w))
    # the whole batch fits
    _as_gpu_plan(mine, monkeypatch, int((8 * per + 2 * io) / 0.85) + 1)
    assert mine._plan_execution(h, w) == 8
    # room for 3 frames -> 3 calls of 3, 3, 2 frames -> chunk 3
    _as_gpu_plan(mine, monkeypatch, int((3 * per + 2 * io) / 0.85) + 1)
    assert mine._plan_execution(h, w) == 3
    assert mine.recommended_queue_depth(h, w) == 1
    # not even one frame: tiling is not ported
    _as_gpu_plan(mine, monkeypatch, int((per + 2 * io) / 0.85) - 10)
    with pytest.raises(NotImplementedError, match="tiling"):
        mine._plan_execution(h, w)


def test_chunked_submit_is_exact():
    """A batch split into several model calls gives the same bytes."""
    mine, _ = _pair(batch_size=5)
    frames = _frames(5, seed=3)
    whole = mine.submit(frames).result()
    mine._plans[(13, 18)] = 2  # 3 calls: 2 + 2 + 1 frames
    calls = mine.stats.calls
    np.testing.assert_array_equal(mine.submit(frames).result(), whole)
    assert mine.stats.calls == calls + 3


def test_frame_bytes_counts_what_the_kernels_keep():
    mine, _ = _pair(batch_size=1, r=2)
    # 2 hidden buffers of 16 float32 channels + 3 u8 in + 12 u8 out
    assert mine._frame_bytes(10, 10) == 100 * (2 * 16 * 4 + 3 + 12)
    bf = UpscaleEngine(device="cpu", compute_dtype="bfloat16",
                       preloaded=(mine.cfg, srvgg.init_params(mine.cfg)))
    assert bf._frame_bytes(10, 10) == 100 * (2 * 16 * 2 + 3 + 12)
    assert engine_mod._PLAN_INFLIGHT_SETS >= 1
