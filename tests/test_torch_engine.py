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
from reve_tpu_torch.pipeline.engine import Plan, UpscaleEngine

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
    assert mine._plans[(8, 8)] == Plan(0, 2)


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
    # (ids as before tiling and TTA left this list)
    pytest.param({"mesh": object()}, "multi-GPU", id="kw3-multi-GPU"),
    pytest.param({"model": "realesrgan-x4plus", "scale": 4}, "RRDB",
                 id="kw4-RRDB"),
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
    """Whole frames in chunks while they fit; past the plan, halo tiles
    where the plan used to refuse (tile=-1 still refuses: the next
    test)."""
    mine, _ = _pair(batch_size=8)
    h, w = 1080, 1920
    per = mine._frame_bytes(h, w)
    io = 8 * (mine._in_bytes(h, w) + mine._out_bytes(h, w))
    # the whole batch fits
    _as_gpu_plan(mine, monkeypatch, int((8 * per + 2 * io) / 0.85) + 1)
    assert mine._plan_execution(h, w) == Plan(0, 8)
    # room for 3 frames -> 3 calls of 3, 3, 2 frames -> chunk 3
    _as_gpu_plan(mine, monkeypatch, int((3 * per + 2 * io) / 0.85) + 1)
    assert mine._plan_execution(h, w) == Plan(0, 3)
    assert mine.recommended_queue_depth(h, w) == 1
    # not even one frame: halo tiles, the largest whose window fits
    # beside the reserve and the executing batch's own IO set
    free = int((per + 2 * io) / 0.85) - 10
    _as_gpu_plan(mine, monkeypatch, free)
    plan = mine._plan_execution(h, w)
    assert 0 < plan.tile < w and plan.per_call >= 1
    avail = int(free * 0.85) - 3 * io
    win = mine._window(h, w, plan.tile)
    assert plan.per_call * mine._frame_bytes(*win) <= avail
    assert mine._frame_bytes(*mine._window(h, w, plan.tile + 1)) > avail
    assert mine.recommended_queue_depth(h, w) >= 1


def test_memory_plan_never_tiles_at_tile_minus_1(monkeypatch):
    """tile=-1 keeps whole frames and raises, plainly, on a frame past
    the plan; nothing fitting at all raises too."""
    mine, _ = _pair(batch_size=8)
    h, w = 1080, 1920
    per = mine._frame_bytes(h, w)
    io = 8 * (mine._in_bytes(h, w) + mine._out_bytes(h, w))
    monkeypatch.setattr(mine, "tile", -1)
    _as_gpu_plan(mine, monkeypatch, int((2 * per + 2 * io) / 0.85) + 1)
    assert mine._plan_execution(h, w) == Plan(0, 2)
    _as_gpu_plan(mine, monkeypatch, int((per + 2 * io) / 0.85) - 10)
    with pytest.raises(RuntimeError, match="does not fit") as e:
        mine._plan_execution(h, w)
    assert "not yet ported" not in str(e.value)
    monkeypatch.setattr(mine, "tile", 0)
    _as_gpu_plan(mine, monkeypatch, int(2 * io / 0.85))
    with pytest.raises(RuntimeError, match="does not fit"):
        mine._plan_execution(h, w)


def test_memory_plan_takes_the_tile_given(monkeypatch):
    """tile > 0 tiles every frame with that tile, as many windows per call
    as fit (all of them when room allows); the queue depth covers the
    tiled working set."""
    mine, _ = _pair(batch_size=4)
    monkeypatch.setattr(mine, "tile", 512)
    h, w = 1080, 1920
    win = mine._frame_bytes(548, 548)
    io = 4 * (mine._in_bytes(h, w) + mine._out_bytes(h, w))
    _as_gpu_plan(mine, monkeypatch, int((3 * io + 100 * win) / 0.85) + 1)
    assert mine._plan_execution(h, w) == Plan(512, 48)  # 4 x 3 x 4
    _as_gpu_plan(mine, monkeypatch, int((3 * io + 5 * win) / 0.85) + 1)
    assert mine._plan_execution(h, w) == Plan(512, 5)
    assert mine.recommended_queue_depth(h, w) == 1
    # more free memory later: the plan stays, the depth grows with what
    # its working set (the batch's IO set and 5 windows) leaves
    monkeypatch.setattr(mine, "_free_bytes",
                        lambda: int((7 * io + 5 * win) / 0.85) + 1)
    assert mine.recommended_queue_depth(h, w) == 3


def test_memory_plan_tile_past_the_frame_chunks_frames(monkeypatch):
    """A tile that covers the frame (one window, the whole frame) runs as
    whole frames in the plan's chunks of frames, never the whole batch in
    one call past the plan; the queue depth bills those chunks.  A frame
    that does not fit whole raises."""
    mine, _ = _pair(batch_size=8)
    monkeypatch.setattr(mine, "tile", 2048)
    h, w = 1080, 1920
    per = mine._frame_bytes(h, w)
    io = 8 * (mine._in_bytes(h, w) + mine._out_bytes(h, w))
    _as_gpu_plan(mine, monkeypatch, int((3 * per + 2 * io) / 0.85) + 1)
    assert mine._plan_execution(h, w) == Plan(0, 3)
    assert mine.recommended_queue_depth(h, w) == 1
    calls = []
    monkeypatch.setattr(mine, "_forward", lambda u8: calls.append(
        u8.shape[0]) or torch.zeros((u8.shape[0], 4, 4, 3), dtype=torch.uint8))
    assert [hi - lo for lo, hi, _ in mine._pieces(
        torch.zeros((8, h, w, 3), dtype=torch.uint8))] == [3, 3, 2]
    assert calls == [3, 3, 2]
    _as_gpu_plan(mine, monkeypatch, int((per + 2 * io) / 0.85) - 10)
    with pytest.raises(RuntimeError, match="tile=2048.*does not fit"):
        mine._plan_execution(h, w)
    # on the CPU: the whole batch as frames, not as one window
    monkeypatch.setattr(mine, "device", torch.device("cpu"))
    mine._plans.clear()
    assert mine._plan_execution(h, w) == Plan(0, 8)


def test_upscale_tiled_one_window_honours_chunk():
    """plan_tiles with one tile: upscale_tiled still runs at most `chunk`
    frames per call, and the output is the whole-frame pass's."""
    from reve_tpu_torch.ops import tiling
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (5, 6, 7, 3), dtype=np.uint8))
    sizes = []

    def up(u8):
        sizes.append(u8.shape[0])
        return u8.repeat_interleave(2, 1).repeat_interleave(2, 2)
    want = up(x)
    sizes.clear()
    got = tiling.upscale_tiled(up, x, scale=2, tile=16, halo=3, chunk=2)
    assert sizes == [2, 2, 1]
    assert torch.equal(got, want)


def test_memory_plan_bills_the_tta_accumulator(monkeypatch):
    """With TTA on, the 16-bit accumulator and two transforms' u8 outputs
    (and the transformed input) leave less room for frames."""
    mine, _ = _pair(batch_size=8)
    h, w = 1080, 1920
    per = mine._frame_bytes(h, w)
    io = 8 * (mine._in_bytes(h, w) + mine._out_bytes(h, w))
    free = int((8 * per + 2 * io) / 0.85) + 1
    _as_gpu_plan(mine, monkeypatch, free)
    assert mine._plan_execution(h, w) == Plan(0, 8)
    monkeypatch.setattr(mine, "tta", True)
    assert mine._tta_bytes(h, w) == 8 * (4 * mine._out_bytes(h, w)
                                         + mine._in_bytes(h, w))
    _as_gpu_plan(mine, monkeypatch, free)
    assert mine._plan_execution(h, w).per_call < 8


def test_chunked_submit_is_exact():
    """A batch split into several model calls gives the same bytes."""
    mine, _ = _pair(batch_size=5)
    frames = _frames(5, seed=3)
    whole = mine.submit(frames).result()
    mine._plans[(13, 18)] = Plan(0, 2)  # 3 calls: 2 + 2 + 1 frames
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
