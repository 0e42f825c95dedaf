"""The port's mesh engine (reve_tpu_torch.parallel.mesh,
pipeline/engine.py `mesh=`) against its one-device engine and against
reve_tpu's mesh engine on conftest's 8 virtual CPU devices.

A Mesh((cpu,) * k) runs k replicas on the CPU, each with its own params,
so the split of a batch into shares, the shares' output slices and the
int8 body installed on every replica are exercised here; the card's
smoke runs the same engine on Mesh((cuda:0, cuda:0)).  The float paths
hold u8 |d| <= 1 against reve_tpu (accumulation order), the mesh engine
equals the one-device engine byte for byte, and the mesh calibration's
maxima are within rtol 1e-5 of reve_tpu's mesh engine's (the float32
forward's rounding).
"""

import types

import jax
import numpy as np
import pytest
import torch

from reve_tpu.models import srvgg as jsrvgg
from reve_tpu.parallel import mesh as jmesh
from reve_tpu.pipeline.engine import UpscaleEngine as JaxEngine
from reve_tpu_torch import device as device_mod
from reve_tpu_torch.models import srvgg
from reve_tpu_torch.ops.color_np import YUVFormat
from reve_tpu_torch.parallel.mesh import Mesh
from reve_tpu_torch.pipeline.engine import (PendingBatch, Plan,
                                            UpscaleEngine, srvgg_act_bytes)

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _small_calibration_chunks(monkeypatch):
    """A one-device calibration pads its sample to a whole chunk of
    _CALIB_CHUNK_ELEMS activations (2e8: tens of thousands of these
    small frames); both packages get a budget of 4 frames of 16 x 20 at
    16 features, as tests/test_torch_int8.py sets it.  A mesh's
    calibration statistic is one chunk's whatever the budget."""
    for cls in (UpscaleEngine, JaxEngine):
        monkeypatch.setattr(cls, "_CALIB_CHUNK_ELEMS", 4 * 16 * 20 * 16)


def _params(r=2, seed=0, feat=16, num_conv=3):
    jcfg = jsrvgg.SRVGGConfig(num_feat=feat, num_conv=num_conv, upscale=r)
    jparams = jsrvgg.init_params(jax.random.key(seed), jcfg)
    cfg = srvgg.SRVGGConfig(num_feat=feat, num_conv=num_conv, upscale=r)
    return (jcfg, jparams), (cfg, srvgg.params_from_jax(jparams))


def _frames(n, h=13, w=18, seed=1):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3),
                                               np.uint8)


@pytest.mark.parametrize("dp", [1, 2, 3, 4])
def test_dp_pad_is_reve_tpus(dp):
    """The cyclic pad to a dp multiple, for 1-9 frames: the same frames
    in the same order, the same n_real."""
    ref_self = types.SimpleNamespace(_batch_sharding=object(),
                                     mesh=types.SimpleNamespace(
                                         shape={"dp": dp}))
    my_self = types.SimpleNamespace(mesh=Mesh((CPU,) * dp))
    for n in range(1, 10):
        frames = _frames(n, 2, 2, seed=n)
        want, want_n = JaxEngine._dp_pad(ref_self, frames)
        got, got_n = UpscaleEngine._dp_pad(my_self, frames)
        assert got_n == want_n == n
        np.testing.assert_array_equal(got, want)
        assert len(got) % dp == 0
    # no mesh: the batch as it is
    frames = _frames(3, 2, 2)
    got, n = UpscaleEngine._dp_pad(types.SimpleNamespace(mesh=None), frames)
    assert got is frames and n == 3


def _pair(k, dtype, batch=4, **kw):
    _, pre = _params()
    one = UpscaleEngine(device="cpu", compute_dtype=dtype, batch_size=batch,
                        preloaded=pre, **kw)
    mesh = UpscaleEngine(mesh=Mesh((CPU,) * k), compute_dtype=dtype,
                         batch_size=batch, preloaded=pre, **kw)
    return one, mesh


@pytest.mark.parametrize("mode", ["whole", "tiles", "tta", "planes"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", [2, 4])
def test_mesh_engine_equals_one_device(k, dtype, mode):
    """Each replica runs its share as one engine runs it: byte for byte,
    short batches padded, tiles and TTA inside each share, K9's planes
    written into each share's slice; int8 with the one-device engine's
    maxima injected."""
    kw = {"tile": 8} if mode == "tiles" else \
        {"tta": True} if mode == "tta" else {}
    one, mesh = _pair(k, dtype, **kw)
    assert len(mesh._replicas) == k and mesh.mesh.shape == {"dp": k}
    assert all(r.batch_size == 4 // k for r in mesh._replicas[1:])
    if mode == "planes":
        fmt = YUVFormat("bt601", False, 10)
        one.set_output_format(fmt)
        mesh.set_output_format(fmt)
        assert all(r.output_format == fmt for r in mesh._replicas)
    frames = _frames(7)
    if dtype == "int8":
        one.calibrate_int8(frames)
        mesh.set_calibration(one.get_calibration())
        assert all(r._qbody is not None for r in mesh._replicas)
    for batch in (frames[:4], frames[4:]):  # a full and a short batch
        want, got = one.submit(batch).result(), mesh.submit(batch).result()
        if mode == "planes":
            assert len(got) == 3
            for g, w in zip(got, want):
                assert g.shape[0] == len(batch)
                np.testing.assert_array_equal(g, w)
        else:
            assert got.shape == (len(batch), 26, 36, 3)
            np.testing.assert_array_equal(got, want)
    # every replica ran its share: the calls are the replicas' sum
    per = 8 if mode == "tta" else 1
    assert mesh.stats.calls == 2 * k * per and mesh.stats.batches == 2
    assert mesh.stats.frames == 7


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_mesh_engine_matches_jax_mesh_engine(dtype):
    """The port's mesh (dp 2 and 4) against reve_tpu's mesh engine on 8
    CPU devices (dp 8), the same params and, for int8, the same maxima:
    u8 |d| <= 1."""
    (jcfg, jparams), pre = _params(seed=3)
    jm = jmesh.make_mesh(jax.devices(), max_sp=1)
    assert jm.shape["dp"] == 8
    ref = JaxEngine(mesh=jm, compute_dtype=dtype, batch_size=8, tile=-1,
                    preloaded=(jcfg, jparams))
    frames = _frames(8, seed=4)
    if dtype == "int8":
        ref.calibrate_int8(frames)
    want = ref.submit(frames).result().astype(np.int16)
    for k in (2, 4):
        mine = UpscaleEngine(mesh=Mesh((CPU,) * k), compute_dtype=dtype,
                             batch_size=8, tile=-1, preloaded=pre)
        if dtype == "int8":
            mine.set_calibration(ref.get_calibration())
        got = mine.submit(frames).result().astype(np.int16)
        assert got.shape == want.shape == (8, 26, 36, 3)
        assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("n", [3, 5, 8])
def test_mesh_calibration_matches_jax_mesh_engine(n):
    """The mesh calibration: the sample dp-padded and taken as one chunk
    (reve_tpu's sharded calibration), its maxima within rtol 1e-5 of
    reve_tpu's mesh engine's; the hook called once, every replica
    quantized with them."""
    from jax.sharding import Mesh as JaxMesh

    (jcfg, jparams), pre = _params(seed=5)
    frames = _frames(n, 16, 20, seed=6)
    ref = JaxEngine(mesh=JaxMesh(np.array(jax.devices()[:2]), ("dp",)),
                    compute_dtype="int8", batch_size=2, tile=-1,
                    preloaded=(jcfg, jparams))
    ref.calibrate_int8(frames)
    mine = UpscaleEngine(mesh=Mesh((CPU, CPU)), compute_dtype="int8",
                         batch_size=2, tile=-1, preloaded=pre)
    hooked = []
    mine.calibration_hook = lambda m: hooked.append(m) or m
    mine.calibrate_int8(frames)
    np.testing.assert_allclose(mine.get_calibration(), ref.get_calibration(),
                               rtol=1e-5)
    assert len(hooked) == 1
    for rep in mine._replicas:
        np.testing.assert_array_equal(rep._act_maxima,
                                      mine.get_calibration())
        assert not rep._qbody_provisional
    # and the one-device engine with its chunking is another statistic
    # only where a chunk boundary splits the sample; the mesh's one chunk
    # is the statistic over the whole padded sample
    from reve_tpu_torch.weights import quantize

    padded, _ = mine._dp_pad(mine._calib_crop(frames))
    whole = quantize.collect_maxima(mine._params_f32,
                                    torch.from_numpy(padded), cfg=pre[0],
                                    percentile=99.9).numpy()
    np.testing.assert_array_equal(mine.get_calibration(), whole)


@pytest.mark.parametrize("int8_calib", ["p99.9", "max"])
@pytest.mark.parametrize("per", [1, 2, 3])
def test_mesh_calibration_fits_each_replicas_memory(monkeypatch, per,
                                                    int8_calib):
    """The mesh calibration's statistic is the dp-padded sample's as one
    chunk, but no device holds it: each replica measures its share in
    calls of at most the frames its part of the free memory holds (here
    patched to hold `per`), and the parts, the maxima or the sample's
    strided subsample at the sample's offsets, join to the one-chunk
    statistic."""
    from reve_tpu_torch.weights import quantize

    _, pre = _params(seed=8)
    h, w = 16, 20
    frames = _frames(11, h, w, seed=9)  # padded to 12: shares of 6
    mesh = UpscaleEngine(mesh=Mesh((CPU, CPU)), compute_dtype="int8",
                         int8_calib=int8_calib, batch_size=2, tile=-1,
                         preloaded=pre)
    # the subsample's stride > 1 at this sample, so the offsets matter
    monkeypatch.setattr(quantize, "_PCT_SAMPLE_CAP", 1000)
    for rep in mesh._replicas:
        need = srvgg_act_bytes(h, w, 16, torch.float32) \
            + 4 * h * w * 16 + rep._in_bytes(h, w)
        _as_gpu(rep, monkeypatch, int((per * need + need // 2)
                                      / 0.85) + 1)
        got = rep._calib_per_call(h, w, 6)
        monkeypatch.setattr(rep, "device", CPU)
        assert got == per
        monkeypatch.setattr(rep, "_calib_per_call",
                            lambda h, w, share, _p=got: _p)
    calls = []
    collect = quantize.collect_maxima

    def counted(params, u8, **kw):
        calls.append((len(u8), kw.get("part")))
        return collect(params, u8, **kw)

    monkeypatch.setattr(quantize, "collect_maxima", counted)
    mesh.calibrate_int8(frames)
    assert all(b <= per for b, _part in calls)
    assert sum(b for b, _part in calls) == 12
    assert [p for _b, p in calls] == [
        (i, 12) for k in (0, 6) for i in range(k, k + 6, per)]
    padded, _ = mesh._dp_pad(frames)
    whole = collect(mesh._params_f32, torch.from_numpy(padded), cfg=pre[0],
                    percentile=mesh._calib_percentile).numpy()
    np.testing.assert_allclose(mesh.get_calibration(), whole, rtol=1e-6)


def test_mesh_certification_excludes_the_padded_frames():
    """The certificate of a mesh engine counts only the real frames: the
    dp-pad's repeats do not move it, so it equals the one-device
    engine's on the same scales."""
    one, mesh = _pair(4, "int8")
    frames = _frames(5, seed=7)
    one.calibrate_int8(frames)
    mesh.set_calibration(one.get_calibration())
    assert mesh.certify_int8(frames) == pytest.approx(
        one.certify_int8(frames), rel=0, abs=1e-9)


def test_mesh_batch_must_divide():
    _, pre = _params()
    with pytest.raises(ValueError, match="not divisible"):
        UpscaleEngine(mesh=Mesh((CPU,) * 4), batch_size=6, preloaded=pre)
    with pytest.raises(ValueError, match="mutually exclusive"):
        UpscaleEngine(mesh=Mesh((CPU, CPU)), device="cpu", batch_size=2,
                      preloaded=pre)


def test_mesh_refuses_what_is_not_ported_and_never_drifts(monkeypatch):
    """A mesh is one axis, dp; its devices are all CUDA devices or all
    the CPU, and a mesh of CUDA devices raises without CUDA."""
    assert Mesh(["cpu"] * 3).shape == {"dp": 3}
    assert Mesh(["cpu"] * 3).axis_names == ("dp",)
    with pytest.raises(ValueError, match="at least one device"):
        Mesh(())
    with pytest.raises(ValueError, match="all CUDA devices or all the CPU"):
        Mesh(("cpu", torch.device("meta")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.NoCudaDeviceError):
        Mesh(("cuda:0", "cuda:1"))


def test_a_replicas_failure_fails_the_batch(monkeypatch):
    _, mesh = _pair(2, "float32")

    def broken(u8):
        raise RuntimeError("replica 1: kernel launch failed")

    monkeypatch.setattr(mesh._replicas[1], "_forward", broken)
    with pytest.raises(RuntimeError, match="replica 1"):
        mesh.submit(_frames(4))


def test_pending_batch_waits_on_every_replica():
    waited = []

    class Event:
        def __init__(self, k):
            self.k = k

        def synchronize(self):
            waited.append(self.k)

    out = torch.zeros((4, 2, 2, 3), dtype=torch.uint8)
    p = PendingBatch(out, 3, [Event(0), Event(1)], host_in=out)
    assert p.result().shape == (3, 2, 2, 3) and waited == [0, 1]
    p.result()
    assert waited == [0, 1]  # each event waited on once


def _as_gpu(engine, monkeypatch, free_bytes):
    """Drive a replica's plan on its CUDA branch on the CPU (the device
    type and the free memory are all the plan reads)."""
    monkeypatch.setattr(engine, "device", torch.device("cuda", 0))
    monkeypatch.setattr(engine, "_free_bytes", lambda: free_bytes)
    engine._plans.clear()


def test_mesh_memory_plan_chunks_each_share(monkeypatch):
    """reve_tpu's test_sharded_engine_hbm_chunking_matches_single_device:
    a mesh does not bypass the memory plan.  Each replica plans its
    share (2 frames of a batch of 16 over dp 8) in the memory it has:
    with room for one frame each runs two calls of one, so the mesh runs
    a dp multiple (8) of frames a step, and the output is byte for byte
    the unchunked one-device engine's."""
    _, pre = _params()
    h, w = 16, 20
    frames = _frames(16, h, w, seed=7)
    ref = UpscaleEngine(device="cpu", compute_dtype="float32",
                        batch_size=16, tile=0, preloaded=pre)
    want = ref.submit(frames).result()
    mesh = UpscaleEngine(mesh=Mesh((CPU,) * 8), compute_dtype="float32",
                         batch_size=16, tile=0, preloaded=pre)
    for rep in mesh._replicas:
        assert rep._share == 2
        io = rep._io_batch_bytes(h, w)
        _as_gpu(rep, monkeypatch, int((rep._frame_bytes(h, w) + 2 * io)
                                      / 0.85) + 1)
        assert rep._plan_execution(h, w) == Plan(0, 1)
        # the plan kept, the replica back on the CPU for the run
        monkeypatch.setattr(rep, "device", CPU)
    assert sum(r._plans[(h, w)].per_call for r in mesh._replicas) == 8
    got = mesh.submit(frames).result()
    np.testing.assert_array_equal(got, want)
    assert mesh.stats.calls == 16  # two calls on each of 8 replicas


def test_replicas_sharing_a_device_split_its_free_bytes(monkeypatch):
    """Each replica plans for its part of its device's free memory: two
    replicas on one device a half each, four a quarter; one engine all
    of it."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (1000, 4000))
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device=None: {
        "reserved_bytes.all.current": 300,
        "allocated_bytes.all.current": 100,
        "inactive_split_bytes.all.current": 0})
    one, two = _pair(2, "bfloat16")
    assert one._free_bytes() == 1200
    assert [r._free_bytes() for r in two._replicas] == [600, 600]
    _, four = _pair(4, "bfloat16")
    assert [r._free_bytes() for r in four._replicas] == [300] * 4
    # the queue depth is the least of the replicas'
    depths = iter([3, 1])
    for rep in two._replicas:
        monkeypatch.setattr(rep, "_queue_depth",
                            lambda h, w, d=next(depths): d)
    assert two.recommended_queue_depth(13, 18) == 1


def test_mesh_warmup_and_repr():
    _, mesh = _pair(2, "int8")
    mesh.warmup(8, 8)
    assert mesh._qbody_provisional
    assert all(r._plans[(8, 8)] == Plan(0, 2) for r in mesh._replicas)
    assert mesh.stats.frames == 0 and mesh.stats.batches == 0
    assert str(mesh.mesh) == "cpu,cpu" and "dp=2" in repr(mesh.mesh)
    mesh.reset_calibration()
    assert all(r._qbody is None for r in mesh._replicas)
