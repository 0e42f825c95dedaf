"""The port's colour conversions (reve_tpu_torch/ops/color.py, K9's plain
version) against the JAX package's (reve_tpu/ops/color.py) and the
host's numpy copy (ops/color_np.py), on the CPU; the engine's planes
route against its RGB route; the writers' and the scheduler's choice of
route.

Tolerances: every function is exact, in all 8 forms (BT.601/709 x
limited/full x 8/10 bits), against color_np (the writers' host route,
whose bytes the output files hold) and its copy in the JAX package, and
against the JAX functions run op by op (jax.disable_jit: one rounding an
op, the source's arithmetic) where XLA keeps the source's order; every
float32 step is one op rounded in the reference's order.  XLA computes
two steps otherwise, so the JAX function does not equal the reference's
own numpy copy everywhere: under jit its CPU backend contracts the luma's
multiply-adds into FMAs, and it sums the 2x2 chroma mean in an order
that depends on the shape (((a + b) + c) + d on a batch of planes,
where numpy sums (a + b) + (c + d), as the port does).
Either moves a code across a rounding boundary now and then: up to 1e-4
of the codes of random frames, by one code (measured here: 9.6e-5 at
most, full-range 8-bit luma under jit).  The test allows 2e-4 and holds
the port, at each such code, to the reference's numpy copy; the chroma
mean is held to JAX's within 2^-24 (the rounding of a sum of four
values below 1 in magnitude).  The jitted yuv420_to_rgb is held to float32 rounding, |d| <=
2^-22 on values in [-0.6, 1.6].
"""

import contextlib
import fractions
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reve_tpu.ops import color as jcolor
from reve_tpu.ops import color_np as jcolor_np
from reve_tpu_torch import cli
from reve_tpu_torch.io import writer
from reve_tpu_torch.kernels import color as color_k
from reve_tpu_torch.models import srvgg
from reve_tpu_torch.ops import color, color_np
from reve_tpu_torch.ops.color_np import Planes, YUVFormat
from reve_tpu_torch.pipeline import scheduler
from reve_tpu_torch.pipeline.engine import UpscaleEngine
from reve_tpu_torch.pipeline.state import Workspace

torch.set_num_threads(2)

FORMS = [YUVFormat(m, fr, b) for m, fr, b in itertools.product(
    ("bt601", "bt709"), (False, True), (8, 10))]
IDS = [f"{f.matrix}-{'full' if f.full_range else 'limited'}-{f.bits}"
       for f in FORMS]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PTH = os.path.join(REPO, "models", "realesr-animevideov3-x4.pth")


def _np(t):
    return color.codes_numpy(t) if t.dtype in (torch.uint8, torch.int16) \
        else t.numpy()


def _frames(n, h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3),
                                               np.uint8)


def _boundary_frames(fmt, quads=2048, seed=1):
    """Frames of uniform 2 x 2 quads whose RGB values put a Y, U or V code
    within 2^-12 of a rounding boundary (x.5) before it is rounded: a
    uniform quad's chroma mean is its pixels' chroma exactly."""
    rs = np.random.RandomState(seed)
    rgb = rs.randint(0, 256, (1 << 21, 3))
    kr, kg, kb = color._coeffs(fmt.matrix)
    scale = 1 << (fmt.bits - 8)
    f = rgb / 255.0
    y = kr * f[:, 0] + kg * f[:, 1] + kb * f[:, 2]
    u = (f[:, 2] - y) / (2 * (1 - kb))
    v = (f[:, 0] - y) / (2 * (1 - kr))
    if fmt.full_range:
        m = (1 << fmt.bits) - 1
        pre = (y * m, u * m + 128 * scale, v * m + 128 * scale)
    else:
        pre = (y * 219 * scale + 16 * scale, u * 224 * scale + 128 * scale,
               v * 224 * scale + 128 * scale)
    near = np.zeros(len(rgb), bool)
    for p in pre:
        near |= np.abs(p - np.floor(p) - 0.5) < 2.0 ** -12
    pick = rgb[near][:quads].astype(np.uint8)
    assert len(pick) >= 256
    side = int(np.ceil(np.sqrt(len(pick))))
    pick = np.concatenate([pick, np.repeat(pick[-1:], side * side
                                           - len(pick), 0)])
    grid = pick.reshape(side, side, 3)
    return np.repeat(np.repeat(grid, 2, 0), 2, 1)[None]


def _jax_rgb_to_yuv420(frames, fmt, jit=True):
    ctx = contextlib.nullcontext() if jit else jax.disable_jit()
    with ctx:
        return [np.asarray(p) for p in jcolor.rgb_to_yuv420(
            jnp.asarray(frames.astype(np.float32) / 255.0),
            matrix=fmt.matrix, full_range=fmt.full_range, bits=fmt.bits)]


@pytest.mark.parametrize("fmt", FORMS, ids=IDS)
def test_rgb_u8_to_yuv420_is_byte_identical(fmt):
    """K9's plain version against color_np (the writers' host route, and
    the JAX package's copy of it), byte for byte, over 4 x 720 x 1440
    random frames (1.04 M samples a chroma plane) and frames of codes at
    rounding boundaries; against reve_tpu's rgb_to_yuv420(u8 / 255) as
    the module docstring says (random frames: <= 2e-4 of the codes, by
    one; at rounding boundaries XLA's steps meet them more often)."""
    for share, frames in ((2e-4, _frames(4, 720, 1440, seed=fmt.bits)),
                          (1.0, _boundary_frames(fmt))):
        got = [_np(t) for t in color.rgb_u8_to_yuv420(
            torch.from_numpy(frames), matrix=fmt.matrix,
            full_range=fmt.full_range, bits=fmt.bits)]
        kw = dict(matrix=fmt.matrix, full_range=fmt.full_range,
                  bits=fmt.bits)
        want = [np.stack(p) for p in zip(*(
            color_np.rgb_to_yuv420_np(f, **kw) for f in frames))]
        jwant = [np.stack(p) for p in zip(*(
            jcolor_np.rgb_to_yuv420_np(f, **kw) for f in frames))]
        for g, w, jw in zip(got, want, jwant):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, jw)
        for jit in (True, False):
            for g, jw, j in zip(got, jwant,
                                _jax_rgb_to_yuv420(frames, fmt, jit)):
                assert g.dtype == j.dtype
                off = g != j
                assert off.mean() <= share
                np.testing.assert_array_equal(g[off], jw[off])
                assert np.abs(g[off].astype(int) - j[off]).max(
                    initial=0) <= 1
        # the wrapper on CPU tensors is the plain version
        kern = color_k.rgb_to_yuv420_u8(torch.from_numpy(frames), fmt)
        for k, g in zip(kern, got):
            np.testing.assert_array_equal(_np(k), g)


@pytest.mark.parametrize("fmt", FORMS, ids=IDS)
def test_each_function_equals_jax(fmt):
    """Each function of ops/color.py against reve_tpu's, op by op (small
    random inputs, values past [0, 1] included)."""
    with jax.disable_jit():
        _each_function_equals_jax(fmt)


def _each_function_equals_jax(fmt):
    rs = np.random.RandomState(3)
    rgb = rs.uniform(-0.1, 1.1, (2, 8, 12, 3)).astype(np.float32)
    kw = dict(matrix=fmt.matrix)
    got = color.rgb_to_yuv(torch.from_numpy(rgb), **kw)
    want = jcolor.rgb_to_yuv(jnp.asarray(rgb), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    y, u, v = (rs.uniform(lo, hi, (2, 8, 12)).astype(np.float32)
               for lo, hi in ((-0.1, 1.1), (-0.6, 0.6), (-0.6, 0.6)))
    q = dict(bits=fmt.bits, full_range=fmt.full_range)
    for g, w in zip(color.quantize_yuv(*map(torch.from_numpy, (y, u, v)),
                                       **q),
                    jcolor.quantize_yuv(*map(jnp.asarray, (y, u, v)), **q)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    hi = (1 << fmt.bits) - 1
    c8 = rs.randint(0, hi + 1, (2, 8, 12)).astype(
        np.uint8 if fmt.bits == 8 else np.uint16)
    ct = torch.from_numpy(c8.astype(np.int32))
    for g, w in zip(color.normalize_yuv(ct, ct, **q),
                    jcolor.normalize_yuv(jnp.asarray(c8), jnp.asarray(c8),
                                         **q)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        color.yuv_to_rgb(*map(torch.from_numpy, (y, u, v)), **kw).numpy(),
        np.asarray(jcolor.yuv_to_rgb(*map(jnp.asarray, (y, u, v)), **kw)))
    np.testing.assert_array_equal(
        color.upsample_chroma_nearest(torch.from_numpy(u)).numpy(),
        np.asarray(jcolor.upsample_chroma_nearest(jnp.asarray(u))))
    # the 2x2 mean: numpy's exactly, XLA's (its own order) within 2^-24
    box = color.downsample_chroma_box(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(box, u.reshape(2, 4, 2, 6, 2).mean((2, 4)))
    np.testing.assert_allclose(
        box, np.asarray(jcolor.downsample_chroma_box(jnp.asarray(u))),
        rtol=0, atol=2.0 ** -24)
    # float input past [0, 1]: the clip, then the steps held above
    want = jcolor.quantize_yuv(
        *_np_yuv(np.clip(rgb, 0, 1), fmt.matrix), **q)
    for g, w in zip(color.rgb_to_yuv420(torch.from_numpy(rgb), **kw, **q),
                    want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def _np_yuv(rgb, matrix):
    """numpy's float32 y and the 2x2 means of u, v (color_np's steps)."""
    kr, kg, kb = color._coeffs(matrix)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = kr * r + kg * g + kb * b
    u = (b - y) / (2.0 * (1.0 - kb))
    v = (r - y) / (2.0 * (1.0 - kr))
    n, h, w = y.shape
    return (jnp.asarray(y),
            jnp.asarray(u.reshape(n, h // 2, 2, w // 2, 2).mean((2, 4))),
            jnp.asarray(v.reshape(n, h // 2, 2, w // 2, 2).mean((2, 4))))


@pytest.mark.parametrize("fmt", FORMS, ids=IDS)
def test_yuv420_to_rgb_matches_jax(fmt):
    """The decode direction: every code, random planes; exact against the
    JAX function run op by op, and within float32 rounding of values in
    [-0.6, 1.6] (2^-22) of the jitted one, whose steps XLA fuses."""
    rs = np.random.RandomState(4)
    hi = (1 << fmt.bits) - 1
    dt = np.uint8 if fmt.bits == 8 else np.uint16
    y = rs.randint(0, hi + 1, (2, 64, 96)).astype(dt)
    y.reshape(-1)[:hi + 1] = np.arange(hi + 1)
    u, v = (rs.randint(0, hi + 1, (2, 32, 48)).astype(dt) for _ in "uv")
    kw = dict(matrix=fmt.matrix, full_range=fmt.full_range, bits=fmt.bits)
    got = color.yuv420_to_rgb(*(torch.from_numpy(p.astype(np.int32))
                                for p in (y, u, v)), **kw).numpy()
    want = np.asarray(jcolor.yuv420_to_rgb(*map(jnp.asarray, (y, u, v)),
                                           **kw))
    assert got.shape == want.shape == (2, 64, 96, 3)
    assert np.abs(got - want).max() <= 2.0 ** -22
    with jax.disable_jit():
        eager = np.asarray(jcolor.yuv420_to_rgb(
            *map(jnp.asarray, (y, u, v)), **kw))
    np.testing.assert_array_equal(got, eager)


def test_chroma_mean_order_is_numpys():
    """The 2x2 mean sums ((a + b) + (c + d)), a and b the upper row's
    pair: numpy's reshape(h/2, 2, w/2, 2).mean((1, 3)) exactly, which
    each other order of the four terms misses (so this test fails under
    any of them)."""
    rs = np.random.RandomState(5)
    u = (rs.rand(512, 1024).astype(np.float32) - 0.5)
    want = u.reshape(256, 2, 512, 2).mean((1, 3))
    got = color.downsample_chroma_box(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)
    a, b, c, d = u[0::2, 0::2], u[0::2, 1::2], u[1::2, 0::2], u[1::2, 1::2]
    for other in ((((a + b) + c) + d), (((a + c) + b) + d),
                  ((a + c) + (b + d)), (((a + d) + b) + c)):
        assert (other / np.float32(4) != want).mean() > 0.05


def test_codes_dtypes_and_refusals():
    x = torch.from_numpy(_frames(1, 4, 6))
    y, u, v = color_k.rgb_to_yuv420_u8(x, YUVFormat("bt601", False, 10))
    assert y.dtype == u.dtype == torch.int16 and color.codes_numpy(
        y).dtype == np.uint16
    assert tuple(u.shape) == (1, 2, 3)
    with pytest.raises(ValueError, match="even"):
        color_k.rgb_to_yuv420_u8(x[:, :3], YUVFormat())
    with pytest.raises(ValueError, match="uint8"):
        color_k.rgb_to_yuv420_u8(x.float(), YUVFormat())
    with pytest.raises(ValueError, match="bits"):
        color_k.rgb_to_yuv420_u8(x, YUVFormat(bits=12))
    with pytest.raises(ValueError, match="even"):
        color.rgb_u8_to_yuv420(x[:, :, :5])
    assert color_k.plane_bytes(4, 6, 8) == 24 + 2 * 6
    assert color_k.plane_bytes(4, 6, 10) == 2 * (24 + 2 * 6)


def test_k9_constants_are_the_plain_versions():
    """The float32 constants K9 gets are those ops/color.py computes
    with: the luma weights, the chroma divisors, each code's scale and
    offset, per form."""
    for fmt in FORMS:
        k = color_k.constants(fmt)
        kr, kg, kb = color._coeffs(fmt.matrix)
        assert k[:5] == [float(np.float32(c)) for c in (
            kr, kg, kb, 2 * (1 - kb), 2 * (1 - kr))]
        s = 1 << (fmt.bits - 8)
        m = float((1 << fmt.bits) - 1)
        assert k[5:] == ([m, 0.0, m, 128.0 * s] if fmt.full_range else
                         [219.0 * s, 16.0 * s, 224.0 * s, 128.0 * s])


# -- the engine's planes route ---------------------------------------------

def _engine(**kw):
    import jax

    from reve_tpu.models import srvgg as jsrvgg

    jp = jsrvgg.init_params(jax.random.key(0), jsrvgg.SRVGGConfig(
        num_feat=16, num_conv=3, upscale=2))
    cfg = srvgg.SRVGGConfig(num_feat=16, num_conv=3, upscale=2)
    return UpscaleEngine(device="cpu", compute_dtype="float32",
                         batch_size=2, preloaded=(cfg,
                                                  srvgg.params_from_jax(jp)),
                         **kw)


@pytest.mark.parametrize("kw", [{}, {"tile": 8}, {"tta": True}],
                         ids=["whole", "tiles", "tta"])
@pytest.mark.parametrize("fmt", [YUVFormat("bt601", False, 8),
                                 YUVFormat("bt709", False, 10)],
                         ids=["y4m8", "ffmpeg10"])
def test_engine_planes_equal_color_np_of_its_rgb(fmt, kw):
    """A batch of the planes route (K9's plain version on the CPU, after
    the tiles' assembly or TTA's mean) equals color_np of the RGB route's
    frames, code for code; a short batch is cropped alike, and
    upscale_frames stays RGB."""
    frames = _frames(3, 12, 20, seed=7)
    eng = _engine(**kw)
    rgb = eng.upscale_frames(frames)
    eng.set_output_format(fmt)
    assert eng.upscale_frames(frames).shape == rgb.shape
    got = [eng.submit(frames[i:i + 2]).result() for i in (0, 2)]
    assert all(isinstance(p, Planes) for p in got)
    assert [len(p.y) for p in got] == [2, 1]
    for i, f in enumerate(rgb):
        p = got[i // 2]
        want = color_np.rgb_to_yuv420_np(f, matrix=fmt.matrix,
                                         full_range=fmt.full_range,
                                         bits=fmt.bits)
        for g, w in zip((p.y[i % 2], p.u[i % 2], p.v[i % 2]), want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fmt", [None, YUVFormat("bt601", False, 10)],
                         ids=["rgb", "planes"])
def test_engine_drops_each_pieces_output_before_the_next_runs(fmt,
                                                              monkeypatch):
    """Chunked whole frames: when a chunk's model call starts, the last
    chunk's output (and its planes) is gone, so on the card its segment
    is free for the next chunk's same-sized tensors (a live one splits
    it: a float32 RRDB batch ran out of memory that way)."""
    import weakref

    from reve_tpu_torch.pipeline.engine import Plan

    eng = _engine()
    eng.set_output_format(fmt)
    monkeypatch.setattr(eng, "_plan_execution", lambda h, w: Plan(0, 1))
    forward, outputs, alive = eng._forward, [], []

    def tracked(x):
        alive.append(sum(r() is not None for r in outputs))
        y = forward(x)
        outputs.append(weakref.ref(y))
        return y

    monkeypatch.setattr(eng, "_forward", tracked)
    eng.submit(_frames(2, 12, 20)).result()
    assert alive == [0, 0]


def test_engine_plan_bills_the_planes():
    eng = _engine()
    io, frame = eng._io_batch_bytes(12, 20), eng._frame_bytes(12, 20)
    eng.set_output_format(YUVFormat("bt601", False, 10))
    planes = 2 * (24 * 40 + 2 * 12 * 20)
    assert eng._frame_bytes(12, 20) == frame + planes
    assert eng._io_batch_bytes(12, 20) == io + 2 * planes
    with pytest.raises(ValueError, match="bits"):
        eng.set_output_format(YUVFormat("bt601", False, 9))


# -- the writers' and the scheduler's route --------------------------------

def test_planes_format_by_backend(monkeypatch, tmp_path):
    s10, s8 = writer.EncodeSettings(), writer.EncodeSettings(
        pix_fmt="yuv420p")
    assert writer.planes_format("p.y4m", s10) == YUVFormat("bt601", False,
                                                           10)
    assert writer.planes_format("p.mp4", s8, "y4m") == YUVFormat(
        "bt601", False, 8)
    monkeypatch.setattr(writer.shutil, "which", lambda _exe: None)
    assert writer.planes_format("p.mp4", s10) is None          # cv2
    assert writer.planes_format("p.mp4", s10, "cv2") is None
    assert writer.planes_format("p.mp4", s10, "ffmpeg") is None  # refused
    monkeypatch.setattr(writer.shutil, "which", lambda _exe: "/x/ffmpeg")
    assert writer.planes_format("p.mp4", s10) == YUVFormat("bt709", False,
                                                           10)
    assert writer.planes_format("p.mp4", s10, "cv2") is None
    # each writer takes the planes its format names
    y4m = writer.Y4MWriter(str(tmp_path / "a.y4m"), 4, 2,
                           fractions.Fraction(24), bits=8)
    assert y4m.planes_format == YUVFormat("bt601", False, 8)
    y4m.close()
    assert writer.FfmpegX265Writer.planes_format == YUVFormat("bt709",
                                                              False, 10)
    assert writer.FrameWriter.planes_format is None


@pytest.mark.parametrize("bits", [8, 10])
def test_y4m_write_planes_equals_write(tmp_path, bits):
    frames = _frames(2, 6, 8, seed=bits)
    paths = [str(tmp_path / f"{k}.y4m") for k in "ab"]
    with writer.Y4MWriter(paths[0], 8, 6, fractions.Fraction(24),
                          bits=bits) as wr:
        for f in frames:
            wr.write(f)
    with writer.Y4MWriter(paths[1], 8, 6, fractions.Fraction(24),
                          bits=bits) as wr:
        for f in frames:
            wr.write_planes(*color_np.rgb_to_yuv420_np(
                f, matrix="bt601", bits=bits))
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_scheduler_asks_the_engine_for_its_writers_planes(tmp_path,
                                                         monkeypatch):
    from reve_tpu_torch.pipeline.planner import Segment
    from reve_tpu_torch.pipeline.state import JobState

    inp = str(tmp_path / "in.y4m")
    with writer.Y4MWriter(inp, 8, 6, fractions.Fraction(24)) as wr:
        wr.write(_frames(1, 6, 8)[0])
    state = JobState(input_path=inp, output_path=str(tmp_path / "o.y4m"),
                     frame_count=1, fps_num=24, fps_den=1, width=8,
                     height=6, scale=2, segment_size=1,
                     pending=[Segment(0, 0, 1)])
    ws = Workspace(str(tmp_path / "ws"))
    ws.create()
    eng = _engine()
    scheduler.PipelineJob(state, ws, eng, io_backend="y4m",
                          part_ext=".y4m")
    assert eng.output_format == YUVFormat("bt601", False, 10)
    monkeypatch.setattr(writer.shutil, "which", lambda _exe: None)
    eng2 = _engine()
    job = scheduler.PipelineJob(state, ws, eng2, io_backend=None,
                                part_ext=".mp4")
    assert eng2.output_format is None and job.planes is None


def _job_input(tmp_path, frames=4, w=16, h=12):
    path = str(tmp_path / "in.y4m")
    with writer.Y4MWriter(path, w, h, fractions.Fraction(24)) as wr:
        for f in _frames(frames, h, w, seed=11):
            wr.write(f)
    return path


def test_cli_y4m_job_bytes_equal_the_rgb_route(tmp_path, monkeypatch):
    """A y4m CLI job on the planes route writes the file the RGB route
    (the writer's own write(rgb), the route before the engine made
    planes) writes, byte for byte; the planes route's encode thread never
    converts colour on the host."""
    inp = _job_input(tmp_path)
    argv = ["-s", "4", "--io-backend", "y4m", "--weights", PTH, "-S", "2",
            "--batch", "2", "--dtype", "float32", "--yes"]
    monkeypatch.chdir(tmp_path)

    def no_host_conversion(*a, **k):
        raise AssertionError("color_np ran on the encode thread")

    with monkeypatch.context() as m:
        m.setattr(color_np, "rgb_to_yuv420_np", no_host_conversion)
        assert cli.run(["-i", inp, str(tmp_path / "planes.y4m")] + argv,
                       device="cpu") == 0
    with monkeypatch.context() as m:
        m.setattr(writer, "planes_format", lambda *a, **k: None)
        assert cli.run(["-i", inp, str(tmp_path / "rgb.y4m")] + argv,
                       device="cpu") == 0
    a = open(tmp_path / "planes.y4m", "rb").read()
    b = open(tmp_path / "rgb.y4m", "rb").read()
    assert b"C420p10" in a[:64] and len(a) > 4 * 64 * 48
    assert a == b
