"""The port's image mode against reve_tpu and cv2, on the CPU.

  * routing: reve_tpu_torch.io.image.upscale_image_array against
    reve_tpu.io.image's with one deterministic numpy engine passed to
    both (gray, BGR, BGRA at 8 and 16 bits): equal arrays (n_diff 0);
  * the port's PNG and BMP readers (io/png.py, io/bmp.py) against
    cv2.imread(IMREAD_UNCHANGED) on files cv2 and PIL write here and on
    files built below with every colour type, depth, filter type and
    Adam7 interlace: equal arrays; corrupt files are None for both,
    refused BMP features raise naming them;
  * the writers: cv2 reads the port's PNGs and BMPs back as the written
    array (and the BMPs are cv2's own bytes);
  * without cv2, JPEG and WebP are refused by name before any engine is
    built;
  * the CLI's image and directory modes and api.upscale_image against
    reve_tpu's in float32 on the CPU, in the cases of
    tests/test_image_modes.py, with one seeded 16-feature x2 SRVGG .pth
    for both: exit codes, messages, output names and skips the
    reference's, pixels within u8 |d| <= 1 (lossy outputs compared as
    the arrays handed to cv2.imwrite).
"""

import contextlib
import io
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import reve_tpu
from reve_tpu import cli as jcli
from reve_tpu.io import image as jimage
from reve_tpu_torch import api, cli, native
from reve_tpu_torch.io import bmp, image, png
from reve_tpu_torch.models import srvgg
from reve_tpu_torch.weights import torch_loader

torch.set_num_threads(2)


def _rs(seed=0):
    return np.random.RandomState(seed)


# -- routing ---------------------------------------------------------------

class MixEngine:
    """Deterministic numpy stand-in for UpscaleEngine.upscale_frames: x2
    nearest of a channel mix, so that a swapped channel order shows."""

    def upscale_frames(self, frames):
        f = frames.astype(np.int32)
        mixed = (3 * f + f[..., [1, 2, 0]] + 2 * f[..., [2, 0, 1]]) // 6
        up = np.repeat(np.repeat(mixed, 2, axis=1), 2, axis=2)
        return np.clip(up + (np.arange(up.shape[2]) % 3)[None, None, :,
                                                           None],
                       0, 255).astype(np.uint8)


LAYOUTS = {
    "gray": (9, 11), "bgr": (9, 11, 3), "bgra": (9, 11, 4),
}


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_routing_matches_reve_tpu(layout, dtype):
    top = 256 if dtype == np.uint8 else 65536
    img = _rs(1).randint(0, top, LAYOUTS[layout]).astype(dtype)
    notes, jnotes = [], []
    got, w16 = image.upscale_image_array(MixEngine(), img, note=notes.append)
    want, jw16 = jimage.upscale_image_array(MixEngine(), img,
                                            note=jnotes.append)
    assert (w16, notes) == (jw16, jnotes)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert int((got != want).sum()) == 0
    np.testing.assert_array_equal(image.to_output_depth(got, w16),
                                  jimage.to_output_depth(want, jw16))


def test_layout_helpers_match_reve_tpu():
    bgr = _rs(2).randint(0, 256, (7, 5, 3)).astype(np.uint8)
    np.testing.assert_array_equal(image._luma(bgr), jimage._luma(bgr))
    u16 = _rs(3).randint(0, 65536, (4, 6)).astype(np.uint16)
    np.testing.assert_array_equal(image.to_u8(u16)[0], jimage.to_u8(u16)[0])
    for shape in ((4, 4), (4, 4, 3), (4, 4, 4)):
        a = np.zeros(shape, np.uint8)
        assert image.classify(a) == jimage.classify(a)
    with pytest.raises(ValueError, match="unsupported image shape"):
        image.classify(np.zeros((4, 4, 2), np.uint8))
    with pytest.raises(ValueError, match="unsupported image dtype"):
        image.to_u8(u16.astype(np.float32))
    for p in ("a.png", "a.WEBP", "a.jpg", "a.bmp"):
        assert image.alpha_ok(p) == jimage.alpha_ok(p)


# -- PNG files built here ----------------------------------------------------

def _chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows, bpp, filters):
    """Forward PNG filters, row r with filters[r % len(filters)]."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for r, row in enumerate(rows.astype(np.int32)):
        f = filters[r % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = {0: 0, 1: a, 2: prev, 3: (a + prev) >> 1,
                4: _paeth(a, prev, c)}[f]
        out.append(bytes([f]) + ((row - pred) & 0xFF).astype(np.uint8)
                   .tobytes())
        prev = row
    return b"".join(out)


def _pack(samples, depth):
    """(h, n) sample values -> (h, rowbytes) bytes at `depth` bits."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(
            samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    h, n = samples.shape
    padded = np.zeros((h, -(-n // per) * per), np.int32)
    padded[:, :n] = samples
    shifts = np.arange(8 - depth, -1, -depth)
    return (padded.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def make_png(samples, depth, ct, filters=(0,), interlace=False,
             extra=b""):
    """A PNG of `samples` ((h, w, channels) values) with the given filter
    types cycled over the rows and optionally Adam7-interlaced."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub.reshape(sub.shape[0], -1), depth)
        raw += _filter_rows(rows, bpp, filters)
    return (png.SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ct, 0,
                                          0, int(interlace)))
            + extra + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


def _plte(n, seed=0):
    return _chunk(b"PLTE", _rs(seed).randint(0, 256, 3 * n)
                  .astype(np.uint8).tobytes())


def _cv2_decode(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)


def _assert_same(got, want):
    assert want is not None
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


BUILT = {
    # name: (ct, depth, shape hw, filters, interlace, extra)
    **{f"rgb8_filter{f}": (2, 8, (13, 17), (f,), False, b"")
       for f in range(5)},
    "rgba16_avg_paeth": (6, 16, (9, 7), (3, 4), False, b""),
    "gray16_mixed": (0, 16, (6, 11), (0, 1, 2, 3, 4), False, b""),
    "gray1": (0, 1, (5, 13), (0, 1, 4), False, b""),
    "gray2": (0, 2, (5, 13), (2, 3), False, b""),
    "gray4": (0, 4, (5, 13), (4,), False, b""),
    "pal1": (3, 1, (6, 9), (4, 2), False, _plte(2)),
    "pal2": (3, 2, (6, 9), (3,), False, _plte(4)),
    "pal4": (3, 4, (6, 9), (1, 4), False, _plte(16)),
    "pal8_short_palette": (3, 8, (6, 9), (4,), False, _plte(7)),
    "pal8_trns": (3, 8, (6, 9), (4,), False,
                  _plte(8) + _chunk(b"tRNS", bytes([0, 128, 255]))),
    "gray_alpha8": (4, 8, (7, 5), (4, 3, 1), False, b""),
    "gray_alpha16": (4, 16, (7, 5), (2, 4), False, b""),
    "rgb8_trns": (2, 8, (6, 6), (4,), False,
                  _chunk(b"tRNS", struct.pack(">HHH", 1, 2, 3))),
    "rgb16_trns": (2, 16, (6, 6), (0,), False,
                   _chunk(b"tRNS", struct.pack(">HHH", 1, 2, 3))),
    "gray8_trns": (0, 8, (6, 6), (0,), False,
                   _chunk(b"tRNS", struct.pack(">H", 7))),
    "gama_sbit": (2, 8, (4, 5), (4,), False,
                  _chunk(b"gAMA", struct.pack(">I", 100000))
                  + _chunk(b"sBIT", bytes([3, 3, 3]))),
    "interlaced_gray1": (0, 1, (11, 13), (0, 4), True, b""),
    "interlaced_rgb8": (2, 8, (17, 9), (1, 2, 3, 4), True, b""),
    "interlaced_pal4": (3, 4, (10, 10), (4,), True, _plte(16, 1)),
    "interlaced_rgba16": (6, 16, (9, 12), (3, 4), True, b""),
    "interlaced_gray_alpha8": (4, 8, (8, 8), (2,), True, b""),
    "interlaced_1x1": (2, 8, (1, 1), (4,), True, b""),
    "interlaced_3x2": (0, 8, (3, 2), (3,), True, b""),
}


def _built(name, seed=0):
    ct, depth, (h, w), filters, interlace, extra = BUILT[name]
    top = (1 << depth) if ct != 3 else {1: 2, 2: 4, 4: 16, 8: 12}[depth]
    samples = _rs(seed).randint(0, top, (h, w, CHANNELS[ct]))
    if name.endswith("_trns"):
        samples[0, 0] = 7 if ct == 0 else (1, 2, 3)[:CHANNELS[ct]]
    return make_png(samples, depth, ct, filters, interlace, extra)


@pytest.mark.parametrize("name", sorted(BUILT))
def test_png_reader_matches_cv2_on_built_files(name):
    data = _built(name)
    _assert_same(png.decode(data), _cv2_decode(data))


@pytest.mark.parametrize("name", ["rgb8_filter3", "rgb8_filter4",
                                  "rgba16_avg_paeth", "interlaced_pal4"])
def test_png_reader_without_the_native_core(name, monkeypatch):
    """Average and Paeth in the Python loop where the core did not build
    (native.py's convention) give the native loop's bytes."""
    monkeypatch.setattr(native, "load", lambda: None)
    data = _built(name, seed=5)
    _assert_same(png.decode(data), _cv2_decode(data))


def test_png_reader_uses_the_native_core_for_average_and_paeth(monkeypatch):
    assert native.available()
    calls = []
    lib = native.load()

    class Spy:
        def rc_png_unfilter_row(self, *a):
            calls.append(a[0])
            return lib.rc_png_unfilter_row(*a)

    monkeypatch.setattr(native, "load", lambda: Spy())
    data = _built("rgba16_avg_paeth")
    _assert_same(png.decode(data), _cv2_decode(data))
    assert sorted(set(calls)) == [3, 4] and len(calls) == 9


CV2_WRITTEN = {
    "gray8": (np.uint8, (23, 31)), "bgr8": (np.uint8, (23, 31, 3)),
    "bgra8": (np.uint8, (23, 31, 4)), "gray16": (np.uint16, (23, 31)),
    "bgr16": (np.uint16, (23, 31, 3)), "bgra16": (np.uint16, (23, 31, 4)),
}


@pytest.mark.parametrize("name", sorted(CV2_WRITTEN))
def test_png_reader_matches_cv2_on_cv2_files(name, tmp_path):
    dtype, shape = CV2_WRITTEN[name]
    arr = _rs(4).randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "x.png")
    assert cv2.imwrite(path, arr)
    _assert_same(png.read(path), cv2.imread(path, cv2.IMREAD_UNCHANGED))
    _assert_same(image.imread(path), arr)


PIL_MODES = ("1", "L", "LA", "P", "P_trns", "RGB", "RGB_trns", "RGBA",
             "I;16", "L_trns")


@pytest.mark.parametrize("mode", PIL_MODES)
def test_png_reader_matches_cv2_on_pil_files(mode, tmp_path):
    rgb = Image.fromarray(_rs(5).randint(0, 256, (21, 26, 3))
                          .astype(np.uint8))
    path = str(tmp_path / "x.png")
    base = mode.split("_")[0]
    if base == "I;16":
        im = Image.fromarray(_rs(6).randint(0, 65536, (21, 26))
                             .astype(np.uint16))
    elif base == "P":
        im = rgb.convert("P", palette=Image.ADAPTIVE, colors=16)
    else:
        im = rgb.convert(base)
    kw = {}
    if mode.endswith("_trns"):
        kw["transparency"] = {"P": 3, "RGB": tuple(np.asarray(rgb)[0, 0]
                                                   .tolist()),
                              "L": 7}[base]
    im.save(path, **kw)
    _assert_same(png.read(path), cv2.imread(path, cv2.IMREAD_UNCHANGED))


def _corrupt(kind):
    data = bytearray(_built("rgb8_filter4"))
    if kind == "critical_crc":
        data[29] ^= 1          # IHDR's CRC
    elif kind == "idat_data":
        i = data.find(b"IDAT")
        data[i + 8] ^= 0x55    # inside the zlib stream
        body_end = i + 4 + struct.unpack(">I", data[i - 4:i])[0]
        data[body_end:body_end + 4] = struct.pack(
            ">I", zlib.crc32(bytes(data[i:body_end])))
    elif kind == "truncated":
        data = data[:len(data) // 2]
    elif kind == "signature":
        data[1] = ord("Q")
    return bytes(data)


@pytest.mark.parametrize("kind", ["critical_crc", "idat_data", "truncated",
                                  "signature"])
def test_corrupt_png_is_no_image_as_in_cv2(kind, tmp_path):
    data = _corrupt(kind)
    assert _cv2_decode(data) is None
    with pytest.raises(png.DecodeError):
        png.decode(data)
    path = tmp_path / "bad.png"
    path.write_bytes(data)
    assert image.imread(str(path)) is None


def test_ancillary_chunk_with_bad_crc_is_skipped_as_in_cv2():
    data = bytearray(_built("gama_sbit"))
    i = data.find(b"gAMA")
    data[i + 4] ^= 1  # gAMA's payload: its CRC no longer matches
    _assert_same(png.decode(bytes(data)), _cv2_decode(bytes(data)))


# -- writers ----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CV2_WRITTEN))
def test_png_writer_read_back_by_cv2(name, tmp_path):
    dtype, shape = CV2_WRITTEN[name]
    arr = _rs(7).randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "x.png")
    png.write(path, arr)
    _assert_same(cv2.imread(path, cv2.IMREAD_UNCHANGED), arr)
    # one filter, Up, on every row of one zlib stream over the IDATs
    idat = b"".join(body for ctype, body in png._chunks(
        open(path, "rb").read()) if ctype == b"IDAT")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        shape[0], -1)
    assert (rows[:, 0] == png.WRITE_FILTER).all() and png.WRITE_FILTER == 2


@pytest.mark.parametrize("shape", [(13, 7), (13, 7, 3), (13, 7, 4),
                                   (1, 1, 3)])
def test_bmp_writer_writes_cv2s_bytes(shape, tmp_path):
    arr = _rs(8).randint(0, 256, shape).astype(np.uint8)
    ours, theirs = str(tmp_path / "a.bmp"), str(tmp_path / "b.bmp")
    bmp.write(ours, arr)
    assert cv2.imwrite(theirs, arr)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    _assert_same(cv2.imread(ours, cv2.IMREAD_UNCHANGED), arr)
    _assert_same(bmp.read(theirs), arr)


def _bmp_bytes(w, h, bpp, comp, rows, masks=b"", palette=b"", hsize=40):
    header = struct.pack("<IiiHHIIiiII", hsize, w, h, 1, bpp, comp, 0, 0,
                         0, len(palette) // 4, 0)
    header += bytes(hsize - 40) if hsize > 40 else b""
    off = 14 + len(header) + len(masks) + len(palette)
    return (b"BM" + struct.pack("<IHHI", off + len(rows), 0, 0, off)
            + header + masks + palette + rows)


BMPS = {
    "top_down24": lambda: _bmp_bytes(
        2, -2, 24, 0, bytes([1, 2, 3, 4, 5, 6, 0, 0, 7, 8, 9, 10, 11, 12,
                             0, 0])),
    "bottom_up24": lambda: _bmp_bytes(
        2, 2, 24, 0, bytes([1, 2, 3, 4, 5, 6, 0, 0, 7, 8, 9, 10, 11, 12,
                            0, 0])),
    "rgb32": lambda: _bmp_bytes(2, 2, 32, 0, bytes(range(16))),
    "bitfields32_no_alpha_mask": lambda: _bmp_bytes(
        2, 2, 32, 3, bytes(range(16)),
        masks=struct.pack("<III", 0xFF0000, 0xFF00, 0xFF)),
    "pal8_color_short": lambda: _bmp_bytes(
        3, 2, 8, 0, bytes([0, 1, 2, 0, 2, 1, 9, 0]),
        palette=bytes([10, 20, 30, 0, 40, 50, 60, 0, 7, 7, 7, 0])),
    "pal8_gray_top_down": lambda: _bmp_bytes(
        3, -2, 8, 0, bytes([0, 1, 2, 0, 2, 1, 0, 0]),
        palette=bytes([5, 5, 5, 0, 9, 9, 9, 0, 200, 200, 200, 0])),
}


@pytest.mark.parametrize("name", sorted(BMPS))
def test_bmp_reader_matches_cv2_on_built_files(name):
    data = BMPS[name]()
    _assert_same(bmp.decode(data), _cv2_decode(data))


@pytest.mark.parametrize("mode", ["P", "L", "RGB", "RGBA"])
def test_bmp_reader_matches_cv2_on_pil_files(mode, tmp_path):
    im = Image.fromarray(_rs(9).randint(0, 256, (11, 9, 3))
                         .astype(np.uint8))
    im = im.convert("P", palette=Image.ADAPTIVE, colors=16) \
        if mode == "P" else im.convert(mode)
    path = str(tmp_path / "x.bmp")
    im.save(path)
    _assert_same(bmp.read(path), cv2.imread(path, cv2.IMREAD_UNCHANGED))


REFUSED_BMPS = {
    "RLE": lambda: _bmp_bytes(2, 2, 8, 1, bytes(8),
                              palette=bytes(range(16))),
    "1-bit": lambda: _bmp_bytes(8, 2, 1, 0, bytes(8),
                                palette=bytes([0, 0, 0, 0, 255, 255, 255,
                                               0])),
    "16-bit": lambda: _bmp_bytes(2, 2, 16, 0, bytes(8)),
    "bit masks": lambda: _bmp_bytes(
        2, 2, 32, 3, bytes(16),
        masks=struct.pack("<III", 0xFF, 0xFF00, 0xFF0000)),
}


@pytest.mark.parametrize("what", sorted(REFUSED_BMPS))
def test_refused_bmp_features_are_named(what, tmp_path):
    path = tmp_path / "x.bmp"
    path.write_bytes(REFUSED_BMPS[what]())
    with pytest.raises(png.Unsupported, match=what):
        image.imread(str(path))


# -- JPEG and WebP without cv2 ----------------------------------------------

@pytest.fixture
def no_cv2(monkeypatch):
    """This machine as the card's: cv2 does not import; and no engine may
    be built."""
    monkeypatch.setattr(image, "_cv2", lambda: None)

    def refuse(*a, **k):
        raise AssertionError("an engine was built")

    monkeypatch.setattr("reve_tpu_torch.pipeline.engine.UpscaleEngine",
                        refuse)


def _image_files(tmp_path):
    """in.jpg, in.webp, in.png and a directory d/ of a.png (and b.jpg)."""
    arr = _rs(10).randint(0, 256, (6, 8, 3)).astype(np.uint8)
    (tmp_path / "d").mkdir()
    for name in ("in.jpg", "in.webp", "in.png", "d/a.png", "d/b.jpg"):
        assert cv2.imwrite(str(tmp_path / name), arr)
    return tmp_path


NO_CODEC = {
    "jpeg_input": (["-i", "in.jpg", "-s", "2", "o.png"], "JPEG"),
    "webp_input": (["-i", "in.webp", "-s", "2", "o.png"], "WebP"),
    "jpeg_output": (["-i", "in.png", "-s", "2", "o.jpg"], "JPEG"),
    "webp_output": (["-i", "in.png", "-s", "2", "o.webp"], "WebP"),
    "dir_with_jpeg": (["-i", "d", "-s", "2", "od"], "JPEG"),
    "dir_format_webp": (["-i", "d", "-s", "2", "od", "-f", "webp"], "WebP"),
}


@pytest.mark.parametrize("case", sorted(NO_CODEC))
def test_jpeg_and_webp_without_cv2_exit_2_before_any_engine(
        case, tmp_path, no_cv2, capsys, monkeypatch):
    root = _image_files(tmp_path)
    if case != "dir_with_jpeg":
        os.unlink(root / "d" / "b.jpg")
    monkeypatch.chdir(root)
    argv, fmt = NO_CODEC[case]
    assert cli.run(argv + ["--dtype", "float32"], device="cpu") == 2
    err = capsys.readouterr().err
    assert fmt in err and "no " + fmt + " codec" in err


def test_api_refuses_webp_without_cv2(tmp_path, no_cv2):
    root = _image_files(tmp_path)
    with pytest.raises(image.CodecUnavailable, match="WebP"):
        api.upscale_image(str(root / "in.webp"), str(root / "o.png"),
                          device="cpu")
    with pytest.raises(image.CodecUnavailable, match="JPEG"):
        api.upscale_image(str(root / "in.png"), str(root / "o.jpeg"),
                          device="cpu")


# -- the CLI's modes against reve_tpu's --------------------------------------

@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """One seeded 16-feature, 2-conv x2 SRVGG .pth both packages load."""
    path = str(tmp_path_factory.mktemp("w") / "m.pth")
    cfg = srvgg.SRVGGConfig(num_feat=16, num_conv=2, upscale=2)
    torch_loader.save_srvgg_pth(path, cfg, srvgg.init_params(
        cfg, torch.Generator().manual_seed(0)))
    return path


class WriteRecorder:
    """cv2.imwrite, recording each array it is handed by absolute path
    (the lossy outputs are compared before their encode)."""

    def __init__(self, monkeypatch):
        self.arrays = {}
        real = cv2.imwrite

        def imwrite(path, img, *a):
            self.arrays[os.path.abspath(path)] = np.array(img)
            return real(path, img, *a)

        monkeypatch.setattr(cv2, "imwrite", imwrite)


def _run(fn, argv, **kw):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = fn(argv, **kw)
    return rc, err.getvalue()


def _outputs(root):
    """{relative name: path} of every file under `root` (a file or a
    directory), or {} where it does not exist."""
    if os.path.isfile(root):
        return {"": root}
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = p
    return out


def run_both(argv, pth, tmp_path, monkeypatch, out="OUT"):
    """Run `argv` (its "OUT" the output path, relative to tmp_path)
    through reve_tpu's CLI and the port's, each with its own output
    path, with `--weights pth --dtype float32`; assert the same exit
    code, messages, output names, and pixels within 1.  Returns (rc,
    stderr of the port, {name: port output array})."""
    rec = WriteRecorder(monkeypatch)
    monkeypatch.chdir(tmp_path)
    res = {}
    for side, fn, kw in (("ref", jcli.run, {}),
                         ("port", cli.run, {"device": "cpu"})):
        dst = out.replace("OUT", f"{side}_out")
        args = [dst if a == "OUT" or a == out else a for a in argv]
        rc, err = _run(fn, args + ["--weights", pth, "--dtype", "float32"],
                       **kw)
        err = err.replace(dst, "OUT")
        lines = [ln for ln in err.splitlines() if "random init" not in ln]
        res[side] = (rc, lines, _outputs(os.path.join(tmp_path, dst)))
    (rc, lines, outs), (prc, plines, pouts) = res["ref"], res["port"]
    assert prc == rc, (plines, lines)
    assert plines == lines
    assert sorted(pouts) == sorted(outs)
    arrays = {}
    for name in outs:
        a = cv2.imread(pouts[name], cv2.IMREAD_UNCHANGED)
        b = cv2.imread(outs[name], cv2.IMREAD_UNCHANGED)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if pouts[name].lower().endswith((".jpg", ".jpeg", ".webp")):
            # lossy: the arrays handed to the encoder (none where both
            # runs skipped the file, written by an earlier run)
            a = rec.arrays.get(os.path.abspath(pouts[name]))
            b = rec.arrays.get(os.path.abspath(outs[name]))
            assert (a is None) == (b is None), name
            if a is None:
                continue
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        step = 257 if a.dtype == np.uint16 else 1
        assert int(d.max(initial=0)) <= step, name
        arrays[name] = a
    return prc, "\n".join(plines), arrays


def _png(tmp_path, name, arr):
    assert cv2.imwrite(str(tmp_path / name), arr)


def test_cli_alpha_png(pth, tmp_path, monkeypatch):
    _png(tmp_path, "in.png", _rs(3).randint(0, 256, (10, 10, 4))
         .astype(np.uint8))
    rc, err, outs = run_both(["-i", "in.png", "-s", "2", "OUT.png"], pth,
                             tmp_path, monkeypatch, out="OUT.png")
    assert rc == 0 and outs[""].shape == (20, 20, 4)
    assert "done: OUT (20x20)" in err


@pytest.mark.parametrize("case", ["gray", "bgr16", "gray16", "bgra16",
                                  "bgr16_to_jpg", "bgr_to_bmp",
                                  "gray_bmp_to_png"])
def test_cli_single_image_layouts(case, pth, tmp_path, monkeypatch):
    rs = _rs(4)
    src, out = "in.png", "OUT.png"
    if case == "gray":
        arr = rs.randint(0, 256, (9, 11)).astype(np.uint8)
    elif case == "gray16":
        arr = rs.randint(0, 65536, (9, 11)).astype(np.uint16)
    elif case == "bgra16":
        arr = rs.randint(0, 65536, (6, 7, 4)).astype(np.uint16)
    elif case == "gray_bmp_to_png":
        arr, src = rs.randint(0, 256, (9, 11)).astype(np.uint8), "in.bmp"
    else:
        arr = rs.randint(0, 65536, (8, 10, 3)).astype(np.uint16) \
            if case.startswith("bgr16") else \
            rs.randint(0, 256, (8, 10, 3)).astype(np.uint8)
    if case.endswith("jpg"):
        out = "OUT.jpg"
    elif case.endswith("bmp") and src == "in.png":
        out = "OUT.bmp"
    _png(tmp_path, src, arr)
    rc, err, outs = run_both(["-i", src, "-s", "2", out], pth, tmp_path,
                             monkeypatch, out=out)
    assert rc == 0
    got = outs[""]
    assert got.shape[:2] == (2 * arr.shape[0], 2 * arr.shape[1])
    if case in ("bgr16", "gray16", "bgra16"):
        assert "16-bit" in err and got.dtype == np.uint16
        assert (got % 257 == 0).all()
    if case == "bgr16_to_jpg":
        assert "cannot carry 16-bit" in err and got.dtype == np.uint8


REFUSALS = {
    "alpha_to_jpg": (["-i", "in4.png", "-s", "2", "OUT.jpg"], "alpha"),
    "format_conflicts": (["-i", "in.png", "-s", "2", "OUT.png", "-f",
                          "jpg"], "conflicts with the output extension"),
    "image_to_video": (["-i", "in.png", "-s", "2", "OUT.mp4"],
                       "requires an image output"),
    "int8_gate": (["-i", "in.png", "-s", "2", "OUT.png", "--int8-gate",
                   "50"], "image mode"),
    "int8_calib_auto": (["-i", "in.png", "-s", "2", "OUT.png",
                         "--int8-calib", "max"], "no effect in image mode"),
    "corrupt_input": (["-i", "bad.png", "-s", "2", "OUT.png"],
                      "cannot decode image"),
    "several_devices": (["-i", "in.png", "-s", "2", "OUT.png", "--device",
                         "0,1"], "one device"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_cli_single_image_refusals(case, pth, tmp_path, monkeypatch):
    rs = _rs(5)
    _png(tmp_path, "in.png", rs.randint(0, 256, (6, 8, 3)).astype(np.uint8))
    _png(tmp_path, "in4.png", rs.randint(0, 256, (6, 8, 4))
         .astype(np.uint8))
    (tmp_path / "bad.png").write_bytes(b"not a png")
    argv, msg = REFUSALS[case]
    dtype = {"int8_calib_auto": "auto", "int8_gate": "int8"}.get(case)
    if dtype is not None:
        # run_both would pass --dtype float32: run both here
        monkeypatch.chdir(tmp_path)
        for fn, kw in ((jcli.run, {}), (cli.run, {"device": "cpu"})):
            rc, err = _run(fn, argv + ["--weights", pth, "--dtype", dtype],
                           **kw)
            assert rc == 2 and msg in err
            assert not os.path.exists(tmp_path / "OUT.png")
        return
    out = [a for a in argv if a.startswith("OUT")][0]
    rc, err, outs = run_both(argv, pth, tmp_path, monkeypatch, out=out)
    assert rc == 2 and msg in err and not outs


def test_cli_single_image_format_jpeg_matches(pth, tmp_path, monkeypatch):
    _png(tmp_path, "in.png", _rs(11).randint(0, 256, (6, 8, 3))
         .astype(np.uint8))
    rc, _, outs = run_both(["-i", "in.png", "-s", "2", "OUT.jpeg", "-f",
                            "jpg"], pth, tmp_path, monkeypatch,
                           out="OUT.jpeg")
    assert rc == 0 and outs[""].shape == (12, 16, 3)


def _dir(tmp_path, files):
    d = tmp_path / "in"
    d.mkdir()
    for name, arr in files.items():
        if isinstance(arr, bytes):
            (d / name).write_bytes(arr)
        else:
            assert cv2.imwrite(str(d / name), arr)
    return d


def test_cli_image_dir_batch_rerun_and_failure(pth, tmp_path, monkeypatch):
    rs = _rs(6)
    d = _dir(tmp_path, {
        "a.png": rs.randint(0, 256, (8, 10, 3)).astype(np.uint8),
        "b.jpg": rs.randint(0, 256, (6, 6, 3)).astype(np.uint8),
        "c.bmp": rs.randint(0, 256, (5, 7, 4)).astype(np.uint8),
        "notes.txt": b"not an image"})
    rc, err, outs = run_both(["-i", "in", "-s", "2", "OUT"], pth, tmp_path,
                             monkeypatch)
    assert rc == 0 and sorted(outs) == ["a.png", "b.jpg", "c.png"]
    assert "alpha channel -> writing c.png" in err
    assert "done: 3 upscaled" in err
    # re-run: everything already present -> all skipped, still rc 0
    rc, err, _ = run_both(["-i", "in", "-s", "2", "OUT"], pth, tmp_path,
                          monkeypatch)
    assert rc == 0 and "0 upscaled, 3 already present (skipped)" in err
    # a corrupt image fails that file (exit 2) but the rest still run
    (d / "z_bad.png").write_bytes(b"not a png")
    rc, err, outs = run_both(["-i", "in", "-s", "2", "OUT2"], pth, tmp_path,
                             monkeypatch, out="OUT2")
    assert rc == 2 and "z_bad.png: cannot decode" in err
    assert "3 upscaled" in err and "1 FAILED" in err


DIR_CASES = {
    # name: (files, extra argv, expected output names)
    "alpha_retarget_collision": (
        {"c.bmp": (5, 7, 4), "c.png": (6, 8, 3)}, [],
        ["c.bmp.png", "c.png"]),
    "format_jpg": (
        {"a.png": (8, 10, 3), "a.bmp": (6, 6, 3), "c.bmp": (5, 7, 4)},
        ["-f", "jpg"], ["a.jpg", "a.png.jpg", "c.png"]),
    "format_webp_keeps_alpha": ({"c.bmp": (5, 7, 4)}, ["-f", "webp"],
                                ["c.webp"]),
    "format_literal_name_owns_slot": (
        {"a.bmp": (6, 6, 3), "a.jpg": (8, 10, 3)}, ["-f", "jpg"],
        ["a.bmp.jpg", "a.jpg"]),
    "gray_and_16bit": ({"g.png": (7, 9), "h.png": (5, 6, 3, 16)}, [],
                       ["g.png", "h.png"]),
}


@pytest.mark.parametrize("case", sorted(DIR_CASES))
def test_cli_image_dir_names(case, pth, tmp_path, monkeypatch):
    files, extra, names = DIR_CASES[case]
    rs = _rs(8)
    arrays = {}
    for name, shape in files.items():
        if len(shape) == 4:
            arrays[name] = rs.randint(0, 65536, shape[:3]).astype(np.uint16)
        else:
            arrays[name] = rs.randint(0, 256, shape).astype(np.uint8)
    _dir(tmp_path, arrays)
    rc, err, outs = run_both(["-i", "in", "-s", "2", "OUT"] + extra, pth,
                             tmp_path, monkeypatch)
    assert rc == 0, err
    assert sorted(outs) == names


DIR_REFUSALS = {
    "empty": ("empty", "no images"),
    "file_output": ("afile", "must be a directory"),
    "into_input": ("in", "must differ"),
    "int8_gate": ("gate", "image mode"),
}


@pytest.mark.parametrize("case", sorted(DIR_REFUSALS))
def test_cli_image_dir_refusals(case, pth, tmp_path, monkeypatch):
    _dir(tmp_path, {"a.png": np.zeros((4, 4, 3), np.uint8)})
    (tmp_path / "empty").mkdir()
    (tmp_path / "afile").write_text("")
    out, msg = DIR_REFUSALS[case]
    src = "empty" if case == "empty" else "in"
    argv = ["-i", src, "-s", "2", out]
    if case == "int8_gate":
        argv = ["-i", src, "-s", "2", "OUT", "--int8-gate", "50"]
    monkeypatch.chdir(tmp_path)
    for fn, kw in ((jcli.run, {}), (cli.run, {"device": "cpu"})):
        rc, err = _run(fn, argv + ["--weights", pth, "--dtype", "int8"
                                   if case == "int8_gate" else "float32"],
                       **kw)
        assert rc == 2 and msg in err


def test_cli_video_mode_rejects_format(tmp_path, capsys):
    import fractions

    from reve_tpu_torch.io import writer as writer_mod

    inp = str(tmp_path / "in.y4m")
    with writer_mod.Y4MWriter(inp, 24, 16, fractions.Fraction(24)) as wr:
        for i in range(2):
            wr.write(np.full((16, 24, 3), 20 * i, np.uint8))
    rc = cli.run(["-i", inp, "-s", "2", str(tmp_path / "o.y4m"), "--yes",
                  "--io-backend", "y4m", "-f", "png"], device="cpu")
    assert rc == 2
    assert "--format applies to image" in capsys.readouterr().err


def test_api_upscale_image_matches_reve_tpu(pth, tmp_path):
    inp = str(tmp_path / "in.png")
    assert cv2.imwrite(inp, _rs(12).randint(0, 256, (7, 9, 4))
                       .astype(np.uint8))
    dims = api.upscale_image(inp, str(tmp_path / "o.png"), scale=2,
                             weights=pth, dtype="float32", device="cpu")
    jdims = reve_tpu.upscale_image(inp, str(tmp_path / "j.png"), scale=2,
                                   weights=pth, dtype="float32")
    assert dims == jdims == (18, 14)
    a = cv2.imread(str(tmp_path / "o.png"), cv2.IMREAD_UNCHANGED)
    b = cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED)
    assert int(np.abs(a.astype(int) - b).max()) <= 1
    import reve_tpu_torch

    assert reve_tpu_torch.upscale_image is api.upscale_image
    with pytest.raises(ValueError, match="alpha"):
        api.upscale_image(inp, str(tmp_path / "o.jpg"), scale=2,
                          weights=pth, dtype="float32", device="cpu")
