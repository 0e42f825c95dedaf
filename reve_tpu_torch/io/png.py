"""PNG reader and writer of the port, on zlib and numpy.

The card's machine has neither cv2 nor PIL, so image mode reads and
writes PNG with this module on every machine (no silent codec swap where
cv2 happens to import).

`decode` returns what `cv2.imread(path, cv2.IMREAD_UNCHANGED)` returns
for the same file (held against it by tests/test_torch_image.py):

  * colour type 0 (gray): a 2-D array; 1-, 2- and 4-bit samples scaled to
    0..255 (x 255, 85, 17), 16-bit ones as uint16; tRNS ignored;
  * colour type 2 (RGB): BGR; with tRNS, BGRA whose alpha is 0 where a
    pixel equals the tRNS colour and the depth's maximum elsewhere;
  * colour type 3 (palette, 1-8 bits): BGR through the palette (indices
    past it read black); with tRNS, BGRA, entries past tRNS opaque;
  * colour type 4 (gray + alpha): BGRA, the gray replicated;
  * colour type 6 (RGBA): BGRA;
  * 16-bit samples as native uint16; Adam7-interlaced files decoded.

Every chunk's CRC is checked: a critical chunk (IHDR, PLTE, IDAT, IEND)
whose CRC fails, or any malformed image, raises DecodeError (cv2: no
image); an ancillary chunk whose CRC fails is skipped, as libpng skips it.
Features a reader may lack raise Unsupported, naming them; this one
refuses none of PNG's standard colour types, depths or interlace methods.

Unfiltering: None, Sub (a cumulative sum mod 256) and Up run in numpy a
row at a time; Average and Paeth depend on the byte a pixel before them
in the same row, so they run in the native core's loop
(`_native/png.cpp`), or, where the core did not build, in a Python loop a
pixel at a time (native.py's convention: callers degrade to their Python
paths).

`encode` writes 8- and 16-bit gray, RGB and RGBA from cv2's layout (2-D
gray, BGR, BGRA), every row with one filter, Up (`WRITE_FILTER`), at
zlib level 1 (`WRITE_LEVEL`, cv2's own default speed), not interlaced.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: the writer's filter for every row: Up (each byte minus the one above)
WRITE_FILTER = 2
#: the writer's zlib level
WRITE_LEVEL = 1
#: rows the writer filters and compresses at a time
_WRITE_ROWS = 256

#: Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
#: samples a pixel by colour type, and the depths each type allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


class DecodeError(ValueError):
    """The data is not a well-formed image (cv2.imread: None)."""


class Unsupported(ValueError):
    """A well-formed image using a feature this reader refuses, named in
    the message."""


def _chunks(data: bytes):
    """(type, payload) of each chunk up to IEND; critical chunks whose CRC
    fails raise, ancillary ones are skipped."""
    if not data.startswith(SIGNATURE):
        raise DecodeError("not a PNG file (bad signature)")
    pos = len(SIGNATURE)
    while True:
        if pos + 12 > len(data):
            raise DecodeError("truncated PNG (no IEND chunk)")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        end = pos + 8 + n
        if end + 4 > len(data):
            raise DecodeError(f"truncated PNG chunk {ctype!r}")
        body = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        pos = end + 4
        critical = not ctype[0] & 0x20
        if zlib.crc32(ctype + body) != crc:
            if critical:
                raise DecodeError(f"PNG chunk {ctype.decode('latin-1')!r}: "
                                  f"CRC error")
            continue
        yield ctype, body
        if ctype == b"IEND":
            return


def _unfilter_py(f: int, cur: np.ndarray, prev: np.ndarray,
                 out: np.ndarray, bpp: int) -> None:
    """Average (3) or Paeth (4), a pixel at a time (no native core)."""
    cur = cur.astype(np.int32)
    prev = prev.astype(np.int32)
    res = np.zeros(len(cur), np.int32)
    zero = np.zeros(bpp, np.int32)
    for i in range(0, len(cur), bpp):
        j = slice(i, i + bpp)
        a = res[i - bpp:i] if i else zero
        b = prev[j]
        if f == 3:
            res[j] = (cur[j] + ((a + b) >> 1)) & 0xFF
        else:
            c = prev[i - bpp:i] if i else zero
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
            res[j] = (cur[j] + pred) & 0xFF
    out[:] = res


def _unfilter(raw: np.ndarray, rows: int, rowbytes: int,
              bpp: int) -> np.ndarray:
    """(rows, rowbytes) unfiltered bytes of one image or Adam7 pass from
    `raw`, its rows each led by a filter-type byte."""
    a = raw.reshape(rows, rowbytes + 1)
    ftypes = a[:, 0]
    if ftypes.max(initial=0) > 4:
        raise DecodeError(f"bad PNG filter type {int(ftypes.max())}")
    lib = None
    if (ftypes >= 3).any():
        from reve_tpu_torch import native

        lib = native.load()
    out = np.empty((rows, rowbytes), np.uint8)
    zero = np.zeros(rowbytes, np.uint8)
    prev = zero
    for r in range(rows):
        f, cur, dst = int(ftypes[r]), a[r, 1:], out[r]
        if f == 0:
            dst[:] = cur
        elif f == 1:
            np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8,
                      out=dst.reshape(-1, bpp))
        elif f == 2:
            np.add(cur, prev, out=dst)
        elif lib is not None:
            lib.rc_png_unfilter_row(f, cur.ctypes.data, prev.ctypes.data,
                                    dst.ctypes.data, rowbytes, bpp)
        else:
            _unfilter_py(f, cur, prev, dst, bpp)
        prev = dst
    return out


def _samples(rows: np.ndarray, width: int, depth: int,
             channels: int) -> np.ndarray:
    """Unfiltered rows -> (rows, width, channels) samples (uint8, or
    uint16 at 16 bits; sub-byte samples unpacked, not scaled)."""
    h = rows.shape[0]
    if depth == 16:
        s = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        s = rows
    else:
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        s = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            h, rows.shape[1] * per)
    return s[:, :width * channels].reshape(h, width, channels)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> the array cv2.imread(..., IMREAD_UNCHANGED) gives
    (module docstring); raises DecodeError or Unsupported."""
    ihdr = plte = trns = None
    idat = []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            if len(body) != 13:
                raise DecodeError("bad IHDR length")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = body
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype != b"IEND" and not ctype[0] & 0x20:
            raise DecodeError(f"unknown critical PNG chunk {ctype!r}")
    if ihdr is None or not idat:
        raise DecodeError("PNG without IHDR or IDAT")
    w, h, depth, ct, comp, filt, interlace = ihdr
    if w == 0 or h == 0 or ct not in _CHANNELS or \
            depth not in _DEPTHS[ct] or comp or filt or interlace > 1:
        raise DecodeError(f"bad PNG header {ihdr}")
    if ct == 3 and (plte is None or len(plte) % 3 or not plte):
        raise DecodeError("palette PNG without a valid PLTE")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise DecodeError(f"PNG image data: {e}") from None
    ch = _CHANNELS[ct]
    bpp = max(1, ch * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        rowbytes = (pw * ch * depth + 7) // 8
        n = ph * (rowbytes + 1)
        if pos + n > len(raw):
            raise DecodeError("truncated PNG image data")
        rows = _unfilter(raw[pos:pos + n], ph, rowbytes, bpp)
        samples[y0::dy, x0::dx] = _samples(rows, pw, depth, ch)
        pos += n
    return _to_cv2(samples, ct, depth, plte, trns)


def _to_cv2(s: np.ndarray, ct: int, depth: int, plte: Optional[bytes],
            trns: Optional[bytes]) -> np.ndarray:
    """Samples -> cv2's layout (module docstring)."""
    if ct == 0:
        g = s[:, :, 0]
        if depth < 8:
            g = g * np.uint8(255 // ((1 << depth) - 1))
        return np.ascontiguousarray(g)
    if ct == 3:
        pal = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte, np.uint8).reshape(-1, 3)[:256]
        pal[:len(entries)] = entries
        idx = s[:, :, 0]
        bgr = pal[idx][:, :, ::-1]
        if trns is None:
            return np.ascontiguousarray(bgr)
        alpha = np.full(256, 255, np.uint8)
        t = np.frombuffer(trns, np.uint8)[:256]
        alpha[:len(t)] = t
        return np.dstack([bgr, alpha[idx]])
    if ct == 2:
        bgr = s[:, :, ::-1]
        if trns is None or len(trns) != 6:
            return np.ascontiguousarray(bgr)
        key = np.array(struct.unpack(">HHH", trns), np.uint32)
        top = (1 << depth) - 1
        clear = (s.astype(np.uint32) == key).all(axis=2)
        alpha = np.where(clear, 0, top).astype(s.dtype)
        return np.dstack([bgr, alpha])
    if ct == 4:
        g, a = s[:, :, 0], s[:, :, 1]
        return np.dstack([g, g, g, a])
    return np.ascontiguousarray(s[:, :, [2, 1, 0, 3]])


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode(img: np.ndarray) -> bytes:
    """cv2-layout array (2-D or one-channel gray, BGR, BGRA; uint8 or
    uint16) -> PNG bytes: gray, RGB or RGBA at 8 or 16 bits, filter Up,
    zlib level WRITE_LEVEL."""
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG writer takes uint8 or uint16, got "
                         f"{img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        ct, px = 0, img[:, :, None]
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        ct = 2 if img.shape[2] == 3 else 6
        px = img[:, :, [2, 1, 0, 3][:img.shape[2]]]
    else:
        raise ValueError(f"PNG writer takes gray, BGR or BGRA, got shape "
                         f"{img.shape}")
    h, w, ch = px.shape
    if h == 0 or w == 0:
        raise ValueError("PNG writer takes a non-empty image")
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(px.astype(">u2") if depth == 16 else px) \
        .view(np.uint8).reshape(h, w * ch * depth // 8)
    comp = zlib.compressobj(WRITE_LEVEL)
    parts = [SIGNATURE, _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ct, 0, 0, 0))]
    prev = np.zeros((1, rows.shape[1]), np.uint8)
    for r in range(0, h, _WRITE_ROWS):
        block = rows[r:r + _WRITE_ROWS]
        filt = np.empty((len(block), rows.shape[1] + 1), np.uint8)
        filt[:, 0] = WRITE_FILTER
        np.subtract(block, np.concatenate([prev, block[:-1]]),
                    out=filt[:, 1:])
        prev = block[-1:]
        z = comp.compress(filt.tobytes())
        if z:
            parts.append(_chunk(b"IDAT", z))
    parts.append(_chunk(b"IDAT", comp.flush()))
    parts.append(_chunk(b"IEND", b""))
    return b"".join(parts)


def write(path: str, img: np.ndarray) -> None:
    data = encode(img)
    with open(path, "wb") as f:
        f.write(data)
