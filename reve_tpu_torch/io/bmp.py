"""BMP reader and writer of the port, on numpy: uncompressed BMPs as
cv2.imwrite writes them and most tools emit.

`decode` returns what `cv2.imread(path, cv2.IMREAD_UNCHANGED)` returns
(held against it by tests/test_torch_image.py), top-down (negative
height) and bottom-up rows alike:

  * 8 bits, BI_RGB: through the palette (entries past it read as zero): a
    2-D array when every entry is gray (b == g == r), else BGR;
  * 24 bits, BI_RGB: BGR;
  * 32 bits: BI_RGB drops the fourth byte (BGR); BI_BITFIELDS with the
    standard B, G, R masks keeps it (BGRA), whatever its alpha mask says.

Refused by name (Unsupported): RLE-compressed BMPs, BMPs carrying JPEG or
PNG data, 1-, 4- and 16-bit BMPs, BI_BITFIELDS masks other than B, G, R in
bytes 0, 1, 2, and the OS/2 headers.  Malformed files raise DecodeError
(cv2: no image).

`encode` writes what cv2.imwrite writes: a 2-D uint8 array as 8 bits with
a gray palette, BGR as 24 bits, BGRA as 32 bits with a BITMAPV5HEADER and
BI_BITFIELDS masks B, G, R, A (so that cv2 reads the alpha back), rows
bottom-up and padded to 4 bytes.
"""

from __future__ import annotations

import struct

import numpy as np

from reve_tpu_torch.io.png import DecodeError, Unsupported

SIGNATURE = b"BM"
_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS = 0, 1, 2, 3
_STD_MASKS = (0x00FF0000, 0x0000FF00, 0x000000FF)
#: BITMAPV5HEADER's colour space "sRGB", as cv2 writes it
_LCS_SRGB = 0x73524742


def _stride(width: int, bpp: int) -> int:
    return (width * bpp + 31) // 32 * 4


def decode(data: bytes) -> np.ndarray:
    """BMP bytes -> the array cv2.imread(..., IMREAD_UNCHANGED) gives
    (module docstring); raises DecodeError or Unsupported."""
    if len(data) < 26 or not data.startswith(SIGNATURE):
        raise DecodeError("not a BMP file (bad signature)")
    (offbits,) = struct.unpack("<I", data[10:14])
    (hsize,) = struct.unpack("<I", data[14:18])
    if hsize == 12 or hsize == 64:
        raise Unsupported("OS/2 BMP headers are not supported")
    if hsize < 40 or len(data) < 14 + hsize:
        raise DecodeError(f"bad BMP header size {hsize}")
    w, h, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
    (clr_used,) = struct.unpack("<I", data[46:50])
    if comp in (_BI_RLE8, _BI_RLE4):
        raise Unsupported("RLE-compressed BMP is not supported")
    if comp not in (_BI_RGB, _BI_BITFIELDS):
        raise Unsupported(f"BMP compression {comp} (JPEG or PNG in a BMP) "
                          f"is not supported")
    if bpp not in (8, 24, 32):
        raise Unsupported(f"{bpp}-bit BMP is not supported (8, 24 and "
                          f"32 bits are)")
    if w <= 0 or h == 0:
        raise DecodeError(f"bad BMP size {w} x {h}")
    alpha = False
    if comp == _BI_BITFIELDS:
        if bpp != 32:
            raise Unsupported(f"BI_BITFIELDS at {bpp} bits is not "
                              f"supported")
        # after a 40-byte header, or inside a V4 or V5 one: both at 54
        if len(data) < 66:
            raise DecodeError("truncated BMP bit masks")
        masks = struct.unpack("<III", data[54:66])
        if masks != _STD_MASKS:
            raise Unsupported(f"BMP bit masks {[hex(m) for m in masks]} "
                              f"other than B, G, R in bytes 0, 1, 2 are "
                              f"not supported")
        alpha = True
    top_down = h < 0
    h = abs(h)
    stride = _stride(w, bpp)
    if offbits + stride * h > len(data):
        raise DecodeError("truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * h, offbits).reshape(
        h, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp == 8:
        n = clr_used or 256
        pal_at = 14 + hsize
        if pal_at + 4 * n > offbits or n > 256:
            raise DecodeError("bad BMP palette")
        pal = np.zeros((256, 4), np.uint8)
        pal[:n] = np.frombuffer(data, np.uint8, 4 * n, pal_at).reshape(n, 4)
        idx = rows[:, :w]
        if (pal[:, 0] == pal[:, 1]).all() and (pal[:, 0] == pal[:, 2]).all():
            return np.ascontiguousarray(pal[idx, 0])
        return np.ascontiguousarray(pal[idx, :3])
    px = rows[:, :w * bpp // 8].reshape(h, w, bpp // 8)
    return np.ascontiguousarray(px if alpha else px[:, :, :3])


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def encode(img: np.ndarray) -> bytes:
    """cv2-layout uint8 array (2-D gray, BGR, BGRA) -> BMP bytes as
    cv2.imwrite writes them (module docstring)."""
    if img.dtype != np.uint8:
        raise ValueError(f"BMP writer takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        bpp, px = 8, img[:, :, None]
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        bpp, px = 8 * img.shape[2], img
    else:
        raise ValueError(f"BMP writer takes gray, BGR or BGRA, got shape "
                         f"{img.shape}")
    h, w = px.shape[:2]
    if h == 0 or w == 0:
        raise ValueError("BMP writer takes a non-empty image")
    stride = _stride(w, bpp)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bpp // 8] = px.reshape(h, -1)
    if bpp == 32:
        header = struct.pack("<IiiHHIIiiII", 124, w, h, 1, 32, _BI_BITFIELDS,
                             0, 0, 0, 0, 0)
        header += struct.pack("<IIIII", *_STD_MASKS, 0xFF000000, _LCS_SRGB)
        header += bytes(124 - len(header))
        palette = b""
    else:
        header = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, _BI_RGB, 0,
                             0, 0, 0, 0)
        palette = b""
        if bpp == 8:  # the gray ramp: entry i is (i, i, i, 0)
            pal = np.zeros((256, 4), np.uint8)
            pal[:, :3] = np.arange(256, dtype=np.uint8)[:, None]
            palette = pal.tobytes()
    off = 14 + len(header) + len(palette)
    size = off + rows.nbytes
    return (SIGNATURE + struct.pack("<IHHI", size, 0, 0, off) + header
            + palette + rows[::-1].tobytes())


def write(path: str, img: np.ndarray) -> None:
    data = encode(img)
    with open(path, "wb") as f:
        f.write(data)
