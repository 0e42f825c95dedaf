"""Single-image channel semantics: grayscale / alpha / 16-bit handling.

The port's copy of reve_tpu/io/image.py.  The model is RGB-only, so every
layout is routed through the 3-channel engine:

  * grayscale   -> replicated to 3 channels; output converted back to
                   single-channel luma (upstream `img_mode == 'L'` rule)
  * BGRA        -> color planes through the model; the alpha plane is
                   replicated to 3 channels, upscaled through the SAME
                   model, and reduced back to one channel
  * 16-bit      -> reduced to 8-bit for the u8-native engine and written
                   back as 16-bit (PNG only) so the container depth
                   survives; a note is printed because the low byte's
                   precision does not

Everything here is host-side numpy around `UpscaleEngine.upscale_frames`;
the engine (and with it --tta, --dtype, tiling) is untouched.

Files: PNG and BMP decode and encode with the port's own codecs
(io/png.py, io/bmp.py) on every machine; JPEG and WebP through cv2 where
it imports, and where it does not they raise CodecUnavailable naming the
format (the card's machine has no cv2).  `imread` and `imwrite` are the
cv2.imread(IMREAD_UNCHANGED) / cv2.imwrite counterparts: imread picks the
codec by the file's signature, as cv2 does, imwrite by the extension.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

import numpy as np

from reve_tpu_torch.io import bmp, png

#: output encodings that can carry an alpha plane
ALPHA_EXTS = (".png", ".webp")
#: output encodings that can carry 16-bit samples; writing a widened u16
#: array to any other encoder would saturate it to white
SIXTEEN_BIT_EXTS = (".png",)
#: encodings only cv2 reads and writes here, by extension
CV2_FORMATS = {".jpg": "JPEG", ".jpeg": "JPEG", ".webp": "WebP"}


class CodecUnavailable(ValueError):
    """A JPEG or WebP file on a machine where cv2 does not import."""


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _no_codec(fmt: str, path: str) -> CodecUnavailable:
    return CodecUnavailable(
        f"{fmt} ({path!r}): no {fmt} codec on this machine (cv2 does not "
        f"import; the port's own codecs are PNG and BMP)")


def codec_missing(path: str) -> Optional[str]:
    """The refusal for writing (or, by name, reading) `path` where its
    extension needs cv2 and cv2 does not import, else None."""
    fmt = CV2_FORMATS.get(os.path.splitext(path)[1].lower())
    if fmt is None or _cv2() is not None:
        return None
    return str(_no_codec(fmt, path))


def _sniff(data: bytes) -> Optional[str]:
    if data.startswith(png.SIGNATURE):
        return "PNG"
    if data.startswith(bmp.SIGNATURE):
        return "BMP"
    if data.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    return None


def imread(path: str) -> Optional[np.ndarray]:
    """cv2.imread(path, IMREAD_UNCHANGED): the decoded image, or None when
    the file cannot be read or decoded.  Raises png.Unsupported for a
    well-formed file using a feature the port's codecs refuse, and
    CodecUnavailable for a JPEG or WebP file without cv2."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    fmt = _sniff(data)
    try:
        if fmt == "PNG":
            return png.decode(data)
        if fmt == "BMP":
            return bmp.decode(data)
    except png.DecodeError:
        return None
    cv2 = _cv2()
    if cv2 is None:
        if fmt is not None:
            raise _no_codec(fmt, path)
        return None
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)


def imwrite(path: str, img: np.ndarray) -> bool:
    """cv2.imwrite(path, img) by the extension: PNG and BMP by the port's
    codecs, JPEG and WebP by cv2 (CodecUnavailable without it).  False
    when the file cannot be written."""
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext == ".png":
            png.write(path, img)
            return True
        if ext == ".bmp":
            bmp.write(path, img)
            return True
    except OSError:
        return False
    cv2 = _cv2()
    if cv2 is None:
        raise _no_codec(CV2_FORMATS.get(ext, ext or "this format"), path)
    return bool(cv2.imwrite(path, img))


def classify(img: np.ndarray) -> str:
    """imread result -> 'gray' | 'bgr' | 'bgra'."""
    if img.ndim == 2:
        return "gray"
    if img.ndim == 3 and img.shape[2] == 3:
        return "bgr"
    if img.ndim == 3 and img.shape[2] == 4:
        return "bgra"
    raise ValueError(f"unsupported image shape {img.shape}")


def to_u8(img: np.ndarray) -> Tuple[np.ndarray, bool]:
    """Reduce a decoded image to uint8; returns (u8 image, was_16bit)."""
    if img.dtype == np.uint8:
        return img, False
    if img.dtype == np.uint16:
        # round-to-nearest /257 (65535 -> 255 exactly)
        return ((img.astype(np.uint32) + 128) // 257).astype(np.uint8), True
    raise ValueError(f"unsupported image dtype {img.dtype}")


def _luma(bgr: np.ndarray) -> np.ndarray:
    """BGR u8 -> single-channel u8 (cv2 BGR2GRAY; import-free)."""
    b, g, r = (bgr[..., i].astype(np.float32) for i in range(3))
    return np.clip(np.rint(0.114 * b + 0.587 * g + 0.299 * r),
                   0, 255).astype(np.uint8)


def _through_model(engine, rgb: np.ndarray) -> np.ndarray:
    return engine.upscale_frames(np.ascontiguousarray(rgb)[None])[0]


def upscale_image_array(engine, img: np.ndarray,
                        note=None) -> Tuple[np.ndarray, bool]:
    """Upscale one decoded (imread, BGR byte order) image through
    `engine`, preserving its channel layout.

    Returns (output image in the INPUT's layout/byte order, was_16bit).
    `note(msg)` is called for user-facing degradation notes (16-bit
    reduction); defaults to stderr.
    """
    if note is None:
        note = lambda msg: print(msg, file=sys.stderr)  # noqa: E731
    img, was_16bit = to_u8(img)
    if was_16bit:
        note("note: 16-bit input reduced to 8-bit for the u8-native "
             "engine")
    mode = classify(img)
    if mode == "gray":
        rgb = np.repeat(img[:, :, None], 3, axis=2)
        out = _through_model(engine, rgb)
        return _luma(out[:, :, ::-1]), was_16bit
    if mode == "bgr":
        out = _through_model(engine, img[:, :, ::-1])
        return out[:, :, ::-1], was_16bit
    # bgra: color and alpha each through the model
    out_bgr = _through_model(engine, img[:, :, 2::-1])[:, :, ::-1]
    alpha3 = np.repeat(img[:, :, 3:4], 3, axis=2)
    out_alpha = _luma(_through_model(engine, alpha3)[:, :, ::-1])
    return np.dstack([out_bgr, out_alpha]), was_16bit


def to_output_depth(out: np.ndarray, was_16bit: bool) -> np.ndarray:
    """Widen an 8-bit result back to the input's bit depth for imwrite."""
    if was_16bit:
        return out.astype(np.uint16) * 257  # 255 -> 65535 exactly
    return out


def alpha_ok(output_path: str) -> bool:
    return output_path.lower().endswith(ALPHA_EXTS)


def upscale_image_file(engine, in_path: str, out_path: str,
                       img: Optional[np.ndarray] = None, note=None):
    """Decode -> engine -> encode one image file; the one shared per-file
    pipeline behind the CLI's single/dir modes and api.upscale_image.

    Returns (error_message_or_None, (width, height)_or_None).  Pass a
    pre-decoded `img` (imread) to skip the decode.  16-bit inputs are
    re-widened only for extensions that can carry 16 bits
    (SIXTEEN_BIT_EXTS); those outputs stay 8-bit with a note.
    Alpha-vs-extension must be validated by the caller (the modes report
    it differently).
    """
    if note is None:
        note = lambda msg: print(msg, file=sys.stderr)  # noqa: E731
    try:
        if img is None:
            img = imread(in_path)
        if img is None:
            return f"cannot decode image {in_path!r}", None
        out, was_16bit = upscale_image_array(engine, img, note=note)
    except ValueError as e:
        return str(e), None
    if was_16bit:
        if out_path.lower().endswith(SIXTEEN_BIT_EXTS):
            out = to_output_depth(out, True)
            note("note: output written as 16-bit")
        else:
            ext = os.path.splitext(out_path)[1]
            note(f"note: {ext} cannot carry 16-bit samples; output "
                 f"written as 8-bit (use .png to keep 16-bit)")
    try:
        written = imwrite(out_path, np.ascontiguousarray(out))
    except CodecUnavailable as e:
        return str(e), None
    if not written:
        return f"cannot write image {out_path!r}", None
    h, w = out.shape[:2]
    return None, (w, h)
