"""Segment concatenation + audio/subtitle/chapter remux.

Mirrors the reference's finalization step (reve-shared/src/lib.rs:173-206):
write a concat list, stream-copy the video parts, and remux audio/subtitles/
chapters from the ORIGINAL input so A/V metadata survives upscaling.

Backends (preference order), as reve_tpu/io/concat.py's:
  * native_concat — the port's in-process C++ core (native.py): y4m
    stream copy, ISO-BMFF sample-copy concat of the mp4 parts + verbatim
    copy (with patched chunk offsets) of the original's audio/subtitle
    tracks and udta (chapters), or a Matroska mux of the mp4 parts.
    Zero re-encode, zero external binaries.
  * y4m_concat — byte-exact stream copy of y4m parts in Python (y4m
    carries no audio, so nothing is remuxed), where the core is
    unavailable.
  * ffmpeg_concat — the reference-equivalent argv (`-f concat ... -map 0:v
    -map 1:a? -map 1:s? -map_chapters 1 -c copy`); zero re-encode.
  * rewrite_concat — decode each part and re-encode into one file via the
    writer stack (last resort; audio is not carried).
"""

from __future__ import annotations

import fractions
import logging
import os
import shutil
import subprocess
import tempfile
from typing import List, Optional

from reve_tpu_torch.io import reader as reader_mod
from reve_tpu_torch.io import writer as writer_mod


log = logging.getLogger(__name__)


def ffmpeg_concat(parts: List[str], original: str, output: str,
                  ffmpeg: Optional[str] = None) -> None:
    exe = ffmpeg or shutil.which("ffmpeg")
    if not exe:
        raise RuntimeError("ffmpeg binary not found")
    with tempfile.NamedTemporaryFile(
        "w", suffix=".txt", dir=os.path.dirname(os.path.abspath(output)) or ".",
        delete=False,
    ) as f:
        for p in parts:
            # the concat demuxer's quoted-string syntax: ' closes the
            # string, so embedded quotes are written as '\'' (close,
            # escaped quote, reopen)
            quoted = os.path.abspath(p).replace("'", "'\\''")
            f.write(f"file '{quoted}'\n")
        list_path = f.name
    try:
        subprocess.run(
            [
                exe, "-v", "error", "-y",
                "-f", "concat", "-safe", "0", "-i", list_path,
                "-i", original,
                "-map", "0:v", "-map", "1:a?", "-map", "1:s?",
                "-map_chapters", "1", "-c", "copy",
                output,
            ],
            check=True,
        )
    finally:
        os.unlink(list_path)


def rewrite_concat(parts: List[str], output: str,
                   fps: fractions.Fraction,
                   backend: Optional[str] = None) -> None:
    """Decode each part sequentially and re-encode into one output file."""
    writer = None
    try:
        for part in parts:
            with reader_mod.open_reader(part, backend=backend) as rd:
                for frame in rd.read_range(0, 10 ** 9):
                    if writer is None:
                        h, w = frame.shape[:2]
                        writer = writer_mod.open_writer(
                            output, w, h, fps, backend=backend
                        )
                    writer.write(frame)
    finally:
        if writer is not None:
            writer.close()


def y4m_concat(parts: List[str], output: str) -> None:
    """Byte-exact y4m concat: the first part's stream header, then the
    FRAME records of every part.  Parts written by one job share one
    header; a mismatch is refused rather than glued into a corrupt file."""
    header = None
    with open(output, "wb") as out:
        for part in parts:
            with open(part, "rb") as f:
                h = f.readline()
                if header is None:
                    header = h
                    out.write(h)
                elif h != header:
                    raise ValueError(
                        f"y4m part {part!r} header {h!r} differs from "
                        f"{header!r}")
                shutil.copyfileobj(f, out, 1 << 20)


def native_concat(parts: List[str], original: str, output: str) -> bool:
    """Attempt the in-process C++ remux path; returns False if unusable.

    .y4m output: byte-exact stream copy of y4m parts (y4m.cpp).
    .mp4 output: ISO-BMFF sample-copy concat (mp4.cpp); the original's
    audio/subs/chapters are remuxed when it is an mp4.
    .mkv output: Matroska mux of the mp4 parts (mkv.cpp); the original's
    non-video tracks are copied verbatim from an mkv original, or remuxed
    with a codec map from an mp4 original — the reference's
    `ffmpeg -f concat ... -c copy out.mkv` equivalence
    (reve-shared/src/lib.rs:181-204)."""
    from reve_tpu_torch import native

    if not native.available():
        return False
    if output.lower().endswith(".y4m"):
        # byte-exact stream copy (y4m carries no audio to remux)
        if not all(p.lower().endswith(".y4m") for p in parts):
            return False
        native.concat_y4m(parts, output)
        return True
    if not all(p.lower().endswith(".mp4") for p in parts):
        return False
    if output.lower().endswith(".mkv"):
        orig = original if (
            original and os.path.exists(original)
            and original.lower().endswith((".mp4", ".mkv"))
        ) else None
        native.concat_mkv(parts, orig, output)
        return True
    if not output.lower().endswith(".mp4"):
        return False
    orig = original if (original and os.path.exists(original)
                        and original.lower().endswith(".mp4")) else None
    native.concat_mp4(parts, orig, output)
    return True


def concatenate(parts: List[str], original: str, output: str,
                fps: fractions.Fraction,
                backend: Optional[str] = None) -> dict:
    """Concat parts into `output`; remux A/V metadata when possible.

    Returns a report dict: {'backend': ..., 'audio_copied': bool}.
    """
    y4m = output.lower().endswith(".y4m") and \
        all(p.lower().endswith(".y4m") for p in parts)
    if backend in (None, "native", "cv2", "y4m"):
        try:
            if native_concat(parts, original, output):
                if output.lower().endswith(".y4m"):  # no audio in y4m
                    return {"backend": "native", "audio_copied": False}
                ok_exts = (".mp4", ".mkv") \
                    if output.lower().endswith(".mkv") else (".mp4",)
                has_orig = bool(original) and os.path.exists(original) \
                    and original.lower().endswith(ok_exts)
                return {"backend": "native", "audio_copied": has_orig}
        except Exception as e:
            if backend == "native":
                raise
            # without ffmpeg the chain ends in a full re-encode that DROPS
            # the original's audio — degrading silently would hide why
            if y4m:
                log.warning("native concat failed (%s); falling back to "
                            "the Python y4m stream copy", e)
            elif shutil.which("ffmpeg"):
                log.warning("native concat failed (%s); falling back to "
                            "ffmpeg stream-copy", e)
            else:
                log.warning(
                    "native concat failed (%s); falling back to a frame "
                    "rewrite, which re-encodes and cannot carry the "
                    "original's audio", e)
    if backend == "native":
        raise RuntimeError("native concat backend unusable for these files")
    if y4m:
        y4m_concat(parts, output)
        return {"backend": "y4m", "audio_copied": False}
    if backend in (None, "ffmpeg") and shutil.which("ffmpeg"):
        ffmpeg_concat(parts, original, output)
        return {"backend": "ffmpeg", "audio_copied": True}
    if backend == "ffmpeg":
        raise RuntimeError("ffmpeg backend requested but binary not found")
    rewrite_concat(parts, output, fps, backend=backend)
    return {"backend": backend or "cv2", "audio_copied": False}
