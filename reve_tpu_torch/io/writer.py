"""Frame writers: encode RGB frames into video segment files.

Replaces the reference's encode stage (`ffmpeg -f image2 ... -c:v libx265
-pix_fmt yuv420p10le -crf -preset -x265-params`, reve-cli/src/main.rs:306-328)
with in-memory frame feeds:

  * FfmpegX265Writer — pipes rawvideo yuv420p10le into ffmpeg/libx265 with
    the reference's exact crf/preset/x265-params knobs (production path,
    gated on the ffmpeg binary existing).
  * Cv2Writer        — OpenCV VideoWriter (bundled FFmpeg). Codec negotiated
    from what the build supports (this image: mp4v / MJPG / FFV1 / VP9).
  * Y4MWriter        — uncompressed, for hermetic tests.

The ffmpeg and y4m writers encode YUV 4:2:0: `write_planes` takes the
codes as they are (the engine makes them on the device, K9), `write`
converts an RGB frame on the host first (color_np, the same codes).
`planes_format` names the format a path's writer takes, before it opens.
"""

from __future__ import annotations

import fractions
import logging
import os
import shutil
import subprocess
from typing import Optional, Sequence

import numpy as np

from reve_tpu_torch.io.probe import VideoInfo  # noqa: F401  (re-export convenience)
from reve_tpu_torch.ops import color_np
from reve_tpu_torch.ops.color_np import YUVFormat

log = logging.getLogger(__name__)


class FrameWriter:
    """Consume RGB uint8 (H, W, 3) frames into a video file."""

    #: the YUV 4:2:0 codes `write_planes` takes (None: RGB only)
    planes_format: Optional[YUVFormat] = None

    def write(self, frame: np.ndarray) -> None:
        raise NotImplementedError

    def write_planes(self, y: np.ndarray, u: np.ndarray,
                     v: np.ndarray) -> None:
        """One frame's 4:2:0 codes in `planes_format`: y (H, W), u and v
        (H/2, W/2), uint8 at 8 bits, uint16 at 10."""
        raise TypeError(f"{type(self).__name__} takes RGB frames only")

    def _write_rgb_as_planes(self, frame: np.ndarray) -> None:
        # host-side numpy conversion: the same codes as the device's K9
        # (the writer of an engine that makes planes never gets here)
        fmt = self.planes_format
        self.write_planes(*color_np.rgb_to_yuv420_np(
            frame, matrix=fmt.matrix, full_range=fmt.full_range,
            bits=fmt.bits))

    def describe(self) -> str:
        """Human-readable encoder identity for done-lines/job reports."""
        return type(self).__name__

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class EncodeSettings:
    """The reference's encode knob set (reve-shared/src/lib.rs:228-246)."""

    def __init__(self, crf: int = 15, preset: str = "slow",
                 x265_params: str = "psy-rd=2:aq-strength=1:deblock=0,0:bframes=8",
                 pix_fmt: str = "yuv420p10le"):
        self.crf = crf
        self.preset = preset
        self.x265_params = x265_params
        self.pix_fmt = pix_fmt


class FfmpegX265Writer(FrameWriter):
    """rawvideo yuv420p10le -> ffmpeg libx265, frame-exact, no temp files.

    Takes BT.709 limited-range 10-bit planes; uint8 RGB numpy input is
    converted to them host-side here.
    """

    planes_format = YUVFormat("bt709", False, 10)

    def __init__(self, path: str, width: int, height: int,
                 fps: fractions.Fraction, settings: EncodeSettings,
                 ffmpeg: Optional[str] = None):
        self.ffmpeg = ffmpeg or shutil.which("ffmpeg")
        if not self.ffmpeg:
            raise RuntimeError("ffmpeg binary not found")
        if width % 2 or height % 2:
            raise ValueError(
                f"yuv420 requires even dimensions, got {width}x{height}"
            )
        self.width, self.height = width, height
        cmd = [
            self.ffmpeg, "-v", "error", "-y",
            "-f", "rawvideo", "-pix_fmt", "yuv420p10le",
            "-s", f"{width}x{height}",
            "-r", f"{fps.numerator}/{fps.denominator}",
            "-i", "-",
            "-c:v", "libx265",
            "-pix_fmt", settings.pix_fmt,
            "-crf", str(settings.crf),
            "-preset", settings.preset,
            "-x265-params", settings.x265_params,
            path,
        ]
        # stderr captured to a file so a failed encode reports the real
        # diagnostic, not just an exit code (or an opaque BrokenPipeError
        # on the next write)
        import tempfile

        self._errf = tempfile.TemporaryFile()
        self._proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stderr=self._errf
        )

    def write_yuv420p10(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        """Write pre-converted 10-bit planes (uint16 little-endian)."""
        for plane in (y, u, v):
            self._proc.stdin.write(
                np.ascontiguousarray(plane, dtype="<u2").tobytes()
            )

    write_planes = write_yuv420p10

    def write(self, frame: np.ndarray) -> None:
        self._write_rgb_as_planes(frame)

    def describe(self) -> str:
        return "ffmpeg:libx265"

    def close(self):
        if self._proc.stdin and not self._proc.stdin.closed:
            try:
                self._proc.stdin.close()
            except OSError:
                # ffmpeg already died: the close() flush hits a broken
                # pipe — proceed to wait() and the stderr read so the
                # error below carries ffmpeg's actual diagnostic (the
                # whole point of capturing stderr)
                pass
        ret = self._proc.wait()
        try:
            self._errf.seek(0)
            err = self._errf.read().decode(errors="replace").strip()
        finally:
            self._errf.close()
        if ret != 0:
            raise RuntimeError(
                f"ffmpeg encoder exited with {ret}"
                + (f": {err[-1000:]}" if err else ""))


_warned_dropped_knobs = False


class Cv2Writer(FrameWriter):
    """OpenCV VideoWriter fallback (no ffmpeg binary needed).

    The cv2 API exposes no crf/preset/x265-params knobs, so this fallback
    CANNOT honor the encode settings the reference always applies
    (reve-shared/src/lib.rs:232-246) — when `settings` is passed, the drop
    is warned once per process instead of silent, and the chosen codec is
    surfaced via `describe()` into the CLI done-line / job report."""

    #: preference order; first that opens wins
    CODECS: Sequence[str] = ("avc1", "hev1", "vp09", "mp4v")

    def __init__(self, path: str, width: int, height: int,
                 fps: fractions.Fraction, codec: Optional[str] = None,
                 settings: Optional["EncodeSettings"] = None):
        import cv2

        self._cv2 = cv2
        self.width, self.height = width, height
        candidates = [codec] if codec else list(self.CODECS)
        self.writer = None
        for cc in candidates:
            w = cv2.VideoWriter(
                path, cv2.VideoWriter_fourcc(*cc), float(fps), (width, height)
            )
            if w.isOpened():
                self.writer = w
                self.codec = cc
                break
            w.release()
        if self.writer is None:
            raise RuntimeError(
                f"no usable cv2 codec among {candidates} for {path!r}"
            )
        global _warned_dropped_knobs
        if settings is not None and not _warned_dropped_knobs:
            _warned_dropped_knobs = True
            log.warning(
                "no ffmpeg binary: falling back to the cv2 encoder "
                "(codec %s, 8-bit) — crf=%s / preset=%s / x265-params are "
                "NOT applied on this path", self.codec, settings.crf,
                settings.preset)

    def describe(self) -> str:
        return f"cv2:{self.codec}"

    def write(self, frame: np.ndarray) -> None:
        self.writer.write(np.ascontiguousarray(frame[:, :, ::-1]))  # RGB->BGR

    def close(self):
        self.writer.release()


class Y4MWriter(FrameWriter):
    """Uncompressed YUV4MPEG2 writer — 420 chroma, 8-bit (C420) or 10-bit
    (C420p10, the bit depth of the reference's yuv420p10le encode,
    reve-cli/src/main.rs:317-318).  Hermetic-test backend AND the
    codec-free 10-bit output path."""

    def __init__(self, path: str, width: int, height: int,
                 fps: fractions.Fraction, bits: int = 8):
        if bits not in (8, 10):
            raise ValueError(f"bits must be 8 or 10, got {bits}")
        if width % 2 or height % 2:
            raise ValueError(
                f"yuv420 requires even dimensions, got {width}x{height} "
                "(2x2 chroma subsampling; ffmpeg/x265 reject this too)"
            )
        self.width, self.height = width, height
        self.bits = bits
        self.planes_format = _y4m_planes(bits)
        chroma = "C420" if bits == 8 else "C420p10"
        self._f = open(path, "wb")
        self._f.write(
            f"YUV4MPEG2 W{width} H{height} "
            f"F{fps.numerator}:{fps.denominator} Ip A1:1 {chroma}\n".encode()
        )

    def write(self, frame: np.ndarray) -> None:
        self._write_rgb_as_planes(frame)

    def write_planes(self, y: np.ndarray, u: np.ndarray,
                     v: np.ndarray) -> None:
        dtype = np.uint8 if self.bits == 8 else np.dtype("<u2")
        self._f.write(b"FRAME\n")
        for plane in (y, u, v):
            self._f.write(np.ascontiguousarray(plane, dtype=dtype).data)

    def describe(self) -> str:
        return f"y4m:{self.bits}bit"

    def close(self):
        self._f.close()


def writer_kind(path: str, backend: Optional[str] = None) -> str:
    """The writer open_writer opens for `path`: "y4m", "ffmpeg" or "cv2"
    (raises when the ffmpeg backend is asked for without its binary)."""
    if path.lower().endswith(".y4m") or backend == "y4m":
        return "y4m"
    if backend in (None, "ffmpeg") and shutil.which("ffmpeg"):
        return "ffmpeg"
    if backend == "ffmpeg":
        raise RuntimeError("ffmpeg backend requested but binary not found")
    return "cv2"


def _y4m_bits(settings: EncodeSettings) -> int:
    return 10 if "10" in settings.pix_fmt else 8


def _y4m_planes(bits: int) -> YUVFormat:
    """The y4m writer's codes: BT.601 limited range (the reference's
    y4m route) at its bit depth."""
    return YUVFormat("bt601", False, bits)


def planes_format(path: str, settings: Optional[EncodeSettings] = None,
                  backend: Optional[str] = None) -> Optional[YUVFormat]:
    """The `planes_format` of the writer open_writer opens for `path`:
    y4m BT.601 limited at the settings' bits, ffmpeg BT.709 limited
    10-bit, cv2 None (RGB)."""
    try:
        kind = writer_kind(path, backend)
    except RuntimeError:
        return None  # open_writer raises it where the writer opens
    if kind == "y4m":
        return _y4m_planes(_y4m_bits(settings or EncodeSettings()))
    if kind == "ffmpeg":
        return FfmpegX265Writer.planes_format
    return None


def open_writer(path: str, width: int, height: int, fps: fractions.Fraction,
                settings: Optional[EncodeSettings] = None,
                backend: Optional[str] = None) -> FrameWriter:
    """backend: None (auto: ffmpeg-x265 if available, else cv2) |
    'ffmpeg' | 'cv2' | 'y4m'."""
    settings = settings or EncodeSettings()
    kind = writer_kind(path, backend)
    if kind == "y4m":
        return Y4MWriter(path, width, height, fps,
                         bits=_y4m_bits(settings))
    if kind == "ffmpeg":
        return FfmpegX265Writer(path, width, height, fps, settings)
    # REVE_TPU_CV2_CODEC picks the fallback's fourcc explicitly: the
    # default preference lands on VP9 when H.264 is unavailable, which is
    # high-quality but slow at 4K (~2.5 s/frame + a ~25-frame lookahead
    # flushed inside close(), measured on the round-5 hardware run) —
    # mp4v trades quality for ~50x encode speed when that matters more
    codec = os.environ.get("REVE_TPU_CV2_CODEC") or None
    return Cv2Writer(path, width, height, fps, codec=codec,
                     settings=settings)
