"""Video probing: frame count / rate / dimensions.

The reference shells out to `mediainfo --Output=Video;%FrameCount%` and
`%FrameRate%` (reve-shared/src/lib.rs:30-57).  Here probing is a backend
chain: the native core's exact y4m (FRAME-marker walk) and mkv (EBML
block walk) probes, ffprobe subprocess when the binary exists, else
OpenCV's demuxer — all normalized into one `VideoInfo`.
"""

from __future__ import annotations

import dataclasses
import fractions
import json
import shutil
import subprocess
from typing import Optional


@dataclasses.dataclass(frozen=True)
class VideoInfo:
    path: str
    width: int
    height: int
    frame_count: int
    fps: fractions.Fraction
    has_audio: bool = False

    @property
    def fps_float(self) -> float:
        return float(self.fps)


def _probe_ffprobe(path: str) -> Optional[VideoInfo]:
    """None (-> next backend in the chain) on ANY probe failure: ffprobe
    rejecting the file, no video stream, malformed/zero frame rate."""
    exe = shutil.which("ffprobe")
    if not exe:
        return None
    try:
        proc = subprocess.run(
            [exe, "-v", "error", "-show_streams", "-count_packets",
             "-of", "json", path],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            return None
        data = json.loads(proc.stdout)
        vstream = next(
            (s for s in data.get("streams", ())
             if s.get("codec_type") == "video"), None
        )
        if vstream is None:
            return None
        has_audio = any(
            s.get("codec_type") == "audio" for s in data["streams"]
        )
        # avg_frame_rate (frames/duration — what the reference's mediainfo
        # %FrameRate% reports) over r_frame_rate: the latter is the LCM of
        # frame timings and is 2x the playback rate on interlaced/
        # telecined streams, which would desync the encode from the
        # verbatim-remuxed audio
        num = den = 0
        for key in ("avg_frame_rate", "r_frame_rate"):
            try:
                num, den = (int(t) for t in vstream[key].split("/"))
            except (KeyError, ValueError):
                continue
            if num > 0 and den > 0:
                break
        if num <= 0 or den <= 0:
            return None
        frames = int(
            vstream.get("nb_frames") or vstream.get("nb_read_packets") or 0
        )
        if frames <= 0:
            # a 'successful' probe without a frame count would plan zero
            # segments; let the next backend count frames instead
            return None
        return VideoInfo(
            path=path,
            width=int(vstream["width"]),
            height=int(vstream["height"]),
            frame_count=frames,
            fps=fractions.Fraction(num, den),
            has_audio=has_audio,
        )
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return None


def _probe_cv2(path: str) -> Optional[VideoInfo]:
    try:
        import cv2
    except ImportError:
        return None
    import math

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return None
    try:
        fps = cap.get(cv2.CAP_PROP_FPS)
        width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()
    # cv2 reports 0 (or NaN fps) instead of failing on damaged headers —
    # treat that as 'cannot probe' so the chain's error names the real
    # problem instead of exploding later in planning/encoding
    if not math.isfinite(fps) or fps <= 0 or width <= 0 or height <= 0 \
            or frames <= 0:
        return None
    return VideoInfo(
        path=path,
        width=width,
        height=height,
        frame_count=frames,
        fps=fractions.Fraction(fps).limit_denominator(1001 * 120),
    )


def _probe_native_mkv(path: str) -> Optional[VideoInfo]:
    """Exact mkv probe via the native EBML walker.  FFmpeg-family probes
    ESTIMATE mkv frame counts from container duration x fps (Matroska has
    no frame-count header), which over-counts whenever audio outlives the
    video; the native walk counts actual video blocks."""
    try:
        from reve_tpu_torch import native

        if not native.available():
            return None
        info = native.probe_mkv(path)
    except Exception:
        return None
    if info["video_blocks"] <= 0 or info["width"] <= 0:
        return None
    # fps is not a Matroska header field; prefer the cv2 estimate, else
    # derive blocks/duration from the container itself; 30 only when the
    # file carries no duration at all (and say so — a wrong rate desyncs
    # the encode from the verbatim-remuxed audio)
    cv2_info = _probe_cv2(path)
    if cv2_info:
        fps = cv2_info.fps
    elif info.get("duration_s", 0) and info["duration_s"] > 0:
        fps = fractions.Fraction(
            info["video_blocks"] / info["duration_s"]
        ).limit_denominator(1001 * 120)
    else:
        import logging

        logging.getLogger(__name__).warning(
            "%s: no decodable rate source (cv2 cannot open, container has "
            "no duration); assuming 30 fps", path)
        fps = fractions.Fraction(30, 1)
    return VideoInfo(
        path=path,
        width=info["width"],
        height=info["height"],
        frame_count=int(info["video_blocks"]),
        fps=fps,
        has_audio=info["has_audio"],
    )


def _probe_y4m(path: str) -> VideoInfo:
    # prefer the native FRAME-marker walk: exact under FRAME parameter
    # strings and torn tail frames, where the Python reader's file-size
    # division assumes bare "FRAME\n" markers
    try:
        from reve_tpu_torch import native

        if native.available():
            info = native.probe_y4m(path)
            return VideoInfo(
                path=path,
                width=info["width"],
                height=info["height"],
                frame_count=info["frames"],
                fps=fractions.Fraction(info["fps_num"], info["fps_den"]),
            )
    except Exception:
        pass
    from reve_tpu_torch.io.reader import Y4MReader

    rd = Y4MReader(path)
    return VideoInfo(
        path=path,
        width=rd.width,
        height=rd.height,
        frame_count=rd.frame_count(),
        fps=fractions.Fraction(rd.fps[0], rd.fps[1]),
    )


def probe(path: str, backend: Optional[str] = None) -> VideoInfo:
    """Probe a video file. backend: None (auto) | 'ffprobe' | 'cv2' | 'y4m'."""
    if path.lower().endswith(".y4m") or backend == "y4m":
        return _probe_y4m(path)
    if path.lower().endswith(".mkv") and backend in (None, "cv2"):
        info = _probe_native_mkv(path)
        if info is not None:
            return info
    if backend in (None, "ffprobe"):
        info = _probe_ffprobe(path)
        if info is not None:
            return info
        if backend == "ffprobe":
            raise RuntimeError("ffprobe not available")
    info = _probe_cv2(path)
    if info is None:
        raise RuntimeError(f"cannot probe {path!r}: no working backend")
    return info
