"""ctypes bindings to the port's native C++ container core.

A copy of reve_tpu/native.py over the port's own copy of its C++ sources
(reve_tpu_torch/_native/: the y4m, mp4 and Matroska probes and concats,
the segment planner, the frame ring and the counters), and one source of
the port's own, png.cpp (the PNG reader's Average and Paeth unfilter,
io/png.py).  It never loads the JAX package's library.

The library is built on first use with the C++ compiler directly (`g++`,
or $CXX; no `make`) into `_native/build/` (listed in .gitignore), named
by a hash of the sources, the header and the flags, so an edited source
rebuilds and an unchanged one loads at once.  Processes that start the
build together (test workers) take turns on a lock file, and the library
appears by an atomic rename, so no process loads a half-written one.
Callers degrade to their Python paths when the core is unavailable (no
compiler): the planner, the byte-copy y4m concat, the re-encode concat,
the PNG reader's per-pixel unfilter loop.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional

log = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "_native")
BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
#: byte copies of reve_tpu/_native/'s sources
SOURCES = ("mp4.cpp", "mkv.cpp", "y4m.cpp", "core.cpp")
#: the port's own sources, built into the same library
PORT_SOURCES = ("png.cpp",)
HEADERS = ("mp4_internal.h",)
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
#: seconds a build may take
BUILD_TIMEOUT_S = 300
_lock = threading.Lock()
_lib = None
_build_failed = False
#: {"seconds": float, "cached": bool, "path": str} of the last load
build_info: dict = {}


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + PORT_SOURCES + HEADERS:
        with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(CXXFLAGS).encode())
    return h.hexdigest()[:16]


def lib_path() -> str:
    return os.path.join(BUILD_DIR, f"libreve_core-{_digest()}.so")


def _compiler() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++") or \
        shutil.which("c++")


def _build(path: str) -> bool:
    """Build the library at `path` unless another process has (holding the
    build lock meanwhile); False, with a warning, when it cannot."""
    cxx = _compiler()
    if cxx is None:
        log.warning("native core build failed: no C++ compiler (g++, c++ "
                    "or $CXX)")
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            # built by a process that held the lock before us
            build_info.update(seconds=0.0, cached=True)
            return True
        tmp = f"{path}.tmp{os.getpid()}"
        t0 = time.perf_counter()
        try:
            subprocess.run(
                [cxx, *CXXFLAGS, "-o", tmp,
                 *(os.path.join(_NATIVE_DIR, s)
                   for s in SOURCES + PORT_SOURCES)],
                check=True, capture_output=True, text=True,
                timeout=BUILD_TIMEOUT_S)
            os.replace(tmp, path)
        except (subprocess.SubprocessError, OSError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            log.warning("native core build failed: %s", detail)
            return False
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        build_info.update(seconds=time.perf_counter() - t0, cached=False)
        return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.rc_last_error.restype = ctypes.c_char_p
    lib.rc_concat_mp4.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.rc_probe_mp4.argtypes = [ctypes.c_char_p] + [
        ctypes.POINTER(t) for t in (
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        )
    ]
    lib.rc_concat_y4m.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_char_p,
    ]
    lib.rc_probe_y4m.argtypes = [ctypes.c_char_p] + [
        ctypes.POINTER(ctypes.c_long)
    ] * 5
    lib.rc_concat_mkv.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.rc_probe_mkv.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.rc_plan_segments.restype = ctypes.c_long
    lib.rc_plan_segments.argtypes = [
        ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.c_long,
    ]
    lib.rc_ring_create.restype = ctypes.c_void_p
    lib.rc_ring_create.argtypes = [ctypes.c_long, ctypes.c_long]
    lib.rc_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.rc_ring_close.argtypes = [ctypes.c_void_p]
    lib.rc_ring_push.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long
    ]
    lib.rc_ring_pop.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long
    ]
    lib.rc_ring_size.restype = ctypes.c_long
    lib.rc_ring_size.argtypes = [ctypes.c_void_p]
    lib.rc_counters_create.restype = ctypes.c_void_p
    lib.rc_counters_create.argtypes = [ctypes.c_long]
    lib.rc_counters_destroy.argtypes = [ctypes.c_void_p]
    lib.rc_counter_add.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long]
    lib.rc_counter_get.restype = ctypes.c_long
    lib.rc_counter_get.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.rc_png_unfilter_row.restype = ctypes.c_int
    lib.rc_png_unfilter_row.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_long,
    ]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native core; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = lib_path()
        if not os.path.exists(path):
            if not _build(path):
                _build_failed = True
                return None
        else:
            build_info.update(seconds=0.0, cached=True)
        build_info["path"] = path
        try:
            _lib = _bind(ctypes.CDLL(path))
        except OSError as e:
            log.warning("cannot load native core: %s", e)
            _build_failed = True
            return None
        return _lib


def available() -> bool:
    return load() is not None


class NativeError(RuntimeError):
    pass


def _check(lib, ret: int):
    if ret != 0:
        raise NativeError(lib.rc_last_error().decode())


def concat_mp4(parts: List[str], original: Optional[str],
               out_path: str) -> None:
    """Sample-copy concat of mp4 parts + remux of the original's non-video
    tracks (audio/subtitles) and udta (chapters).  Native-only capability."""
    lib = load()
    if lib is None:
        raise NativeError("native core unavailable")
    arr = (ctypes.c_char_p * len(parts))(
        *[p.encode() for p in parts]
    )
    _check(lib, lib.rc_concat_mp4(
        arr, len(parts),
        original.encode() if original else None,
        out_path.encode(),
    ))


def concat_mkv(parts: List[str], original: Optional[str],
               out_path: str) -> None:
    """Mux mp4 video parts into a Matroska file without re-encoding,
    remuxing audio/subtitles/chapters from the original (.mkv tracks are
    copied verbatim; .mp4 audio is remuxed with a codec map).  This closes
    the reference's mkv concat flow (reve-shared/src/lib.rs:181-204)
    natively.  Native-only capability."""
    lib = load()
    if lib is None:
        raise NativeError("native core unavailable")
    arr = (ctypes.c_char_p * len(parts))(*[p.encode() for p in parts])
    _check(lib, lib.rc_concat_mkv(
        arr, len(parts),
        original.encode() if original else None,
        out_path.encode(),
    ))


def concat_y4m(parts: List[str], out_path: str) -> None:
    """Byte-exact stream-copy concat of y4m parts (no YUV->RGB round trip
    — the reference's `-c copy` semantics, reve-shared/src/lib.rs:181-204,
    for the codec-free y4m path).  Native-only capability."""
    lib = load()
    if lib is None:
        raise NativeError("native core unavailable")
    arr = (ctypes.c_char_p * len(parts))(*[p.encode() for p in parts])
    _check(lib, lib.rc_concat_y4m(arr, len(parts), out_path.encode()))


def probe_y4m(path: str) -> dict:
    """Exact y4m probe: geometry, fps, and a FRAME-marker-walked frame
    count (robust to FRAME parameter strings and torn tail frames)."""
    lib = load()
    if lib is None:
        raise NativeError("native core unavailable")
    w, h, fn, fd, fr = (ctypes.c_long() for _ in range(5))
    _check(lib, lib.rc_probe_y4m(
        path.encode(), ctypes.byref(w), ctypes.byref(h),
        ctypes.byref(fn), ctypes.byref(fd), ctypes.byref(fr),
    ))
    return {
        "width": w.value, "height": h.value,
        "fps_num": fn.value, "fps_den": fd.value, "frames": fr.value,
    }


def probe_mkv(path: str) -> dict:
    """Structural probe of a Matroska file (native EBML walk)."""
    lib = load()
    if lib is None:
        raise NativeError("native core unavailable")
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    blocks = ctypes.c_int64()
    dur = ctypes.c_double()
    ntracks = ctypes.c_int32()
    has_audio = ctypes.c_int32()
    _check(lib, lib.rc_probe_mkv(
        path.encode(), ctypes.byref(w), ctypes.byref(h),
        ctypes.byref(blocks), ctypes.byref(dur),
        ctypes.byref(ntracks), ctypes.byref(has_audio),
    ))
    return {
        "width": w.value, "height": h.value,
        "video_blocks": blocks.value, "duration_s": dur.value,
        "n_tracks": ntracks.value, "has_audio": bool(has_audio.value),
    }


def probe_mp4(path: str) -> dict:
    lib = load()
    if lib is None:
        raise NativeError("native core unavailable")
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    samples = ctypes.c_int64()
    ts = ctypes.c_int64()
    dur = ctypes.c_int64()
    ntracks = ctypes.c_int32()
    has_audio = ctypes.c_int32()
    _check(lib, lib.rc_probe_mp4(
        path.encode(), ctypes.byref(w), ctypes.byref(h),
        ctypes.byref(samples), ctypes.byref(ts), ctypes.byref(dur),
        ctypes.byref(ntracks), ctypes.byref(has_audio),
    ))
    return {
        "width": w.value, "height": h.value,
        "video_samples": samples.value, "timescale": ts.value,
        "duration": dur.value, "n_tracks": ntracks.value,
        "has_audio": bool(has_audio.value),
    }


def plan_segments(frames: int, segsize: int):
    """Native planner (parity-tested against pipeline/planner.py)."""
    lib = load()
    if lib is None:
        raise NativeError("native core unavailable")
    cap = (frames + segsize - 1) // segsize + 1
    starts = (ctypes.c_long * cap)()
    sizes = (ctypes.c_long * cap)()
    n = lib.rc_plan_segments(frames, segsize, starts, sizes, cap)
    if n < 0:
        raise NativeError("rc_plan_segments failed")
    return [(starts[i], sizes[i]) for i in range(n)]


class FrameRing:
    """Bounded SPSC frame queue backed by native shared memory."""

    def __init__(self, frame_bytes: int, capacity: int):
        self._lib = load()
        if self._lib is None:
            raise NativeError("native core unavailable")
        if frame_bytes <= 0 or capacity <= 0:
            # capacity 0 would make push() block forever (the ring can
            # never accept a frame); a negative value wraps to a huge
            # size_t allocation that terminates across the C boundary
            raise ValueError(f"frame_bytes and capacity must be positive, "
                             f"got {frame_bytes}, {capacity}")
        self.frame_bytes = frame_bytes
        self._ring = self._lib.rc_ring_create(frame_bytes, capacity)

    def push(self, frame_u8, timeout_ms: int = -1) -> int:
        import numpy as np

        frame = np.ascontiguousarray(frame_u8, dtype=np.uint8)
        # memory-safety precondition, NOT a debug assert (python -O must
        # not disable it): the native side memcpys frame_bytes from the
        # buffer unconditionally
        if frame.nbytes != self.frame_bytes:
            raise ValueError(f"frame is {frame.nbytes} bytes; ring expects "
                             f"{self.frame_bytes}")
        ptr = frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        return self._lib.rc_ring_push(self._ring, ptr, timeout_ms)

    def pop(self, out_u8, timeout_ms: int = -1) -> int:
        # same guard as push: the native side memcpys frame_bytes into the
        # buffer unconditionally — an undersized/non-contiguous target
        # would corrupt the heap, not raise (and python -O strips asserts,
        # so these are real raises)
        if not out_u8.flags["C_CONTIGUOUS"] or \
                out_u8.nbytes != self.frame_bytes:
            raise ValueError(
                f"pop target must be C-contiguous and exactly "
                f"{self.frame_bytes} bytes, got {out_u8.nbytes}")
        ptr = out_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        return self._lib.rc_ring_pop(self._ring, ptr, timeout_ms)

    def close(self):
        self._lib.rc_ring_close(self._ring)

    def __len__(self):
        return self._lib.rc_ring_size(self._ring)

    def __del__(self):
        if getattr(self, "_ring", None):
            self._lib.rc_ring_destroy(self._ring)
            self._ring = None
