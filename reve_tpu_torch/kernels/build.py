"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source is compiled by `nvcc` for sm_90a into its own
shared library with a plain C interface, loaded with ctypes.  The build
goes into `reve_tpu_torch/kernels/build/` on first use, keyed by a hash
of the source, the shared headers and the flags, so an edited source
rebuilds and an unchanged one loads in milliseconds.  All sources are
compiled at once (one `nvcc` process each, started together).

Nothing here runs at import time: this module imports on a machine with
no `nvcc` and no GPU, and only `load()` needs them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
#: one shared library per source
SOURCES = ("conv3x3.cu", "conv3x3_tc.cu", "conv3x3_f32_tc.cu",
           "conv3x3_s8.cu", "dot_probe.cu", "tta.cu", "rrdb.cu",
           "rrdb_s8.cu", "conv_last_f32.cu", "conv3x3_train_tc.cu",
           "color.cu")
HEADERS = ("common.cuh", "tc.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: {source: {"seconds": float, "cached": bool, "log": str, "path": str}} of
#: the last load
build_info: Dict[str, dict] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    exe = shutil.which("nvcc")
    if exe is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the CUDA "
            "kernels of reve_tpu_torch are built on first use and need the "
            "CUDA toolkit")
    return exe


def _digest(source: str) -> str:
    h = hashlib.sha256()
    for name in (source,) + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(source: str) -> str:
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{_digest(source)}.so")


def _compile_all(sources: List[str]) -> None:
    """Start one nvcc per missing library, all at once; wait for all."""
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for src in sources:
        out = _lib_path(src)
        # unique temp name, then an atomic rename: a concurrent build
        # never loads a half-written library
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs.append((src, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        build_info[src] = {"seconds": time.perf_counter() - t0,
                           "cached": False, "log": log, "path": out}
        if proc.returncode != 0:
            failed.append(f"{src}: nvcc exited {proc.returncode}\n{log}")
            if os.path.exists(tmp):
                os.unlink(tmp)
            continue
        with open(out + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load(source: str) -> ctypes.CDLL:
    """The loaded library for `source` (building every missing library on
    the first call)."""
    with _lock:
        if source in _libs:
            return _libs[source]
        missing = [s for s in SOURCES if not os.path.exists(_lib_path(s))]
        if missing:
            _compile_all(missing)
        for s in SOURCES:
            if s not in build_info:
                log_path = _lib_path(s) + ".log"
                log = open(log_path).read() if os.path.exists(log_path) \
                    else ""
                build_info[s] = {"seconds": 0.0, "cached": True, "log": log,
                                 "path": _lib_path(s)}
            if s not in _libs:
                _libs[s] = ctypes.CDLL(_lib_path(s))
        return _libs[source]


def load_all() -> Dict[str, dict]:
    """Build (if needed) and load every kernel library; returns
    build_info."""
    for s in SOURCES:
        load(s)
    return build_info


def sass(source: str) -> Dict[str, str]:
    """Each kernel's SASS in `source`'s library, by mangled name
    (cuobjdump of the CUDA toolkit whose nvcc built it; builds the
    library first if needed)."""
    load(source)
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", _lib_path(source)], check=True,
                          capture_output=True, text=True).stdout
    return {part.split()[0]: part
            for part in re.split(r"\n\s*Function : ", text)[1:]}


def spills(source: str) -> Dict[str, int]:
    """Spill bytes (stores and loads) of each kernel in `source`'s
    library, by mangled name, from ptxas's report of its last build ({}
    when the report holds none)."""
    load(source)
    return {m.group(1): int(m.group(2)) + int(m.group(3))
            for m in re.finditer(
                r"Function properties for (\S+)\n\s*\d+ bytes stack frame, "
                r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                build_info[source]["log"])}


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch (the C entry
    points return cudaGetLastError() right after the launch)."""
    if err:
        fn = lib.reve_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({fn(err).decode()})")
