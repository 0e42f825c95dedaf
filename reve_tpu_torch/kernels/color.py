"""K9 `rgb_to_yuv420_u8`: the engine's u8 RGB output to YUV 4:2:0 codes
on the card (csrc/color.cu), and its plain version.

Replaces reve_tpu/ops/color.py::rgb_to_yuv420 (:142-150) applied to
u8 / 255, the conversion the reference runs on the device so that frames
leave it as planes.  The codes are byte for byte those of the plain
version (ops/color.py::rgb_u8_to_yuv420) and of the writers' host
conversion (ops/color_np.py::rgb_to_yuv420_np): every float step of the
kernel is one op rounded to nearest in the reference's order.

Bound at 4 frames of 7680 x 4320 (3.35 TB/s): 8-bit 398 MB read + 199 MB
written, 0.178 ms; 10-bit 398 + 398 MB, 0.238 ms.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import tempfile
from typing import List, Tuple

import torch

from reve_tpu_torch.kernels import LAUNCHES, build
from reve_tpu_torch.ops import color as color_ops
from reve_tpu_torch.ops.color_np import YUVFormat

SOURCE = "color.cu"
#: pixels of a row a thread of the vector form takes (csrc/color.cu)
VEC_PX = 16


def plane_shapes(b: int, h: int, w: int):
    """Shapes of the Y, U and V planes of a (b, h, w, 3) batch."""
    return (b, h, w), (b, h // 2, w // 2), (b, h // 2, w // 2)


def plane_bytes(h: int, w: int, bits: int) -> int:
    """Bytes of one (h, w) frame's three planes."""
    return (h * w + 2 * (h // 2) * (w // 2)) * (1 if bits == 8 else 2)


def constants(fmt: YUVFormat) -> List[float]:
    """K9's float32 constants for `fmt`, rounded from the reference's
    Python doubles as ops/color.py rounds them: kr, kg, kb, the chroma
    divisors, and each plane's code scale and offset."""
    kr, kg, kb = color_ops._coeffs(fmt.matrix)
    scale = 1 << (fmt.bits - 8)
    if fmt.full_range:
        maxv = float((1 << fmt.bits) - 1)
        codes = (maxv, 0.0, maxv, 128.0 * scale)
    else:
        codes = (219.0 * scale, 16.0 * scale, 224.0 * scale, 128.0 * scale)
    return [color_ops._f32(c) for c in (
        kr, kg, kb, 2.0 * (1.0 - kb), 2.0 * (1.0 - kr)) + codes]


def rgb_to_yuv420_u8_plain(x: torch.Tensor, fmt: YUVFormat):
    """K9's plain version: ops/color.py's rgb_u8_to_yuv420."""
    return color_ops.rgb_u8_to_yuv420(x, matrix=fmt.matrix,
                                      full_range=fmt.full_range,
                                      bits=fmt.bits)


def _check(x: torch.Tensor, fmt: YUVFormat) -> None:
    if fmt.bits not in (8, 10) or fmt.matrix not in ("bt601", "bt709"):
        raise ValueError(f"format {fmt}: bits 8 or 10, matrix bt601 or "
                         f"bt709")
    if x.dim() != 4 or x.shape[3] != 3 or x.dtype != torch.uint8:
        raise ValueError(f"input {tuple(x.shape)} {x.dtype}; expected "
                         f"(B, H, W, 3) uint8")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"yuv420 requires even dimensions, got "
                         f"{x.shape[2]}x{x.shape[1]}")


def rgb_to_yuv420_u8(x: torch.Tensor,
                     fmt: YUVFormat) -> Tuple[torch.Tensor, ...]:
    """K9: (B, H, W, 3) uint8 RGB -> (y, u, v) codes in `fmt`, y (B, H,
    W), u and v (B, H/2, W/2), uint8 at 8 bits and int16 holding the
    uint16 codes at 10 (ops/color.py's CODE_DTYPES), on x's device.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check(x, fmt)
    if x.device.type == "cpu":
        return rgb_to_yuv420_u8_plain(x, fmt)
    if x.device.type != "cuda":
        raise ValueError(f"tensor on {x.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain version)")
    if not x.is_contiguous():
        raise ValueError("K9 takes a contiguous (B, H, W, 3) input")
    b, h, w, _ = x.shape
    dt = color_ops.CODE_DTYPES[fmt.bits]
    planes = tuple(torch.empty(s, dtype=dt, device=x.device)
                   for s in plane_shapes(b, h, w))
    vec = w % VEC_PX == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x,) + planes)
    lib = build.load(SOURCE)
    fn = lib.reve_rgb_to_yuv420_u8
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
        [ctypes.c_float] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), *(t.data_ptr() for t in planes), b, h, w,
             fmt.bits, int(vec), *constants(fmt),
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "rgb_to_yuv420_u8")
    LAUNCHES["rgb_to_yuv420_u8"] += 1
    return planes


def _ops(text: str, op: str) -> int:
    return len(re.findall(rf"\b{op}\b", text))


def contraction_faults() -> List[str]:
    """What the built K9 library breaks of its exactness design, empty
    when nothing: its PTX holds no fma and no float mul or add without a
    rounding mode (the _rn ops, which nothing contracts), and its SASS
    holds as many FFMA as a build with -fmad=false (the FFMAs of the
    divisions' own expansion, and no contracted multiply-add).  Needs the
    CUDA toolkit."""
    faults = []
    nvcc = build.nvcc_path()
    src = os.path.join(build.CSRC, SOURCE)
    with tempfile.TemporaryDirectory() as tmp:
        ptx = os.path.join(tmp, "color.ptx")
        subprocess.run([nvcc, "-arch=compute_90a", "-std=c++17", "-O3",
                        "-ptx", "-o", ptx, src], check=True,
                       capture_output=True)
        text = open(ptx).read()
        cubin = os.path.join(tmp, "color.cubin")
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-fmad=false", "-cubin", "-o",
                        cubin, src], check=True, capture_output=True)
        tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        nofma = subprocess.run([tool, "-sass", cubin], check=True,
                               capture_output=True, text=True).stdout
    if re.search(r"\bfma\.[a-z.]*f32\b", text):
        faults.append(f"{SOURCE}: fma.f32 in its PTX")
    loose = re.findall(r"\b(?:mul|add|sub)\.f32\b", text)
    if loose:
        faults.append(f"{SOURCE}: {len(loose)} float mul/add/sub without a "
                      f"rounding mode in its PTX")
    built = "".join(build.sass(SOURCE).values())
    if _ops(built, "FFMA") != _ops(nofma, "FFMA"):
        faults.append(f"{SOURCE}: {_ops(built, 'FFMA')} FFMA in its SASS, "
                      f"{_ops(nofma, 'FFMA')} in a build with -fmad=false")
    return faults
