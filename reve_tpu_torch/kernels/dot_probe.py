"""P1 `dot_loop` (csrc/dot_probe.cu): the tensor-core dot-rate probe.

Replaces the Pallas kernel of scripts/perf_pallas_int8.py:54-75
(`main.run.kernel`): `loops` dots x @ w_half, where w_half alternates
between the two K-halves of w with the loop index, summed into one
accumulator, in s8 -> s32 and in bf16 -> f32.  It answers the question the
TPU probe answered for the MXU: how fast this card issues s8 dots next to
bf16 ones.  It is not on a model path; `python -m
reve_tpu_torch.scripts.perf_int8_dot` drives it.

The kernel runs on wgmma (m64n64, A from registers).  It splits the loop
over `LANES` warpgroups (two in the CTA of each 64 x 64 output tile):
lane l sums the dots i = l, l + LANES, ... in order, and the tile is the
lanes' sums added in lane order, so in bf16 the float32 sum is sum(even
dots) + sum(odd dots); s8 is exact.

Bound at the probe's shape (x (4224, 256), w (512, 128), 64 loops) on an
H100 SXM: 17.7 GOP per call -> 0.009 ms at 1979 TOP/s (s8 dense), 0.018 ms
at 989 TFLOP/s (bf16 dense).
"""

from __future__ import annotations

import ctypes

import torch

from reve_tpu_torch import device as device_mod
from reve_tpu_torch.kernels import LAUNCHES, build
from reve_tpu_torch.kernels.conv3x3 import check_operands

SOURCE = "dot_probe.cu"
_DTYPE_CODE = {torch.int8: 0, torch.bfloat16: 1}
#: M and N in multiples of the kernel's tile edge, K in multiples of its
#: k step (32 bytes) per dtype
_TILE, _KSTEP = 64, {torch.int8: 32, torch.bfloat16: 16}
#: K of one half: the A fragments of K / KSTEP k steps sit in registers
_MAX_K = 256
#: the warpgroups the kernel splits the loop over (WGS in
#: csrc/dot_probe.cu)
LANES = 2


def dot_loop_plain(x: torch.Tensor, w: torch.Tensor,
                   loops: int) -> torch.Tensor:
    """sum_{i < loops} x @ w[(i % 2) K : (i % 2 + 1) K]; s8: exact in
    float64, returned as int32; bf16: each dot in float32 (TF32 off), added
    to a float32 accumulator, as the Pallas kernel adds them."""
    k = w.shape[0] // 2
    halves = (w[:k], w[k:])
    if x.dtype == torch.int8:
        acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float64,
                          device=x.device)
        for i in range(loops):
            acc += x.double() @ halves[i % 2].double()
        return acc.round().to(torch.int32)
    device_mod.strict_f32()
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for i in range(loops):
        acc += x.float() @ halves[i % 2].float()
    return acc


def check_shapes(x: torch.Tensor, w: torch.Tensor, loops: int) -> None:
    """Raise ValueError unless the kernel takes these shapes: x (M, K) and
    w (2K, N), M and N positive multiples of 64, K at most 256 and a
    positive multiple of the dtype's k step (32 for s8, 16 for bf16),
    loops >= 0.  Reads only shapes and dtypes (any device)."""
    step = _KSTEP.get(x.dtype, 0)
    M, K = x.shape
    N = w.shape[1]
    if not step or w.shape[0] != 2 * K or M <= 0 or M % _TILE or N <= 0 \
            or N % _TILE or K <= 0 or K > _MAX_K or K % step or loops < 0:
        raise ValueError(
            f"dot_loop shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"loops {loops}: need w (2K, N), M and N positive multiples of "
            f"{_TILE}, K <= {_MAX_K} a positive multiple of the k step "
            f"(32 for int8, 16 for bfloat16), loops >= 0")


def dot_loop(x: torch.Tensor, w: torch.Tensor, loops: int) -> torch.Tensor:
    """P1: x (M, K) and w (2K, N), both int8 or both bfloat16 -> (M, N)
    int32 or float32, at the shapes `check_shapes` takes."""
    if x.device.type == "cpu":
        return dot_loop_plain(x, w, loops)
    if x.device.type != "cuda":
        raise ValueError(f"tensor on {x.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain version)")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"dot_loop takes int8 or bfloat16 for both "
                        f"operands, got {x.dtype} / {w.dtype}")
    check_shapes(x, w, loops)
    check_operands(x, w)
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), device=x.device,
                      dtype=torch.int32 if x.dtype == torch.int8
                      else torch.float32)
    lib = build.load(SOURCE)
    fn = lib.reve_dot_loop
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, loops,
             _DTYPE_CODE[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "dot_loop")
    LAUNCHES["dot_loop"] += 1
    return out
