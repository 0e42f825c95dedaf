"""K6 `tta_accumulate`, the TTA inverse-dihedral accumulate
(csrc/tta.cu), the forward transforms of the ensemble, and their plain
versions.

Replaces reve_tpu/pipeline/engine.py::_tta_acc_device (:189-201) and
::_tta_mean_device (:204-209): the model output y of the forward
transform (k, flip) -- rot90 by k on the spatial axes, then a flip of the
width axis (`forward_transform`, engine.py:175-179) -- is flipped back,
rotated by -k, widened and added to a 16-bit accumulator in the frame's
own orientation.  The 8 terms of `SPECS` sum to at most 2040, so the sum
is exact, and the mean (acc + 4) >> 3 is the reference's round-half-up
integer mean.  Because the 8 transforms are a group, the ensemble is
exactly dihedral-equivariant.

The accumulator is int16: torch has no uint16 arithmetic on the CPU, and
every value it can hold (0..2040) has the same bits in both types.

Three forms, so that one batch is 8 launches and the mean never makes a
pass of its own: FIRST writes acc = term without reading acc, MIDDLE adds,
LAST writes the u8 mean of acc + term into `out` without writing acc.
Bound at 4 frames of 1080p x4 (398.1 M values, 3.35 TB/s): FIRST 3 B a
value (0.356 ms), MIDDLE 5 B (0.594), LAST 4 B (0.475); one batch 37 B a
value, 4.40 ms.  Design: csrc/tta.cu stages each 32 x 32-pixel tile of y
through shared memory so that y, acc and out are read and written in
consecutive bytes for every (k, flip).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from reve_tpu_torch.kernels import LAUNCHES, build

SOURCE = "tta.cu"
#: the 8 dihedral transforms of the self-ensemble as (rot90 quarter-turns,
#: horizontal flip), in the reference's order (engine.py:172)
SPECS: Tuple[Tuple[int, bool], ...] = tuple(
    (k, f) for k in range(4) for f in (False, True))
FIRST, MIDDLE, LAST = 0, 1, 2
ACC_DTYPE = torch.int16


def forward_transform(x: torch.Tensor, k: int, flip: bool) -> torch.Tensor:
    """(B, H, W, C) -> rot90(x, k) on (H, W), then flipped along W,
    contiguous (reve_tpu engine._tta_fwd)."""
    t = torch.rot90(x, k, (1, 2))
    if flip:
        t = t.flip(2)
    return t.contiguous()


def inverse_term_plain(y: torch.Tensor, k: int, flip: bool) -> torch.Tensor:
    """The term y contributes: flip undone, then rot90 by -k
    (reve_tpu engine._tta_inv), in y's dtype."""
    return torch.rot90(torch.flip(y, [2]) if flip else y, -k, (1, 2))


def tta_accumulate_plain(y: torch.Tensor, acc: torch.Tensor, k: int,
                         flip: bool, form: int,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6's plain version; writes what the kernel writes and returns it:
    FIRST acc[...] = term, MIDDLE acc += term, LAST out[...] = u8((acc +
    term + 4) >> 3)."""
    term = inverse_term_plain(y, k, flip).to(ACC_DTYPE)
    if form == FIRST:
        return acc.copy_(term)
    if form == MIDDLE:
        return acc.add_(term)
    return out.copy_(((acc + term + 4) >> 3).to(torch.uint8))


def _check(y, acc, k, flip, form, out) -> None:
    if form not in (FIRST, MIDDLE, LAST):
        raise ValueError(f"form {form}; expected FIRST, MIDDLE or LAST")
    if (k, bool(flip)) not in SPECS:
        raise ValueError(f"transform (k={k}, flip={flip}) is not one of "
                         f"the 8 dihedral transforms")
    if acc.dim() != 4 or acc.shape[3] != 3 or acc.dtype != ACC_DTYPE:
        raise ValueError(f"accumulator {tuple(acc.shape)} {acc.dtype}; "
                         f"expected (B, H, W, 3) {ACC_DTYPE}")
    b, ho, wo, _ = acc.shape
    want = (b, wo, ho, 3) if k & 1 else (b, ho, wo, 3)
    if y.dtype != torch.uint8 or tuple(y.shape) != want:
        raise ValueError(f"model output {tuple(y.shape)} {y.dtype}; "
                         f"expected {want} uint8 for k={k}")
    if form == LAST and (out is None or out.dtype != torch.uint8
                         or out.shape != acc.shape):
        raise ValueError(f"LAST writes the mean into `out`: (B, H, W, 3) "
                         f"uint8 like the accumulator {tuple(acc.shape)}")


def tta_accumulate(y: torch.Tensor, acc: torch.Tensor, k: int, flip: bool,
                   form: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6: add the inverse-transformed model output y of transform (k,
    flip) to acc ((B, H, W, 3) int16, written in place), in `form`; LAST
    writes the u8 mean into `out` ((B, H, W, 3) uint8) instead.  Returns
    the tensor written.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    _check(y, acc, k, flip, form, out)
    if y.device.type == "cpu":
        return tta_accumulate_plain(y, acc, k, flip, form, out)
    if y.device.type != "cuda":
        raise ValueError(f"tensor on {y.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain version)")
    for t in (y, acc) + ((out,) if form == LAST else ()):
        # byte and 16-bit accesses: any batch slice of a contiguous
        # tensor will do
        if t.device != y.device or not t.is_contiguous():
            raise ValueError("K6 operands must be contiguous and on one "
                             "device")
    b, ho, wo, _ = acc.shape
    lib = build.load(SOURCE)
    fn = lib.reve_tta_accumulate
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(y.data_ptr(), acc.data_ptr(),
             out.data_ptr() if form == LAST else None, b, ho, wo, k,
             int(bool(flip)), form,
             torch.cuda.current_stream(y.device).cuda_stream)
    build.check(lib, err, "tta_accumulate")
    LAUNCHES["tta_accumulate"] += 1
    return out if form == LAST else acc
