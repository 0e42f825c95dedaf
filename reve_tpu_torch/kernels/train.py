"""T1 `conv3x3_fwd_train`, T2 `conv3x3_dgrad` and T3 `conv3x3_wgrad`:
SRVGG's conv3x3 + PReLU for training, forward and backward, in float32
on the tensor cores (csrc/conv3x3_train_tc.cu), their plain versions,
and `conv_stack`, the autograd Function that runs a whole SRVGG conv
stack through them.

They replace what XLA runs for reve_tpu/train/trainer.py:53-72
(`jax.value_and_grad` of `srvgg.apply(..., compute_dtype=float32)`):
`_conv3x3` at Precision.HIGHEST with `_prelu` (reve_tpu/models/srvgg.py
:88-113) and the two convs autodiff derives from each.

    T1  z = conv3x3(x, W) + b, y = PReLU(z) with z written beside y (the
        head: no PReLU, y = z; the teacher's forward: y only)
    T2  dx = conv3x3^T(dz, W), then the previous layer's dz = dx *
        PReLU'(z) and d(alpha) = sum dx * min(z, 0), with JAX's
        PReLU'(0) = (1 + alpha) / 2 and d(alpha) 0 there
    T3  dW[ky, kx, ci, co] = sum_p x(p + k) dz(p), db = sum_p dz(p)

Layouts: NHWC float32 activations, HWIO float32 weights, at the channel
pairs of PAIRS: Cin 3, 64, 128 x Cout 48, 64, 128, and every SRVGG conv
at WIDTHS features (32, 64, 96, 128) and SCALES (x2, x3, x4) -- conv_first
(3, F), the hidden convs (F, F) and the head (F, 3 r^2), Cout 12, 27 or
48 (23 pairs); other pairs are refused.  The kernels read Cin and Cout
in 64-channel halo halves (the last of 32 or 96 features: 32 channels)
and units of one tap's 32 channels (16 at Cout 12); T1's N blocks are
`fwd_block`, T2's `dgrad_block`, T3's `wgrad_groups`.  A Cout-27 pixel is
108 B, only 4-B aligned: the kernels read and write it a float at a
time.

Bound on an H100 SXM per training step of a 64-feature, 16-conv student
on 8 LR patches of 64 x 64: a hidden conv is 2.416 GFLOP, 0.0147 ms as
six bf16 products on the tensor cores (989 TFLOP/s; 0.036 ms as float32
FMAs at 67 TFLOP/s), against about 25 MB of bytes -> 0.0075 ms, so all
three are bound by operations.  All three sum six bf16 products of
their operands split in three, float32 K1's scheme (the design is in
their source's head).  T3 sums its pixel splits, and T2 its tiles'
d(alpha), in a fixed order set by the shapes alone, so a step repeats
bit for bit.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
import re
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from reve_tpu_torch import device as device_mod
from reve_tpu_torch.kernels import LAUNCHES, build
from reve_tpu_torch.kernels.conv3x3 import check_operands, prelu_plain

#: T1, T2 and T3
SOURCE = "conv3x3_train_tc.cu"
#: the SRVGG widths (num_feat) and scales whose convs the kernels take
WIDTHS = (32, 64, 96, 128)
SCALES = (2, 3, 4)
#: the (Cin, Cout) pairs the kernels take (REVE_TRAIN_PAIRS in SOURCE)
PAIRS = tuple(sorted(
    {(ci, co) for ci in (3, 64, 128) for co in (48, 64, 128)}
    | {p for f in WIDTHS
       for p in [(3, f), (f, f)] + [(f, 3 * r * r) for r in SCALES]}))
#: the ROADMAP.md item that other channel counts wait on
WIDTHS_ITEM = "Training at other widths"
#: T1's, T2's and T3's tiles: rows x columns of pixels (T1, T2: a
#: block's output, a warpgroup a row; T3: a K chunk)
TILE = (2, 64)
#: T3's pixel splits are chosen to give about this many blocks (one per
#: SM of an H100's 132), from the shapes alone: the sum's order, and so
#: its bits, depend on nothing else
WGRAD_BLOCKS = 132


# -- plain versions ---------------------------------------------------------


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def prelu_grad_plain(dy: torch.Tensor, z: torch.Tensor,
                     alpha: torch.Tensor) -> torch.Tensor:
    """JAX's vjp of _prelu in z: dy above 0, alpha dy below, and at z = 0
    dy / 2 + (alpha dy) / 2 (lax.max and lax.min split a tie's gradient
    in halves)."""
    ady = alpha * dy
    return torch.where(z > 0, dy, torch.where(z < 0, ady,
                                              dy * 0.5 + ady * 0.5))


def conv3x3_fwd_train_plain(x, w, b, alpha=None, save_z: bool = True):
    """T1's function: (out, z).  z = SAME conv3x3(x, w) + b; with alpha,
    out = PReLU(z) and z is returned when `save_z`, else None; without
    alpha (the head) out = z and z is None."""
    device_mod.strict_f32()
    z = (F.conv2d(_nchw(x), _oihw(w), padding=1).permute(0, 2, 3, 1)
         + b).contiguous()
    if alpha is None:
        return z, None
    return prelu_plain(z, alpha).contiguous(), (z if save_z else None)


def conv3x3_dgrad_plain(dz, w, z_prev, alpha_prev):
    """T2's function: (dz_prev, dalpha_prev).  dx = the input gradient of
    the SAME conv3x3 with weights w given its output gradient dz, then
    the previous layer's PReLU: dz_prev = PReLU'(z_prev) dx and
    dalpha_prev = sum over pixels of dx * min(z_prev, 0)."""
    device_mod.strict_f32()
    B, H, W, _ = dz.shape
    dx = torch.nn.grad.conv2d_input((B, w.shape[2], H, W), _oihw(w),
                                    _nchw(dz), padding=1).permute(0, 2, 3, 1)
    return (prelu_grad_plain(dx, z_prev, alpha_prev).contiguous(),
            (dx * z_prev.clamp_max(0)).sum((0, 1, 2)))


def conv3x3_wgrad_plain(x, dz):
    """T3's function: (dw, db), the weight (HWIO) and bias gradients of
    the SAME conv3x3 of input x given its output gradient dz."""
    device_mod.strict_f32()
    cin, cout = x.shape[3], dz.shape[3]
    dw = torch.nn.grad.conv2d_weight(_nchw(x), (cout, cin, 3, 3), _nchw(dz),
                                     padding=1)
    return dw.permute(2, 3, 1, 0).contiguous(), dz.sum((0, 1, 2))


# -- the kernels --------------------------------------------------------------


def check_channels(cin: int, cout: int) -> None:
    if (cin, cout) not in PAIRS:
        raise ValueError(
            f"conv3x3 {cin} -> {cout} channels: the training kernels take "
            f"the (Cin, Cout) pairs {PAIRS}: SRVGG at {WIDTHS} features and "
            f"x{SCALES} (ROADMAP.md queue 1, '{WIDTHS_ITEM}')")


def fwd_block(cout: int) -> int:
    """T1's N of a block (its blocks: ceil(cout / it)): Cout 12 at wgmma's
    N 16 and 27 at 32 (the columns past Cout zero), 96 as two blocks of
    48, 128 as two of 64."""
    return {12: 16, 27: 32, 96: 48}.get(cout, min(cout, 64))


def dgrad_block(cin: int) -> int:
    """T2's N of a block over Cin: 3 at wgmma's N 8, 96 as two of 48, 128
    as two of 64."""
    return {3: 8, 96: 48}.get(cin, min(cin, 64))


def k_units(c: int) -> List[Tuple[int, int, int]]:
    """T1's K over Cin (not 3: its 27 im2col values are one unit) and
    T2's over Cout, in the order the kernels run it: (tap, first channel,
    channels) of each unit, halo half by halo half (channels 64 h .. 64 h
    + 63), each tap's 32-channel runs of the half (a run of 16 where c <=
    16: one k16 step)."""
    run = 16 if c <= 16 else 32
    return [(tap, c0, min(run, c - c0))
            for h0 in range(0, c, 64) for tap in range(9)
            for c0 in range(h0, min(h0 + 64, c), 32)]


def _check(cin: int, cout: int, *ts: torch.Tensor) -> None:
    """The operands of a launch for a conv `cin` -> `cout`: float32 CUDA
    tensors, contiguous and 16-byte aligned on one device."""
    if ts[0].device.type != "cuda":
        raise ValueError(f"tensor on {ts[0].device}: the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain version)")
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"the training kernels take float32, got "
                            f"{t.dtype}")
    check_channels(cin, cout)
    check_operands(*ts)


def _check_shapes(what: str, got, want) -> None:
    got = [tuple(t.shape) for t in got]
    if got != [tuple(s) for s in want]:
        raise ValueError(f"{what} operands {got}; expected {want}")


_entries: dict = {}


def _call(entry: str, device, ptrs, ints) -> None:
    if entry not in _entries:
        lib = build.load(SOURCE)
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * len(ptrs) + \
            [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[entry] = (lib, fn)
    lib, fn = _entries[entry]
    err = fn(*ptrs, *ints, torch.cuda.current_stream(device).cuda_stream)
    build.check(lib, err, entry)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def conv3x3_fwd_train(x, w, b, alpha=None, save_z: bool = True):
    """T1: conv3x3_fwd_train_plain's (out, z) from one kernel launch."""
    if x.device.type == "cpu":
        return conv3x3_fwd_train_plain(x, w, b, alpha, save_z)
    ts = (x, w, b) + (() if alpha is None else (alpha,))
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    _check_shapes("T1", ts, [(B, H, W, cin), (3, 3, cin, cout), (cout,),
                             (cout,)][:len(ts)])
    _check(cin, cout, *ts)
    out = torch.empty((B, H, W, cout), device=x.device)
    z = torch.empty_like(out) if alpha is not None and save_z else None
    _call("reve_conv3x3_fwd_train_tc", x.device,
          [x.data_ptr(), w.data_ptr(), b.data_ptr(), _ptr(alpha),
           out.data_ptr(), _ptr(z)], [B, H, W, cin, cout])
    LAUNCHES["conv3x3_fwd_train"] += 1
    return out, z


def conv3x3_dgrad(dz, w, z_prev, alpha_prev):
    """T2: conv3x3_dgrad_plain's (dz_prev, dalpha_prev) from one kernel
    launch (and the fixed-order sum of its tiles' d(alpha))."""
    if dz.device.type == "cpu":
        return conv3x3_dgrad_plain(dz, w, z_prev, alpha_prev)
    B, H, W, cout = dz.shape
    cin = z_prev.shape[-1]
    ts = (dz, w, z_prev, alpha_prev)
    _check_shapes("T2", ts, [(B, H, W, cout), (3, 3, cin, cout),
                             (B, H, W, cin), (cin,)])
    _check(cin, cout, *ts)
    if B * H * W == 0:
        raise ValueError("T2 over no pixels")
    dz_prev = torch.empty_like(z_prev)
    part = torch.empty((tiles(B, H, W), cin), device=dz.device)
    dalpha = torch.empty((cin,), device=dz.device)
    _call("reve_conv3x3_dgrad_tc", dz.device,
          [dz.data_ptr(), w.data_ptr(), z_prev.data_ptr(),
           alpha_prev.data_ptr(), dz_prev.data_ptr(), part.data_ptr(),
           dalpha.data_ptr()], [B, H, W, cin, cout])
    LAUNCHES["conv3x3_dgrad"] += 1
    return dz_prev, dalpha


def tiles(B: int, H: int, W: int) -> int:
    """The TILE-sized tiles over B images of H x W: T1's and T2's blocks
    of an N block (T2: its d(alpha) partial rows), and T3's K chunks,
    numbered with x fastest, then rows, then images."""
    return B * math.ceil(H / TILE[0]) * math.ceil(W / TILE[1])


def wgrad_groups(cin: int, cout: int) -> int:
    """T3's blocks of one split: each tap row times each 64-channel half of
    Cin (its three warpgroups the row's taps; the last half of 32 or 96:
    32 channels); at Cin 3 one (its 27 rows of dW one slab); each times
    the 64-channel N blocks of Cout (Cout 12 to 64 as one, 96 and 128 as
    two)."""
    return (1 if cin == 3 else 3 * math.ceil(cin / 64)) * math.ceil(
        cout / 64)


def wgrad_splits(B: int, H: int, W: int, cin: int,
                 cout: int) -> Tuple[int, int]:
    """(splits, tiles a split) of T3's sum over the tiles of B images of H
    x W: runs of consecutive tiles, about WGRAD_BLOCKS blocks in all,
    none empty."""
    n = tiles(B, H, W)
    want = max(1, WGRAD_BLOCKS // wgrad_groups(cin, cout))
    per = math.ceil(n / want)
    return math.ceil(n / per), per


def conv3x3_wgrad(x, dz):
    """T3: conv3x3_wgrad_plain's (dw, db) from one kernel launch (and the
    fixed-order sum of its splits)."""
    if x.device.type == "cpu":
        return conv3x3_wgrad_plain(x, dz)
    B, H, W, cin = x.shape
    cout = dz.shape[-1]
    _check_shapes("T3", (x, dz), [(B, H, W, cin), (B, H, W, cout)])
    _check(cin, cout, x, dz)
    if B * H * W == 0:
        raise ValueError("T3 over no pixels")
    splits, per = wgrad_splits(B, H, W, cin, cout)
    rows = 9 * cin + 1
    part = torch.empty((splits, rows, cout), device=x.device)
    dwb = torch.empty((rows, cout), device=x.device)
    _call("reve_conv3x3_wgrad_tc", x.device,
          [x.data_ptr(), dz.data_ptr(), part.data_ptr(), dwb.data_ptr()],
          [B, H, W, cin, cout, splits, per])
    LAUNCHES["conv3x3_wgrad"] += 1
    return dwb[:9 * cin].view(3, 3, cin, cout), dwb[9 * cin]


# -- the conv stack under autograd --------------------------------------------


#: the kernel templates of T1, T2 and T3, each of whose PAIRS must hold
#: wgmma (HGMMA)
SASS_FORMS = ("fwd_tc_kernel", "dgrad_tc_kernel", "wgrad_tc_kernel")


def sass_faults() -> List[str]:
    """What the built training library's SASS breaks of its design, empty
    when nothing: each SASS_FORMS kernel at each of the PAIRS holds HGMMA
    (so no CUDA-core form of T1, T2 or T3 is left), and the library holds
    no TF32 product and no float atomic (RED or ATOM on F32; every sum
    runs in a fixed order).  Needs the CUDA toolkit."""
    lib = build.sass(SOURCE)
    faults = []
    for form in SASS_FORMS:
        ks = {k: v for k, v in lib.items() if form in k}
        lacking = sorted(k for k, v in ks.items()
                         if not re.search(r"\bHGMMA\b", v))
        if len(ks) != len(PAIRS) or lacking:
            faults.append(f"{SOURCE}: {len(ks)} {form} kernels, HGMMA "
                          f"missing in {lacking}; expected HGMMA in each of "
                          f"{len(PAIRS)}")
    text = "".join(lib.values())
    if "TF32" in text or re.search(
            r"\b(?:RED|ATOMG?|ATOMS)\.[^\n]*\bF32\b", text):
        faults.append(f"{SOURCE}: a TF32 product or a float atomic in its "
                      f"SASS")
    return faults


def flat_params(params) -> List[torch.Tensor]:
    """SRVGG params -> [w0, b0, alpha0, ..., w_last, b_last]: each conv's
    weight and bias, then the PReLU after it (none after the head)."""
    convs, prelus = params["convs"], params["prelus"]
    if len(prelus) != len(convs) - 1:
        raise ValueError(f"{len(convs)} convs need {len(convs) - 1} "
                         f"PReLUs, got {len(prelus)}")
    out = []
    for i, c in enumerate(convs):
        out += [c["w"], c["b"]]
        if i < len(prelus):
            out.append(prelus[i]["alpha"])
    return out


def _forward(x, flat, plain: bool, save: bool):
    """The stack's head output, and (when `save`) each layer's input and z
    for the backward."""
    fwd = conv3x3_fwd_train_plain if plain else conv3x3_fwd_train
    n = (len(flat) + 1) // 3
    h, inputs, zs = x, [x], []
    for i in range(n - 1):
        h, z = fwd(h, flat[3 * i], flat[3 * i + 1], flat[3 * i + 2],
                   save_z=save)
        inputs.append(h)
        zs.append(z)
    out, _ = fwd(h, flat[-2], flat[-1])
    return out, inputs, zs


class _ConvStack(torch.autograd.Function):
    """The conv stack's forward on T1 (each layer's input and z saved),
    its backward on T2 and T3 from the head down."""

    @staticmethod
    def forward(ctx, x, plain, *flat):
        out, inputs, zs = _forward(x, flat, plain, save=True)
        ctx.plain = plain
        ctx.n = len(inputs)
        ctx.save_for_backward(*inputs, *zs, *flat)
        return out

    @staticmethod
    def backward(ctx, dout):
        n = ctx.n
        saved = ctx.saved_tensors
        inputs, zs, flat = saved[:n], saved[n:2 * n - 1], saved[2 * n - 1:]
        dgrad = conv3x3_dgrad_plain if ctx.plain else conv3x3_dgrad
        wgrad = conv3x3_wgrad_plain if ctx.plain else conv3x3_wgrad
        grads = [None] * len(flat)
        dz = dout.contiguous()
        for i in reversed(range(n)):
            grads[3 * i], grads[3 * i + 1] = wgrad(inputs[i], dz)
            if i > 0:
                dz, grads[3 * i - 1] = dgrad(dz, flat[3 * i], zs[i - 1],
                                             flat[3 * i - 1])
        return (None, None, *grads)


def conv_stack(x: torch.Tensor, params, plain: bool = False) -> torch.Tensor:
    """SRVGG's conv stack (first conv + PReLU, the hidden convs + PReLU,
    the head conv) on float32 NHWC `x`: the head's output (B, H, W, Cout),
    before the residual and the pixel shuffle.  Under autograd (grad mode
    on and a param that requires grad) it is the Function above; else the
    forward alone, which writes no z.  `plain=True` runs the plain
    versions wherever the tensors are.  No gradient flows to `x`."""
    flat = flat_params(params)
    if x.requires_grad:
        raise ValueError("conv_stack computes no gradient for its input")
    if torch.is_grad_enabled() and any(p.requires_grad for p in flat):
        return _ConvStack.apply(x, plain, *flat)
    return _forward(x, flat, plain, save=False)[0]
