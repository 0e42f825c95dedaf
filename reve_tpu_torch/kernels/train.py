"""T1 `conv3x3_fwd_train`, T2 `conv3x3_dgrad` and T3 `conv3x3_wgrad`:
SRVGG's conv3x3 + PReLU for training, forward and backward, in float32
(csrc/conv3x3_train.cu), their plain versions, and `conv_stack`, the
autograd Function that runs a whole SRVGG conv stack through them.

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

Layouts: NHWC float32 activations, HWIO float32 weights, channels Cin in
{3, 64, 128} and Cout in {48, 64, 128} (conv_first's 3 inputs, x4's 48 =
3 * 4^2 head outputs, realesr-animevideov3's 64 features and the 128 of
the distillation script's default student); other counts are refused.

Bound on an H100 SXM per training step of a 64-feature, 16-conv student
on 8 LR patches of 64 x 64 (67 TFLOP/s float32 outside the tensor
cores): a hidden conv is 2.416 GFLOP -> 0.036 ms against about 25 MB of
bytes -> 0.0075 ms, so all three are bound by operations; the forward,
T2 and T3 each about 40.6 GFLOP a step, 1.82 ms of float32 FMAs in all.
Each kernel is a float32 implicit GEMM on the CUDA cores (the design is
in the source's head); T3 sums its pixel splits, and T2 its blocks'
d(alpha), in a fixed order, so a step repeats bit for bit.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from reve_tpu_torch import device as device_mod
from reve_tpu_torch.kernels import LAUNCHES, build
from reve_tpu_torch.kernels.conv3x3 import check_operands, prelu_plain

SOURCE = "conv3x3_train.cu"
CINS = (3, 64, 128)
COUTS = (48, 64, 128)
#: the ROADMAP.md item that other channel counts wait on
WIDTHS_ITEM = "Training at other widths"
#: T3's pixel splits are chosen to give about this many blocks (4 per SM
#: of an H100's 132), from the shapes alone: the sum's order, and so its
#: bits, depend on nothing else
WGRAD_BLOCKS = 528
_BM, _BN, _BK = 128, 64, 8


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
    if cin not in CINS or cout not in COUTS:
        raise ValueError(
            f"conv3x3 {cin} -> {cout} channels: the training kernels take "
            f"Cin in {CINS} and Cout in {COUTS} (ROADMAP.md queue 1, "
            f"'{WIDTHS_ITEM}')")


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


def _call(entry: str, device, ptrs, ints) -> None:
    lib = build.load(SOURCE)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + \
        [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
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
    _call("reve_conv3x3_fwd_train", x.device,
          [x.data_ptr(), w.data_ptr(), b.data_ptr(), _ptr(alpha),
           out.data_ptr(), _ptr(z)], [B, H, W, cin, cout])
    LAUNCHES["conv3x3_fwd_train"] += 1
    return out, z


def conv3x3_dgrad(dz, w, z_prev, alpha_prev):
    """T2: conv3x3_dgrad_plain's (dz_prev, dalpha_prev) from one kernel
    launch (and the fixed-order sum of its blocks' d(alpha))."""
    if dz.device.type == "cpu":
        return conv3x3_dgrad_plain(dz, w, z_prev, alpha_prev)
    B, H, W, cout = dz.shape
    cin = z_prev.shape[-1]
    ts = (dz, w, z_prev, alpha_prev)
    _check_shapes("T2", ts, [(B, H, W, cout), (3, 3, cin, cout),
                             (B, H, W, cin), (cin,)])
    _check(cin, cout, *ts)
    dz_prev = torch.empty_like(z_prev)
    part = torch.empty((math.ceil(B * H * W / _BM), cin), device=dz.device)
    dalpha = torch.empty((cin,), device=dz.device)
    _call("reve_conv3x3_dgrad", dz.device,
          [dz.data_ptr(), w.data_ptr(), z_prev.data_ptr(),
           alpha_prev.data_ptr(), dz_prev.data_ptr(), part.data_ptr(),
           dalpha.data_ptr()], [B, H, W, cin, cout])
    LAUNCHES["conv3x3_dgrad"] += 1
    return dz_prev, dalpha


def wgrad_splits(npix: int, cin: int, cout: int) -> Tuple[int, int]:
    """(splits, pixels a split) of T3's sum over `npix` pixels: about
    WGRAD_BLOCKS blocks, a multiple of the 8-pixel step a split."""
    tiles = math.ceil((9 * cin + 1) / _BM) * math.ceil(cout / _BN)
    want = math.ceil(WGRAD_BLOCKS / tiles)
    kc = _BK * math.ceil(npix / want / _BK)
    return math.ceil(npix / kc), kc


def conv3x3_wgrad(x, dz):
    """T3: conv3x3_wgrad_plain's (dw, db) from one kernel launch (and the
    fixed-order sum of its splits)."""
    if x.device.type == "cpu":
        return conv3x3_wgrad_plain(x, dz)
    B, H, W, cin = x.shape
    cout = dz.shape[-1]
    _check_shapes("T3", (x, dz), [(B, H, W, cin), (B, H, W, cout)])
    _check(cin, cout, x, dz)
    splits, kc = wgrad_splits(B * H * W, cin, cout)
    rows = 9 * cin + 1
    part = torch.empty((splits, rows, cout), device=x.device)
    dwb = torch.empty((rows, cout), device=x.device)
    _call("reve_conv3x3_wgrad", x.device,
          [x.data_ptr(), dz.data_ptr(), part.data_ptr(), dwb.data_ptr()],
          [B, H, W, cin, cout, splits, kc])
    LAUNCHES["conv3x3_wgrad"] += 1
    return dwb[:9 * cin].view(3, 3, cin, cout), dwb[9 * cin]


# -- the conv stack under autograd --------------------------------------------


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
