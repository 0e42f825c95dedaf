"""K1 `conv3x3_bias_prelu` and K3 `conv3x3_u8_bias_prelu` (csrc/conv3x3.cu).

K1 replaces the hidden layers of reve_tpu/models/srvgg.py:apply
(`_prelu(_conv3x3(h, w, b), alpha)`, srvgg.py:88-113, applied at
:205-210); K3 replaces the engine's u8 -> float32 * (1/255) -> compute
dtype cast (reve_tpu/pipeline/engine.py:645, srvgg.py:154) fused with the
first conv + PReLU (srvgg.py:203-204).  Both were one XLA-fused conv graph
on the TPU.

Bound per 1080p frame on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): K1
152.9 GFLOP -> 0.155 ms and 531 MB -> 0.158 ms (bf16); K3 7.2 GFLOP,
6 MB in + 265 MB out -> 0.08 ms.  The kernels are a first direct-conv
form on CUDA cores (see the .cu header); `bound_ms` in chip_smoke.py is
computed from each run's own shapes.

Rounding points follow the JAX reference exactly: weights in the compute
dtype, float32 accumulation, + bias in float32, cast to the compute
dtype, PReLU in the compute dtype with alpha cast to it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from reve_tpu_torch import device as device_mod
from reve_tpu_torch.kernels import LAUNCHES, build

SOURCE = "conv3x3.cu"
FEAT = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


# -- plain versions ---------------------------------------------------------


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """SAME conv3x3, NHWC x HWIO, float32 accumulation + b in float32,
    cast to x.dtype (reve_tpu srvgg._conv3x3)."""
    device_mod.strict_f32()
    y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                 w.permute(3, 2, 0, 1).float(), padding=1)
    return (y.permute(0, 2, 3, 1) + b.float()).to(x.dtype)


def prelu_plain(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """max(x, 0) + alpha * min(x, 0) in x.dtype (reve_tpu srvgg._prelu)."""
    a = alpha.to(x.dtype)
    return x.clamp_min(0) + a * x.clamp_max(0)


def u8_to_dtype_plain(u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32(u8) * float32(1/255), cast to the compute dtype."""
    return (u8.float() * (1.0 / 255.0)).to(dtype)


def conv3x3_bias_prelu_plain(x, w, b, alpha) -> torch.Tensor:
    return prelu_plain(conv3x3_plain(x, w, b), alpha).contiguous()


def conv3x3_u8_bias_prelu_plain(u8, w, b, alpha) -> torch.Tensor:
    return conv3x3_bias_prelu_plain(u8_to_dtype_plain(u8, w.dtype), w, b,
                                    alpha)


# -- kernel wrappers ----------------------------------------------------------


def _check(x: torch.Tensor, w: torch.Tensor, cin: int, in_dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"tensor on {x.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain version)")
    if w.dtype not in _DTYPE_CODE:
        raise TypeError(f"compute dtype {w.dtype} not supported "
                        f"(float32, bfloat16)")
    if x.dtype != in_dtype:
        raise TypeError(f"input dtype {x.dtype}, expected {in_dtype}")
    if x.dim() != 4 or x.shape[3] != cin:
        raise ValueError(f"input shape {tuple(x.shape)}, expected "
                         f"(B, H, W, {cin})")
    if tuple(w.shape) != (3, 3, cin, FEAT):
        raise ValueError(f"weight shape {tuple(w.shape)}, expected "
                         f"(3, 3, {cin}, {FEAT}) HWIO")
    check_operands(x, w)


def check_operands(*ts: torch.Tensor) -> None:
    """The kernels read their operands as 16-byte vectors of one device."""
    for t in ts:
        if t.device != ts[0].device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous, 16-byte "
                             "aligned and on one device")


def _launch(entry: str, x, w, b, alpha) -> torch.Tensor:
    B, H, W, _ = x.shape
    y = torch.empty((B, H, W, FEAT), dtype=w.dtype, device=x.device)
    bb = b.to(device=x.device, dtype=torch.float32).contiguous()
    # alpha as the compute dtype rounds it, widened for the kernel
    aa = alpha.to(x.device).to(w.dtype).float().contiguous()
    if bb.numel() != FEAT or aa.numel() != FEAT:
        raise ValueError(f"bias/alpha must have {FEAT} entries")
    lib = build.load(SOURCE)
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(x.data_ptr(), w.data_ptr(), bb.data_ptr(), aa.data_ptr(),
             y.data_ptr(), B, H, W, _DTYPE_CODE[w.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, entry)
    return y


def conv3x3_bias_prelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       alpha: torch.Tensor) -> torch.Tensor:
    """K1: (B, H, W, 64) x (3, 3, 64, 64) HWIO in the compute dtype ->
    PReLU(dtype(conv + b)) (B, H, W, 64) in the compute dtype."""
    if x.device.type == "cpu":
        return conv3x3_bias_prelu_plain(x, w, b, alpha)
    _check(x, w, FEAT, w.dtype)
    y = _launch("reve_conv3x3_bias_prelu", x, w, b, alpha)
    LAUNCHES["conv3x3_bias_prelu"] += 1
    return y


def conv3x3_u8_bias_prelu(u8: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          alpha: torch.Tensor) -> torch.Tensor:
    """K3: (B, H, W, 3) uint8 x (3, 3, 3, 64) HWIO in the compute dtype ->
    PReLU(dtype(conv(dtype(u8 / 255)) + b)) (B, H, W, 64)."""
    if u8.device.type == "cpu":
        return conv3x3_u8_bias_prelu_plain(u8, w, b, alpha)
    _check(u8, w, 3, torch.uint8)
    y = _launch("reve_conv3x3_u8_bias_prelu", u8, w, b, alpha)
    LAUNCHES["conv3x3_u8_bias_prelu"] += 1
    return y
