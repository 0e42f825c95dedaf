"""Device and dtype resolution for the port's entry points.

Entry points (`UpscaleEngine`, `cli.run`, `python -m reve_tpu_torch`) run
on `cuda:0` unless the caller names a device.  With no CUDA device and no
device requested they raise: a job never drifts onto the CPU, where the
kernels' plain versions would run it orders of magnitude slower.  The CPU
is used only when asked for (`device="cpu"`), as the tests do.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, int, str, torch.device]


class NoCudaDeviceError(RuntimeError):
    """No CUDA device exists and the caller did not ask for another one."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> cuda:0 (raises NoCudaDeviceError without CUDA); an int N ->
    cuda:N; a string or torch.device is taken as given.  A named CUDA
    device that does not exist raises too."""
    if device is None:
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                "no CUDA device is available; reve_tpu_torch runs on the "
                "GPU by default — pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda", 0)
    if isinstance(device, int):
        device = torch.device("cuda", device)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(f"{dev} requested but CUDA is not "
                                    f"available")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise NoCudaDeviceError(
                f"{dev} requested but this host has "
                f"{torch.cuda.device_count()} CUDA device(s)")
        dev = torch.device("cuda", index)
    return dev


_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    # off the TPU, reve_tpu's --dtype auto is bf16 without certification
    # (reve_tpu/pipeline/scheduler.py resolve_auto_dtype)
    "auto": torch.bfloat16,
}


def resolve_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """Float compute-dtype name -> torch dtype (float32 | bfloat16; auto
    -> bfloat16).  "int8" is not a float dtype: the engine takes it as the
    int8 turbo path, whose float parts run in bfloat16."""
    if isinstance(name, torch.dtype):
        if name not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported compute dtype {name}")
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown compute dtype {name!r}; known: "
                         f"{sorted(_DTYPES)}, and int8 for "
                         f"UpscaleEngine") from None


def strict_f32() -> None:
    """Full-precision float32 for every plain reference: cuDNN convs and
    cuBLAS matmuls otherwise run float32 in TF32 (~3 decimal digits),
    where the JAX reference runs Precision.HIGHEST."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
