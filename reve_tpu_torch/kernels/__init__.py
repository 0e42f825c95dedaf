"""Hand-written CUDA kernels of the SRVGG main path (sm_90a), each with
its plain PyTorch version and a launch counter.

    K1  conv3x3.conv3x3_bias_prelu            hidden conv 64->64 + PReLU
    K3  conv3x3.conv3x3_u8_bias_prelu         u8 input + first conv + PReLU
    K2  head.head_conv_residual_u8_shuffle    head conv + residual + u8 +
                                              pixel shuffle

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — there is no fallback.  `LAUNCHES` counts
kernel launches only (plain-version calls are not counted), so a run can
show that the main path went through the kernels.
"""

from __future__ import annotations

#: kernel name -> launches since the last reset_launches()
LAUNCHES = {
    "conv3x3_bias_prelu": 0,
    "conv3x3_u8_bias_prelu": 0,
    "head_conv_residual_u8_shuffle": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
