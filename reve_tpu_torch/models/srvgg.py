"""SRVGGNetCompact — the Real-ESRGAN compact VGG-style net, in PyTorch.

Counterpart of reve_tpu/models/srvgg.py.  Architecture (upstream
Real-ESRGAN `SRVGGNetCompact`):

    conv3x3(in_ch -> num_feat), PReLU
    num_conv x [ conv3x3(num_feat -> num_feat), PReLU ]
    conv3x3(num_feat -> out_ch * scale^2)
    pixel_shuffle(scale)
    + nearest-neighbor-upsampled input (residual)

Layouts match reve_tpu so the two packages compute the same function on
the same numbers: NHWC activations, HWIO weights, uint8 frames at the
public boundary.  Only the classic domain is carried: reve_tpu's row
space-to-depth form is an MXU-width trick, and it is exact, so the port
is held against both of its modes.

`apply` runs u8 -> u8 through the three kernels of the main path (K3 the
first conv, K1 each hidden conv, K2 the head with its epilogue); on CPU
tensors each kernel wrapper runs its plain PyTorch version, and
`plain=True` runs the plain versions on any device (the reference path).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from reve_tpu_torch.kernels import conv3x3, head

#: floor for bf16-vs-f32 PSNR (dB, 8-bit scale) of the model's u8 output:
#: the repo's 50 dB quality gate (BASELINE.md).  tests/test_torch_srvgg.py
#: holds the JAX package's own bf16 path and the port's above it on the
#: shipped weights, and chip_smoke.py holds the port's bf16 main path on
#: the card above it.
BF16_PSNR_FLOOR_DB = 50.0


@dataclasses.dataclass(frozen=True)
class SRVGGConfig:
    """Static hyper-parameters of a SRVGGNetCompact variant.

    `realesr-animevideov3` is num_feat=64, num_conv=16 with upscale in
    {2, 3, 4}; `realesr-general-x4v3` is num_conv=32, upscale=4.
    """

    num_in_ch: int = 3
    num_out_ch: int = 3
    num_feat: int = 64
    num_conv: int = 16
    upscale: int = 2

    @property
    def num_body_convs(self) -> int:
        # first conv + num_conv hidden convs + last conv
        return self.num_conv + 2


Params = Dict[str, Any]


def init_params(cfg: SRVGGConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.float32) -> Params:
    """Deterministic uniform(+-1/sqrt(fan_in)) init, HWIO, from an explicit
    torch.Generator (seed 0 when none is given).  Not bit-equal to
    reve_tpu's jax.random init: tests carry weights across with
    params_from_jax instead."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    chans = (
        [(cfg.num_in_ch, cfg.num_feat)]
        + [(cfg.num_feat, cfg.num_feat)] * cfg.num_conv
        + [(cfg.num_feat, cfg.num_out_ch * cfg.upscale * cfg.upscale)]
    )
    params: Params = {"convs": [], "prelus": []}
    for cin, cout in chans:
        bound = 1.0 / math.sqrt(cin * 9)
        w = (torch.rand((3, 3, cin, cout), generator=generator,
                        dtype=dtype) * 2 - 1) * bound
        b = (torch.rand((cout,), generator=generator, dtype=dtype)
             * 2 - 1) * bound
        params["convs"].append({"w": w, "b": b})
    # one PReLU after every conv except the last
    for _ in range(cfg.num_conv + 1):
        params["prelus"].append({"alpha": torch.full((cfg.num_feat,), 0.25,
                                                     dtype=dtype)})
    return params


def params_from_jax(tree) -> Params:
    """reve_tpu's params pytree (HWIO `w`, `b`, `alpha`; numpy or jax
    arrays) -> the port's layout (the same HWIO layout as float32 torch
    tensors), so both packages compute the same function."""

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))

    return {
        "convs": [{"w": t(c["w"]), "b": t(c["b"])} for c in tree["convs"]],
        "prelus": [{"alpha": t(p["alpha"])} for p in tree["prelus"]],
    }


def params_to(params: Params, device) -> Params:
    return {
        "convs": [{k: v.to(device) for k, v in c.items()}
                  for c in params["convs"]],
        "prelus": [{k: v.to(device) for k, v in p.items()}
                   for p in params["prelus"]],
    }


def apply(params: Params, u8: torch.Tensor, *, cfg: SRVGGConfig,
          compute_dtype: torch.dtype = torch.float32,
          plain: bool = False) -> torch.Tensor:
    """Forward pass, u8 -> u8: (B, H, W, 3) uint8 -> (B, H*r, W*r, 3) uint8.

    Equals reve_tpu's `srvgg.apply(params, u8 / 255, quantize_u8=True)`
    as the engine runs it: weights cast to `compute_dtype`, float32
    accumulation, + bias in float32, cast, PReLU in the compute dtype; the
    head output is cast to the compute dtype before the float32 residual
    add on the float32 u8/255 input, and u8 = clip(y*255+0.5) truncated.

    `plain=True` runs the plain PyTorch version of every kernel (the
    reference path) wherever the tensors are."""
    if u8.dtype != torch.uint8:
        raise TypeError(f"apply takes uint8 frames, got {u8.dtype}")
    dt = compute_dtype
    convs, prelus = params["convs"], params["prelus"]
    if len(convs) != cfg.num_conv + 2 or len(prelus) != cfg.num_conv + 1:
        raise ValueError(f"params hold {len(convs)} convs / {len(prelus)} "
                         f"prelus; cfg needs {cfg.num_conv + 2} / "
                         f"{cfg.num_conv + 1}")
    if plain:
        first = conv3x3.conv3x3_u8_bias_prelu_plain
        hidden = conv3x3.conv3x3_bias_prelu_plain
        last = head.head_conv_residual_u8_shuffle_plain
    else:
        first = conv3x3.conv3x3_u8_bias_prelu
        hidden = conv3x3.conv3x3_bias_prelu
        last = head.head_conv_residual_u8_shuffle
    h = first(u8, convs[0]["w"].to(dt), convs[0]["b"], prelus[0]["alpha"])
    for i in range(cfg.num_conv):
        h = hidden(h, convs[i + 1]["w"].to(dt), convs[i + 1]["b"],
                   prelus[i + 1]["alpha"])
    return last(h, convs[-1]["w"].to(dt), convs[-1]["b"], u8, cfg.upscale)
