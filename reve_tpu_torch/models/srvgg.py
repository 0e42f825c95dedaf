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
first conv, K1 each hidden conv, K2 the head with its epilogue), at any
num_feat the kernels take on the card (kernels.conv3x3.WIDTHS: 32, 64,
96, 128); on CPU tensors each kernel wrapper runs its plain PyTorch
version (any width), and `plain=True` runs the plain versions on any
device (the reference path).  In float32 at 32, 96 and 128 features the
hidden layers pass the split planes of their output from K1 to K1 and
into K2 (conv3x3.conv3x3_bias_prelu_planes): one split pass a call,
after K3 (`body`, which the int8 calibration runs too).
`prepare` casts the weights to the compute dtype once, so the wide
kernels' packed weights are packed once too.  `apply_int8` is the int8
turbo path on K4a, K4 and K4h, at the same widths on the card (each
wrapper takes the width of its operands: the 64-feature kernels at 64,
the wide forms at 32, 96 and 128).  `apply_float` is the float32
forward that training differentiates, on T1 (and, under autograd, T2
and T3 in the backward).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from reve_tpu_torch.kernels import conv3x3, conv3x3_s8, head, train
from reve_tpu_torch.ops.pixel_shuffle import pixel_shuffle

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


def prepare(params: Params, dtype: torch.dtype) -> Params:
    """params with each conv's weights cast to the compute dtype once (the
    same tensors in float32): what `apply` casts them to at each call, so
    the wide kernels' packs (conv3x3.packed_wide, kept on the weights)
    are made once for every batch.  Biases and alphas stay float32."""
    return {
        "convs": [dict(c, w=c["w"].to(dtype).contiguous())
                  for c in params["convs"]],
        "prelus": params["prelus"],
    }


def carries_planes(num_feat: int, compute_dtype: torch.dtype) -> bool:
    """Whether the hidden layers pass the split planes of their output
    from K1 to K1 and into K2 (conv3x3.conv3x3_bias_prelu_planes): in
    float32 at the wide widths (32, 96, 128) on the card."""
    return compute_dtype == torch.float32 and num_feat != conv3x3.FEAT


def split_passes(cfg: SRVGGConfig, compute_dtype: torch.dtype) -> int:
    """The split passes (conv3x3.split_bf16x3) of one `apply` call on the
    card: none in bfloat16; in float32 one after K3 where the hidden layers
    carry planes, else one before each K1 and K2."""
    if compute_dtype != torch.float32:
        return 0
    return 1 if carries_planes(cfg.num_feat, compute_dtype) else \
        cfg.num_conv + 1


def body(params: Params, u8: torch.Tensor, *, cfg: SRVGGConfig,
         compute_dtype: torch.dtype, plain: bool = False,
         each=None) -> torch.Tensor:
    """The first conv (K3) on the u8 frames and the num_conv hidden convs
    (K1) -> the head's operand: the last layer's output, or, where the
    layers carry planes (carries_planes; not with `plain`), its split
    planes, after one split pass of K3's output.  `each`, if given, is
    called with K3's output and each hidden layer's, in the compute dtype
    (with planes, the float32 value the same kernel writes beside them).
    It holds no layer's output past the layer after it (the caller holds
    none): the float32 call's memory bill, engine.srvgg_act_bytes, counts
    on that."""
    dt = compute_dtype
    convs, prelus = params["convs"], params["prelus"]
    first = conv3x3.conv3x3_u8_bias_prelu_plain if plain else \
        conv3x3.conv3x3_u8_bias_prelu
    h = first(u8, convs[0]["w"].to(dt).contiguous(), convs[0]["b"],
              prelus[0]["alpha"])
    if each is not None:
        each(h)
    planes = not plain and carries_planes(cfg.num_feat, dt)
    if planes:
        h = conv3x3.split_bf16x3(h)
    hidden = conv3x3.conv3x3_bias_prelu_plain if plain else \
        conv3x3.conv3x3_bias_prelu
    for i in range(cfg.num_conv):
        args = (convs[i + 1]["w"].to(dt).contiguous(), convs[i + 1]["b"],
                prelus[i + 1]["alpha"])
        if not planes:
            h = value = hidden(h, *args)
        elif each is None:
            h = conv3x3.conv3x3_bias_prelu_planes(h, *args)
        else:
            h, value = conv3x3.conv3x3_bias_prelu_planes(h, *args,
                                                         value=True)
        if each is not None:
            each(value)
    return h


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
    last = head.head_conv_residual_u8_shuffle_plain if plain else \
        head.head_conv_residual_u8_shuffle
    h = body(params, u8, cfg=cfg, compute_dtype=dt, plain=plain)
    return last(h, convs[-1]["w"].to(dt), convs[-1]["b"], u8, cfg.upscale)


def apply_float(params: Params, x: torch.Tensor, *, cfg: SRVGGConfig,
                plain: bool = False) -> torch.Tensor:
    """float32 forward, (B, H, W, 3) in [0, 1] -> (B, H*r, W*r, 3) float32,
    not clipped: reve_tpu's `srvgg.apply(params, x, cfg=cfg,
    compute_dtype=float32)` (quantize_u8=False), the function its trainer
    differentiates.  The conv stack runs through kernels.train.conv_stack
    (differentiable in the params), then pixel_shuffle(h + repeat(x, r^2))
    in float32 as torch ops."""
    if x.dtype != torch.float32:
        raise TypeError(f"apply_float takes float32 input, got {x.dtype}")
    convs = params["convs"]
    if len(convs) != cfg.num_conv + 2:
        raise ValueError(f"params hold {len(convs)} convs; cfg needs "
                         f"{cfg.num_conv + 2}")
    r = cfg.upscale
    h = train.conv_stack(x, params, plain=plain)
    return pixel_shuffle(h + x.repeat_interleave(r * r, dim=-1), r)


def apply_int8(params: Params, qbody, u8: torch.Tensor, *, cfg: SRVGGConfig,
               compute_dtype: torch.dtype = torch.bfloat16,
               int8_head: bool = True, plain: bool = False) -> torch.Tensor:
    """int8 turbo forward, u8 -> u8: (B, H, W, 3) uint8 -> (B, H*r, W*r, 3)
    uint8.  Equals reve_tpu's `srvgg.apply_int8(params, qbody, u8 / 255,
    quantize_u8=True)` in its classic domain (its row space-to-depth form
    is exact):

      K4a  first conv + PReLU in the compute dtype (as `apply`), then
           _quant_s8(h, act_scale[0]);
      K4   per hidden layer: s8 conv, float32(y32) * (act_scale[i] *
           sw[i]) + b, PReLU in float32, _quant_s8(., act_scale[i + 1]);
      K4h  (int8_head) s8 head conv, float32(y32) * (act_scale[n] *
           sw_last) + b_last in float32, then the u8 residual epilogue.

    `int8_head=False` runs the head in the compute dtype instead: K2 on
    q * act_scale[n], both cast to the compute dtype (srvgg.py:387-390).
    `qbody`: weights.quantize.QuantizedBody on the frames' device.  Every
    scale the kernels take is formed here in torch exactly as the
    reference forms it: products sx[i] * sw[i] and reciprocals 1 / sx[i]
    in float32."""
    if u8.dtype != torch.uint8:
        raise TypeError(f"apply_int8 takes uint8 frames, got {u8.dtype}")
    dt = compute_dtype
    convs, prelus = params["convs"], params["prelus"]
    n = cfg.num_conv
    if len(qbody.w8) != n or tuple(qbody.act_scale.shape) != (n + 1,):
        raise ValueError(f"qbody holds {len(qbody.w8)} int8 convs / "
                         f"{tuple(qbody.act_scale.shape)} scales; cfg needs "
                         f"{n} / ({n + 1},)")
    if plain:
        first = conv3x3.conv3x3_u8_bias_prelu_q8_plain
        hidden = conv3x3_s8.conv3x3_s8_dq_prelu_q8_plain
        last8 = head.head_conv_s8_residual_u8_shuffle_plain
        last = head.head_conv_residual_u8_shuffle_plain
    else:
        first = conv3x3.conv3x3_u8_bias_prelu_q8
        hidden = conv3x3_s8.conv3x3_s8_dq_prelu_q8
        last8 = head.head_conv_s8_residual_u8_shuffle
        last = head.head_conv_residual_u8_shuffle
    sx = qbody.act_scale
    inv = 1.0 / sx  # float32 reciprocals, as `1.0 / scale` in _quant_s8
    # K4a's weights cast once per set of weights (an int8 engine keeps its
    # params in float32), so that the pack its wide forms take is made
    # once too (conv3x3.packed_u8conv)
    w0 = convs[0]["w"]
    if w0.dtype != dt:
        w0 = w0.to(dt) if plain else conv3x3.packed_once(
            w0, lambda w: w.to(dt), f"_reve_as_{str(dt)[6:]}")
    q = first(u8, w0, convs[0]["b"], prelus[0]["alpha"], inv[0:1])
    for i in range(n):
        q = hidden(q, qbody.w8[i], sx[i] * qbody.sw[i], qbody.b[i],
                   qbody.alpha[i], inv[i + 1:i + 2])
    if int8_head:
        return last8(q, qbody.w8_last, sx[n] * qbody.sw_last, qbody.b_last,
                     u8, cfg.upscale)
    hf = q.to(dt) * sx[n].to(dt)
    return last(hf, convs[-1]["w"].to(dt), convs[-1]["b"], u8, cfg.upscale)
