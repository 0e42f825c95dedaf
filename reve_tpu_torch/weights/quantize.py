"""Post-training int8 quantization of the SRVGG body and the RRDB trunk
(the int8 turbo).

Counterpart of reve_tpu/weights/quantize.py.  The scheme is the
reference's, to the bit:

  * weights: per-output-channel symmetric int8,
    ``w8[..., o] = clip(round(w[..., o] / sw[o]), -127, 127)`` with
    ``sw[o] = max(max|w[..., o]|, 1e-12) / 127`` (a division, as JAX does
    it, not a multiply by 1/127);
  * activations: one symmetric scale per hidden-conv input and for the
    head conv's input, ``act_scale = max(maxima * margin, 1e-8) / 127`` in
    float32, from |activation| statistics of a calibration forward
    (`collect_act_maxima`): the max, or a percentile of a strided
    subsample (`_stat`).

Given the same maxima, quantization is float32 elementwise math and comes
out identical to the reference's, so a calibration persisted by either
package (Workspace.claim_calibration) quantizes the same way in both.  The
maxima themselves agree to float32 accumulation order (about 1e-6
relative): the calibration forward runs K3/K1 (RRDB: K3/K7) in float32 on
CUDA and their plain versions on the CPU.

RRDB (quantize_rrdb): every dense conv reads a concat of parts with their
own ranges (the dense block's input and the growth slices), so each part
keeps its own activation scale, folded into its weight slice before the
per-output-channel weight quantization (`w' = w * s_part(ci)`); its
dequant is then `float32(y32) * sw + b`, with no activation scale.  Its
statistics (collect_act_maxima_rrdb): per block, per dense block, the
block's input and h1..h4, then conv_body's input: num_block * 15 + 1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from reve_tpu_torch.models import rrdb, srvgg

#: percentile statistics of tensors above this many elements are taken on
#: a deterministic strided subsample of ~this many (reve_tpu's cap); it
#: also keeps torch.quantile under its 2^24-element input limit
_PCT_SAMPLE_CAP = 1 << 22


@dataclasses.dataclass
class QuantizedBody:
    """int8 hidden-stack + head-conv parameters (classic domain), as torch
    tensors on one device."""

    w8: List[torch.Tensor]       # num_conv x (3, 3, C, C) int8
    sw: List[torch.Tensor]       # num_conv x (C,) f32 per-out-channel
    b: List[torch.Tensor]        # num_conv x (C,) f32
    alpha: List[torch.Tensor]    # num_conv x (C,) f32 (PReLU)
    act_scale: torch.Tensor      # (num_conv + 1,) f32: input scale per
    #                              hidden conv + the head conv's input
    w8_last: torch.Tensor        # (3, 3, C, out*r^2) int8 head conv
    sw_last: torch.Tensor        # (out*r^2,) f32
    b_last: torch.Tensor         # (out*r^2,) f32


def qbody_from_jax(qb) -> QuantizedBody:
    """reve_tpu's QuantizedBody (jax or numpy arrays) -> the port's, the
    same numbers as torch tensors on the CPU."""

    def t(a):
        return torch.from_numpy(np.array(a, copy=True))

    return QuantizedBody(
        w8=[t(a) for a in qb.w8], sw=[t(a) for a in qb.sw],
        b=[t(a) for a in qb.b], alpha=[t(a) for a in qb.alpha],
        act_scale=t(qb.act_scale), w8_last=t(qb.w8_last),
        sw_last=t(qb.sw_last), b_last=t(qb.b_last))


def _stat(h: torch.Tensor, percentile: Optional[float]) -> torch.Tensor:
    """max|h|, or the `percentile` of |h| (linear interpolation) over the
    reference's strided subsample: every (n // 2^22)-th element."""
    a = h.float().abs()
    if percentile is None:
        return a.max()
    flat = a.reshape(-1)
    stride = max(1, flat.shape[0] // _PCT_SAMPLE_CAP)
    # q as jnp.percentile forms it: float32(percentile) / 100 in float32
    # (a double q would move the interpolation rank by up to ~n * 6e-8)
    q = torch.tensor(percentile, dtype=torch.float32,
                     device=a.device) / 100.0
    return torch.quantile(flat[::stride], q, interpolation="linear")


def collect_act_maxima(params: Dict[str, Any], u8: torch.Tensor, *,
                       cfg: srvgg.SRVGGConfig,
                       percentile: Optional[float] = None,
                       plain: bool = False) -> torch.Tensor:
    """Calibration forward in float32 over (B, H, W, 3) uint8 frames:
    (num_conv + 1,) |activation| statistics, one for the input of each
    hidden conv and one for the head conv's input (reve_tpu
    collect_act_maxima, classic domain).  The float32 forward runs K3 and
    K1 (their plain versions on the CPU, or with `plain=True`) through
    srvgg.body, as srvgg.apply does: at the wide widths K1
    carries the split planes and writes its float32 output beside them."""
    maxima = []
    srvgg.body(params, u8, cfg=cfg, compute_dtype=torch.float32,
               plain=plain, each=lambda v: maxima.append(_stat(v, percentile)))
    return torch.stack(maxima)


def rrdb_num_stats(cfg: rrdb.RRDBConfig) -> int:
    return cfg.num_block * 15 + 1


def collect_act_maxima_rrdb(params: Dict[str, Any], u8: torch.Tensor, *,
                            cfg: rrdb.RRDBConfig,
                            percentile: Optional[float] = None,
                            plain: bool = False) -> torch.Tensor:
    """Calibration forward in float32 over the RRDB trunk of (B, H, W, 3)
    uint8 frames: (num_block * 15 + 1,) |activation| statistics in
    reve_tpu's layout (per block, per dense block: its input, h1..h4;
    then conv_body's input).  The forward is rrdb.apply's trunk in
    float32: K3 for conv_first (x2: K3 at Cin 12), K7 for the dense
    convs (their plain
    versions on the CPU, or with `plain=True`); `params` float32, or
    rrdb.prepare(params, torch.float32) (K7's weights packed once).

    Each statistic is taken over the tensor the reference holds, (B, H,
    W, C) of that part alone: a channel slice of the 192-channel dense
    buffer, made contiguous, so the percentile's strided subsample reads
    the reference's elements."""
    nf = cfg.num_feat
    stats = []

    def observe(buf, lo, hi):
        stats.append(_stat(buf[..., lo:hi].contiguous(), percentile))

    feat = rrdb.conv_first(params, u8, cfg=cfg, compute_dtype=torch.float32,
                           plain=plain)
    a, _planes = rrdb.dense_trunk(params, feat, cfg=cfg,
                                  compute_dtype=torch.float32, plain=plain,
                                  observe=observe)
    observe(a, 0, nf)
    return torch.stack(stats)


def _qw(w: torch.Tensor):
    w = w.float()
    s = torch.amax(w.abs(), dim=(0, 1, 2)).clamp_min(1e-12) / 127.0
    return torch.round(w / s).clamp_(-127, 127).to(torch.int8), s


def quantize_hidden(params: Dict[str, Any], cfg: srvgg.SRVGGConfig,
                    act_maxima, margin: float = 1.0) -> QuantizedBody:
    """int8 hidden-stack + head params from float32 params + calibration
    maxima ((num_conv + 1,), e.g. from `collect_act_maxima`), on the
    params' device.  `margin` (>= 1) widens the activation ranges."""
    act_scale = _act_scale(act_maxima, cfg.num_conv + 1, margin,
                           params["convs"][0]["w"].device)
    w8, sw, b, alpha = [], [], [], []
    for i in range(cfg.num_conv):
        q, s = _qw(params["convs"][i + 1]["w"])
        w8.append(q)
        sw.append(s)
        b.append(params["convs"][i + 1]["b"].float())
        alpha.append(params["prelus"][i + 1]["alpha"].float())
    w8_last, sw_last = _qw(params["convs"][-1]["w"])
    return QuantizedBody(w8=w8, sw=sw, b=b, alpha=alpha,
                         act_scale=act_scale, w8_last=w8_last,
                         sw_last=sw_last,
                         b_last=params["convs"][-1]["b"].float())


def _act_scale(act_maxima, n: int, margin: float, dev) -> torch.Tensor:
    """max(maxima * margin, 1e-8) / 127 in float32, from (n,) maxima."""
    if not torch.is_tensor(act_maxima):
        act_maxima = torch.from_numpy(np.array(act_maxima, np.float32))
    act_maxima = act_maxima.to(dev, torch.float32)
    if tuple(act_maxima.shape) != (n,):
        raise ValueError(f"act_maxima must be ({n},), got "
                         f"{tuple(act_maxima.shape)}")
    return (act_maxima * float(margin)).clamp_min(1e-8) / 127.0


def _qw_folded(w: torch.Tensor, part_scales, part_channels):
    """reve_tpu quantize_rrdb._qw_folded: each input-channel part's
    activation scale folded into its weight slice, then _qw."""
    sc = torch.cat([s.reshape(1).expand(c) for s, c in
                    zip(part_scales, part_channels)])
    return _qw(w.float() * sc[None, None, :, None])


def quantize_rrdb(params: Dict[str, Any], cfg: rrdb.RRDBConfig, act_maxima,
                  margin: float = 1.0) -> Dict[str, Any]:
    """The int8 RRDB trunk from float32 params + calibration maxima
    ((num_block * 15 + 1,), e.g. from collect_act_maxima_rrdb), on the
    params' device, in reve_tpu quantize_rrdb's layout:
      body: per block, per dense block: {"w8": [5], "sw": [5], "b": [5]}
        (HWIO int8 with each part's activation scale folded in; sw the
        per-output-channel dequant scale; b float32);
      conv_body: {"w8", "sw", "b"};
      act_scale: (num_block * 15 + 1,) float32, the quant scale of each
        statistic's tensor."""
    n = rrdb_num_stats(cfg)
    act_scale = _act_scale(act_maxima, n, margin,
                           params["conv_body"]["w"].device)
    nf, gc = cfg.num_feat, cfg.num_grow_ch
    body, si = [], 0
    for block in params["body"]:
        rdbs = []
        for rdb_p in block["rdbs"]:
            scales = act_scale[si:si + 5]  # [x, h1, h2, h3, h4]
            si += 5
            q = {"w8": [], "sw": [], "b": []}
            for i, conv in enumerate(rdb_p["convs"]):
                w8, sw = _qw_folded(conv["w"], scales[:i + 1],
                                    [nf] + [gc] * i)
                q["w8"].append(w8)
                q["sw"].append(sw)
                q["b"].append(conv["b"].float())
            rdbs.append(q)
        body.append(rdbs)
    assert si == n - 1, (si, n)
    w8, sw = _qw_folded(params["conv_body"]["w"], act_scale[si:], [nf])
    return {"body": body,
            "conv_body": {"w8": w8, "sw": sw,
                          "b": params["conv_body"]["b"].float()},
            "act_scale": act_scale}


def collect_maxima(params, u8, *, cfg, percentile: Optional[float] = None,
                   plain: bool = False) -> torch.Tensor:
    """Calibration statistics for any supported architecture."""
    fn = collect_act_maxima if isinstance(cfg, srvgg.SRVGGConfig) else \
        collect_act_maxima_rrdb
    return fn(params, u8, cfg=cfg, percentile=percentile, plain=plain)


def build_qbody(params, cfg, act_maxima, margin: float = 1.0):
    """Quantized body for any supported architecture."""
    if isinstance(cfg, srvgg.SRVGGConfig):
        return quantize_hidden(params, cfg, act_maxima, margin=margin)
    return quantize_rrdb(params, cfg, act_maxima, margin=margin)
