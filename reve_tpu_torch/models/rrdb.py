"""RRDBNet — the full-size Real-ESRGAN generator (x4plus, x4plus-anime-6B,
RealESRNet), in PyTorch.

Counterpart of reve_tpu/models/rrdb.py.  Architecture (upstream
Real-ESRGAN `RRDBNet`):

    conv_first -> nb x RRDB -> conv_body (+ residual)
    -> [nearest x2 + conv_up1 + lrelu] x2 -> conv_hr + lrelu -> conv_last

    RDB  (dense block): 5 convs with dense concats, growth gc, out*0.2 + x
    RRDB: 3 RDBs chained, out*0.2 + x

Layouts match reve_tpu: NHWC activations, HWIO weights, uint8 frames at
the public boundary.  Only the classic domain is carried: reve_tpu's 2D
space-to-depth form is an MXU-width trick and exact, so the port is held
against both of its modes.  x4 and x2 are carried; x2 pixel-unshuffles
its input by 2 (reve_tpu rrdb.py:192-193), so conv_first reads 12
channels and the trunk runs at half the frame's height and width.  x1
(unshuffled by 4, 48 channels) is in no registry name and is refused
(ROADMAP.md port queue: RRDB x1).

`apply` runs u8 -> u8 through the kernels of the path: K3 for conv_first
(its PReLU at alpha 1 is the identity; at x2 K3 at Cin 12, which reads
the unshuffle in place from the frame), K7 for every dense-block conv and
conv_body with the step after it (one NHWC buffer of nf + 4 gc channels a
pixel holds a dense block's concat, three of them rotate through an
RRDB; in float32 each with its split planes beside it, written by the
convs that write it), K1 for conv_up1, conv_up2 and conv_hr with the leaky ReLU (PReLU
at alpha 0.2), and head.conv_last_u8 for conv_last with the engine's u8
rounding (K2's conv_last mode in bfloat16; in float32 a kernel of float32
FMAs that reads its input as it is, with no split pass).  The nearest x2
before each up conv is a torch op (ops/resize.py).  `apply_int8`, the int8 turbo (`--dtype int8`), runs the
trunk on K7q, K7's s8 form, with the scales of weights/quantize.py's
quantize_rrdb, and conv_first and the head as `apply` in bfloat16.  On
CPU tensors each wrapper runs its plain version, and `plain=True` runs
the plain versions on any device (the reference path).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from reve_tpu_torch.kernels import conv3x3, head
from reve_tpu_torch.kernels import rrdb as dense
from reve_tpu_torch.ops.resize import upsample_nearest

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RRDBConfig:
    num_in_ch: int = 3
    num_out_ch: int = 3
    num_feat: int = 64
    num_block: int = 23
    num_grow_ch: int = 32
    upscale: int = 4   # output scale; x2/x1 pixel-unshuffle the input

    @property
    def dense_channels(self) -> int:
        """Channels of one dense block's concat: nf + 4 gc."""
        return self.num_feat + 4 * self.num_grow_ch


Params = Dict[str, Any]
#: the head convs, classic domain, in order
HEAD = ("conv_up1", "conv_up2", "conv_hr", "conv_last")


def _conv_init(gen, cin, cout, dtype, scale=1.0):
    bound = scale / math.sqrt(cin * 9)
    w = (torch.rand((3, 3, cin, cout), generator=gen, dtype=dtype) * 2
         - 1) * bound
    return {"w": w, "b": torch.zeros((cout,), dtype=dtype)}


def init_params(cfg: RRDBConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.float32) -> Params:
    """Deterministic init with reve_tpu's scales (rrdb.py:48-83): weights
    uniform(+-scale / sqrt(9 cin)), scale 0.1 in the dense blocks and 1
    elsewhere, zero biases; from an explicit torch.Generator (seed 0 when
    none is given).  Not bit-equal to reve_tpu's jax.random init: tests
    carry weights across with params_from_jax instead."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    nf, gc = cfg.num_feat, cfg.num_grow_ch
    cin = cfg.num_in_ch * (4 if cfg.upscale == 2 else
                           16 if cfg.upscale == 1 else 1)

    def rdb():
        return {"convs": [_conv_init(generator, nf + i * gc,
                                     gc if i < 4 else nf, dtype, scale=0.1)
                          for i in range(5)]}

    params = {"conv_first": _conv_init(generator, cin, nf, dtype)}
    params["body"] = [{"rdbs": [rdb() for _ in range(3)]}
                      for _ in range(cfg.num_block)]
    params["conv_body"] = _conv_init(generator, nf, nf, dtype)
    for name in HEAD[:-1]:
        params[name] = _conv_init(generator, nf, nf, dtype)
    params["conv_last"] = _conv_init(generator, nf, cfg.num_out_ch, dtype)
    return params


def _map_convs(params: Params, fn) -> Params:
    """params with fn(conv) in place of every conv dict."""
    out = {name: fn(params[name]) for name in
           ("conv_first", "conv_body") + HEAD}
    out["body"] = [{"rdbs": [{"convs": [fn(c) for c in rdb["convs"]]}
                             for rdb in block["rdbs"]]}
                   for block in params["body"]]
    return out


def params_from_jax(tree) -> Params:
    """reve_tpu's classic-domain params pytree (HWIO `w`, `b`; numpy or
    jax arrays) -> the port's layout, float32 torch tensors."""

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))

    return _map_convs(tree, lambda c: {"w": t(c["w"]), "b": t(c["b"])})


def params_to(params: Params, device) -> Params:
    return _map_convs(params, lambda c: {k: v.to(device)
                                         for k, v in c.items()})


def prepare(params: Params, compute_dtype: torch.dtype) -> Params:
    """params with every weight cast to the compute dtype once and, on a
    CUDA device, every K7 conv's weights packed once (`packed`, what
    kernels.rrdb.dense_conv streams): `apply` takes either form, and the
    engine keeps this one.  Biases stay float32."""

    def cast(c):
        return {"w": c["w"].to(compute_dtype).contiguous(),
                "b": c["b"].float()}

    out = _map_convs(params, cast)
    if out["conv_body"]["w"].device.type == "cuda":
        def pack(c):
            return dict(c, packed=dense.pack_weights_dense(c["w"]))

        out["body"] = [{"rdbs": [{"convs": [pack(c) for c in rdb["convs"]]}
                                 for rdb in block["rdbs"]]}
                       for block in out["body"]]
        out["conv_body"] = pack(out["conv_body"])
    return out


def check_cfg(cfg: RRDBConfig) -> None:
    """Raise for a config the port does not run (x1, x3, not RGB)."""
    if cfg.upscale == 1:
        raise NotImplementedError(
            "RRDB x1 (an input pixel-unshuffled by 4) is not yet ported in "
            "reve_tpu_torch (ROADMAP.md port queue: RRDB x1)")
    if cfg.upscale not in (2, 4):
        raise ValueError(f"RRDBNet upscales x1, x2 or x4, not "
                         f"x{cfg.upscale}")
    if (cfg.num_in_ch, cfg.num_out_ch) != (3, 3):
        raise ValueError(f"RRDB takes and returns RGB frames, got "
                         f"{cfg.num_in_ch} -> {cfg.num_out_ch} channels")


def conv_first(params: Params, u8: torch.Tensor, *, cfg: RRDBConfig,
               compute_dtype: torch.dtype,
               plain: bool = False) -> torch.Tensor:
    """conv_first of (B, H, W, 3) uint8 frames in the compute dtype, no
    activation: x4 on K3 (its PReLU at alpha 1, the identity), x2 on K3
    at Cin 12 over the frames unshuffled by 2 (H and W even) -> (B, H/2,
    W/2, nf); their plain versions with `plain`."""
    cf = params["conv_first"]
    w = cf["w"].to(compute_dtype)
    if cfg.upscale == 2:
        fn = conv3x3.conv3x3_u8x2_bias_plain if plain else \
            conv3x3.conv3x3_u8x2_bias
        return fn(u8, w, cf["b"])
    fn = conv3x3.conv3x3_u8_bias_prelu_plain if plain else \
        conv3x3.conv3x3_u8_bias_prelu
    return fn(u8, w, cf["b"], torch.ones(cfg.num_feat, device=u8.device))


def apply(params: Params, u8: torch.Tensor, *, cfg: RRDBConfig,
          compute_dtype: torch.dtype = torch.float32,
          plain: bool = False) -> torch.Tensor:
    """Forward pass, u8 -> u8: (B, H, W, 3) uint8 -> (B, sH, sW, 3) uint8,
    s = cfg.upscale (4, or 2 with H and W even).

    Equals the JAX engine's RRDB call (reve_tpu/pipeline/engine.py:426-429):
    `rrdb.apply(u8 / 255, s2d=...)`, then u8 = clip(y * 255 + 0.5, 0, 255)
    truncated.  Weights in the compute dtype, float32 accumulation, each
    conv + bias in float32 then cast (_raw_conv); the leaky ReLU, the
    dense blocks' `* 0.2 + x` and conv_body's `feat +` in the compute
    dtype; the last conv's output widened to float32 for the u8 rounding.

    `params`: float32 params, or `prepare(params, compute_dtype)` (weights
    cast and K7's packed once).  `plain=True` runs the plain PyTorch
    version of every kernel (the reference path) wherever the tensors
    are."""
    if u8.dtype != torch.uint8:
        raise TypeError(f"apply takes uint8 frames, got {u8.dtype}")
    check_cfg(cfg)
    if len(params["body"]) != cfg.num_block:
        raise ValueError(f"params hold {len(params['body'])} RRDB blocks; "
                         f"cfg needs {cfg.num_block}")
    dt = compute_dtype
    feat = conv_first(params, u8, cfg=cfg, compute_dtype=dt, plain=plain)
    a, planes = dense_trunk(params, feat, cfg=cfg, compute_dtype=dt,
                            plain=plain)
    # feat + conv_body(body), written over feat
    _dense_conv_fn(dt, plain)(a, cfg.num_feat, params["conv_body"], feat,
                              0, "add", res=feat, planes=planes)
    # the trunk's buffers go before the head allocates at 2x and 4x
    del a, planes
    held = [feat]
    del feat
    return _head(params, held, dt, plain)


def _dense_conv_fn(dt: torch.dtype, plain: bool):
    """K7 (or its plain version) over a conv's params in the compute
    dtype, with its packed weights where `prepare` packed them."""

    def conv(src, cin, p, dst, off, epi, res=None, res2=None, planes=None,
             out_planes=None):
        w = p["w"].to(dt)
        if plain:
            dense.dense_conv_plain(src, cin, w, p["b"], dst, off, epi, res,
                                   res2)
        else:
            dense.dense_conv(src, cin, w, p["b"], dst, off, epi, res, res2,
                             packed=p.get("packed"), planes=planes,
                             out_planes=out_planes)
    return conv


def dense_trunk(params: Params, feat: torch.Tensor, *, cfg: RRDBConfig,
                compute_dtype: torch.dtype, plain: bool = False,
                observe=None):
    """The RRDB blocks of `apply` over feat (B, H, W, nf) in the compute
    dtype, on K7: returns (the dense buffer whose first nf channels hold
    the trunk's output, conv_body's input; its split planes or None).
    `observe(buf, lo, hi)`, when given, sees channels [lo, hi) of the
    buffer holding each dense block's input and each growth slice as it
    is written (the calibration's statistics, weights/quantize.py).

    In float32 (but with `plain`) each dense buffer has its split planes
    beside it, (3, B, H, W, nf + 4 gc) bfloat16, which K7 reads: feat's
    are split once, and every conv writes the planes of the channels it
    writes, so no split pass runs in the trunk."""
    nf, gc, cs = cfg.num_feat, cfg.num_grow_ch, cfg.dense_channels
    conv = _dense_conv_fn(compute_dtype, plain)
    B, H, W, _ = feat.shape
    dev = feat.device
    # a = bufs[0]: the RRDB's input and, written in place by the third
    # dense block's last conv, its output; bufs[1], bufs[2]: the first two
    # blocks' outputs; planes[i]: the split of bufs[i] (float32)
    bufs = [torch.empty((B, H, W, cs), dtype=compute_dtype, device=dev)
            for _ in range(3)]
    a = bufs[0]
    a[..., :nf].copy_(feat)
    planes = [None] * 3
    if compute_dtype == torch.float32 and not plain:
        planes = [torch.empty((3, B, H, W, cs), dtype=torch.bfloat16,
                              device=dev) for _ in range(3)]
        planes[0][..., :nf].copy_(conv3x3.split_bf16x3(feat))
    for block in params["body"]:
        for (i_src, i_dst), rdb, epi in zip(((0, 1), (1, 2), (2, 0)),
                                            block["rdbs"],
                                            ("rdb", "rdb", "rrdb")):
            src, dst = bufs[i_src], bufs[i_dst]
            ps, pd = planes[i_src], planes[i_dst]
            if observe is not None:
                observe(src, 0, nf)
            convs = rdb["convs"]
            for i in range(4):
                # growth slice i right after the channels conv i reads
                lo = nf + i * gc
                conv(src, lo, convs[i], src, lo, "lrelu", planes=ps,
                     out_planes=ps)
                if observe is not None:
                    observe(src, lo, lo + gc)
            conv(src, cs, convs[4], dst, 0, epi, res=src,
                 res2=a if epi == "rrdb" else None, planes=ps, out_planes=pd)
    return a, planes[0]


def _head(params: Params, held: list, dt: torch.dtype,
          plain: bool) -> torch.Tensor:
    """The head after the trunk, u8 out: nearest x2 + conv_up1 + leaky
    ReLU, the same at 4x with conv_up2, conv_hr + leaky ReLU, then
    conv_last with the u8 rounding (K1 with PReLU at alpha 0.2,
    head.conv_last_u8; their plain versions with `plain`).  `held`: a
    one-element list holding feat (B, H, W, nf) in the compute dtype,
    emptied here, so that the caller keeps no reference that would hold
    feat while the head allocates at 2x and 4x."""
    if plain:
        up_conv = conv3x3.conv3x3_bias_prelu_plain
        last = head.conv_last_u8_plain
    else:
        up_conv = conv3x3.conv3x3_bias_prelu
        last = head.conv_last_u8
    feat = held.pop()
    nf = feat.shape[-1]
    slope = torch.full((nf,), dense.SLOPE, device=feat.device)
    for name in ("conv_up1", "conv_up2"):
        p = params[name]
        x = upsample_nearest(feat, 2)
        del feat
        feat = up_conv(x, p["w"].to(dt), p["b"], slope)
        del x
    p = params["conv_hr"]
    x = up_conv(feat, p["w"].to(dt), p["b"], slope)
    del feat
    p = params["conv_last"]
    return last(x, p["w"].to(dt), p["b"])


def qbody_from_jax(tree) -> Dict[str, Any]:
    """reve_tpu's quantize_rrdb output (numpy or jax arrays) -> the port's
    qbody (weights.quantize.quantize_rrdb's layout), the same numbers as
    torch tensors on the CPU."""

    def t(a):
        return torch.from_numpy(np.array(a, copy=True))

    def conv(c):
        return {k: t(c[k]) for k in ("w8", "sw", "b")}

    return {"body": [[{k: [t(a) for a in q[k]] for k in ("w8", "sw", "b")}
                      for q in block] for block in tree["body"]],
            "conv_body": conv(tree["conv_body"]),
            "act_scale": t(tree["act_scale"])}


def prepare_qbody(qbody: Dict[str, Any]) -> Dict[str, Any]:
    """qbody with, on a CUDA device, every K7q conv's s8 weights packed
    once (`packed`: a list of 5 per dense block, one for conv_body), what
    kernels.rrdb.dense_conv_s8 keeps resident; on the CPU as it is."""
    if qbody["conv_body"]["w8"].device.type != "cuda":
        return qbody
    pack = dense.pack_weights_dense_s8
    body = [[dict(q, packed=[pack(w) for w in q["w8"]]) for q in block]
            for block in qbody["body"]]
    cb = qbody["conv_body"]
    return dict(qbody, body=body, conv_body=dict(cb, packed=pack(cb["w8"])))


def _quant_into(dst: torch.Tensor, x: torch.Tensor,
                inv: torch.Tensor) -> None:
    """dst (int8) = reve_tpu srvgg._quant_s8(x): round(x * inv) half to
    even, clipped to +-127, through one float32 temporary."""
    t = x * inv
    t.round_().clamp_(-127, 127)
    dst.copy_(t)


def apply_int8(params: Params, qbody: Dict[str, Any], u8: torch.Tensor, *,
               cfg: RRDBConfig, compute_dtype: torch.dtype = torch.bfloat16,
               plain: bool = False) -> torch.Tensor:
    """int8 turbo forward, u8 -> u8: (B, H, W, 3) uint8 -> (B, sH, sW, 3)
    uint8, s = cfg.upscale.  Equals reve_tpu's `rrdb.apply_int8(params,
    qbody, u8 / 255, quantize_u8=True)` in its classic domain (its s2d
    form is exact in the s8 convs):

      conv_first on K3 (x2: K3 at Cin 12) in the compute dtype (as
          `apply`); body =
          float32(feat) and its quantize with act_scale[0] as torch ops;
      every dense-block conv on K7q (kernels.rrdb.dense_conv_s8): s8 x
          s8 -> s32, dq = float32(y32) * sw + b, then lrelu_q for convs
          1-4, rdb (dq * 0.2 + x in float32) for conv 5 and rrdb (then
          * 0.2 + b_in) after the third dense block, each conv-5 output
          quantized with the next statistic's scale;
      conv_body on K7q's add form: feat = dtype(float32(feat) + dq);
      the head exactly as `apply`'s.

    Buffers: two s8 concat buffers of nf + 4 gc channels that alternate
    by dense block (conv 5 writes its quantized output into the first nf
    channels of the other one: neighbouring tiles still read its input
    through their halos) and three float32 nf-channel buffers for the
    residual chain (the RRDB's input, written over in place by the third
    dense block, and the first two blocks' outputs).

    `params`: float32 params or `prepare(params, compute_dtype)`; `qbody`:
    weights.quantize.quantize_rrdb's, or prepare_qbody's (K7q's weights
    packed once).  Every scale is formed here in torch as the reference
    forms it: the reciprocals 1 / act_scale in float32.  `plain=True` runs
    the plain PyTorch version of every kernel wherever the tensors are."""
    if u8.dtype != torch.uint8:
        raise TypeError(f"apply_int8 takes uint8 frames, got {u8.dtype}")
    check_cfg(cfg)
    n = cfg.num_block * 15 + 1
    if len(params["body"]) != cfg.num_block or \
            len(qbody["body"]) != cfg.num_block or \
            tuple(qbody["act_scale"].shape) != (n,):
        raise ValueError(f"params / qbody hold {len(params['body'])} / "
                         f"{len(qbody['body'])} RRDB blocks and "
                         f"{tuple(qbody['act_scale'].shape)} scales; cfg "
                         f"needs {cfg.num_block} and ({n},)")
    dt = compute_dtype
    nf, gc, cs = cfg.num_feat, cfg.num_grow_ch, cfg.dense_channels
    conv_s8 = dense.dense_conv_s8_plain if plain else dense.dense_conv_s8

    def conv(src, cin, q, i, epi, **kw):
        if not plain:
            kw["packed"] = q["packed"][i] if "packed" in q else None
        conv_s8(src, cin, q["w8"][i], q["sw"][i], q["b"][i], epi, **kw)

    dev = u8.device
    inv = 1.0 / qbody["act_scale"]  # float32, as `1.0 / scale`
    feat = conv_first(params, u8, cfg=cfg, compute_dtype=dt, plain=plain)
    B, H, W, _ = feat.shape
    s8 = [torch.empty((B, H, W, cs), dtype=torch.int8, device=dev)
          for _ in range(2)]
    # chain[0]: the RRDB's input, then (in place) its output; chain[1],
    # chain[2]: the first two dense blocks' outputs
    chain = [torch.empty((B, H, W, nf), dtype=torch.float32, device=dev)
             for _ in range(3)]
    chain[0].copy_(feat)
    _quant_into(s8[0][..., :nf], chain[0], inv[0])
    cur, si = 0, 0
    for qblock in qbody["body"]:
        for j, q in enumerate(qblock):
            src, dst = s8[cur], s8[1 - cur]
            for i in range(4):
                # growth slice i right after the channels conv i reads
                conv(src, nf + i * gc, q, i, "lrelu_q", inv=inv[si + i + 1],
                     out8=src, out8_off=nf + i * gc)
            last = j == len(qblock) - 1
            conv(src, cs, q, 4, "rrdb" if last else "rdb",
                 inv=inv[si + 5], out8=dst, res=chain[j],
                 res2=chain[0] if last else None,
                 out=chain[0] if last else chain[j + 1])
            cur, si = 1 - cur, si + 5
    # feat + conv_body(quant(body)), written over feat
    cb = qbody["conv_body"]
    conv(s8[cur], nf, {k: [v] for k, v in cb.items()}, 0, "add", res=feat,
         out=feat)
    del s8, chain, src, dst
    held = [feat]
    del feat
    return _head(params, held, dt, plain)


# -- weight loading ----------------------------------------------------------


def load_pth(path: str):
    """RealESRGAN RRDBNet .pth -> (RRDBConfig, params), params as float32
    CPU tensors.  Upstream key layout (reve_tpu rrdb.load_pth): conv_first,
    body.<i>.rdb<j>.conv<k>, conv_body, conv_up1/2, conv_hr, conv_last
    (weights OIHW, stored HWIO)."""
    from reve_tpu_torch.weights.torch_loader import _state_dict

    sd = _state_dict(path)

    def conv(name):
        w = sd[f"{name}.weight"]
        b = sd.get(f"{name}.bias", torch.zeros((w.shape[0],)))
        return {"w": w.permute(2, 3, 1, 0).contiguous(), "b": b.contiguous()}

    num_block = 1 + max(
        int(k.split(".")[1]) for k in sd if k.startswith("body."))
    first_w = sd["conv_first.weight"]
    nf, cin = int(first_w.shape[0]), int(first_w.shape[1])
    gc = int(sd["body.0.rdb1.conv1.weight"].shape[0])
    upscale = {3: 4, 12: 2, 48: 1}.get(cin, 4)
    cfg = RRDBConfig(num_in_ch=3,
                     num_out_ch=int(sd["conv_last.weight"].shape[0]),
                     num_feat=nf, num_block=num_block, num_grow_ch=gc,
                     upscale=upscale)
    params = {"conv_first": conv("conv_first")}
    params["body"] = [
        {"rdbs": [{"convs": [conv(f"body.{i}.rdb{j + 1}.conv{k + 1}")
                             for k in range(5)]} for j in range(3)]}
        for i in range(num_block)]
    for name in ("conv_body",) + HEAD:
        params[name] = conv(name)
    return cfg, params


def load_model(spec, scale: int, path: Optional[str] = None,
               allow_random_init=None):
    """Registry hook (models.registry.load_model for the rrdb arch), with
    reve_tpu rrdb.load_model's missing-weights contract: the .pth at
    `path` (an explicit --weights, or found on the search path by the
    registry) must load at `scale`; with no weights, MissingWeightsError
    unless random init is explicitly allowed (then init_params, seed
    0)."""
    from reve_tpu_torch.models import registry

    if path:
        cfg, params = load_pth(path)
        if cfg.upscale != scale:
            raise ValueError(f"weights {path!r} are x{cfg.upscale}, "
                             f"requested x{scale}")
        return cfg, params
    if not registry.random_init_allowed(allow_random_init):
        raise registry.MissingWeightsError(registry.missing_weights_message(
            spec.canonical, scale, spec.canonical))
    log.warning("no weights for %s; using deterministic random init",
                spec.canonical)
    cfg = RRDBConfig(num_feat=spec.num_feat, num_block=spec.num_conv,
                     upscale=scale)
    return cfg, init_params(cfg)
