"""K7 `dense_conv`: RRDBNet's dense-block conv with the elementwise step
after it (csrc/rrdb.cu), in bfloat16 and float32, and K7q
`dense_conv_s8`, its s8 form for the int8 trunk (csrc/rrdb_s8.cu), each
with its plain version and its weight packing.

Replaces the trunk convs of reve_tpu/models/rrdb.py: `_rdb`'s five convs
over the growing concat with `_lrelu` after the first four and
`feats[-1] * 0.2 + x` after the fifth (rrdb.py:157-165), `_rrdb`'s `out *
0.2 + x` after its third dense block (:168-172), and `feat +
conv_body(body)` (:229), which XLA fused into one conv graph on the TPU.

The dense concat is one NHWC buffer of nf + 4 gc = 192 channels a pixel:
conv i reads its first nf + i gc channels and writes its gc growth
channels right after them (the `lrelu` form), so no concat is ever
copied.  The fifth conv writes the block's output, `rdb` (y * 0.2 + x),
into the first nf channels of another buffer: its neighbours still read
its input through their halos.  `rrdb` also adds the RRDB's residual,
writing over it in place (read at the same pixel); `add` is conv_body's
+ feat.

Bound per call of 4 1080p frames on an H100 SXM (989 TFLOP/s bf16,
3.35 TB/s): conv 1 (64 -> 32) 1.59 GB -> 0.475 ms (bytes); conv 5
(192 -> 64) 1.83 TFLOP -> 1.855 ms (operations).  float32 runs six bf16
products of operands split in three (never TF32), read from the split
planes of the buffer, (3, B, H, W, Cs) bfloat16 beside each float32
dense buffer: the conv that writes a channel writes its hi, mid and lo
too (`out_planes`), so the trunk runs no split pass; called without
planes, the wrapper splits the channels the conv reads first.

Rounding points follow the JAX reference: weights in the compute dtype,
float32 accumulation + b in float32, cast to the compute dtype, then each
step of the epilogue in the compute dtype with 0.2 cast to it.

K7q replaces the int8 trunk of reve_tpu/models/rrdb.py:apply_int8
(`_rdb_int8`, :247-265, and conv_body, :324-327): an s8 x s8 -> s32 conv
of the first Cin channels of a 192-channel s8 concat buffer, the dequant
`float32(y32) * sw + b` (`_dq`, :240-244; `sw` alone: each concat part's
activation scale is folded into its weight slice, weights/quantize.py)
and one of four float32 epilogues (EPILOGUES_S8), every conv-5 output
quantized with the next statistic's scale, so no quant pass runs inside
the trunk:

  lrelu_q  quant(lrelu(dq), s_next) into the growth slice beside the
           channels it read;
  rdb      z = dq * 0.2 + x (float32, x the dense block's input) into the
           next float32 chain buffer, and quant(z, s_next) into the first
           nf channels of the other s8 buffer;
  rrdb     rdb, then z * 0.2 + b_in written over b_in (the RRDB's input,
           read at the same pixel), and its quant;
  add      dtype(feat.f32 + dq) over feat (conv_body).

quant is `clip(round_half_even(v * f32(1 / scale)), +-127)` (reve_tpu
srvgg._quant_s8).  Each multiply and add rounds on its own, as the
reference's ops are written (an XLA build may contract some into FMAs).
Bound per call of 4 1080p frames at 3.35 TB/s and 1979 TOP/s s8: bytes
for every form (chip_smoke.py reckons it from its shapes).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from reve_tpu_torch.kernels import LAUNCHES, build
from reve_tpu_torch.kernels.conv3x3 import (check_operands, conv3x3_plain,
                                            f32_operand, quant_s8_plain,
                                            split_bf16x3,
                                            split_bf16x3_plain)
from reve_tpu_torch.kernels.conv3x3_s8 import conv3x3_s8_plain

SOURCE = "rrdb.cu"
#: K7q, the s8 form
S8_SOURCE = "rrdb_s8.cu"
#: K7 and K7q take Cin in multiples of this many channels: K7q's s8 k32
#: step (K7's own chunk, KCHUNK, divides it), one rule for both so that
#: every conv the float32 and bf16 model runs, the int8 model runs too
CIN_STEP = 32
#: input channels per chunk of K7's mainloop (one TMA box, one 32-B A row,
#: one k16 step of each tap)
KCHUNK = 16
#: K7's output channel counts (the wgmma N): a growth slice, nf
COUTS = (32, 64)
#: the most input channels K7 reads: nf + 4 gc (its resident weights)
MAX_CIN = 192
#: the epilogue forms, in the kernel's numbering
EPILOGUES = ("lrelu", "rdb", "rrdb", "add")
#: the dense blocks' leaky-ReLU slope and residual scale
SLOPE = 0.2
_DTYPES = (torch.float32, torch.bfloat16)
#: K7q's epilogue forms, in the kernel's numbering
EPILOGUES_S8 = ("lrelu_q", "rdb", "rrdb", "add")
#: input channels per chunk of K7q's mainloop (one TMA box, one 64-B A
#: row; a last chunk past Cin reads zeros)
CHUNK_S8 = 64


# -- plain versions ---------------------------------------------------------


def dense_epilogue_plain(y: torch.Tensor, epi: str,
                         res: Optional[torch.Tensor] = None,
                         res2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The step after a dense conv, each op rounded to y's dtype:
    lrelu where(y >= 0, y, y * 0.2); rdb y * 0.2 + res; rrdb (y * 0.2 +
    res) * 0.2 + res2; add res + y.  `res`, `res2`: y's shape."""
    k = torch.tensor(SLOPE, dtype=y.dtype, device=y.device)
    if epi == "lrelu":
        return torch.where(y >= 0, y, y * k)
    if epi == "add":
        return res + y
    z = y * k + res
    if epi == "rrdb":
        z = z * k + res2
    elif epi != "rdb":
        raise ValueError(f"unknown epilogue {epi!r}; known: {EPILOGUES}")
    return z


def dense_conv_plain(buf: torch.Tensor, cin: int, w: torch.Tensor,
                     b: torch.Tensor, out: torch.Tensor, out_off: int,
                     epi: str, res: Optional[torch.Tensor] = None,
                     res2: Optional[torch.Tensor] = None,
                     out_planes: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """out[..., out_off:out_off + cout] = epilogue(dtype(conv3x3(buf[...,
    :cin], w) + b)), with the first cout channels of `res` and `res2`,
    and, where `out_planes` ((3, *out.shape) bfloat16) is given, the same
    channels of it = split_bf16x3_plain of what was written; returns
    out."""
    cout = w.shape[-1]
    y = conv3x3_plain(buf[..., :cin], w, b)
    y = dense_epilogue_plain(
        y, epi, None if res is None else res[..., :cout],
        None if res2 is None else res2[..., :cout])
    out[..., out_off:out_off + cout] = y
    if out_planes is not None:
        out_planes[..., out_off:out_off + cout] = split_bf16x3_plain(y)
    return out


def pack_weights_dense(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, cin, cout) in the compute dtype -> the B operand K7
    reads: (cin / 16, 9, S, 2, cout, 8) bfloat16 [chunk][tap][split][k /
    8][n][8], packed[c, t, s, kb, n, kk] = planes[s, t // 3, t % 3, 16 c +
    8 kb + kk, n] (B K-major in core matrices of 8 rows x 16 B; a chunk's
    taps, a tap's splits, contiguous).  bfloat16: S = 1, the weights as
    they are; float32: S = 3, split_bf16x3's hi, mid, lo."""
    cin, cout = w.shape[2], w.shape[3]
    if cin % CIN_STEP:
        raise ValueError(f"K7 reads Cin in chunks of {CIN_STEP}, got "
                         f"{cin}")
    planes = w[None] if w.dtype == torch.bfloat16 else split_bf16x3_plain(w)
    s = planes.shape[0]
    t = planes.reshape(s, 9, cin // KCHUNK, KCHUNK // 8, 8, cout)
    return t.permute(2, 1, 0, 3, 5, 4).contiguous()


# -- kernel wrapper -----------------------------------------------------------


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _check_planes(buf, cin, out, out_off, planes, out_planes) -> None:
    """The split planes K7 reads (of buf) and writes (of out): float32
    only, (3, *shape) bfloat16; the planes it writes lie beside the
    channels it reads, as out beside buf."""
    for p, of in ((planes, buf), (out_planes, out)):
        if p is None:
            continue
        if buf.dtype != torch.float32 or p.dtype != torch.bfloat16 or \
                tuple(p.shape) != (3, *of.shape):
            raise ValueError(f"K7's planes are float32's split, (3, "
                             f"{tuple(of.shape)}) bfloat16; got "
                             f"{tuple(p.shape)} {p.dtype} for a {buf.dtype} "
                             f"conv")
    if planes is not None and out_planes is not None and \
            _shares_storage(planes, out_planes) and (
                out_planes.data_ptr() != planes.data_ptr() or
                out_off < cin):
        raise ValueError("K7 writes into the planes it reads only in "
                         "channels past the ones it reads (out_off >= cin)")


def _check(buf, cin, w, out, out_off, epi, res, res2) -> None:
    """K7's checks of its operands' types, shapes and overlaps."""
    if w.dtype not in _DTYPES or buf.dtype != w.dtype or \
            out.dtype != w.dtype:
        raise TypeError(f"K7 dtypes {buf.dtype}/{w.dtype}/{out.dtype}; "
                        f"expected one of float32, bfloat16 for all")
    if buf.dim() != 4 or out.dim() != 4 or out.shape[:3] != buf.shape[:3]:
        raise ValueError(f"K7 buffers {tuple(buf.shape)} -> "
                         f"{tuple(out.shape)}; expected (B, H, W, C) of one "
                         f"B, H, W")
    cs, cout = buf.shape[3], w.shape[3]
    if cin % CIN_STEP or not CIN_STEP <= cin <= min(cs, MAX_CIN) or \
            cs % 8 or tuple(w.shape) != (3, 3, cin, cout) or cout not in COUTS:
        raise ValueError(f"K7 reads Cin <= {MAX_CIN} channels in chunks of "
                         f"{CIN_STEP} of a "
                         f"buffer of a multiple of 8 and writes {COUTS}: "
                         f"got Cin {cin} of {cs}, weights {tuple(w.shape)}")
    if out_off % 8 or out_off + cout > out.shape[3] or out.shape[3] % 8:
        raise ValueError(f"K7 writes channels [{out_off}, {out_off + cout}) "
                         f"of {out.shape[3]}: the offset must be a multiple "
                         f"of 8 inside a pixel of a multiple of 8")
    if epi not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epi!r}; known: {EPILOGUES}")
    need = {"lrelu": (), "rdb": (res,), "add": (res,),
            "rrdb": (res, res2)}[epi]
    for r in need:
        if r is None or r.dtype != w.dtype or r.dim() != 4 or \
                r.shape[:3] != buf.shape[:3] or r.shape[3] < cout or \
                r.shape[3] % 8:
            raise ValueError(f"epilogue {epi!r} needs residuals of "
                             f"({tuple(buf.shape[:3])}, >= {cout}, a "
                             f"multiple of 8) {w.dtype}")
    # the conv reads buf's first cin channels of every pixel in its
    # halos: an output into buf must lie beside them, never over them
    if _shares_storage(out, buf) and (out.data_ptr() != buf.data_ptr() or
                                      out.shape != buf.shape or
                                      out_off < cin):
        raise ValueError("K7 writes into its own input only in channels "
                         "past the ones it reads (out_off >= cin)")
    check_operands(buf, w, out, *need)


def dense_conv(buf: torch.Tensor, cin: int, w: torch.Tensor,
               b: torch.Tensor, out: torch.Tensor, out_off: int, epi: str,
               res: Optional[torch.Tensor] = None,
               res2: Optional[torch.Tensor] = None,
               packed: Optional[torch.Tensor] = None,
               planes: Optional[torch.Tensor] = None,
               out_planes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7: the conv of buf's first `cin` channels ((B, H, W, Cs) in the
    compute dtype) by w ((3, 3, cin, cout) HWIO, cout 32 or 64), + b in
    float32, cast, then the epilogue `epi` (EPILOGUES) with the first cout
    channels of `res` and `res2`, into out[..., out_off:out_off + cout];
    returns out.  `packed`: pack_weights_dense(w), packed once by the
    caller (packed here when None).

    float32 only: `planes` ((3, *buf.shape) bfloat16) holds the split of
    buf's first cin channels, which the conv reads (None: the split pass
    runs first over them, a second launch); `out_planes` ((3, *out.shape)
    bfloat16), where given, receives the split of the channels written,
    by the same kernel."""
    if buf.device.type == "cpu":
        return dense_conv_plain(buf, cin, w, b, out, out_off, epi, res, res2,
                                out_planes)
    if buf.device.type != "cuda":
        raise ValueError(f"tensor on {buf.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain version)")
    _check(buf, cin, w, out, out_off, epi, res, res2)
    _check_planes(buf, cin, out, out_off, planes, out_planes)
    cout = w.shape[3]
    wp = pack_weights_dense(w) if packed is None else packed
    expect = (cin // KCHUNK, 9, 1 if w.dtype == torch.bfloat16 else 3,
              KCHUNK // 8, cout, 8)
    if tuple(wp.shape) != expect or wp.dtype != torch.bfloat16 or \
            wp.device != buf.device or not wp.is_contiguous():
        raise ValueError(f"packed weights {tuple(wp.shape)} {wp.dtype}; "
                         f"expected {expect} bfloat16 on {buf.device}")
    B, H, W, cs = buf.shape
    bb = f32_operand(b, cout, buf.device, "bias")
    elem = buf.element_size()

    def ptr(t):
        return None if t is None else t.data_ptr()

    px = [0 if t is None else t.shape[3] for t in (res, res2)]
    lib = build.load(SOURCE)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    epi_i = EPILOGUES.index(epi)
    P, I = ctypes.c_void_p, ctypes.c_int
    if w.dtype == torch.bfloat16:
        fn = lib.reve_dense_conv_tc
        fn.argtypes = [P] * 6 + [I] * 10 + [P]
        fn.restype = ctypes.c_int
        err = fn(buf.data_ptr(), wp.data_ptr(), bb.data_ptr(), ptr(res),
                 ptr(res2), out.data_ptr() + out_off * elem, B, H, W, cin,
                 cs, cout, px[0], px[1], out.shape[3], epi_i, stream)
    else:
        if planes is None:
            # stays referenced until the launch is enqueued
            planes = split_bf16x3(buf[..., :cin])
        check_operands(planes, *(() if out_planes is None
                                 else (out_planes,)))
        fn = lib.reve_dense_conv_f32tc_planes
        fn.argtypes = [P] * 7 + [I] * 11 + [P]
        fn.restype = ctypes.c_int
        op = None if out_planes is None else \
            out_planes.data_ptr() + out_off * 2
        err = fn(planes.data_ptr(), wp.data_ptr(), bb.data_ptr(), ptr(res),
                 ptr(res2), out.data_ptr() + out_off * elem, op, B, H, W,
                 cin, planes.shape[-1], cout, px[0], px[1], out.shape[3],
                 0 if out_planes is None else out_planes.shape[-1], epi_i,
                 stream)
    build.check(lib, err, "dense_conv")
    LAUNCHES["dense_conv"] += 1
    return out


# -- K7q: the s8 form ---------------------------------------------------------


def dense_epilogue_s8_plain(y32: torch.Tensor, sw: torch.Tensor,
                            b: torch.Tensor, epi: str,
                            inv: Optional[torch.Tensor] = None,
                            res: Optional[torch.Tensor] = None,
                            res2: Optional[torch.Tensor] = None):
    """K7q's step after the s8 conv, in float32, each multiply and add
    rounded on its own: dq = float32(y32) * sw + b, then
      lrelu_q  (None, quant(where(dq >= 0, dq, dq * 0.2), inv));
      rdb      (z, quant(z, inv)), z = dq * 0.2 + res;
      rrdb     (z2, quant(z2, inv)), z2 = (dq * 0.2 + res) * 0.2 + res2;
      add      (res.dtype(float32(res) + dq), None).
    `inv`: the float32 tensor 1 / s_next; `res`, `res2`: y32's shape."""
    k = torch.tensor(SLOPE, dtype=torch.float32, device=y32.device)
    dq = y32.float() * sw.float() + b.float()
    if epi == "lrelu_q":
        return None, quant_s8_plain(torch.where(dq >= 0, dq, dq * k), inv)
    if epi == "add":
        return (res.float() + dq).to(res.dtype), None
    z = dq * k + res.float()
    if epi == "rrdb":
        z = z * k + res2.float()
    elif epi != "rdb":
        raise ValueError(f"unknown epilogue {epi!r}; known: {EPILOGUES_S8}")
    return z, quant_s8_plain(z, inv)


def dense_conv_s8_plain(buf8: torch.Tensor, cin: int, w8: torch.Tensor,
                        sw: torch.Tensor, b: torch.Tensor, epi: str, *,
                        inv: Optional[torch.Tensor] = None,
                        out8: Optional[torch.Tensor] = None,
                        out8_off: int = 0,
                        res: Optional[torch.Tensor] = None,
                        res2: Optional[torch.Tensor] = None,
                        out: Optional[torch.Tensor] = None) -> None:
    """The plain version of dense_conv_s8 (same arguments): the exact s32
    conv of buf8's first `cin` channels (conv3x3_s8_plain), then
    dense_epilogue_s8_plain with the first cout channels of `res`, `res2`;
    the s8 result into out8[..., out8_off:out8_off + cout], the float
    result into out[..., :cout]."""
    cout = w8.shape[-1]

    def first(t):
        return None if t is None else t[..., :cout]

    z, q = dense_epilogue_s8_plain(conv3x3_s8_plain(buf8[..., :cin], w8),
                                   sw, b, epi, inv, first(res), first(res2))
    if z is not None:
        out[..., :cout] = z
    if q is not None:
        out8[..., out8_off:out8_off + cout] = q


def pack_weights_dense_s8(w8: torch.Tensor) -> torch.Tensor:
    """s8 HWIO (3, 3, cin, cout) -> the resident B operand of K7q: (chunks,
    9, 4, cout, 16) int8 [chunk][tap][k / 16][n][16], chunks = cin / 64
    rounded up, packed[c, t, kb, n, kk] = w8[t // 3, t % 3, 64 c + 16 kb +
    kk, n] and 0 past cin (B K-major in core matrices of 8 rows x 16 B, as
    K4's pack_weights_s8 per chunk)."""
    cin, cout = w8.shape[2], w8.shape[3]
    if w8.dtype != torch.int8 or cin % CIN_STEP:
        raise ValueError(f"K7q takes int8 weights over Cin in multiples of "
                         f"{CIN_STEP}, got {w8.dtype} Cin {cin}")
    chunks = -(-cin // CHUNK_S8)
    w = torch.zeros((3, 3, chunks * CHUNK_S8, cout), dtype=torch.int8,
                    device=w8.device)
    w[:, :, :cin] = w8
    return w.reshape(9, chunks, CHUNK_S8 // 16, 16, cout) \
        .permute(1, 0, 2, 4, 3).contiguous()


def _check_s8(buf8, cin, w8, epi, inv, out8, out8_off, res, res2,
              out) -> None:
    """K7q's checks of its operands' types, shapes and overlaps."""
    if epi not in EPILOGUES_S8:
        raise ValueError(f"unknown epilogue {epi!r}; known: {EPILOGUES_S8}")
    if buf8.dtype != torch.int8 or w8.dtype != torch.int8 or \
            buf8.dim() != 4:
        raise TypeError(f"K7q takes an int8 (B, H, W, C) buffer and int8 "
                        f"weights, got {buf8.dtype} {tuple(buf8.shape)} / "
                        f"{w8.dtype}")
    cs, cout = buf8.shape[3], w8.shape[3]
    if cin % CIN_STEP or not CIN_STEP <= cin <= cs or cs % 16 or \
            tuple(w8.shape) != (3, 3, cin, cout) or cout not in COUTS:
        raise ValueError(f"K7q reads Cin channels, a multiple of "
                         f"{CIN_STEP}, "
                         f"of a buffer of a multiple of 16 and writes "
                         f"{COUTS}: got Cin {cin} of {cs}, weights "
                         f"{tuple(w8.shape)}")
    px = buf8.shape[:3]
    ops = [buf8, w8]
    if epi != "add":
        if out8 is None or out8.dtype != torch.int8 or out8.dim() != 4 or \
                out8.shape[:3] != px or out8.shape[3] % 16 or \
                out8_off % 16 or out8_off + cout > out8.shape[3]:
            # (the kernel writes them by TMA stores: 16-B aligned)
            raise ValueError(f"epilogue {epi!r} writes channels "
                             f"[{out8_off}, {out8_off + cout}) of an int8 "
                             f"({tuple(px)}, C) buffer, C a multiple of 16, "
                             f"at an offset that is a multiple of 16")
        if inv is None or inv.numel() != 1:
            raise ValueError(f"epilogue {epi!r} needs inv = 1 / s_next")
        # the conv reads buf8's first cin channels of every pixel in its
        # halos: its s8 output must lie beside them, never over them
        if _shares_storage(out8, buf8) and (
                out8.data_ptr() != buf8.data_ptr() or
                out8.shape != buf8.shape or out8_off < cin):
            raise ValueError("K7q writes into its own input only in "
                             "channels past the ones it reads "
                             "(out8_off >= cin)")
        ops.append(out8)
    if epi != "lrelu_q":
        dt = (torch.float32, torch.bfloat16) if epi == "add" \
            else (torch.float32,)
        need = (res, out) + ((res2,) if epi == "rrdb" else ())
        for t in need:
            if t is None or t.dtype not in dt or t.dtype != need[0].dtype \
                    or t.dim() != 4 or t.shape[:3] != px or \
                    t.shape[3] != cout:
                raise ValueError(f"epilogue {epi!r} needs residuals and an "
                                 f"output of ({tuple(px)}, {cout}) in "
                                 f"{' or '.join(map(str, dt))}")
        ops += need
    check_operands(*ops)


def dense_conv_s8(buf8: torch.Tensor, cin: int, w8: torch.Tensor,
                  sw: torch.Tensor, b: torch.Tensor, epi: str, *,
                  inv: Optional[torch.Tensor] = None,
                  out8: Optional[torch.Tensor] = None, out8_off: int = 0,
                  res: Optional[torch.Tensor] = None,
                  res2: Optional[torch.Tensor] = None,
                  out: Optional[torch.Tensor] = None,
                  packed: Optional[torch.Tensor] = None) -> None:
    """K7q: the s8 conv of buf8's first `cin` channels ((B, H, W, Cs)
    int8) by w8 ((3, 3, cin, cout) int8 HWIO, cout 32 or 64), dequantized
    with `sw` and `b` (cout float32 each), then the epilogue `epi`
    (EPILOGUES_S8):
      lrelu_q  s8 into out8[..., out8_off:out8_off + cout] (`inv` = the
               float32 1 / s_next; out8 may be buf8, past cin);
      rdb      float32 into `out` ((B, H, W, cout), may be `res`), s8 into
               out8 as lrelu_q; `res` the dense block's float32 input;
      rrdb     as rdb, with `res2` the RRDB's float32 input (`out` may be
               it: read and written at the same pixel);
      add      `out` = dtype(float32(res) + dq), `res` and `out` (B, H, W,
               cout) in float32 or bfloat16, usually one tensor (feat).
    `packed`: pack_weights_dense_s8(w8), packed once by the caller (here
    when None)."""
    if buf8.device.type == "cpu":
        return dense_conv_s8_plain(buf8, cin, w8, sw, b, epi, inv=inv,
                                   out8=out8, out8_off=out8_off, res=res,
                                   res2=res2, out=out)
    if buf8.device.type != "cuda":
        raise ValueError(f"tensor on {buf8.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain version)")
    _check_s8(buf8, cin, w8, epi, inv, out8, out8_off, res, res2, out)
    cout = w8.shape[3]
    dev = buf8.device
    wp = pack_weights_dense_s8(w8) if packed is None else packed
    expect = (-(-cin // CHUNK_S8), 9, CHUNK_S8 // 16, cout, 16)
    if tuple(wp.shape) != expect or wp.dtype != torch.int8 or \
            wp.device != dev or not wp.is_contiguous():
        raise ValueError(f"packed weights {tuple(wp.shape)} {wp.dtype}; "
                         f"expected {expect} int8 on {dev}")
    ss = f32_operand(sw, cout, dev, "sw")
    bb = f32_operand(b, cout, dev, "b")
    ii = None if inv is None else f32_operand(inv, 1, dev, "inv")
    B, H, W, cs = buf8.shape

    def ptr(t, off=0):
        return None if t is None else t.data_ptr() + off * t.element_size()

    lib = build.load(S8_SOURCE)
    fn = lib.reve_dense_conv_s8
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(buf8.data_ptr(), wp.data_ptr(), ss.data_ptr(), bb.data_ptr(),
             ptr(ii), ptr(res), ptr(res2), ptr(out), ptr(out8, out8_off),
             B, H, W, cin, cs, cout,
             0 if out8 is None else out8.shape[3],
             EPILOGUES_S8.index(epi),
             int(out is not None and out.dtype == torch.bfloat16),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "dense_conv_s8")
    LAUNCHES["dense_conv_s8"] += 1
