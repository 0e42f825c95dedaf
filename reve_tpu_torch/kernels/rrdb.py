"""K7 `dense_conv`: RRDBNet's dense-block conv with the elementwise step
after it (csrc/rrdb.cu), in bfloat16 and float32, with its plain version
and its weight packing.

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
products of operands split in three (never TF32): the split pass over
the channels the conv reads (`split_bf16x3` on the channel slice), then
the conv.

Rounding points follow the JAX reference: weights in the compute dtype,
float32 accumulation + b in float32, cast to the compute dtype, then each
step of the epilogue in the compute dtype with 0.2 cast to it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from reve_tpu_torch.kernels import LAUNCHES, build
from reve_tpu_torch.kernels.conv3x3 import (check_operands, conv3x3_plain,
                                            f32_operand, split_bf16x3,
                                            split_bf16x3_plain)

SOURCE = "rrdb.cu"
#: input channels per chunk of K7's mainloop (one TMA box, one 64-B A row)
CHUNK = 32
#: K7's output channel counts (the wgmma N): a growth slice, nf
COUTS = (32, 64)
#: the epilogue forms, in the kernel's numbering
EPILOGUES = ("lrelu", "rdb", "rrdb", "add")
#: the dense blocks' leaky-ReLU slope and residual scale
SLOPE = 0.2
_DTYPES = (torch.float32, torch.bfloat16)


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
                     res2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[..., out_off:out_off + cout] = epilogue(dtype(conv3x3(buf[...,
    :cin], w) + b)), with the first cout channels of `res` and `res2`;
    returns out."""
    cout = w.shape[-1]
    y = conv3x3_plain(buf[..., :cin], w, b)
    y = dense_epilogue_plain(
        y, epi, None if res is None else res[..., :cout],
        None if res2 is None else res2[..., :cout])
    out[..., out_off:out_off + cout] = y
    return out


def pack_weights_dense(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, cin, cout) in the compute dtype -> the B operand K7
    streams: (cin / 32, 9, S, 4, cout, 8) bfloat16 [chunk][tap][split][k /
    8][n][8], packed[c, t, s, kb, n, kk] = planes[s, t // 3, t % 3, 32 c +
    8 kb + kk, n] (B K-major in core matrices of 8 rows x 16 B).
    bfloat16: S = 1, the weights as they are; float32: S = 3,
    split_bf16x3's hi, mid, lo."""
    cin, cout = w.shape[2], w.shape[3]
    if cin % CHUNK:
        raise ValueError(f"K7 reads Cin in chunks of {CHUNK}, got {cin}")
    planes = w[None] if w.dtype == torch.bfloat16 else split_bf16x3_plain(w)
    s = planes.shape[0]
    t = planes.reshape(s, 9, cin // CHUNK, CHUNK // 8, 8, cout)
    return t.permute(2, 1, 0, 3, 5, 4).contiguous()


# -- kernel wrapper -----------------------------------------------------------


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


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
    if cin % CHUNK or not CHUNK <= cin <= cs or cs % 8 or \
            tuple(w.shape) != (3, 3, cin, cout) or cout not in COUTS:
        raise ValueError(f"K7 reads Cin channels in chunks of {CHUNK} of a "
                         f"buffer of a multiple of 8 and writes {COUTS}: "
                         f"got Cin {cin} of {cs}, weights {tuple(w.shape)}")
    if out_off % 8 or out_off + cout > out.shape[3]:
        raise ValueError(f"K7 writes channels [{out_off}, {out_off + cout}) "
                         f"of {out.shape[3]}: the offset must be a multiple "
                         f"of 8 inside the pixel")
    if epi not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epi!r}; known: {EPILOGUES}")
    need = {"lrelu": (), "rdb": (res,), "add": (res,),
            "rrdb": (res, res2)}[epi]
    for r in need:
        if r is None or r.dtype != w.dtype or r.dim() != 4 or \
                r.shape[:3] != buf.shape[:3] or r.shape[3] < cout:
            raise ValueError(f"epilogue {epi!r} needs residuals of "
                             f"({tuple(buf.shape[:3])}, >= {cout}) "
                             f"{w.dtype}")
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
               packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7: the conv of buf's first `cin` channels ((B, H, W, Cs) in the
    compute dtype) by w ((3, 3, cin, cout) HWIO, cout 32 or 64), + b in
    float32, cast, then the epilogue `epi` (EPILOGUES) with the first cout
    channels of `res` and `res2`, into out[..., out_off:out_off + cout];
    returns out.  `packed`: pack_weights_dense(w), packed once by the
    caller (packed here when None).  float32 launches two kernels: the
    split pass over buf's first cin channels and the bf16x6 conv."""
    if buf.device.type == "cpu":
        return dense_conv_plain(buf, cin, w, b, out, out_off, epi, res, res2)
    if buf.device.type != "cuda":
        raise ValueError(f"tensor on {buf.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors take the plain version)")
    _check(buf, cin, w, out, out_off, epi, res, res2)
    cout = w.shape[3]
    wp = pack_weights_dense(w) if packed is None else packed
    expect = (cin // CHUNK, 9, 1 if w.dtype == torch.bfloat16 else 3,
              CHUNK // 8, cout, 8)
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
    if w.dtype == torch.bfloat16:
        fn = lib.reve_dense_conv_tc
        x, ints = buf, [cin, cs, cout]
    else:
        # the planes stay referenced until the launch is enqueued
        fn = lib.reve_dense_conv_f32tc
        x, ints = split_bf16x3(buf[..., :cin]), [cin, cout]
    fn.argtypes = [ctypes.c_void_p] * 6 + \
        [ctypes.c_int] * (3 + len(ints) + 4) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), wp.data_ptr(), bb.data_ptr(), ptr(res), ptr(res2),
             out.data_ptr() + out_off * elem, B, H, W, *ints, px[0], px[1],
             out.shape[3], EPILOGUES.index(epi), stream)
    build.check(lib, err, "dense_conv")
    LAUNCHES["dense_conv"] += 1
    return out
