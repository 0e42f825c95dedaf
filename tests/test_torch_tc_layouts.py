"""What the tensor-core kernels take, held on the CPU: the bf16x3 split
and six-pass product of float32 K1 and K2 (csrc/conv3x3_f32_tc.cu)
against the JAX package's float32 conv and head epilogue, and the weight
packers of float32 K1/K2 and K4/K4h (csrc/conv3x3_s8.cu) against their
index formulas, at every N the kernels take (64 for the hidden convs;
16, 32, 48 for the heads at r = 2, 3, 4, zero-padded).  K3 and K4a
(csrc/conv3x3.cu): their weight packer against its index formula, an
emulation of their product (A in their K order, B as packed, bf16 or
six bf16 pairs) and epilogue (PReLU as one bf16x2 fma, the quantize by
adding 1.5 * 2^23) against reve_tpu's first conv + PReLU (+ _quant_s8).

Tolerances: the split is exact (hi + mid + lo == x); the six-pass
emulation, float32 convs of each bf16 pair summed in float32, is held to
reve_tpu's `_conv3x3` at float32 (Precision.HIGHEST) at the bound of
test_torch_kernels.py's float32 cases, atol 2e-5, rtol 1e-5, scaled by
2^8 with the inputs; through the head epilogue, u8 |d| <= 1 (a sum that
differs in its last bits may round y * 255 + 0.5 to the neighbouring
integer), on under 1% of the samples.  K3's emulation: float32 atol
2e-5, rtol 1e-5 as float32 K1's; bfloat16 within 2 bf16 ulp (the ulp
taken at 2^-10 or more) as the card tests hold the kernel; K4a's s8 codes
within 1 of the reference's.  float32 conv_last (csrc/conv_last_f32.cu):
an emulation of its sum (each lane's channels, its packed weights, the
lanes' reduction) against reve_tpu's float32 conv_last with the engine's
u8 rounding, u8 |d| <= 1 on under 1% of the samples; its walk over work
items and its ring of input rows, written out, reads each row once and
writes each output pixel once.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reve_tpu.models import rrdb as jrrdb
from reve_tpu.models import srvgg as jsrvgg
from reve_tpu_torch.kernels import LAUNCHES, build, conv3x3, conv3x3_s8, head
from reve_tpu_torch.scripts import perf_conv_tc_parts

torch.set_num_threads(2)

#: the (activation, weight) split pairs float32 K1 sums on the tensor
#: cores (csrc/conv3x3_f32_tc.cu, mma_bf16x6): every product of parts
#: above 2^-24 of the result (hi = 0, mid = 1, lo = 2)
BF16X6_PAIRS = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))


def _values(kind, rs, n=4096):
    if kind == "random":
        return (rs.standard_normal(n) * np.exp2(rs.uniform(-30, 30, n)))
    if kind == "pm2^8":
        return rs.choice([-1.0, 1.0], n) * 2.0 ** 8 * rs.uniform(1, 2, n)
    if kind == "pm2^-20":
        return rs.choice([-1.0, 1.0], n) * 2.0 ** -20 * rs.uniform(1, 2, n)
    return np.zeros(n)


@pytest.mark.parametrize("kind", ["random", "pm2^8", "pm2^-20", "zeros"])
def test_split_bf16x3_reconstructs_float32_exactly(kind):
    rs = np.random.RandomState(len(kind))
    x = torch.from_numpy(_values(kind, rs).astype(np.float32))
    s = conv3x3.split_bf16x3(x)  # a CPU tensor: the plain version
    assert s.shape == (3, x.numel()) and s.dtype == torch.bfloat16
    hi, mid, lo = s.float()
    assert torch.equal(hi + mid + lo, x)
    assert torch.equal(hi, x.to(torch.bfloat16).float())
    # each part is below half an ulp of the one before
    assert bool((mid.abs() <= hi.abs() * 2.0 ** -8).all())
    assert bool((lo.abs() <= mid.abs() * 2.0 ** -8).all())
    assert all(v == 0 for v in LAUNCHES.values())


def _inputs(seed, B=2, H=9, W=13, scale=1.0, cout=64):
    rs = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(9 * 64)
    return {
        "x": ((rs.rand(B, H, W, 64) * 2 - 0.5) * scale).astype(np.float32),
        "w": rs.uniform(-bound, bound, (3, 3, 64, cout)).astype(np.float32),
        "b": rs.uniform(-0.1, 0.1, (cout,)).astype(np.float32),
        "u8": rs.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
    }


def _conv_bf16_pairs(x, w, b, pairs):
    """float32 conv of each (activation, weight) bf16 pair of the splits,
    summed smallest first in float32, + b: the products float32 K1 sums
    on the tensor cores."""
    xs, ws = conv3x3.split_bf16x3(x), conv3x3.split_bf16x3(w)
    zero = torch.zeros(w.shape[-1])
    acc = None
    for i, j in reversed(pairs):
        t = conv3x3.conv3x3_plain(xs[i].float(), ws[j].float(), zero)
        acc = t if acc is None else acc + t
    return acc + b


@pytest.mark.parametrize("scale", [1.0, 2.0 ** 8])
def test_bf16x6_product_matches_jax_float32_conv(scale):
    d = _inputs(3, scale=scale)
    want = np.asarray(jsrvgg._conv3x3(jnp.asarray(d["x"]),
                                      jnp.asarray(d["w"]),
                                      jnp.asarray(d["b"])))
    got = _conv_bf16_pairs(torch.from_numpy(d["x"]), torch.from_numpy(d["w"]),
                           torch.from_numpy(d["b"]), BF16X6_PAIRS)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * scale,
                               rtol=1e-5)


@pytest.mark.parametrize("scale", [1.0, 2.0 ** 8])
@pytest.mark.parametrize("r", [2, 3, 4])
def test_bf16x6_head_matches_jax_float32_head(r, scale):
    """float32 K2's six-pass product at 3r^2 outputs, then the head
    epilogue, against reve_tpu's float32 `_conv3x3` + `_epilogue(
    quantize_u8=True)` (the pixel shuffle included)."""
    d = _inputs(10 + r, scale=scale, cout=3 * r * r)
    h = np.maximum(d["x"], 0) * 0.5  # a hidden activation, as K1 hands it
    cfg = jsrvgg.SRVGGConfig(num_feat=64, num_conv=1, upscale=r)
    orig = jnp.asarray(d["u8"]).astype(jnp.float32) * (1.0 / 255.0)
    want = np.asarray(jsrvgg._epilogue(
        jsrvgg._conv3x3(jnp.asarray(h), jnp.asarray(d["w"]),
                        jnp.asarray(d["b"])), orig, cfg, quantize_u8=True))
    hv = _conv_bf16_pairs(torch.from_numpy(h), torch.from_numpy(d["w"]),
                          torch.from_numpy(d["b"]), BF16X6_PAIRS)
    got = head.residual_u8_plain(hv, torch.from_numpy(d["u8"]), r).numpy()
    assert got.shape == want.shape == (2, 9 * r, 13 * r, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01, (diff > 0).mean()
    if scale == 1.0:  # not clipped flat: the comparison has something
        assert np.unique(want).size > 64


def test_bf16_alone_is_not_float32():
    """The hi.hi product alone (a bf16 conv) misses the tolerance the six
    passes meet: the split is what carries float32 accuracy."""
    d = _inputs(4)
    want = np.asarray(jsrvgg._conv3x3(jnp.asarray(d["x"]),
                                      jnp.asarray(d["w"]),
                                      jnp.asarray(d["b"])))
    got = _conv_bf16_pairs(torch.from_numpy(d["x"]), torch.from_numpy(d["w"]),
                           torch.from_numpy(d["b"]), ((0, 0),))
    assert np.abs(got.numpy() - want).max() > 1e-3


#: output channels -> the N the kernels run at: the hidden convs (64) and
#: the heads at r = 2, 3, 4 (3r^2 padded to a multiple of 8)
COUTS = {64: 64, 12: 16, 27: 32, 48: 48}


@pytest.mark.parametrize("cout", sorted(COUTS))
def test_bf16x3_weight_packer_matches_its_index_formula(cout):
    rs = np.random.RandomState(5)
    n_pad = COUTS[cout]
    assert conv3x3.padded_n(cout) == n_pad
    w = torch.from_numpy(rs.standard_normal((3, 3, 64, cout)).astype(
        np.float32))
    p = conv3x3.pack_weights_bf16x3(w)
    s = conv3x3.split_bf16x3(w)
    assert p.shape == (9, 3, 8, n_pad, 8) and p.dtype == torch.bfloat16
    assert p.is_contiguous()
    for t, sp, kb, n, kk in zip(*(rs.randint(0, m, 500)
                                  for m in (9, 3, 8, n_pad, 8))):
        want = s[sp, t // 3, t % 3, 8 * kb + kk, n] if n < cout else 0
        assert p[t, sp, kb, n, kk] == want
    # the padded outputs are zero in every tap, split and k
    assert not p[:, :, :, cout:].any()


@pytest.mark.parametrize("cout", sorted(COUTS))
def test_s8_weight_packer_matches_its_index_formula(cout):
    rs = np.random.RandomState(6)
    n_pad = COUTS[cout]
    w8 = torch.from_numpy(rs.randint(-127, 128, (3, 3, 64, cout)).astype(
        np.int8))
    p = conv3x3_s8.pack_weights_s8(w8)
    assert p.shape == (9, 4, n_pad, 16) and p.dtype == torch.int8
    flat = p.reshape(-1)
    for t, kb, n, kk in zip(*(rs.randint(0, m, 500)
                              for m in (9, 4, n_pad, 16))):
        want = w8[t // 3, t % 3, 16 * kb + kk, n] if n < cout else 0
        assert p[t, kb, n, kk] == want
        # as [k / 16][n][16] bytes, k = tap * 64 + ci
        k = t * 64 + 16 * kb + kk
        assert flat[((k // 16) * n_pad + n) * 16 + k % 16] == \
            p[t, kb, n, kk]
    assert not p[:, :, cout:].any()
    if cout == 64:  # K4's packing: the layout it always had
        assert torch.equal(p, w8.reshape(9, 4, 16, 64).permute(0, 1, 3, 2))


def test_every_header_is_in_the_build_key():
    """Each csrc/*.cuh is hashed into every library's name (tc.cuh, the
    tensor-core kernels' shared header, among them), and the tensor-core
    sources are built."""
    on_disk = {f for f in os.listdir(build.CSRC) if f.endswith(".cuh")}
    assert on_disk == set(build.HEADERS)
    assert {conv3x3.TC_SOURCE, conv3x3.F32_SOURCE,
            conv3x3_s8.SOURCE} <= set(build.SOURCES)


@pytest.mark.parametrize("source, entries", [
    ("conv3x3.cu", ("reve_conv3x3_u8_bias_prelu",
                    "reve_conv3x3_u8_bias_prelu_q8")),
    ("conv3x3_tc.cu", ("reve_conv3x3_bias_prelu_tc",
                       "reve_head_conv_residual_u8_shuffle_tc")),
    ("conv3x3_f32_tc.cu", ("reve_split_bf16x3",
                           "reve_conv3x3_bias_prelu_f32tc",
                           "reve_head_conv_residual_u8_shuffle_f32tc")),
    ("conv3x3_s8.cu", ("reve_conv3x3_s8_dq_prelu_q8",
                       "reve_head_conv_s8_residual_u8_shuffle_tc")),
])
def test_heads_live_beside_their_hidden_convs(source, entries):
    """Each head is its source's mainloop with the head epilogue: the
    source defines the C entry the wrapper calls, the kernel is one
    template on R, and the head epilogue is tc.cuh's, shared."""
    with open(os.path.join(build.CSRC, source)) as f:
        src = f.read()
    for entry in entries:
        assert f'extern "C" int {entry}(' in src
    # every conv is on the tensor cores: no CUDA-core form is left
    assert "Wgmma" in src
    assert "fmaf(" not in src and "__dp4a" not in src
    if "head" in " ".join(entries):
        assert "HeadEpilogue<R>" in src and "residual_u8(" not in src


@pytest.mark.parametrize("source", sorted(perf_conv_tc_parts.PATCHES))
def test_parts_script_variants_still_apply(source):
    """Every variant of the parts timer finds the text it replaces once in
    the source, so the script keeps timing the kernel as it is."""
    with open(os.path.join(build.CSRC, source)) as f:
        original = f.read()
    for variant in perf_conv_tc_parts.PATCHES[source]:
        text = perf_conv_tc_parts.variant_source(source, variant,
                                                 strict=True)
        assert (text == original) == (variant == "full")
    if source == conv3x3.SOURCE:  # K3/K4a: stores alone, wgmmas alone
        assert {"stores_only", "no_load_no_epi", "full"} <= set(
            perf_conv_tc_parts.PATCHES[source])
    if source == perf_conv_tc_parts.WIDE:
        # the resident kernel's parts, the resident K1 forms on the
        # streamed kernel and float32 K2 at x2 on the resident one
        assert {"no_load", "no_mma", "no_epi", "weights_only", "streamed",
                "resident", "full"} == set(perf_conv_tc_parts.PATCHES[source])
        # each part taken out of the resident kernel and the streamed one
        # alike (the wide K2 runs on both, by form)
        for variant, marks in (
                ("no_load", ("if (gh < UNITS)", "if (hu < UNITS)")),
                ("no_mma", ("acc[s][kc] += a_rows;", "acc[kc] += a;",
                            "acc[kc] += af[kc][0][0];",
                            "acc[s][kc] += af[kc][s][0][0]")),
                ("no_epi", ("keep += acc[s][0]", "acc[0] + cor[0] == 0.5f"))):
            text = perf_conv_tc_parts.variant_source(source, variant)
            assert all(m in text and m not in original for m in marks)
        assert "mma_step<K>(" not in perf_conv_tc_parts.variant_source(
            source, "weights_only")
        assert "res_step_regs<K>(" not in perf_conv_tc_parts.variant_source(
            source, "no_mma").split("void res_step_regs(")[1]
    if source == perf_conv_tc_parts.S8_WIDE:
        # the wide K4's and K4h's parts, on texts the parent's kernel has
        # too, and the teams' kernel at other shapes
        for variant, mark in (("no_load", "if (hu >= UNITS) continue;"),
                              ("no_load", "if (hu < UNITS) mbar_wait("),
                              ("no_mma", "no_mma(\n"),
                              ("no_epi", "keep(acc) == 12345")):
            text = perf_conv_tc_parts.variant_source(source, variant)
            assert mark in text and mark not in original
        assert "WgmmaS8<N>::mma(" not in perf_conv_tc_parts.variant_source(
            source, "no_mma")
        shapes = [v for v in perf_conv_tc_parts.PATCHES[source]
                  if re.search(r"_t\d+w\d+r\d+h\d+", v)]
        assert shapes
        for variant in shapes:
            text = perf_conv_tc_parts.variant_source(source, variant)
            # one shape replaced, the one it replaced left unused
            assert text.count("struct S8Shape") == original.count(
                "struct S8Shape")
            assert re.search(r"\nstruct Was\w+ : Shape<[\d, ]+> \{\};",
                             text)
        # the epilogues as first written: parameters in shared memory,
        # K4's quantize by conversion
        for variant, mark in (("params_smem", "int PJ = 1;"),
                              ("k4_quant_cvt", "reve::quant_s8(v0, inv)")):
            assert mark in perf_conv_tc_parts.variant_source(source, variant)


def _conv_last_f32_constants() -> dict:
    """The schedule constants of csrc/conv_last_f32.cu, read from it."""
    with open(os.path.join(build.CSRC, head.LAST_F32_SOURCE)) as f:
        src = f.read()
    return {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
            for n in ("TW", "ROWS", "SEG", "SLOTS", "P")}


def _conv_last_f32_weights(w: torch.Tensor) -> torch.Tensor:
    """The weights as conv_last_f32.cu packs them in shared memory: i =
    ((((half * 3 + dy) * 3 + dx) * 3 + c) * 8 + q) * 4 + k holds w[dy][dx]
    [32 half + 4 q + k][c] (the kernel's own formula, written out)."""
    out = torch.empty(1728)
    for i in range(1728):
        k, q, t = i & 3, (i >> 2) & 7, i >> 5
        c, t = t % 3, t // 3
        dx, t = t % 3, t // 3
        dy, half = t % 3, t // 3
        out[i] = w[dy, dx, 32 * half + 4 * q + k, c]
    return out


def _conv_last_f32_emulated(x: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """conv_last_f32.cu's sum in float32 (each product rounded, where the
    kernel fuses it into its add): lane q of a pixel's 8 lanes sums
    channels 32 half + 4 q + k over dy, half, dx and k in that order,
    reading the weights where the kernel reads them in the packed array;
    the lanes' sums meet as ((a0 + a4) + (a2 + a6)) + ((a1 + a5) + (a3 +
    a7)) (the shuffle rounds 4, 2, 1); + b; the u8 rounding."""
    B, H, W, _ = x.shape
    packed = _conv_last_f32_weights(w)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    q = torch.arange(8)
    a = torch.zeros(8, B, H, W, 3)
    for dy in range(3):
        for half in range(2):
            for dx in range(3):
                for c in range(3):
                    base = ((half * 3 + dy) * 9 + dx * 3 + c) * 32
                    for k in range(4):
                        ch = 32 * half + 4 * q + k
                        xs = xp[:, dy:dy + H, dx:dx + W, ch].permute(
                            3, 0, 1, 2)
                        a[..., c] += xs * packed[base + 4 * q + k][
                            :, None, None, None]
    y = ((a[0] + a[4]) + (a[2] + a[6])) + ((a[1] + a[5]) + (a[3] + a[7]))
    return torch.clamp((y + b) * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


@pytest.mark.parametrize("scale", [1.0, 2.0 ** 8])
def test_conv_last_f32_sum_matches_jax_float32_conv_last(scale):
    """float32 conv_last's channel split over the lanes, its packed
    weights and its reduction, emulated, against reve_tpu's float32
    conv_last (rrdb._conv) with the engine's u8 rounding: u8 |d| <= 1 (a
    sum that differs in its last bits may round y * 255 + 0.5 to the
    neighbouring integer), on under 1% of the samples."""
    d = _inputs(20, B=2, H=9, W=27, cout=3)
    h = d["x"] * 2 - 1
    h, w = (h * scale).astype(np.float32), (d["w"] * 2 / scale).astype(
        np.float32)
    b = (d["b"] + 0.45).astype(np.float32)
    y = jrrdb._conv(jnp.asarray(h), {"w": jnp.asarray(w),
                                     "b": jnp.asarray(b)}, jnp.float32)
    want = np.asarray(jnp.clip(y.astype(jnp.float32) * 255.0 + 0.5, 0.0,
                               255.0).astype(jnp.uint8))
    got = _conv_last_f32_emulated(torch.from_numpy(h), torch.from_numpy(w),
                                  torch.from_numpy(b)).numpy()
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01, (diff > 0).mean()
    assert np.unique(want).size > 64  # not clipped flat


@pytest.mark.parametrize("B, H, W", [(1, 1, 1), (1, 5, 64), (2, 64, 65),
                                     (1, 130, 129), (3, 67, 200)])
def test_conv_last_f32_schedule_reads_each_row_once(B, H, W):
    """conv_last_f32.cu's walk, written out as its producer and consumer
    loops run it on each block of a grid smaller than the work: the
    producer loads each item's rows y0 - 1 .. y0 + ROWS steps once, in
    ring order; each step's window of ROWS + 2 rows holds the input rows
    its output rows need; the ring never holds more than SLOTS rows a
    step still needs; every row is released once; every output pixel is
    written once."""
    k = _conv_last_f32_constants()
    TW, ROWS, SEG, SLOTS = k["TW"], k["ROWS"], k["SEG"], k["SLOTS"]
    strips, segs = -(-W // TW), -(-H // SEG)
    count = B * segs * strips
    written = np.zeros((B, H, W), np.int32)
    for grid in (1, 3):
        written[:] = 0
        for block in range(min(grid, count)):
            loaded, released = [], 0  # the block's row sequence
            items = range(block, count, grid)
            for item in items:  # the producer
                b, rem = divmod(item, segs * strips)
                y0, x0 = rem // strips * SEG, rem % strips * TW
                steps = -(-min(SEG, H - y0) // ROWS)
                loaded += [(b, y0 - 1 + i, x0)
                           for i in range(ROWS * steps + 2)]
            g0 = 0
            for item in items:  # the consumers
                b, rem = divmod(item, segs * strips)
                y0, x0 = rem // strips * SEG, rem % strips * TW
                steps = -(-min(SEG, H - y0) // ROWS)
                for st in range(steps):
                    gs = g0 + ROWS * st
                    assert gs + ROWS + 2 - released <= SLOTS
                    for r in range(ROWS):
                        oy = y0 + ROWS * st + r
                        for dy in range(3):
                            assert loaded[gs + r + dy] == (b, oy - 1 + dy,
                                                           x0)
                        if oy < H:
                            written[b, oy, x0:x0 + TW] += 1
                    assert released == gs
                    released += ROWS if st + 1 < steps else ROWS + 2
                g0 += ROWS * steps + 2
            assert released == len(loaded)
        assert (written == 1).all()
    assert k["P"] * 4 * 2 == TW  # a warp's 4 pixel groups: half a strip


def test_split_pass_refuses_non_cuda_devices():
    x = torch.empty((1, 2, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3.split_bf16x3(x)
    assert all(v == 0 for v in LAUNCHES.values())
    assert not build._libs


#: the compute dtypes of K3 and K4a: (JAX dtype, torch dtype)
U8_DTYPES = {"float32": (jnp.float32, torch.float32),
             "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("name", sorted(U8_DTYPES))
def test_u8conv_weight_packer_matches_its_index_formula(name):
    """K3/K4a's B: row k = 10 dx + 3 dy + c holds tap (dy, dx), channel
    c (taps column by column, each column of 9 padded to 10); rows 9, 19
    and 29..31 are zero.  bfloat16 packs the weights as they are, float32
    their three bf16 splits."""
    tdt = U8_DTYPES[name][1]
    rs = np.random.RandomState(7)
    w = torch.from_numpy(rs.standard_normal((3, 3, 3, 64)).astype(
        np.float32)).to(tdt)
    p = conv3x3.pack_weights_u8conv(w)
    planes = w[None] if tdt == torch.bfloat16 else conv3x3.split_bf16x3(w)
    assert p.dtype == torch.bfloat16 and p.is_contiguous()
    assert p.shape == (planes.shape[0], 4, 64, 8)
    real = {conv3x3.u8conv_k(dy, dx, c): (dy, dx, c)
            for dy in range(3) for dx in range(3) for c in range(3)}
    assert len(real) == 27 and max(real) < conv3x3.U8_K
    assert set(range(conv3x3.U8_K)) - set(real) == {9, 19, 29, 30, 31}
    for s in range(p.shape[0]):
        for kb in range(4):
            for kk in range(8):
                k = 8 * kb + kk
                if k in real:
                    dy, dx, c = real[k]
                    assert torch.equal(p[s, kb, :, kk], planes[s, dy, dx, c])
                else:
                    assert not p[s, kb, :, kk].any()


def _u8conv_emulation(u8, w, b, alpha, inv=None):
    """The product and epilogue of K3 (inv None) or K4a on the CPU: A as
    the kernel stages it (bf16(u8 / 255), or float32 u8 / 255 as its bf16
    hi, mid, lo) in the kernel's K order, B as pack_weights_u8conv lays it
    out, float32 sums (float32: the pairs of BF16X6_PAIRS, smallest first),
    + b in float32, the cast, PReLU as max(f, 0) + alpha * min(f, 0) in one
    rounding, and K4a's quantize as the kernel does it: clip, then add
    1.5 * 2^23, whose float32 sum's low byte is the code."""
    dt = w.dtype
    B, H, W, _ = u8.shape
    x = u8.float() * (1.0 / 255.0)
    planes = x.to(torch.bfloat16)[None] if dt == torch.bfloat16 \
        else conv3x3.split_bf16x3(x)
    xp = torch.nn.functional.pad(planes, (0, 0, 1, 1, 1, 1))
    cols = torch.zeros(planes.shape[0], B, H, W, conv3x3.U8_K)
    for dy in range(3):
        for dx in range(3):
            for c in range(3):
                cols[..., conv3x3.u8conv_k(dy, dx, c)] = \
                    xp[:, :, dy:dy + H, dx:dx + W, c].float()
    bp = conv3x3.pack_weights_u8conv(w).permute(0, 1, 3, 2).reshape(
        -1, conv3x3.U8_K, 64).float()
    pairs = ((0, 0),) if dt == torch.bfloat16 else BF16X6_PAIRS
    acc = None
    for i, j in reversed(pairs):
        t = cols[i] @ bp[j]
        acc = t if acc is None else acc + t
    f = (acc + b).to(dt).double()
    a = alpha.to(dt).double()
    h = (f.clamp_min(0) + a * f.clamp_max(0)).to(dt)  # one rounding
    if inv is None:
        return h
    v = (h.float() * inv).clamp(-127, 127) + 12582912.0
    code = (v.view(torch.int32) & 0xFF).to(torch.uint8)
    return code.view(torch.int8)


@pytest.mark.parametrize("q8", [False, True], ids=["k3", "k4a"])
@pytest.mark.parametrize("name", sorted(U8_DTYPES))
def test_u8conv_emulation_matches_jax_first_conv(name, q8):
    jdt, tdt = U8_DTYPES[name]
    rs = np.random.RandomState(11 + q8)
    u8 = rs.randint(0, 256, (2, 9, 13, 3)).astype(np.uint8)
    w = rs.uniform(-0.3, 0.3, (3, 3, 3, 64)).astype(np.float32)
    b = rs.uniform(-0.1, 0.1, 64).astype(np.float32)
    alpha = rs.uniform(0.05, 0.4, 64).astype(np.float32)
    x = jnp.asarray(u8).astype(jnp.float32) * (1.0 / 255.0)
    want = jsrvgg._prelu(jsrvgg._conv3x3(
        x.astype(jdt), jnp.asarray(w).astype(jdt), jnp.asarray(b)),
        jnp.asarray(alpha))
    scale = np.float32(0.01)
    inv = torch.tensor([1.0], dtype=torch.float32) / torch.tensor(
        [scale], dtype=torch.float32)
    got = _u8conv_emulation(torch.from_numpy(u8),
                            torch.from_numpy(w).to(tdt), torch.from_numpy(b),
                            torch.from_numpy(alpha), inv if q8 else None)
    if q8:
        want = np.asarray(jsrvgg._quant_s8(want, jnp.float32(scale)))
        d = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() < 0.01
        assert np.unique(want).size > 64 and (np.abs(want) == 127).any()
        return
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    g = got.float().numpy()
    if name == "float32":
        np.testing.assert_allclose(g, want, atol=2e-5, rtol=1e-5)
    else:
        mag = np.maximum(np.maximum(np.abs(g), np.abs(want)), 2.0 ** -10)
        ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
        assert (np.abs(g - want) <= 2 * ulp).all()


def _k4a_shapes() -> dict:
    """{feat: (TH, BLOCKS, UNROLL)} of the wide K4a forms
    (csrc/conv3x3.cu's Q8Shape specialisations), read from the source."""
    with open(os.path.join(build.CSRC, conv3x3.SOURCE)) as f:
        src = f.read()
    return {int(m.group(1)): tuple(int(v) for v in m.group(2).split(", "))
            for m in re.finditer(r"struct Q8Shape<(\d+)> : RowShape<"
                                 r"([\d, ]+)> \{\};", src)}


def _k4a_slots(th: int) -> int:
    """RowGeo<TH>::SLOTS, the values of a staged halo pixel (a copy)."""
    return 24 if 3 * th + 10 < 24 else 40


#: the wide K4a's shapes: each form's, and each that the parts script
#: sweeps (perf_conv_tc_parts._ROWS_SWEEP)
_K4A_SHAPES = sorted(
    {(f, tuple(int(v) for v in sh.split(", ")))
     for f, shapes in perf_conv_tc_parts._ROWS_SWEEP.items()
     for sh in shapes} | set(_k4a_shapes().items()))


def test_wide_k4a_forms_each_have_a_shape():
    assert sorted(_k4a_shapes()) == [32, 96, 128]


@pytest.mark.parametrize("feat,shape", _K4A_SHAPES,
                         ids=[f"{f}-{'x'.join(map(str, s))}"
                              for f, s in _K4A_SHAPES])
def test_wide_k4a_shape_fits_the_sm(feat, shape):
    """A wide K4a shape's budgets as conv3x3.cu's U8 states them: the
    registers __launch_bounds__ leaves a thread x 128 threads x BLOCKS
    within the SM's 65,536, and at least what a thread's live arrays hold
    (two accumulator sets of a channel chunk, two A sets, the bias and the
    bf16 alpha pairs); the blocks' shared memory (the staged tile of TH
    rows, the packed weights, raw words, two halo copies, the table, and
    the 1 KB the card reserves a block) within the SM's 228 KB; rows in
    pairs, the tile 1-KB aligned, the pairs unrolled or looped."""
    th, blocks, unroll = shape
    nc = 64 if feat % 64 == 0 else 32
    regs = 65536 // (128 * blocks) // 8 * 8
    assert regs * 128 * blocks <= 65536
    assert 2 * nc // 2 + 2 * 8 + feat // 4 + feat // 8 <= regs
    slots = _k4a_slots(th)
    assert 3 * th + 10 < slots and slots // 2 % 8 == 4
    tile = th * 64 * feat
    smem = (tile + 32 * feat * 2 + (th + 2) * 256 + 2 * 66 * slots * 2
            + 256 * 2 + 16)
    assert (smem + 1024) * blocks <= 228 * 1024
    assert th % 2 == 0 and tile % 1024 == 0 and unroll in (0, 1)


@pytest.mark.parametrize("th", [2, 4, 8])
def test_wide_k4a_rows_read_their_windows_from_the_staged_halo(th):
    """The wide K4a's halo (RowGeo) and A reads, written out: value (u8
    row r, pixel u, channel c) staged at slot u SLOTS + 3 r + c of copy 0
    and one slot later in copy 1; thread (pa, q)'s register r of k16 step
    kc for output row i read as conv3x3.cu's a_frags reads it.  Every
    read is 4-B aligned and inside its copy, the eight pixels x four q of
    a warp fall on at most two words a bank (on distinct banks where all
    four q read one tap column: k 0..7 and 24..31), and each k of a
    nonzero weight
    (k = 10 dx + 3 dy + c) reads the value of row i + dy, pixel p + dx,
    channel c (k 9, 19, 29..31 read finite values)."""
    slots = _k4a_slots(th)
    copy = 66 * slots
    val = np.full(2 * copy, -1.0)  # pad slots (zeros in the kernel)
    want = {}
    for r in range(th + 2):
        for u in range(66):
            for c in range(3):
                v = 1000 * r + 3 * u + c
                want[r, u, c] = v
                val[u * slots + 3 * r + c] = v
                val[copy + u * slots + 3 * r + c + 1] = v
    real = {conv3x3.u8conv_k(dy, dx, c): (dy, dx, c)
            for dy in range(3) for dx in range(3) for c in range(3)}
    for i in range(th):
        row = ((i & 1) * copy + 3 * i + (i & 1)) * 2
        for w in range(4):
            for kc in range(2):
                for r in range(4):
                    words = []
                    for lane in range(32):
                        pa, q = 16 * w + lane // 4, lane % 4
                        dxs = [min((8 * j + 2 * q) // 10, 2)
                               for j in range(4)]
                        dxo = [(slots - 10) * d * 2 for d in dxs]
                        addr = ((pa * slots + 2 * q) * 2 + row
                                + ((r & 1) * 8 * slots + 16 * kc
                                   + 8 * (r >> 1)) * 2
                                + dxo[2 * kc + (r >> 1)])
                        assert addr % 4 == 0
                        lo = (i & 1) * copy * 2
                        assert lo <= addr and addr + 4 <= lo + copy * 2
                        words.append(addr // 4)
                        p = pa + 8 * (r & 1)
                        for e in range(2):
                            k = 16 * kc + 8 * (r >> 1) + 2 * q + e
                            got = val[addr // 2 + e]
                            if k in real:
                                dy, dx, c = real[k]
                                assert got == want[i + dy, p + dx, c], (
                                    i, p, k)
                    banks = {}
                    for word in words:
                        banks.setdefault(word % 32, set()).add(word)
                    ways = max(len(s) for s in banks.values())
                    assert ways <= (1 if kc == r >> 1 else 2)


def test_quantize_by_adding_1p5_2p23_is_round_half_even_clipped():
    """K4a's quantize: clip(t, +-127) + 1.5 * 2^23 in float32 has the code
    clip(rint(t), +-127) in its low byte, ties to even, at the halves,
    their neighbours, the clip bounds and far past them."""
    rs = np.random.RandomState(3)
    halves = np.arange(-130, 131) + 0.5
    t = np.concatenate([
        halves, np.nextafter(halves, np.inf, dtype=np.float32),
        np.nextafter(halves, -np.inf, dtype=np.float32),
        rs.uniform(-200, 200, 4096), [0.0, -0.0, 127.0, -127.0, 3e38,
                                      -3e38, 1e-30, -1e-30]]).astype(
                                          np.float32)
    v = np.clip(t, np.float32(-127), np.float32(127)) + np.float32(12582912)
    got = (v.view(np.int32) & 0xFF).astype(np.uint8).view(np.int8)
    want = np.clip(np.rint(t), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(got, want)


def test_prelu_as_one_bf16_fma_matches_the_plain_prelu():
    """K3/K4a's bf16 PReLU, alpha * min(f, 0) + max(f, 0) rounded once,
    equals the plain version's max(f, 0) + bf16(alpha * min(f, 0))."""
    rs = np.random.RandomState(4)
    f = torch.from_numpy(rs.standard_normal(65536).astype(
        np.float32) * np.exp2(rs.uniform(-20, 8, 65536)).astype(
            np.float32)).to(torch.bfloat16)
    alpha = torch.from_numpy(rs.uniform(0.01, 0.5, 65536).astype(
        np.float32)).to(torch.bfloat16)
    fd, ad = f.double(), alpha.double()
    fma = (ad * fd.clamp_max(0) + fd.clamp_min(0)).to(torch.bfloat16)
    assert torch.equal(fma.float(), conv3x3.prelu_plain(f, alpha).float())
