"""The arithmetic of T1, T2 and T3 on the tensor cores
(csrc/conv3x3_train_tc.cu), emulated in torch on the CPU, held against the
plain versions and against reve_tpu's gradients; the wrappers' index
helpers against their formulas; and, on synthetic SASS and ptxas
reports, the SASS check and the spill reader that chip_smoke.py's build
phase runs.

The kernels cannot run here, so this file holds what they compute: each
float32 operand split into bf16 hi, mid and lo; the six products hi.hi,
hi.mid, mid.hi, hi.lo, lo.hi and mid.mid summed in float32, hi.hi in a
sum of its own added to the other five's at the end; T2's A operand dz
at the mirrored taps (output pixel q reads dz(q - o_t)) against the
weights as they lie (B[co][ci] = W[t][ci][co]), its d(alpha) summed a
2 x 64 tile at a time and the tiles' partials in tile order; T3's hi.hi
flushed into a float32 sum after every 2 x 64 tile, its splits (runs of
tiles, `kernels.train.wgrad_splits`) summed in split order, and db
summed apart from dz.  The card tests (test_torch_kernels_cuda.py) hold
the kernels to the plain versions.

Tolerances: the split's parts sum back to the value within 2^-24 of it
(lo keeps the bits below hi's and mid's 16; values from 1e-20 to 1e20,
where lo is no subnormal); the six products within
2^-20 of sum |x| |w| of the float64 product (the three left out are
each below 2^-24 of it; float32 sums of at most 1,152 terms add the
rest); the emulated T1, T2 and T3 within 1e-5 of the largest |value| of
the plain float32 versions and of reve_tpu's `_conv3x3` + `_prelu` and
its `jax.value_and_grad` and `jax.vjp` gradients (float32 sums in other
orders: the card tests' gate).
"""

import math
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from reve_tpu.models import srvgg as jsrvgg
from reve_tpu_torch.kernels import train

torch.set_num_threads(2)

PAIRS = list(train.PAIRS)
CINS = sorted({ci for ci, _ in PAIRS})
#: 2 images of 5 x 70: a ragged tile row and a ragged tile column
SHAPE = (2, 5, 70)
REL = 1e-5


def _inputs(cin, cout, seed=0):
    B, H, W = SHAPE
    rs = np.random.RandomState(seed + 100 * cin + cout)
    bound = 1.0 / np.sqrt(9 * cin)
    z_prev = rs.randn(B, H, W, cin)
    z_prev[rs.rand(B, H, W, cin) < 0.05] = 0.0  # PReLU's tie
    return {"x": (rs.rand(B, H, W, cin) * 2 - 0.5).astype(np.float32),
            "w": rs.uniform(-bound, bound, (3, 3, cin, cout)).astype(
                np.float32),
            "b": rs.uniform(-0.1, 0.1, (cout,)).astype(np.float32),
            "alpha": rs.uniform(0.05, 0.4, (cout,)).astype(np.float32),
            "dz": (rs.randn(B, H, W, cout) * 1e-3).astype(np.float32),
            "z_prev": z_prev.astype(np.float32),
            "alpha_prev": rs.uniform(0.05, 0.4, (cin,)).astype(np.float32)}


def split3(t):
    """The kernels' split: hi = bf16(t), mid = bf16(t - hi), lo = bf16(t -
    hi - mid), each as float32 (tc.cuh split2)."""
    hi = t.bfloat16().float()
    r = t - hi
    mid = r.bfloat16().float()
    return hi, mid, (r - mid).bfloat16().float()


def six(prod, a, b):
    """(hi.hi, the five smaller products) of prod(a, b) over the split
    operands, the five added smallest first as the kernels issue them."""
    ah, am, al = split3(a)
    bh, bm, bl = split3(b)
    cor = prod(al, bh)
    for p, q in ((ah, bl), (am, bm), (am, bh), (ah, bm)):
        cor = cor + prod(p, q)
    return prod(ah, bh), cor


def _conv(x, w):
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


def _tap(x, tap, mirror=False):
    """x at every pixel p shifted by tap (ky, kx)'s offset o = (ky - 1, kx
    - 1): x(p + o), or mirrored x(p - o); zeros outside."""
    ky, kx = divmod(tap, 3)
    if mirror:
        ky, kx = 2 - ky, 2 - kx
    _, H, W, _ = x.shape
    return F.pad(x, (0, 0, 1, 1, 1, 1))[:, ky:ky + H, kx:kx + W]


def _blocks(n, nb):
    """The kernels' N blocks of nb columns over n: ceil(n / nb) of them,
    the last cut at n."""
    return [(n0, min(nb, n - n0)) for n0 in range(0, nb * math.ceil(n / nb),
                                                  nb)]


def fwd_emulated(x, w, b, alpha):
    """T1: z = (hi.hi + the five) + b, y = z > 0 ? z : alpha z, an N block
    (train.fwd_block) at a time, its K summed unit by unit
    (train.k_units: a tap's run of input channels; Cin 3's 27 im2col
    values one unit)."""
    cin, cout = w.shape[2], w.shape[3]
    z = torch.zeros(*x.shape[:3], cout)
    for n0, nb in _blocks(cout, train.fwd_block(cout)):
        wb = w[..., n0:n0 + nb]
        if cin == 3:
            acc, cor = six(_conv, x, wb)
        else:
            acc = cor = 0
            for tap, c0, n in train.k_units(cin):
                a, c = six(lambda p, q: p @ q,
                           _tap(x, tap)[..., c0:c0 + n],
                           wb[tap // 3, tap % 3, c0:c0 + n])
                acc, cor = acc + a, cor + c
        z[..., n0:n0 + nb] = (acc + cor) + b[n0:n0 + nb]
    return torch.where(z > 0, z, alpha * z), z


def im2col(x):
    """(B, H, W, Cin) -> (B H W, 9 Cin): pixel p's row k = tap * Cin + ci
    is x at p + (tap // 3 - 1, tap % 3 - 1), channel ci (HWIO's order)."""
    B, H, W, cin = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), 3, padding=1)  # (B, Cin 9, HW)
    return cols.view(B, cin, 9, H * W).permute(0, 3, 2, 1).reshape(
        B * H * W, 9 * cin)


def tile_pixels(B, H, W):
    """The flat pixel indices of each T3 tile, in the kernels' order (x
    fastest, then tile rows, then images)."""
    th, tw = train.TILE
    idx = torch.arange(B * H * W).view(B, H, W)
    return [idx[b, y:y + th, x:x + tw].reshape(-1)
            for b in range(B) for y in range(0, H, th)
            for x in range(0, W, tw)]


def wgrad_emulated(x, dz):
    """T3: per split, hi.hi summed a tile at a time into a float32 sum,
    the five smaller products over the split, the partial = that sum +
    the five's; the partials summed in split order; db the same way from
    dz's per-split sums."""
    B, H, W, cin = x.shape
    cout = dz.shape[-1]
    cols, d = im2col(x), dz.reshape(-1, cout)
    tiles = tile_pixels(B, H, W)
    splits, per = train.wgrad_splits(B, H, W, cin, cout)
    dw = torch.zeros(9 * cin, cout)
    db = torch.zeros(cout)
    for s in range(splits):
        run = tiles[s * per:(s + 1) * per]
        tot = torch.zeros(9 * cin, cout)
        cor = torch.zeros(9 * cin, cout)
        part_db = torch.zeros(cout)
        for p in run:
            acc, c = six(lambda a, b_: a.t() @ b_, cols[p], d[p])
            tot = tot + acc
            cor = cor + c
            part_db = part_db + d[p].sum(0)
        dw = dw + (tot + cor)
        db = db + part_db
    return (dw * wgrad_written(cin, cout)).view(3, 3, cin, cout), db


def wgrad_written(cin, cout):
    """The rows and columns of [dW] that T3's train.wgrad_groups blocks
    write (1, else 0): a block a tap row, a 64-channel half of Cin (its
    three warpgroups the taps) and a 64-column N block; Cin 3's 27 rows
    one slab."""
    halves = 1 if cin == 3 else math.ceil(cin / 64)
    nblk = math.ceil(cout / 64)
    rows = 1 if cin == 3 else 3
    assert train.wgrad_groups(cin, cout) == rows * halves * nblk
    m = torch.zeros(9 * cin, cout)
    for g in range(rows * halves * nblk):
        nb, rest = g % nblk, g // nblk
        h, dy = rest % halves, rest // halves
        cols = slice(64 * nb, 64 * nb + 64)
        if cin == 3:
            m[:27, cols] = 1
            continue
        for dx in range(3):
            r0 = (3 * dy + dx) * cin + 64 * h
            m[r0:min(r0 + 64, (3 * dy + dx + 1) * cin), cols] = 1
    return m


def dgrad_emulated(dz, w, z_prev, alpha_prev):
    """T2: dx = (hi.hi + the five) of A = dz at the mirrored taps (row q,
    k = tap * Cout + co: dz(q - o_t), o_t = (ky - 1, kx - 1)) times B =
    W[tap][ci][co] as it lies (k = tap * Cout + co, n = ci); dz_prev =
    PReLU'(z_prev) dx; d(alpha) summed a 2 x 64 tile at a time, the tiles'
    partials added in tile order."""
    B, H, W, cout = dz.shape
    cin = w.shape[2]
    # an N block of Cin columns (train.dgrad_block) at a time, its K
    # summed unit by unit over Cout (train.k_units)
    dx = torch.zeros(B, H, W, cin)
    for n0, nb in _blocks(cin, train.dgrad_block(cin)):
        acc = cor = 0
        for tap, c0, n in train.k_units(cout):
            a, c = six(lambda p, q: p @ q,
                       _tap(dz, tap, mirror=True)[..., c0:c0 + n],
                       w[tap // 3, tap % 3, n0:n0 + nb, c0:c0 + n].t())
            acc, cor = acc + a, cor + c
        dx[..., n0:n0 + nb] = acc + cor
    dz_prev = train.prelu_grad_plain(dx, z_prev, alpha_prev)
    terms = (dx * z_prev.clamp_max(0)).reshape(-1, cin)
    dalpha = torch.zeros(cin)
    for p in tile_pixels(B, H, W):
        dalpha = dalpha + terms[p].sum(0)
    return dz_prev, dalpha


def _rel_close(got, want, what):
    err = float((got - want).abs().max())
    ref = float(want.abs().max())
    assert err <= REL * ref, f"{what}: max |d| {err} > {REL} x {ref}"


def test_split_sums_back_to_the_value():
    rs = np.random.RandomState(0)
    t = torch.from_numpy(np.concatenate([
        rs.randn(4096), rs.randn(4096) * 1e-20, rs.randn(4096) * 1e20,
        rs.rand(4096)]).astype(np.float32))
    hi, mid, lo = split3(t)
    back = hi.double() + mid.double() + lo.double()
    assert bool(((back - t.double()).abs()
                 <= 2.0 ** -24 * t.double().abs()).all())
    # each part is a bf16 value, and mid, lo sit below hi's last bit
    for p in (hi, mid, lo):
        assert torch.equal(p, p.bfloat16().float())
    assert bool((mid.abs() <= 2.0 ** -8 * hi.abs()).all())


@pytest.mark.parametrize("cin", CINS)
def test_six_products_leave_out_only_what_lies_below_float32(cin):
    rs = np.random.RandomState(cin)
    a = torch.from_numpy(rs.randn(32, 9 * cin).astype(np.float32))
    b = torch.from_numpy(rs.randn(9 * cin, 16).astype(np.float32))
    acc, cor = six(lambda p, q: p @ q, a, b)
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    assert bool(((acc + cor).double() - exact).abs().le(
        2.0 ** -20 * scale).all())


@pytest.mark.parametrize("cin,cout", PAIRS)
def test_fwd_emulation_matches_plain_and_jax(cin, cout):
    d = _inputs(cin, cout)
    x, w, b, alpha = (torch.from_numpy(d[k]) for k in
                      ("x", "w", "b", "alpha"))
    y, z = fwd_emulated(x, w, b, alpha)
    y0, z0 = train.conv3x3_fwd_train_plain(x, w, b, alpha)
    _rel_close(y, y0, "y vs plain")
    _rel_close(z, z0, "z vs plain")
    zj = jsrvgg._conv3x3(jnp.asarray(d["x"]), jnp.asarray(d["w"]),
                         jnp.asarray(d["b"]))
    yj = jsrvgg._prelu(zj, jnp.asarray(d["alpha"]))
    _rel_close(z, torch.from_numpy(np.array(zj)), "z vs reve_tpu")
    _rel_close(y, torch.from_numpy(np.array(yj)), "y vs reve_tpu")


@pytest.mark.parametrize("cin,cout", PAIRS)
def test_wgrad_emulation_matches_plain_and_jax(cin, cout):
    d = _inputs(cin, cout)
    x, dz = torch.from_numpy(d["x"]), torch.from_numpy(d["dz"])
    dw, db = wgrad_emulated(x, dz)
    dw0, db0 = train.conv3x3_wgrad_plain(x, dz)
    _rel_close(dw, dw0, "dw vs plain")
    _rel_close(db, db0, "db vs plain")

    def loss(w, b):
        return jnp.sum(jsrvgg._conv3x3(jnp.asarray(d["x"]), w, b)
                       * jnp.asarray(d["dz"]))

    _, (gw, gb) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(d["w"]), jnp.asarray(d["b"]))
    _rel_close(dw, torch.from_numpy(np.array(gw)), "dw vs reve_tpu")
    _rel_close(db, torch.from_numpy(np.array(gb)), "db vs reve_tpu")


@pytest.mark.parametrize("cin,cout", PAIRS)
def test_dgrad_emulation_matches_plain_and_jax(cin, cout):
    d = _inputs(cin, cout)
    dz, w, zp, ap = (torch.from_numpy(d[k]) for k in
                     ("dz", "w", "z_prev", "alpha_prev"))
    assert bool((zp == 0).any())  # JAX's tie is exercised
    dzp, da = dgrad_emulated(dz, w, zp, ap)
    dzp0, da0 = train.conv3x3_dgrad_plain(dz, w, zp, ap)
    _rel_close(dzp, dzp0, "dz_prev vs plain")
    _rel_close(da, da0, "dalpha vs plain")

    def layer(z, a):
        return jsrvgg._conv3x3(jsrvgg._prelu(z, a), jnp.asarray(d["w"]),
                               jnp.zeros((cout,), jnp.float32))

    _, vjp = jax.vjp(layer, jnp.asarray(d["z_prev"]),
                     jnp.asarray(d["alpha_prev"]))
    gz, ga = vjp(jnp.asarray(d["dz"]))
    _rel_close(dzp, torch.from_numpy(np.array(gz)), "dz_prev vs reve_tpu")
    _rel_close(da, torch.from_numpy(np.array(ga)), "dalpha vs reve_tpu")


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 7, 63), (1, 65, 129),
                                   (8, 64, 64), (2, 5, 70)])
def test_tiles_cover_every_pixel_once(shape):
    B, H, W = shape
    th, tw = train.TILE
    assert train.tiles(B, H, W) == B * math.ceil(H / th) * math.ceil(W / tw)
    pix = torch.cat(tile_pixels(B, H, W))
    assert len(tile_pixels(B, H, W)) == train.tiles(B, H, W)
    assert torch.equal(pix.sort().values, torch.arange(B * H * W))


def test_wgrad_groups_follow_their_formula():
    for cin, cout in PAIRS:
        halves = 1 if cin == 3 else math.ceil(cin / 64)
        taps = 1 if cin == 3 else 3
        nblk = math.ceil(cout / 64)
        assert train.wgrad_groups(cin, cout) == taps * halves * nblk
    # every row and column of dW is some block's, once Cin 96's second half
    # (32 channels) and Cout 96's second N block are counted
    for cin, cout in PAIRS:
        m = wgrad_written(cin, cout)
        assert bool((m[:27] if cin == 3 else m).eq(1).all()), (cin, cout)


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 7, 63), (1, 65, 129),
                                   (8, 64, 64), (64, 64, 64)])
def test_wgrad_splits_cover_the_tiles_in_about_one_wave(shape):
    B, H, W = shape
    n = train.tiles(B, H, W)
    for cin, cout in PAIRS:
        splits, per = train.wgrad_splits(B, H, W, cin, cout)
        groups = train.wgrad_groups(cin, cout)
        # every split holds tiles, and together they hold every tile
        assert per >= 1 and (splits - 1) * per < n <= splits * per
        # about WGRAD_BLOCKS blocks: never more, and as many as the
        # tiles allow
        assert splits * groups <= max(train.WGRAD_BLOCKS, groups)
        assert splits == min(n, math.ceil(
            n / math.ceil(n / (train.WGRAD_BLOCKS // groups))))


def test_wgrad_splits_at_the_steps_widths():
    """The splits at a training step's 8 x 64 x 64 and the bytes their
    partials move (written once, read once by the split-order sum)."""
    assert train.wgrad_splits(8, 64, 64, 64, 64) == (43, 6)
    assert train.wgrad_splits(8, 64, 64, 128, 128) == (11, 24)
    assert train.wgrad_splits(8, 64, 64, 3, 64) == (128, 2)
    # the new widths: 32 -> 32 as 64 -> 64 (one half, one N block), 96 ->
    # 96 as two halves and two N blocks, the heads one N block
    assert train.wgrad_splits(8, 64, 64, 32, 32) == (43, 6)
    assert train.wgrad_splits(8, 64, 64, 96, 96) == (11, 24)
    assert train.wgrad_splits(8, 64, 64, 128, 12) == (22, 12)
    assert train.wgrad_splits(8, 64, 64, 64, 27) == (43, 6)
    part = {k: s * (9 * k + 1) * k * 4 for k, s in ((64, 43), (128, 11))}
    assert 6.3e6 < part[64] < 6.4e6 and 6.4e6 < part[128] < 6.5e6


def _sass(op="HGMMA", extra="", drop=None, lacking=None):
    """Per-kernel SASS as build.sass returns it for the training library:
    every kernel of SASS_FORMS at each pair holding `op` (the form
    `lacking` holding FFMA instead)."""
    lib = {}
    for form in train.SASS_FORMS:
        for ci, co in PAIRS:
            name = f"_Z{len(form)}{form}ILi{ci}ELi{co}EEvPKf"
            if name != drop:
                lib[name] = (f"{name}\n  /*0100*/ "
                             f"{'FFMA' if form == lacking else op} "
                             f"R1, R2, R3 ;\n{extra}")
    return lib


@pytest.mark.parametrize("case,want", [
    ({}, None),
    ({"op": "FFMA"}, "fwd_tc_kernel kernels, HGMMA missing"),
    ({"lacking": "dgrad_tc_kernel"}, "dgrad_tc_kernel kernels, HGMMA missing"),
    ({"extra": "  /*0200*/ HMMA.16816.F32.TF32 R4, R8, R12, R4 ;"},
     "a TF32 product or a float atomic"),
    ({"extra": "  /*0200*/ RED.E.ADD.F32.FTZ.RN.STRONG.GPU [R2.64], R5 ;"},
     "a TF32 product or a float atomic"),
    ({"drop": "_Z15wgrad_tc_kernelILi128ELi64EEvPKf"},
     "22 wgrad_tc_kernel kernels"),
    ({"drop": "_Z13fwd_tc_kernelILi96ELi27EEvPKf"},
     "22 fwd_tc_kernel kernels"),
], ids=["case0-None", "case1-fwd_tc_kernel kernels, HGMMA missing",
        "case2-dgrad_tc_kernel kernels, HGMMA missing",
        "case3-a TF32 product or a float atomic",
        "case4-a TF32 product or a float atomic",
        # the name it had when the library held 9 kernels a form
        "case5-8 wgrad_tc_kernel kernels",
        "case6-22 fwd_tc_kernel kernels"])
def test_sass_faults_name_what_breaks_the_design(monkeypatch, case, want):
    """train.sass_faults, the check the smoke's build phase and the card
    test run: empty on SASS that keeps T1, T2 and T3 on wgmma with no TF32
    or float atomic; a fault naming what broke otherwise (a T2 kernel
    without HGMMA: a CUDA-core form of T2 is back)."""
    lib = _sass(**case)
    monkeypatch.setattr(train.build, "sass",
                        lambda src: {train.SOURCE: lib}[src])
    faults = train.sass_faults()
    if want is None:
        assert faults == []
    else:
        assert len(faults) >= 1 and any(want in f for f in faults), faults


def test_spills_read_ptxas_report_by_kernel(monkeypatch):
    log = "".join(
        f"ptxas info    : Compiling entry function '{k}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {k}\n"
        f"    16 bytes stack frame, {n} bytes spill stores, {n} bytes "
        f"spill loads\nptxas info    : Used 128 registers, used 1 "
        f"barriers\n" for k, n in (("_Z3fooILi1EEv", 12), ("_Z3barv", 0)))
    monkeypatch.setattr(train.build, "load", lambda src: None)
    monkeypatch.setitem(train.build.build_info, "x.cu", {"log": log})
    assert train.build.spills("x.cu") == {"_Z3fooILi1EEv": 24,
                                           "_Z3barv": 0}


def test_pairs_are_the_sources_and_every_srvggs():
    """train.PAIRS is the pair list the kernels are instantiated at
    (REVE_TRAIN_PAIRS in the source): the 9 pairs of before and every
    SRVGG conv at 32, 64, 96 and 128 features and x2, x3, x4 -- 23."""
    with open(os.path.join(os.path.dirname(train.__file__), "csrc",
                           train.SOURCE)) as f:
        src = f.read()
    block = src[src.index("#define REVE_TRAIN_PAIRS"):]
    block = block[:block.index("\n\n")]
    got = {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)",
                                                    block)}
    srvgg = {p for f in (32, 64, 96, 128)
             for p in [(3, f), (f, f), (f, 12), (f, 27), (f, 48)]}
    old = {(ci, co) for ci in (3, 64, 128) for co in (48, 64, 128)}
    assert got == set(train.PAIRS) == srvgg | old
    assert len(train.PAIRS) == 23 and len(srvgg - old) == 14


@pytest.mark.parametrize("c", [12, 27, 32, 48, 64, 96, 128])
def test_k_units_cover_each_tap_and_channel_once(c):
    """T1's (Cin) and T2's (Cout) units: every (tap, channel) once, a tap's
    runs inside one 64-channel half, 32 channels a run (16 at Cout 12), in
    the kernels' order: half by half, each half's taps in turn."""
    units = train.k_units(c)
    seen = [(tap, ch) for tap, c0, n in units for ch in range(c0, c0 + n)]
    assert sorted(seen) == [(t, ch) for t in range(9) for ch in range(c)]
    run = 16 if c <= 16 else 32
    assert all(c0 % run == 0 and 0 < n <= run and c0 // 64 == (c0 + n - 1)
               // 64 for _, c0, n in units)
    halves = [c0 // 64 for _, c0, _ in units]
    assert halves == sorted(halves)
    # the kernels' count of units: 18 a whole half, 9 a tap's run of the
    # last partial half
    assert len(units) == 18 * (c // 64) + 9 * math.ceil(c % 64 / 32)


def test_emulation_fails_a_blocking_that_drops_channels(monkeypatch):
    """The emulations hold the kernels' blocking, not only their
    arithmetic: at 96 -> 96, a T1 that took Cin 96 as one 64-channel half
    (CIN / 64 halves) or Cout 96 as one 64-column N block drops channels
    and lands far outside the tolerance."""
    d = _inputs(96, 96)
    x, w, b, alpha = (torch.from_numpy(d[k]) for k in
                      ("x", "w", "b", "alpha"))
    y0, _ = train.conv3x3_fwd_train_plain(x, w, b, alpha)
    units = train.k_units

    for owner, name, fn in (
            (train, "k_units", lambda c: [u for u in units(c) if u[1] < 64]),
            (sys.modules[__name__], "_blocks",
             lambda n, nb: [(0, min(64, n))])):
        with monkeypatch.context() as m:
            m.setattr(owner, name, fn)
            y, _ = fwd_emulated(x, w, b, alpha)
        err = float((y - y0).abs().max())
        assert err > 100 * REL * float(y0.abs().max()), name
