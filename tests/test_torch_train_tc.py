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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from reve_tpu.models import srvgg as jsrvgg
from reve_tpu_torch.kernels import train

torch.set_num_threads(2)

PAIRS = [(ci, co) for ci in train.CINS for co in train.COUTS]
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


def fwd_emulated(x, w, b, alpha):
    """T1: z = (hi.hi + the five) + b, y = z > 0 ? z : alpha z."""
    acc, cor = six(_conv, x, w)
    z = (acc + cor) + b
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
    return dw.view(3, 3, cin, cout), db


def dgrad_emulated(dz, w, z_prev, alpha_prev):
    """T2: dx = (hi.hi + the five) of A = dz at the mirrored taps (row q,
    k = tap * Cout + co: dz(q - o_t), o_t = (ky - 1, kx - 1)) times B =
    W[tap][ci][co] as it lies (k = tap * Cout + co, n = ci); dz_prev =
    PReLU'(z_prev) dx; d(alpha) summed a 2 x 64 tile at a time, the tiles'
    partials added in tile order."""
    B, H, W, cout = dz.shape
    cin = w.shape[2]
    # im2col's tap t reads dz(q + o_t); the mirrored tap 8 - t reads
    # dz(q - o_t)
    cols = im2col(dz).view(-1, 9, cout).flip(1).reshape(-1, 9 * cout)
    bmat = w.permute(0, 1, 3, 2).reshape(9 * cout, cin)
    acc, cor = six(lambda a, b_: a @ b_, cols, bmat)
    dx = (acc + cor).view(B, H, W, cin)
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


@pytest.mark.parametrize("cin", train.CINS)
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
    for cin in train.CINS:
        for cout in train.COUTS:
            halves = 1 if cin == 3 else cin // 64
            taps = 1 if cin == 3 else 3
            nblk = math.ceil(cout / 64)
            assert train.wgrad_groups(cin, cout) == taps * halves * nblk


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 7, 63), (1, 65, 129),
                                   (8, 64, 64), (64, 64, 64)])
def test_wgrad_splits_cover_the_tiles_in_about_one_wave(shape):
    B, H, W = shape
    n = train.tiles(B, H, W)
    for cin in train.CINS:
        for cout in train.COUTS:
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
     "8 wgrad_tc_kernel kernels"),
])
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
