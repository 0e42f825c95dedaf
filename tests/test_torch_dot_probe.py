"""P1, the port's int8/bf16 dot-rate probe (reve_tpu_torch.kernels.
dot_probe), against the Pallas kernel it replaces: the probe body of
scripts/perf_pallas_int8.py:54-75, rebuilt here at a small shape and run
under pl.pallas_call(..., interpret=True) on the CPU.

The kernel's own order of the float32 sum (csrc/dot_probe.cu: the loop
split over dot_probe.LANES warpgroups, each dot's 32-byte k steps added
in order, the lanes' sums added in lane order) is emulated here and held
to the same Pallas probe, beside the host-side helpers of the probe
script: the shapes the kernel takes, the library yardstick's operands and
the linearity check of the timing.

Tolerances: s8 -> s32 exact (integer sums); bf16 -> f32 within 1e-5
relative to the largest |value| (each loop's float32 dot is summed in
another order); the kernel's emulated order within 1e-4 relative, the
tolerance the card tests hold the kernel to.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from reve_tpu_torch.kernels import LAUNCHES, build, dot_probe
from reve_tpu_torch.scripts import perf_int8_dot

torch.set_num_threads(2)

M, K, N, LOOPS = 64, 256, 128, 4


def _pallas_probe(x, w, loops, acc_t):
    """scripts/perf_pallas_int8.py:54-75 at (M, K, N), interpreted."""
    m, k = x.shape
    n = w.shape[1]

    def kernel(x_ref, w_ref, o_ref):
        xv = x_ref[...]
        w0 = w_ref[0:k, :]
        w1 = w_ref[k:2 * k, :]
        acc = jnp.zeros((m, n), acc_t)

        def body(i, acc):
            wv = jnp.where((i % 2) == 0, w0, w1)
            return acc + jax.lax.dot_general(
                xv, wv, (((1,), (0,)), ((), ())),
                preferred_element_type=acc_t)

        o_ref[...] = jax.lax.fori_loop(0, loops, body, acc).astype(acc_t)

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((m, n), acc_t),
        interpret=True)(x, w))


@pytest.mark.parametrize("name", ["int8", "bf16"])
def test_plain_probe_matches_the_pallas_probe(name):
    rs = np.random.RandomState(0)
    if name == "int8":
        x = rs.randint(-127, 128, (M, K)).astype(np.int8)
        w = rs.randint(-127, 128, (2 * K, N)).astype(np.int8)
        want = _pallas_probe(jnp.asarray(x), jnp.asarray(w), LOOPS,
                             jnp.int32)
        tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    else:
        x = (rs.rand(M, K) - 0.5).astype(np.float32)
        w = (rs.rand(2 * K, N) - 0.5).astype(np.float32)
        want = _pallas_probe(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(w, jnp.bfloat16), LOOPS,
                             jnp.float32)
        tx = torch.from_numpy(x).to(torch.bfloat16)
        tw = torch.from_numpy(w).to(torch.bfloat16)
    before = LAUNCHES["dot_loop"]
    got = dot_probe.dot_loop(tx, tw, LOOPS).numpy()  # CPU: plain version
    assert LAUNCHES["dot_loop"] == before  # plain calls are not counted
    assert got.shape == (M, N) and got.dtype == want.dtype
    if name == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _operands(name, seed, m=M, k=K, n=N):
    rs = np.random.RandomState(seed)
    if name == "int8":
        return (rs.randint(-127, 128, (m, k)).astype(np.int8),
                rs.randint(-127, 128, (2 * k, n)).astype(np.int8))
    return ((rs.rand(m, k) - 0.5).astype(np.float32),
            (rs.rand(2 * k, n) - 0.5).astype(np.float32))


def _kernel_order(x, w, loops, lanes):
    """csrc/dot_probe.cu's sum, emulated: lane l adds the k steps (32 bytes
    of K) of its dots i = l, l + lanes, ... in order into its accumulator
    (a step's products summed in float64 and rounded once: the tensor
    cores add within a step in their own order), and the tile is the
    lanes' sums added in lane order.  bf16 operands come as float32 values
    (exact); s8 sums in int64."""
    k = x.shape[1]
    step = 32 // x.itemsize if x.dtype == np.int8 else 16
    acc_t = np.int64 if x.dtype == np.int8 else np.float32
    halves = (w[:k], w[k:])
    parts = []
    for lane in range(lanes):
        acc = np.zeros((x.shape[0], w.shape[1]), acc_t)
        for i in range(lane, loops, lanes):
            h = halves[i % 2]
            for s in range(0, k, step):
                p = x[:, s:s + step].astype(np.float64) @ \
                    h[s:s + step].astype(np.float64)
                acc = acc + p.astype(acc_t)
        parts.append(acc)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


@pytest.mark.parametrize("loops", [1, 3, 8])
@pytest.mark.parametrize("name", ["int8", "bf16"])
def test_kernel_summation_order_matches_the_pallas_probe(name, loops):
    x, w = _operands(name, loops)
    if name == "int8":
        want = _pallas_probe(jnp.asarray(x), jnp.asarray(w), loops,
                             jnp.int32)
        got = _kernel_order(x, w, loops, dot_probe.LANES)
        np.testing.assert_array_equal(got, want)
        return
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = _pallas_probe(xb, wb, loops, jnp.float32)
    got = _kernel_order(np.asarray(xb, np.float32), np.asarray(wb, np.float32),
                        loops, dot_probe.LANES)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _byte_perm(x, y, sel):
    """CUDA __byte_perm on uint32 arrays: byte i of the result is byte
    nibble i of sel of (y << 32 | x)."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint32)
    for i in range(4):
        b = (both >> np.uint64(8 * ((sel >> (4 * i)) & 0xF))) & np.uint64(
            0xFF)
        out |= (b.astype(np.uint32) << np.uint32(8 * i))
    return out


@pytest.mark.parametrize("name", ["int8", "bf16"])
def test_staged_b_matches_the_wgmma_layout(name):
    """csrc/dot_probe.cu stage_half, emulated: 4-B words of E rows of w
    transposed by byte permutes land value (k, n) at 16-B chunk k / E, row
    n, byte (k % E) * size, the K-major layout tc.cuh desc() reads."""
    size = 1 if name == "int8" else 2
    e, c, bn, k = 16 // size, 4 // size, 64, 64
    rs = np.random.RandomState(3)
    w = rs.randint(0, 1 << (8 * size), (k, bn)).astype(
        np.uint8 if size == 1 else np.uint16)
    words = np.ascontiguousarray(w).view(np.uint32)  # w's rows as 4-B words
    staged = np.zeros((k // e, bn, 4), np.uint32)  # [chunk][n][word]
    for kc in range(k // e):
        rows = words[kc * e:(kc + 1) * e]  # in[j] for every column group
        for q in range(4):
            if c == 4:
                t0 = _byte_perm(rows[4 * q], rows[4 * q + 1], 0x5140)
                t1 = _byte_perm(rows[4 * q], rows[4 * q + 1], 0x7362)
                t2 = _byte_perm(rows[4 * q + 2], rows[4 * q + 3], 0x5140)
                t3 = _byte_perm(rows[4 * q + 2], rows[4 * q + 3], 0x7362)
                outs = (_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
                        _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632))
            else:
                outs = (_byte_perm(rows[2 * q], rows[2 * q + 1], 0x5410),
                        _byte_perm(rows[2 * q], rows[2 * q + 1], 0x7632))
            for col, o in enumerate(outs):
                staged[kc, col::c, q] = o
    values = staged.view(w.dtype).reshape(k // e, bn, e)  # [chunk][n][k%E]
    want = w.reshape(k // e, e, bn).transpose(0, 2, 1)
    np.testing.assert_array_equal(values, want)


def test_lanes_match_the_kernels_split():
    """dot_probe.LANES is the kernel's WGS, the warpgroups of a CTA that
    split the loop, and a CTA covers one 64 x 64 tile (one m64n64 wgmma),
    the wrapper's multiple of M and N."""
    with open(os.path.join(build.CSRC, dot_probe.SOURCE)) as f:
        src = f.read()
    wgs = int(re.search(r"constexpr int WGS = (\d+);", src).group(1))
    assert wgs == dot_probe.LANES
    bm, bn = map(int, re.search(r"constexpr int BM = (\d+), BN = (\d+);",
                                src).groups())
    assert bm == bn == dot_probe._TILE
    assert "mma.sync" not in src and "Wgmma" in src


@pytest.mark.parametrize("case", [
    ((64, 256), (512, 96), torch.int8, 1),      # N not a multiple of 64
    ((64, 288), (576, 128), torch.int8, 1),     # K > 256
    ((64, 288), (576, 128), torch.bfloat16, 1),
    ((64, 48), (96, 64), torch.int8, 1),        # K not a multiple of 32
    ((64, 24), (48, 64), torch.bfloat16, 1),    # ... of 16
    ((100, 64), (128, 64), torch.int8, 1),      # M not a multiple of 64
    ((0, 64), (128, 64), torch.int8, 1),        # M = 0
    ((64, 64), (64, 64), torch.int8, 1),        # w not (2K, N)
    ((64, 64), (128, 64), torch.bfloat16, -1),  # loops < 0
], ids=["n96", "k288_s8", "k288_bf16", "k48_s8", "k24_bf16", "m100", "m0",
        "w_rows", "loops_neg"])
def test_check_shapes_refuses_what_the_kernel_does_not_take(case):
    xs, ws, dt, loops = case
    with pytest.raises(ValueError, match="dot_loop shapes"):
        dot_probe.check_shapes(torch.empty(xs, dtype=dt, device="meta"),
                               torch.empty(ws, dtype=dt, device="meta"),
                               loops)


@pytest.mark.parametrize("case", [
    ((64, 32), (64, 64), torch.int8, 0), ((64, 16), (32, 64), torch.bfloat16,
                                          1),
    ((4224, 256), (512, 128), torch.int8, 64),
    ((128, 256), (512, 192), torch.bfloat16, 7)])
def test_check_shapes_takes_the_kernels_shapes(case):
    xs, ws, dt, loops = case
    dot_probe.check_shapes(torch.empty(xs, dtype=dt, device="meta"),
                           torch.empty(ws, dtype=dt, device="meta"), loops)


@pytest.mark.parametrize("name", ["int8", "bf16"])
def test_library_operands_give_the_probe_sum(name):
    """The yardstick's one product, x tiled along K by the halves stacked
    in loop order, is the probe's sum."""
    x, w = _operands(name, 11, m=64, k=64, n=64)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    if name == "bf16":
        tx, tw = tx.to(torch.bfloat16), tw.to(torch.bfloat16)
    xt, wt = perf_int8_dot.library_operands(tx, tw, 5)
    assert xt.shape == (64, 5 * 64) and wt.shape == (5 * 64, 64)
    assert torch.equal(wt[64:128], tw[64:]) and torch.equal(wt[128:192],
                                                            tw[:64])
    got = xt.double() @ wt.double()
    want = dot_probe.dot_loop_plain(tx, tw, 5).double()
    if name == "int8":
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_slope_flags_what_is_not_linear():
    """The marginal rate between two loop counts, and the linearity check
    that shows no dot was hoisted: an added dot may not cost less than
    its time at the peak (times PEAK_SLACK), and the time may not grow
    faster than the loop count."""
    peak = perf_int8_dot.PEAK_TOPS["int8"]
    per_dot = perf_int8_dot.tops(1.0, 1) / peak  # ms of one dot at peak
    ok = perf_int8_dot.slope(0.02, 0.02 + 960 * per_dot * 1.1, 64, 1024,
                             peak)
    assert ok["linear"] and ok["marginal_tops"] < peak
    hoisted = perf_int8_dot.slope(0.02, 0.02 + 960 * per_dot / 2, 64, 1024,
                                  peak)
    assert not hoisted["linear"] and hoisted["marginal_tops"] > 1.9 * peak
    assert not perf_int8_dot.slope(0.02, 0.019, 64, 1024, peak)["linear"]
    faster = perf_int8_dot.slope(0.02, 0.02 * 18, 64, 1024, peak)
    assert faster["growth"] == pytest.approx(18)
    assert not faster["linear"]


def test_plain_probe_alternates_the_k_halves():
    x = torch.ones((64, 32), dtype=torch.int8)
    w = torch.cat([torch.ones((32, 64)), 2 * torch.ones((32, 64))]).to(
        torch.int8)
    # 3 loops: halves 0, 1, 0 -> 32 * (1 + 2 + 1)
    assert int(dot_probe.dot_loop_plain(x, w, 3)[0, 0]) == 128


def test_probe_script_runs_on_the_cpu(capsys):
    out = perf_int8_dot.main(["--iters", "1", "--loops", "2"],
                             device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("bf16: ") and lines[1].startswith("int8: ")
    assert lines[2].startswith("ratio int8/bf16: ") and "1979/989" in \
        lines[2]
    assert out["ratio"] > 0 and out["int8"]["ms"] > 0
