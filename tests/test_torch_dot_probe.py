"""P1, the port's int8/bf16 dot-rate probe (reve_tpu_torch.kernels.
dot_probe), against the Pallas kernel it replaces: the probe body of
scripts/perf_pallas_int8.py:54-75, rebuilt here at a small shape and run
under pl.pallas_call(..., interpret=True) on the CPU.

Tolerances: s8 -> s32 exact (integer sums); bf16 -> f32 within 1e-5
relative to the largest |value| (each loop's float32 dot is summed in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from reve_tpu_torch.kernels import LAUNCHES, dot_probe
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
