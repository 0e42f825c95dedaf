"""int8 vs bf16 dot rate of the card's tensor cores (kernel P1).

    python -m reve_tpu_torch.scripts.perf_int8_dot [--iters N] [--loops N]

The port of scripts/perf_pallas_int8.py, which asked whether the TPU's
matrix unit issues s8 dots fast enough, next to bf16, for an int8 body to
be worth having.  Here the same question is put to the H100's tensor
cores: kernel P1 (reve_tpu_torch/kernels/csrc/dot_probe.cu) runs `loops`
dots (4224, 256) @ (256, 128), alternating the two K-halves of a (512, 128)
weight, in bf16 -> f32 and in s8 -> s32, on the same seeded inputs as the
TPU probe (numpy RandomState(0), bf16 drawn first).

Each call is timed free of the host's launch cost: `iters` calls queued
behind a sleep kernel, so that the card runs them back to back, between
CUDA events (on the CPU, the host clock around the calls).  It is timed
at `loops` and at 16 x `loops` dots: the slope between the two is the
marginal dot rate, and the time must grow linearly with the loop count
(each added dot costs at least its time at the card's peak, and the time
grows no faster than the count), which shows that no dot was hoisted or
merged.  Printed as three lines: bf16 and int8, each its rate per call
(on the card also the time of back-to-back calls from the host), its
marginal rate and the growth of its time; then their ratio beside the
card's dense peak ratio.  On the card a fourth line gives its name and
power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from reve_tpu_torch import device as device_mod
from reve_tpu_torch.kernels import dot_probe

#: the TPU probe's shape: an s2d strip (S*W) x K (2 lane tiles) x N
M, K, N = 4224, 256, 128
#: H100 SXM dense tensor-core peaks (NVIDIA data sheet)
PEAK_TOPS = {"bf16": 989.0, "int8": 1979.0}
#: how far a marginal rate may pass the data sheet's peak before the
#: growth counts as not linear: the peaks assume a 1830 MHz boost clock,
#: and an H100 SXM may run its SMs up to 1980 MHz (8% more)
PEAK_SLACK = 1.15
#: cycles of the sleep kernel that queued_ms's calls wait behind: about 50
#: ms at the SMs' clock, far longer than the host takes to queue them
SLEEP_CYCLES = 100_000_000


def inputs(device) -> dict:
    """The probe's operands, drawn from RandomState(0) in the TPU probe's
    order (bf16 first, then int8)."""
    rs = np.random.RandomState(0)
    xb = torch.from_numpy((rs.rand(M, K) - 0.5).astype(np.float32))
    wb = torch.from_numpy((rs.rand(2 * K, N) - 0.5).astype(np.float32))
    xi = torch.from_numpy(rs.randint(-127, 128, (M, K)).astype(np.int8))
    wi = torch.from_numpy(rs.randint(-127, 128, (2 * K, N)).astype(np.int8))
    return {"bf16": (xb.to(device, torch.bfloat16),
                     wb.to(device, torch.bfloat16)),
            "int8": (xi.to(device), wi.to(device))}


def time_ms(fn, iters: int, device) -> float:
    """Mean milliseconds per call over `iters` calls, after one untimed
    call: CUDA events around back-to-back calls from the host on the card
    (so a call that takes the host longer than the card counts the host's
    time), the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int, device) -> float:
    """Mean milliseconds per call, free of the host's launch cost: on the
    card, one untimed call, then `iters` calls queued behind a sleep kernel
    (`torch.cuda._sleep`), so that the card runs them back to back, timed
    by CUDA events; raises if the card had passed the first event before
    the host had queued the last call.  On the CPU, time_ms."""
    if device.type != "cuda":
        return time_ms(fn, iters, device)
    fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    ahead = not start.query()
    torch.cuda.synchronize(device)
    if not ahead:
        raise RuntimeError(f"the card ran the sleep kernel ({SLEEP_CYCLES} "
                           f"cycles) before the host had queued {iters} "
                           f"calls: the time would hold the host's")
    return start.elapsed_time(end) / iters


def tops(ms: float, loops: int) -> float:
    """The probe's rate in TOP/s: 2 M K N operations a dot."""
    return 2 * M * K * N * loops / (ms * 1e-3) / 1e12


def slope(ms: float, ms_long: float, loops: int, long_loops: int,
          peak_tops: float) -> dict:
    """The marginal rate between `loops` and `long_loops` dots, the growth
    ms_long / ms, and whether the growth is linear: each added dot costs
    at least its time at PEAK_SLACK x `peak_tops`, and the time grows no
    faster than the loop count (within 10%)."""
    added = ms_long - ms
    marginal = tops(added, long_loops - loops) if added > 0 else float("inf")
    growth = ms_long / ms
    linear = marginal <= PEAK_SLACK * peak_tops and \
        growth <= 1.1 * long_loops / loops
    return {"marginal_tops": marginal, "growth": growth, "linear": linear}


def library_operands(x: torch.Tensor, w: torch.Tensor, loops: int):
    """One library product of the probe's multiply-adds: x tiled `loops`
    times along K, times w's K-halves stacked in loop order (half i % 2
    for dot i), so that x_t @ w_t is sum_i x @ half_i."""
    k = w.shape[0] // 2
    return (x.repeat(1, loops),
            torch.cat([w[(i % 2) * k:(i % 2 + 1) * k] for i in range(loops)]))


def card() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them, or None
    without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def main(argv: Optional[List[str]] = None, device=None,
         card_line: Optional[str] = None) -> dict:
    """Run the probe; returns {"bf16": {...}, "int8": {...}, "ratio": r,
    "marginal_ratio": r, "card": str or None}.  `device`: None -> cuda:0
    (the plain version runs only where the caller asks for the CPU);
    `card_line`: the card's nvidia-smi line where the caller has read it
    (else it is read here, on the card)."""
    p = argparse.ArgumentParser(prog="perf_int8_dot",
                                description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--loops", type=int, default=64)
    args = p.parse_args(argv)
    if args.loops < 1:
        p.error("need --loops >= 1")
    long_loops = 16 * args.loops
    dev = device_mod.resolve_device(device)
    ops = inputs(dev)
    out = {}
    for name in ("bf16", "int8"):
        x, w = ops[name]
        ms = queued_ms(lambda: dot_probe.dot_loop(x, w, args.loops),
                       args.iters, dev)
        ms_long = queued_ms(lambda: dot_probe.dot_loop(x, w, long_loops),
                            args.iters, dev)
        r = {"tops": tops(ms, args.loops), "ms": ms, "ms_long": ms_long,
             "loops": args.loops, "long_loops": long_loops,
             **slope(ms, ms_long, args.loops, long_loops, PEAK_TOPS[name])}
        host = ""
        if dev.type == "cuda":  # back-to-back calls from the host
            r["host_ms"] = time_ms(
                lambda: dot_probe.dot_loop(x, w, args.loops), args.iters, dev)
            host = f", {r['host_ms']:.4f} ms a call from the host"
        print(f"{name}: {r['tops']:.1f} TOP/s ({ms:.4f} ms / {args.loops} "
              f"dots{host}; marginal {r['marginal_tops']:.1f} TOP/s to "
              f"{long_loops} dots, time x{r['growth']:.2f}: "
              f"{'linear' if r['linear'] else 'NOT linear'})", flush=True)
        out[name] = r
    ratio = out["int8"]["tops"] / out["bf16"]["tops"]
    marginal_ratio = out["int8"]["marginal_tops"] / \
        out["bf16"]["marginal_tops"]
    print(f"ratio int8/bf16: {ratio:.2f}x (marginal {marginal_ratio:.2f}x; "
          f"H100 dense peak ratio: {PEAK_TOPS['int8']:.0f}/"
          f"{PEAK_TOPS['bf16']:.0f} = "
          f"{PEAK_TOPS['int8'] / PEAK_TOPS['bf16']:.1f}x)", flush=True)
    if dev.type == "cuda" and card_line is None:
        card_line = card()
    out.update(ratio=ratio, marginal_ratio=marginal_ratio, card=card_line)
    if out["card"]:
        print(f"card: {out['card']}", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
