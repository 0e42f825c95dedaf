"""int8 vs bf16 dot rate of the card's tensor cores (kernel P1).

    python -m reve_tpu_torch.scripts.perf_int8_dot [--iters N] [--loops N]

The port of scripts/perf_pallas_int8.py, which asked whether the TPU's
matrix unit issues s8 dots fast enough, next to bf16, for an int8 body to
be worth having.  Here the same question is put to the H100's tensor
cores: kernel P1 (reve_tpu_torch/kernels/csrc/dot_probe.cu) runs `loops`
dots (4224, 256) @ (256, 128), alternating the two K-halves of a (512, 128)
weight, in bf16 -> f32 and in s8 -> s32, on the same seeded inputs as the
TPU probe (numpy RandomState(0), bf16 drawn first).  Each rate is timed
with CUDA events over `iters` calls after one untimed call, and printed as
three lines: bf16 TOP/s, int8 TOP/s, and their ratio beside the card's
dense peak ratio.
"""

from __future__ import annotations

import argparse
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
    call: CUDA events on the card, the host clock on the CPU."""
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


def main(argv: Optional[List[str]] = None, device=None) -> dict:
    """Run the probe; returns {"bf16": {...}, "int8": {...}, "ratio": r}.
    `device`: None -> cuda:0 (the plain version runs only where the
    caller asks for the CPU)."""
    p = argparse.ArgumentParser(prog="perf_int8_dot",
                                description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--loops", type=int, default=64)
    args = p.parse_args(argv)
    dev = device_mod.resolve_device(device)
    ops = inputs(dev)
    out = {}
    for name in ("bf16", "int8"):
        x, w = ops[name]
        ms = time_ms(lambda: dot_probe.dot_loop(x, w, args.loops),
                     args.iters, dev)
        tops = 2 * M * K * N * args.loops / (ms * 1e-3) / 1e12
        print(f"{name}: {tops:.1f} TOP/s ({ms:.4f} ms / {args.loops} dots)",
              flush=True)
        out[name] = {"tops": tops, "ms": ms}
    ratio = out["int8"]["tops"] / out["bf16"]["tops"]
    print(f"ratio int8/bf16: {ratio:.2f}x (H100 dense peak ratio: "
          f"{PEAK_TOPS['int8']:.0f}/{PEAK_TOPS['bf16']:.0f} = "
          f"{PEAK_TOPS['int8'] / PEAK_TOPS['bf16']:.1f}x)", flush=True)
    out["ratio"] = ratio
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
