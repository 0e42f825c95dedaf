"""T1, T2 and T3 at their channel pairs on a training step's shapes: the
card's time of each launch.

    python -m reve_tpu_torch.scripts.perf_train_kernels
        [--pairs 64x64,128x128] [--iters 20] [--rounds 2]

Each pair's operands are drawn from a numpy seed at 8 LR patches of 64 x
64 (`inputs`; the smoke's train phase draws the same); each kernel's
`--iters` launches are queued behind a sleep kernel and timed by CUDA
events (perf_int8_dot.queued_ms), `--rounds` times over the pairs in
turn.  Prints one JSON line with every time and the card's name and
power limit.  Only the wrappers' names are used, so the parent's kernels
are timed by running this file by path with PYTHONPATH at a `git
archive` of the parent; compare two trees only within one call, in turns
(parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import List, Optional

import numpy as np
import torch

#: a training step: 8 LR patches of 64 x 64
SHAPE = (8, 64, 64)
#: the heads' output counts (x2, x3, x4): no PReLU after them
HEAD_COUTS = (12, 27, 48)
KERNELS = ("conv3x3_fwd_train", "conv3x3_dgrad", "conv3x3_wgrad")


def inputs(cin: int, cout: int, dev, shape=SHAPE) -> dict:
    """Seeded operands of a conv cin -> cout at `shape` (B, H, W) on
    `dev`: x, w, b, alpha (None at a head's Cout), dz, z_prev (exactly 0
    at some pixels: PReLU's tie) and alpha_prev."""
    B, H, W = shape
    rs = np.random.RandomState(1000 * cin + cout)
    bound = 1.0 / np.sqrt(9 * cin)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    d = {"x": t(rs.rand(B, H, W, cin) * 2 - 0.5),
         "w": t(rs.uniform(-bound, bound, (3, 3, cin, cout))),
         "b": t(rs.uniform(-0.1, 0.1, (cout,)))}
    alpha = t(rs.uniform(0.05, 0.4, (cout,)))
    d["alpha"] = None if cout in HEAD_COUTS else alpha
    d["dz"] = t(rs.randn(B, H, W, cout) * 1e-3)
    zp = rs.randn(B, H, W, cin)
    zp[rs.rand(B, H, W, cin) < 0.05] = 0.0
    d["z_prev"] = t(zp)
    d["alpha_prev"] = t(rs.uniform(0.05, 0.4, (cin,)))
    return d


def launchers(d: dict) -> dict:
    """Each kernel's launch on operands `d`, by its LAUNCHES name."""
    from reve_tpu_torch.kernels import train

    return {
        "conv3x3_fwd_train": lambda: train.conv3x3_fwd_train(
            d["x"], d["w"], d["b"], d["alpha"]),
        "conv3x3_dgrad": lambda: train.conv3x3_dgrad(
            d["dz"], d["w"], d["z_prev"], d["alpha_prev"]),
        "conv3x3_wgrad": lambda: train.conv3x3_wgrad(d["x"], d["dz"])}


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(prog="perf_train_kernels",
                                description=__doc__.splitlines()[0])
    p.add_argument("--pairs", default="64x64,128x128")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    from reve_tpu_torch import device as device_mod
    from reve_tpu_torch.scripts import perf_int8_dot

    device_mod.strict_f32()
    dev = torch.device("cuda", 0)
    pairs = [tuple(int(c) for c in s.split("x"))
             for s in args.pairs.split(",")]
    ops = {f"{ci}x{co}": launchers(inputs(ci, co, dev)) for ci, co in pairs}
    ms = {k: {n: [] for n in KERNELS} for k in ops}
    for _ in range(args.rounds):
        for k, fns in ops.items():
            for n, fn in fns.items():
                ms[k][n].append(perf_int8_dot.queued_ms(fn, args.iters, dev))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    line = {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
            "shape": list(SHAPE), "iters": args.iters, "ms": ms}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
