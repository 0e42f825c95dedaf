"""RRDBNet's model time per batch on the card, and where it goes.

    python -m reve_tpu_torch.scripts.perf_rrdb_model [--dtype float32]
        [--batches N] [--trace]

Builds an engine for realesrgan-x4plus (23 blocks, random weights from
seed 0) in `--dtype` and runs its model calls over a batch of 4 seeded
1080p frames (x4) as the engine runs them, in the plan's chunks: one
untimed batch, then `--batches` batches timed by CUDA events.  With
`--trace`, one more batch runs under torch.profiler, which gives the
device time of each kernel (the 12 largest) and of all of them.  Prints
one JSON line: the card, the plan, the kernel launches per batch,
model_ms_per_batch and, with --trace, device_ms and by_kernel_ms.  To
time the parent's model beside it, run this file by path with
PYTHONPATH at a `git archive` of the parent.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from reve_tpu_torch import kernels
from reve_tpu_torch.pipeline.engine import UpscaleEngine

FRAMES, H, W = 4, 1080, 1920


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(prog="perf_rrdb_model",
                                description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--batches", type=int, default=2)
    p.add_argument("--trace", action="store_true")
    args = p.parse_args(argv)
    dev = torch.device("cuda", 0)
    frames = np.random.RandomState(0).randint(
        0, 256, (FRAMES, H, W, 3)).astype(np.uint8)
    eng = UpscaleEngine(model="realesrgan-x4plus", scale=4,
                        compute_dtype=args.dtype, batch_size=FRAMES,
                        allow_random_init=True)
    x = torch.from_numpy(frames).to(dev)

    def batch():
        # each piece dropped before the next runs, as the engine's loop does
        for piece in eng._pieces(x):
            del piece

    batch()
    torch.cuda.synchronize(dev)
    kernels.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.batches):
        batch()
    end.record()
    torch.cuda.synchronize(dev)
    line = {"device": torch.cuda.get_device_name(dev), "dtype": args.dtype,
            "plan": list(eng._plan_execution(H, W)),
            "launches_per_batch": {k: v / args.batches
                                   for k, v in kernels.LAUNCHES.items() if v},
            "model_ms_per_batch": start.elapsed_time(end) / args.batches}
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            batch()
            torch.cuda.synchronize(dev)
        ms = {e.key: e.self_device_time_total / 1e3
              for e in prof.key_averages() if e.self_device_time_total}
        line["device_ms"] = sum(ms.values())
        line["by_kernel_ms"] = dict(sorted(ms.items(),
                                           key=lambda kv: -kv[1])[:12])
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
