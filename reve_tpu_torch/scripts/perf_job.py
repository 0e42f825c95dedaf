"""The product job's wall on the card, and where it goes.

    python -m reve_tpu_torch.scripts.perf_job [--frames 8] [--repeat 2]
        [--dtype auto] [--work DIR]

Runs `chip_smoke.py`'s main job through the CLI: `--frames` seeded
1920 x 1080 frames (gradients and noise, the smoke's) upscaled x4 by
realesr-animevideov3 (the shipped weights), batches of 4, segments of 4,
y4m io, `--repeat` times in one process after the kernels are built.
Prints one JSON line a run: the wall of `cli.run`, job fps, the seconds
of each scheduler span from its --trace file (submit on the main thread;
device_wait and encode_batch on the encode thread), encode_batch's share
of the wall, the kernel launches (K9's where the tree has it) and the
output file's size and sha256; then nvidia-smi's name and power limit.
It needs a CUDA device.

To run the parent's job beside it, run this file by path with
PYTHONPATH at a `git archive` of the parent: it uses only the CLI, the
launch counters and the trace, which both trees have.
"""

from __future__ import annotations

import argparse
import fractions
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

import reve_tpu_torch
from reve_tpu_torch import cli, kernels
from reve_tpu_torch.io import writer
from reve_tpu_torch.kernels import build

H, W, SCALE, BATCH = 1080, 1920, 4, 4


def frames_u8(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """chip_smoke.py's frames: seeded gradients + noise."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.int32)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        grad = np.stack([(yy // 4 + 9 * i) % 256, (xx // 7) % 256,
                         ((yy + xx) // 9 + 3 * i) % 256], -1)
        out[i] = np.clip(grad + rs.randint(-16, 17, grad.shape), 0, 255)
    return out


def span_seconds(trace: str) -> dict:
    spans = {}
    with open(trace) as f:
        for ln in f:
            ev = json.loads(ln)
            if "dur" in ev:
                spans[ev["ev"]] = spans.get(ev["ev"], 0.0) + ev["dur"]
    return spans


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(prog="perf_job",
                                description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--repeat", type=int, default=2)
    p.add_argument("--dtype", default="auto")
    p.add_argument("--work", default=None,
                   help="scratch directory (default: a temporary one)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("perf_job needs a CUDA device")
    build.load_all()
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        reve_tpu_torch.__file__)))
    weights = os.path.join(root, "models", "realesr-animevideov3-x4.pth")
    work = tempfile.mkdtemp(prefix="perf_job-", dir=args.work)
    results = []
    try:
        inp = os.path.join(work, "in.y4m")
        with writer.Y4MWriter(inp, W, H, fractions.Fraction(24)) as wr:
            for f in frames_u8(args.frames, H, W):
                wr.write(f)
        for run in range(args.repeat):
            out = os.path.join(work, f"out{run}.y4m")
            trace = os.path.join(work, f"trace{run}.jsonl")
            argv_j = ["-i", inp, "-s", str(SCALE), out, "--io-backend",
                      "y4m", "--weights", weights, "-S", "4", "--batch",
                      str(BATCH), "--dtype", args.dtype, "--yes",
                      "--trace", trace]
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            rc = cli.run(argv_j)
            wall = time.perf_counter() - t0
            if rc != 0:
                raise SystemExit(f"cli.run exited {rc}")
            spans = span_seconds(trace)
            h = hashlib.sha256()
            with open(out, "rb") as f:
                for block in iter(lambda: f.read(1 << 24), b""):
                    h.update(block)
            res = {"package": os.path.dirname(reve_tpu_torch.__file__),
                   "run": run, "frames": args.frames, "wall_s": wall,
                   "fps": args.frames / wall, "span_s": spans,
                   "encode_share": spans.get("encode_batch", 0.0) / wall,
                   "device_wait_share": spans.get("device_wait", 0.0)
                   / wall,
                   "k9_launches": kernels.LAUNCHES.get("rgb_to_yuv420_u8"),
                   "launches": {k: v for k, v in kernels.LAUNCHES.items()
                                if v},
                   "output_bytes": os.path.getsize(out),
                   "output_sha256": h.hexdigest()}
            results.append(res)
            print(json.dumps(res), flush=True)
            os.unlink(out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    return results


if __name__ == "__main__":
    main()
