"""A fine-tune step's time on the card, and where it goes.

    python -m reve_tpu_torch.scripts.perf_train_step [--steps N] [--plain]
        [--trace] [--feat F] [--scale R]

Fine-tunes realesr-animevideov3 x4 (models/, 64 features, 16 convs; with
`--feat F` (32, 96 or 128, the distillation script's default student
width) or `--scale R` (2 or 3: no x2 or x3 weights ship), the same depth
at F features (64 by default) and xR (4 by default) drawn from seed 0)
with train.Trainer's defaults on seeded batches of 8 LR patches of 64 x
64 (HR 64 R) already on the card, so no host-to-device copy is timed: two
untimed steps, then `--steps` steps by the host's clock (each step ends
in its loss's read, as Trainer.step does).  `--plain` runs the kernels'
plain versions (cuDNN) instead of T1-T3.  With `--trace`, three more
steps run under torch.profiler, which gives the card's busy time a step
(the sum of its kernels' device times) against the step's wall, and the
12 largest device times by kernel.  Prints one JSON line with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from reve_tpu_torch.models import srvgg
from reve_tpu_torch.train import trainer
from reve_tpu_torch.weights.torch_loader import load_srvgg_pth

BATCH, LR_PATCH = 8, 64
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "models", "realesr-animevideov3-x4.pth")


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(prog="perf_train_step",
                                description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--plain", action="store_true")
    p.add_argument("--trace", action="store_true")
    p.add_argument("--feat", type=int, default=0)
    p.add_argument("--scale", type=int, default=0, choices=(0, 2, 3, 4))
    args = p.parse_args(argv)
    dev = torch.device("cuda", 0)
    cfg, params = load_srvgg_pth(WEIGHTS)
    if (args.feat or cfg.num_feat, args.scale or cfg.upscale) != (
            cfg.num_feat, cfg.upscale):
        cfg = srvgg.SRVGGConfig(num_feat=args.feat or cfg.num_feat,
                                num_conv=cfg.num_conv,
                                upscale=args.scale or cfg.upscale)
        params = srvgg.init_params(cfg)
    r = cfg.upscale
    tr = trainer.Trainer(cfg, params=params, device=dev, plain=args.plain)
    rs = np.random.RandomState(0)
    hr = torch.from_numpy(rs.rand(BATCH, LR_PATCH * r, LR_PATCH * r,
                                  3).astype(np.float32)).to(dev)
    lr = hr.reshape(BATCH, LR_PATCH, r, LR_PATCH, r, 3).mean((2, 4))
    for _ in range(2):
        tr.step(lr, hr)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        tr.step(lr, hr)
    torch.cuda.synchronize(dev)
    step_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    line = {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
            "plain": args.plain, "num_feat": cfg.num_feat,
            "scale": cfg.upscale, "batch": BATCH,
            "lr_patch": LR_PATCH,
            "step_ms": step_ms, "lr_patches_per_s": BATCH * 1e3 / step_ms}
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        n = 3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                tr.step(lr, hr)
            torch.cuda.synchronize(dev)
            wall = 1e3 * (time.perf_counter() - t0) / n
        ms = {e.key: e.self_device_time_total / 1e3 / n
              for e in prof.key_averages() if e.self_device_time_total}
        kernels = sum(e.count for e in prof.key_averages()
                      if e.self_device_time_total) / n
        line.update(traced_step_ms=wall, device_ms=sum(ms.values()),
                    device_busy_share=sum(ms.values()) / wall,
                    device_ops_per_step=kernels,
                    by_kernel_ms=dict(sorted(ms.items(),
                                             key=lambda kv: -kv[1])[:12]))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
