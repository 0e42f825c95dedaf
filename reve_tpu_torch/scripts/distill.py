"""Distill a teacher SRVGG model into a student, on the card.

    python -m reve_tpu_torch.scripts.distill \\
        --teacher realesr-animevideov3-x4 --student-feat 128 \\
        --student-conv 16 --steps 2000 --data clip.y4m --out student.pth

The flags and defaults of reve_tpu's scripts/distill.py, plus --device
(default cuda:0, which raises without CUDA; `--device cpu` runs the
kernels' plain versions).  The teacher resolves through the model
registry (`--teacher-weights`, $REVE_TPU_MODELS_DIR, ./models): the
shipped realesr-animevideov3 models need no flag, and a teacher that
does not resolve is an error, not random weights.  With --data absent,
synthetic textured patches are used (a smoke run; real distillation
needs real frames).  --out ending in .pth writes product weights (the
registry and reve_tpu both load them); anything else a training
checkpoint directory.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np


def synthetic_batches(batch, patch, scale, seed=0):
    rs = np.random.RandomState(seed)
    while True:
        # mixed-frequency synthetic texture (better than white noise for
        # exercising an SR net)
        yy, xx = np.mgrid[0:patch, 0:patch].astype(np.float32)
        out = np.empty((batch, patch, patch, 3), np.float32)
        for b in range(batch):
            f1, f2 = rs.uniform(0.05, 0.6, 2)
            ph = rs.uniform(0, 6.28, 2)
            base = 0.5 + 0.25 * np.sin(f1 * xx + ph[0]) * \
                np.cos(f2 * yy + ph[1])
            noise = rs.normal(0, 0.05, (patch, patch, 1))
            out[b] = np.clip(base[..., None] + noise, 0, 1)
        yield out, None


def video_batches(path, batch, patch, scale, seed=0):
    from reve_tpu_torch.io import probe, reader

    info = probe.probe(path)
    rs = np.random.RandomState(seed)
    with reader.open_reader(path, width=info.width,
                            height=info.height) as rd:
        frames = [f for f in rd.read_range(0, min(info.frame_count, 500))]
    frames = np.stack(frames).astype(np.float32) / 255.0
    while True:
        out = np.empty((batch, patch, patch, 3), np.float32)
        for b in range(batch):
            fi = rs.randint(len(frames))
            y = rs.randint(0, frames.shape[1] - patch + 1)
            x = rs.randint(0, frames.shape[2] - patch + 1)
            out[b] = frames[fi, y:y + patch, x:x + patch]
        yield out, None


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="distill",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--teacher", default="realesr-animevideov3-x2")
    ap.add_argument("--teacher-weights", default=None)
    ap.add_argument("--student-feat", type=int, default=128)
    ap.add_argument("--student-conv", type=int, default=16)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--patch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--data", default=None,
                    help="video file with training frames (else synthetic)")
    ap.add_argument("--out", default="student.ckpt")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)

    from reve_tpu_torch.models import registry, srvgg
    from reve_tpu_torch.train import checkpoint
    from reve_tpu_torch.train.distill import (DistillConfig, Distiller,
                                              run_distillation)
    from reve_tpu_torch.train.trainer import TrainConfig
    from reve_tpu_torch.weights.torch_loader import save_srvgg_pth

    _spec, scale = registry.parse_model_name(args.teacher)
    tcfg, tparams = registry.load_model(args.teacher, scale,
                                        weights=args.teacher_weights)
    if not isinstance(tcfg, srvgg.SRVGGConfig):
        raise SystemExit(f"--teacher {args.teacher}: distillation takes an "
                         f"SRVGG teacher")
    scfg = srvgg.SRVGGConfig(num_feat=args.student_feat,
                             num_conv=args.student_conv,
                             upscale=tcfg.upscale)
    dist = Distiller(tcfg, tparams, scfg,
                     tc=TrainConfig(learning_rate=args.lr),
                     device=args.device)
    batches = (video_batches(args.data, args.batch, args.patch, tcfg.upscale)
               if args.data else
               synthetic_batches(args.batch, args.patch, tcfg.upscale))
    dc = DistillConfig(steps=args.steps, batch=args.batch, patch=args.patch)
    history = run_distillation(dist, batches, dc)
    probe_lr, _ = next(batches)
    agreement = dist.agreement_psnr(probe_lr)
    print(f"final loss {history[-1]:.5f}; "
          f"student/teacher agreement {agreement:.2f} dB")
    if args.out.endswith(".pth"):
        save_srvgg_pth(args.out, scfg, dist.trainer.export_params())
        print(f"saved student weights: {args.out}")
    else:
        checkpoint.save(args.out, dist.trainer, step=args.steps)
        print(f"saved student checkpoint: {args.out}")
    return {"history": history, "agreement_db": agreement, "out": args.out,
            "distiller": dist}


if __name__ == "__main__":
    main()
