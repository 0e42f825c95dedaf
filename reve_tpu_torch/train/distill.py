"""Teacher -> student distillation of SRVGG upscalers.

Counterpart of reve_tpu/train/distill.py: supervised training where the
target batch is clip(teacher(lr), 0, 1) instead of a ground-truth HR
frame, optionally blended with real HR targets (`hr_weight`).  The
teacher's forward runs T1 alone, writing no z, outside autograd.

Driven by reve_tpu_torch/scripts/distill.py.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from reve_tpu_torch import device as device_mod
from reve_tpu_torch.models import srvgg
from reve_tpu_torch.train.trainer import TrainConfig, Trainer, params_on


@dataclasses.dataclass
class DistillConfig:
    steps: int = 1000
    batch: int = 8
    patch: int = 64              # LR patch size fed to both nets
    hr_weight: float = 0.0       # 0 = pure distillation
    log_every: int = 50


class Distiller:
    """Owns a frozen teacher and a student Trainer.  `student_params`
    starts the student from given weights (reve_tpu's Distiller always
    draws them from `seed`); `device` as Trainer's."""

    def __init__(self, teacher_cfg: srvgg.SRVGGConfig, teacher_params,
                 student_cfg: srvgg.SRVGGConfig,
                 tc: Optional[TrainConfig] = None, seed: int = 0,
                 device: device_mod.DeviceLike = None,
                 student_params=None):
        if teacher_cfg.upscale != student_cfg.upscale:
            raise ValueError("teacher/student scale mismatch")
        self.teacher_cfg = teacher_cfg
        self.trainer = Trainer(student_cfg, tc=tc, params=student_params,
                               seed=seed, device=device)
        self.teacher_params = params_on(teacher_params, self.trainer.device,
                                        False)

    @torch.no_grad()
    def teacher_targets(self, lr_batch) -> torch.Tensor:
        return torch.clamp(srvgg.apply_float(
            self.teacher_params, self.trainer.to_device(lr_batch),
            cfg=self.teacher_cfg, plain=self.trainer.plain), 0.0, 1.0)

    def step(self, lr_batch, hr_batch=None, hr_weight: float = 0.0) -> float:
        """One distillation step.  With hr_weight in (0, 1], the target is
        a blend of the teacher output and the real HR frame."""
        target = self.teacher_targets(lr_batch)
        if hr_batch is not None and hr_weight > 0:
            target = (1.0 - hr_weight) * target + \
                hr_weight * self.trainer.to_device(hr_batch)
        return self.trainer.step(lr_batch, target)

    def agreement_psnr(self, lr_batch) -> float:
        """PSNR between student and teacher outputs (the distillation
        objective's own metric)."""
        return self.trainer.eval_psnr(lr_batch,
                                      self.teacher_targets(lr_batch))


def run_distillation(
    distiller: Distiller, batches: Iterator[Tuple[np.ndarray,
                                                  Optional[np.ndarray]]],
    dc: DistillConfig, log=print,
) -> list:
    """Drive `dc.steps` steps from an (lr, hr|None) batch iterator; returns
    the loss history."""
    history = []
    for step, (lr_b, hr_b) in enumerate(batches):
        if step >= dc.steps:
            break
        loss = distiller.step(lr_b, hr_b, hr_weight=dc.hr_weight)
        history.append(loss)
        if dc.log_every and step % dc.log_every == 0:
            log(f"step {step}: loss {loss:.5f}")
    return history
