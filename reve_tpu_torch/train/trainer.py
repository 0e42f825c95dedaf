"""Fine-tuning of SRVGG upscalers on one CUDA device.

Counterpart of reve_tpu/train/trainer.py: fine-tune `realesr-animevideov3`
on your own footage, or (train/distill.py) distill it into another
SRVGG shape.  The loss is reve_tpu's: charbonnier (or l1) of the float32
forward `srvgg.apply_float`, whose convolutions run forward on T1 and
backward on T2 and T3.  The optimizer is reve_tpu's optax chain written
out: clip_by_global_norm(grad_clip) (t / norm * max_norm when norm >=
max_norm; not torch's clip_grad_norm_, which divides by norm + 1e-6),
then, with weight_decay, L2 added to the gradient (add_decayed_weights,
not AdamW), then adam(learning_rate) with b1 0.9, b2 0.999, eps 1e-8 and
bias correction.  Params, optimizer moments and the EMA are updated in
place, each op of the chain over all leaves at once.

reve_tpu shards the batch over a mesh; the port runs on one device (a
mesh waits on the "Multi-GPU training" item of ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from reve_tpu_torch import device as device_mod
from reve_tpu_torch.kernels import train as train_kernels
from reve_tpu_torch.models import srvgg
from reve_tpu_torch.train import losses


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    loss: str = "charbonnier"   # charbonnier | l1
    # exponential moving average of the params (the upstream Real-ESRGAN
    # convention, 0.999); 0 disables.  The EMA copy is what is exported.
    ema_decay: float = 0.999


_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AdamState:
    """optax's ScaleByAdamState: the step count and the two moments, one
    tensor per leaf of `leaves(params)`."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def leaves(params) -> List[torch.Tensor]:
    """The params' tensors in a fixed order (kernels.train.flat_params)."""
    return train_kernels.flat_params(params)


def init_opt_state(params) -> AdamState:
    return AdamState(0, [torch.zeros_like(p) for p in leaves(params)],
                     [torch.zeros_like(p) for p in leaves(params)])


def loss_fn(params, lr_batch: torch.Tensor, hr_batch: torch.Tensor, *,
            cfg: srvgg.SRVGGConfig, loss: str = "charbonnier",
            plain: bool = False) -> torch.Tensor:
    pred = srvgg.apply_float(params, lr_batch, cfg=cfg, plain=plain)
    fn = losses.charbonnier if loss == "charbonnier" else losses.l1
    return fn(pred, hr_batch)


@torch.no_grad()
def apply_optimizer(params, grads: List[torch.Tensor], state: AdamState,
                    tc: TrainConfig) -> None:
    """One step of the optimizer chain on `params` in place (optax's
    tx.update then apply_updates), with no host synchronisation.  Each op
    runs over all leaves at once (torch._foreach_*), with the elementwise
    arithmetic of optax's: a step is a few dozen launches, not some
    fifteen for each of the leaves."""
    ps = leaves(params)
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    # clip_by_global_norm: t where norm < max, else (t / norm) * max; t / 1
    # * 1 is t exactly
    clip = torch.logical_not(g_norm < tc.grad_clip)
    one = torch.ones_like(g_norm)
    grads = torch._foreach_div(grads, torch.where(clip, g_norm, one))
    torch._foreach_mul_(grads, torch.where(clip, one * tc.grad_clip, one))
    if tc.weight_decay:
        torch._foreach_add_(grads, torch._foreach_mul(ps, tc.weight_decay))
    state.count += 1
    # optax bias_correction: 1 - decay ** count in float32
    bc1 = float(np.float32(1) - np.float32(_B1) ** np.int32(state.count))
    bc2 = float(np.float32(1) - np.float32(_B2) ** np.int32(state.count))
    # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
    torch._foreach_mul_(state.mu, _B1)
    torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - _B1))
    g2 = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(g2, 1 - _B2)
    torch._foreach_mul_(state.nu, _B2)
    torch._foreach_add_(state.nu, g2)
    # p += -lr * (mu / bc1) / (sqrt(nu / bc2) + eps)
    den = torch._foreach_div(state.nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, _EPS)
    upd = torch._foreach_div(state.mu, bc1)
    torch._foreach_div_(upd, den)
    torch._foreach_mul_(upd, -tc.learning_rate)
    torch._foreach_add_(ps, upd)


def train_step(params, opt_state: AdamState, lr_batch: torch.Tensor,
               hr_batch: torch.Tensor, *, cfg: srvgg.SRVGGConfig,
               tc: TrainConfig, plain: bool = False) -> torch.Tensor:
    """One optimizer step on `params` and `opt_state` in place; returns
    the loss before the step (reve_tpu's train_step, value_and_grad then
    the optimizer)."""
    ps = leaves(params)
    loss_val = loss_fn(params, lr_batch, hr_batch, cfg=cfg, loss=tc.loss,
                       plain=plain)
    grads = torch.autograd.grad(loss_val, ps)
    apply_optimizer(params, list(grads), opt_state, tc)
    return loss_val.detach()


@torch.no_grad()
def ema_update(ema_params, params, *, decay: float) -> None:
    """ema <- ema * decay + params * (1 - decay), leafwise, in place."""
    es = leaves(ema_params)
    torch._foreach_mul_(es, decay)
    torch._foreach_add_(es, torch._foreach_mul(leaves(params), 1.0 - decay))


def params_on(params, device, requires_grad: bool):
    """A copy of `params` on `device` as float32 leaf tensors."""
    def leaf(t):
        return torch.as_tensor(t, dtype=torch.float32).detach().to(
            device).clone().requires_grad_(requires_grad)

    return {"convs": [{k: leaf(v) for k, v in c.items()}
                      for c in params["convs"]],
            "prelus": [{k: leaf(v) for k, v in p.items()}
                       for p in params["prelus"]]}


def check_params(cfg: srvgg.SRVGGConfig, params) -> None:
    """The params' shapes are those of `cfg` (what reve_tpu's init gives)."""
    want = srvgg.init_params(cfg)
    for a, b in zip(leaves(params), leaves(want)):
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"params shape {tuple(a.shape)} where {cfg} "
                             f"needs {tuple(b.shape)}")
    if len(leaves(params)) != len(leaves(want)):
        raise ValueError(f"params hold {len(leaves(params))} tensors; {cfg} "
                         f"needs {len(leaves(want))}")


class Trainer:
    """Owns the params, the optimizer state and the EMA on one device.

    `device`: None runs on cuda:0 and raises without CUDA; pass
    device="cpu" to train through the kernels' plain versions on the
    CPU.  `params`: the port's layout (srvgg.params_from_jax carries
    reve_tpu's across); None draws srvgg.init_params from `seed`.
    `plain=True` runs the kernels' plain versions on any device (the
    reference path)."""

    def __init__(self, cfg: srvgg.SRVGGConfig,
                 tc: Optional[TrainConfig] = None, params=None,
                 seed: int = 0, device: device_mod.DeviceLike = None,
                 plain: bool = False):
        self.cfg = cfg
        self.tc = tc or TrainConfig()
        self.device = device_mod.resolve_device(device)
        self.plain = plain
        if params is None:
            params = srvgg.init_params(cfg, torch.Generator().manual_seed(
                seed))
        check_params(cfg, params)
        self.params = params_on(params, self.device, True)
        self.opt_state = init_opt_state(self.params)
        self.ema_params = params_on(self.params, self.device, False) \
            if self.tc.ema_decay else None

    def to_device(self, batch) -> torch.Tensor:
        """A host (numpy) or torch batch as float32 on the trainer's
        device."""
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(np.ascontiguousarray(batch,
                                                          np.float32))
        return batch.to(self.device, torch.float32).contiguous()

    def step(self, lr_batch, hr_batch) -> float:
        loss_val = train_step(self.params, self.opt_state,
                              self.to_device(lr_batch),
                              self.to_device(hr_batch), cfg=self.cfg,
                              tc=self.tc, plain=self.plain)
        if self.ema_params is not None:
            ema_update(self.ema_params, self.params,
                       decay=self.tc.ema_decay)
        return float(loss_val)

    def export_params(self):
        """Params to ship: the EMA copy when enabled, else the live ones."""
        return self.ema_params if self.ema_params is not None else self.params

    @torch.no_grad()
    def eval_psnr(self, lr_batch, hr_batch) -> float:
        pred = srvgg.apply_float(self.params, self.to_device(lr_batch),
                                 cfg=self.cfg, plain=self.plain)
        return float(losses.psnr(torch.clamp(pred, 0, 1),
                                 self.to_device(hr_batch)))
