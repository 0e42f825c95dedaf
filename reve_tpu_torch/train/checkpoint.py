"""Training checkpoints: save and restore a Trainer's state.

Counterpart of reve_tpu/train/checkpoint.py with its layout (one
`step_{:08d}` entry under the checkpoint directory, the newest found by
`latest_step`) and its tolerance of the EMA key both ways.  reve_tpu
writes orbax directories; the port writes `step_{:08d}/state.pt` with
torch.save (the card's machine has no orbax).  So each package reads
its own checkpoints; the weights pass between them as a .pth
(weights/torch_loader.save_srvgg_pth).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from reve_tpu_torch.train.trainer import AdamState, leaves, params_on

STATE = "state.pt"


def _cpu(params):
    return params_on(params, "cpu", False)


def save(path: str, trainer, step: int) -> None:
    """Write params, optimizer state, the EMA (if any) and the step under
    `path/step_{step:08d}/` (the file replaced atomically)."""
    d = os.path.join(os.path.abspath(path), f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    st = trainer.opt_state
    state = {
        "params": _cpu(trainer.params),
        "opt_state": {"count": st.count,
                      "mu": [t.detach().cpu() for t in st.mu],
                      "nu": [t.detach().cpu() for t in st.nu]},
        "step": step,
    }
    if trainer.ema_params is not None:
        state["ema_params"] = _cpu(trainer.ema_params)
    tmp = os.path.join(d, f"{STATE}.tmp{os.getpid()}")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(d, STATE))


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [
        int(name.split("_")[1])
        for name in os.listdir(path)
        if name.startswith("step_") and name.split("_")[1].isdigit()
    ]
    return max(steps) if steps else None


def restore(path: str, trainer, step: Optional[int] = None) -> int:
    """Load the (latest) checkpoint into `trainer`; returns the step.  An
    EMA trainer reading a checkpoint without an EMA seeds it from the
    params; a trainer without an EMA ignores a checkpoint's."""
    path = os.path.abspath(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    state = torch.load(os.path.join(path, f"step_{step:08d}", STATE),
                       map_location="cpu", weights_only=True)
    got = [tuple(t.shape) for t in leaves(state["params"])]
    want = [tuple(t.shape) for t in leaves(trainer.params)]
    if got != want:
        raise ValueError(f"checkpoint {path} step {step} holds params of "
                         f"shapes {got}; the trainer's are {want}")
    dev = trainer.device
    trainer.params = params_on(state["params"], dev, True)
    if trainer.ema_params is not None:
        trainer.ema_params = params_on(
            state.get("ema_params", state["params"]), dev, False)
    opt = state["opt_state"]
    trainer.opt_state = AdamState(
        int(opt["count"]), [t.to(dev) for t in opt["mu"]],
        [t.to(dev) for t in opt["nu"]])
    return int(state["step"])
