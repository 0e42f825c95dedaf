"""Loader for upstream Real-ESRGAN PyTorch checkpoints (.pth).

Counterpart of reve_tpu/weights/torch_loader.py, loading straight into
the port's params (HWIO float32 torch tensors).  Published
SRVGGNetCompact checkpoints (e.g. realesr-animevideov3.pth) store a state
dict under 'params' with keys:

    body.0.weight / body.0.bias      first conv (OIHW / O)
    body.1.weight                    PReLU alpha
    body.2.weight / body.2.bias ...  alternating conv / prelu
    body.<2*(num_conv+1)>.weight     last conv

`save_srvgg_pth` writes that layout back: how weights trained or
distilled by the port (reve_tpu_torch/train) become product weights, and
how they pass to and from reve_tpu, whose loader reads the same file.
"""

from __future__ import annotations

from typing import Dict

import torch


def _state_dict(path: str) -> Dict[str, torch.Tensor]:
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict):
        for key in ("params", "params_ema", "state_dict"):
            if key in blob and isinstance(blob[key], dict):
                blob = blob[key]
                break
    return {k: v.detach().to("cpu", torch.float32) for k, v in blob.items()}


def load_srvgg_pth(path: str):
    """realesr .pth -> (SRVGGConfig, params)."""
    from reve_tpu_torch.models.srvgg import SRVGGConfig

    sd = _state_dict(path)
    body_idx = sorted(
        {int(k.split(".")[1]) for k in sd if k.startswith("body.")}
    )
    n_body = max(body_idx) + 1
    # layers alternate conv, prelu, conv, prelu, ..., conv
    num_conv = (n_body - 3) // 2
    convs, prelus = [], []
    for i in body_idx:
        w = sd[f"body.{i}.weight"]
        if w.dim() == 4:  # conv, OIHW -> HWIO
            b = sd.get(f"body.{i}.bias", torch.zeros(w.shape[0]))
            convs.append({"w": w.permute(2, 3, 1, 0).contiguous(),
                          "b": b.contiguous()})
        else:  # prelu alpha
            prelus.append({"alpha": w.contiguous()})
    num_feat = int(convs[0]["w"].shape[-1])
    num_in_ch = int(convs[0]["w"].shape[2])
    last_out = int(convs[-1]["w"].shape[-1])
    # upscale from last conv: out_ch * r^2
    for num_out_ch in (num_in_ch, 3, 1):
        r = int(round((last_out / num_out_ch) ** 0.5))
        if r * r * num_out_ch == last_out:
            break
    else:
        raise ValueError(f"cannot infer upscale from last conv ({last_out})")
    cfg = SRVGGConfig(
        num_in_ch=num_in_ch,
        num_out_ch=num_out_ch,
        num_feat=num_feat,
        num_conv=num_conv,
        upscale=r,
    )
    return cfg, {"convs": convs, "prelus": prelus}


def save_srvgg_pth(path: str, cfg, params) -> None:
    """(SRVGGConfig, params) -> realesr-compatible .pth, the inverse of
    load_srvgg_pth and the same file as reve_tpu's save_srvgg_pth: convs
    back to OIHW under the alternating body.<i> numbering, the state dict
    under 'params'."""
    convs, prelus = params["convs"], params["prelus"]
    if len(convs) != cfg.num_conv + 2 or len(prelus) != cfg.num_conv + 1:
        raise ValueError(
            f"params shape mismatch: {len(convs)} convs/{len(prelus)} "
            f"prelus vs cfg num_conv={cfg.num_conv}")

    def cpu(t):
        return t.detach().to("cpu", torch.float32)

    sd = {}
    for i, c in enumerate(convs):
        sd[f"body.{2 * i}.weight"] = cpu(c["w"]).permute(3, 2, 0,
                                                         1).contiguous()
        sd[f"body.{2 * i}.bias"] = cpu(c["b"]).clone()
        if i < len(prelus):
            sd[f"body.{2 * i + 1}.weight"] = cpu(prelus[i]["alpha"]).clone()
    torch.save({"params": sd}, path)
