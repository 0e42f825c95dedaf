"""Weight interpolation (upstream Real-ESRGAN's `-dni` / denoise strength).

Counterpart of reve_tpu/weights/interpolate.py, on torch tensors.  The
general model family ships paired checkpoints (`realesr-general-x4v3`
and its `-wdn` weight-denoised twin); denoise strength d in [0,1] is
realized by linearly interpolating every parameter:

    params = (1 - d) * wdn + d * plain      (upstream dni convention)

Works on any two structurally identical params (dicts and lists of
tensors: srvgg or rrdb), in float32 as the reference computes it.
"""

from __future__ import annotations

import torch


def interpolate(params_a, params_b, weight_b: float):
    """(1 - weight_b) * a + weight_b * b, leaf-wise."""
    if not 0.0 <= weight_b <= 1.0:
        raise ValueError(f"interpolation weight must be in [0,1], got "
                         f"{weight_b}")

    def leaf(a, b):
        if isinstance(a, dict):
            if a.keys() != b.keys():
                raise ValueError(f"param keys differ: {sorted(a)} vs "
                                 f"{sorted(b)} — models are not "
                                 f"structurally identical")
            return {k: leaf(a[k], b[k]) for k in a}
        if isinstance(a, (list, tuple)):
            if len(a) != len(b):
                raise ValueError(f"param lists of {len(a)} and {len(b)} — "
                                 f"models are not structurally identical")
            return [leaf(x, y) for x, y in zip(a, b)]
        if not torch.is_tensor(a) or a.shape != b.shape:
            raise ValueError(
                f"param shape mismatch: {tuple(a.shape)} vs "
                f"{tuple(b.shape)} — models are not structurally identical"
            )
        return (1.0 - weight_b) * a + weight_b * b

    return leaf(params_a, params_b)


def load_dni(path_wdn: str, path_plain: str, denoise_strength: float):
    """Load both .pth checkpoints and blend per the upstream dni
    convention (params = (1-d)*wdn + d*plain): denoise_strength 1.0 =
    pure plain model (full denoising), 0.0 = pure wdn twin (weak-denoise,
    preserves grain/detail).  Returns (SRVGGConfig, params)."""
    from reve_tpu_torch.weights.torch_loader import load_srvgg_pth

    cfg_w, params_w = load_srvgg_pth(path_wdn)
    cfg_p, params_p = load_srvgg_pth(path_plain)
    if cfg_w != cfg_p:
        raise ValueError(f"config mismatch: {cfg_w} vs {cfg_p}")
    return cfg_w, interpolate(params_w, params_p, denoise_strength)
