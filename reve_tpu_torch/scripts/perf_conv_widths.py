"""K3, K1 and K2 (and in int8 K4a, K4 and K4h) at the SRVGG widths, per
call of the main path's batch.

    python -m reve_tpu_torch.scripts.perf_conv_widths [--widths 32 64 96 128]
        [--dtypes bfloat16 float32 int8] [--scales 2 3 4] [--iters N]

At a batch of 4 frames of 1920 x 1080 with seeded inputs (made on the
card): K3 on the u8 frames (3 -> F), K1 over F channels (F -> F) and K2
at each scale (F -> 3r^2 with the u8 residual and the shuffle), each
through its wrapper (float32 K1 and K2 with their split pass; at the
wide widths float32 K1 and K2 also as the model calls them there,
`k1_planes` and `k2_planes_x{r}`: on the split planes of their input, K1
writing those of its output), and the
whole model (`srvgg.apply`, u8 -> u8, F features,
16 convs, x4, seeded init).  `--dtypes int8` (or `--dtype int8`) times
the int8 forms instead: K4a on the u8 frames (3 -> F, bfloat16 compute,
s8 out), K4 over F s8 channels and K4h at each scale, on seeded codes
and weights, and the int8 model (`srvgg.apply_int8` with the same seeded
init, quantized from the float32 calibration statistic of its first
frame).  For each form it prints its time a call (CUDA events over
`--iters` calls after one warm-up call) and the sha256 of its output, so
two checkouts' outputs can be compared bit for bit; then nvidia-smi's
name and power limit.  One JSON line.

The parent's kernels: run this file by path with PYTHONPATH at a `git
archive` of the parent (a parent without the wide forms takes `--widths
64` only); alternate the two (parent, change, change, parent) in one
call to the card to compare their times.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

import torch

from reve_tpu_torch.kernels import conv3x3, conv3x3_s8, head
from reve_tpu_torch.models import srvgg
from reve_tpu_torch.weights import quantize

H, W, FRAMES = 1080, 1920, 4
#: the SRVGG widths timed by default (kernels.conv3x3.WIDTHS)
WIDTHS = (32, 64, 96, 128)


def events_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def forms(feat: int, dtype: torch.dtype, scales, seed: int = 0) -> dict:
    """name -> the call of each form at `feat` features, on seeded inputs
    (uniform(+-1/sqrt(9 Cin)) weights, activations in [-0.5, 1.5))."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed * 1000 + feat)

    def unif(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    u8 = torch.randint(0, 256, (FRAMES, H, W, 3), generator=gen, device=dev,
                       dtype=torch.uint8)
    x = unif((FRAMES, H, W, feat), -0.5, 1.5).to(dtype)
    b0, b1 = 1 / 27 ** 0.5, 1 / (9 * feat) ** 0.5
    w3 = unif((3, 3, 3, feat), -b0, b0).to(dtype)
    w1 = unif((3, 3, feat, feat), -b1, b1).to(dtype)
    b, a = unif((feat,), -0.1, 0.1), unif((feat,), 0.05, 0.4)
    calls = {
        "k3": lambda: conv3x3.conv3x3_u8_bias_prelu(u8, w3, b, a),
        "k1": lambda: conv3x3.conv3x3_bias_prelu(x, w1, b, a),
    }
    xp = None
    if dtype == torch.float32 and feat != conv3x3.FEAT:
        # K1 as the float32 model calls it there: planes in, planes out
        xp = conv3x3.split_bf16x3(x)
        calls["k1_planes"] = lambda: conv3x3.conv3x3_bias_prelu_planes(
            xp, w1, b, a)
    for r in scales:
        wh = unif((3, 3, feat, 3 * r * r), -b1, b1).to(dtype)
        bh = unif((3 * r * r,), -0.1, 0.1)
        calls[f"k2_x{r}"] = (lambda wh=wh, bh=bh, r=r:
                             head.head_conv_residual_u8_shuffle(
                                 x, wh, bh, u8, r))
        if xp is not None:
            # ... and K2 as it calls it: on those planes, no split pass
            calls[f"k2_planes_x{r}"] = (lambda wh=wh, bh=bh, r=r:
                                        head.head_conv_residual_u8_shuffle(
                                            xp, wh, bh, u8, r))
    cfg = srvgg.SRVGGConfig(num_feat=feat, num_conv=16, upscale=4)
    params = srvgg.params_to(srvgg.init_params(
        cfg, torch.Generator().manual_seed(feat)), dev)
    calls["model"] = lambda: srvgg.apply(params, u8, cfg=cfg,
                                         compute_dtype=dtype)
    return calls


def int8_forms(feat: int, scales, seed: int = 0) -> dict:
    """name -> the call of each int8 form at `feat` features, on seeded
    inputs: s8 codes and weights uniform in [-127, 127], K4's scale
    2e-6..2e-5 and K4h's 1e-8..1e-7 (sums of 9 F codes' products land
    on many codes), inv 1 / 0.02; K4a's bf16 weights as K3's."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed * 1000 + feat + 7)

    def unif(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    u8 = torch.randint(0, 256, (FRAMES, H, W, 3), generator=gen, device=dev,
                       dtype=torch.uint8)
    x8 = codes((FRAMES, H, W, feat))
    b0 = 1 / 27 ** 0.5
    w3 = unif((3, 3, 3, feat), -b0, b0).to(torch.bfloat16)
    w8 = codes((3, 3, feat, feat))
    b, a = unif((feat,), -0.1, 0.1), unif((feat,), 0.05, 0.4)
    scale = unif((feat,), 2e-6, 2e-5)
    inv = torch.tensor([1 / 0.02], device=dev)
    calls = {
        "k4a": lambda: conv3x3.conv3x3_u8_bias_prelu_q8(u8, w3, b, a, inv),
        "k4": lambda: conv3x3_s8.conv3x3_s8_dq_prelu_q8(x8, w8, scale, b,
                                                        a, inv),
    }
    for r in scales:
        wh = codes((3, 3, feat, 3 * r * r))
        sh, bh = unif((3 * r * r,), 1e-8, 1e-7), unif((3 * r * r,), -0.1,
                                                      0.1)
        calls[f"k4h_x{r}"] = (lambda wh=wh, sh=sh, bh=bh, r=r:
                              head.head_conv_s8_residual_u8_shuffle(
                                  x8, wh, sh, bh, u8, r))
    cfg = srvgg.SRVGGConfig(num_feat=feat, num_conv=16, upscale=4)
    params = srvgg.params_to(srvgg.init_params(
        cfg, torch.Generator().manual_seed(feat)), dev)
    maxima = quantize.collect_act_maxima(params, u8[:1], cfg=cfg,
                                         percentile=99.9)
    qb = quantize.build_qbody(params, cfg, maxima, margin=1.25)
    calls["model"] = lambda: srvgg.apply_int8(params, qb, u8, cfg=cfg)
    return calls


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--widths", type=int, nargs="+", default=list(WIDTHS))
    p.add_argument("--dtypes", "--dtype", nargs="+",
                   default=["bfloat16", "float32"],
                   choices=["bfloat16", "float32", "int8"])
    p.add_argument("--scales", type=int, nargs="+", default=[2, 3, 4])
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("perf_conv_widths needs a CUDA device")
    res = {}
    for feat in args.widths:
        for name in args.dtypes:
            calls = int8_forms(feat, args.scales) if name == "int8" \
                else forms(feat, getattr(torch, name), args.scales)
            for form, fn in calls.items():
                out = fn()
                res[f"{form}_f{feat}_{name}"] = {
                    "ms": events_ms(fn, args.iters), "sha256": digest(out)}
                del out
            del calls
            torch.cuda.empty_cache()
    res["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
