"""Quickest proof that the PyTorch/CUDA port runs on a GPU.

    python3 chip_smoke.py

Drives reve_tpu_torch on one CUDA device, in phases that each print one
JSON line; any failure exits non-zero (no phase catches and continues):

  1. device   the card's name, and its name and power limit as nvidia-smi
              reports them;
  2. build    nvcc builds every kernel of the main path from the sources
              in this checkout (sm_90a), all at once;
  3. kernels  K3, K1 and K2 at the main path's shapes (1080p frames, a
              batch of 4, x4), in bfloat16 and float32: each kernel against
              its plain PyTorch version on the same inputs (float32:
              max |d| <= 1e-4, float32 accumulation order; bfloat16: <= 2
              bf16 ulp relative, the ulp taken at 2^-10 or more; uint8:
              |d| <= 1), then timed beside the
              plain version, one cuDNN F.conv2d of the same conv
              (library_ms; the port never calls it) and the card's bound;
  4. main     the product job through the port's CLI: 8 frames of
              1920x1080 -> 7680x4320 (x4, realesr-animevideov3 at its full
              64-feature, 16-conv width, the shipped weights), default
              --dtype auto (= bfloat16).  Launch counters are zeroed just
              before and read just after; each kernel must have run.
              Output frame 0 is held against the port's plain float32 path
              on the card (PSNR >= srvgg.BF16_PSNR_FLOOR_DB).  The job
              runs with --trace: the phase reports seconds per scheduler
              span and the model's device time as a share of the wall.

The line before the last is nvidia-smi's name and power limit; before
that, one JSON object {"kernels": [...]} with each kernel's launches on
the main path, error, times and bound.  The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import fractions
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
#: H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor rate, float32
#: rate outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
FRAMES, W, H, SCALE, BATCH = 8, 1920, 1080, 4, 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase(name: str, record: dict):
    t0 = time.perf_counter()
    yield record
    record.update(phase=name, ok=True,
                  seconds=round(time.perf_counter() - t0, 3))
    emit(record)


def cuda_time_ms(fn, iters: int = 10) -> float:
    import torch

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


def bf16_ulp_ok(got, want, ulps: int = 2) -> bool:
    """|got - want| <= ulps bf16 ulp of the larger magnitude.  The ulp is
    taken at 2^-10 or more: a float32 sum that cancels to near zero
    carries accumulation-order noise (~1e-6 here) that may flip its sign
    between two summation orders, and PReLU then scales one side by
    alpha — a tiny absolute difference that is many ulp of the tiny
    value."""
    import torch

    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -10)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    bad = (g - w).abs() > ulps * ulp
    if bool(bad.any()):
        print(f"# {int(bad.sum())} values beyond {ulps} bf16 ulp, e.g. "
              f"kernel {g[bad][:4].tolist()} vs plain {w[bad][:4].tolist()}",
              flush=True)
        return False
    return True


def bound_ms(nbytes: int, flops: int, dtype: str):
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def frames_u8(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """Seeded gradients + noise, the smoke's stand-in for video content."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.int32)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        grad = np.stack([(yy // 4 + 9 * i) % 256, (xx // 7) % 256,
                         ((yy + xx) // 9 + 3 * i) % 256], -1)
        out[i] = np.clip(grad + rs.randint(-16, 17, grad.shape), 0, 255)
    return out


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * math.log10(255.0 ** 2 / max(mse, 1e-12)))


def kernel_phase(params, cfg, frames, out: dict) -> dict:
    """Each kernel against its plain version, then timed, in both dtypes.
    Inputs chain like the model's: K3 on the frames, K1 on K3's output,
    K2 on K1's output, with the model's real weights."""
    import torch
    import torch.nn.functional as F

    from reve_tpu_torch import device as device_mod
    from reve_tpu_torch.kernels import conv3x3, head

    dev = torch.device("cuda", 0)
    u8 = torch.from_numpy(frames).to(dev)
    B = u8.shape[0]
    px = B * H * W
    feat, r = cfg.num_feat, cfg.upscale
    c0, c1, cl = params["convs"][0], params["convs"][1], params["convs"][-1]
    a0, a1 = params["prelus"][0]["alpha"], params["prelus"][1]["alpha"]
    results = {}
    for name in ("bfloat16", "float32"):
        dt = getattr(torch, name)
        bpe = torch.finfo(dt).bits // 8
        w0, w1, wl = (c["w"].to(dt).contiguous() for c in (c0, c1, cl))
        device_mod.strict_f32()
        x3 = conv3x3.conv3x3_u8_bias_prelu_plain(u8, w0, c0["b"], a0)
        x1 = conv3x3.conv3x3_bias_prelu_plain(x3, w1, c1["b"], a1)
        cases = {
            "conv3x3_u8_bias_prelu": dict(
                kernel=lambda: conv3x3.conv3x3_u8_bias_prelu(
                    u8, w0, c0["b"], a0),
                plain=lambda: conv3x3.conv3x3_u8_bias_prelu_plain(
                    u8, w0, c0["b"], a0),
                lib_in=u8.permute(0, 3, 1, 2).to(dt).contiguous(
                    memory_format=torch.channels_last),
                lib_w=w0, lib_b=c0["b"],
                nbytes=px * 3 + px * feat * bpe + w0.numel() * bpe + 2 * feat
                * 4,
                flops=2 * 9 * 3 * feat * px),
            "conv3x3_bias_prelu": dict(
                kernel=lambda: conv3x3.conv3x3_bias_prelu(
                    x3, w1, c1["b"], a1),
                plain=lambda: conv3x3.conv3x3_bias_prelu_plain(
                    x3, w1, c1["b"], a1),
                lib_in=x3.permute(0, 3, 1, 2), lib_w=w1, lib_b=c1["b"],
                nbytes=2 * px * feat * bpe + w1.numel() * bpe + 2 * feat * 4,
                flops=2 * 9 * feat * feat * px),
            "head_conv_residual_u8_shuffle": dict(
                kernel=lambda: head.head_conv_residual_u8_shuffle(
                    x1, wl, cl["b"], u8, r),
                plain=lambda: head.head_conv_residual_u8_shuffle_plain(
                    x1, wl, cl["b"], u8, r),
                lib_in=x1.permute(0, 3, 1, 2), lib_w=wl, lib_b=cl["b"],
                nbytes=px * feat * bpe + px * 3 + px * r * r * 3
                + wl.numel() * bpe + 3 * r * r * 4,
                flops=2 * 9 * feat * 3 * r * r * px),
        }
        for kname, c in cases.items():
            got, want = c["kernel"](), c["plain"]()
            torch.cuda.synchronize()
            if got.dtype == torch.uint8:
                err = (got.int() - want.int()).abs().max().item()
                ok = err <= 1
            else:
                err = (got.float() - want.float()).abs().max().item()
                ok = err <= 1e-4 if name == "float32" else \
                    bf16_ulp_ok(got, want)
            if not ok:
                raise AssertionError(f"{kname} {name}: kernel disagrees "
                                     f"with its plain version (max |d| "
                                     f"{err})")
            lib_w = c["lib_w"].permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            lib_in = c["lib_in"].contiguous(memory_format=torch.channels_last)
            lib_b = c["lib_b"].to(dt)
            bms, bby = bound_ms(c["nbytes"], c["flops"], name)
            results.setdefault(kname, {})[name] = {
                "max_abs_err": err,
                "ms": cuda_time_ms(c["kernel"]),
                "plain_ms": cuda_time_ms(c["plain"]),
                "library_ms": cuda_time_ms(
                    lambda: F.conv2d(lib_in, lib_w, lib_b, padding=1)),
                "bound_ms": bms, "bound_by": bby,
                "shape": list(got.shape),
            }
            del got, want
        del x3, x1
        torch.cuda.empty_cache()
    out["kernels"] = results
    return results


def model_ms(params, cfg, frames) -> dict:
    """The whole model, u8 -> u8 on the card, per batch of BATCH frames."""
    import torch

    from reve_tpu_torch.models import srvgg

    u8 = torch.from_numpy(frames).to("cuda")
    return {name: cuda_time_ms(lambda: srvgg.apply(
        params, u8, cfg=cfg, compute_dtype=getattr(torch, name)), iters=3)
        for name in ("bfloat16", "float32")}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from reve_tpu_torch import cli, kernels
    from reve_tpu_torch.io import reader, writer
    from reve_tpu_torch.kernels import build
    from reve_tpu_torch.models import srvgg
    from reve_tpu_torch.weights.torch_loader import load_srvgg_pth

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    with phase("device", {}) as rec:
        rec.update(kind=torch.cuda.get_device_name(0),
                   count=torch.cuda.device_count(), nvidia_smi=smi,
                   torch=torch.__version__, cuda=torch.version.cuda)

    with phase("build", {}) as rec:
        info = build.load_all()
        rec["sources"] = {s: {"seconds": round(v["seconds"], 3),
                              "cached": v["cached"]}
                          for s, v in info.items()}
        for s, v in info.items():
            print(f"# {s}: " + " | ".join(
                ln.strip() for ln in v["log"].splitlines()
                if "registers" in ln or "spill" in ln), flush=True)

    weights = os.path.join(ROOT, "models", "realesr-animevideov3-x4.pth")
    cfg, params = load_srvgg_pth(weights)
    assert (cfg.num_feat, cfg.num_conv, cfg.upscale) == (64, 16, SCALE)
    params = srvgg.params_to(params, "cuda")
    frames = frames_u8(FRAMES, H, W)

    with phase("kernels", {"batch": BATCH, "h": H, "w": W,
                           "scale": SCALE}) as rec:
        results = kernel_phase(params, cfg, frames[:BATCH], rec)
        batch_ms = model_ms(params, cfg, frames[:BATCH])
        rec["model_ms_per_batch"] = batch_ms

    work = tempfile.mkdtemp(prefix=".chip_smoke-", dir=ROOT)
    try:
        inp = os.path.join(work, "in.y4m")
        out = os.path.join(work, "out.y4m")
        trace = os.path.join(work, "trace.jsonl")
        with writer.Y4MWriter(inp, W, H, fractions.Fraction(24)) as wr:
            for f in frames:
                wr.write(f)
        argv = ["-i", inp, "-s", str(SCALE), out, "--io-backend", "y4m",
                "--weights", weights, "-S", "4", "--batch", str(BATCH),
                "--yes", "--trace", trace]
        with phase("main", {"argv": argv[4:]}) as rec:
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            rc = cli.run(argv)
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            if rc != 0:
                raise AssertionError(f"cli.run exited {rc}")
            rd = reader.Y4MReader(out)
            shape = (rd.frame_count(), rd.width, rd.height)
            if shape != (FRAMES, W * SCALE, H * SCALE):
                raise AssertionError(f"output {shape}, expected "
                                     f"{(FRAMES, W * SCALE, H * SCALE)}")
            calls = launches["conv3x3_u8_bias_prelu"]
            if calls < math.ceil(FRAMES / BATCH) or \
                    launches["conv3x3_bias_prelu"] != cfg.num_conv * calls \
                    or launches["head_conv_residual_u8_shuffle"] != calls:
                raise AssertionError(f"launch counts {launches} do not "
                                     f"show the main path's kernels")
            # frame 0 against the plain float32 path on the card, taken
            # through the same y4m encode as the job's output
            in0 = next(reader.Y4MReader(inp).read_range(0, 1))
            ref = srvgg.apply(params, torch.from_numpy(in0[None]).cuda(),
                              cfg=cfg, compute_dtype=torch.float32,
                              plain=True)[0].cpu().numpy()
            ref_path = os.path.join(work, "ref.y4m")
            with writer.open_writer(ref_path, W * SCALE, H * SCALE,
                                    fractions.Fraction(24),
                                    backend="y4m") as wr:
                wr.write(ref)
            ref_dec = next(reader.Y4MReader(ref_path).read_range(0, 1))
            got0 = next(rd.read_range(0, 1))
            db = psnr(got0, ref_dec)
            if not db >= srvgg.BF16_PSNR_FLOOR_DB:
                raise AssertionError(f"frame 0 PSNR {db:.2f} dB vs the "
                                     f"plain float32 path < "
                                     f"{srvgg.BF16_PSNR_FLOOR_DB} dB")
            # where the job's wall time went: seconds summed per scheduler
            # span (submit on the main thread; device_wait and
            # encode_batch on the encode thread), and the model's device
            # time from the kernels phase (calls x ms per batch)
            spans = {}
            with open(trace) as f:
                for ln in f:
                    ev = json.loads(ln)
                    if "dur" in ev:
                        spans[ev["ev"]] = spans.get(ev["ev"], 0.0) + ev["dur"]
            model_s = calls * batch_ms["bfloat16"] / 1e3
            rec.update(rc=rc, frames=FRAMES, wall_s=round(wall, 3),
                       fps_end_to_end=FRAMES / wall, launches=launches,
                       model_calls=calls, psnr_db_vs_plain_f32=db,
                       psnr_floor_db=srvgg.BF16_PSNR_FLOOR_DB,
                       output=[W * SCALE, H * SCALE], span_s=spans,
                       model_device_s=model_s,
                       model_share_of_wall=model_s / wall)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    sources = {
        "conv3x3_u8_bias_prelu": (
            "reve_tpu_torch/kernels/csrc/conv3x3.cu",
            "reve_tpu/models/srvgg.py:203"),
        "conv3x3_bias_prelu": (
            "reve_tpu_torch/kernels/csrc/conv3x3.cu",
            "reve_tpu/models/srvgg.py:206"),
        "head_conv_residual_u8_shuffle": (
            "reve_tpu_torch/kernels/csrc/head.cu",
            "reve_tpu/models/srvgg.py:211"),
    }
    line = []
    for name, (src, replaces) in sources.items():
        main_dt = results[name]["bfloat16"]
        line.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": main_dt["max_abs_err"], "ms": main_dt["ms"],
            "plain_ms": main_dt["plain_ms"], "bound_ms": main_dt["bound_ms"],
            "bound_by": main_dt["bound_by"],
            "library_ms": main_dt["library_ms"], "dtype": "bfloat16",
            "shape": main_dt["shape"],
            "float32": results[name]["float32"],
        })
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
