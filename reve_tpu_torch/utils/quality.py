"""Image/video quality metrics: PSNR and SSIM, per-frame and aggregate.

This is the acceptance tooling for the numeric-parity requirement (per-frame
PSNR >= 50 dB vs the reference ncnn outputs, BASELINE.md): once real weights
are present, run

    python -m reve_tpu_torch.utils.quality ours.mp4 reference.mp4

to get per-frame and mean PSNR/SSIM between two videos (or two image dirs).

The port's copy of reve_tpu/utils/quality.py (numpy), reading the videos
through the port's own readers (io/reader.py).
"""

from __future__ import annotations

import json
import sys
from typing import Iterator, Optional, Tuple

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 255.0) -> float:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(max_val * max_val / mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - size // 2
    k = np.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    k = np.outer(k, k)
    return k / k.sum()


def _filter2(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Valid-mode 2D correlation per channel (small images; numpy only)."""
    kh, kw = kernel.shape
    h, w = img.shape[:2]
    out_h, out_w = h - kh + 1, w - kw + 1
    strides = img.strides[:2] + img.strides[:2] + img.strides[2:]
    shape = (out_h, out_w, kh, kw) + img.shape[2:]
    windows = np.lib.stride_tricks.as_strided(img, shape, strides)
    return np.einsum("ijklc,kl->ijc", windows, kernel)


def ssim(a: np.ndarray, b: np.ndarray, max_val: float = 255.0) -> float:
    """Mean SSIM over channels (standard 11x11 gaussian window)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    k = _gaussian_kernel()
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_a = _filter2(a, k)
    mu_b = _filter2(b, k)
    mu_a2, mu_b2, mu_ab = mu_a ** 2, mu_b ** 2, mu_a * mu_b
    sig_a = _filter2(a * a, k) - mu_a2
    sig_b = _filter2(b * b, k) - mu_b2
    sig_ab = _filter2(a * b, k) - mu_ab
    num = (2 * mu_ab + c1) * (2 * sig_ab + c2)
    den = (mu_a2 + mu_b2 + c1) * (sig_a + sig_b + c2)
    return float(np.mean(num / den))


def frame_pairs(path_a: str, path_b: str,
                limit: Optional[int] = None
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    from reve_tpu_torch.io import reader

    with reader.open_reader(path_a) as ra, reader.open_reader(path_b) as rb:
        it_a = ra.read_range(0, limit or 10 ** 9)
        it_b = rb.read_range(0, limit or 10 ** 9)
        for fa, fb in zip(it_a, it_b):
            yield fa, fb


def compare_videos(path_a: str, path_b: str,
                   limit: Optional[int] = None,
                   with_ssim: bool = True) -> dict:
    """Per-frame PSNR (and SSIM) between two videos; returns aggregates."""
    psnrs, ssims = [], []
    for fa, fb in frame_pairs(path_a, path_b, limit):
        if fa.shape != fb.shape:
            raise ValueError(f"frame shape mismatch: {fa.shape} vs {fb.shape}")
        psnrs.append(psnr(fa, fb))
        if with_ssim:
            ssims.append(ssim(fa, fb))
    if not psnrs:
        raise ValueError("no comparable frames")
    report = {
        "frames": len(psnrs),
        "psnr_mean": round(float(np.mean(psnrs)), 3),
        "psnr_min": round(float(np.min(psnrs)), 3),
        "psnr_p5": round(float(np.percentile(psnrs, 5)), 3),
    }
    if with_ssim:
        report["ssim_mean"] = round(float(np.mean(ssims)), 5)
    return report


def main():
    if len(sys.argv) < 3:
        print("usage: python -m reve_tpu_torch.utils.quality A B "
              "[max_frames]", file=sys.stderr)
        sys.exit(2)
    limit = int(sys.argv[3]) if len(sys.argv) > 3 else None
    print(json.dumps(compare_videos(sys.argv[1], sys.argv[2], limit)))


if __name__ == "__main__":
    main()


def temporal_consistency(frames: "list[np.ndarray]",
                         ref_frames: "list[np.ndarray] | None" = None,
                         scale: int = 1) -> dict:
    """Temporal-stability metrics for an upscaled sequence (ROADMAP #8).

    Flicker = mean |frame[t+1] - frame[t]|.  An upscaler that hallucinates
    differently per frame inflates output flicker relative to the input's
    own motion energy; the reference's engine processes frames
    independently (reve-shared/src/lib.rs:129-155 runs ncnn per frame), so
    this ratio is the honest apples-to-apples comparison axis.

    Args:
      frames: output frames (uint8 HxWx3), >= 2.
      ref_frames: optional input frames; when given, `flicker_ratio` =
        output flicker / input flicker after nearest-upsampling the input
        by `scale` (ratio ~1.0 = no added temporal noise).
    """
    assert len(frames) >= 2, "need at least 2 frames"
    diffs = [
        float(np.mean(np.abs(a.astype(np.float32) - b.astype(np.float32))))
        for a, b in zip(frames, frames[1:])
    ]
    out = {
        "flicker_mean": round(float(np.mean(diffs)), 4),
        "flicker_max": round(float(np.max(diffs)), 4),
    }
    if ref_frames is not None:
        ups = [np.repeat(np.repeat(f, scale, 0), scale, 1)
               for f in ref_frames]
        ref_diffs = [
            float(np.mean(np.abs(a.astype(np.float32) -
                                 b.astype(np.float32))))
            for a, b in zip(ups, ups[1:])
        ]
        ref_mean = float(np.mean(ref_diffs))
        out["input_flicker_mean"] = round(ref_mean, 4)
        out["flicker_ratio"] = round(
            out["flicker_mean"] / ref_mean, 4) if ref_mean > 1e-9 else None
    return out
