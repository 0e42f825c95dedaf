"""Training data: LR/HR patch pairs sampled from video files.

Counterpart of reve_tpu/train/data.py, its numpy copied so that the same
frames and seed give the same batches, array for array.  HR patches are
random crops of decoded frames; their LR counterparts come from the
'light' degradation: area downscale, optional gaussian noise, optional
8-bit quantization.  The 'realesrgan' second-order pipeline
(reve_tpu/train/degradation.py, which needs cv2) is not ported.

Host numpy; batches feed reve_tpu_torch.train.trainer.Trainer.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

from reve_tpu_torch.io import reader as reader_mod

#: the ROADMAP.md item that the 'realesrgan' degradation waits on
GAN_ITEM = "GAN fine-tune"


@dataclasses.dataclass
class DataConfig:
    scale: int = 2
    patch: int = 64            # HR patch side (must be divisible by scale)
    batch: int = 8
    noise_std: float = 0.0     # gaussian noise on LR, in [0,1] units
    quantize: bool = True      # round LR to 8-bit (matches decode reality)
    seed: int = 0
    #: 'light' = area downscale + noise + quantize; 'realesrgan' (the
    #: second-order synthetic pipeline) is refused
    pipeline: str = "light"


def _area_downscale(img: np.ndarray, scale: int) -> np.ndarray:
    """(H, W, C) float -> (H/s, W/s, C) by box averaging (cv2 INTER_AREA
    equivalent for integer factors)."""
    h, w, c = img.shape
    return img.reshape(h // scale, scale, w // scale, scale, c).mean((1, 3))


def degrade(hr: np.ndarray, cfg: DataConfig,
            rng: np.random.RandomState) -> np.ndarray:
    """HR float [0,1] patch -> LR float [0,1] patch."""
    if cfg.pipeline != "light":
        raise NotImplementedError(
            f"degradation pipeline {cfg.pipeline!r} is not ported: "
            f"reve_tpu_torch runs 'light' only (ROADMAP.md queue 1, "
            f"'{GAN_ITEM}')")
    lr = _area_downscale(hr, cfg.scale)
    if cfg.noise_std > 0:
        lr = lr + rng.normal(0.0, cfg.noise_std, lr.shape)
    if cfg.quantize:
        lr = np.round(np.clip(lr, 0.0, 1.0) * 255.0) / 255.0
    return np.clip(lr, 0.0, 1.0).astype(np.float32)


def patch_pairs_from_frames(
    frames: Iterator[np.ndarray],
    cfg: DataConfig,
    patches_per_frame: int = 4,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (lr, hr) float32 patch pairs from uint8 RGB frames."""
    rng = np.random.RandomState(cfg.seed)
    p = cfg.patch
    if p % cfg.scale:
        raise ValueError(f"patch {p} must be divisible by scale {cfg.scale}")
    for frame in frames:
        h, w = frame.shape[:2]
        if h < p or w < p:
            continue
        img = frame.astype(np.float32) / 255.0
        for _ in range(patches_per_frame):
            y = rng.randint(0, h - p + 1)
            x = rng.randint(0, w - p + 1)
            hr = img[y:y + p, x:x + p]
            yield degrade(hr, cfg, rng), hr


def batches_from_video(
    path: str,
    cfg: DataConfig,
    max_frames: Optional[int] = None,
    frame_stride: int = 10,
    io_backend: Optional[str] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (lr_batch, hr_batch) float32 arrays from a video file.

    lr: (B, p/s, p/s, 3), hr: (B, p, p, 3).
    """
    def frames():
        with reader_mod.open_reader(path, backend=io_backend) as rd:
            for i, f in enumerate(rd.read_range(0, max_frames or 10 ** 9)):
                if i % frame_stride == 0:
                    yield f

    lr_buf, hr_buf = [], []
    for lr, hr in patch_pairs_from_frames(frames(), cfg):
        lr_buf.append(lr)
        hr_buf.append(hr)
        if len(lr_buf) == cfg.batch:
            yield np.stack(lr_buf), np.stack(hr_buf)
            lr_buf, hr_buf = [], []
