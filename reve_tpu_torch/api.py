"""One-call Python API of the PyTorch/CUDA port.

Counterpart of reve_tpu/api.py: a thin, blocking convenience over the
same pipeline the CLI drives.

    import reve_tpu_torch
    reve_tpu_torch.upscale_video("in.y4m", "out.y4m", scale=4, tta=True)

It keeps the CLI's workspace and segment checkpoints: calling it again
after a crash continues where the job stopped, with the settings the job
was started with.  It runs on cuda:0 unless `device` names another CUDA
device or "cpu".  What the port's CLI refuses with exit 2, this raises:
NotImplementedError naming the ROADMAP.md port-queue item (`mesh`,
`scene_align`, a non-SRVGG model, ncnn weights), or ValueError
(`compile_attempts`, which has no counterpart).  `upscale_image` waits
for image mode (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported in reve_tpu_torch (ROADMAP.md port "
        f"queue: {item})")


def _resolve_device(device):
    """None -> cuda:0 (raises without CUDA), an int N -> cuda:N (checked
    against this host's devices), "cpu" or a CUDA device name as given."""
    from reve_tpu_torch import device as device_mod

    if isinstance(device, int) and not isinstance(device, bool):
        import torch

        n = torch.cuda.device_count()
        if not 0 <= device < n:
            raise ValueError(f"device index {device} out of range: this "
                             f"host has {n} CUDA device(s)")
    return device_mod.resolve_device(device)


def upscale_video(
    input_path: str,
    output_path: str,
    scale: int = 2,
    *,
    model: str = "realesr-animevideov3",
    weights: Optional[str] = None,
    segment_size: int = 1000,
    batch: int = 4,
    tile: int = 0,
    dtype: str = "auto",
    int8_calib: str = "p99.9",
    tta: bool = False,
    io_backend: Optional[str] = None,
    crf: int = 15,
    preset: str = "slow",
    x265_params: str = "psy-rd=2:aq-strength=1:deblock=0,0:bframes=8",
    workspace: Optional[str] = None,
    keep_workspace: bool = False,
    resume: bool = True,
    on_progress=None,
    scene_align: bool = False,
    device=None,
    mesh=None,
    compile_attempts: Optional[int] = None,
    allow_random_init: bool = False,
) -> dict:
    """Upscale a video through the full segmented, resumable pipeline.

    Returns the finalize report: {"backend": ..., "audio_copied": bool,
    "dtype": resolved compute path}.  When `resume` and a prior
    interrupted workspace of this package exists, continues it with its
    saved weights, dtype, int8 calibration statistic, `tta` and io
    backend; otherwise starts fresh.  Raises on invalid inputs (same rules
    as the CLI: output must not exist, mkv input requires mkv output).

    `tile`: 0 (default) tiles only frames past the device memory plan, N
    > 0 always runs N x N halo tiles, -1 never tiles; tiles are
    byte-identical to whole frames.  `tta`: the 8-transform self-ensemble
    (8x the model work).  `dtype="auto"`: the CLI's --dtype auto policy
    (bfloat16 on CUDA).  `on_progress`: optional callable receiving a
    snapshot dict after every counter update, from pipeline worker
    threads.  `device`: None (cuda:0), a CUDA device index, or "cpu" (the
    kernels' plain versions).  `allow_random_init`: run with
    deterministic random weights when no trained weights resolve
    (tests/benchmarks only); without it (or REVE_TPU_ALLOW_RANDOM_INIT=1)
    missing weights raise registry.MissingWeightsError before any
    workspace or decode."""
    from reve_tpu_torch.models import registry
    from reve_tpu_torch.pipeline import job as job_mod
    from reve_tpu_torch.pipeline.state import Workspace

    if scale not in (2, 3, 4):
        raise ValueError("scale must be 2, 3 or 4")
    if mesh is not None:
        raise _not_ported("a multi-device mesh", "multi-GPU")
    if scene_align:
        raise _not_ported("scene_align", "scene-aligned segments")
    spec, _ = registry.parse_model_name(model)
    if spec.arch != "srvgg":
        raise _not_ported(f"model {model} ({spec.arch})", "RRDB, K7")
    if weights and weights.endswith((".param", ".bin")):
        raise _not_ported(f"ncnn weights {weights!r}", "ncnn/dni weights")
    if compile_attempts is not None:
        raise ValueError("compile_attempts has no counterpart in "
                         "reve_tpu_torch (the JAX package's XLA "
                         "compile-lottery guard)")
    device = _resolve_device(device)
    if os.path.exists(output_path):
        raise FileExistsError(f"output path already exists: {output_path}")
    if input_path.lower().endswith(".mkv") and \
            not output_path.lower().endswith(".mkv"):
        raise ValueError("mkv input requires mkv output")
    ws = Workspace(workspace or output_path + ".revework")
    resuming = resume and ws.has_state()
    if not resuming:
        # an interrupted workspace defers to the resume path, whose saved
        # opts restore the original weights / random-init opt-in
        msg = job_mod.missing_weights(model, scale, weights,
                                      allow_random_init)
        if msg is not None:
            raise registry.MissingWeightsError(msg)
    if not ws.acquire_owner():
        raise RuntimeError(
            f"another live process is already working on this "
            f"workspace ({ws.owner_path}); wait for it to finish")
    settings = argparse.Namespace(
        weights=weights, dtype=dtype, int8_calib=int8_calib, tta=tta,
        io_backend=io_backend, allow_random_init=allow_random_init)
    try:
        if resuming:
            state = ws.load()
            if state.scale != scale:
                raise ValueError(
                    f"workspace {ws.root!r} holds progress for x"
                    f"{state.scale}; resume with the same scale or remove "
                    f"the workspace to start fresh")
            # resumed segments go through the same weights, dtype,
            # ensemble and container as the committed ones
            state = job_mod.restore(ws, state, settings, model)
        else:
            state = job_mod.fresh(
                ws, settings, input_path=input_path,
                output_path=output_path, scale=scale,
                segment_size=segment_size, model=model,
                encode={"crf": crf, "preset": preset,
                        "x265_params": x265_params})
        ws.save(state)
        engine, _ = job_mod.open_engine(ws, state, settings, device,
                                        batch=batch, tile=tile)
        progress = None
        if on_progress is not None:
            from reve_tpu_torch.pipeline.progress import ProgressTracker

            progress = ProgressTracker(
                total_frames=sum(s.size for s in state.pending),
                total_segments=len(state.pending),
                on_update=lambda t: on_progress(t.snapshot()),
                source_fps=state.fps_num / max(state.fps_den, 1),
            )
        _, report = job_mod.run(ws, state, engine, settings,
                                progress=progress,
                                keep_workspace=keep_workspace)
        return report
    finally:
        ws.release_owner()
