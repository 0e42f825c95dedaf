"""reve_tpu_torch — the PyTorch/CUDA port of reve_tpu for NVIDIA Hopper.

The same segmented, resumable video upscaler as `reve_tpu`, with the
inference engine on an H100: plain tensor code is PyTorch, and the fused
conv ops of the SRVGG main path are CUDA kernels written for sm_90a
(`reve_tpu_torch.kernels`).  Module names and layout follow `reve_tpu`
so each file's counterpart is easy to find.

Layer map:

    CLI / library API                 reve_tpu_torch.cli / reve_tpu_torch.api
      └─ pipeline scheduler           reve_tpu_torch.pipeline.scheduler
           ├─ planner + resume        reve_tpu_torch.pipeline.{planner,state}
           ├─ io backends             reve_tpu_torch.io.{probe,reader,writer,concat}
           └─ CUDA inference engine   reve_tpu_torch.pipeline.engine
                ├─ models             reve_tpu_torch.models.srvgg
                ├─ ops                reve_tpu_torch.ops.{tiling,pixel_shuffle}
                ├─ kernels            reve_tpu_torch.kernels.{conv3x3,conv3x3_s8,head,tta}
                └─ device/dtype       reve_tpu_torch.device

Entry points run on `cuda:0` unless the caller passes a device; with no
CUDA device and none requested they raise instead of drifting onto the
CPU.
"""

from reve_tpu_torch.version import __version__

__all__ = ["__version__", "UpscaleEngine", "upscale_video"]


def __getattr__(name):
    # lazy: keep `import reve_tpu_torch` free of torch/cv2 imports
    if name == "UpscaleEngine":
        from reve_tpu_torch.pipeline.engine import UpscaleEngine

        return UpscaleEngine
    if name == "upscale_video":
        from reve_tpu_torch import api

        return api.upscale_video
    raise AttributeError(name)
