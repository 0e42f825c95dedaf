"""Fine-tuning and distillation of SRVGG upscalers on one CUDA device
(counterpart of reve_tpu/train without the mesh, the GAN and the
realesrgan degradation).  The convolutions, forward and backward, run on
the training kernels T1-T3 (reve_tpu_torch/kernels/train.py)."""
