"""Hand-written CUDA kernels of the SRVGG and RRDBNet main paths
(sm_90a), each with its plain PyTorch version and a launch counter.

    K1  conv3x3.conv3x3_bias_prelu            hidden conv F->F + PReLU (F
                                              the SRVGG's 32, 64, 96 or
                                              128 features)
                                              (RRDB: the up and hr convs +
                                              leaky ReLU, alpha 0.2)
        conv3x3.conv3x3_bias_prelu_planes     float32 K1 at 32, 96, 128 on
                                              split planes, writing its
                                              output's (counted apart)
        conv3x3.split_bf16x3                  float32 K1's, K2's and K7's
                                              split pass
    K3  conv3x3.conv3x3_u8_bias_prelu         u8 input + first conv + PReLU
                                              (RRDB: conv_first, alpha 1)
        conv3x3.conv3x3_u8x2_bias             K3 at Cin 12: RRDB x2's
                                              conv_first over the 2x2-
                                              unshuffled u8 frame, read in
                                              place
    K2  head.head_conv_residual_u8_shuffle    head conv + residual + u8 +
                                              pixel shuffle (float32 given
                                              the split planes of its
                                              input: counted apart, as
                                              head_conv_residual_u8_
                                              shuffle_planes)
        head.conv_last_u8                     RRDB's conv_last: 64->3 conv +
                                              u8, no residual (bf16: K2's
                                              conv_last mode; float32: its
                                              own kernel of float32 FMAs)
    K7  rrdb.dense_conv                       RRDB dense-block conv over
                                              a channel slice + leaky ReLU
                                              or the block residuals
    K7q rrdb.dense_conv_s8                    K7's s8 form (RRDB int8
                                              trunk): s8 conv + dequant +
                                              quantize or float residuals
    K4  conv3x3_s8.conv3x3_s8_dq_prelu_q8     int8 hidden conv + dequant +
                                              PReLU + requant
    K4a conv3x3.conv3x3_u8_bias_prelu_q8      K3 with an s8 quantize epilogue
    K4h head.head_conv_s8_residual_u8_shuffle int8 head conv + K2's epilogue
    K6  tta.tta_accumulate                    TTA inverse-dihedral
                                              accumulate (u8 term -> int16
                                              sum; the last form writes
                                              the u8 mean)
    K9  color.rgb_to_yuv420_u8                the engine's u8 RGB output ->
                                              YUV 4:2:0 codes for the
                                              writers (8 or 10 bits,
                                              BT.601/709, limited/full)
    P1  dot_probe.dot_loop                    s8/bf16 dot-rate probe on
                                              wgmma (not on a model path)
    T1  train.conv3x3_fwd_train               training: conv3x3 + PReLU
                                              forward, z kept
    T2  train.conv3x3_dgrad                   training: the input gradient
                                              + PReLU' and d(alpha)
    T3  train.conv3x3_wgrad                   training: the weight and
                                              bias gradients

K1, K2 (both dtypes), K7, K4 and K4h run on the tensor cores as
implicit-GEMM `wgmma` kernels with TMA halo loads: bfloat16 K1 and K2 in
csrc/conv3x3_tc.cu, float32 K1 and K2 in csrc/conv3x3_f32_tc.cu (their
operands split into three bf16 parts, six products summed: float32
accuracy, never TF32, to match the reference's Precision.HIGHEST), at
32, 96 and 128 features both as csrc/conv3x3_wide.cuh's template
(halo and weights streamed in units of 32 input channels), K4 and
K4h on s8 wgmma in csrc/conv3x3_s8.cu (64 features only, as K4a), K7
in both dtypes in csrc/rrdb.cu (Cin in chunks of 16 channels through a four-stage TMA
ring; float32 as six bf16 products on split planes), K7q on s8 wgmma in csrc/rrdb_s8.cu
(Cin in chunks of 64 through a TMA ring, the weights resident, two
consumer teams taking tiles in turn, residuals and outputs moved through
shared memory by TMA).  K3 and K4a run on bf16 wgmma
with A from registers and TMA stores (csrc/conv3x3.cu), and P1 on s8 and
bf16 wgmma with A from registers (csrc/dot_probe.cu); K3 at Cin 12 is
K3's template with its halo read from the x2 frame as the unshuffle
lays it out.  K6 moves bytes
only: it stages tiles of the transformed output through shared memory
(csrc/tta.cu).  float32 conv_last (N = 3, where wgmma's operand reads,
not its math, would set the pace) sums float32 FMAs on the CUDA cores
over its input read once by TMA, with no split pass
(csrc/conv_last_f32.cu).  T1, T2 and T3, the training path's forward,
input-gradient and weight-gradient convs, run on bf16 wgmma as six
products of their float32 operands split in three by the threads that
stage them (csrc/conv3x3_train_tc.cu; T2 over dz's halo at the mirrored
taps, T3's operands MN-major, through wgmma's transpose flags).  K9 moves
bytes: a thread converts 16 pixels of a row pair with 16-B loads and
stores, each float op one IEEE op rounded to nearest (csrc/color.cu).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — there is no fallback.  `LAUNCHES` counts
kernel launches only (plain-version calls are not counted), so a run can
show that the main path went through the kernels.
"""

from __future__ import annotations

#: kernel name -> launches since the last reset_launches()
LAUNCHES = {
    "conv3x3_bias_prelu": 0,
    "conv3x3_bias_prelu_planes": 0,
    "split_bf16x3": 0,
    "conv3x3_u8_bias_prelu": 0,
    "conv3x3_u8x2_bias": 0,
    "head_conv_residual_u8_shuffle": 0,
    "head_conv_residual_u8_shuffle_planes": 0,
    "conv_last_u8": 0,
    "dense_conv": 0,
    "dense_conv_s8": 0,
    "conv3x3_s8_dq_prelu_q8": 0,
    "conv3x3_u8_bias_prelu_q8": 0,
    "head_conv_s8_residual_u8_shuffle": 0,
    "tta_accumulate": 0,
    "rgb_to_yuv420_u8": 0,
    "dot_loop": 0,
    "conv3x3_fwd_train": 0,
    "conv3x3_dgrad": 0,
    "conv3x3_wgrad": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
