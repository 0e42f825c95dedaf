"""Quickest proof that the PyTorch/CUDA port runs on a GPU.

    python3 chip_smoke.py

Drives reve_tpu_torch on one CUDA device, in phases that each print one
JSON line; any failure exits non-zero (no phase catches and continues):

  1. device   the card's name, and its name and power limit as nvidia-smi
              reports them;
  2. build    nvcc builds every kernel of the main path from the sources
              in this checkout (sm_90a), all at once, and prints each
              library's registers, spills and count of wgmma instructions
              in its SASS (cuobjdump: HGMMA for bf16, IGMMA for s8): the
              libraries of K3/K4a (and K3 at Cin 12), bfloat16 K1/K2,
              float32 K1/K2, K4/K4h, K7, K7q and P1 must have at least the
              count of all their kernels (the heads at r = 2, 3, 4
              included; P1 at every K), every kernel of conv3x3.cu (K3,
              K4a and K3 at Cin 12 in both compute dtypes), rrdb.cu,
              rrdb_s8.cu, conv3x3_s8.cu (K4 and K4h, their forms at 32,
              96 and 128 features in conv3x3_s8_wide.cuh among them) and
              dot_probe.cu must hold wgmma, P1's library
              both IGMMA and HGMMA, and no library any __dp4a (IDP.4A) or
              mma.sync (HMMA, IMMA); float32 conv_last's library
              (conv_last_f32.cu, float32 FMAs) must hold FFMA and spill
              nothing; the training library of T1, T2 and T3
              (conv3x3_train_tc.cu) must hold wgmma (HGMMA) in each of
              its 69 kernels (23 channel pairs), no TF32 product and no
              float atomic (RED or ATOM on F32) (kernels.train.sass_faults,
              which the card test runs too), and its HGMMA count and
              spill bytes are reported kernel by kernel, as are the spill
              bytes of K3's, K1's and K2's libraries (their forms at 32,
              96 and 128 features among them);
  3. kernels  K3, K1 and K2 at the main path's shapes (1080p frames, a
              batch of 4, x4), all on the tensor cores, in bfloat16
              (conv3x3.cu, conv3x3_tc.cu) and float32 (as six bf16
              products: K3 in conv3x3.cu, K1 and K2 each after its split
              pass in conv3x3_f32_tc.cu): each kernel against
              its plain PyTorch version on the same inputs (float32: max
              |d| <= 1e-4, float32 accumulation order; bfloat16: <= 2 bf16
              ulp relative, the ulp taken at 2^-10 or more; uint8: |d| <=
              1; the split pass exact), then timed beside the plain
              version, one cuDNN F.conv2d of the same conv (library_ms;
              the port never calls it) and the card's bound (float32 K1,
              K2 and K3: their six bf16 passes at the bf16 rate; K3 is
              bound by its bytes in both dtypes);
              The int8 kernels K4a (K3's kernel with an s8 output, its
              conv in bf16), K4 and K4h (both on s8 wgmma) at the
              same shapes, with a QuantizedBody the port's int8 engine
              calibrates on the smoke's frames, each against its plain
              version (K4 and K4h exact; K4a: |d| <= 1 s8 code, its bf16
              conv summed in another order than cuDNN's), timed the
              same way (library_ms: torch._int_mm of the im2col'd
              product of one frame, x4 frames, the im2col not counted;
              cuDNN bf16 F.conv2d for K4a);
              every kernel above once more on the transposed batch (4
              frames of 1080 x 1920, the shape the TTA path's odd
              quarter-turns give it: 1080 columns, ragged against the
              64-pixel tiles), against its plain version at the same
              tolerance, untimed;
              K6 at the TTA path's shape (4 frames of 1080p x4: u8 model
              outputs, the int16 accumulator), each of its three forms
              (FIRST writes acc, MIDDLE adds, LAST writes the u8 mean)
              for each of the 8 transforms exact against its plain
              version, timed beside it, beside the same function as
              in-place torch ops (library_ms: rot90/flip, then add_) and
              its byte bound;
  3b. color  K9 (color.cu: the engine's u8 output -> the writers' YUV
              4:2:0 codes) on the main job's model output (4 frames of
              7680 x 4320, bf16) in all 8 forms (BT.601/709, limited/full,
              8/10 bits): n_diff 0 against its plain version, timed beside
              it and its byte bound (no single torch call computes it:
              library_ms null).  The build phase also builds the native
              container core (native.py, g++) beside nvcc and fails if it
              does not build, and fails if K9's PTX holds an fma or a
              float op without a rounding mode, or its SASS more FFMA than
              a -fmad=false build (color.contraction_faults).  Every job
              below that writes y4m runs K9: its launches must equal the
              job's pieces (whole-frame model calls, or one a batch for
              tiles and TTA), so the encode thread only writes planes;
  4. main     the product job through the port's CLI: 8 frames of
              1920x1080 -> 7680x4320 (x4, realesr-animevideov3 at its full
              64-feature, 16-conv width, the shipped weights), default
              --dtype auto (= bfloat16).  Launch counters are zeroed just
              before and read just after; each kernel must have run.
              Output frame 0 is held against the port's plain float32 path
              on the card (PSNR >= srvgg.BF16_PSNR_FLOOR_DB).  The job
              runs with --trace: the phase reports seconds per scheduler
              span, encode_batch's share of the wall, and the model's
              device time as a share of the wall;
  4b. native  the native core's exact y4m probe (FRAME markers walked) on
              the main job's output and on a file whose markers carry
              parameters, and the main job's concat through the core
              (backend "native");
  5. int8     the same job with --dtype int8: launch counts must show K4a,
              K4 (16 per model call) and K4h, and float32 K1 and K2, each
              launch with its split pass (calibration, certification);
              output frame 0 is held against the port's plain int8 path
              on the card, with the calibration the workspace persisted,
              at >= 60 dB.  It reports the certified int8-vs-f32 dB
              (reported, not gated: the frames are synthetic and the
              weights self-SR proxies), the job's fps and the calibration
              and certification seconds;
  6. tile     the main job on its first 4 frames (one batch) with --tile
              512 (bfloat16): windows of 548 x 548, their model calls
              through K3, 16 x K1 and K2 (the counts checked per window
              chunk), and an output file byte-identical (n_diff = 0) to
              the main job's first 4 frames; then, on the engine, int8
              (with the scales the whole-frame engine calibrated) and
              float32 tiled batches byte-identical to whole-frame ones,
              and the model's ms per batch tiled against whole frames in
              the three dtypes;
  7. tta      the same 4 frames with --tta (bfloat16): 8 model calls per
              batch, each followed by K6 (the inverse-dihedral accumulate,
              csrc/tta.cu), checked by the launch counts; the engine's
              ensemble byte-identical to the manual one (the whole-frame
              engine on the 8 forward-transformed batches, inverse
              transformed and averaged by K6's plain version) and to the
              job's output frame 0, and tta(rot90(x)) == rot90(tta(x));
              the model output of the first quarter-turn (1080 x 1920)
              against the plain float32 path on the same input at the
              main phase's PSNR gate; the job's seconds by span;
  8. rrdb     RRDBNet (realesrgan-x4plus at its full width and depth: 64
              features, 32 growth channels, 23 blocks; random weights
              from seed 0, reve_tpu's init scales) on the same 4 frames:
              K7's seven forms on the path (Cin 64/96/128/160 -> 32 with
              the leaky ReLU, 192 -> 64 with the dense block's and the
              RRDB's residual, conv_body's 64 -> 64 + feat) in both
              dtypes at a batch of 4 1080p frames on the model's own
              activations, each against its plain version (bfloat16 <=
              2 ulp of the largest operand of its epilogue; float32 max
              |d| <= 2e-6; float32 on the planes of its input, and the
              planes it writes equal to the split pass's of its output),
              timed beside the plain version, cuDNN's F.conv2d and its
              bound; K7's part times (perf_conv_tc_parts on rrdb.cu:
              its loads, weight copies, wgmmas or epilogue taken out,
              the epilogue alone); the CLI job (-s 4 --model
              realesrgan-x4plus --allow-random-init --dtype auto =
              bfloat16) with the counters zeroed around it: per model
              call K3 1, K7 346, K1 3 and K2's conv_last mode 1; each
              of its 4 frames against the plain float32 path, at most 1
              dB further from it than the plain bfloat16 path (bf16
              through 23 random-weight blocks is itself below the 50-dB
              gate), and at 50 dB or more against the plain bfloat16
              path, with the share of bytes clipped to 0 or 255 printed;
              a float32 engine batch through the plan's chunks, twice,
              with PyTorch's default allocator (the second batch
              byte-identical to the first), every frame at u8 |d| <= 1
              against the plain float32 path, with 4 split passes a
              call (feat's, the head's three K1) and none in the trunk
              or conv_last; the model's ms per batch,
              the plan and one call's peak device memory, at most what
              the plan bills, in both dtypes; conv_last at its shapes
              (4 frames of 7680 x 4320 in bfloat16, K2's conv_last
              mode; the float32 plan's chunk in float32, its own kernel
              of float32 FMAs, conv_last_f32.cu) against its plain
              version frame by frame (u8 |d| <= 1, n_diff), timed
              beside cuDNN and its bound; K1 at the up convs' shapes (alpha
              0.2; 4 frames at 2x and at 4x, 8.5e9 values, in bfloat16;
              the float32 plan's chunk in float32) against its plain
              version on every frame, in strips of rows (<= 2 ulp;
              float32 <= 2e-6), timed beside it, cuDNN and its bound;
              the nearest x2's time;
  9. rrdb_int8  the same model and frames with --dtype int8 (the CLI
              job, counters zeroed around it): the launch counts split
              into the job's int8 calls (each K3 1, K7q 346, K1 3, the
              conv_last mode 1), the calibration's float32 forwards (K3,
              345 x K7, one split pass) and the certification's float32
              calls (4 split passes each); each
              frame against the port's plain int8 path on the card with
              the calibration the workspace persisted, >= 60 dB, with
              n_diff; the certificate (dB vs float32), calibrate_s and
              certify_s; K7q's seven forms at a batch of 4 1080p frames
              on the int8 model's own activations, each exact against
              its plain version (s8 n_diff 0, float outputs
              bit-identical), timed beside the plain version,
              torch._int_mm of one frame's im2col'd product x4 and its
              bound (bytes); K7q's part times (perf_conv_tc_parts on
              rrdb_s8.cu: its loads, wgmmas or epilogue taken out, the
              epilogue alone); an int8 engine's plan, one call's peak
              device memory against the plan's bill and the model's ms
              per batch beside bfloat16's;
 10. rrdb_x2  realesrgan-x2plus (RRDBNet x2 at full width and depth, random
              weights from seed 0) on the same 4 frames, 1080p -> 2160p:
              K3 at Cin 12 (conv_first over the 2x2-unshuffled frames,
              read in place; conv3x3.cu at R = 2) in both dtypes at the
              batch's shape against its plain version (bfloat16 <= 2 ulp,
              float32 max |d| <= 1e-4, as K3), timed beside it, cuDNN's
              F.conv2d on the unshuffled input and its bound, with its two
              kernels' wgmma counts; the CLI bf16 job (counters zeroed
              around it: per call K3 at Cin 12 1, K7 346, K1 3, conv_last
              1, K3 0), each frame held as the rrdb phase holds x4's; the
              float32 engine batch (|d| <= 1 against the plain float32
              path, peak memory within the plan's bill) and the model's ms
              a batch in both dtypes; the --dtype int8 job (its launches
              split into int8, calibration and certification calls; each
              frame >= 60 dB against the plain int8 path with the
              persisted calibration; calibrate_s, certify_s; the int8
              engine's plan, peak and ms a batch); a --tile 512 job whose
              file equals each 560 x 560 window run alone as a whole frame
              on a whole-frame engine (n_diff 0);
 11. weights  the shipped x4 .pth written as an ncnn .param/.bin pair with
              fp32 and with fp16 tags: the port's parser gives its params
              (fp16: rounded through np.float16), and a job with
              --weights x.param on 2 of the frames writes the bytes of the
              .pth job (fp32) or of the engine on the fp16-rounded params
              (fp16); a --denoise 0.5 job with a seeded perturbed twin as
              --weights-wdn writes the bytes of the engine on
              interpolate(twin, plain, 0.5), and not the plain job's;
 12. scenes   a 24-frame 270 x 480 clip of two seeded scenes (a cut at
              frame 10), -S 8: with --scene-align the plan saved in
              state.json is plan_segments_aligned over detect_cuts' cuts
              ([10]), unlike the fixed plan, and the output file equals
              the unaligned job's byte for byte;
 13. train    training on the card, at realesr-animevideov3 x4's full
              width (64 features, 16 convs), LR patches of 64 x 64 in
              batches of 8: T1, T2 and T3 (on bf16 wgmma as six products
              of their split float32 operands, csrc/conv3x3_train_tc.cu)
              at every channel pair they take (kernels.train.PAIRS: Cin
              3, 64, 128 x Cout 48, 64, 128, and every SRVGG conv at 32,
              64, 96 and 128 features and x2, x3, x4, heads of Cout 12,
              27 and 48) on seeded inputs, each
              against its plain version (max |d| <= 1e-5 x max |ref|, T3
              5e-5: its sums run over the step's 32,768 pixels), timed
              beside it (the calls queued behind a sleep kernel, free of
              the host's launch cost), cuDNN's call of the same function
              (library_ms: F.conv2d, aten.convolution_backward; TF32 off)
              and its bound on its own route (bound_ms: six bf16
              products on the tensor cores; beside it both that and
              float32 FMAs on the CUDA cores, as bound_ms_bf16x6 and
              bound_ms_fma_f32), with a step's sums of each;
              a fine-tune of the
              shipped x4 model through train.Trainer, 20 steps of
              train.data.batches_from_video over the main job's y4m (HR
              patches of 256), the counters zeroed around it (per step
              T1 18, T2 17, T3 18), each step's loss within 1e-4
              relative of the same 20 steps on the plain versions on the
              card and the final params within 1e-6 of theirs, element
              by element and in relative l2 (at most 16 elements whose
              plain-path gradient sits at float32's noise level within 2
              lr a step instead);
              the first 5 steps twice on the kernels, bit for bit; the
              median step's ms and LR patches a second; the same checks
              on a 5-step fine-tune of a seeded 64 x 16 model at x3 (HR
              patches of 192; the head's 27 outputs); a distillation
              of x4 into realesr-animevideov3-fast's shape (64
              features, 8 convs)
              from its shipped weights, 20 steps (per step T1 18 + 10,
              T2 9, T3 10), agreement_psnr before and after, the
              student saved with save_srvgg_pth, loaded back through
              registry.load_model, and one engine batch of the frames on
              it byte-identical to the engine on the in-memory params;
              reve_tpu's
              distillation defaults end to end through
              scripts.distill.main, given a seeded 64 x 16 x2 teacher
              .pth (no x2 weights ship), --data the main job's y4m and 5
              steps: the x2 teacher, a 128-feature 16-conv student,
              batch 8, patch 64, on T1-T3 with the launches predicted
              (per step T1 18 + 18, T2 17, T3 18, and 36 T1 for the
              closing agreement), the .pth loaded back through the
              registry equal to the exported params, each loss within
              1e-4 relative of the same steps through Distiller on the
              plain versions; distillations of x4 into random-init
              students of 32, 96 and 128 features and 16 convs, 5 steps
              each on the kernels and the same 5 on the plain versions
              (which launch none of T1-T3), each loss within 1e-4
              relative, and their ms a step;
 13b. widths  serving an SRVGG of 32, 96 and 128 features: K3, K1 and K2
              at those widths (K1 and K2 in conv3x3_wide.cuh, K3 its
              template at Cout F), in both dtypes and K2 at x2, x3, x4,
              on seeded 1-conv models at the main path's batch, held
              and timed as the kernels phase holds the 64-feature forms
              (their own plain version, cuDNN, the bound), and float32
              K1 as the model calls it there, on the split planes of its
              input writing those of its output ("float32_planes"; held
              with its float32 value written beside: the value bit for
              bit the float32-out K1's and within 1e-4 of the plain
              version's, the planes bit for bit its split), and float32
              K2 so, on the split planes of its input ("float32_planes";
              u8 |d| <= 1 against its plain version, n_diff reported;
              its launches those of head_conv_residual_u8_shuffle_planes
              in the engine batches below); K4a, K4 and
              K4h at those widths (K4h at x2, x3, x4; K4 and K4h in
              conv3x3_s8_wide.cuh, K4a K3's template with the s8
              epilogue) on the same models quantized by an int8 engine's
              calibration on the batch, held and timed as the kernels
              phase holds the 64-feature forms (K4 and K4h exact, K4a
              within 1 s8 code; their plain version, torch._int_mm x4 or
              cuDNN, the bound); then one
              engine batch of the main job's first 4 frames through
              UpscaleEngine in bfloat16, float32 and int8 for each of the train
              phase's x4 students (32, 96, 128 features, 16 convs), the
              default distillation's x2 128-feature student loaded
              through the registry from its .pth, and a seeded x3 model
              of 96 features and 16 convs: launches 1 K3, num_conv K1
              and 1 K2 a model call (float32: one split pass, after K3;
              K1 reads and writes the split planes, counted as
              conv3x3_bias_prelu_planes with no float32-out K1, K2 reads
              them, counted as head_conv_residual_u8_shuffle_planes with
              no float32-input K2; its `split_passes_per_call` reported),
              float32 u8
              |d| <= 1 on every frame against the plain float32 path,
              bfloat16 each frame >= 50 dB against the plain bf16 path
              and within 1 dB of the plain bf16 path's own PSNR against
              plain float32, the model's ms a batch; int8 calibrated on
              the batch, launches 1 K4a, num_conv K4 and 1 K4h a model
              call, frame 0 >= 60 dB
              against the plain int8 path on the same calibration, the
              certificate's PSNR (reported, not gated) and the int8
              model's ms a batch; a --tile 512 bfloat16 and int8 batch
              of the 128-feature student byte-identical to its whole
              frames; 2-frame `--dtype int8` and `--dtype auto`
              (REVE_TPU_AUTO_INT8=1: int8 at >= 50 dB certified, else
              bf16) CLI jobs of the default student's .pth; int8 and
              bfloat16 at 48 features refused
              before any batch, naming "Serving at other widths", with
              nothing launched;
 14. probe    P1, the tensor-core dot-rate probe (wgmma), through
              `python -m reve_tpu_torch.scripts.perf_int8_dot`'s main at
              its shapes: per call at 64 loops timed free of the host's
              launch cost (the calls queued behind a sleep kernel, so that
              the card runs them back to back), the marginal rate from
              64 to 1024 loops and the check that the time grows
              linearly (fails otherwise: a dot was hoisted), and the
              time of back-to-back calls from the host; then against
              its plain version (s8 exact; bf16 max |d| <= 1e-4 max
              |ref|), beside one library call of the same multiply-adds
              (library_ms: torch._int_mm, or a bf16 torch.mm to float32,
              of x tiled 64 times along K by the halves stacked in loop
              order) and 64 library calls (library_loop_ms).

The line before the last is nvidia-smi's name and power limit; before
that, one JSON object {"kernels": [...]} with each kernel's launches on
its path (main, int8, tta, rrdb, rrdb_int8, rrdb_x2, train's fine-tune or
probe), error
(and, for u8 and s8 outputs,
n_diff: the values that differ from the plain version's; the model
kernels' error on the transposed batch under "transposed"), times, bound
and design ("wgmma", "wgmma_bf16x6", "fma_f32", "elementwise" or
"smem_transpose";
K6's numbers per launch averaged over one batch's 8 launches, with each
form's under "forms"; the
float32 forms of K1, K2 and K3 nested under "float32" with their own
source, design and launches on the int8 path, where they run; those of
K7 and conv_last (conv_last_f32.cu, "fma_f32") with their launches in
the rrdb phase's float32 engine batch, and of K3 at Cin 12 with its
launches in the rrdb_x2 phase's; K3's, K1's and K2's forms at 32, 96 and
128 features under "widths", by width and dtype, and K4a's, K4's and
K4h's under "widths" by width ("int8"), with their launches in the
widths phase's engine batch of the x4 student of that width, K2's and
K4h's x2 and x3 nested).  The last
line is {"ok": true, "device": {...}}.

Run from the root of a checkout: alone, or without a CUDA device, it
exits 1 and prints no result.  Any failure, in a phase or before the
first, prints one JSON line {"phase": ..., "ok": false, "error": ...} on
stdout before the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import fractions
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
#: H100 SXM peaks (NVIDIA data sheet): dense bf16 and int8 tensor rates,
#: float32 rate outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12
FRAMES, W, H, SCALE, BATCH = 8, 1920, 1080, 4, 4
#: the tile phase's --tile: windows of 548 x 548 at the model's halo 18
TILE = 512
#: wgmma instructions each tensor-core library must hold at least: every
#: kernel's mainloop unrolled (per 64-pixel row: bf16 36, bf16x6 216, s8
#: 18), the hidden conv, the heads at r = 2, 3, 4 and (bf16 only) K2's
#: conv_last mode (r = 1); K3 and K4a 2 in bfloat16 and 12 in float32 (K = 32: two k16
#: steps, six products each), K3 at Cin 12 7 and 42 (K = 112: seven k16
#: steps); K7 at N = 32 and 64, per 16-channel chunk
#: 18 in bfloat16 (two rows of 9 taps) and 54 in float32 (9 taps, six
#: products each); K7q in its four kernels (N = 32 and 64, each with and
#: without float residuals), per 64-channel chunk 18 (s8) a warpgroup's
#: row, four rows at N = 32 and two at 64; P1 one kernel for each count of
#: 32-B k steps, its dot's wgmmas unrolled: s8 1 + ... + 8 (IGMMA), bf16
#: 1 + ... + 16 (HGMMA); T1 and T2 12 a unit (two k16 steps, six
#: products each; T2 at Cout 12 6, one k16 step) in each of their 23
#: kernels (kernels.train.PAIRS; 4 at Cout 12), T3 48 a tile (eight k16
#: steps) in each of its 23.  The SRVGG widths 32, 96 and 128
#: (conv3x3_wide.cuh, instantiated by conv3x3_tc.cu and conv3x3_f32_tc.cu):
#: K1 and K2 at x2, x3, x4, 12 kernels in each dtype, 18 (bf16) or 108
#: (bf16x6) a unit of 32 input channels (nine taps of two k16 steps; the
#: units looped; the resident K1 forms that many a row of a warpgroup);
#: K3 at Cout 32, 96, 128 in chunks of 64 or 32 output
#: channels (1, 3, 2 chunks): 2 and 12 a chunk, and K4a the same; K4 and
#: K4h in int8 (conv3x3_s8_wide.cuh, instantiated by conv3x3_s8.cu): 12
#: kernels, 9 (s8) a unit of 32 input channels and row of a warpgroup
#: (nine taps of one k32 step; the units looped)
P1_IGMMA, P1_HGMMA = sum(range(1, 9)), sum(range(1, 17))
WIDE_KERNELS = 3 + 3 * 3
MIN_WGMMA = {"conv3x3_tc.cu": 5 * 36 + WIDE_KERNELS * 18,
             "conv3x3_f32_tc.cu": 4 * 216 + WIDE_KERNELS * 108,
             "conv3x3_s8.cu": 4 * 18 + WIDE_KERNELS * 9,
             "conv3x3.cu": 2 * (2 + 12) + 7 + 42
             + 2 * (1 + 3 + 2) * (2 + 12),
             "dot_probe.cu": P1_IGMMA + P1_HGMMA,
             "rrdb.cu": 2 * (18 + 54), "rrdb_s8.cu": 2 * (4 * 18 + 2 * 18),
             "conv3x3_train_tc.cu": 23 * 12 + 19 * 12 + 4 * 6 + 23 * 48}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


#: the phase running now, named by the failure line if one fails
CURRENT = ["setup"]


def fail_line(err: BaseException) -> None:
    """The one JSON line a failure prints on stdout before the script
    exits non-zero: the phase and the error."""
    emit({"phase": CURRENT[0], "ok": False,
          "error": f"{type(err).__name__}: {err}"[:4000]})


@contextlib.contextmanager
def phase(name: str, record: dict):
    CURRENT[0] = name
    t0 = time.perf_counter()
    yield record
    record.update(phase=name, ok=True,
                  seconds=round(time.perf_counter() - t0, 3))
    emit(record)
    CURRENT[0] = f"after {name}"


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


def queued_time_ms(fn, iters: int = 10) -> float:
    """Milliseconds a call on the card, free of the host's launch cost:
    the calls queued behind a sleep kernel and timed by CUDA events
    (perf_int8_dot.queued_ms); for calls shorter on the card than on the
    host."""
    import torch

    from reve_tpu_torch.scripts import perf_int8_dot

    return perf_int8_dot.queued_ms(fn, iters, torch.device("cuda", 0))


def library_time_ms(fn, iters: int = 10, timer=cuda_time_ms):
    """`timer` (cuda_time_ms) of a library call that is only a yardstick:
    None, with the reason printed, where the installed PyTorch refuses the
    call."""
    try:
        return timer(fn, iters)
    except RuntimeError as e:
        print(f"# library call refused: {str(e).splitlines()[0]}",
              flush=True)
        return None


def count_diff(a, b, chunk: int = 1 << 28) -> int:
    """Elements of `a` and `b` (one shape) that differ, counted a chunk at
    a time: a sum over a whole 1080p batch's planes at 128 features would
    widen 3.2 G flags to int64 at once (25 GB)."""
    a, b = a.reshape(-1), b.reshape(-1)
    return sum(int((a[i:i + chunk] != b[i:i + chunk]).sum())
               for i in range(0, a.numel(), chunk))


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


def sass_ops(source: str) -> dict:
    """Counts of the wgmma opcodes (HGMMA, IGMMA, ...), of mma.sync (HMMA,
    IMMA), of float32 FMAs (FFMA) and of __dp4a (SASS IDP.4A, counted as
    "IDP4A") in a built library's SASS (build.sass), in all and by
    kernel: {"all": {op: n}, "by_kernel": {mangled name: {op: n}}}."""
    from reve_tpu_torch.kernels import build

    every, by_kernel = {}, {}
    for name, part in build.sass(source).items():
        ops = by_kernel.setdefault(name, {})
        for m in re.finditer(r"\b([A-Z]GMMA|[HI]MMA|FFMA|IDP\.?4A)\b",
                             part):
            op = m.group(1).replace(".", "")
            ops[op] = ops.get(op, 0) + 1
            every[op] = every.get(op, 0) + 1
    return {"all": every, "by_kernel": by_kernel}


#: template arguments in a mangled kernel name: int values, and the
#: types of conv3x3.cu's kernels (float, bf16, int8_t, the first again)
_MANGLED_ARGS = r"(?:Li\d+E|f|a|13__nv_bfloat16|S\d*_)"
_ARG_NAMES = {"f": "float", "a": "int8", "13__nv_bfloat16": "bf16"}


def kernel_label(mangled: str) -> str:
    """A kernel's readable name from its mangled one: fwd_tc_kernel<128,
    64> for a template of int parameters, conv3x3_u8_tc_kernel<bf16,
    bf16, 1, 96> for one of types and ints.  The name is the shortest
    run ending in `_kernel` that the decimal of its length precedes."""
    end = mangled.find("_kernel")
    if end < 0:
        return mangled
    end += len("_kernel")
    for start in range(end - 1, 0, -1):
        n = str(end - start)
        if (mangled[start].isalpha() or mangled[start] == "_") and \
                mangled[max(start - len(n), 0):start] == n:
            break
    else:
        return mangled
    m = re.match(rf"I({_MANGLED_ARGS}+)E", mangled[end:])
    args = []
    for a in re.findall(_MANGLED_ARGS, m.group(1) if m else ""):
        args.append(args[0] if a[0] == "S" else a[2:-1] if a[0] == "L"
                    else _ARG_NAMES[a])
    return mangled[start:end] + (f"<{', '.join(args)}>" if args else "")


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


#: float ops K9 computes a pixel: luma 3 mul + 2 add, chroma 2 sub + 2
#: div, the Y code mul + add, and a quarter of a quad's two means (3 add
#: + 1 mul each) and two codes
K9_FLOPS_PER_PX = 5 + 4 + 2 + 3
#: the form the smoke's y4m jobs write: BT.601 limited, 10-bit (the
#: default pix_fmt yuv420p10le)
K9_JOB_FORM = ("bt601", False, 10)


def color_phase(params, cfg, frames) -> dict:
    """K9 on the main path's model output in all 8 forms: n_diff against
    its plain version (must be 0), its time beside the plain version's
    and the byte bound; the smoke jobs' form at the top."""
    import torch

    from reve_tpu_torch.kernels import color as color_k
    from reve_tpu_torch.models import srvgg
    from reve_tpu_torch.ops.color_np import YUVFormat

    y = srvgg.apply(params, torch.from_numpy(frames).cuda(), cfg=cfg)
    b, h, w, _ = y.shape
    forms = {}
    for m in ("bt601", "bt709"):
        for full in (False, True):
            for bits in (8, 10):
                fmt = YUVFormat(m, full, bits)
                got = color_k.rgb_to_yuv420_u8(y, fmt)
                want = color_k.rgb_to_yuv420_u8_plain(y, fmt)
                n_diff = sum(int((g != v).sum()) for g, v in zip(got, want))
                err = max(int((g.int() - v.int()).abs().max())
                          for g, v in zip(got, want))
                del got, want
                if n_diff:
                    raise AssertionError(f"K9 {fmt}: n_diff {n_diff} "
                                         f"against its plain version")
                nbytes = b * h * w * 3 + b * color_k.plane_bytes(h, w, bits)
                bms, by = bound_ms(nbytes, b * h * w * K9_FLOPS_PER_PX,
                                   "float32")
                forms[f"{m}_{'full' if full else 'limited'}_{bits}"] = {
                    "n_diff": n_diff, "max_abs_err": err,
                    "ms": cuda_time_ms(
                        lambda: color_k.rgb_to_yuv420_u8(y, fmt), 20),
                    "plain_ms": cuda_time_ms(
                        lambda: color_k.rgb_to_yuv420_u8_plain(y, fmt), 3),
                    "bound_ms": bms, "bound_by": by, "bytes": nbytes}
    del y
    torch.cuda.empty_cache()
    m, full, bits = K9_JOB_FORM
    top = forms[f"{m}_{'full' if full else 'limited'}_{bits}"]
    return dict(top, forms=forms, library_ms=None, shape=[b, h, w, 3],
                format=list(K9_JOB_FORM))


def k9_check(launches: dict, pieces: int, what: str) -> int:
    """A y4m job's K9 launches: one a piece of its batches (whole-frame
    model calls, or one a batch for tiles and TTA), so every frame the
    encode thread wrote was converted on the card."""
    n = launches["rgb_to_yuv420_u8"]
    if n != pieces or n < 1:
        raise AssertionError(f"{what}: K9 launched {n} times, expected one "
                             f"a piece ({pieces}): {launches}")
    return n


def kernel_phase(params, cfg, frames, out: dict, timed: bool = True,
                 only=None) -> dict:
    """Each kernel against its plain version, then (`timed`) timed, in
    both dtypes.  Inputs chain like the model's: K3 on the frames, K1 on
    K3's output, K2 on K1's output, with the model's real weights.
    Untimed, the results hold each kernel's error only.  `only`: the
    names of the kernels to hold (None: all, and the split pass)."""
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
            # float32 K3, K1 and K2 are six bf16 products on the tensor
            # cores (K1's and K2's split pass included in their time):
            # bound at six times the operations at the bf16 rate (K3's
            # bytes bound it in both dtypes)
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
                flops=2 * 9 * 3 * feat * px * (6 if name == "float32" else 1),
                peak="bfloat16"),
            "conv3x3_bias_prelu": dict(
                kernel=lambda: conv3x3.conv3x3_bias_prelu(
                    x3, w1, c1["b"], a1),
                plain=lambda: conv3x3.conv3x3_bias_prelu_plain(
                    x3, w1, c1["b"], a1),
                lib_in=x3.permute(0, 3, 1, 2), lib_w=w1, lib_b=c1["b"],
                nbytes=2 * px * feat * bpe + w1.numel() * bpe + 2 * feat * 4,
                flops=2 * 9 * feat * feat * px
                * (6 if name == "float32" else 1),
                peak="bfloat16"),
            "head_conv_residual_u8_shuffle": dict(
                kernel=lambda: head.head_conv_residual_u8_shuffle(
                    x1, wl, cl["b"], u8, r),
                plain=lambda: head.head_conv_residual_u8_shuffle_plain(
                    x1, wl, cl["b"], u8, r),
                lib_in=x1.permute(0, 3, 1, 2), lib_w=wl, lib_b=cl["b"],
                nbytes=px * feat * bpe + px * 3 + px * r * r * 3
                + wl.numel() * bpe + 3 * r * r * 4,
                flops=2 * 9 * feat * 3 * r * r * px
                * (6 if name == "float32" else 1),
                peak="bfloat16"),
        }
        if name == "float32" and feat != conv3x3.FEAT:
            # float32 K1 as the model calls it at the wide widths: on the
            # split planes of its input, writing those of its output
            # (held on its value, then the planes bit for bit its own
            # value's split), reported as K1's "float32_planes"
            xp = conv3x3.split_bf16x3(x3)
            cases["conv3x3_bias_prelu_planes"] = dict(
                cases["conv3x3_bias_prelu"],
                kernel=lambda: conv3x3.conv3x3_bias_prelu_planes(
                    xp, w1, c1["b"], a1),
                plain=lambda: conv3x3.conv3x3_bias_prelu_planes_plain(
                    xp, w1, c1["b"], a1),
                nbytes=2 * px * feat * 6 + w1.numel() * 4 + 2 * feat * 4)
            # ... and float32 K2: on the split planes of its input, with
            # no split pass, reported as K2's "float32_planes"
            x1p = conv3x3.split_bf16x3(x1)
            cases["head_conv_residual_u8_shuffle_planes"] = dict(
                cases["head_conv_residual_u8_shuffle"],
                kernel=lambda: head.head_conv_residual_u8_shuffle(
                    x1p, wl, cl["b"], u8, r),
                plain=lambda: head.head_conv_residual_u8_shuffle_plain(
                    x1p, wl, cl["b"], u8, r),
                nbytes=px * feat * 6 + px * 3 + px * r * r * 3
                + wl.numel() * 4 + 3 * r * r * 4)
        for kname, c in cases.items():
            if only is not None and kname not in only:
                continue
            got, want = c["kernel"](), c["plain"]()
            torch.cuda.synchronize()
            n_diff = None
            key, dname = kname, name
            if kname.endswith("_planes"):
                key, dname = kname[:-len("_planes")], "float32_planes"
            if kname == "conv3x3_bias_prelu_planes":
                # the one kernel writing its float32 value beside the
                # planes: the value bit for bit the float32-out K1's on
                # the same input and within 1e-4 of the plain version's;
                # the planes that value's split bit for bit, the same
                # with or without the value written
                planes, value = conv3x3.conv3x3_bias_prelu_planes(
                    xp, w1, c1["b"], a1, value=True)
                # plane values off the plain version's split
                n_diff = count_diff(got, want)
                err = (value - x1).abs().max().item()
                ok = err <= 1e-4 and torch.equal(got, planes) and \
                    torch.equal(planes, conv3x3.split_bf16x3_plain(value)) \
                    and torch.equal(value, conv3x3.conv3x3_bias_prelu(
                        x3, w1, c1["b"], a1))
                del planes, value
            elif got.dtype == torch.uint8:
                err = (got.int() - want.int()).abs().max().item()
                n_diff = int((got != want).sum().item())
                ok = err <= 1
            else:
                err = (got.float() - want.float()).abs().max().item()
                ok = err <= 1e-4 if name == "float32" else \
                    bf16_ulp_ok(got, want)
            if not ok:
                raise AssertionError(f"{kname} {name} at {list(got.shape)}: "
                                     f"kernel disagrees with its plain "
                                     f"version (max |d| {err})")
            if not timed:
                results.setdefault(key, {})[dname] = {
                    "max_abs_err": err, "n_diff": n_diff,
                    "shape": list(got.shape)}
                del got, want
                continue
            lib_w = c["lib_w"].permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            lib_in = c["lib_in"].contiguous(memory_format=torch.channels_last)
            lib_b = c["lib_b"].to(dt)
            bms, bby = bound_ms(c["nbytes"], c["flops"],
                                c.get("peak", name))
            results.setdefault(key, {})[dname] = {
                "max_abs_err": err, "n_diff": n_diff,
                "ms": cuda_time_ms(c["kernel"]),
                "plain_ms": cuda_time_ms(c["plain"]),
                "library_ms": cuda_time_ms(
                    lambda: F.conv2d(lib_in, lib_w, lib_b, padding=1)),
                "bound_ms": bms, "bound_by": bby,
                "shape": list(got.shape),
            }
            del got, want
        if name == "float32" and timed and only is None:
            results["split_bf16x3"] = split_case(x3)
        xp = x1p = None
        del x3, x1
        torch.cuda.empty_cache()
    out["kernels" if timed else "kernels_transposed"] = results
    return results


def split_case(x):
    """The split pass of float32 K1 and K2 alone, on K1's input: exact
    against its plain version; bound by its bytes (4 in, 6 out per
    value)."""
    import torch

    from reve_tpu_torch.kernels import conv3x3

    got, want = conv3x3.split_bf16x3(x), conv3x3.split_bf16x3_plain(x)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if err != 0:
        raise AssertionError(f"split_bf16x3 disagrees with its plain "
                             f"version (max |d| {err})")
    bms, bby = bound_ms(x.numel() * 10, 0, "float32")
    return {"max_abs_err": err,
            "ms": cuda_time_ms(lambda: conv3x3.split_bf16x3(x)),
            "plain_ms": cuda_time_ms(lambda: conv3x3.split_bf16x3_plain(x)),
            "library_ms": None, "bound_ms": bms, "bound_by": bby,
            "shape": list(got.shape)}


def int8_kernel_phase(params, cfg, frames, qb, out: dict,
                      timed: bool = True, only=None) -> dict:
    """K4a, K4 and K4h against their plain versions, then (`timed`)
    timed.  Inputs chain like the int8 model's: K4a on the frames, K4 on
    K4a's output, K4h on K4's output, with the model's weights quantized
    by `qb`.  Untimed, the results hold each kernel's error only.
    `only`: the names of the kernels to hold (None: all)."""
    import torch
    import torch.nn.functional as F

    from reve_tpu_torch.kernels import conv3x3, conv3x3_s8, head

    dev = torch.device("cuda", 0)
    u8 = torch.from_numpy(frames).to(dev)
    B = u8.shape[0]
    px = B * H * W
    feat, r, n = cfg.num_feat, cfg.upscale, cfg.num_conv
    c0, a0 = params["convs"][0], params["prelus"][0]["alpha"]
    w0 = c0["w"].to(torch.bfloat16).contiguous()
    sx = qb.act_scale
    inv = 1.0 / sx
    s1, sl = sx[0] * qb.sw[0], sx[n] * qb.sw_last
    q0 = conv3x3.conv3x3_u8_bias_prelu_q8_plain(u8, w0, c0["b"], a0,
                                                inv[0:1])
    q1 = conv3x3_s8.conv3x3_s8_dq_prelu_q8_plain(q0, qb.w8[0], s1, qb.b[0],
                                                 qb.alpha[0], inv[1:2])

    bf_in = u8.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    bf_w = w0.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    cases = {
        "conv3x3_u8_bias_prelu_q8": dict(
            kernel=lambda: conv3x3.conv3x3_u8_bias_prelu_q8(
                u8, w0, c0["b"], a0, inv[0:1]),
            plain=lambda: conv3x3.conv3x3_u8_bias_prelu_q8_plain(
                u8, w0, c0["b"], a0, inv[0:1]),
            library=lambda: F.conv2d(bf_in, bf_w,
                                     c0["b"].to(torch.bfloat16), padding=1),
            tol=1, nbytes=px * 3 + px * feat + w0.numel() * 2 + 2 * feat * 4
            + 4, flops=2 * 9 * 3 * feat * px, peak="bfloat16"),
        "conv3x3_s8_dq_prelu_q8": dict(
            kernel=lambda: conv3x3_s8.conv3x3_s8_dq_prelu_q8(
                q0, qb.w8[0], s1, qb.b[0], qb.alpha[0], inv[1:2]),
            plain=lambda: conv3x3_s8.conv3x3_s8_dq_prelu_q8_plain(
                q0, qb.w8[0], s1, qb.b[0], qb.alpha[0], inv[1:2]),
            library=int_mm_x4(q0, feat, qb.w8[0], B) if timed else None,
            tol=0, nbytes=2 * px * feat + qb.w8[0].numel() + 3 * feat * 4
            + 4, flops=2 * 9 * feat * feat * px, peak="int8"),
        "head_conv_s8_residual_u8_shuffle": dict(
            kernel=lambda: head.head_conv_s8_residual_u8_shuffle(
                q1, qb.w8_last, sl, qb.b_last, u8, r),
            plain=lambda: head.head_conv_s8_residual_u8_shuffle_plain(
                q1, qb.w8_last, sl, qb.b_last, u8, r),
            library=int_mm_x4(q1, feat, qb.w8_last, B) if timed else None,
            tol=0, nbytes=px * feat + px * 3 + px * r * r * 3
            + qb.w8_last.numel() + 2 * 3 * r * r * 4,
            flops=2 * 9 * feat * 3 * r * r * px, peak="int8"),
    }
    results = {}
    for kname, c in cases.items():
        if only is not None and kname not in only:
            continue
        got, want = c["kernel"](), c["plain"]()
        torch.cuda.synchronize()
        err = (got.int() - want.int()).abs().max().item()
        if err > c["tol"]:
            raise AssertionError(f"{kname} at {list(got.shape)}: kernel "
                                 f"disagrees with its plain version (max "
                                 f"|d| {err} > {c['tol']})")
        n_diff = int((got != want).sum().item())
        if not timed:
            results[kname] = {"max_abs_err": err, "n_diff": n_diff,
                              "shape": list(got.shape)}
            del got, want
            continue
        bms, bby = bound_ms(c["nbytes"], c["flops"], c["peak"])
        results[kname] = {
            "max_abs_err": err, "n_diff": n_diff,
            "ms": cuda_time_ms(c["kernel"]),
            "plain_ms": cuda_time_ms(c["plain"], iters=3),
            "library_ms": library_time_ms(c["library"]),
            "bound_ms": bms, "bound_by": bby, "shape": list(got.shape),
        }
        del got, want
    torch.cuda.empty_cache()
    out["int8_kernels" if timed else "int8_kernels_transposed"] = results
    return results


def tta_kernel_phase(out: dict) -> dict:
    """K6 at the TTA path's shape: each form for each of the 8 transforms
    against its plain version (exact), then timed beside it, beside the
    same function as in-place torch ops and the byte bound (FIRST 3 B a
    value, MIDDLE 5, LAST 4).  The top-level numbers are per launch,
    averaged over one batch's 8 launches (1 FIRST, 6 MIDDLE, 1 LAST)."""
    import torch

    from reve_tpu_torch.kernels import tta

    dev = torch.device("cuda", 0)
    shape = (BATCH, H * SCALE, W * SCALE, 3)
    n = math.prod(shape)
    gen = torch.Generator(device=dev).manual_seed(0)
    acc0 = torch.randint(0, 1786, shape, dtype=tta.ACC_DTYPE, device=dev,
                         generator=gen)
    forms = {}
    for form, fname, nbytes in ((tta.FIRST, "first", 3),
                                (tta.MIDDLE, "middle", 5),
                                (tta.LAST, "last", 4)):
        per_spec, n_diff, max_err = {}, 0, 0
        for k, flip in tta.SPECS:
            ys = (BATCH, W * SCALE, H * SCALE, 3) if k & 1 else shape
            y = torch.randint(0, 256, ys, dtype=torch.uint8, device=dev,
                              generator=gen)
            acc, acc_p = acc0.clone(), acc0.clone()
            res = torch.empty(shape, dtype=torch.uint8, device=dev)
            res_p = torch.empty_like(res)
            tta.tta_accumulate(y, acc, k, flip, form, out=res)
            tta.tta_accumulate_plain(y, acc_p, k, flip, form, out=res_p)
            torch.cuda.synchronize()
            got, want = (res, res_p) if form == tta.LAST else (acc, acc_p)
            d = int((got != want).sum().item())
            err = (got.int() - want.int()).abs().max().item()
            n_diff += d
            max_err = max(max_err, err)

            def library():
                term = torch.rot90(y.flip(2) if flip else y, -k, (1, 2))
                if form == tta.FIRST:
                    acc.copy_(term)
                elif form == tta.MIDDLE:
                    acc.add_(term)
                else:
                    res.copy_((acc + term + 4) >> 3)
            per_spec[f"{k}{'f' if flip else ''}"] = {
                "n_diff": d, "max_abs_err": err,
                "ms": cuda_time_ms(lambda: tta.tta_accumulate(
                    y, acc, k, flip, form, out=res)),
                "plain_ms": cuda_time_ms(lambda: tta.tta_accumulate_plain(
                    y, acc_p, k, flip, form, out=res_p), iters=3),
                "library_ms": cuda_time_ms(library, iters=3)}
            del y, acc, acc_p, res, res_p, got, want
        if n_diff:
            raise AssertionError(f"tta_accumulate {fname}: {n_diff} values "
                                 f"differ from the plain version")
        bms, bby = bound_ms(nbytes * n, 0, "int8")
        forms[fname] = {key: sum(v[key] for v in per_spec.values()) / 8
                        for key in ("ms", "plain_ms", "library_ms")}
        forms[fname].update(n_diff=n_diff, max_abs_err=max_err,
                            bound_ms=bms, bound_by=bby,
                            ms_by_transform={t: v["ms"]
                                             for t, v in per_spec.items()})
    torch.cuda.empty_cache()
    weights = {"first": 1, "middle": 6, "last": 1}
    result = {key: sum(weights[f] * forms[f][key] for f in forms) / 8
              for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    result.update(max_abs_err=max(f["max_abs_err"] for f in forms.values()),
                  n_diff=sum(f["n_diff"] for f in forms.values()),
                  bound_by="bytes",
                  batch_ms=8 * result["ms"],
                  batch_bound_ms=8 * result["bound_ms"], forms=forms,
                  shape=list(shape))
    out["tta_kernel"] = result
    return result


def span_seconds(trace: str) -> dict:
    """Seconds per scheduler span of a job's --trace file."""
    spans = {}
    with open(trace) as f:
        for ln in f:
            ev = json.loads(ln)
            if "dur" in ev:
                spans[ev["ev"]] = spans.get(ev["ev"], 0.0) + ev["dur"]
    return spans


def tile_engine_checks(params, cfg, frames) -> dict:
    """On the engine: tiled batches (--tile TILE) byte-identical to whole
    frames in int8 (with the scales the whole-frame engine calibrated)
    and float32; the model's ms per batch, tiled and whole, in the three
    dtypes (the plan's calls on the card, no host copies)."""
    import torch

    from reve_tpu_torch.pipeline.engine import UpscaleEngine

    batch = frames[:BATCH]
    dev_in = torch.from_numpy(batch).cuda()
    n_diff, ms = {}, {}
    for dt in ("bfloat16", "int8", "float32"):
        whole = UpscaleEngine(compute_dtype=dt, batch_size=BATCH, tile=-1,
                              preloaded=(cfg, params))
        tiled = UpscaleEngine(compute_dtype=dt, batch_size=BATCH,
                              tile=TILE, preloaded=(cfg, params))
        if dt == "int8":
            whole.calibrate_int8(frames)
            tiled.set_calibration(whole.get_calibration())
        if dt != "bfloat16":
            d = int((whole.submit(batch).result()
                     != tiled.submit(batch).result()).sum())
            if d:
                raise AssertionError(f"{dt}: tiled batch differs from the "
                                     f"whole frames in {d} bytes")
            n_diff[dt] = d
        ms[dt] = {name: cuda_time_ms(lambda: [y for _, _, y in
                                              eng._pieces(dev_in)], iters=3)
                  for name, eng in (("tiled", tiled), ("whole", whole))}
        ms[dt]["ratio"] = ms[dt]["tiled"] / ms[dt]["whole"]
        ms[dt]["plan"] = list(tiled._plans[(H, W)])
        del whole, tiled
        torch.cuda.empty_cache()
    return {"engine_n_diff": n_diff, "model_ms_per_batch": ms}


def tta_engine_checks(params, cfg, batch, job_frame0, work: str) -> dict:
    """On the engine: the TTA ensemble of `batch` (the job's frames as it
    decoded them from the y4m input) against the manual one (the
    whole-frame engine on the 8 forward-transformed batches, inverse
    transformed and averaged by K6's plain version, on the card), the
    model output of the first quarter-turn (a 1080 x 1920 batch) against
    the plain float32 path on the same input (PSNR >=
    srvgg.BF16_PSNR_FLOOR_DB, the gate of the main phase), the job's
    output frame 0 against the ensemble's through the same y4m encode,
    and tta(rot90(x)) == rot90(tta(x))."""
    import torch

    from reve_tpu_torch.io import reader, writer
    from reve_tpu_torch.kernels import tta
    from reve_tpu_torch.models import srvgg
    from reve_tpu_torch.pipeline.engine import UpscaleEngine

    ens = UpscaleEngine(compute_dtype="bfloat16", batch_size=BATCH,
                        tta=True, preloaded=(cfg, params))
    plain = UpscaleEngine(compute_dtype="bfloat16", batch_size=BATCH,
                          preloaded=(cfg, params))
    t0 = time.perf_counter()
    got = ens.submit(batch).result().copy()
    batch_s = time.perf_counter() - t0
    x = torch.from_numpy(batch)
    shape = (BATCH, H * SCALE, W * SCALE, 3)
    acc = torch.empty(shape, dtype=tta.ACC_DTYPE, device="cuda")
    mean = torch.empty(shape, dtype=torch.uint8, device="cuda")
    for s, (k, flip) in enumerate(tta.SPECS):
        xt = tta.forward_transform(x, k, flip)
        y = plain.submit(xt.numpy()).result()
        if (k, flip) == (1, False):
            ref = srvgg.apply(params, xt.cuda(), cfg=cfg,
                              compute_dtype=torch.float32, plain=True)
            mse = (torch.from_numpy(y).cuda().double()
                   - ref.double()).square().mean().item()
            db_rot = 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))
            del ref
            if not db_rot >= srvgg.BF16_PSNR_FLOOR_DB:
                raise AssertionError(
                    f"model output on the quarter-turned batch "
                    f"{list(y.shape)}: PSNR {db_rot:.2f} dB vs the plain "
                    f"float32 path < {srvgg.BF16_PSNR_FLOOR_DB} dB")
        form = tta.FIRST if s == 0 else tta.LAST if s == 7 else tta.MIDDLE
        tta.tta_accumulate_plain(torch.from_numpy(y).cuda(), acc, k, flip,
                                 form, out=mean)
    n_manual = int((mean.cpu().numpy() != got).sum())
    del acc, mean
    if n_manual:
        raise AssertionError(f"TTA ensemble differs from the manual one in "
                             f"{n_manual} bytes")
    ref_path = os.path.join(work, "ref_tta.y4m")
    with writer.open_writer(ref_path, W * SCALE, H * SCALE,
                            fractions.Fraction(24), backend="y4m") as wr:
        wr.write(got[0])
    ref0 = next(reader.Y4MReader(ref_path).read_range(0, 1))
    n_job = int((ref0 != job_frame0).sum())
    if n_job:
        raise AssertionError(f"TTA job frame 0 differs from the engine's "
                             f"ensemble in {n_job} bytes")
    rot = ens.submit(np.ascontiguousarray(np.rot90(batch, 1, (1, 2))))
    n_equiv = int((rot.result() != np.rot90(got, 1, (1, 2))).sum())
    if n_equiv:
        raise AssertionError(f"tta(rot90(x)) != rot90(tta(x)) in {n_equiv} "
                             f"bytes")
    torch.cuda.empty_cache()
    return {"n_diff_vs_manual": n_manual, "n_diff_job_frame0": n_job,
            "psnr_db_rot90_vs_plain_f32": db_rot,
            "n_diff_equivariance_rot90": n_equiv,
            "engine_batch_s": batch_s}


def model_ms(params, cfg, frames) -> dict:
    """The whole model, u8 -> u8 on the card, per batch of BATCH frames."""
    import torch

    from reve_tpu_torch.models import srvgg

    u8 = torch.from_numpy(frames).to("cuda")
    return {name: cuda_time_ms(lambda: srvgg.apply(
        params, u8, cfg=cfg, compute_dtype=getattr(torch, name)), iters=3)
        for name in ("bfloat16", "float32")}


def probe_phase(out: dict, smi: str) -> dict:
    """P1 through the probe script's entry point with the launch counters
    zeroed (its calls queued behind a sleep kernel at 64 and 1024 loops,
    then timed from the host; the growth must be linear), then against
    its plain version and beside one library call of the same
    multiply-adds and 64 library calls, on the same inputs."""
    import torch

    from reve_tpu_torch import kernels
    from reve_tpu_torch.kernels import dot_probe
    from reve_tpu_torch.scripts import perf_int8_dot as probe

    iters, loops = 20, 64
    torch.cuda.synchronize()
    kernels.reset_launches()
    rates = probe.main(["--iters", str(iters), "--loops", str(loops)],
                       card_line=smi)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["dot_loop"]
    # per dtype: the queued calls at 64 and at 1024 loops and the host's
    # loop, each one untimed call and `iters` timed ones
    if launches != 2 * 3 * (iters + 1):
        raise AssertionError(f"probe launched P1 {launches} times, "
                             f"expected {2 * 3 * (iters + 1)}")
    ops = probe.inputs(torch.device("cuda", 0))
    k = probe.K
    results = {}
    for name, peak in (("int8", "int8"), ("bf16", "bfloat16")):
        r = rates[name]
        if not r["linear"]:
            raise AssertionError(
                f"dot_loop {name}: time x{r['growth']:.2f} from "
                f"{r['loops']} to {r['long_loops']} loops, marginal "
                f"{r['marginal_tops']:.1f} TOP/s: not linear")
        x, w = ops[name]
        got = dot_probe.dot_loop(x, w, loops)
        want = dot_probe.dot_loop_plain(x, w, loops)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        tol = 0.0 if name == "int8" else \
            1e-4 * want.abs().max().item()
        if err > tol:
            raise AssertionError(f"dot_loop {name}: kernel disagrees with "
                                 f"its plain version (max |d| {err} > "
                                 f"{tol})")
        halves = (w[:k], w[k:])
        xt, wt = probe.library_operands(x, w, loops)
        if name == "int8":
            lib_dtype = "int32"

            def library():
                return torch._int_mm(xt, wt)

            def library_loop():
                for i in range(loops):
                    torch._int_mm(x, halves[i % 2])
        else:
            # float32 output where the installed PyTorch offers it
            lib_dtype = "float32"

            def library():
                return torch.mm(xt, wt, out_dtype=torch.float32)

            def library_loop():
                for i in range(loops):
                    torch.matmul(x, halves[i % 2])
        try:
            lib_out = library()
        except (TypeError, RuntimeError, NotImplementedError) as e:
            if name == "int8":
                raise
            print(f"# torch.mm without out_dtype=float32 "
                  f"({str(e).splitlines()[0]}): bf16 output", flush=True)
            lib_dtype = "bfloat16"

            def library():
                return torch.mm(xt, wt)
            lib_out = library()
        lib_err = (lib_out.double() - want.double()).abs().max().item()
        del lib_out
        flops = 2 * probe.M * k * probe.N * loops
        nbytes = (x.numel() + w.numel()) * x.element_size() + got.numel() * 4
        bms, bby = bound_ms(nbytes, flops, peak)
        results[name] = {
            "max_abs_err": err, "ms": r["ms"], "tops": r["tops"],
            "ms_long": r["ms_long"], "long_loops": r["long_loops"],
            "marginal_tops": r["marginal_tops"], "growth": r["growth"],
            "linear": r["linear"], "host_ms": r["host_ms"],
            "plain_ms": cuda_time_ms(lambda: dot_probe.dot_loop_plain(
                x, w, loops), iters=3),
            "library_ms": library_time_ms(library),
            "library_dtype": lib_dtype, "library_max_abs_err": lib_err,
            "library_loop_ms": library_time_ms(library_loop),
            "bound_ms": bms, "bound_by": bby,
            "shape": [probe.M, k, probe.N, loops],
        }
        del xt, wt
    out.update(results, launches=launches, ratio_int8_bf16=rates["ratio"],
               marginal_ratio_int8_bf16=rates["marginal_ratio"],
               peak_ratio=PEAK_FLOPS["int8"] / PEAK_FLOPS["bfloat16"],
               nvidia_smi=smi)
    return results


#: the rrdb phase's model and its K7 launches per call: 15 dense convs a
#: block and conv_body
RRDB_MODEL = "realesrgan-x4plus"
RRDB_BLOCKS = 23
RRDB_K7_PER_CALL = 15 * RRDB_BLOCKS + 1
#: split passes per float32 RRDB call: feat's once (the trunk's convs
#: write the planes they read), then the head's three K1 (conv_last reads
#: its float32 input as it is)
RRDB_F32_SPLITS_PER_CALL = 1 + 3
#: each frame of the bf16 job may sit this far further from the plain
#: float32 path than the plain bfloat16 path does (dB):
#: tests/test_torch_rrdb.py's margin against the JAX package's own bf16
#: error
RRDB_BF16_MARGIN_DB = 1.0
#: and no frame of it below this against the plain bfloat16 path (dB):
#: the kernels' rounding moves it to 59.7 dB on frame 0 (PERF.md §6)
RRDB_VS_PLAIN_BF16_DB = 50.0
#: each frame of the rrdb_int8 job against the port's plain int8 path with
#: the job's persisted calibration (dB), as the SRVGG int8 phase holds it
RRDB_INT8_FLOOR_DB = 60.0


def k7_forms(params):
    """K7's forms on the model's path, with the weights of block 0 that
    use them and their launches per model call: convs 1-4 (lrelu, Cin 64
    to 160) three times a block, conv 5 as rdb twice a block and as rrdb
    once, conv_body (add) once."""
    rdbs = params["body"][0]["rdbs"]
    forms = [(f"lrelu_{64 + 32 * i}", 64 + 32 * i, 32, "lrelu",
              rdbs[0]["convs"][i], 3 * RRDB_BLOCKS) for i in range(4)]
    forms += [("rdb_192", 192, 64, "rdb", rdbs[0]["convs"][4],
               2 * RRDB_BLOCKS),
              ("rrdb_192", 192, 64, "rrdb", rdbs[2]["convs"][4],
               RRDB_BLOCKS),
              ("add_64", 64, 64, "add", params["conv_body"], 1)]
    assert sum(f[-1] for f in forms) == RRDB_K7_PER_CALL
    return forms


def library_conv(buf, cin: int, w, b):
    """The yardstick for K7's and the conv_last mode's time (the port
    never calls it): one cuDNN F.conv2d of the same conv in channels-last
    at the same dtype (TF32 off for float32), on operands laid out once
    here.  Returns a callable."""
    import torch
    import torch.nn.functional as F

    x = buf[..., :cin].permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bl = b.to(w.dtype)
    return lambda: F.conv2d(x, wl, bl, padding=1)


def rrdb_kernel_phase(params, frames) -> dict:
    """K7's forms at the main path's shapes (a batch of 4 1080p frames) in
    both dtypes, against their plain versions on the same inputs (the
    frames through conv_first, then block 0's first dense block in the
    plain version, so every form reads the model's own activations),
    then timed beside the plain version, one cuDNN F.conv2d of the same
    conv (channels-last, the same dtype, TF32 off) and the bound (bytes:
    the channels read, written and the residuals, in float32 the planes
    read and written; operations: float32's six bf16 products at the
    bf16 rate).  float32 runs as the model runs it, on the split planes
    of its input, writing those of its output (conv_body's add writes
    none), which must equal the split pass's of its output bit for bit.
    Tolerances: bfloat16 <= 2 ulp of the largest operand of the epilogue
    (the conv value, the residuals, the result), float32 max |d| <= 2e-6.
    The top-level
    numbers of each dtype are per launch, weighted by the forms'
    launches in one model call ("call_ms": their sum over the call)."""
    import torch

    from reve_tpu_torch import device as device_mod
    from reve_tpu_torch.kernels import conv3x3
    from reve_tpu_torch.kernels import rrdb as k7

    dev = torch.device("cuda", 0)
    u8 = torch.from_numpy(frames).to(dev)
    B = u8.shape[0]
    px = B * H * W
    forms = k7_forms(params)
    results = {}
    for name in ("bfloat16", "float32"):
        dt = getattr(torch, name)
        bpe = torch.finfo(dt).bits // 8
        device_mod.strict_f32()
        cf = params["conv_first"]
        feat = conv3x3.conv3x3_u8_bias_prelu_plain(
            u8, cf["w"].to(dt), cf["b"], torch.ones(64, device=dev))
        a = torch.empty((B, H, W, 192), dtype=dt, device=dev)
        a[..., :64] = feat
        for i in range(4):
            c = params["body"][0]["rdbs"][0]["convs"][i]
            k7.dense_conv_plain(a, 64 + 32 * i, c["w"].to(dt), c["b"], a,
                                64 + 32 * i, "lrelu")
        by_form = {}
        for fname, cin, cout, epi, p, n in forms:
            w, b = p["w"].to(dt).contiguous(), p["b"]
            packed = k7.pack_weights_dense(w)
            if epi == "lrelu":
                out, off, res, res2 = a.clone(), cin, None, None
                buf = out
            elif epi == "add":
                out = feat.clone()
                buf, off, res, res2 = a, 0, out, None
            else:
                out = a.clone() if epi == "rrdb" else torch.empty_like(a)
                buf, off, res = a, 0, a
                res2 = out if epi == "rrdb" else None
            want = out.clone()
            plain_args = (buf if buf is not out else want, cin, w, b, want,
                          off, epi, res if res is not out else want,
                          res2 if res2 is not out else want)
            # float32 as the model runs it: on the planes of its input,
            # writing those of its output (conv_body's add writes none)
            pl = {}
            if name == "float32":
                pl["planes"] = conv3x3.split_bf16x3(buf)
                if epi != "add":
                    pl["out_planes"] = pl["planes"] if out is buf else \
                        conv3x3.split_bf16x3(out)
            k7.dense_conv(buf, cin, w, b, out, off, epi, res, res2,
                          packed=packed, **pl)
            k7.dense_conv_plain(*plain_args)
            torch.cuda.synchronize()
            got_s, want_s = (t[..., off:off + cout] for t in (out, want))
            err = (got_s.float() - want_s.float()).abs().max().item()
            if name == "float32":
                ok = err <= 2e-6
                # the planes it wrote: the split pass's of its output
                if "out_planes" in pl and not torch.equal(
                        pl["out_planes"][..., off:off + cout],
                        conv3x3.split_bf16x3(got_s)):
                    raise AssertionError(f"dense_conv {fname} float32: the "
                                         f"planes it wrote are not the "
                                         f"split of its output")
            else:
                y = conv3x3.conv3x3_plain(a[..., :cin], w, b)
                # the residuals as they were before the kernel wrote
                ops = [t[..., :cout] for t in
                       {"lrelu": (), "rdb": (a,), "rrdb": (a, a),
                        "add": (feat,)}[epi]]
                mag = torch.stack([t.float().abs() for t in
                                   [got_s, want_s, y] + ops]).amax(0) \
                    .clamp_min(2.0 ** -10)
                ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
                ok = bool(((got_s.float() - want_s.float()).abs()
                           <= 2 * ulp).all())
                del y, mag, ulp
            if not ok:
                raise AssertionError(f"dense_conv {fname} {name}: kernel "
                                     f"disagrees with its plain version "
                                     f"(max |d| {err})")
            del got_s, want_s
            resid = {"lrelu": 0, "rdb": 1, "rrdb": 2, "add": 1}[epi]
            nbytes = px * (cin + cout * (1 + resid)) * bpe \
                + w.numel() * bpe + cout * 4
            if name == "float32":
                # it reads the planes of its input (6 B a value, not 4)
                # and writes those of its output beside the values
                nbytes += px * (cin + (cout if "out_planes" in pl else 0)) \
                    * 2 * 3 - px * cin * bpe
            bms, bby = bound_ms(nbytes, 2 * 9 * cin * cout * px
                                * (6 if name == "float32" else 1),
                                "bfloat16")
            by_form[fname] = {
                "cin": cin, "cout": cout, "epilogue": epi,
                "launches_per_call": n, "max_abs_err": err,
                "ms": cuda_time_ms(lambda: k7.dense_conv(
                    buf, cin, w, b, out, off, epi, res, res2,
                    packed=packed, **pl)),
                "plain_ms": cuda_time_ms(lambda: k7.dense_conv_plain(
                    *plain_args), iters=3),
                "library_ms": cuda_time_ms(library_conv(buf, cin, w, b)),
                "bound_ms": bms, "bound_by": bby}
            del out, want, plain_args, res, res2, buf, pl
            torch.cuda.empty_cache()
        total = sum(f["launches_per_call"] for f in by_form.values())
        top = {key: sum(f[key] * f["launches_per_call"]
                        for f in by_form.values()) / total
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        top.update(max_abs_err=max(f["max_abs_err"]
                                   for f in by_form.values()),
                   bound_by="operations" if all(
                       f["bound_by"] == "operations"
                       for f in by_form.values()) else "bytes",
                   call_ms=top["ms"] * total,
                   call_bound_ms=top["bound_ms"] * total,
                   forms=by_form, shape=[B, H, W, 192])
        results[name] = top
        del a, feat
        torch.cuda.empty_cache()
    return results


def part_times(source: str) -> dict:
    """A dense-block kernel's time by part (reve_tpu_torch.scripts.
    perf_conv_tc_parts on rrdb.cu, K7, or rrdb_s8.cu, K7q: its forms at
    the trunk's shapes with the halo loads, the wgmmas or the epilogue
    taken out, and the stores alone; K7 also without the weight copies
    after each block's first tile): {variant: {timing: ms}}, each the
    mean of the script's two rounds of 5 launches."""
    import torch

    from reve_tpu_torch.scripts import perf_conv_tc_parts

    line = perf_conv_tc_parts.run([source], iters=5)
    torch.cuda.empty_cache()
    return {variant: {key: sum(t) / len(t) for key, t in timings.items()}
            for variant, timings in line["variants"][source].items()}


def int_mm_x4(x8, cin: int, w8, frames: int):
    """The yardstick of K4's and K7q's time (the port never calls it):
    torch._int_mm of one frame's im2col'd s8 product (x8's first `cin`
    channels, built here once and not timed; the weights' columns padded
    with zeros to a multiple of 8, as _int_mm takes them: 12 and 27 at
    the x2 and x3 heads), `frames` times.  Returns a callable."""
    import torch
    import torch.nn.functional as F

    h, w = x8.shape[1:3]
    xp = F.pad(x8[0, ..., :cin].permute(2, 0, 1), (1, 1, 1, 1)) \
        .permute(1, 2, 0)
    cols = torch.cat([xp[dy:dy + h, dx:dx + w] for dy in range(3)
                      for dx in range(3)], -1).reshape(h * w, -1)
    n = w8.shape[-1]
    wm = F.pad(w8.reshape(-1, n), (0, -n % 8)).contiguous()

    def run():
        for _ in range(frames):
            torch._int_mm(cols, wm)
    return run


def k7q_forms(qb):
    """K7q's forms on the int8 model's path, with the quantized weights of
    block 0 that use them ((qrdb, conv index)) and their launches per
    model call: convs 1-4 (lrelu_q, Cin 64 to 160) three times a block,
    conv 5 as rdb twice a block and as rrdb once, conv_body (add) once."""
    rdbs = qb["body"][0]
    cb = {k: [v] for k, v in qb["conv_body"].items()}
    forms = [(f"lrelu_q_{64 + 32 * i}", 64 + 32 * i, 32, "lrelu_q",
              rdbs[0], i, 3 * RRDB_BLOCKS) for i in range(4)]
    forms += [("rdb_192", 192, 64, "rdb", rdbs[0], 4, 2 * RRDB_BLOCKS),
              ("rrdb_192", 192, 64, "rrdb", rdbs[2], 4, RRDB_BLOCKS),
              ("add_64", 64, 64, "add", cb, 0, 1)]
    assert sum(f[-1] for f in forms) == RRDB_K7_PER_CALL
    return forms


def rrdb_int8_kernel_phase(params, qb, frames) -> dict:
    """K7q's forms at the main path's shapes (a batch of 4 1080p frames),
    each against its plain version on the int8 model's own activations
    (the frames through conv_first in bfloat16, the trunk input's
    quantize, then block 0's first dense block by the plain lrelu_q
    forms), exact: s8 codes n_diff 0, the float32 chain and conv_body's
    bfloat16 feat bit-identical (integer sums, the same float32 steps,
    each rounded on its own).  Then timed beside the plain version,
    torch._int_mm of one frame's im2col'd product x4 (K4's convention) and
    the bound (bytes for every form: the s8 channels read, the s8 and
    float32 written, the float32 residuals read; operations at the s8
    rate).  The top-level numbers are per launch, weighted by the forms'
    launches in one model call ("call_ms": their sum over the call)."""
    import torch

    from reve_tpu_torch.kernels import conv3x3
    from reve_tpu_torch.kernels import rrdb as k7
    from reve_tpu_torch.models import rrdb

    dev = torch.device("cuda", 0)
    u8 = torch.from_numpy(frames).to(dev)
    B = u8.shape[0]
    px = B * H * W
    inv = 1.0 / qb["act_scale"]
    cf = params["conv_first"]
    feat = conv3x3.conv3x3_u8_bias_prelu_plain(
        u8, cf["w"].to(torch.bfloat16), cf["b"], torch.ones(64, device=dev))
    chain = feat.float()
    a = torch.zeros((B, H, W, 192), dtype=torch.int8, device=dev)
    rrdb._quant_into(a[..., :64], chain, inv[0])
    q0 = qb["body"][0][0]
    for i in range(4):
        k7.dense_conv_s8_plain(a, 64 + 32 * i, q0["w8"][i], q0["sw"][i],
                               q0["b"][i], "lrelu_q", inv=inv[i + 1],
                               out8=a, out8_off=64 + 32 * i)
    by_form = {}
    for fname, cin, cout, epi, q, i, n in k7q_forms(qb):
        w8, sw, b = q["w8"][i], q["sw"][i], q["b"][i]
        packed = k7.pack_weights_dense_s8(w8)

        def operands():
            """Fresh (buf, out8, out, kwargs) of one call: the tensors it
            writes are copies, so the kernel and the plain version start
            alike."""
            if epi == "lrelu_q":
                buf = a.clone()
                return buf, buf, None, dict(inv=inv[i + 1], out8=buf,
                                            out8_off=cin)
            if epi == "add":
                out = feat.clone()
                return a, None, out, dict(res=out, out=out)
            out8 = torch.zeros_like(a)
            out = chain.clone() if epi == "rrdb" else torch.empty_like(chain)
            kw = dict(inv=inv[5], out8=out8, res=chain, out=out)
            if epi == "rrdb":
                kw["res2"] = out
            return a, out8, out, kw

        got, want = operands(), operands()
        k7.dense_conv_s8(got[0], cin, w8, sw, b, epi, packed=packed,
                         **got[3])
        k7.dense_conv_s8_plain(want[0], cin, w8, sw, b, epi, **want[3])
        torch.cuda.synchronize()
        lo = cin if epi == "lrelu_q" else 0
        n_diff = 0 if epi == "add" else int(
            (got[1][..., lo:lo + cout] != want[1][..., lo:lo + cout]).sum())
        err = 0.0 if epi == "lrelu_q" else float(
            (got[2].float() - want[2].float()).abs().max())
        if n_diff or err:
            raise AssertionError(f"dense_conv_s8 {fname}: kernel disagrees "
                                 f"with its plain version (n_diff {n_diff}, "
                                 f"max |d| {err})")
        del want
        resid = {"lrelu_q": 0, "rdb": 1, "rrdb": 2, "add": 1}[epi]
        if epi == "add":
            nbytes = px * (cin + 2 * cout * 2)
        else:
            nbytes = px * (cin + cout + (cout * 4 * (1 + resid)
                                         if resid else 0))
        nbytes += w8.numel() + 2 * cout * 4
        bms, bby = bound_ms(nbytes, 2 * 9 * cin * cout * px, "int8")
        buf, _o8, _o, kw = got
        by_form[fname] = {
            "cin": cin, "cout": cout, "epilogue": epi,
            "launches_per_call": n, "max_abs_err": err, "n_diff": n_diff,
            "ms": cuda_time_ms(lambda: k7.dense_conv_s8(
                buf, cin, w8, sw, b, epi, packed=packed, **kw)),
            "plain_ms": cuda_time_ms(lambda: k7.dense_conv_s8_plain(
                buf, cin, w8, sw, b, epi, **kw), iters=1),
            "library_ms": library_time_ms(int_mm_x4(a, cin, w8, B)),
            "bound_ms": bms, "bound_by": bby}
        del got, buf, kw, _o8, _o
        torch.cuda.empty_cache()
    total = sum(f["launches_per_call"] for f in by_form.values())
    top = {key: None if any(f[key] is None for f in by_form.values())
           else sum(f[key] * f["launches_per_call"]
                    for f in by_form.values()) / total
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    top.update(max_abs_err=max(f["max_abs_err"] for f in by_form.values()),
               n_diff=sum(f["n_diff"] for f in by_form.values()),
               bound_by="operations" if all(
                   f["bound_by"] == "operations" for f in by_form.values())
               else "bytes",
               call_ms=top["ms"] * total,
               call_bound_ms=top["bound_ms"] * total,
               forms=by_form, shape=[B, H, W, 192])
    del a, chain, feat
    torch.cuda.empty_cache()
    return top


def rrdb_int8_calls(launches: dict,
                    first: str = "conv3x3_u8_bias_prelu") -> dict:
    """The model calls of the rrdb_int8 job from its launch counts, and
    the check that each ran the int8 path's kernels: an int8 call
    launches K3 (bf16) once, K7q 346 times, K1 3 times and the conv_last
    mode once; the calibration's float32 forwards K3 once, the split
    pass once (feat's) and K7 345 times (no conv_body); the
    certification's float32 calls the whole float32 model (K3, 346 x K7,
    3 x K1, conv_last, 4 split passes).  At least one of
    each, and more int8 calls than float32 ones (the job's own batch).
    `first`: conv_first's kernel (x2: conv3x3_u8x2_bias, K3 at Cin 12);
    the other u8 conv never runs."""
    k7q = launches["dense_conv_s8"]
    n8 = k7q // RRDB_K7_PER_CALL
    cert = launches["conv_last_u8"] - n8
    calib = launches[first] - launches["conv_last_u8"]
    other = "conv3x3_u8x2_bias" if first == "conv3x3_u8_bias_prelu" else \
        "conv3x3_u8_bias_prelu"
    ok = (k7q == RRDB_K7_PER_CALL * n8 and n8 > cert >= 1 and calib >= 1
          and launches["conv3x3_bias_prelu"] == 3 * (n8 + cert)
          and launches["dense_conv"] == (RRDB_K7_PER_CALL - 1) * calib
          + RRDB_K7_PER_CALL * cert
          # feat's split in each float32 trunk, and the head's too in
          # each certification call
          and launches["split_bf16x3"] == calib
          + RRDB_F32_SPLITS_PER_CALL * cert
          and not any(launches[k] for k in (
              "head_conv_residual_u8_shuffle", "conv3x3_s8_dq_prelu_q8",
              "conv3x3_u8_bias_prelu_q8", "head_conv_s8_residual_u8_shuffle",
              "tta_accumulate", other)))
    if not ok:
        raise AssertionError(f"launch counts {launches} do not show the "
                             f"RRDB int8 path's kernels")
    return {"int8": n8, "float32_calibration": calib,
            "float32_certification": cert,
            "float32_" + first: calib + cert,
            "float32_conv3x3_bias_prelu": 3 * cert,
            "float32_conv_last_u8": cert}


def rrdb_int8_engine_checks(frames, maxima, model: str = RRDB_MODEL,
                            scale: int = SCALE) -> dict:
    """An int8 RRDB engine on the card with the job's persisted
    calibration: the plan, one call's peak device memory (held to what
    the plan bills for it) and the model's ms per batch."""
    import torch

    from reve_tpu_torch.pipeline.engine import UpscaleEngine

    eng = UpscaleEngine(model=model, scale=scale, compute_dtype="int8",
                        batch_size=BATCH, allow_random_init=True)
    eng.set_calibration(maxima)
    dev_in = torch.from_numpy(frames).cuda()
    plan = eng._plan_execution(H, W)
    if plan.tile:
        raise AssertionError(f"int8 plan {plan}: tiles at 1080p")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with eng._on_device():
        y = eng._forward(dev_in[:plan.per_call])
    torch.cuda.synchronize()
    del y
    rec = {"plan": list(plan),
           "peak_bytes_per_call": torch.cuda.max_memory_allocated() - base,
           "billed_bytes_per_call": plan.per_call * eng._frame_bytes(H, W)}
    if rec["peak_bytes_per_call"] > rec["billed_bytes_per_call"]:
        raise AssertionError(f"int8: a call peaked at "
                             f"{rec['peak_bytes_per_call']} B, past the "
                             f"plan's {rec['billed_bytes_per_call']} B")
    rec["model_ms_per_batch"] = cuda_time_ms(
        lambda: run_pieces(eng, dev_in), iters=2)
    del eng, dev_in
    torch.cuda.empty_cache()
    return rec


def conv_last_phase(params, batches: dict) -> dict:
    """conv_last at the main path's shapes (4 frames of 7680 x 4320 in
    bfloat16, K2's conv_last mode; the float32 plan's chunk,
    `batches["float32"]` frames, in float32, conv_last_f32.cu's float32
    FMAs) on conv_hr-like activations (a leaky ReLU of seeded normals),
    against its plain version frame by frame (the plain version's
    float32 copy of a whole batch would not fit beside it), timed beside
    cuDNN's F.conv2d and its bound (the conv's operations at the rate of
    the type it computes in: bf16 on the tensor cores, float32 on the
    CUDA cores)."""
    import torch
    import torch.nn.functional as F

    from reve_tpu_torch.kernels import head

    dev = torch.device("cuda", 0)
    p = params["conv_last"]
    results = {}
    for name in ("bfloat16", "float32"):
        dt = getattr(torch, name)
        B, oh, ow = batches[name], H * SCALE, W * SCALE
        gen = torch.Generator(device=dev).manual_seed(7)
        h = torch.randn((B, oh, ow, 64), device=dev, generator=gen,
                        dtype=dt).mul_(0.3)
        F.leaky_relu_(h, 0.2)
        w = p["w"].to(dt).contiguous()
        got = head.conv_last_u8(h, w, p["b"])
        torch.cuda.synchronize()
        err, n_diff = 0, 0
        for i in range(B):
            want = head.conv_last_u8_plain(h[i:i + 1], w, p["b"])
            d = (got[i:i + 1].int() - want.int()).abs()
            err, n_diff = max(err, d.max().item()), n_diff + int(
                (d > 0).sum().item())
            del want, d
        clipped = ((got == 0) | (got == 255)).float().mean().item()
        if err > 1:
            raise AssertionError(f"conv_last_u8 {name}: kernel disagrees "
                                 f"with its plain version (max |d| {err})")
        del got
        torch.cuda.empty_cache()
        bpe = torch.finfo(dt).bits // 8
        px = B * oh * ow
        bms, bby = bound_ms(px * (64 * bpe + 3) + w.numel() * bpe + 12,
                            2 * 9 * 64 * 3 * px, name)
        results[name] = {
            "max_abs_err": err, "n_diff": n_diff, "clipped_share": clipped,
            "ms": cuda_time_ms(lambda: head.conv_last_u8(h, w, p["b"]),
                               iters=3),
            "plain_ms": cuda_time_ms(lambda: [head.conv_last_u8_plain(
                h[i:i + 1], w, p["b"]) for i in range(B)], iters=1),
            "library_ms": library_time_ms(library_conv(h, 64, w, p["b"]),
                                          iters=3),
            "bound_ms": bms, "bound_by": bby, "shape": [B, oh, ow, 3]}
        del h
        torch.cuda.empty_cache()
    return results


def strips_plain(fn, x, i: int, rows: int = 540):
    """fn's plain version on frame i of x, a strip of `rows` output rows
    at a time, each read with a row of context on either side (the 3x3
    conv's SAME padding falls only at the frame's own edges): yields (r,
    the strip's rows of the result).  A whole frame's float32
    temporaries would not fit beside the batch."""
    h = x.shape[1]
    for r in range(0, h, rows):
        lo, hi = max(r - 1, 0), min(r + rows + 1, h)
        yield r, fn(x[i:i + 1, lo:hi])[:, r - lo:r - lo + min(rows, h - r)]


def rrdb_k1_phase(params, batches: dict) -> dict:
    """K1 at the RRDB head's shapes, alpha 0.2 (dense.SLOPE): conv_up1's
    at 2x and conv_up2's / conv_hr's at 4x (4 frames of 7680 x 4320 x 64
    are 8.5e9 values, past 2^32), in bfloat16 at the batch of 4 and in
    float32 at the float32 plan's chunk (`batches["float32"]` frames),
    with the model's weights (conv_up1's; conv_hr's at 4x) on conv_up-like
    activations (a leaky ReLU of seeded normals).  Every frame is held
    against the plain version in strips of rows (strips_plain):
    bfloat16 within 2 ulp (bf16_ulp_ok), float32 max |d| <= 2e-6.  Timed
    beside the plain version (its strips), cuDNN's F.conv2d (conv + bias
    in channels-last, the same dtype, TF32 off) and the bound (bytes: the
    input read and the output written once; operations: float32's six
    bf16 products at the bf16 rate)."""
    import torch
    import torch.nn.functional as F

    from reve_tpu_torch import device as device_mod
    from reve_tpu_torch.kernels import conv3x3
    from reve_tpu_torch.kernels import rrdb as k7

    dev = torch.device("cuda", 0)
    slope = torch.full((64,), k7.SLOPE, device=dev)
    results = {}
    for name in ("bfloat16", "float32"):
        dt = getattr(torch, name)
        bpe = torch.finfo(dt).bits // 8
        device_mod.strict_f32()
        for shape_name, r, p in (("up1", 2, params["conv_up1"]),
                                 ("up2_hr", 4, params["conv_hr"])):
            B, oh, ow = batches[name], H * r, W * r
            gen = torch.Generator(device=dev).manual_seed(11 + r)
            x = torch.randn((B, oh, ow, 64), device=dev, generator=gen,
                            dtype=dt).mul_(0.3)
            F.leaky_relu_(x, 0.2)
            w, b = p["w"].to(dt).contiguous(), p["b"]

            def kernel():
                return conv3x3.conv3x3_bias_prelu(x, w, b, slope)

            def plain(t):
                return conv3x3.conv3x3_bias_prelu_plain(t, w, b, slope)

            y = kernel()
            torch.cuda.synchronize()
            err = 0.0
            for i in range(B):
                for row, want in strips_plain(plain, x, i):
                    got = y[i:i + 1, row:row + want.shape[1]]
                    err = max(err, (got.float() - want.float()).abs()
                              .max().item())
                    ok = err <= 2e-6 if name == "float32" else \
                        bf16_ulp_ok(got, want)
                    if not ok:
                        raise AssertionError(
                            f"conv3x3_bias_prelu {name} at {[B, oh, ow, 64]}"
                            f", frame {i} rows {row}+: kernel disagrees "
                            f"with its plain version (max |d| {err})")
                    del got, want
            del y
            torch.cuda.empty_cache()
            px = B * oh * ow
            bms, bby = bound_ms(2 * px * 64 * bpe + w.numel() * bpe + 2 * 64
                                * 4, 2 * 9 * 64 * 64 * px
                                * (6 if name == "float32" else 1),
                                "bfloat16")
            results.setdefault(shape_name, {})[name] = {
                "max_abs_err": err, "ms": cuda_time_ms(kernel, iters=3),
                "plain_ms": cuda_time_ms(lambda: [
                    None for i in range(B)
                    for _ in strips_plain(plain, x, i)], iters=1),
                "library_ms": library_time_ms(library_conv(x, 64, w, b),
                                              iters=3),
                "bound_ms": bms, "bound_by": bby, "shape": [B, oh, ow, 64]}
            del x
            torch.cuda.empty_cache()
    return results


def upsample_ms() -> dict:
    """The nearest x2 before conv_up1 and conv_up2 (a torch op, one copy)
    at the bfloat16 batch's two shapes, beside its byte bound (read once,
    write four times the bytes)."""
    import torch

    from reve_tpu_torch.ops.resize import upsample_nearest

    out = {}
    for name, (h, w) in (("up1", (H, W)), ("up2", (2 * H, 2 * W))):
        x = torch.zeros((BATCH, h, w, 64), dtype=torch.bfloat16,
                        device="cuda")
        bms, _ = bound_ms(x.numel() * 2 * 5, 0, "bfloat16")
        out[name] = {"ms": cuda_time_ms(lambda: upsample_nearest(x, 2),
                                        iters=3),
                     "bound_ms": bms, "shape": [BATCH, h, w, 64]}
        del x
        torch.cuda.empty_cache()
    return out


def run_pieces(eng, x) -> None:
    """The engine's model calls over the device batch x, each piece's
    output dropped before the next piece runs, as the engine's own loop
    does (a chunked plan frees the chunk's segments in between)."""
    for piece in eng._pieces(x):
        del piece


def rrdb_engine_checks(frames, ref_f32: np.ndarray, model: str = RRDB_MODEL,
                       scale: int = SCALE) -> dict:
    """The RRDB engines on the card, with PyTorch's default allocator: a
    float32 batch through the plan's chunks, twice (the second
    byte-identical to the first: the chunks find their memory again),
    every frame against the plain float32 path (`ref_f32`, u8 |d| <= 1);
    the model's ms per batch and the plan in both dtypes; one call's peak
    device memory, held to what the plan bills for it; the most the
    allocator reserved beside the free memory the plan saw."""
    import torch

    from reve_tpu_torch import kernels
    from reve_tpu_torch.pipeline.engine import UpscaleEngine

    dev_in = torch.from_numpy(frames).cuda()
    out = {}
    for dt in ("bfloat16", "float32"):
        eng = UpscaleEngine(model=model, scale=scale, compute_dtype=dt,
                            batch_size=BATCH, allow_random_init=True)
        torch.cuda.reset_peak_memory_stats()
        reserved0 = torch.cuda.memory_reserved()
        free_seen = eng._free_bytes()
        plan = eng._plan_execution(H, W)
        calls = eng.stats.calls
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        got = eng.submit(frames).result()
        batch_s = time.perf_counter() - t0
        ran = eng.stats.calls - calls
        launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                    if v != before[k]}
        if plan.tile or ran != -(-BATCH // plan.per_call):
            raise AssertionError(f"{dt} batch ran {ran} calls; plan {plan}")
        splits = launches.get("split_bf16x3", 0)
        if splits != (RRDB_F32_SPLITS_PER_CALL * ran if dt == "float32"
                      else 0):
            raise AssertionError(f"{dt} batch: {splits} split passes in "
                                 f"{ran} calls; the trunk runs none")
        rec = {"plan": list(plan), "calls_per_batch": ran,
               "engine_batch_s": batch_s, "launches": launches}
        if dt == "float32":
            d = np.abs(got.astype(np.int16) - ref_f32.astype(np.int16))
            rec.update(max_abs_err=int(d.max()), n_diff=int((d > 0).sum()),
                       frames_checked=len(got))
            if d.max() > 1:
                bad = np.nonzero(d.max((1, 2, 3)) > 1)[0].tolist()
                raise AssertionError(f"float32 engine differs from the "
                                     f"plain float32 path by {d.max()} "
                                     f"(frames {bad})")
            again = eng.submit(frames).result()
            if not np.array_equal(again, got):
                raise AssertionError("float32 engine: a second batch "
                                     "differs from the first")
            del again
        rec.update(free_bytes_at_plan=free_seen,
                   max_reserved_bytes=torch.cuda.max_memory_reserved()
                   - reserved0)
        del got
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with eng._on_device():
            y = eng._forward(dev_in[:plan.per_call])
        torch.cuda.synchronize()
        del y
        rec["peak_bytes_per_call"] = torch.cuda.max_memory_allocated() - base
        rec["billed_bytes_per_call"] = plan.per_call * eng._frame_bytes(H, W)
        if rec["peak_bytes_per_call"] > rec["billed_bytes_per_call"]:
            raise AssertionError(f"{dt}: a call peaked at "
                                 f"{rec['peak_bytes_per_call']} B, past the "
                                 f"plan's {rec['billed_bytes_per_call']} B")
        rec["model_ms_per_batch"] = cuda_time_ms(
            lambda: run_pieces(eng, dev_in), iters=2)
        out[dt] = rec
        del eng
        torch.cuda.empty_cache()
    return out


#: the rrdb_x2 phase's model: RRDBNet x2 (its input pixel-unshuffled by
#: 2, conv_first on K3 at Cin 12), 1080p -> 2160p
X2_MODEL, X2_SCALE = "realesrgan-x2plus", 2


def k3x2_phase(params, frames) -> dict:
    """K3 at Cin 12 (conv3x3_u8x2_bias: RRDB x2's conv_first over the
    2x2-unshuffled frames, read in place) at the main path's shape (a
    batch of 4 1080p frames -> a 4 x 540 x 960 trunk), with the model's
    conv_first weights, in both dtypes: against its plain version
    (bfloat16 <= 2 ulp, float32 max |d| <= 1e-4 as K3's), then timed
    beside the plain version, cuDNN's F.conv2d of the same conv on the
    unshuffled input (channels-last, the same dtype, TF32 off; the port
    never calls it) and the bound (bytes: the u8 in, the 64 channels out;
    operations: K = 108, float32 as six bf16 products at the bf16
    rate)."""
    import torch
    import torch.nn.functional as F

    from reve_tpu_torch import device as device_mod
    from reve_tpu_torch.kernels import conv3x3
    from reve_tpu_torch.ops.pixel_shuffle import pixel_unshuffle

    dev = torch.device("cuda", 0)
    u8 = torch.from_numpy(frames).to(dev)
    B = u8.shape[0]
    px = B * (H // 2) * (W // 2)
    cf = params["conv_first"]
    results = {}
    for name in ("bfloat16", "float32"):
        dt = getattr(torch, name)
        bpe = torch.finfo(dt).bits // 8
        device_mod.strict_f32()
        w = cf["w"].to(dt).contiguous()
        got = conv3x3.conv3x3_u8x2_bias(u8, w, cf["b"])
        want = conv3x3.conv3x3_u8x2_bias_plain(u8, w, cf["b"])
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = err <= 1e-4 if name == "float32" else bf16_ulp_ok(got, want)
        if not ok:
            raise AssertionError(f"conv3x3_u8x2_bias {name} at "
                                 f"{list(got.shape)}: kernel disagrees "
                                 f"with its plain version (max |d| {err})")
        shape = list(got.shape)
        del got, want
        lib_in = pixel_unshuffle(conv3x3.u8_to_dtype_plain(u8, dt), 2) \
            .permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
        lib_w = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib_b = cf["b"].to(dt)
        bms, bby = bound_ms(
            u8.numel() + px * 64 * bpe + w.numel() * bpe + 2 * 64 * 4,
            2 * 9 * 12 * 64 * px * (6 if name == "float32" else 1),
            "bfloat16")
        results[name] = {
            "max_abs_err": err, "shape": shape,
            "ms": cuda_time_ms(lambda: conv3x3.conv3x3_u8x2_bias(
                u8, w, cf["b"])),
            "plain_ms": cuda_time_ms(lambda: conv3x3.conv3x3_u8x2_bias_plain(
                u8, w, cf["b"])),
            "library_ms": library_time_ms(
                lambda: F.conv2d(lib_in, lib_w, lib_b, padding=1)),
            "bound_ms": bms, "bound_by": bby}
        del lib_in
        torch.cuda.empty_cache()
    return results


def x2_wgmma(by_kernel: dict) -> dict:
    """HGMMA of K3 at Cin 12's two kernels (conv3x3.cu's template at
    R = 2, C = 64: 7 k16 steps a row in bfloat16, 6 x 7 in float32), by
    kernel_label; fails below those."""
    got = {kernel_label(k): o.get("HGMMA", 0) for k, o in by_kernel.items()
           if kernel_label(k).endswith(", 2, 64>")}
    if len(got) != 2 or sorted(got.values()) < [7, 42]:
        raise AssertionError(f"K3 at Cin 12's kernels: {got}, expected two "
                             f"with 7 and 42 HGMMA")
    return got


def write_ncnn(path: str, cfg, params, fp16: bool) -> str:
    """The SRVGG params as an ncnn .param/.bin pair at `path` (+ .param,
    .bin), realesrgan-ncnn-vulkan's layout (fp16 or fp32 weight tags, the
    biases and PReLU slopes raw float32); returns the .param's path."""
    import struct

    layers, blobs, parts = [], ["data"], []
    layers.append("Input            input    0 1 data")

    def conv(i, w, b):
        o, cin = w.shape[-1], w.shape[2]
        inb, outb = blobs[-1], f"conv{i}_out"
        blobs.append(outb)
        layers.append(f"Convolution      conv{i}   1 1 {inb} {outb} 0={o} "
                      f"1=3 11=3 2=1 3=1 4=1 5=1 6={o * cin * 9}")
        oihw = np.transpose(w.cpu().numpy(), (3, 2, 0, 1))
        if fp16:
            data = oihw.astype("<f2").tobytes()
            parts.extend([struct.pack("<I", 0x01306B47), data,
                          b"\0" * (-len(data) % 4)])
        else:
            parts.extend([struct.pack("<I", 0),
                          oihw.astype("<f4").tobytes()])
        parts.append(b.cpu().numpy().astype("<f4").tobytes())

    def prelu(i, alpha):
        inb, outb = blobs[-1], f"prelu{i}_out"
        blobs.append(outb)
        layers.append(f"PReLU            prelu{i}  1 1 {inb} {outb} "
                      f"0={alpha.numel()}")
        parts.append(alpha.cpu().numpy().astype("<f4").tobytes())

    convs, prelus = params["convs"], params["prelus"]
    for i in range(cfg.num_conv + 1):
        conv(i, convs[i]["w"], convs[i]["b"])
        prelu(i, prelus[i]["alpha"])
    conv(len(convs) - 1, convs[-1]["w"], convs[-1]["b"])
    layers.append(f"PixelShuffle     shuf     1 1 {blobs[-1]} shuf_out "
                  f"0={cfg.upscale}")
    layers.append(f"Interp           up       1 1 data up_out 0=1 "
                  f"1={cfg.upscale}.0 2={cfg.upscale}.0")
    layers.append("BinaryOp         add      2 1 shuf_out up_out out 0=0")
    with open(path + ".param", "w") as f:
        f.write("\n".join(["7767517", f"{len(layers)} {len(blobs) + 3}"]
                          + layers))
    with open(path + ".bin", "wb") as f:
        f.write(b"".join(parts))
    return path + ".param"


def encode_y4m(path: str, frames: np.ndarray) -> bytes:
    """frames through the y4m writer the jobs use; the file's bytes."""
    from reve_tpu_torch.io import writer

    n, h, w, _ = frames.shape
    with writer.open_writer(path, w, h, fractions.Fraction(24),
                            backend="y4m") as wr:
        for f in frames:
            wr.write(f)
    with open(path, "rb") as f:
        return f.read()


def file_n_diff(a: str, b) -> int:
    """Bytes that differ between file `a` and file or bytes `b` (-1: their
    lengths differ)."""
    with open(a, "rb") as f:
        x = np.frombuffer(f.read(), np.uint8)
    if isinstance(b, str):
        with open(b, "rb") as f:
            b = f.read()
    y = np.frombuffer(b, np.uint8)
    return int((x != y).sum()) if len(x) == len(y) else -1


def scene_frames(n: int, h: int, w: int, cut: int, seed: int = 3):
    """n frames of two seeded scenes, the second from frame `cut`: a dark
    textured one and a bright one, each drifting a little a frame."""
    rs = np.random.RandomState(seed)
    scenes = [np.clip(rs.normal(m, 18, (h, w, 3)), 0, 255)
              for m in (50.0, 190.0)]
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        base = scenes[int(i >= cut)]
        out[i] = np.clip(np.roll(base, 2 * i, axis=1)
                         + rs.randint(-6, 7, (h, w, 3)), 0, 255)
    return out


def x2_phase(work: str, in4: str, frames) -> tuple:
    """Phase rrdb_x2 (see the module docstring): returns (K3 at Cin 12's
    numbers by dtype, the x2 engines' records, the bf16 job's launch
    counts)."""
    import torch

    from reve_tpu_torch import cli, kernels
    from reve_tpu_torch.io import reader
    from reve_tpu_torch.kernels import build, conv3x3
    from reve_tpu_torch.models import registry, rrdb
    from reve_tpu_torch.ops import tiling
    from reve_tpu_torch.pipeline.engine import RRDB_HALO, UpscaleEngine
    from reve_tpu_torch.weights import quantize

    # RRDB x2 (realesrgan-x2plus at full width and depth, random
    # weights from seed 0) on the same 4 frames: 1080p -> 2160p
    def x2_argv(name, dtype, *extra):
        return ["-i", in4, "-s", str(X2_SCALE),
                os.path.join(work, f"{name}.y4m"), "--model", X2_MODEL,
                "--allow-random-init", "--dtype", dtype, "--io-backend",
                "y4m", "-S", "4", "--batch", str(BATCH), "--yes",
                *extra]

    argv_x = x2_argv("out_x2", "auto")
    out_x = argv_x[4]
    x2_size = (BATCH, W * X2_SCALE, H * X2_SCALE)
    with phase("rrdb_x2", {"argv": argv_x[3:]}) as rec:
        cfg_x, params_x = registry.load_model(X2_MODEL, X2_SCALE,
                                              allow_random_init=True)
        assert (cfg_x.num_feat, cfg_x.num_grow_ch, cfg_x.num_block,
                cfg_x.upscale) == (64, 32, RRDB_BLOCKS, X2_SCALE)
        params_x = rrdb.params_to(params_x, "cuda")
        k3x2 = k3x2_phase(params_x, frames[:BATCH])
        k3x2["bfloat16"]["wgmma_by_kernel"] = x2_wgmma(
            sass_ops(conv3x3.SOURCE)["by_kernel"])
        batch4 = np.stack(list(reader.Y4MReader(in4).read_range(
            0, BATCH)))
        # the bf16 job, its counters zeroed around it
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli.run(argv_x)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"cli.run --model {X2_MODEL} exited "
                                 f"{rc}")
        rd = reader.Y4MReader(out_x)
        if (rd.frame_count(), rd.width, rd.height) != x2_size:
            raise AssertionError(f"x2 output {rd.frame_count()} x "
                                 f"{rd.width} x {rd.height}, expected "
                                 f"{x2_size}")
        calls = launches["conv3x3_u8x2_bias"]
        if calls < 1 or \
                launches["dense_conv"] != RRDB_K7_PER_CALL * calls or \
                launches["conv3x3_bias_prelu"] != 3 * calls or \
                launches["conv_last_u8"] != calls or \
                launches["conv3x3_u8_bias_prelu"] != 0:
            raise AssertionError(f"launch counts {launches} do not "
                                 f"show the RRDB x2 path's kernels")
        k9_check(launches, calls, "rrdb_x2")
        refs = {}
        for dt in ("float32", "bfloat16"):
            y = np.stack([rrdb.apply(
                params_x, torch.from_numpy(batch4[i:i + 1]).cuda(),
                cfg=cfg_x, compute_dtype=getattr(torch, dt),
                plain=True)[0].cpu().numpy() for i in range(BATCH)])
            torch.cuda.empty_cache()
            path = os.path.join(work, f"ref_x2_{dt}.y4m")
            encode_y4m(path, y)
            refs[dt] = (y, list(reader.Y4MReader(path)
                                .read_range(0, BATCH)))
        got = list(rd.read_range(0, BATCH))
        f32, b16 = refs["float32"][1], refs["bfloat16"][1]
        db = [psnr(g, r) for g, r in zip(got, f32)]
        db_plain = [psnr(a, r) for a, r in zip(b16, f32)]
        db_kernels = [psnr(g, a) for g, a in zip(got, b16)]
        for i in range(BATCH):
            if not (db[i] >= db_plain[i] - RRDB_BF16_MARGIN_DB
                    and db_kernels[i] >= RRDB_VS_PLAIN_BF16_DB):
                raise AssertionError(
                    f"x2 frame {i}: {db[i]:.2f} dB vs the plain float32 "
                    f"path (the plain bfloat16 path's "
                    f"{db_plain[i]:.2f} dB, margin "
                    f"{RRDB_BF16_MARGIN_DB}), {db_kernels[i]:.2f} dB vs "
                    f"the plain bfloat16 path (floor "
                    f"{RRDB_VS_PLAIN_BF16_DB})")
        del got, f32, b16
        engines_x = rrdb_engine_checks(batch4, refs["float32"][0],
                                       X2_MODEL, X2_SCALE)
        del refs
        # the int8 job: every frame against the plain int8 path with
        # the job's persisted calibration
        trace_x8 = os.path.join(work, "trace_x2_8.jsonl")
        argv_x8 = x2_argv("out_x2_8", "int8", "--trace", trace_x8,
                          "--keep-workspace")
        out_x8 = argv_x8[4]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli.run(argv_x8)
        wall8 = time.perf_counter() - t0
        launches8 = dict(kernels.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"cli.run --model {X2_MODEL} --dtype "
                                 f"int8 exited {rc}")
        calls8 = rrdb_int8_calls(launches8, "conv3x3_u8x2_bias")
        k9_check(launches8, calls8["int8"]
                 - calls8["float32_certification"], "rrdb_x2 int8")
        ws_x8 = out_x8 + ".revework"
        with open(os.path.join(ws_x8, "int8_calibration.json")) as f:
            maxima_x = json.load(f)["act_maxima"]
        with open(os.path.join(ws_x8, "int8_cert.json")) as f:
            cert_x = json.load(f)["db"]
        int8_ev = {}
        with open(trace_x8) as f:
            for ln in f:
                ev = json.loads(ln)
                if ev.get("ev") == "int8":
                    int8_ev = ev
        qb_x = rrdb.prepare_qbody(quantize.build_qbody(
            params_x, cfg_x, maxima_x, margin=1.25))
        ref8 = np.stack([rrdb.apply_int8(
            params_x, qb_x, torch.from_numpy(batch4[i:i + 1]).cuda(),
            cfg=cfg_x, plain=True)[0].cpu().numpy()
            for i in range(BATCH)])
        del qb_x
        torch.cuda.empty_cache()
        path = os.path.join(work, "ref_x2_8.y4m")
        encode_y4m(path, ref8)
        del ref8
        db8 = [psnr(g, r) for g, r in zip(
            reader.Y4MReader(out_x8).read_range(0, BATCH),
            reader.Y4MReader(path).read_range(0, BATCH))]
        if not min(db8) >= RRDB_INT8_FLOOR_DB:
            raise AssertionError(f"x2 int8 frames {db8} dB vs the plain "
                                 f"int8 path, below "
                                 f"{RRDB_INT8_FLOOR_DB} dB")
        engine_x8 = rrdb_int8_engine_checks(batch4, maxima_x, X2_MODEL,
                                            X2_SCALE)
        # halo tiles at x2 (even windows, 560 x 560 at tile 512): the
        # job's file equals each window run alone as a whole frame on
        # a whole-frame engine, its owned core kept
        argv_xt = x2_argv("out_x2_tile", "auto", "--tile", str(TILE))
        out_xt = argv_xt[4]
        kernels.reset_launches()
        rc = cli.run(argv_xt)
        launches_t = dict(kernels.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"cli.run --tile {TILE} at x2 exited "
                                 f"{rc}")
        whole = UpscaleEngine(model=X2_MODEL, scale=X2_SCALE,
                              compute_dtype="bfloat16", batch_size=1,
                              tile=-1, allow_random_init=True)
        from reve_tpu_torch.ops import tiling

        with whole._on_device():
            ref_t = tiling.upscale_tiled(
                whole._forward, torch.from_numpy(batch4).cuda(),
                scale=X2_SCALE, tile=TILE, halo=whole.halo,
                chunk=1).cpu().numpy()
        del whole
        torch.cuda.empty_cache()
        n_diff_t = file_n_diff(out_xt, encode_y4m(
            os.path.join(work, "ref_x2_tile.y4m"), ref_t))
        del ref_t
        windows = BATCH * tiling.plan_tiles(H, W, TILE, RRDB_HALO).num_tiles
        k9_check(launches_t, 1, "rrdb_x2 tile")
        if n_diff_t != 0 or launches_t["conv3x3_u8x2_bias"] < 1 or \
                windows <= BATCH:
            raise AssertionError(f"x2 tiles: n_diff {n_diff_t} against "
                                 f"the windows run whole, {windows} "
                                 f"windows, launches {launches_t}")
        rec.update(
            rc=rc, frames=BATCH, output=list(x2_size[1:]),
            wall_s=round(wall, 3), launches=launches, model_calls=calls,
            launches_per_call={k: launches[k] / calls for k in (
                "conv3x3_u8x2_bias", "dense_conv", "conv3x3_bias_prelu",
                "conv_last_u8")},
            psnr_db_vs_plain_f32=db,
            psnr_db_plain_bf16_vs_plain_f32=db_plain,
            psnr_db_vs_plain_bf16=db_kernels, engines=engines_x,
            int8={"wall_s": round(wall8, 3), "launches": launches8,
                  "calls": calls8, "psnr_db_vs_plain_int8": db8,
                  "psnr_floor_db": RRDB_INT8_FLOOR_DB,
                  "certified_db_vs_f32": cert_x,
                  "calibrate_s": int8_ev.get("calibrate_s"),
                  "certify_s": int8_ev.get("certify_s"),
                  "engine": engine_x8},
            tile={"tile": TILE, "windows": windows, "launches": launches_t,
                  "n_diff_vs_windows_whole": n_diff_t},
            k3x2=k3x2,
            model_ms_per_batch={
                "bfloat16": engines_x["bfloat16"]["model_ms_per_batch"],
                "float32": engines_x["float32"]["model_ms_per_batch"],
                "int8": engine_x8["model_ms_per_batch"]})
        del params_x
        torch.cuda.empty_cache()
    return k3x2, engines_x, launches


def weights_phase(work: str, frames, weights: str) -> None:
    """Phase weights (see the module docstring)."""
    import torch

    from reve_tpu_torch import cli, kernels
    from reve_tpu_torch.io import reader
    from reve_tpu_torch.pipeline.engine import UpscaleEngine
    from reve_tpu_torch.weights import interpolate, ncnn
    from reve_tpu_torch.weights.torch_loader import (load_srvgg_pth,
                                                     save_srvgg_pth)

    # ncnn .param/.bin weights (the shipped .pth written out with fp16
    # and fp32 tags) and --denoise, each a job on 2 of the frames
    in2 = os.path.join(work, "in2.y4m")
    encode_y4m(in2, frames[:2])
    # the frames as the jobs decode them from the file
    with reader.Y4MReader(in2) as rd:
        src2 = np.stack(list(rd.read_range(0, 2)))
    with phase("weights", {"frames": 2}) as rec:
        cfg_c, params_c = load_srvgg_pth(weights)

        def job(name, extra):
            out_j = os.path.join(work, f"out_{name}.y4m")
            kernels.reset_launches()
            rc = cli.run(["-i", in2, "-s", str(SCALE), out_j,
                          "--io-backend", "y4m", "-S", "4", "--batch",
                          "2", "--yes"] + extra)
            if rc != 0:
                raise AssertionError(f"{name} job exited {rc}")
            launches = dict(kernels.LAUNCHES)
            k9_check(launches, launches["head_conv_residual_u8_shuffle"],
                     f"weights {name}")
            return out_j

        def engine_file(name, cfg_e, params_e):
            eng = UpscaleEngine(compute_dtype="bfloat16", batch_size=2,
                                preloaded=(cfg_e, params_e))
            y = eng.upscale_frames(src2)
            del eng
            return encode_y4m(os.path.join(work, f"eng_{name}.y4m"), y)

        out_pth = job("pth", ["--weights", weights])
        res = {}
        for tag, fp16 in (("fp32", False), ("fp16", True)):
            par = write_ncnn(os.path.join(work, f"m_{tag}"), cfg_c,
                             params_c, fp16)
            cfg_n, params_n = ncnn.load_files(par, par[:-6] + ".bin")
            round_ = (lambda t: t.half().float()) if fp16 else \
                (lambda t: t)
            same = cfg_n == cfg_c and all(
                torch.equal(a["w"], round_(b["w"])) and
                torch.equal(a["b"], b["b"])
                for a, b in zip(params_n["convs"], params_c["convs"])) \
                and all(torch.equal(a["alpha"], b["alpha"]) for a, b in
                        zip(params_n["prelus"], params_c["prelus"]))
            if not same:
                raise AssertionError(f"ncnn {tag}: parsed params differ "
                                     f"from the .pth's")
            out_n = job(f"ncnn_{tag}", ["--weights", par])
            # fp32: the .pth job's bytes; fp16: the engine on the
            # fp16-rounded params, through the same encode
            n_diff = file_n_diff(out_n, out_pth if not fp16 else
                                 engine_file(tag, cfg_n, params_n))
            if n_diff != 0:
                raise AssertionError(f"ncnn {tag} job: n_diff {n_diff}")
            res[tag] = {"n_diff": n_diff, "params_equal": same,
                        "bin_bytes": os.path.getsize(par[:-6] + ".bin")}
        # --denoise 0.5 with a seeded perturbed twin as --weights-wdn
        rs = np.random.RandomState(5)
        twin = {"convs": [{"w": c["w"] * (1 + 0.05 * torch.from_numpy(
            rs.standard_normal(tuple(c["w"].shape)).astype(np.float32))),
            "b": c["b"]} for c in params_c["convs"]],
            "prelus": params_c["prelus"]}
        wdn = os.path.join(work, "wdn.pth")
        save_srvgg_pth(wdn, cfg_c, twin)
        out_d = job("denoise", ["--weights", weights, "--weights-wdn",
                                wdn, "--denoise", "0.5"])
        n_diff_d = file_n_diff(out_d, engine_file(
            "denoise", cfg_c, interpolate.interpolate(twin, params_c,
                                                      0.5)))
        if n_diff_d != 0 or file_n_diff(out_d, out_pth) == 0:
            raise AssertionError(f"--denoise job: n_diff {n_diff_d} "
                                 f"against the engine on interpolated "
                                 f"params (or equal to the plain job)")
        rec.update(ncnn=res, denoise={"strength": 0.5,
                                      "n_diff_vs_engine": n_diff_d})


def scenes_phase(work: str, weights: str) -> None:
    """Phase scenes (see the module docstring)."""
    from reve_tpu_torch import cli, kernels
    from reve_tpu_torch.io import reader
    from reve_tpu_torch.pipeline import scenes
    from reve_tpu_torch.pipeline.state import Workspace

    # --scene-align on a small clip of two seeded scenes
    with phase("scenes", {}) as rec:
        # a cut 2 frames past the first boundary, inside its snap
        # window of seg // 4
        n_f, cut, seg = 24, 10, 8
        in_s = os.path.join(work, "scenes.y4m")
        encode_y4m(in_s, scene_frames(n_f, 270, 480, cut))
        outs = {}
        for align in (True, False):
            out_s = os.path.join(work, f"scenes_{align}.y4m")
            kernels.reset_launches()
            rc = cli.run(["-i", in_s, "-s", str(SCALE), out_s,
                          "--io-backend", "y4m", "--weights", weights,
                          "-S", str(seg), "--batch", str(BATCH), "--yes",
                          "--keep-workspace"]
                         + (["--scene-align"] if align else []))
            if rc != 0:
                raise AssertionError(f"scene-align={align} job exited "
                                     f"{rc}")
            k9_check(kernels.LAUNCHES,
                     kernels.LAUNCHES["head_conv_residual_u8_shuffle"],
                     f"scenes align={align}")
            plan = [(sg.start, sg.size) for sg in Workspace(
                out_s + ".revework").load().plan]
            outs[align] = (out_s, plan)
        with reader.Y4MReader(in_s) as rd_s:
            cuts = scenes.detect_cuts(rd_s, n_f)
        want = [(sg.start, sg.size) for sg in
                scenes.plan_segments_aligned(n_f, seg, cuts)]
        n_diff_s = file_n_diff(outs[True][0], outs[False][0])
        if outs[True][1] != want or cuts != [cut] or \
                outs[True][1] == outs[False][1] or n_diff_s != 0:
            raise AssertionError(f"scene-align: cuts {cuts}, plan "
                                 f"{outs[True][1]} (want {want}; "
                                 f"unaligned {outs[False][1]}), n_diff "
                                 f"{n_diff_s}")
        rec.update(cuts=cuts, plan=outs[True][1],
                   plan_unaligned=outs[False][1],
                   n_diff_vs_unaligned=n_diff_s)


#: the train phase: realesr-animevideov3 x4 at its full width (64
#: features, 16 convs), LR patches of 64 x 64 in batches of 8 (the
#: defaults of reve_tpu's scripts/distill.py), HR patches of 256
TRAIN_STEPS, TRAIN_REPEAT_STEPS, TRAIN_BATCH, TRAIN_LR_PATCH = 20, 5, 8, 64
#: T1-T3 against their plain versions: max |d| <= this x max |ref|, float32
#: sums in another order: T1's and T2's over at most 1,728 taps x
#: channels, T3's over a step's 32,768 pixels (19x longer: its rounding
#: error, a random walk, grows about 4.4x)
TRAIN_KERNEL_REL = {"conv3x3_fwd_train": 1e-5, "conv3x3_dgrad": 1e-5,
                    "conv3x3_wgrad": 5e-5}
#: each fine-tune step's loss on the kernels against the plain path's
TRAIN_LOSS_RTOL = 1e-4
#: the final params of the two paths: every element within
#: TRAIN_PARAM_ATOL and the whole within TRAIN_PARAM_REL_L2 (relative
#: l2), about 15x the readings on an H100 (6.6e-8 and 5.9e-8); a zeroed or
#: sign-flipped weight gradient moves a leaf by about lr (1e-4) a step.
#: Adam moves an element by up to about 1.2 lr a step whatever the
#: gradient's size (its |m^ / sqrt(v^)| bound at b1 0.9, b2 0.999), so an
#: element whose plain-path gradient fell below 1e-6 of its leaf's
#: largest in some step (float32's noise level: the paths sum it in other
#: orders and its sign may differ) is held to 2 lr a step instead, and at
#: most TRAIN_PARAM_LOOSE of them may need it
TRAIN_PARAM_ATOL, TRAIN_PARAM_REL_L2, TRAIN_PARAM_LOOSE = 1e-6, 1e-6, 16
TRAIN_NOISE_REL = 1e-6
TRAIN_KERNELS = ("conv3x3_fwd_train", "conv3x3_dgrad", "conv3x3_wgrad")
#: the route each runs its products on, whose rate its bound_ms takes:
#: six bf16 products on wgmma (989 TF/s) or float32 FMAs (67 TF/s)
TRAIN_ROUTE = {"conv3x3_fwd_train": "bf16x6", "conv3x3_dgrad": "bf16x6",
               "conv3x3_wgrad": "bf16x6"}
FAST_MODEL = "realesr-animevideov3-fast"
#: random-init students of the training kernels' other widths (128:
#: reve_tpu_torch/scripts/distill.py's default --student-feat) at the
#: shipped x4 teacher's 16 convs, drawn from seed 0; steps on the kernels
#: and again on the plain versions
WIDE_FEATS, WIDE_STEPS = (32, 96, 128), 5
#: steps of the x3 fine-tune (a seeded 64 x 16 model)
X3_STEPS = 5
#: scripts/distill.py's default teacher, given seeded x2 weights, and the
#: steps its defaults run here
DEFAULT_TEACHER, DEFAULT_STEPS = "realesr-animevideov3-x2", 5


def train_launches(cfg, steps: int, teacher_convs: int = 0) -> dict:
    """T1, T2 and T3 launches of `steps` steps of an SRVGG of cfg's
    depth, with (distillation) a teacher of `teacher_convs` convs whose
    forward runs T1 alone."""
    n = cfg.num_conv + 2
    return {"conv3x3_fwd_train": steps * (n + teacher_convs),
            "conv3x3_dgrad": steps * (n - 1), "conv3x3_wgrad": steps * n}


def train_kernel_phase(per_step: dict) -> dict:
    """T1, T2 and T3 at every channel pair they take (train.PAIRS), on a
    step's shapes (8 LR patches of 64 x 64) with seeded inputs
    (perf_train_kernels.inputs; the heads, Cout 12, 27 and 48, with no
    PReLU): each against its plain version (max |d| / max |ref|), timed
    beside it, cuDNN's call of the same function (TF32 off: F.conv2d, and
    aten.convolution_backward for the input and the weight gradients) and
    the card's bound.  The numbers at the top of each kernel's entry are
    the hidden conv's (64 -> 64, 16 of a step's 18 convs); `step_ms` and
    `step_bound_ms` sum a step's launches (`per_step`: first 3 -> 64, 16
    x 64 -> 64, head 64 -> 48) at their pairs' times and bounds.
    `bound_ms_bf16x6` is the operations as six bf16 products on the
    tensor cores (the card's best float32-accurate rate),
    `bound_ms_fma_f32` as float32 FMAs on the CUDA cores, and `bound_ms`
    (with `bound_by`) the one of the kernel's own route, TRAIN_ROUTE."""
    import torch
    import torch.nn.functional as F

    from reve_tpu_torch import device as device_mod
    from reve_tpu_torch.kernels import train
    from reve_tpu_torch.scripts import perf_train_kernels as ptk

    device_mod.strict_f32()
    dev = torch.device("cuda", 0)
    B, H, W = ptk.SHAPE
    npix = B * H * W
    res = {k: {"pairs": {}} for k in TRAIN_KERNELS}
    bad = []
    for cin, cout in train.PAIRS:
        d = ptk.inputs(cin, cout, dev)
        x, w, b, a, dz = (d[k] for k in ("x", "w", "b", "alpha", "dz"))
        zp, ap = d["z_prev"], d["alpha_prev"]
        xl = x.permute(0, 3, 1, 2)  # channels-last views for cuDNN
        dzl = dz.permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def lib_bwd(mask):
            return lambda: torch.ops.aten.convolution_backward(
                dzl, xl, wl, [cout], [1, 1], [1, 1], [1, 1], False,
                [0, 0], 1, mask)

        f4 = 4
        weights = 9 * cin * cout * f4
        macs = 9 * cin * cout * npix
        fns = ptk.launchers(d)
        cases = {
            # a head as the model runs it: no PReLU, no z
            "conv3x3_fwd_train": (
                lambda: train.conv3x3_fwd_train_plain(x, w, b, a),
                lambda: F.conv2d(xl, wl, b, padding=1),
                npix * cin * f4 + weights + 2 * cout * f4
                + npix * cout * f4 * (1 if a is None else 2),
                2 * macs),
            "conv3x3_dgrad": (
                lambda: train.conv3x3_dgrad_plain(dz, w, zp, ap),
                lib_bwd([True, False, False]),
                npix * cout * f4 + weights + 2 * npix * cin * f4
                + 2 * cin * f4, 2 * macs),
            "conv3x3_wgrad": (
                lambda: train.conv3x3_wgrad_plain(x, dz),
                lib_bwd([False, True, True]),
                npix * (cin + cout) * f4 + weights + cout * f4,
                2 * macs + npix * cout),
        }
        for name, (plain, lib, nbytes, flops) in cases.items():
            fn = fns[name]
            got = [v for v in fn() if v is not None]
            want = [v for v in plain() if v is not None]
            err = max(float((g - r).abs().max())
                      for g, r in zip(got, want))
            ref = max(float(r.abs().max()) for r in want)
            if not err <= TRAIN_KERNEL_REL[name] * ref:
                bad.append(f"{name} {cin} -> {cout}: max |d| {err} > "
                           f"{TRAIN_KERNEL_REL[name]} x max |ref| "
                           f"{ref}")
            bounds = {"bf16x6": bound_ms(nbytes, 6 * flops, "bfloat16"),
                      "fma_f32": bound_ms(nbytes, flops, "float32")}
            bms, by = bounds[TRAIN_ROUTE[name]]
            res[name]["pairs"][f"{cin}x{cout}"] = {
                "max_abs_err": err, "max_rel_err": err / ref,
                "ms": queued_time_ms(fn, 20),
                "plain_ms": queued_time_ms(plain, 20),
                "library_ms": library_time_ms(lib, 20, queued_time_ms),
                "bound_ms": bms, "bound_by": by,
                **{f"bound_ms_{k}": v[0] for k, v in bounds.items()},
                "shape": [B, H, W, cin, cout]}
        del d, fns, cases, x, w, b, a, dz, zp, ap, xl, dzl, wl
    if bad:
        raise AssertionError("; ".join(bad))
    for name, r in res.items():
        p = r["pairs"]
        r.update(p["64x64"])
        steps = {"conv3x3_dgrad": {"64x64": 16, "64x48": 1}}.get(
            name, {"3x64": 1, "64x64": 16, "64x48": 1})
        assert sum(steps.values()) == per_step[name]
        r["launches_per_step"] = per_step[name]
        r["step_ms"] = sum(n * p[k]["ms"] for k, n in steps.items())
        for key in ("bound_ms", "bound_ms_bf16x6", "bound_ms_fma_f32"):
            r["step_" + key] = sum(n * p[k][key] for k, n in steps.items())
        r["step_library_ms"] = sum(n * p[k]["library_ms"]
                                   for k, n in steps.items()) \
            if all(p[k]["library_ms"] for k in steps) else None
    return res


def train_batches(path: str, scale: int = SCALE,
                  n: int = TRAIN_STEPS) -> list:
    """n (lr, hr) batches of train.data.batches_from_video over the y4m at
    `path` (every frame; HR patches of 64 x scale, LR 64, batches of 8),
    the seed stepped each time the clip runs out of patches."""
    from reve_tpu_torch.train import data

    out = []
    seed = 0
    while len(out) < n:
        dc = data.DataConfig(scale=scale, patch=TRAIN_LR_PATCH * scale,
                             batch=TRAIN_BATCH, seed=seed)
        out += list(data.batches_from_video(path, dc, frame_stride=1))
        seed += 1
    return out[:n]


def run_steps(tr, batches) -> tuple:
    """Each batch one Trainer step (which ends in its loss's read);
    (losses, the median step's seconds).  The median leaves out the first
    step's one-time costs (the first launch of each op, the allocator)."""
    import torch

    torch.cuda.synchronize()
    losses, secs = [], []
    for lr, hr in batches:
        t0 = time.perf_counter()
        losses.append(tr.step(lr, hr))
        secs.append(time.perf_counter() - t0)
    return losses, float(np.median(secs))


def noisy_gradients(tr, batches) -> list:
    """Per leaf of `tr.params`, the elements whose gradient falls below
    TRAIN_NOISE_REL of the leaf's largest in some step of `batches`, read
    before each of those steps is taken on `tr`."""
    import torch

    from reve_tpu_torch.train import trainer

    masks = [torch.zeros_like(p, dtype=torch.bool)
             for p in trainer.leaves(tr.params)]
    for lr, hr in batches:
        loss = trainer.loss_fn(tr.params, tr.to_device(lr),
                               tr.to_device(hr), cfg=tr.cfg,
                               loss=tr.tc.loss, plain=tr.plain)
        grads = torch.autograd.grad(loss, trainer.leaves(tr.params))
        for m, g in zip(masks, grads):
            m |= g.abs() < TRAIN_NOISE_REL * g.abs().max()
        tr.step(lr, hr)
    return masks


def finetune_checks(cfg, params, batches, tc) -> tuple:
    """Fine-tune steps of an SRVGG (cfg, params) over `batches` on the
    kernels, the launch counts zeroed just before and read just after;
    the same steps on the plain versions, each loss within
    TRAIN_LOSS_RTOL; the final params within the TRAIN_PARAM_* bounds;
    the first TRAIN_REPEAT_STEPS twice more on the kernels, bit for bit.
    Returns (the record, the launches)."""
    import torch

    from reve_tpu_torch import kernels
    from reve_tpu_torch.train import trainer

    steps = len(batches)
    tr = trainer.Trainer(cfg, tc, params=params, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    losses, step_s = run_steps(tr, batches)
    launches = dict(kernels.LAUNCHES)
    want = train_launches(cfg, steps)
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"fine-tune x{cfg.upscale} launches "
                             f"{launches}, expected {want}")
    # the same steps on the plain versions, on the card
    trp = trainer.Trainer(cfg, tc, params=params, device="cuda", plain=True)
    losses_p, step_s_p = run_steps(trp, batches)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, losses_p)]
    if not (all(np.isfinite(losses)) and max(rel) <= TRAIN_LOSS_RTOL):
        raise AssertionError(f"fine-tune x{cfg.upscale} losses {losses} "
                             f"against the plain path's {losses_p}: "
                             f"relative {max(rel)} > {TRAIN_LOSS_RTOL}")
    d = [(a - b).detach().abs() for a, b in zip(trainer.leaves(tr.params),
                                                trainer.leaves(trp.params))]
    # the plain path again, reading which elements' gradients sit at
    # float32's noise level
    noisy = noisy_gradients(trainer.Trainer(
        cfg, tc, params=params, device="cuda", plain=True), batches)
    p_max = max(float(x.max()) for x in d)
    p_max_held = max(float(torch.where(m, 0.0, x).max())
                     for x, m in zip(d, noisy))
    loose = sum(int((x > TRAIN_PARAM_ATOL).sum()) for x in d)
    loose_bound = 2 * tc.learning_rate * steps
    p_rel = float(torch.sqrt(sum((x * x).sum() for x in d)) / torch.sqrt(
        sum((p.detach() ** 2).sum() for p in trainer.leaves(trp.params))))
    if not (p_max_held <= TRAIN_PARAM_ATOL and loose <= TRAIN_PARAM_LOOSE
            and p_max <= loose_bound and p_rel <= TRAIN_PARAM_REL_L2):
        raise AssertionError(
            f"fine-tune x{cfg.upscale} params against the plain path's: "
            f"max |d| {p_max_held} over elements with a gradient above "
            f"noise (bound {TRAIN_PARAM_ATOL}), {loose} elements beyond it "
            f"(at most {TRAIN_PARAM_LOOSE}), max |d| {p_max} (bound "
            f"{loose_bound}), relative l2 {p_rel} (bound "
            f"{TRAIN_PARAM_REL_L2})")
    n_noisy = sum(int(m.sum()) for m in noisy)
    del noisy
    # the first steps twice on the kernels: bit for bit
    reps = []
    for _ in range(2):
        t = trainer.Trainer(cfg, tc, params=params, device="cuda")
        reps.append((run_steps(t, batches[:TRAIN_REPEAT_STEPS])[0],
                     trainer.leaves(t.params)))
    same = reps[0][0] == reps[1][0] == losses[:TRAIN_REPEAT_STEPS] and \
        all(torch.equal(a, b) for a, b in zip(reps[0][1], reps[1][1]))
    if not same:
        raise AssertionError(f"{TRAIN_REPEAT_STEPS} x{cfg.upscale} steps "
                             f"twice: losses {reps[0][0]} and {reps[1][0]} "
                             f"(the {steps}-step run's "
                             f"{losses[:TRAIN_REPEAT_STEPS]})")
    rec = {"num_feat": cfg.num_feat, "num_conv": cfg.num_conv,
           "scale": cfg.upscale, "steps": steps, "launches": launches,
           "losses": losses, "losses_plain": losses_p,
           "max_loss_rel_diff": max(rel), "loss_rtol": TRAIN_LOSS_RTOL,
           "params_max_abs_diff": p_max,
           "params_max_abs_diff_above_noise": p_max_held,
           "params_atol": TRAIN_PARAM_ATOL,
           "params_beyond_atol": loose,
           "params_beyond_atol_max": TRAIN_PARAM_LOOSE,
           "params_noisy_gradient": n_noisy,
           "params_rel_l2_diff": p_rel,
           "params_rel_l2_bound": TRAIN_PARAM_REL_L2,
           "repeat_identical": same,
           "ms_per_step": 1e3 * step_s,
           "plain_ms_per_step": 1e3 * step_s_p,
           "lr_patches_per_s": TRAIN_BATCH / step_s}
    return rec, launches


def default_distill_checks(work: str, inp: str) -> dict:
    """reve_tpu's distillation defaults end to end:
    scripts.distill.main with no flag changed but --teacher-weights (a
    seeded random-init 64 x 16 x2 teacher: no x2 .pth ships), --steps,
    --data (the smoke's y4m) and --out: the x2 teacher, a 128-feature,
    16-conv student, batch 8, patch 64, on T1-T3 with the launches
    train_launches predicts (and the two forwards of its closing
    agreement), finite losses, the .pth loaded back through the registry
    equal to the exported params; the same steps through Distiller on the
    plain versions, each loss within TRAIN_LOSS_RTOL."""
    import torch

    from reve_tpu_torch import kernels
    from reve_tpu_torch.models import registry, srvgg
    from reve_tpu_torch.scripts import distill as script
    from reve_tpu_torch.train import distill, trainer
    from reve_tpu_torch.weights.torch_loader import save_srvgg_pth

    tcfg = srvgg.SRVGGConfig(num_feat=64, num_conv=16, upscale=2)
    teacher = os.path.join(work, f"{DEFAULT_TEACHER}.pth")
    save_srvgg_pth(teacher, tcfg, srvgg.init_params(
        tcfg, torch.Generator().manual_seed(2)))
    student = os.path.join(work, "default-student.pth")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = script.main(["--teacher-weights", teacher, "--steps",
                       str(DEFAULT_STEPS), "--data", inp, "--out", student])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    dist = res["distiller"]
    scfg = dist.trainer.cfg
    if (scfg.num_feat, scfg.num_conv, scfg.upscale) != (128, 16, 2):
        raise AssertionError(f"the script's default student is {scfg}")
    want = train_launches(scfg, DEFAULT_STEPS, tcfg.num_conv + 2)
    # agreement_psnr: the teacher's forward and the student's
    want["conv3x3_fwd_train"] += tcfg.num_conv + 2 + scfg.num_conv + 2
    hist = res["history"]
    if len(hist) != DEFAULT_STEPS or not all(np.isfinite(hist)) or any(
            launches[k] != n for k, n in want.items()):
        raise AssertionError(f"default distillation: losses {hist}, "
                             f"launches {launches} (expected {want})")
    exported = trainer.params_on(dist.trainer.export_params(), "cpu", False)
    cfg_l, params_l = registry.load_model(DEFAULT_TEACHER, 2,
                                          weights=student)
    if cfg_l != scfg or not all(torch.equal(a, b) for a, b in zip(
            trainer.leaves(params_l), trainer.leaves(exported))):
        raise AssertionError("the default student's .pth did not load back "
                             "to its params")
    # the same steps on the plain versions: the script's student init
    # (seed 0), learning rate and batches
    _, tparams = registry.load_model(DEFAULT_TEACHER, 2, weights=teacher)
    dp = distill.Distiller(tcfg, tparams, scfg, tc=trainer.TrainConfig(
        learning_rate=2e-4), device="cuda")
    dp.trainer.plain = True
    batches = [next(b) for b in [script.video_batches(inp, 8, 64, 2)]
               for _ in range(DEFAULT_STEPS)]

    def steps(d):
        """Each batch one step of Distiller `d`: (losses, median ms)."""
        losses, secs = [], []
        torch.cuda.synchronize()
        for lr, _ in batches:
            t0 = time.perf_counter()
            losses.append(d.step(lr))
            secs.append(time.perf_counter() - t0)
        return losses, 1e3 * float(np.median(secs))

    hist_p, ms_p = steps(dp)
    rel = [abs(a - b) / abs(b) for a, b in zip(hist, hist_p)]
    if max(rel) > TRAIN_LOSS_RTOL:
        raise AssertionError(f"default distillation losses {hist} against "
                             f"the plain path's {hist_p}: relative "
                             f"{max(rel)} > {TRAIN_LOSS_RTOL}")
    # the step's time on the kernels: the same batches again on the
    # script's distiller
    ms = steps(dist)[1]
    return {"teacher": [tcfg.num_feat, tcfg.num_conv, tcfg.upscale],
            "student": [scfg.num_feat, scfg.num_conv, scfg.upscale],
            "steps": DEFAULT_STEPS, "launches": launches,
            "launches_expected": want, "losses": hist,
            "losses_plain": hist_p, "max_loss_rel_diff": max(rel),
            "agreement_db": res["agreement_db"], "wall_s": wall,
            "ms_per_step": ms, "plain_ms_per_step": ms_p}


def train_phase(work: str, inp: str, frames, weights: str) -> tuple:
    """Phase train (see the module docstring).  Returns T1-T3's results,
    the fine-tune's launch counts and the wide students ({feat: (cfg,
    params)}, params on the CPU)."""
    import torch

    from reve_tpu_torch import kernels
    from reve_tpu_torch.models import registry, srvgg
    from reve_tpu_torch.pipeline.engine import UpscaleEngine
    from reve_tpu_torch.train import distill, trainer
    from reve_tpu_torch.weights.torch_loader import (load_srvgg_pth,
                                                     save_srvgg_pth)

    with phase("train", {"batch": TRAIN_BATCH, "lr_patch": TRAIN_LR_PATCH,
                         "steps": TRAIN_STEPS}) as rec:
        cfg, params = load_srvgg_pth(weights)
        per_step = train_launches(cfg, 1)
        results = train_kernel_phase(per_step)
        batches = train_batches(inp)
        tc = trainer.TrainConfig()
        # fine-tune: the shipped x4 model, 20 steps on the kernels
        finetune, launches = finetune_checks(cfg, params, batches, tc)
        # fine-tune at x3 (the head's 27 outputs): a seeded 64 x 16 model
        # (no x3 .pth ships)
        cfg3 = srvgg.SRVGGConfig(num_feat=64, num_conv=16, upscale=3)
        finetune_x3, _ = finetune_checks(
            cfg3, srvgg.init_params(cfg3, torch.Generator().manual_seed(3)),
            train_batches(inp, 3, X3_STEPS), tc)
        # distillation: teacher x4 (16 convs) into realesr-animevideov3-
        # fast's shape (64 features, 8 convs) from its shipped weights
        scfg, sparams = load_srvgg_pth(os.path.join(
            ROOT, "models", f"{FAST_MODEL}-x{SCALE}.pth"))
        assert (scfg.num_feat, scfg.num_conv, scfg.upscale) == (64, 8, SCALE)
        dist = distill.Distiller(cfg, params, scfg, tc=tc, device="cuda",
                                 student_params=sparams)
        probe_lr = batches[0][0]
        agree_before = dist.agreement_psnr(probe_lr)
        torch.cuda.synchronize()
        kernels.reset_launches()
        secs = []

        def timed(it):
            for b in it:
                t0 = time.perf_counter()
                yield b
                secs.append(time.perf_counter() - t0)

        hist = distill.run_distillation(
            dist, timed((lr, None) for lr, _ in batches),
            distill.DistillConfig(steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                                  patch=TRAIN_LR_PATCH, log_every=0))
        launches_d = dict(kernels.LAUNCHES)
        want_d = train_launches(scfg, TRAIN_STEPS, cfg.num_conv + 2)
        if len(hist) != TRAIN_STEPS or not all(np.isfinite(hist)) or any(
                launches_d[k] != n for k, n in want_d.items()):
            raise AssertionError(f"distillation: {len(hist)} steps, losses "
                                 f"{hist}, launches {launches_d} (expected "
                                 f"{want_d})")
        agree_after = dist.agreement_psnr(probe_lr)
        # the student as product weights: .pth, the registry, the engine
        student = os.path.join(work, "student.pth")
        exported = trainer.params_on(dist.trainer.export_params(), "cpu",
                                     False)
        save_srvgg_pth(student, scfg, exported)
        cfg_l, params_l = registry.load_model(FAST_MODEL, SCALE,
                                              weights=student)
        if cfg_l != scfg or not all(torch.equal(a, b) for a, b in zip(
                trainer.leaves(params_l), trainer.leaves(exported))):
            raise AssertionError("the student's .pth did not load back to "
                                 "its params")
        ys = [UpscaleEngine(compute_dtype="bfloat16", batch_size=BATCH,
                            preloaded=pre).upscale_frames(frames[:BATCH])
              for pre in ((scfg, exported), (cfg_l, params_l))]
        n_diff = int((ys[0] != ys[1]).sum())
        if ys[0].shape != (BATCH, H * SCALE, W * SCALE, 3) or n_diff != 0:
            raise AssertionError(f"student engine batch {ys[0].shape}: "
                                 f"n_diff {n_diff} between the .pth and "
                                 f"the in-memory params")
        rec.update(
            kernels={k: {"ms": v["ms"], "route": TRAIN_ROUTE[k],
                         "bound_ms": v["bound_ms"],
                         "bound_ms_bf16x6": v["bound_ms_bf16x6"],
                         "bound_ms_fma_f32": v["bound_ms_fma_f32"],
                         "step_ms": v["step_ms"],
                         "step_bound_ms": v["step_bound_ms"],
                         "step_bound_ms_bf16x6": v["step_bound_ms_bf16x6"],
                         "step_bound_ms_fma_f32": v["step_bound_ms_fma_f32"],
                         "step_library_ms": v["step_library_ms"],
                         "max_rel_err": max(p["max_rel_err"] for p in
                                            v["pairs"].values())}
                     for k, v in results.items()},
            finetune=finetune, finetune_x3=finetune_x3,
            distill={"launches": launches_d, "losses": hist,
                     "agreement_db_before": agree_before,
                     "agreement_db_after": agree_after,
                     "ms_per_step": 1e3 * float(np.median(secs)),
                     "n_diff_pth_vs_params": n_diff})
        del dist, ys
        rec["distill_default"] = default_distill_checks(work, inp)
        # random-init students of WIDE_FEATS features from the shipped x4
        # teacher: WIDE_STEPS steps on the kernels, the same on the plain
        # versions (the teacher follows the trainer's `plain`; that run
        # launches no T1-T3), each loss within TRAIN_LOSS_RTOL
        rec["distill_wide"], students = {}, {}
        for feat in WIDE_FEATS:
            wcfg = srvgg.SRVGGConfig(num_feat=feat, num_conv=cfg.num_conv,
                                     upscale=SCALE)
            wide = {}
            for plain in (False, True):
                dw = distill.Distiller(cfg, params, wcfg, tc=tc, seed=0,
                                       device="cuda")
                dw.trainer.plain = plain
                torch.cuda.synchronize()
                kernels.reset_launches()
                wl, ws = [], []
                for lr, _ in batches[:WIDE_STEPS]:
                    t0 = time.perf_counter()
                    wl.append(dw.step(lr))
                    ws.append(time.perf_counter() - t0)
                wide[plain] = (wl, float(np.median(ws)),
                               dict(kernels.LAUNCHES))
                if not plain:  # the student the widths phase serves
                    students[feat] = (wcfg, trainer.params_on(
                        dw.trainer.export_params(), "cpu", False))
                del dw
            want_w = train_launches(wcfg, WIDE_STEPS, cfg.num_conv + 2)
            rel_w = [abs(a - b) / abs(b) for a, b in zip(wide[False][0],
                                                         wide[True][0])]
            if not (all(np.isfinite(wide[False][0])) and max(rel_w)
                    <= TRAIN_LOSS_RTOL) or any(
                        wide[False][2][k] != n for k, n in want_w.items()) \
                    or any(wide[True][2][k] for k in TRAIN_KERNELS):
                raise AssertionError(
                    f"{feat}-feature distillation: losses "
                    f"{wide[False][0]} against the plain path's "
                    f"{wide[True][0]} (relative {max(rel_w)}, bound "
                    f"{TRAIN_LOSS_RTOL}); launches {wide[False][2]} "
                    f"(expected {want_w}), on the plain path "
                    f"{wide[True][2]} (expected none of {TRAIN_KERNELS})")
            rec["distill_wide"][str(feat)] = {
                "num_feat": feat, "num_conv": wcfg.num_conv,
                "launches": wide[False][2], "launches_plain": wide[True][2],
                "losses": wide[False][0],
                "losses_plain": wide[True][0],
                "max_loss_rel_diff": max(rel_w),
                "ms_per_step": 1e3 * wide[False][1],
                "plain_ms_per_step": 1e3 * wide[True][1]}
        torch.cuda.empty_cache()
    return results, launches, students


#: the SRVGG widths besides 64 that the card serves (K3, K1 and K2 in
#: bfloat16 and float32, K4a, K4 and K4h in int8); the widths phase's
#: refusals: a width no kernel takes, in int8 and in bfloat16
SERVE_WIDTHS = (32, 96, 128)
REFUSED = (("int8", 48), ("bfloat16", 48))
#: the int8 kernels, whose forms at SERVE_WIDTHS the widths phase holds
INT8_KERNELS = ("conv3x3_u8_bias_prelu_q8", "conv3x3_s8_dq_prelu_q8",
                "head_conv_s8_residual_u8_shuffle")
#: the widths phase's int8 rule: frame 0 of each engine batch against the
#: plain int8 path on the same calibration (the int8 job's floor)
WIDTH_INT8_DB = 60.0
#: the widths phase's bfloat16 rule (RRDB's): each frame >= this against
#: the plain bf16 path, and within the slack of the plain bf16 path's own
#: PSNR against plain float32 (students trained 5 steps make no
#: transparency claim of their own)
WIDTH_BF16_DB, WIDTH_BF16_SLACK_DB = 50.0, 1.0


def widths_kernel_checks(frames) -> dict:
    """K3, K1 and K2 at SERVE_WIDTHS on the main path's batch, as the
    kernels phase holds them at 64 (kernel_phase: against the plain
    version, then timed beside it, cuDNN and the bound): K3, K1 and K2 at
    x4 of a seeded 1-conv model at each width, and K2 at x2 and x3 of
    models seeded the same way; and K4a, K4 and K4h as the kernels phase
    holds them (int8_kernel_phase: exact, K4a within 1 code; timed beside
    their plain version, torch._int_mm x4 or cuDNN, and the bound) on the
    same models quantized by an int8 engine's calibration on the batch.
    {feat: {kernel: {dtype: numbers}}} (the int8 kernels' dtype "int8"),
    K2's and K4h's x2 and x3 nested under "x2" and "x3"."""
    import torch

    from reve_tpu_torch.models import srvgg
    from reve_tpu_torch.pipeline.engine import UpscaleEngine

    head8 = "head_conv_s8_residual_u8_shuffle"
    out = {}
    for feat in SERVE_WIDTHS:
        res = None
        for r in (4, 2, 3):
            cfg = srvgg.SRVGGConfig(num_feat=feat, num_conv=1, upscale=r)
            params = srvgg.params_to(srvgg.init_params(
                cfg, torch.Generator().manual_seed(feat + r)), "cuda")
            got = kernel_phase(params, cfg, frames, {}, only=None if r == 4
                               else ("head_conv_residual_u8_shuffle",
                                     "head_conv_residual_u8_shuffle_planes"))
            eng = UpscaleEngine(compute_dtype="int8", batch_size=len(frames),
                                preloaded=(cfg, params))
            eng.calibrate_int8(frames)
            got8 = int8_kernel_phase(params, cfg, frames, eng._qbody, {},
                                     only=None if r == 4 else (head8,))
            del eng
            if res is None:
                res = got
                res.update({k: {"int8": v} for k, v in got8.items()})
                continue
            for dt, v in got["head_conv_residual_u8_shuffle"].items():
                res["head_conv_residual_u8_shuffle"][dt][f"x{r}"] = v
            res[head8]["int8"][f"x{r}"] = got8[head8]
        res.pop("split_bf16x3", None)
        out[str(feat)] = res
        torch.cuda.empty_cache()
    return out


def frame_psnr(a, b) -> list:
    """psnr() of each frame of two u8 batches on the card: the squared
    differences summed in int64 (exact), the same formula."""
    import torch

    d = a.int() - b.int()
    sq = (d * d).reshape(len(d), -1)
    return [float(10 * math.log10(255.0 ** 2 / max(v / sq.shape[1], 1e-12)))
            for v in sq.sum(1, dtype=torch.int64).tolist()]


def serve_checks(cfg, params, frames, tile_check: bool = False) -> dict:
    """One engine batch of `frames` through UpscaleEngine on the card in
    bfloat16 and float32, the counters zeroed around it, against
    srvgg.apply's plain path on the same frames: the launches 1 K3,
    num_conv K1 and 1 K2 a model call (float32: srvgg.split_passes; at
    the wide widths K1 and K2 on planes, counted as
    conv3x3_bias_prelu_planes and head_conv_residual_u8_shuffle_planes,
    and no float32-out K1 or float32-input K2); float32 u8 |d| <= 1 on
    every frame;
    bfloat16 each frame >= WIDTH_BF16_DB against the plain bf16 path and within
    WIDTH_BF16_SLACK_DB of the plain bf16 path's PSNR against plain
    float32; the model's ms a batch.  `tile_check`: one --tile TILE batch
    in bfloat16 too, byte-identical to the whole frames."""
    import torch

    from reve_tpu_torch import kernels
    from reve_tpu_torch.models import srvgg
    from reve_tpu_torch.pipeline.engine import UpscaleEngine

    u8 = torch.from_numpy(frames).cuda()
    pdev = srvgg.params_to(params, "cuda")
    # the plain paths' outputs stay on the card, where the engine's
    # frames are held against them
    plain = {dt: srvgg.apply(pdev, u8, cfg=cfg, plain=True,
                             compute_dtype=getattr(torch, dt))
             for dt in ("bfloat16", "float32")}
    del pdev
    res = {"num_feat": cfg.num_feat, "num_conv": cfg.num_conv,
           "upscale": cfg.upscale}
    for dt in ("bfloat16", "float32"):
        eng = UpscaleEngine(compute_dtype=dt, batch_size=len(frames),
                            preloaded=(cfg, params))
        torch.cuda.synchronize()
        kernels.reset_launches()
        y = torch.from_numpy(eng.upscale_frames(frames)).cuda()
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        calls = eng.stats.calls
        want = {"conv3x3_u8_bias_prelu": calls,
                "conv3x3_bias_prelu": cfg.num_conv * calls,
                "head_conv_residual_u8_shuffle": calls}
        if dt == "float32":
            want["split_bf16x3"] = srvgg.split_passes(cfg, torch.float32) \
                * calls
            if srvgg.carries_planes(cfg.num_feat, torch.float32):
                # K1 and K2 on planes, counted apart from the forms on a
                # float32 input
                for k in ("conv3x3_bias_prelu",
                          "head_conv_residual_u8_shuffle"):
                    want[k + "_planes"] = want.pop(k)
        if launches != want:
            raise AssertionError(f"{cfg} {dt} engine batch: launches "
                                 f"{launches}, expected {want}")
        rec = {"launches": launches, "calls": calls,
               "split_passes_per_call": launches.get("split_bf16x3", 0)
               / calls,
               "model_ms_per_batch": cuda_time_ms(lambda: srvgg.apply(
                   eng.params, u8, cfg=cfg,
                   compute_dtype=eng.compute_dtype), iters=3)}
        if dt == "float32":
            d = (y.int() - plain[dt].int()).abs()
            per_frame = d.reshape(len(y), -1).amax(1).tolist()
            if max(per_frame) > 1:
                raise AssertionError(f"{cfg} float32 engine batch: max "
                                     f"|d| {per_frame} by frame against "
                                     f"the plain path (bound 1)")
            rec.update(max_abs_diff_by_frame=per_frame,
                       n_diff=int((d > 0).sum()))
            del d
        else:
            db = frame_psnr(y, plain[dt])
            db_ref = frame_psnr(y, plain["float32"])
            db_plain = frame_psnr(plain[dt], plain["float32"])
            if min(db) < WIDTH_BF16_DB or any(
                    a < b - WIDTH_BF16_SLACK_DB
                    for a, b in zip(db_ref, db_plain)):
                raise AssertionError(
                    f"{cfg} bfloat16 engine batch: {db} dB against the "
                    f"plain bf16 path (floor {WIDTH_BF16_DB}); {db_ref} "
                    f"against plain float32, the plain bf16 path's "
                    f"{db_plain} (slack {WIDTH_BF16_SLACK_DB})")
            rec.update(psnr_db_vs_plain_bf16=db, psnr_db_vs_plain_f32=db_ref,
                       plain_bf16_psnr_db_vs_plain_f32=db_plain)
            if tile_check:
                eng_t = UpscaleEngine(compute_dtype=dt, tile=TILE,
                                      batch_size=len(frames),
                                      preloaded=(cfg, params))
                kernels.reset_launches()
                yt = torch.from_numpy(eng_t.upscale_frames(frames)).cuda()
                torch.cuda.synchronize()
                n_diff = int((yt != y).sum())
                if n_diff:
                    raise AssertionError(f"{cfg} --tile {TILE}: n_diff "
                                         f"{n_diff} against whole frames")
                rec["tile"] = {"tile": TILE, "n_diff_vs_whole": n_diff,
                               "calls": eng_t.stats.calls,
                               "launches": {k: v for k, v in
                                            kernels.LAUNCHES.items() if v}}
                del eng_t, yt
        res[dt] = rec
        del eng, y
        torch.cuda.empty_cache()
    res["int8"] = serve_int8_checks(cfg, params, frames, u8, tile_check)
    return res


def serve_int8_checks(cfg, params, frames, u8, tile_check: bool) -> dict:
    """One int8 engine batch of `frames` through UpscaleEngine on the
    card, calibrated on them first (a job's own calibration), the
    counters zeroed around the batch: launches 1 K4a, num_conv K4 and 1
    K4h a model call; frame 0 >= WIDTH_INT8_DB against srvgg.apply_int8's
    plain path (`u8` on the card) quantized from the same calibration's
    maxima, as the int8 job's frame is held; the certificate's PSNR
    (certify_int8 on the frames: reported, not gated) and the int8
    model's ms a batch.  `tile_check`: one --tile TILE int8 batch on the
    same calibration, byte-identical to the whole frames."""
    import torch

    from reve_tpu_torch import kernels
    from reve_tpu_torch.models import srvgg
    from reve_tpu_torch.pipeline.engine import UpscaleEngine
    from reve_tpu_torch.weights import quantize

    eng = UpscaleEngine(compute_dtype="int8", batch_size=len(frames),
                        preloaded=(cfg, params))
    eng.calibrate_int8(frames)
    maxima = eng.get_calibration()
    torch.cuda.synchronize()
    kernels.reset_launches()
    y = torch.from_numpy(eng.upscale_frames(frames)).cuda()
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    calls = eng.stats.calls
    want = {"conv3x3_u8_bias_prelu_q8": calls,
            "conv3x3_s8_dq_prelu_q8": cfg.num_conv * calls,
            "head_conv_s8_residual_u8_shuffle": calls}
    if launches != want:
        raise AssertionError(f"{cfg} int8 engine batch: launches "
                             f"{launches}, expected {want}")
    pdev = srvgg.params_to(params, "cuda")
    ref = srvgg.apply_int8(pdev, quantize.build_qbody(pdev, cfg, maxima,
                                                      margin=1.25),
                           u8[:1], cfg=cfg, plain=True)
    db = frame_psnr(y[:1], ref)[0]
    if not db >= WIDTH_INT8_DB:
        raise AssertionError(f"{cfg} int8 engine batch: frame 0 {db:.2f} dB "
                             f"against the plain int8 path < "
                             f"{WIDTH_INT8_DB}")
    rec = {"launches": launches, "calls": calls,
           "psnr_db_vs_plain_int8": db, "psnr_floor_db": WIDTH_INT8_DB,
           "n_diff_vs_plain_int8": int((y[:1] != ref).sum()),
           "certificate_db": eng.certify_int8(frames),
           "model_ms_per_batch": cuda_time_ms(lambda: srvgg.apply_int8(
               eng.params, eng._qbody, u8, cfg=cfg), iters=3)}
    del pdev, ref
    if tile_check:
        eng_t = UpscaleEngine(compute_dtype="int8", tile=TILE,
                              batch_size=len(frames), preloaded=(cfg, params))
        eng_t.set_calibration(maxima)
        kernels.reset_launches()
        yt = torch.from_numpy(eng_t.upscale_frames(frames)).cuda()
        torch.cuda.synchronize()
        n_diff = int((yt != y).sum())
        if n_diff:
            raise AssertionError(f"{cfg} int8 --tile {TILE}: n_diff "
                                 f"{n_diff} against whole frames")
        rec["tile"] = {"tile": TILE, "n_diff_vs_whole": n_diff,
                       "calls": eng_t.stats.calls,
                       "launches": {k: v for k, v in
                                    kernels.LAUNCHES.items() if v}}
        del eng_t, yt
    del eng, y
    torch.cuda.empty_cache()
    return rec


#: the widths phase's engine batch whose launches each K2 form reports:
#: (feat, scale) -> model; x4 at every width is that width's student
WIDTH_K2_MODELS = {(128, 2): "x2_128_default", (96, 3): "x3_96_seeded"}


def width_entries(name: str, widths: dict) -> dict:
    """K3's, K1's, K2's, K4a's, K4's or K4h's forms at SERVE_WIDTHS for
    the kernels line: {feat: {dtype: the widths phase's numbers, with
    source, route, design and launches}}.  launches: in that phase's
    engine batch of the x4 student of that width (K2 and K4h at x2 and
    x3, nested under "x2" and "x3": of the model WIDTH_K2_MODELS names,
    else 0)."""
    src = "reve_tpu_torch/kernels/csrc/" + (
        "conv3x3.cu" if name.startswith("conv3x3_u8_bias_prelu")
        else "conv3x3_s8_wide.cuh" if name in INT8_KERNELS
        else "conv3x3_wide.cuh")
    out = {}
    for feat in SERVE_WIDTHS:
        out[str(feat)] = {}
        for dt, nums in widths["kernels"][str(feat)][name].items():
            def launched(r):
                model = f"x4_{feat}" if r == 4 else \
                    WIDTH_K2_MODELS.get((feat, r))
                # float32 K1 and K2 on planes: the float32 engine's
                # launches of that form, counted apart
                eng, key = ("float32", name + "_planes") \
                    if dt == "float32_planes" else (dt, name)
                return widths["engine"][model][eng]["launches"].get(
                    key, 0) if model else 0
            e = dict(nums, source=src, route="cuda",
                     design="wgmma_bf16x6" if dt == "float32" else
                     "wgmma_bf16x6_planes" if dt == "float32_planes" else
                     "wgmma_s8_teams" if src.endswith("s8_wide.cuh") else
                     "wgmma_row_tiles" if name == INT8_KERNELS[0] else
                     "wgmma",
                     launches=launched(4))
            for r in (2, 3):
                if f"x{r}" in e:
                    e[f"x{r}"] = dict(e[f"x{r}"], launches=launched(r))
            out[str(feat)][dt] = e
    return out


def width_cli_int8(work: str, frames) -> dict:
    """The default distillation's x2 128-feature student, as its .pth,
    through `cli.run --dtype int8` on `frames` (its own calibration and
    certification): exit 0, the output's frame count and size, and the
    int8 kernels among the job's launches.  Then the same job with
    `--dtype auto` under REVE_TPU_AUTO_INT8=1: it certifies int8 and
    resolves int8 at the 50-dB gate or above, else bfloat16, and runs the
    kernels of what it resolved."""
    import torch

    from reve_tpu_torch import cli, kernels
    from reve_tpu_torch.io import reader, writer
    from reve_tpu_torch.pipeline.state import Workspace

    inp = os.path.join(work, "widths-in.y4m")
    with writer.Y4MWriter(inp, W, H, fractions.Fraction(24)) as wr:
        for f in frames:
            wr.write(f)
    res = {}
    for dtype in ("int8", "auto"):
        out = os.path.join(work, f"widths-{dtype}.y4m")
        argv = ["-i", inp, "-s", "2", out, "--dtype", dtype,
                "--io-backend", "y4m", "--weights",
                os.path.join(work, "default-student.pth"), "-S",
                str(len(frames)), "--batch", str(len(frames)), "--yes",
                "--keep-workspace"]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with _env("REVE_TPU_AUTO_INT8", "1" if dtype == "auto" else None):
            rc = cli.run(argv)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        rd = reader.Y4MReader(out) if rc == 0 else None
        shape = (rd.frame_count(), rd.width, rd.height) if rd else None
        resolved = Workspace(out + ".revework").load_resolution() \
            if dtype == "auto" else {"dtype": "int8", "db": None}
        want = "int8" if resolved and resolved["db"] is not None and \
            resolved["db"] >= 50.0 else "bfloat16"
        runs = INT8_KERNELS if (resolved or {}).get("dtype") == "int8" \
            else ("conv3x3_u8_bias_prelu", "head_conv_residual_u8_shuffle")
        if rc != 0 or shape != (len(frames), 2 * W, 2 * H) or any(
                not launches.get(k) for k in runs) or (
                    dtype == "auto" and resolved["dtype"] != want):
            raise AssertionError(
                f"default student --dtype {dtype} job: exit {rc}, output "
                f"{shape}, resolved {resolved}, launches {launches}")
        res[dtype] = {"argv": argv[4:], "rc": rc, "wall_s": wall,
                      "output": shape, "resolved": resolved,
                      "launches": launches}
    return res


@contextlib.contextmanager
def _env(name: str, value):
    """The environment variable `name` set to `value` (None: unset) for
    the block, then restored."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def widths_phase(work: str, frames, students: dict) -> dict:
    """Phase widths (see the module docstring).  `students`: {feat: (cfg,
    params)} of the train phase's x4 students.  Returns the kernels' and
    the engine batches' numbers."""
    import torch

    from reve_tpu_torch import kernels
    from reve_tpu_torch.models import registry, srvgg
    from reve_tpu_torch.pipeline.engine import (SERVING_WIDTHS_ITEM,
                                                UpscaleEngine)

    with phase("widths", {"widths": list(SERVE_WIDTHS),
                          "batch": len(frames), "h": H, "w": W}) as rec:
        rec["kernels"] = widths_kernel_checks(frames)
        models = {f"x4_{feat}": students[feat] for feat in SERVE_WIDTHS}
        # the default distillation's student, as a user loads it
        models["x2_128_default"] = registry.load_model(
            DEFAULT_TEACHER, 2,
            weights=os.path.join(work, "default-student.pth"))
        cfg3 = srvgg.SRVGGConfig(num_feat=96, num_conv=16, upscale=3)
        models["x3_96_seeded"] = (cfg3, srvgg.init_params(
            cfg3, torch.Generator().manual_seed(96)))
        rec["engine"] = {
            name: serve_checks(cfg, params, frames,
                               tile_check=name == "x4_128")
            for name, (cfg, params) in models.items()}
        rec["cli"] = width_cli_int8(work, frames[:2])
        # refused before any batch, naming the ROADMAP.md item
        rec["refused"] = {}
        for dt, feat in REFUSED:
            cfg_r = srvgg.SRVGGConfig(num_feat=feat, num_conv=1, upscale=4)
            kernels.reset_launches()
            try:
                UpscaleEngine(compute_dtype=dt, preloaded=(
                    cfg_r, srvgg.init_params(cfg_r)))
                raise AssertionError(f"the engine took a {feat}-feature "
                                     f"SRVGG in {dt} on the card")
            except NotImplementedError as e:
                if SERVING_WIDTHS_ITEM not in str(e) or any(
                        kernels.LAUNCHES.values()):
                    raise
                rec["refused"][f"{dt}_{feat}"] = str(e)
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "False)")
    sys.path.insert(0, ROOT)
    if not os.path.isdir(os.path.join(ROOT, "reve_tpu_torch")):
        raise RuntimeError(f"no reve_tpu_torch package beside {__file__}: "
                           f"run it from the root of a checkout of the "
                           f"repo")
    from reve_tpu_torch import cli, kernels, native
    from reve_tpu_torch.io import concat as concat_mod
    from reve_tpu_torch.io import reader, writer
    from reve_tpu_torch.kernels import (build, conv3x3, conv3x3_s8,
                                        dot_probe, head, train)
    from reve_tpu_torch.kernels import color as color_k
    from reve_tpu_torch.kernels import rrdb as k7
    from reve_tpu_torch.models import registry, rrdb, srvgg
    from reve_tpu_torch.pipeline.engine import UpscaleEngine
    from reve_tpu_torch.weights import quantize
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
        # the native container core (g++) builds beside the kernels
        native_t = threading.Thread(target=native.load)
        native_t.start()
        info = build.load_all()
        rec["sources"] = {}
        for s, v in info.items():
            sass = sass_ops(s)
            ops = sass["all"]
            rec["sources"][s] = {
                "seconds": round(v["seconds"], 3), "cached": v["cached"],
                "wgmma": sum(n for k, n in ops.items()
                             if k.endswith("GMMA")),
                "sass_ops": ops,
                # spill stores and loads in ptxas's report (None: no
                # report, a library loaded from the build cache)
                "spill_bytes": sum(int(n) for n in re.findall(
                    r"(\d+) bytes spill (?:stores|loads)", v["log"]))
                if "spill" in v["log"] else None,
                "kernels_without_wgmma": sorted(
                    k for k, o in sass["by_kernel"].items()
                    if not any(op.endswith("GMMA") for op in o))}
            print(f"# {s}: {ops} | "
                  + " | ".join(ln.strip() for ln in v["log"].splitlines()
                               if "registers" in ln or "spill" in ln),
                  flush=True)
        # K1, K2, K3, K7 (both dtypes), K7q, K4a, K4, K4h and P1 run on
        # wgmma; nothing on __dp4a or mma.sync
        for s, least in MIN_WGMMA.items():
            if rec["sources"][s]["wgmma"] < least:
                raise AssertionError(f"{s}: {rec['sources'][s]['wgmma']} "
                                     f"wgmma in its SASS, fewer than its "
                                     f"kernels' {least}")
        p1 = rec["sources"][dot_probe.SOURCE]["sass_ops"]
        if p1.get("IGMMA", 0) < P1_IGMMA or p1.get("HGMMA", 0) < P1_HGMMA:
            raise AssertionError(f"{dot_probe.SOURCE}: {p1}, fewer than "
                                 f"IGMMA {P1_IGMMA} and HGMMA {P1_HGMMA}")
        # no CUDA-core form of K3, K4a, K4, K4h, K7 or K7q and no
        # mma.sync form of P1 is left: every kernel of their libraries
        # holds wgmma
        for s in (conv3x3.SOURCE, conv3x3_s8.SOURCE, dot_probe.SOURCE,
                  "rrdb.cu", "rrdb_s8.cu"):
            if rec["sources"][s]["kernels_without_wgmma"]:
                raise AssertionError(
                    f"{s}: kernels without wgmma: "
                    f"{rec['sources'][s]['kernels_without_wgmma']}")
        for s, v in rec["sources"].items():
            for op in ("IDP4A", "HMMA", "IMMA"):
                if v["sass_ops"].get(op):
                    raise AssertionError(f"{s}: {op} in its SASS")
        # float32 conv_last sums in float32 FMAs held in registers: FFMA
        # in its SASS, and ptxas reports no spill for its kernel
        last = rec["sources"][head.LAST_F32_SOURCE]
        if not last["sass_ops"].get("FFMA") or last["spill_bytes"] != 0:
            raise AssertionError(f"{head.LAST_F32_SOURCE}: {last}, expected "
                                 f"FFMA and no spills")
        # train.sass_faults: HGMMA in each of T1's, T2's and T3's 23
        # kernels (one a channel pair: no CUDA-core form of them is left),
        # and no TF32 product or float atomic in the training library
        faults = train.sass_faults()
        if faults:
            raise AssertionError("; ".join(faults))
        by_k = sass_ops(train.SOURCE)["by_kernel"]
        tc = rec["sources"][train.SOURCE]
        tc["hgmma_by_kernel"] = {kernel_label(k): o.get("HGMMA", 0)
                                 for k, o in sorted(by_k.items())}
        tc["spill_bytes_by_kernel"] = {
            kernel_label(k): n
            for k, n in sorted(build.spills(train.SOURCE).items())}
        print(f"# {train.SOURCE}: HGMMA {tc['hgmma_by_kernel']}; spill "
              f"bytes {tc['spill_bytes_by_kernel']}", flush=True)
        # K3, K1 and K2 at every width, both dtypes, and K4a, K4 and K4h:
        # spills by kernel
        for s in (conv3x3.SOURCE, conv3x3.TC_SOURCE, conv3x3.F32_SOURCE,
                  conv3x3_s8.SOURCE):
            by = {kernel_label(k): n
                  for k, n in sorted(build.spills(s).items())}
            rec["sources"][s]["spill_bytes_by_kernel"] = by
            print(f"# {s}: spill bytes {by}", flush=True)
        # K9's float steps are one rounded op each: no contraction
        faults = color_k.contraction_faults()
        if faults:
            raise AssertionError("; ".join(faults))
        rec["sources"][color_k.SOURCE]["contraction_faults"] = faults
        native_t.join()
        if not native.available():
            raise AssertionError("the native container core did not build "
                                 "(g++ over reve_tpu_torch/_native/)")
        rec["native"] = dict(native.build_info)

    weights = os.path.join(ROOT, "models", "realesr-animevideov3-x4.pth")
    cfg, params = load_srvgg_pth(weights)
    assert (cfg.num_feat, cfg.num_conv, cfg.upscale) == (64, 16, SCALE)
    params = srvgg.params_to(params, "cuda")
    frames = frames_u8(FRAMES, H, W)

    with phase("kernels", {"batch": BATCH, "h": H, "w": W,
                           "scale": SCALE}) as rec:
        results = kernel_phase(params, cfg, frames[:BATCH], rec)
        # the TTA path's odd quarter-turns run every kernel on the
        # transposed batch (W x H: 1080 columns, ragged against the
        # kernels' 64-pixel tiles): held there too, untimed
        frames_t = np.ascontiguousarray(frames[:BATCH].transpose(0, 2, 1, 3))
        for kname, by_dt in kernel_phase(params, cfg, frames_t, rec,
                                         timed=False).items():
            for dt, v in by_dt.items():
                results[kname][dt]["transposed"] = v
        batch_ms = model_ms(params, cfg, frames[:BATCH])
        # a QuantizedBody as the int8 engine calibrates it on these frames
        eng = UpscaleEngine(compute_dtype="int8", batch_size=BATCH,
                            preloaded=(cfg, params))
        eng.calibrate_int8(frames)
        qb = eng._qbody
        rec["int8_calibrate_s"] = eng.stats.calibrate_s
        results8 = int8_kernel_phase(params, cfg, frames[:BATCH], qb, rec)
        for kname, v in int8_kernel_phase(params, cfg, frames_t, qb, rec,
                                          timed=False).items():
            results8[kname]["transposed"] = v
        u8 = torch.from_numpy(frames[:BATCH]).cuda()
        batch_ms["int8"] = cuda_time_ms(lambda: srvgg.apply_int8(
            params, qb, u8, cfg=cfg), iters=3)
        rec["model_ms_per_batch"] = batch_ms
        del eng, u8
        k6 = tta_kernel_phase(rec)

    with phase("color", {"batch": BATCH, "h": H * SCALE,
                         "w": W * SCALE}) as rec:
        k9 = color_phase(params, cfg, frames[:BATCH])
        rec.update(k9)

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
            # the job's concat report (its backend)
            reports, concatenate = [], concat_mod.concatenate

            def recording(*a, **k):
                reports.append(concatenate(*a, **k))
                return reports[-1]

            concat_mod.concatenate = recording
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            try:
                rc = cli.run(argv)
            finally:
                concat_mod.concatenate = concatenate
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
            k9_check(launches, calls, "main")
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
            spans = span_seconds(trace)
            model_s = calls * batch_ms["bfloat16"] / 1e3
            rec.update(rc=rc, frames=FRAMES, wall_s=round(wall, 3),
                       fps_end_to_end=FRAMES / wall, launches=launches,
                       model_calls=calls, psnr_db_vs_plain_f32=db,
                       psnr_floor_db=srvgg.BF16_PSNR_FLOOR_DB,
                       output=[W * SCALE, H * SCALE], span_s=spans,
                       encode_share_of_wall=spans.get("encode_batch", 0.0)
                       / wall,
                       model_device_s=model_s,
                       model_share_of_wall=model_s / wall,
                       concat=reports)
        main_launches = launches

        with phase("native", {}) as rec:
            probed = native.probe_y4m(out)
            if (probed["frames"], probed["width"], probed["height"]) != \
                    (FRAMES, W * SCALE, H * SCALE):
                raise AssertionError(f"native y4m probe of the main job's "
                                     f"output: {probed}")
            # FRAME markers with parameters: the walk counts 3 frames
            marked = os.path.join(work, "marked.y4m")
            with open(marked, "wb") as f:
                f.write(b"YUV4MPEG2 W8 H4 F25:1 Ip A1:1 C420\n")
                for i in range(3):
                    f.write(b"FRAME Ixyz X=%d\n" % i + bytes(48))
            marked_frames = native.probe_y4m(marked)["frames"]
            if marked_frames != 3 or [r["backend"] for r in reports] != \
                    ["native"]:
                raise AssertionError(f"native: {marked_frames} frames "
                                     f"probed of 3; the main job's concat "
                                     f"reports {reports}")
            rec.update(build=dict(native.build_info), probe_main=probed,
                       probe_frame_params=marked_frames,
                       main_concat=reports[0],
                       planner=native.plan_segments(FRAMES, 4))

        out8 = os.path.join(work, "out8.y4m")
        trace8 = os.path.join(work, "trace8.jsonl")
        argv8 = ["-i", inp, "-s", str(SCALE), out8, "--dtype", "int8",
                 "--io-backend", "y4m", "--weights", weights, "-S", "4",
                 "--batch", str(BATCH), "--keep-workspace", "--yes",
                 "--trace", trace8]
        with phase("int8", {"argv": argv8[3:]}) as rec:
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            rc = cli.run(argv8)
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            if rc != 0:
                raise AssertionError(f"cli.run --dtype int8 exited {rc}")
            rd = reader.Y4MReader(out8)
            shape = (rd.frame_count(), rd.width, rd.height)
            if shape != (FRAMES, W * SCALE, H * SCALE):
                raise AssertionError(f"int8 output {shape}, expected "
                                     f"{(FRAMES, W * SCALE, H * SCALE)}")
            heads = launches["head_conv_s8_residual_u8_shuffle"]
            hidden = launches["conv3x3_s8_dq_prelu_q8"]
            # calibration and certification run the float32 model: K1
            # and (certification) K2 on the tensor cores, each call with
            # its split pass
            f32_k1 = launches["conv3x3_bias_prelu"]
            f32_k2 = launches["head_conv_residual_u8_shuffle"]
            if heads < 2 or hidden != cfg.num_conv * heads \
                    or launches["conv3x3_u8_bias_prelu_q8"] != heads \
                    or f32_k1 == 0 or f32_k2 == 0 \
                    or launches["split_bf16x3"] != f32_k1 + f32_k2:
                raise AssertionError(f"launch counts {launches} do not "
                                     f"show the int8 path's kernels")
            # the job's own int8 calls: the certification's int8 calls
            # are as many as its float32 heads (K2)
            k9_check(launches, heads - f32_k2, "int8")
            ws8 = os.path.join(work, "out8.y4m.revework")
            with open(os.path.join(ws8, "int8_calibration.json")) as f:
                maxima = json.load(f)["act_maxima"]
            with open(os.path.join(ws8, "int8_cert.json")) as f:
                cert_db = json.load(f)["db"]
            # frame 0 against the plain int8 path on the card, with the
            # persisted calibration, through the same y4m encode
            qb8 = quantize.build_qbody(params, cfg, maxima, margin=1.25)
            ref = srvgg.apply_int8(params, qb8,
                                   torch.from_numpy(in0[None]).cuda(),
                                   cfg=cfg, plain=True)[0].cpu().numpy()
            ref_path = os.path.join(work, "ref8.y4m")
            with writer.open_writer(ref_path, W * SCALE, H * SCALE,
                                    fractions.Fraction(24),
                                    backend="y4m") as wr:
                wr.write(ref)
            ref_dec = next(reader.Y4MReader(ref_path).read_range(0, 1))
            db8 = psnr(next(rd.read_range(0, 1)), ref_dec)
            if not db8 >= 60.0:
                raise AssertionError(f"int8 frame 0 PSNR {db8:.2f} dB vs "
                                     f"the plain int8 path < 60 dB")
            spans, int8_ev = {}, {}
            with open(trace8) as f:
                for ln in f:
                    ev = json.loads(ln)
                    if "dur" in ev:
                        spans[ev["ev"]] = spans.get(ev["ev"], 0.0) + ev["dur"]
                    elif ev["ev"] == "int8":
                        int8_ev = ev
            rec.update(rc=rc, frames=FRAMES, wall_s=round(wall, 3),
                       fps_end_to_end=FRAMES / wall, launches=launches,
                       psnr_db_vs_plain_int8=db8, psnr_floor_db=60.0,
                       certified_db_vs_f32=cert_db,
                       calibrate_s=int8_ev.get("calibrate_s"),
                       certify_s=int8_ev.get("certify_s"),
                       output=[W * SCALE, H * SCALE], span_s=spans)
        int8_launches = launches

        # the main job's first batch, for the tiled and TTA jobs
        in4 = os.path.join(work, "in4.y4m")
        with writer.Y4MWriter(in4, W, H, fractions.Fraction(24)) as wr:
            for f in frames[:BATCH]:
                wr.write(f)
        out_t = os.path.join(work, "out_tile.y4m")
        trace_t = os.path.join(work, "trace_tile.jsonl")
        argv_t = ["-i", in4, "-s", str(SCALE), out_t, "--io-backend", "y4m",
                  "--weights", weights, "-S", "4", "--batch", str(BATCH),
                  "--yes", "--trace", trace_t, "--tile", str(TILE)]
        with phase("tile", {"argv": argv_t[3:]}) as rec:
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            rc = cli.run(argv_t)
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            if rc != 0:
                raise AssertionError(f"cli.run --tile {TILE} exited {rc}")
            calls = launches["conv3x3_u8_bias_prelu"]
            if calls < 1 or \
                    launches["conv3x3_bias_prelu"] != cfg.num_conv * calls \
                    or launches["head_conv_residual_u8_shuffle"] != calls:
                raise AssertionError(f"launch counts {launches} do not "
                                     f"show the model on every window chunk")
            k9_check(launches, 1, "tile")  # one batch, one assembled piece
            # the tiled job's file against the main job's first 4 frames:
            # the same header, then the same bytes
            with open(out_t, "rb") as f:
                got = np.frombuffer(f.read(), np.uint8)
            with open(out, "rb") as f:
                want = np.frombuffer(f.read(len(got)), np.uint8)
            n_diff = int((got != want).sum()) if len(want) == len(got) \
                else -1
            if n_diff != 0:
                raise AssertionError(f"tiled job output differs from the "
                                     f"whole-frame job's: n_diff {n_diff}")
            del got, want
            rec.update(rc=rc, frames=BATCH, wall_s=round(wall, 3),
                       launches=launches, model_calls=calls,
                       windows=BATCH * len(range(0, H, TILE))
                       * len(range(0, W, TILE)), n_diff_vs_main=n_diff,
                       span_s=span_seconds(trace_t),
                       **tile_engine_checks(params, cfg, frames))

        out_a = os.path.join(work, "out_tta.y4m")
        trace_a = os.path.join(work, "trace_tta.jsonl")
        argv_a = ["-i", in4, "-s", str(SCALE), out_a, "--io-backend", "y4m",
                  "--weights", weights, "-S", "4", "--batch", str(BATCH),
                  "--yes", "--trace", trace_a, "--tta"]
        with phase("tta", {"argv": argv_a[3:]}) as rec:
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            rc = cli.run(argv_a)
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            if rc != 0:
                raise AssertionError(f"cli.run --tta exited {rc}")
            # main ran 2 batches; each TTA batch runs 8 times its model
            # calls, K6 once after each
            calls = launches["conv3x3_u8_bias_prelu"]
            if calls != 8 * main_launches["conv3x3_u8_bias_prelu"] // 2 \
                    or launches["tta_accumulate"] != calls \
                    or launches["conv3x3_bias_prelu"] != cfg.num_conv * calls \
                    or launches["head_conv_residual_u8_shuffle"] != calls:
                raise AssertionError(f"launch counts {launches} do not "
                                     f"show the TTA path's kernels")
            k9_check(launches, 1, "tta")  # K9 on the one batch's mean
            got0 = next(reader.Y4MReader(out_a).read_range(0, 1))
            rec.update(rc=rc, frames=BATCH, wall_s=round(wall, 3),
                       fps_end_to_end=BATCH / wall, launches=launches,
                       model_calls=calls, span_s=span_seconds(trace_a),
                       **tta_engine_checks(
                           params, cfg, np.stack(list(reader.Y4MReader(
                               in4).read_range(0, BATCH))), got0, work))
        tta_launches = launches

        # RRDBNet (realesrgan-x4plus at full width and depth, random
        # weights from seed 0) on the same 4 frames
        out_r = os.path.join(work, "out_rrdb.y4m")
        trace_r = os.path.join(work, "trace_rrdb.jsonl")
        argv_r = ["-i", in4, "-s", str(SCALE), out_r, "--model", RRDB_MODEL,
                  "--allow-random-init", "--dtype", "auto", "--io-backend",
                  "y4m", "-S", "4", "--batch", str(BATCH), "--yes",
                  "--trace", trace_r]
        with phase("rrdb", {"argv": argv_r[3:]}) as rec:
            cfg_r, params_r = registry.load_model(RRDB_MODEL, SCALE,
                                                  allow_random_init=True)
            assert (cfg_r.num_feat, cfg_r.num_grow_ch, cfg_r.num_block) == \
                (64, 32, RRDB_BLOCKS)
            params_r = rrdb.params_to(params_r, "cuda")
            k7_results = rrdb_kernel_phase(params_r, frames[:BATCH])
            k7_results["bfloat16"]["parts"] = part_times(k7.SOURCE)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            rc = cli.run(argv_r)
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            if rc != 0:
                raise AssertionError(f"cli.run --model {RRDB_MODEL} exited "
                                     f"{rc}")
            rd = reader.Y4MReader(out_r)
            shape = (rd.frame_count(), rd.width, rd.height)
            if shape != (BATCH, W * SCALE, H * SCALE):
                raise AssertionError(f"rrdb output {shape}, expected "
                                     f"{(BATCH, W * SCALE, H * SCALE)}")
            calls = launches["conv3x3_u8_bias_prelu"]
            if calls < 1 or \
                    launches["dense_conv"] != RRDB_K7_PER_CALL * calls or \
                    launches["conv3x3_bias_prelu"] != 3 * calls or \
                    launches["conv_last_u8"] != calls or \
                    launches["head_conv_residual_u8_shuffle"] != 0:
                raise AssertionError(f"launch counts {launches} do not "
                                     f"show the RRDB path's kernels")
            k9_check(launches, calls, "rrdb")
            # every frame against the plain float32 and the plain
            # bfloat16 paths on the card (a frame at a time), through the
            # same y4m encode as the job's output
            batch4 = np.stack(list(reader.Y4MReader(in4).read_range(
                0, BATCH)))
            refs = {}
            for dt in ("float32", "bfloat16"):
                y = np.stack([rrdb.apply(
                    params_r, torch.from_numpy(batch4[i:i + 1]).cuda(),
                    cfg=cfg_r, compute_dtype=getattr(torch, dt),
                    plain=True)[0].cpu().numpy() for i in range(BATCH)])
                torch.cuda.empty_cache()
                ref_path = os.path.join(work, f"ref_rrdb_{dt}.y4m")
                with writer.open_writer(ref_path, W * SCALE, H * SCALE,
                                        fractions.Fraction(24),
                                        backend="y4m") as wr:
                    for f in y:
                        wr.write(f)
                refs[dt] = (y, list(reader.Y4MReader(ref_path)
                                    .read_range(0, BATCH)))
            got = list(rd.read_range(0, BATCH))
            f32, b16 = refs["float32"][1], refs["bfloat16"][1]
            db = [psnr(g, r) for g, r in zip(got, f32)]
            db_plain = [psnr(a, r) for a, r in zip(b16, f32)]
            db_kernels = [psnr(g, a) for g, a in zip(got, b16)]
            clipped = [float(((g == 0) | (g == 255)).mean()) for g in got]
            # bf16 through 23 random-weight blocks is itself below the
            # 50-dB gate against float32 (the reference's arithmetic, run
            # as the plain bfloat16 path, sits where the job does): each
            # frame is held to the plain bfloat16 path's own distance from
            # float32, and to the plain bfloat16 path itself, which a
            # fault in a kernel moves
            for i in range(BATCH):
                if not db[i] >= db_plain[i] - RRDB_BF16_MARGIN_DB:
                    raise AssertionError(
                        f"rrdb frame {i} PSNR {db[i]:.2f} dB vs the plain "
                        f"float32 path, more than {RRDB_BF16_MARGIN_DB} dB "
                        f"below the plain bfloat16 path's "
                        f"{db_plain[i]:.2f} dB (clipped share "
                        f"{clipped[i]:.3f})")
                if not db_kernels[i] >= RRDB_VS_PLAIN_BF16_DB:
                    raise AssertionError(
                        f"rrdb frame {i} PSNR {db_kernels[i]:.2f} dB vs "
                        f"the plain bfloat16 path, below "
                        f"{RRDB_VS_PLAIN_BF16_DB} dB")
            engines = rrdb_engine_checks(batch4, refs["float32"][0])
            chunk = {"bfloat16": BATCH,
                     "float32": engines["float32"]["plan"][1]}
            last = conv_last_phase(params_r, chunk)
            up_convs = rrdb_k1_phase(params_r, chunk)
            ref = refs["float32"][0]
            del refs
            rec.update(rc=rc, frames=BATCH, wall_s=round(wall, 3),
                       launches=launches, model_calls=calls,
                       launches_per_call={
                           k: launches[k] / calls for k in (
                               "conv3x3_u8_bias_prelu", "dense_conv",
                               "conv3x3_bias_prelu", "conv_last_u8")},
                       psnr_db_vs_plain_f32=db,
                       psnr_db_plain_bf16_vs_plain_f32=db_plain,
                       psnr_db_vs_plain_bf16=db_kernels,
                       psnr_margin_db=RRDB_BF16_MARGIN_DB,
                       psnr_floor_vs_plain_bf16_db=RRDB_VS_PLAIN_BF16_DB,
                       clipped_share=clipped,
                       clipped_share_ref=[
                           float(((f == 0) | (f == 255)).mean())
                           for f in ref],
                       up_convs=up_convs,
                       span_s=span_seconds(trace_r), engines=engines,
                       upsample=upsample_ms(),
                       model_ms_per_batch={
                           dt: engines[dt]["model_ms_per_batch"]
                           for dt in ("bfloat16", "float32")})
            del params_r
            torch.cuda.empty_cache()
        rrdb_launches = launches

        # RRDB's int8 turbo: the same model and frames with --dtype int8
        out_q = os.path.join(work, "out_rrdb8.y4m")
        trace_q = os.path.join(work, "trace_rrdb8.jsonl")
        argv_q = ["-i", in4, "-s", str(SCALE), out_q, "--model", RRDB_MODEL,
                  "--allow-random-init", "--dtype", "int8", "--io-backend",
                  "y4m", "-S", "4", "--batch", str(BATCH), "--keep-workspace",
                  "--yes", "--trace", trace_q]
        with phase("rrdb_int8", {"argv": argv_q[3:]}) as rec:
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            rc = cli.run(argv_q)
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            if rc != 0:
                raise AssertionError(f"cli.run --model {RRDB_MODEL} --dtype "
                                     f"int8 exited {rc}")
            rd = reader.Y4MReader(out_q)
            shape = (rd.frame_count(), rd.width, rd.height)
            if shape != (BATCH, W * SCALE, H * SCALE):
                raise AssertionError(f"rrdb int8 output {shape}, expected "
                                     f"{(BATCH, W * SCALE, H * SCALE)}")
            calls = rrdb_int8_calls(launches)
            k9_check(launches, calls["int8"]
                     - calls["float32_certification"], "rrdb_int8")
            ws_q = out_q + ".revework"
            with open(os.path.join(ws_q, "int8_calibration.json")) as f:
                maxima = json.load(f)["act_maxima"]
            with open(os.path.join(ws_q, "int8_cert.json")) as f:
                cert_db = json.load(f)["db"]
            spans, int8_ev = {}, {}
            with open(trace_q) as f:
                for ln in f:
                    ev = json.loads(ln)
                    if "dur" in ev:
                        spans[ev["ev"]] = spans.get(ev["ev"], 0.0) + ev["dur"]
                    elif ev["ev"] == "int8":
                        int8_ev = ev
            cfg_q, params_q = registry.load_model(RRDB_MODEL, SCALE,
                                                  allow_random_init=True)
            params_q = rrdb.params_to(params_q, "cuda")
            qb_q = rrdb.prepare_qbody(quantize.build_qbody(
                params_q, cfg_q, maxima, margin=1.25))
            # every frame against the plain int8 path on the card with the
            # job's persisted calibration, a frame at a time, through the
            # same y4m encode
            batch4 = np.stack(list(reader.Y4MReader(in4).read_range(
                0, BATCH)))
            t1 = time.perf_counter()
            ref = np.stack([rrdb.apply_int8(
                params_q, qb_q, torch.from_numpy(batch4[i:i + 1]).cuda(),
                cfg=cfg_q, plain=True)[0].cpu().numpy()
                for i in range(BATCH)])
            plain_s = time.perf_counter() - t1
            torch.cuda.empty_cache()
            ref_path = os.path.join(work, "ref_rrdb8.y4m")
            with writer.open_writer(ref_path, W * SCALE, H * SCALE,
                                    fractions.Fraction(24),
                                    backend="y4m") as wr:
                for f in ref:
                    wr.write(f)
            got = list(rd.read_range(0, BATCH))
            ref_dec = list(reader.Y4MReader(ref_path).read_range(0, BATCH))
            db_q = [psnr(g, r) for g, r in zip(got, ref_dec)]
            n_diff_q = [int((g != r).sum()) for g, r in zip(got, ref_dec)]
            for i in range(BATCH):
                if not db_q[i] >= RRDB_INT8_FLOOR_DB:
                    raise AssertionError(
                        f"rrdb int8 frame {i} PSNR {db_q[i]:.2f} dB vs the "
                        f"plain int8 path < {RRDB_INT8_FLOOR_DB} dB")
            del ref, ref_dec, got
            k7q_results = rrdb_int8_kernel_phase(params_q, qb_q,
                                                 frames[:BATCH])
            k7q_results["parts"] = part_times(k7.S8_SOURCE)
            del qb_q, params_q
            torch.cuda.empty_cache()
            engine_q = rrdb_int8_engine_checks(batch4, maxima)
            rec.update(rc=rc, frames=BATCH, wall_s=round(wall, 3),
                       launches=launches, calls=calls,
                       launches_per_call={
                           k: launches[k] / max(calls["int8"], 1)
                           for k in ("dense_conv_s8",)} | {
                           k: (launches[k] - calls["float32_" + k])
                           / max(calls["int8"], 1) for k in (
                               "conv3x3_u8_bias_prelu", "conv3x3_bias_prelu",
                               "conv_last_u8")},
                       psnr_db_vs_plain_int8=db_q,
                       n_diff_vs_plain_int8=n_diff_q,
                       psnr_floor_db=RRDB_INT8_FLOOR_DB,
                       plain_int8_s=plain_s,
                       certified_db_vs_f32=cert_db,
                       calibrate_s=int8_ev.get("calibrate_s"),
                       certify_s=int8_ev.get("certify_s"),
                       span_s=spans, engine=engine_q,
                       model_ms_per_batch={
                           "int8": engine_q["model_ms_per_batch"],
                           "bfloat16": engines["bfloat16"][
                               "model_ms_per_batch"]},
                       k7q_call_ms=k7q_results["call_ms"],
                       k7q_call_bound_ms=k7q_results["call_bound_ms"],
                       k7q_forms=k7q_results["forms"],
                       k7q_parts=k7q_results["parts"])
        rrdb8_launches = launches

        k3x2, engines_x, x2_launches = x2_phase(work, in4, frames)
        weights_phase(work, frames, weights)
        scenes_phase(work, weights)
        train_res, train_launched, students = train_phase(work, inp, frames,
                                                          weights)
        widths = widths_phase(work, frames[:BATCH], students)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    with phase("probe", {}) as rec:
        probe = probe_phase(rec, smi)
        probe_launches = rec["launches"]

    sources = {
        "conv3x3_u8_bias_prelu": (
            "reve_tpu_torch/kernels/csrc/conv3x3.cu",
            "reve_tpu/models/srvgg.py:203"),
        "conv3x3_bias_prelu": (
            "reve_tpu_torch/kernels/csrc/conv3x3_tc.cu",
            "reve_tpu/models/srvgg.py:206"),
        "split_bf16x3": (
            "reve_tpu_torch/kernels/csrc/conv3x3_f32_tc.cu",
            "reve_tpu/models/srvgg.py:91"),
        "head_conv_residual_u8_shuffle": (
            "reve_tpu_torch/kernels/csrc/conv3x3_tc.cu",
            "reve_tpu/models/srvgg.py:211"),
        "conv3x3_u8_bias_prelu_q8": (
            "reve_tpu_torch/kernels/csrc/conv3x3.cu",
            "reve_tpu/models/srvgg.py:376"),
        "conv3x3_s8_dq_prelu_q8": (
            "reve_tpu_torch/kernels/csrc/conv3x3_s8.cu",
            "reve_tpu/models/srvgg.py:380"),
        "head_conv_s8_residual_u8_shuffle": (
            "reve_tpu_torch/kernels/csrc/conv3x3_s8.cu",
            "reve_tpu/models/srvgg.py:383"),
        "tta_accumulate": (
            "reve_tpu_torch/kernels/csrc/tta.cu",
            "reve_tpu/pipeline/engine.py:189"),
        "dot_loop": (
            "reve_tpu_torch/kernels/csrc/dot_probe.cu",
            "scripts/perf_pallas_int8.py:54"),
        "rgb_to_yuv420_u8": (
            "reve_tpu_torch/kernels/csrc/color.cu",
            "reve_tpu/ops/color.py:142"),
        "dense_conv": (
            "reve_tpu_torch/kernels/csrc/rrdb.cu",
            "reve_tpu/models/rrdb.py:157"),
        "conv_last_u8": (
            "reve_tpu_torch/kernels/csrc/conv3x3_tc.cu",
            "reve_tpu/models/rrdb.py:232"),
        "dense_conv_s8": (
            "reve_tpu_torch/kernels/csrc/rrdb_s8.cu",
            "reve_tpu/models/rrdb.py:247"),
        "conv3x3_u8x2_bias": (
            "reve_tpu_torch/kernels/csrc/conv3x3.cu",
            "reve_tpu/models/rrdb.py:192"),
        # the training convs: XLA's conv and the two convs jax autodiff
        # derives from it under value_and_grad
        "conv3x3_fwd_train": (
            "reve_tpu_torch/kernels/csrc/conv3x3_train_tc.cu",
            "reve_tpu/models/srvgg.py:88"),
        "conv3x3_dgrad": (
            "reve_tpu_torch/kernels/csrc/conv3x3_train_tc.cu",
            "reve_tpu/train/trainer.py:66"),
        "conv3x3_wgrad": (
            "reve_tpu_torch/kernels/csrc/conv3x3_train_tc.cu",
            "reve_tpu/train/trainer.py:66"),
    }
    # each kernel's numbers and its launches on the path that runs it: the
    # bf16 main job, the int8 job, or the probe script
    paths = {
        "conv3x3_u8_bias_prelu": ("bfloat16", main_launches),
        "conv3x3_bias_prelu": ("bfloat16", main_launches),
        "split_bf16x3": ("float32", int8_launches),
        "head_conv_residual_u8_shuffle": ("bfloat16", main_launches),
        "conv3x3_u8_bias_prelu_q8": ("int8", int8_launches),
        "conv3x3_s8_dq_prelu_q8": ("int8", int8_launches),
        "head_conv_s8_residual_u8_shuffle": ("int8", int8_launches),
        "tta_accumulate": ("uint8", tta_launches),
        "rgb_to_yuv420_u8": ("uint8", main_launches),
        "dot_loop": ("int8", {"dot_loop": probe_launches}),
        "dense_conv": ("bfloat16", rrdb_launches),
        "conv_last_u8": ("bfloat16", rrdb_launches),
        "dense_conv_s8": ("int8", rrdb8_launches),
        "conv3x3_u8x2_bias": ("bfloat16", x2_launches),
        **{k: ("float32", train_launched) for k in TRAIN_KERNELS},
    }
    # every model conv and P1 run on wgmma, the split pass on CUDA cores;
    # the float32 forms of K1, K2 and K3 run on wgmma as six bf16 products
    # (K1's and K2's after their split pass)
    designs = {"split_bf16x3": "elementwise",
               "tta_accumulate": "smem_transpose",
               "rgb_to_yuv420_u8": "elementwise",
               "conv3x3_fwd_train": "wgmma_bf16x6",
               "conv3x3_dgrad": "wgmma_bf16x6",
               "conv3x3_wgrad": "wgmma_bf16x6"}
    f32_forms = {
        "conv3x3_u8_bias_prelu": ("reve_tpu_torch/kernels/csrc/conv3x3.cu",
                                  "wgmma_bf16x6"),
        "conv3x3_bias_prelu": (
            "reve_tpu_torch/kernels/csrc/conv3x3_f32_tc.cu",
            "wgmma_bf16x6"),
        "head_conv_residual_u8_shuffle": (
            "reve_tpu_torch/kernels/csrc/conv3x3_f32_tc.cu",
            "wgmma_bf16x6"),
    }
    line = []
    for name, (src, replaces) in sources.items():
        dtype, launched = paths[name]
        if name == "dot_loop":
            nums = probe["int8"]
            extra = {key: nums[key] for key in (
                "library_loop_ms", "library_dtype", "host_ms", "ms_long",
                "long_loops", "marginal_tops", "growth", "linear")}
            extra["bfloat16"] = probe["bf16"]
        elif name == "split_bf16x3":
            nums, extra = results[name], {}
        elif name == "rgb_to_yuv420_u8":
            nums = k9
            extra = {key: k9[key] for key in ("forms", "format")}
        elif name == "tta_accumulate":
            nums = k6
            extra = {key: k6[key] for key in ("forms", "batch_ms",
                                              "batch_bound_ms")}
        elif name in ("dense_conv", "conv_last_u8"):
            # bfloat16 at the top, float32 nested with its launches in the
            # float32 engine's batch (float32 conv_last: its own kernel
            # of float32 FMAs)
            by_dt = k7_results if name == "dense_conv" else last
            f32_src, f32_design = (src, "wgmma_bf16x6") \
                if name == "dense_conv" else (
                    "reve_tpu_torch/kernels/csrc/conv_last_f32.cu",
                    "fma_f32")
            nums = by_dt["bfloat16"]
            extra = {key: v for key, v in nums.items() if key not in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape", "n_diff")}
            extra["float32"] = dict(
                by_dt["float32"], source=f32_src, route="cuda",
                replaces=replaces, design=f32_design,
                launches=engines["float32"]["launches"].get(name, 0))
        elif name == "conv3x3_u8x2_bias":
            # float32 nested with its launches in the x2 float32 batch
            nums = k3x2["bfloat16"]
            extra = {"wgmma_by_kernel": nums["wgmma_by_kernel"],
                     "float32": dict(
                         k3x2["float32"], source=src, route="cuda",
                         replaces=replaces, design="wgmma_bf16x6",
                         launches=engines_x["float32"]["launches"][name])}
        elif name in TRAIN_KERNELS:
            # the hidden conv's numbers, every channel pair under "pairs"
            nums = train_res[name]
            extra = {key: nums[key] for key in (
                "pairs", "launches_per_step", "step_ms", "step_bound_ms",
                "bound_ms_bf16x6", "step_bound_ms_bf16x6",
                "bound_ms_fma_f32", "step_bound_ms_fma_f32",
                "step_library_ms", "max_rel_err")}
        elif name == "dense_conv_s8":
            nums = k7q_results
            extra = {key: nums[key] for key in ("forms", "call_ms",
                                                "call_bound_ms")}
        elif dtype == "bfloat16":
            f32_src, f32_design = f32_forms[name]
            nums, extra = results[name]["bfloat16"], {
                "transposed": results[name]["bfloat16"]["transposed"],
                "float32": dict(results[name]["float32"], source=f32_src,
                                route="cuda", design=f32_design,
                                launches=int8_launches[name])}
        else:
            nums = results8[name]
            extra = {"transposed": nums["transposed"]}
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launched[name],
                 "dtype": dtype, "design": designs.get(name, "wgmma")}
        entry.update({k: nums[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape") + (("n_diff",) if "n_diff" in nums
                                      else ())})
        entry.update(extra)
        if name in f32_forms or name in INT8_KERNELS:
            entry["widths"] = width_entries(name, widths)
        if name == "conv3x3_bias_prelu":
            # K1 on the RRDB path: conv_up1 at 2x, conv_up2 and conv_hr at
            # 4x, with its launches in the bf16 job and the float32 batch
            entry["rrdb"] = dict(
                up_convs, launches=rrdb_launches[name],
                float32_launches=engines["float32"]["launches"][name])
        line.append(entry)
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as e:
        fail_line(e)
        print(f"chip_smoke: {CURRENT[0]} failed: {e}", file=sys.stderr)
        raise
    sys.exit(rc)
