"""Where the time of the tensor-core conv kernels (and of K6) goes.

    python -m reve_tpu_torch.scripts.perf_conv_tc_parts [--iters N]
        [--sources SOURCE ...] [--variants VARIANT ...]

Builds variants of the conv sources with one or two of their
parts taken out: the halo loads after the first tile (`no_load`: later
tiles compute on a stale buffer), the wgmmas (`no_mma`: the accumulators
are set, not computed), and the epilogue (`no_epi`: nothing is written).
It times each variant, beside the kernel as it is (`full`), at the main
path's shapes (a batch of 4 1920x1080 frames); `two_blocks` runs K4h at
two blocks on each SM, as K4, not three.  For K3 and K4a `no_epi` takes
out the epilogue arithmetic and the TMA stores, and `stores_only` runs
the stores of the staging buffers alone (no loads, wgmmas or epilogue
arithmetic); their `no_load_no_epi` is the wgmmas with the halo's
staging, and `fewer_blocks` / `more_blocks` run one block fewer / more on
each SM (K4a's wide forms: below):
  * kernels/csrc/conv3x3_tc.cu: bfloat16 K1 (`k1_ms`) and K2 at r=4
    (`k2_ms`);
  * kernels/csrc/conv3x3_f32_tc.cu: float32 K1 as the wrapper runs it,
    split pass and conv (`k1_f32_ms`), the conv alone on split planes
    (`conv_ms`), the split pass alone (`split_ms`), and float32 K2 at r=4
    with its split pass (`k2_f32_ms`) and alone (`k2_conv_ms`); run
    against a checkout from before conv_last_f32.cu (by path, with
    PYTHONPATH at its `git archive`), also float32 conv_last as it was
    there, the split pass and K2 at r = 1, at conv_last_f32.cu's shape
    (`conv_last_f32_ms`, `conv_last_split_ms`, `conv_last_conv_ms`).  The
    weights stream tap by tap in every variant: `no_load` takes out the
    halo loads only;
  * kernels/csrc/conv3x3_s8.cu: K4 (`k4_ms`) and K4h at r=4 (`k4h_ms`);
  * kernels/csrc/conv3x3_wide.cuh (the header; conv3x3_tc.cu and
    conv3x3_f32_tc.cu are built over each variant of it): K1 at 32 and 96
    features in bfloat16 (`k1_32_ms`, `k1_96_ms`), and float32 K1 at 32,
    its conv alone as the model calls it (`k1_f32_32_conv_ms`: on split
    planes, writing its output's planes) and its split pass alone
    (`k1_f32_32_split_ms`); K2 in bfloat16 at x2 and x4 at 128 features
    and x4 at 32 (`k2_x2_128_ms`, ...) and float32 K2 at x2 at 128 on the
    split planes of its input, as the model calls it
    (`k2_f32_x2_128_planes_ms`; at 96 `k2_f32_x2_96_planes_ms`).  Its
    variants take their part out of
    the resident kernel and the streamed one alike: `no_load` (the halo
    loads after each block's first tile), `no_mma`, `no_epi`,
    `weights_only` (the weight copies alone: no halo loads after the first
    tile, no wgmmas, no epilogue; the streamed kernel's weights still
    stream each tile, the resident kernel's are one copy a block) and
    `streamed` (the three K1 forms on the streamed kernel that K1 at the
    other widths runs, whole and right: what the resident design gains)
    and `resident` (float32 K2 at x2 at 96 and 128 on the resident
    kernel, whole and right: what its streamed form gains);
  * kernels/csrc/conv3x3_s8_wide.cuh (the header; conv3x3_s8.cu is built
    over each variant of it): K4 at 32 and 128 features (`k4_32_ms`,
    `k4_128_ms`), K4h at x4 at 32 and 128 and at x2 at 128
    (`k4h_x4_32_ms`, ...), each entry point on weights packed once (the
    wrappers' per-call packing before their packs were kept is not in
    these times).  Its variants `no_load`, `no_mma` and `no_epi` (every
    accumulator still read) are anchored on texts its kernel has had since
    its first form, so they apply to a parent's kernel too; the shape
    variants (`k4_32_t2w1r8h4`: K4 at 32 on TEAMS 2 teams of TEAM_WGS 1
    warpgroup of RPW 8 rows, HS 4 halo slots; `k4_128_...` K4 at 128,
    `heads_...` K4h at x3 and x4) route forms to other shapes of the
    teams' kernel, whole and right;
  * kernels/csrc/conv3x3.cu: K3 in bfloat16 (`k3_ms`) and float32
    (`k3_f32_ms`), K4a with its conv in bfloat16 (`k4a_ms`) and float32
    (`k4a_f32_ms`), K4a's wide forms in bfloat16 at 32, 96 and 128
    features (`k4a_32_ms`, `k4a_96_ms`, `k4a_128_ms`), and K3 at Cin 12
    (R = 2) at RRDB x2's shape, the batch's 4 frames of 1920 x 1080 as a
    540 x 960 trunk (`k3x2_ms`, `k3x2_f32_ms`).  Besides the variants
    above: `no_stage` (the halo staged from the raw words for each
    block's first tile only), `loads_only` (the halo words' loads and
    their copy into the raw buffer alone: no staging, wgmmas or
    epilogue) and `no_pack` (B left as the block finds its shared
    memory: the weights' packing inside each block taken out); each
    takes its part out of the one-row kernel and of the wide K4a's row
    tiles alike.  `fewer_blocks` / `more_blocks` move every form's
    blocks on each SM, `k4a_blocks3` ... `k4a_blocks8` the wide bf16
    K4a's only (texts the kernel has had since its wide forms, so a
    parent has them too); `k4a_clip_f32` runs the wide K4a's quantize
    with the one-row forms' float32 clip; and the shape variants
    (`k4a_32_t8b5u1`: K4a at 32 on tiles of 8 rows, 5 blocks, row pairs
    unrolled) route a wide form to another shape.  These three compute
    the right result.  A swept variant that does not build (registers
    or shared memory refused) is listed under "failed" and not timed;
  * kernels/csrc/dot_probe.cu: P1 at the probe's shape in s8 and bf16 at
    0 loops (the prologue and epilogue alone), 64 and 1024 loops
    (`int8_64_ms`, ...), the calls queued behind a sleep kernel
    (perf_int8_dot.queued_ms); its variants are one warpgroup on each 64 x
    64 tile in place of two (`one_wg`: every dot in one chain) and the
    mainloop without the prologue (`no_prologue`: B not staged, A not
    loaded);
  * kernels/csrc/rrdb.cu: K7 at the RRDB trunk's shapes (a 192-channel
    buffer), in bfloat16 its forms lrelu at Cin 64 and 160, rdb, rrdb and
    add (`lrelu64_ms`, ...), in float32 lrelu at Cin 64 and rdb, each the
    conv alone on split planes (`f32_lrelu64_ms`, `f32_rdb_ms`), and the
    split pass alone over 64 and 192 channels (`f32_split64_ms`,
    `f32_split192_ms`).  Its variants: `no_load` (the halo loads after
    each block's first tile), `w_once` (the weights of each stage copied
    only for the block's first tile: what resident weights would save),
    `no_mma`, `no_epi`, and `stores_only` (no halo or weight loads after
    the first tile and no wgmmas: the epilogue with its residual loads
    and its stores alone);
  * kernels/csrc/rrdb_s8.cu: K7q at the int8 trunk's shapes (a
    192-channel s8 buffer, float32 residuals), its forms lrelu_q at Cin
    64 and 160, rdb, rrdb and add (`lrelu_q64_ms`, ...), laid out as
    apply_int8 lays them out.  Its variants: `no_load`, `no_mma`,
    `no_epi` (no residual loads, epilogue arithmetic or stores) and
    `stores_only` (the epilogue with its residual loads and stores
    alone);
  * kernels/csrc/conv_last_f32.cu: float32 conv_last at the float32 RRDB
    plan's chunk, 2 frames of 7680 x 4320 (`conv_last_f32_ms`).  Its
    variants: `no_load` (the input rows after each block's first work
    item), `no_mma` (the FMAs: each loaded 16-B vector added once, no
    weights read) and `no_epi` (the lanes' reduction, the rounding and
    the stores); and, each with its FMAs alone, every pixel group of a
    warp reading the same pixels (`fma_x_bcast`), the tap rows looped
    (`fma_dy_loop`) and 6 rows a step on 12 warps (`fma_rows6`; `rows6`
    whole);
  * kernels/csrc/conv3x3_train_tc.cu: T2 at a training step's 8 LR
    patches of 64 x 64, 64 -> 64 and 128 -> 128 (`t2_64_ms`,
    `t2_128_ms`), and T1 beside it as the kernel whose mainloop T2's
    follows (`t1_64_ms`, `t1_128_ms`; no variant patches T1), the calls
    queued behind a sleep kernel.  T2's variants: `no_mma` (its
    wgmmas), `no_epi` (PReLU', the z_prev reads, the dz_prev stores and
    the d(alpha) partials), `w_once` (the weights loaded for the first
    unit only), `no_sum` (the tile-order sum of the d(alpha) partials);
  * kernels/csrc/tta.cu: K6's three forms at the TTA path's shape (4
    frames of 1080p x4) for an even and an odd transform
    (`middle_k1f_ms`: MIDDLE at k = 1 with the flip, ...); its variants
    walk each tile's rows 4 or 1 at a time (`rows_4`, `rows_1`) where
    it walks them 2 at a time.  They compute the right result.
Each conv source's kernels share one mainloop, so a variant takes the part out
of all of them.  Run by path with PYTHONPATH at a `git archive` of a
parent, a variant none of whose texts that parent has is not built.  The
variants that take a part out compute wrong results.  They exist only here, in a temporary directory, and only their times mean
anything.
Prints one JSON line: the
card, then {source: {variant: {timing: [ms, ms]}}}, each time the mean
over `iters` launches after one untimed launch, the variants run in turn,
twice, and the swept variants that did not build.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch

from reve_tpu_torch.kernels import (build, conv3x3, conv3x3_s8, dot_probe,
                                    rrdb, train, tta)
from reve_tpu_torch.scripts import perf_int8_dot
from reve_tpu_torch.scripts.perf_int8_dot import queued_ms, time_ms

B, H, W, R = 4, 1080, 1920, 4
#: float32 conv_last's source (kernels.head.LAST_F32_SOURCE; named here so
#: that the script also runs against a checkout from before it existed)
LAST_F32_SOURCE = "conv_last_f32.cu"
_LOAD = "    if (tid == 0 && next < g.count) {"
_LOAD_WAIT = "    mbar_wait(bar + (it & 1) * 8, (it >> 1) & 1);"
_NO_LOAD = [(_LOAD, "    if (false) {"),
            (_LOAD_WAIT, "    if (it == 0) mbar_wait(bar, 0);")]
_U8_MMA = ("        mma_row<U::F32, G, C, U::NC>(\n"
           "            acc, cor, a_src + G::CIN * i * U::V, cross,\n"
           "            base + (uint32_t)(U::OFF_W + ci * U::NC * 16));\n")
_U8_EPI = ("        epilogue<T, TOut, C>(st, acc, cor, bi, al, al2, inv_s, pa, "
           "q, ci);\n")
_U8_STORE = "      if (t == 0) {\n        const uint32_t src"
_U8_STAGE = ("    stage<U::F32, G>(halo, raw, smem + U::OFF_ZEROS, table, t, "
             "cur.b, y0,\n")
#: ... the wide K4a's rows loop (conv3x3.cu's U8::ROWS forms): its
#: fetch, staging, wgmmas, epilogue and stores
_ROWS_LOAD = "      if (tile + 2 * step < count)\n"
_ROWS_STAGE = "      stage_rows<G>(halo, raw, smem + U::OFF_ZEROS, table, t, "
_ROWS_MMA = ("    Wgmma<NC>::mma(acc, a[kc], desc(w + kc * 32 * C, 16 * "
             "C));\n")
_ROWS_EPI = ("          epilogue<T, TOut, C>(st + (i + v / U::CHUNKS) * TW * C,\n"
             "                               acc[v % 2], acc[v % 2], bi, al, "
             "al2, inv_s,\n"
             "                               pa, q, v % U::CHUNKS, clip_hi, "
             "clip_lo);\n")
_ROWS_STORE = "      if (t == 0) {\n        tma_store_4d(&out_map, base, 0,"
#: ... the wide K4a's quantize: its clip on the bf16 pairs, and its
#: codes of the clipped values
_ROWS_CLIP = ("        if constexpr (U::ROWS) pr = __hmax2(__hmin2(pr, clip_hi), "
              "clip_lo);\n")
_ROWS_QUANT = ("                __float_as_uint(__fadd_rn(__fmul_rn(v[0], inv), "
               "12582912.f)),\n"
               "                __float_as_uint(__fadd_rn(__fmul_rn(v[1], inv), "
               "12582912.f)),\n")
#: ... the wide K4a's shapes (the shape variants replace them)
_ROWS_SHAPES = {f: f"struct Q8Shape<{f}> : RowShape<" for f in (32, 96, 128)}
#: source -> variant -> [(text in the source, its replacement)]
PATCHES = {
    conv3x3.TC_SOURCE: {
        "no_load": _NO_LOAD,
        "no_mma": [("    issue_mma<N>(acc, base + (it & 1) * HALO_BYTES + wg "
                    "* (TW + 2) * CIN * 2,\n                 base + "
                    "(uint32_t)C::OFF_W);\n",
                    "    for (int i = 0; i < N / 2; ++i) acc[i] = it;\n")],
        "no_epi": [("    wait_mma<N>(acc);\n",
                    "    wait_mma<N>(acc);\n    if (acc[0] == 0.5f) "
                    "*(float*)out = acc[1];\n    continue;\n")],
    },
    conv3x3.F32_SOURCE: {
        "no_load": [("      if (gi % 9 == 0 && gi > 0) {",
                     "      if (false) {"),
                    ("    mbar_wait(halo_full, (uint32_t)(it & 1));",
                     "    if (it == 0) mbar_wait(halo_full, 0);")],
        "no_mma": [("        mma_bf16x6<N>(acc, cor, a + kc * 32, ws + 2 * kc "
                    "* N * 16);\n", "        acc[kc] += a;\n")],
        "no_epi": [("    // accumulator fragment: register",
                    "    if (acc[0] == 0.5f) *(float*)out = cor[1];\n"
                    "    continue;\n    // accumulator fragment: register")],
    },
    conv3x3_s8.SOURCE: {
        "no_load": _NO_LOAD,
        "no_mma": [("    issue_mma<N>(acc, base + (it & 1) * HALO_BYTES + wg "
                    "* (TW + 2) * C,\n                 base + "
                    "(uint32_t)S::OFF_W);\n",
                    "    for (int i = 0; i < N / 2; ++i) acc[i] = it;\n")],
        "no_epi": [("    wait_mma<N>(acc);\n",
                    "    wait_mma<N>(acc);\n    if (acc[0] == 5) "
                    "*(int8_t*)out = (int8_t)acc[1];\n    continue;\n")],
        # K4h at K4's two blocks on each SM, not three
        "two_blocks": [("  static constexpr int BLOCKS = R == 0 ? 2 : 3;",
                        "  static constexpr int BLOCKS = 2;")],
    },
    conv3x3.SOURCE: {
        "no_load": [("      if (i == 0 && tile + 2 * step < count)\n",
                     "      if (false)\n"),
                    (_ROWS_LOAD, "      if (false)\n")],
        "no_stage": [(_U8_STAGE, "    if (it == 0)\n" + _U8_STAGE),
                     (_ROWS_STAGE,
                      "      if (tile == blockIdx.x)\n" + _ROWS_STAGE)],
        "no_mma": [(_U8_MMA, "        for (int j = 0; j < U::NC / 2; ++j) "
                    "acc[j] = cor[j] = it;\n"),
                   (_ROWS_MMA, "    acc[kc] += (float)a[kc][0];\n")],
        "no_epi": [(_U8_EPI, "        if (acc[0] == 0.5f) smem[0] = 1;\n"),
                   (_U8_STORE,
                    "      if (false) {\n        const uint32_t src"),
                   (_ROWS_EPI, "          if (acc[v % 2][0] == 0.5f) "
                    "smem[0] = 1;\n"),
                   (_ROWS_STORE, _ROWS_STORE.replace("(t == 0)", "(false)"))],
    },
}
# The blocks on each SM, anchored on where the kernel's launch bounds and
# its grid read U8's count (texts that the kernel has had since the wide
# forms): every form at one block fewer and one more than it runs, and
# the bf16 K4a at 32, 96 and 128 features (its Q8 forms whose staged row
# is not 64 channels) at 3 to 8 blocks, the other forms as they run
_U8_BOUNDS = "U8<T, TOut, R, C>::BLOCKS)"
_U8_GRID = "                              U::BLOCKS);"


def _u8_blocks(n: str, wide_k4a_only: bool) -> list:
    """Patches that run the forms at `n` blocks on each SM (a C
    expression of U, U8's instantiation)."""
    pick = (f"U::Q8 && !U::F32 && U::OUT_BYTES != TW * 64 ? {n} : U::BLOCKS"
            if wide_k4a_only else n)
    return [("struct Walk {",
             "template <class U>\nstruct KBlocks {\n  static constexpr int N "
             f"= {pick};\n}};\nstruct Walk {{"),
            (_U8_BOUNDS, "KBlocks<U8<T, TOut, R, C>>::N)"),
            (_U8_GRID, "                              KBlocks<U>::N);")]


PATCHES[conv3x3.SOURCE]["fewer_blocks"] = _u8_blocks("U::BLOCKS - 1", False)
PATCHES[conv3x3.SOURCE]["more_blocks"] = _u8_blocks("U::BLOCKS + 1", False)
for _n in range(3, 9):
    PATCHES[conv3x3.SOURCE][f"k4a_blocks{_n}"] = _u8_blocks(str(_n), True)
# the weights not packed: each block's B as it finds its shared memory
# (what packing them once per set of weights could save)
PATCHES[conv3x3.SOURCE]["no_pack"] = [
    ("  pack_weights<T, G, C>(reinterpret_cast<bf16*>(smem + U::OFF_W), w, "
     "t);\n", "")]
PATCHES[conv3x3.SOURCE]["stores_only"] = (
    PATCHES[conv3x3.SOURCE]["no_load"] + PATCHES[conv3x3.SOURCE]["no_mma"]
    + [(_U8_EPI, ""), (_ROWS_EPI, "")])
# the wide K4a's quantize as the one-row forms run it: the float32 clip
# of quant_bits, none on the bf16 pairs (whole and right)
PATCHES[conv3x3.SOURCE]["k4a_clip_f32"] = [
    (_ROWS_CLIP, ""),
    (_ROWS_QUANT, "                reve::quant_bits(v[0], inv),\n"
                  "                reve::quant_bits(v[1], inv),\n")]
# the wide K4a's shapes (TH rows a tile, blocks on each SM, row pairs
# unrolled or looped), whole and right: `k4a_32_t8b5u1` runs K4a at 32
# on RowShape<8, 5, 1> (the shape there before left in an unused struct)
_ROWS_SWEEP = {32: ("8, 5, 0", "8, 4, 1", "8, 6, 1", "6, 5, 1", "4, 6, 1"),
               96: ("4, 4, 0", "6, 3, 1", "4, 3, 1", "4, 5, 1"),
               128: ("6, 3, 1", "8, 2, 0", "4, 3, 0", "6, 2, 0")}
for _f, _shapes in _ROWS_SWEEP.items():
    for _sh in _shapes:
        _th, _b, _u = _sh.split(", ")
        PATCHES[conv3x3.SOURCE][f"k4a_{_f}_t{_th}b{_b}u{_u}"] = [(
            _ROWS_SHAPES[_f], _ROWS_SHAPES[_f] + _sh + "> {};\nstruct Was"
            f"{_f} : RowShape<")]
PATCHES[conv3x3.SOURCE]["loads_only"] = (
    PATCHES[conv3x3.SOURCE]["no_stage"] + PATCHES[conv3x3.SOURCE]["no_mma"]
    + PATCHES[conv3x3.SOURCE]["no_epi"])
# K7
_K7_FIRST = "tile == blockIdx.x"
_K7_HALO = ("          mbar_expect_tx(halo_full + 8 * hs, K::PLANES * "
            "HALO_TX);\n          for (int q = 0; q < K::PLANES; ++q)\n")
_K7_W = ("            mbar_expect_tx(w_full + 8 * ws, K::W_STAGE);\n"
         "            bulk_load(")
_K7_MMA = ("mma_step<F32, N>(acc[s], cor[s], a + kc * 32,\n"
           "                                 wt + 2 * kc * N * 16);")
#: the float32 Cout-32 wgmmas (A in registers)
_K7_MMA_REGS = ("            mma_step_regs<N>(acc[0], cor[0], af[tl],\n"
                "                             wst + tl * K::TAP_BYTES);\n")
_K7_EPI = "    // the epilogue: accumulator fragment register 4j + 2h + e"
PATCHES[rrdb.SOURCE] = {
    "no_load": [(_K7_HALO, _K7_HALO
                 .replace("K::PLANES * HALO_TX", f"{_K7_FIRST} ? K::PLANES * "
                          "HALO_TX : 0")
                 .replace("q < K::PLANES", f"q < ({_K7_FIRST} ? K::PLANES : "
                          "0)"))],
    "w_once": [(_K7_W, _K7_W
                .replace("K::W_STAGE)", f"{_K7_FIRST} ? K::W_STAGE : 0)")
                .replace("bulk_load(", f"if ({_K7_FIRST}) bulk_load("))],
    "no_mma": [(_K7_MMA, "acc[s][kc] += a;"),
               (_K7_MMA_REGS, "            acc[0][tl] += af[tl][0][0];\n")],
    # (every accumulator set stays live, or ptxas drops the wgmmas that
    # write it; the residual the producer loaded is waited on, so that no
    # copy is in flight when the block exits)
    "no_epi": [(_K7_EPI,
                "    if (has_res) mbar_wait(res_full, (uint32_t)(k & 1));\n"
                "    if (acc[0][0] + acc[RPW - 1][1] == 0.5f)\n"
                "      *(float*)out = cor[0][1] + cor[RPW - 1][0];\n"
                "    continue;\n" + _K7_EPI)],
}
PATCHES[rrdb.SOURCE]["stores_only"] = [
    *PATCHES[rrdb.SOURCE]["no_load"], *PATCHES[rrdb.SOURCE]["w_once"],
    *PATCHES[rrdb.SOURCE]["no_mma"]]
# K7q
_K7Q_HALO = ("          mbar_expect_tx(halo_full + 8 * hs, K::HALO_TX);\n"
             "          tma_load_4d(")
_K7Q_MMA = "        WgmmaS8<N>::mma(acc[s], desc_sw64(a), desc(bw, N * 16));"
_K7Q_EPI = ("    // The epilogue: accumulator register 4j + 2h + e holds pixel "
            "p0 + 8h,\n")
PATCHES[rrdb.S8_SOURCE] = {
    "no_load": [(_K7Q_HALO, _K7Q_HALO
                 .replace("K::HALO_TX)", f"{_K7_FIRST} ? K::HALO_TX : 0)")
                 .replace("tma_load_4d(", f"if ({_K7_FIRST}) tma_load_4d("))],
    "no_mma": [(_K7Q_MMA, "        acc[s][kc] += a;")],
    # no residual loads, arithmetic or stores: the staging thread idles
    # (every accumulator read, or ptxas drops the wgmmas that write it)
    "no_epi": [(_K7Q_EPI,
                "    int sum = 0;\n    for (int s = 0; s < RPW; ++s)\n"
                "      for (int i = 0; i < N / 2; ++i) sum += acc[s][i];\n"
                "    if (sum == 0x7654321) ps[0] = 1.f;\n"
                "    continue;\n" + _K7Q_EPI),
               ("    } else if (role == 2) {",
                "    } else if (role == 2 && false) {")],
}
PATCHES[rrdb.S8_SOURCE]["stores_only"] = [
    *PATCHES[rrdb.S8_SOURCE]["no_load"], *PATCHES[rrdb.S8_SOURCE]["no_mma"]]
# float32 conv_last: the rows after each block's first item not loaded,
# the FMAs replaced by one add a loaded vector, the epilogue (reduction,
# rounding, stores) replaced by a read of every accumulator
_LAST_FMA = ("          fma_row(acc, rows[dy] + 32 * hf,\n"
             "                  ws + (hf * 3 + dy) * 9 * 32 + 4 * q);\n")
_LAST_EPI = "      // The epilogue: reduce the 8 lanes' partial sums"
PATCHES[LAST_F32_SOURCE] = {
    "no_load": [("        if (iy >= 0 && iy < H) {",
                 "        if (iy >= 0 && iy < H && item == blockIdx.x) {")],
    "no_mma": [(_LAST_FMA,
                "          for (int j = 0; j < P + 2; ++j)\n"
                "            acc[j % P][hf] += reinterpret_cast<const float4*>"
                "(\n                rows[dy] + 32 * hf + j * CIN)->x;\n")],
    "no_epi": [(_LAST_EPI,
                "      float sum = 0.f;\n      for (int j = 0; j < P; ++j)\n"
                "        for (int c = 0; c < COUT; ++c) sum += acc[j][c];\n"
                "      if (sum == 0.5f) out[0] = 1;\n      continue;\n"
                + _LAST_EPI)],
}
for _p in PATCHES.values():
    _p["full"] = []
    _p["no_load_no_epi"] = _p["no_load"] + _p["no_epi"]
    _p["no_mma_no_epi"] = _p["no_mma"] + _p["no_epi"]
# what holds float32 conv_last's FMAs (alone: `fma_*`, no loads after the
# first item, no epilogue) below the card's float32 rate: every pixel
# group of a warp reading the same pixels (shared-memory bandwidth), the
# tap rows looped and not unrolled (the instruction cache), 6 rows a
# step on 12 warps (more warps a scheduler; `rows6` also in full)
_LAST_PASSES = ("#pragma unroll\n      for (int dy = 0; dy < 3; ++dy)\n"
                "#pragma unroll\n        for (int hf = 0; hf < 2; ++hf)\n")
_LAST_ROWS6 = [("constexpr int ROWS = 4;", "constexpr int ROWS = 6;"),
               ("constexpr int SEG = 64;", "constexpr int SEG = 66;")]
_LAST_ALONE = PATCHES[LAST_F32_SOURCE]["no_load_no_epi"]
PATCHES[LAST_F32_SOURCE].update({
    "fma_x_bcast": [("                   px0 * CIN + 4 * q;",
                     "                   half * 32 * CIN + 4 * q;"),
                    *_LAST_ALONE],
    # (the row pointer by a select: rows[dy] would go to local memory)
    "fma_dy_loop": [(_LAST_PASSES + _LAST_FMA, _LAST_PASSES.replace(
        "#pragma unroll\n      for (int dy", "#pragma unroll 1\n      for "
        "(int dy") + _LAST_FMA.replace(
            "rows[dy]", "(dy == 0 ? rows[0] : dy == 1 ? rows[1] : rows[2])")),
        *_LAST_ALONE],
    "rows6": _LAST_ROWS6,
    "fma_rows6": [*_LAST_ROWS6, *_LAST_ALONE]})
PATCHES[dot_probe.SOURCE] = {
    "full": [],
    "one_wg": [("constexpr int WGS = 2;", "constexpr int WGS = 1;")],
    "no_prologue": [
        ("  for (int h = 0; h < 2; ++h)\n    stage_half",
         "  for (int h = 0; h < 0; ++h)\n    stage_half"),
        ("      a[s][r] = __ldg(reinterpret_cast<const uint32_t*>(\n"
         "          xr + (r & 1) * 8 * KB + 32 * s + 16 * (r >> 1)));\n",
         "      a[s][r] = (uint32_t)(size_t)xr + 32 * s + r;\n")],
}
_K6_ROWS = "constexpr int ROWS_PER_PASS = 2;"
PATCHES[tta.SOURCE] = {
    "full": [],
    "rows_4": [(_K6_ROWS, _K6_ROWS.replace("2", "4"))],
    "rows_1": [(_K6_ROWS, _K6_ROWS.replace("2", "1"))],
}
#: K6's transforms in the timer: an even one and an odd one (a transpose)
# T2
PATCHES[train.SOURCE] = {
    "no_mma": [("      mma_bf16x6<NB>(acc, cor, a + 32 * s, C::A_PLANE, wb + 2 * s "
                "* NB * 16,\n                     C::W_PLANE, FwdMma<NB, "
                "false>());\n", "      acc[s] += 1.f;\n")],
    "no_epi": [("  const int oy = y0 + wg, lane = t & 31, warp = t >> 5;\n",
                "  if (acc[0] == 0.5f && cor[0] == 0.25f) part[t] = acc[1] "
                "+ cor[1];\n  return;\n  const int oy = y0 + wg, lane = t & "
                "31, warp = t >> 5;\n")],
    "w_once": [("    load_wt<C, CIN, COUT>(w, u + 1 < C::UNITS ? u + 1 : u, n0, "
                "t, wv);\n", "")],
    "no_sum": [("    return sum_parts<8>(part, dalpha, (int)tiles, CIN, st);\n",
                "    return cudaSuccess;\n")],
    "full": [],
}
# conv3x3_wide.cuh: the resident kernel (K1 at bf16 32 and 96 and float32
# 32; K2 where its weights fit) and the streamed one (the other forms),
# each variant taking its part out of both
WIDE = "conv3x3_wide.cuh"
_RES_LOAD = ("        if (gh >= HS) mbar_wait(h_empty + 8 * hs, (gh / HS - 1) & "
             "1);\n")
_RES_WAIT = "      mbar_wait(h_full + 8 * hs, (gh / HS) & 1);\n"
_RES_MMA = ("          mma_step<K>(acc[s], cor[s],\n"
            "                      a_rows + ((s + tap / 3) * (TW + 2) + tap % "
            "3) * CK * 2 +\n"
            "                          kc * 32,\n"
            "                      wu + tap * K::TAP_BYTES + 2 * kc * K::N * "
            "16);\n")
#: ... with A in registers
_RES_MMA_REGS = "res_step_regs<K>(acc[s], cor[s], af[h][s][kc],\n"
_RES_EPI = ("    // accumulator fragment: register 4j + 2h + e of row s holds "
            "pixel\n")
#: ... the streamed kernel's: its producer's halo wait and the copies'
#: end (the weight copies follow), its warpgroups' halo wait, a k16
#: step's wgmmas and the epilogue
_WIDE_LOAD = ("        if (hu >= K::SLOTS)\n"
              "          mbar_wait(h_empty + 8 * hs, ((hu >> 1) - 1) & 1);\n")
_WIDE_LOADED = ("q * B + b);\n"
                "        for (int tap = 0; tap < 9; ++tap, ++gi) {\n")
_WIDE_WAIT = "      mbar_wait(h_full + 8 * hs, (hu >> 1) & 1);\n"
_WIDE_MMA = ("          mma_step<K>(acc, cor, a + kc * 32, ws + 2 * kc * N * "
             "16);\n")
#: ... the float32 K2's k16 steps with A in registers, in the streamed
#: kernel and the resident one, which a checkout from before them does
#: not have
_WIDE_MMA_REGS = ("res_step_regs<K>(acc, cor, af[kc], ws + 2 * kc * K::N * "
                  "16);")
_HEAD_MMA_REGS = "res_step_regs<K>(acc[s], cor[s], af[kc][s],\n"
#: ... which K2 forms run resident
_HEAD_RESIDENT = "  return PLANES == 1 || CIN == 32;\n"
#: texts a variant replaces where the source has them: an older checkout
#: (a parent timed by path) may not; the current sources have each once
OPTIONAL = {_WIDE_MMA_REGS, _HEAD_MMA_REGS, _HEAD_RESIDENT}
_WIDE_EPI = "    // accumulator fragment: register 4j + 2h + e holds pixel\n"
PATCHES[WIDE] = {
    "full": [],
    # the producer neither loads nor waits past the first tile (waits on
    # slots the teams no longer pace could alias phases); the streamed
    # kernel's weights still stream
    "no_load": [(_RES_LOAD, "        if (gh >= UNITS) continue;\n" + _RES_LOAD),
                (_RES_WAIT, "      if (gh < UNITS)\n" + _RES_WAIT),
                (_WIDE_LOAD, "        if (hu < UNITS) {\n" + _WIDE_LOAD),
                (_WIDE_LOADED, _WIDE_LOADED.replace("\n", "\n        }\n",
                                                    1)),
                (_WIDE_WAIT, "      if (hu < UNITS)\n" + _WIDE_WAIT)],
    "no_mma": [(_RES_MMA, "          acc[s][kc] += a_rows;\n"),
               (_RES_MMA_REGS, "acc[s][kc] += af[h][s][kc][0][0] + (\n"),
               (_WIDE_MMA, "          acc[kc] += a;\n"),
               (_WIDE_MMA_REGS, "acc[kc] += af[kc][0][0];"),
               (_HEAD_MMA_REGS, "acc[s][kc] += af[kc][s][0][0] + (\n")],
    # every accumulator set read, so that ptxas keeps the wgmmas
    "no_epi": [(_RES_EPI,
                "    float keep = 0.f;\n"
                "    for (int s = 0; s < RPW; ++s) keep += acc[s][0] + "
                "cor[s][0];\n"
                "    if (keep == 0.5f && out) *(float*)out = keep;\n"
                "    continue;\n" + _RES_EPI),
               (_WIDE_EPI,
                "    if (acc[0] + cor[0] == 0.5f && out) *(float*)out = "
                "acc[0];\n"
                "    continue;\n" + _WIDE_EPI)],
}
PATCHES[WIDE]["weights_only"] = [*PATCHES[WIDE]["no_load"],
                                 *PATCHES[WIDE]["no_mma"],
                                 *PATCHES[WIDE]["no_epi"]]
# the resident forms routed to the streamed kernel (planes out in
# float32), whole: what the resident design gains over it
PATCHES[WIDE]["streamed"] = [(
    "  return launch_res<PLANES, CIN, ResShape<PLANES, CIN>>(x, w, b, alpha, "
    "y,\n",
    "  return launch<PLANES, CIN, 0>(x, w, b, alpha, nullptr, y, B, H, W, s,\n"
    "                                planes);\n"
    "  return launch_res<PLANES, CIN, ResShape<PLANES, CIN>>(x, w, b, alpha, "
    "y,\n")]
# float32 K2 at x2 at 96 and 128 routed to the resident kernel (2-row
# tiles), whole: what its streamed form (4-row tiles) gains (not built
# for a checkout from before the resident K2)
PATCHES[WIDE]["resident"] = [(
    _HEAD_RESIDENT, "  return PLANES == 1 || CIN == 32 || R == 2;\n")]
# conv3x3_s8_wide.cuh: the wide K4 and K4h.  Each part is anchored on a
# text its kernel has had since its first form (a parent timed by path
# has it too); the shape variants route forms to other shapes of the
# teams' kernel
S8_WIDE = "conv3x3_s8_wide.cuh"
_S8_CK = ("constexpr int CK = 32;  // input channels of a unit: one 32-B "
          "halo row\n")
#: the variants' stand-ins: a "wgmma" that adds its operands' descriptors
#: to the accumulators, and a read of every accumulator set
_S8_PARTS = (
    "template <int M>\n"
    "__device__ __forceinline__ void no_mma(int (&acc)[M], uint64_t a, "
    "uint64_t b) {\n"
    "  acc[0] += (int)(a ^ b);\n"
    "}\n"
    "template <int M>\n"
    "__device__ __forceinline__ int keep(int (&acc)[M]) { return acc[0]; }\n"
    "template <int S, int M>\n"
    "__device__ __forceinline__ int keep(int (&acc)[S][M]) {\n"
    "  int k = 0;\n"
    "  for (int s = 0; s < S; ++s) k += acc[s][0];\n"
    "  return k;\n"
    "}\n")
_S8_LOAD = "      for (int u = 0; u < UNITS; ++u, ++hu) {\n"
_S8_WAIT = "      mbar_wait(h_full + 8 * hs, (hu "
_S8_EPI = "    // accumulator fragment: register 4j + 2h + e holds pixel\n"
#: the shapes the shape variants replace (texts of the teams' kernel only)
_S8_K4_32 = "struct S8Shape<32, 0> : Shape<"
_S8_K4_128 = "struct S8Shape<128, 0> : Shape<"
_S8_HEADS = "struct S8Shape : Shape<"
#: ... K4's epilogue: its parameters in registers at 32, its quantize in
#: float32 arithmetic
_S8_PJ = "  constexpr int PJ = R > 0 || N <= 32 ? N / 8 : 1;\n"
_S8_QUANT = "quant_bits(v0, inv), quant_bits(v1, inv)"
OPTIONAL |= {_S8_K4_32, _S8_K4_128, _S8_HEADS, _S8_PJ, _S8_QUANT}
OPTIONAL |= {_ROWS_LOAD, _ROWS_STAGE, _ROWS_MMA, _ROWS_EPI, _ROWS_STORE,
             _ROWS_CLIP, _ROWS_QUANT,
             *_ROWS_SHAPES.values()}


def _s8_shape(anchor: str, shape: str, name: str) -> tuple:
    """A patch that gives the forms at `anchor` the shape `shape` (the
    shape there before is left in an unused struct `name`)."""
    return (anchor, anchor + shape + "> {};\nstruct " + name + " : Shape<")


PATCHES[S8_WIDE] = {
    "full": [],
    # the producer neither loads nor waits past each block's first tile
    "no_load": [(_S8_LOAD, _S8_LOAD + "        if (hu >= UNITS) continue;\n"),
                (_S8_WAIT, "      if (hu < UNITS) mbar_wait(h_full + 8 * hs, "
                           "(hu ")],
    "no_mma": [(_S8_CK, _S8_CK + _S8_PARTS),
               ("WgmmaS8<N>::mma(", "no_mma(")],
    # every accumulator set read, so that ptxas keeps the wgmmas
    "no_epi": [(_S8_CK, _S8_CK + _S8_PARTS),
               (_S8_EPI, "    if (keep(acc) == 12345 && out) *(int*)out = "
                         "0;\n    continue;\n" + _S8_EPI)],
    # the epilogues as they were first written: K4's and K4h's parameters
    # read from shared memory, K4's quantize as reve::quant_s8's
    # conversion
    "params_smem": [(_S8_PJ, "  constexpr int PJ = 1;\n")],
    "k4_quant_cvt": [(_S8_QUANT,
                      "reve::quant_s8(v0, inv), reve::quant_s8(v1, inv)")],
    # K4 at 32: teams (TEAMS, TEAM_WGS, RPW, HS)
    "k4_32_t2w2r2h6": [_s8_shape(_S8_K4_32, "2, 2, 2, 6", "Was32")],
    "k4_32_t3w2r2h6": [_s8_shape(_S8_K4_32, "3, 2, 2, 6", "Was32")],
    "k4_32_t4w1r2h6": [_s8_shape(_S8_K4_32, "4, 1, 2, 6", "Was32")],
    "k4_32_t2w2r4h3": [_s8_shape(_S8_K4_32, "2, 2, 4, 3", "Was32")],
    "k4_32_t2w2r4h4": [_s8_shape(_S8_K4_32, "2, 2, 4, 4", "Was32")],
    "k4_32_t2w2r4h6": [_s8_shape(_S8_K4_32, "2, 2, 4, 6", "Was32")],
    "k4_32_t2w1r4h6": [_s8_shape(_S8_K4_32, "2, 1, 4, 6", "Was32")],
    "k4_32_t2w1r8h4": [_s8_shape(_S8_K4_32, "2, 1, 8, 4", "Was32")],
    "k4_32_t2w1r8h6": [_s8_shape(_S8_K4_32, "2, 1, 8, 6", "Was32")],
    # K4 at 128: the parent's shape (one team of four warpgroups of a row,
    # two slots) on the teams' kernel
    "k4_128_t1w4r1h2": [_s8_shape(_S8_K4_128, "1, 4, 1, 2", "Was128")],
    "k4_128_t2w1r2h3": [_s8_shape(_S8_K4_128, "2, 1, 2, 3", "Was128")],
    "k4_128_t3w1r1h4": [_s8_shape(_S8_K4_128, "3, 1, 1, 4", "Was128")],
    "k4_128_t4w1r1h4": [_s8_shape(_S8_K4_128, "4, 1, 1, 4", "Was128")],
    # K4h at x3 and x4 (x2 has its own)
    "heads_t2w2r1h4": [_s8_shape(_S8_HEADS, "2, 2, 1, 4", "WasHeads")],
    "heads_t4w1r2h4": [_s8_shape(_S8_HEADS, "4, 1, 2, 4", "WasHeads")],
    "heads_t2w1r4h4": [_s8_shape(_S8_HEADS, "2, 1, 4, 4", "WasHeads")],
}
#: the sources built over each variant of a header
_HEADER_USERS = {WIDE: (conv3x3.TC_SOURCE, conv3x3.F32_SOURCE),
                 S8_WIDE: (conv3x3_s8.SOURCE,)}
_K6_SPECS = ((2, False), (1, True))
#: P1's loop counts: the prologue and epilogue alone, the probe's, the
#: slope's
_DOT_LOOPS = (0, 64, 1024)


#: "source variant" -> the end of nvcc's output, of the swept variants
#: that did not build
FAILED = {}


def variant_source(source: str, variant: str, strict: bool = False) -> str:
    """The text of `source` with `variant`'s parts taken out (`strict`:
    the OPTIONAL texts too, each once)."""
    with open(os.path.join(build.CSRC, source)) as f:
        text = f.read()
    for old, new in PATCHES[source][variant]:
        if not strict and old in OPTIONAL and old not in text:
            continue
        if text.count(old) != 1:
            raise RuntimeError(f"{source} {variant}: the source no longer "
                               f"has the text this variant replaces")
        text = text.replace(old, new)
    return text


def build_variants(tmp: str, sources=None, variants=None) -> dict:
    """{(source, variant): loaded library} of `sources` (default: all)
    and `variants` (default: all; `full` always), all compiled at once."""
    procs = {}
    for source in sources or PATCHES:
        for variant in PATCHES[source]:
            if variants and variant != "full" and variant not in variants:
                continue
            text = variant_source(source, variant)
            if variant != "full" and text == variant_source(source, "full"):
                continue  # none of its texts in an older checkout
            stem = f"{os.path.splitext(source)[0]}-{variant}"
            if source in _HEADER_USERS:
                # the patched header beside copies of the sources that
                # include it, which find it first
                vdir = os.path.join(tmp, stem)
                os.makedirs(vdir)
                with open(os.path.join(vdir, source), "w") as f:
                    f.write(text)
                for user in _HEADER_USERS[source]:
                    shutil.copy(os.path.join(build.CSRC, user), vdir)
                    so = os.path.join(vdir, f"lib{user[:-3]}.so")
                    procs[source, variant, user] = (so, subprocess.Popen(
                        [build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                         build.CSRC, "-o", so, os.path.join(vdir, user)],
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True))
                continue
            cu = os.path.join(tmp, f"{stem}.cu")
            with open(cu, "w") as f:
                f.write(text)
            so = os.path.join(tmp, f"lib{stem}.so")
            procs[source, variant] = (so, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC,
                 "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode and key[1].startswith("k4a_"):
            # a swept count or shape of the wide K4a that its registers or
            # shared memory refuse: reported (FAILED), not timed
            FAILED[f"{key[0]} {key[1]}"] = log[-2000:]
            continue
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc exited {proc.returncode}\n{log}")
        if key[0] in _HEADER_USERS:
            # {user source: library} of the header's variant
            libs.setdefault(key[:2], {})[key[2]] = ctypes.CDLL(so)
        else:
            libs[key] = ctypes.CDLL(so)
    return libs


def _entry(lib, name: str, argtypes) -> ctypes._CFuncPtr:
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


#: K7's timed forms: (name, Cin, Cout, epilogue)
_K7_FORMS = (("lrelu64", 64, 32, "lrelu"), ("lrelu160", 160, 32, "lrelu"),
             ("rdb", 192, 64, "rdb"), ("rrdb", 192, 64, "rrdb"),
             ("add", 64, 64, "add"))
_K7_F32_FORMS = (("lrelu64", 64, 32, "lrelu"), ("rdb", 192, 64, "rdb"))


def _k7_operands(rs, dev) -> dict:
    """K7's operands at the trunk's shapes, in both dtypes: the
    192-channel buffer a dense block reads, the other one conv 5 writes,
    feat, the float32 buffer's split planes, the weights of each form
    packed once."""
    cs = 192
    ops = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        buf = (torch.rand((B, H, W, cs), device=dev) * 2 - 1).to(dt)
        ops[name] = {"buf": buf, "other": torch.zeros_like(buf),
                     "feat": buf[..., :64].contiguous(), "w": {}}
        for _f, cin, cout, _e in _K7_FORMS:
            w = torch.from_numpy(rs.uniform(-1, 1, (3, 3, cin, cout)).astype(
                np.float32) * 0.1 / np.sqrt(9 * cin)).to(dev, dt)
            ops[name]["w"][cin, cout] = rrdb.pack_weights_dense(w)
    f = ops["f32"]
    f["planes"] = conv3x3.split_bf16x3(f["buf"])
    f["out_planes"] = torch.zeros_like(f["planes"])
    ops["b"] = torch.zeros(64, device=dev)
    return ops


def _k7_timings(lib, name: str, ops: dict, stream) -> dict:
    """{timing: callable} of K7's forms for one variant's library (float32
    reads the planes of the whole buffer and writes the planes of what it
    writes)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    bf = _entry(lib, "reve_dense_conv_tc", [P] * 6 + [I] * 10 + [P])
    f32 = _entry(lib, "reve_dense_conv_f32tc_planes",
                 [P] * 7 + [I] * 11 + [P])
    bb = ops["b"].data_ptr()

    def operands(o, cin, epi):
        """(out tensor, out channel offset, res, res2) as the model lays
        them out."""
        if epi == "lrelu":
            return o["buf"], cin, None, None
        if epi == "add":
            return o["feat"], 0, o["feat"], None
        return o["other"], 0, o["buf"], o["other"] if epi == "rrdb" else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    def px(t):
        return 0 if t is None else t.shape[3]

    def run_bf16(cin, cout, epi):
        o = ops["bf16"]
        out, off, res, res2 = operands(o, cin, epi)
        wp = o["w"][cin, cout]
        return lambda: build.check(lib, bf(
            o["buf"].data_ptr(), wp.data_ptr(), bb, ptr(res), ptr(res2),
            out.data_ptr() + off * 2, B, H, W, cin, 192, cout, px(res),
            px(res2), out.shape[3], rrdb.EPILOGUES.index(epi), stream), name)

    def run_f32(cin, cout, epi):
        o = ops["f32"]
        out, off, res, res2 = operands(o, cin, epi)
        wp = o["w"][cin, cout]
        op = o["out_planes"]
        return lambda: build.check(lib, f32(
            o["planes"].data_ptr(), wp.data_ptr(), bb, ptr(res), ptr(res2),
            out.data_ptr() + off * 4, op.data_ptr() + off * 2, B, H, W, cin,
            192, cout, px(res), px(res2), out.shape[3], op.shape[4],
            rrdb.EPILOGUES.index(epi), stream), name)

    def run_split(cin):
        x = ops["f32"]["buf"][..., :cin]
        return lambda: conv3x3.split_bf16x3(x)

    t = {f"{f}_ms": run_bf16(cin, cout, epi)
         for f, cin, cout, epi in _K7_FORMS}
    t.update({f"f32_{f}_ms": run_f32(cin, cout, epi)
              for f, cin, cout, epi in _K7_F32_FORMS})
    t.update({f"f32_split{cin}_ms": run_split(cin) for cin in (64, 192)})
    return t


#: K7q's timed forms: (name, Cin, Cout, epilogue), at the model's path
_K7Q_FORMS = (("lrelu_q64", 64, 32, "lrelu_q"),
              ("lrelu_q160", 160, 32, "lrelu_q"), ("rdb", 192, 64, "rdb"),
              ("rrdb", 192, 64, "rrdb"), ("add", 64, 64, "add"))


#: the widths of K4a's wide forms timed (bfloat16 weights, as the int8
#: engine runs them)
U8_WIDE = (32, 96, 128)


def _u8_wide_operands(rs, dev) -> dict:
    """{feat: the bf16 weights (3, 3, 3, feat) as the wrapper hands them
    to the kernel (packed once where it takes them packed,
    conv3x3.packs_u8conv; HWIO for a checkout whose kernel packs them
    itself), bias, alpha and the s8 output} of K4a at each of U8_WIDE."""
    ops = {}
    for feat in U8_WIDE:
        w = torch.from_numpy(rs.uniform(-0.19, 0.19, (3, 3, 3, feat)).astype(
            np.float32)).to(dev, torch.bfloat16)
        if getattr(conv3x3, "packs_u8conv", lambda w, q8: False)(w, True):
            w = conv3x3.packed_u8conv(w)
        ops[feat] = {
            "w": w,
            "b": torch.from_numpy(rs.uniform(-0.1, 0.1, feat).astype(
                np.float32)).to(dev),
            "a": torch.from_numpy(rs.uniform(0.05, 0.4, feat).astype(
                np.float32)).to(dev),
            "y": torch.empty((B, H, W, feat), dtype=torch.int8, device=dev)}
    return ops


#: the wide K1 forms timed: (timing, width, dtype)
_WIDE_FORMS = (("k1_32_ms", 32, "bf16"), ("k1_96_ms", 96, "bf16"),
               ("k1_f32_32", 32, "f32"))
#: the wide K2 forms timed: (timing, width, scale, dtype); float32 as the
#: model calls it, on the split planes of its input
_WIDE_HEADS = (("k2_x2_128_ms", 128, 2, "bf16"),
               ("k2_x4_128_ms", 128, 4, "bf16"),
               ("k2_x4_32_ms", 32, 4, "bf16"),
               ("k2_f32_x2_128_planes_ms", 128, 2, "f32"),
               ("k2_f32_x2_96_planes_ms", 96, 2, "f32"))


def _wide_operands(rs, dev) -> dict:
    """The wide K1 and K2 forms' operands at the main path's shape: the
    input (and in float32 its split planes, made once), the weights
    packed once, the outputs (K2's: its u8 frames too)."""
    ops = {}
    for timing, feat, dt in _WIDE_FORMS:
        xf = torch.from_numpy(rs.rand(B, H, W, feat).astype(np.float32)
                              - 0.3).to(dev)
        wf = torch.from_numpy(rs.uniform(-1, 1, (3, 3, feat, feat)).astype(
            np.float32) / np.sqrt(9 * feat)).to(dev)
        o = {"b": torch.zeros(feat, device=dev),
             "alpha": torch.full((feat,), 0.2, device=dev)}
        if dt == "bf16":
            o["x"] = xf.to(torch.bfloat16)
            o["w"] = conv3x3.pack_weights_wide(wf.to(torch.bfloat16))
            o["y"] = torch.empty_like(o["x"])
        else:
            o["xf"] = xf
            o["x"] = conv3x3.split_bf16x3(xf)
            o["w"] = conv3x3.pack_weights_wide(wf)
            o["y_planes"] = torch.empty_like(o["x"])
        ops[timing] = o
    u8 = torch.from_numpy(rs.randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)).to(dev)
    for timing, feat, r, dt in _WIDE_HEADS:
        xf = torch.from_numpy(rs.rand(B, H, W, feat).astype(np.float32)
                              - 0.3).to(dev)
        wf = torch.from_numpy(rs.uniform(-1, 1, (3, 3, feat, 3 * r * r))
                              .astype(np.float32) / np.sqrt(9 * feat)).to(
                                  dev)
        bf16 = dt == "bf16"
        ops[timing] = {
            "x": xf.to(torch.bfloat16) if bf16 else conv3x3.split_bf16x3(xf),
            "w": conv3x3.pack_weights_wide(wf.to(torch.bfloat16) if bf16
                                           else wf),
            "b": torch.zeros(3 * r * r, device=dev), "u8": u8,
            "out": torch.empty((B, H * r, W * r, 3), dtype=torch.uint8,
                               device=dev)}
        del xf
    return ops


def _wide_timings(libs, name: str, ops: dict, stream) -> dict:
    """{timing: callable} of the wide K1 and K2 forms for one variant's
    libraries ({user source: library})."""
    P, I = ctypes.c_void_p, ctypes.c_int
    tc, f32 = libs[conv3x3.TC_SOURCE], libs[conv3x3.F32_SOURCE]
    bf = _entry(tc, "reve_conv3x3_bias_prelu_wide_tc", [P] * 5 + [I] * 4 + [P])
    split = _entry(f32, "reve_split_bf16x3", [P, P, ctypes.c_longlong, I, I, P])
    conv = _entry(f32, "reve_conv3x3_bias_prelu_wide_f32tc_planes",
                  [P] * 6 + [I] * 4 + [P])

    def run_bf16(o, feat):
        return lambda: build.check(tc, bf(
            o["x"].data_ptr(), o["w"].data_ptr(), o["b"].data_ptr(),
            o["alpha"].data_ptr(), o["y"].data_ptr(), B, H, W, feat, stream),
            name)

    o = ops["k1_f32_32"]

    def run_conv():  # as the model calls it: planes in, planes out
        build.check(f32, conv(
            o["x"].data_ptr(), o["w"].data_ptr(), o["b"].data_ptr(),
            o["alpha"].data_ptr(), None, o["y_planes"].data_ptr(), B, H, W,
            32, stream), name)

    def run_split():
        build.check(f32, split(o["xf"].data_ptr(), o["x"].data_ptr(),
                               o["xf"].numel() // 8, 8, 8, stream), name)

    def run_head(timing, feat, r, dt):
        lib = tc if dt == "bf16" else f32
        fn = _entry(lib, "reve_head_conv_residual_u8_shuffle_wide_" + (
            "tc" if dt == "bf16" else "f32tc"), [P] * 5 + [I] * 5 + [P])
        h = ops[timing]
        return lambda: build.check(lib, fn(
            h["x"].data_ptr(), h["w"].data_ptr(), h["b"].data_ptr(),
            h["u8"].data_ptr(), h["out"].data_ptr(), B, H, W, feat, r,
            stream), name)
    return {"k1_32_ms": run_bf16(ops["k1_32_ms"], 32),
            "k1_96_ms": run_bf16(ops["k1_96_ms"], 96),
            "k1_f32_32_conv_ms": run_conv, "k1_f32_32_split_ms": run_split,
            **{form[0]: run_head(*form) for form in _WIDE_HEADS}}


#: the wide K4 and K4h forms timed: (timing, width, scale; 0: K4)
_S8_WIDE_FORMS = (("k4_32_ms", 32, 0), ("k4_128_ms", 128, 0),
                  ("k4h_x4_32_ms", 32, 4), ("k4h_x4_128_ms", 128, 4),
                  ("k4h_x2_128_ms", 128, 2))


def _s8_wide_operands(rs, dev) -> dict:
    """The wide K4 and K4h forms' operands at the main path's shape: s8
    codes and weights uniform in [-127, 127] (the weights packed once, as
    the wrappers keep them), K4's scale 2e-6..2e-5 and K4h's 1e-8..1e-7,
    the outputs."""
    ops = {}
    u8 = torch.from_numpy(rs.randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)).to(dev)
    x8 = {}
    for timing, feat, r in _S8_WIDE_FORMS:
        if feat not in x8:
            x8[feat] = torch.from_numpy(rs.randint(
                -127, 128, (B, H, W, feat)).astype(np.int8)).to(dev)
        cout = 3 * r * r if r else feat
        w8 = torch.from_numpy(rs.randint(-127, 128, (3, 3, feat, cout))
                              .astype(np.int8)).to(dev)
        lo, hi = (1e-8, 1e-7) if r else (2e-6, 2e-5)
        ops[timing] = {
            "x": x8[feat], "w": conv3x3_s8.pack_weights_s8_wide(w8),
            "scale": torch.from_numpy(rs.uniform(lo, hi, cout).astype(
                np.float32)).to(dev),
            "b": torch.from_numpy(rs.uniform(-0.1, 0.1, cout).astype(
                np.float32)).to(dev),
            "alpha": torch.full((cout,), 0.2, device=dev),
            "inv": torch.full((1,), 50.0, device=dev), "u8": u8,
            "out": torch.empty((B, H * r, W * r, 3), dtype=torch.uint8,
                               device=dev) if r else torch.empty_like(
                                   x8[feat])}
    return ops


def _s8_wide_timings(libs, name: str, ops: dict, stream) -> dict:
    """{timing: callable} of the wide K4 and K4h forms for one variant's
    library ({conv3x3_s8.cu: library}): their entry points on the
    weights packed once."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib = libs[conv3x3_s8.SOURCE]
    k4 = _entry(lib, "reve_conv3x3_s8_dq_prelu_q8_wide",
                [P] * 7 + [I] * 4 + [P])
    k4h = _entry(lib, "reve_head_conv_s8_residual_u8_shuffle_wide_tc",
                 [P] * 6 + [I] * 5 + [P])

    def run(timing, feat, r):
        o = ops[timing]
        if r == 0:
            return lambda: build.check(lib, k4(
                o["x"].data_ptr(), o["w"].data_ptr(), o["scale"].data_ptr(),
                o["b"].data_ptr(), o["alpha"].data_ptr(),
                o["inv"].data_ptr(), o["out"].data_ptr(), B, H, W, feat,
                stream), name)
        return lambda: build.check(lib, k4h(
            o["x"].data_ptr(), o["w"].data_ptr(), o["scale"].data_ptr(),
            o["b"].data_ptr(), o["u8"].data_ptr(), o["out"].data_ptr(), B,
            H, W, feat, r, stream), name)
    return {form[0]: run(*form) for form in _S8_WIDE_FORMS}


def _k7q_operands(rs, dev) -> dict:
    """K7q's operands at the int8 trunk's shapes: the 192-channel s8
    buffer a dense block reads and the other one conv 5 writes, the
    float32 chain (res, res2 = out) and feat, the model's scales, the
    weights of each form packed once."""
    cs = 192
    buf = torch.from_numpy(rs.randint(-127, 128, (B, H, W, cs)).astype(
        np.int8)).to(dev)
    ops = {"buf": buf, "other": torch.zeros_like(buf), "w": {},
           "res": torch.rand((B, H, W, 64), device=dev) * 4 - 2,
           "inv": torch.full((1,), 50.0, device=dev),
           "sw": torch.full((64,), 4e-6, device=dev),
           "b": torch.zeros(64, device=dev)}
    ops["res2"] = ops["res"].flip(0).contiguous()
    ops["feat"] = ops["res"].clone()
    for _f, cin, cout, _e in _K7Q_FORMS:
        w8 = torch.from_numpy(rs.randint(-127, 128, (3, 3, cin, cout))
                              .astype(np.int8)).to(dev)
        ops["w"][cin, cout] = rrdb.pack_weights_dense_s8(w8)
    return ops


def _k7q_timings(lib, name: str, ops: dict, stream) -> dict:
    """{timing: callable} of K7q's forms for one variant's library, laid
    out as apply_int8 lays them out: lrelu_q writes its growth slice of
    the buffer it reads, rdb and rrdb the other buffer's first 64
    channels and a float32 chain buffer (rrdb in place over res2), add
    feat in place."""
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _entry(lib, "reve_dense_conv_s8", [P] * 9 + [I] * 9 + [P])

    def run(cin, cout, epi):
        res = res2 = out = out8 = None
        if epi == "lrelu_q":
            out8 = ops["buf"].data_ptr() + cin
        elif epi == "add":
            res = out = ops["feat"].data_ptr()
        else:
            out8, res = ops["other"].data_ptr(), ops["res"].data_ptr()
            out = ops["res2"].data_ptr()
            res2 = out if epi == "rrdb" else None
        wp = ops["w"][cin, cout]
        return lambda: build.check(lib, fn(
            ops["buf"].data_ptr(), wp.data_ptr(), ops["sw"].data_ptr(),
            ops["b"].data_ptr(), ops["inv"].data_ptr(), res, res2, out,
            out8, B, H, W, cin, 192, cout, 192,
            rrdb.EPILOGUES_S8.index(epi), 0, stream), name)

    return {f"{f}_ms": run(cin, cout, epi)
            for f, cin, cout, epi in _K7Q_FORMS}


#: float32 conv_last's shape: the float32 RRDB plan's chunk of 2 frames
#: of 1080p x4
LAST_SHAPE = (2, 4320, 7680)


def _conv_last_operands(rs, dev, planes: bool) -> dict:
    """float32 conv_last's operands at LAST_SHAPE: conv_hr-like input (a
    leaky ReLU of normals), 64 -> 3 weights and bias as the wrapper passes
    them, and the u8 output; with `planes`, what the form before
    conv_last_f32.cu also took: the weights packed for the bf16x6 head
    and the split planes."""
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((*LAST_SHAPE, 64), device=dev, generator=gen).mul_(0.3)
    torch.nn.functional.leaky_relu_(x, 0.2)
    w = torch.from_numpy(rs.uniform(-0.04, 0.04, (3, 3, 64, 3)).astype(
        np.float32)).to(dev)
    ops = {"x": x, "w": w, "b": torch.full((3,), 0.45, device=dev),
           "out": torch.empty((*LAST_SHAPE, 3), dtype=torch.uint8,
                              device=dev)}
    if planes:
        ops.update(wp=conv3x3.pack_weights_bf16x3(w),
                   planes=torch.empty((3, *x.shape), dtype=torch.bfloat16,
                                      device=dev))
    return ops


#: T1's and T2's timed channel pairs, at a training step's shape
_TRAIN_PAIRS = (64, 128)
_TRAIN_SHAPE = (8, 64, 64)


def _train_operands(rs, dev) -> dict:
    """T1's and T2's operands at each of _TRAIN_PAIRS (c -> c) on
    _TRAIN_SHAPE: x, w, b, alpha, dz, z_prev and the outputs."""
    B, H, W = _TRAIN_SHAPE
    ops = {}
    for c in _TRAIN_PAIRS:
        def t(*shape, scale=1.0):
            return torch.from_numpy((rs.randn(*shape) * scale).astype(
                np.float32)).to(dev)
        ops[c] = {"x": t(B, H, W, c), "w": t(3, 3, c, c, scale=0.03),
                  "b": t(c, scale=0.1), "a": t(c, scale=0.1).abs(),
                  "dz": t(B, H, W, c, scale=1e-3), "zp": t(B, H, W, c),
                  "y": t(B, H, W, c), "z": t(B, H, W, c),
                  "part": t(train.tiles(B, H, W), c), "da": t(c)}
    return ops


def _train_timings(lib, name: str, ops: dict, stream) -> dict:
    """{t2_C_ms, t1_C_ms: callable} for C in _TRAIN_PAIRS."""
    P, I = ctypes.c_void_p, ctypes.c_int
    t2 = _entry(lib, "reve_conv3x3_dgrad_tc", [P] * 7 + [I] * 5 + [P])
    t1 = _entry(lib, "reve_conv3x3_fwd_train_tc", [P] * 6 + [I] * 5 + [P])
    B, H, W = _TRAIN_SHAPE

    def run(c, fn, keys):
        o = ops[c]
        return lambda: build.check(lib, fn(
            *(o[k].data_ptr() for k in keys), B, H, W, c, c, stream), name)
    out = {}
    for c in _TRAIN_PAIRS:
        out[f"t2_{c}_ms"] = run(c, t2, ("dz", "w", "zp", "a", "y", "part",
                                         "da"))
        out[f"t1_{c}_ms"] = run(c, t1, ("x", "w", "b", "a", "y", "z"))
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(prog="perf_conv_tc_parts",
                                description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--sources", nargs="+", choices=sorted(PATCHES),
                   help="time only these sources' variants")
    p.add_argument("--variants", nargs="+",
                   help="time only these variants (and `full`)")
    args = p.parse_args(argv)
    line = run(args.sources, args.iters, args.variants)
    print(json.dumps(line), flush=True)
    return line


def run(sources: Optional[List[str]] = None, iters: int = 20,
        variants: Optional[List[str]] = None) -> dict:
    """Build and time the variants of `sources` (None: all; `variants`:
    only those and `full`) on the card; returns the line main prints."""
    dev = torch.device("cuda", 0)
    rs = np.random.RandomState(0)
    xf = torch.from_numpy(rs.rand(B, H, W, 64).astype(np.float32) - 0.3).to(
        dev)
    x = xf.to(torch.bfloat16)
    wf = torch.from_numpy(rs.uniform(-0.04, 0.04, (3, 3, 64, 64)).astype(
        np.float32)).to(dev)
    w = wf.to(torch.bfloat16)
    wh = w[..., :3 * R * R].contiguous()
    wp = conv3x3.pack_weights_bf16x3(wf)
    wph = conv3x3.pack_weights_bf16x3(wf[..., :3 * R * R])
    x8 = torch.from_numpy(rs.randint(-127, 128, (B, H, W, 64)).astype(
        np.int8)).to(dev)
    w8r = torch.from_numpy(rs.randint(-127, 128, (3, 3, 64, 64)).astype(
        np.int8)).to(dev)
    w8 = conv3x3_s8.pack_weights_s8(w8r)
    w8h = conv3x3_s8.pack_weights_s8(w8r[..., :3 * R * R])
    w3, w3f = w[:, :, :3].contiguous(), wf[:, :, :3].contiguous()
    w12, w12f = w[:, :, :12].contiguous(), wf[:, :, :12].contiguous()
    ones = torch.ones(64, device=dev)
    y2 = torch.empty((B, H // 2, W // 2, 64), dtype=torch.bfloat16,
                     device=dev)
    yf2 = torch.empty((B, H // 2, W // 2, 64), device=dev)
    b = torch.zeros(64, device=dev)
    alpha = torch.full((64,), 0.2, device=dev)
    scale = torch.full((64,), 1e-5, device=dev)
    inv = torch.full((1,), 50.0, device=dev)
    u8 = torch.from_numpy(rs.randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)).to(dev)
    y, yf, y8 = torch.empty_like(x), torch.empty_like(xf), \
        torch.empty_like(x8)
    planes = conv3x3.split_bf16x3(xf)
    o = torch.empty((B, H * R, W * R, 3), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    k6_shape = (B, H * R, W * R, 3)
    k6_acc = torch.from_numpy(rs.randint(0, 1786, k6_shape).astype(
        np.int16)).to(dev)
    k6_y = {k: torch.from_numpy(rs.randint(0, 256, (
        B, W * R, H * R, 3) if k & 1 else k6_shape).astype(np.uint8)).to(dev)
        for k, _ in _K6_SPECS}

    probe_ops = perf_int8_dot.inputs(dev)
    probe_out = {n: torch.empty((perf_int8_dot.M, perf_int8_dot.N),
                                dtype=torch.int32 if n == "int8"
                                else torch.float32, device=dev)
                 for n in probe_ops}

    def timings(source, lib, name):
        """{timing: callable} for one variant's library."""
        if source == dot_probe.SOURCE:
            fn = _entry(lib, "reve_dot_loop", [P] * 3 + [I] * 5 + [P])

            def run(n, loops):
                x, w = probe_ops[n]
                return lambda: build.check(lib, fn(
                    x.data_ptr(), w.data_ptr(), probe_out[n].data_ptr(),
                    perf_int8_dot.M, perf_int8_dot.N, perf_int8_dot.K,
                    loops, int(n == "bf16"), stream), name)
            return {f"{n}_{loops}_ms": run(n, loops) for n in probe_ops
                    for loops in _DOT_LOOPS}
        if source == tta.SOURCE:
            fn = _entry(lib, "reve_tta_accumulate", [P] * 3 + [I] * 6 + [P])

            def run_k6(k, flip, form):
                # MIDDLE adds in place at each launch (the sum wraps; only
                # the time is read)
                return lambda: build.check(lib, fn(
                    k6_y[k].data_ptr(), k6_acc.data_ptr(), o.data_ptr(), B,
                    H * R, W * R, k, int(flip), form, stream), name)
            return {f"{fname}_k{k}{'f' if flip else ''}_ms":
                    run_k6(k, flip, form) for k, flip in _K6_SPECS
                    for form, fname in ((tta.FIRST, "first"),
                                        (tta.MIDDLE, "middle"),
                                        (tta.LAST, "last"))}
        if source == rrdb.SOURCE:
            return _k7_timings(lib, name, k7_ops, stream)
        if source == train.SOURCE:
            return _train_timings(lib, name, train_ops, stream)
        if source == rrdb.S8_SOURCE:
            return _k7q_timings(lib, name, k7q_ops, stream)
        if source == WIDE:
            return _wide_timings(lib, name, wide_ops, stream)
        if source == S8_WIDE:
            return _s8_wide_timings(lib, name, s8w_ops, stream)
        if source == conv3x3.TC_SOURCE:
            k1 = _entry(lib, "reve_conv3x3_bias_prelu_tc",
                        [P] * 5 + [I] * 3 + [P])
            k2 = _entry(lib, "reve_head_conv_residual_u8_shuffle_tc",
                        [P] * 5 + [I] * 4 + [P])
            return {
                "k1_ms": lambda: build.check(lib, k1(
                    x.data_ptr(), w.data_ptr(), b.data_ptr(),
                    alpha.data_ptr(), y.data_ptr(), B, H, W, stream),
                    name),
                "k2_ms": lambda: build.check(lib, k2(
                    x.data_ptr(), wh.data_ptr(), b.data_ptr(),
                    u8.data_ptr(), o.data_ptr(), B, H, W, R, stream),
                    name)}
        if source == conv3x3.F32_SOURCE:
            split = _entry(lib, "reve_split_bf16x3",
                           [P, P, ctypes.c_longlong, I, I, P])
            conv = _entry(lib, "reve_conv3x3_bias_prelu_f32tc",
                          [P] * 5 + [I] * 3 + [P])
            k2 = _entry(lib, "reve_head_conv_residual_u8_shuffle_f32tc",
                        [P] * 5 + [I] * 4 + [P])

            def run_split():
                build.check(lib, split(xf.data_ptr(), planes.data_ptr(),
                                       xf.numel() // 8, 8, 8, stream), name)

            def run_conv():
                build.check(lib, conv(
                    planes.data_ptr(), wp.data_ptr(), b.data_ptr(),
                    alpha.data_ptr(), yf.data_ptr(), B, H, W, stream), name)

            def run_both():
                run_split()
                run_conv()

            def run_head():
                build.check(lib, k2(
                    planes.data_ptr(), wph.data_ptr(), b.data_ptr(),
                    u8.data_ptr(), o.data_ptr(), B, H, W, R, stream), name)

            def run_head_split():
                run_split()
                run_head()
            t = {"k1_f32_ms": run_both, "conv_ms": run_conv,
                 "split_ms": run_split, "k2_f32_ms": run_head_split,
                 "k2_conv_ms": run_head}
            if hasattr(lib, "reve_conv_last_u8_f32tc"):
                # float32 conv_last in a checkout from before
                # conv_last_f32.cu: the split pass, then K2 at r = 1
                last = _entry(lib, "reve_conv_last_u8_f32tc",
                              [P] * 4 + [I] * 3 + [P])
                lo = last_ops

                def run_last_split():
                    build.check(lib, split(
                        lo["x"].data_ptr(), lo["planes"].data_ptr(),
                        lo["x"].numel() // 8, 8, 8, stream), name)

                def run_last_conv():
                    build.check(lib, last(
                        lo["planes"].data_ptr(), lo["wp"].data_ptr(),
                        lo["b"].data_ptr(), lo["out"].data_ptr(),
                        *LAST_SHAPE, stream), name)

                def run_last():
                    run_last_split()
                    run_last_conv()
                t.update(conv_last_f32_ms=run_last,
                         conv_last_split_ms=run_last_split,
                         conv_last_conv_ms=run_last_conv)
            return t
        if source == LAST_F32_SOURCE:
            last = _entry(lib, "reve_conv_last_u8_f32",
                          [P] * 4 + [I] * 3 + [P])
            lo = last_ops
            return {"conv_last_f32_ms": lambda: build.check(lib, last(
                lo["x"].data_ptr(), lo["w"].data_ptr(), lo["b"].data_ptr(),
                lo["out"].data_ptr(), *LAST_SHAPE, stream), name)}
        if source == conv3x3.SOURCE:
            k3 = _entry(lib, "reve_conv3x3_u8_bias_prelu",
                        [P] * 5 + [I] * 5 + [P])
            k4a = _entry(lib, "reve_conv3x3_u8_bias_prelu_q8",
                         [P] * 6 + [I] * 5 + [P])

            def run_k3(wt, out, code):
                return lambda: build.check(lib, k3(
                    u8.data_ptr(), wt.data_ptr(), b.data_ptr(),
                    alpha.data_ptr(), out.data_ptr(), B, H, W, code, 64,
                    stream), name)

            def run_k4a(wt, code, feat=64):
                o = u8w_ops[feat] if feat != 64 else dict(
                    b=b, a=alpha, y=y8)
                return lambda: build.check(lib, k4a(
                    u8.data_ptr(), wt.data_ptr(), o["b"].data_ptr(),
                    o["a"].data_ptr(), inv.data_ptr(), o["y"].data_ptr(), B,
                    H, W, code, feat, stream), name)
            k3x2 = _entry(lib, "reve_conv3x3_u8x2_bias",
                          [P] * 5 + [I] * 4 + [P])

            def run_k3x2(wt, out, code):
                # the batch's 1080p frames as RRDB x2's 540 x 960 trunk
                return lambda: build.check(lib, k3x2(
                    u8.data_ptr(), wt.data_ptr(), b.data_ptr(),
                    ones.data_ptr(), out.data_ptr(), B, H // 2, W // 2,
                    code, stream), name)
            return {"k3_ms": run_k3(w3, y, 1),
                    "k3_f32_ms": run_k3(w3f, yf, 0),
                    "k4a_ms": run_k4a(w3, 1), "k4a_f32_ms": run_k4a(w3f, 0),
                    **{f"k4a_{f}_ms": run_k4a(u8w_ops[f]["w"], 1, f)
                       for f in U8_WIDE},
                    "k3x2_ms": run_k3x2(w12, y2, 1),
                    "k3x2_f32_ms": run_k3x2(w12f, yf2, 0)}
        k4 = _entry(lib, "reve_conv3x3_s8_dq_prelu_q8",
                    [P] * 7 + [I] * 3 + [P])
        k4h = _entry(lib, "reve_head_conv_s8_residual_u8_shuffle_tc",
                     [P] * 6 + [I] * 4 + [P])
        return {"k4_ms": lambda: build.check(lib, k4(
            x8.data_ptr(), w8.data_ptr(), scale.data_ptr(), b.data_ptr(),
            alpha.data_ptr(), inv.data_ptr(), y8.data_ptr(), B, H, W,
            stream), name),
            "k4h_ms": lambda: build.check(lib, k4h(
                x8.data_ptr(), w8h.data_ptr(), scale.data_ptr(),
                b.data_ptr(), u8.data_ptr(), o.data_ptr(), B, H, W, R,
                stream), name)}

    k7_ops = k7q_ops = last_ops = train_ops = wide_ops = s8w_ops = None
    u8w_ops = {}
    if conv3x3.SOURCE in (sources or PATCHES):
        u8w_ops = _u8_wide_operands(rs, dev)
    if WIDE in (sources or PATCHES):
        wide_ops = _wide_operands(rs, dev)
    if S8_WIDE in (sources or PATCHES):
        s8w_ops = _s8_wide_operands(rs, dev)
    if train.SOURCE in (sources or PATCHES):
        train_ops = _train_operands(rs, dev)
    if {LAST_F32_SOURCE, conv3x3.F32_SOURCE} & set(sources or PATCHES):
        last_ops = _conv_last_operands(
            rs, dev, planes=conv3x3.F32_SOURCE in (sources or PATCHES))
    if rrdb.SOURCE in (sources or PATCHES):
        k7_ops = _k7_operands(rs, dev)
    if rrdb.S8_SOURCE in (sources or PATCHES):
        k7q_ops = _k7q_operands(rs, dev)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, sources, variants)
        for _ in range(2):
            for (source, variant), lib in libs.items():
                print(f"# timing {source} {variant}", file=sys.stderr,
                      flush=True)
                timer = queued_ms if source in (dot_probe.SOURCE,
                                                train.SOURCE) else time_ms
                for timing, fn in timings(source, lib, variant).items():
                    out.setdefault(source, {}).setdefault(
                        variant, {}).setdefault(timing, []).append(
                            timer(fn, iters, dev))
    return {"device": torch.cuda.get_device_name(dev), "shape": [B, H, W],
            "r": R, "variants": out, "failed": FAILED}


if __name__ == "__main__":
    main(sys.argv[1:])
