"""Where the time of the tensor-core conv kernels (and of K6) goes.

    python -m reve_tpu_torch.scripts.perf_conv_tc_parts [--iters N]
        [--sources SOURCE ...]

Builds variants of the four tensor-core sources with one or two of their
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
each SM:
  * kernels/csrc/conv3x3_tc.cu: bfloat16 K1 (`k1_ms`) and K2 at r=4
    (`k2_ms`);
  * kernels/csrc/conv3x3_f32_tc.cu: float32 K1 as the wrapper runs it,
    split pass and conv (`k1_f32_ms`), the conv alone on split planes
    (`conv_ms`), the split pass alone (`split_ms`), and float32 K2 at r=4
    with its split pass (`k2_f32_ms`) and alone (`k2_conv_ms`).  The
    weights stream tap by tap in every variant: `no_load` takes out the
    halo loads only;
  * kernels/csrc/conv3x3_s8.cu: K4 (`k4_ms`) and K4h at r=4 (`k4h_ms`);
  * kernels/csrc/conv3x3.cu: K3 in bfloat16 (`k3_ms`) and float32
    (`k3_f32_ms`), K4a with its conv in bfloat16 (`k4a_ms`) and float32
    (`k4a_f32_ms`);
  * kernels/csrc/dot_probe.cu: P1 at the probe's shape in s8 and bf16 at
    0 loops (the prologue and epilogue alone), 64 and 1024 loops
    (`int8_64_ms`, ...), the calls queued behind a sleep kernel
    (perf_int8_dot.queued_ms); its variants are one warpgroup on each 64 x
    64 tile in place of two (`one_wg`: every dot in one chain) and the
    mainloop without the prologue (`no_prologue`: B not staged, A not
    loaded);
  * kernels/csrc/tta.cu: K6's three forms at the TTA path's shape (4
    frames of 1080p x4) for an even and an odd transform
    (`middle_k1f_ms`: MIDDLE at k = 1 with the flip, ...); its variants
    walk each tile's rows 4 or 1 at a time (`rows_4`, `rows_1`) where
    it walks them 2 at a time.  They compute the right result.
Each conv source's kernels share one mainloop, so a variant takes the part out
of all of them.  The variants that take a part out compute wrong results.
They exist only here, in a temporary directory, and only their times mean
anything.
Prints one JSON line: the
card, then {source: {variant: {timing: [ms, ms]}}}, each time the mean
over `iters` launches after one untimed launch, the variants run in turn,
twice.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch

from reve_tpu_torch.kernels import (build, conv3x3, conv3x3_s8, dot_probe,
                                    tta)
from reve_tpu_torch.scripts import perf_int8_dot
from reve_tpu_torch.scripts.perf_int8_dot import queued_ms, time_ms

B, H, W, R = 4, 1080, 1920, 4
_LOAD = "    if (tid == 0 && next < g.count) {"
_LOAD_WAIT = "    mbar_wait(bar + (it & 1) * 8, (it >> 1) & 1);"
_NO_LOAD = [(_LOAD, "    if (false) {"),
            (_LOAD_WAIT, "    if (it == 0) mbar_wait(bar, 0);")]
_U8_MMA = ("    mma_row<U::F32>(acc, cor, a_src, base + "
           "(uint32_t)U::OFF_W);\n")
_U8_EPI = ("    epilogue<T, TOut>(st, acc, cor, bi, al, al2, inv_s, pa, "
           "q);\n")
_U8_STORE = "    if (t == 0) {\n      const uint32_t src"
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
        "no_load": [("    if (tile + 2 * step < count)\n      fetch(",
                     "    if (false)\n      fetch(")],
        "no_mma": [(_U8_MMA, "    for (int i = 0; i < 32; ++i) acc[i] = "
                    "cor[i] = it;\n")],
        "no_epi": [(_U8_EPI, "    if (acc[0] == 0.5f) smem[0] = 1;\n"),
                   (_U8_STORE, "    if (false) {\n      const uint32_t src")],
    },
}
# K3 and K4a at one block fewer and one more on each SM than they run
_U8_BLOCKS = ("  static constexpr int BLOCKS = F32 ? (Q8 ? 3 : 2) : (Q8 ? 6 : "
              "4);")
PATCHES[conv3x3.SOURCE]["fewer_blocks"] = [(_U8_BLOCKS, _U8_BLOCKS.replace(
    "(Q8 ? 3 : 2) : (Q8 ? 6 : 4)", "(Q8 ? 2 : 1) : (Q8 ? 5 : 3)"))]
PATCHES[conv3x3.SOURCE]["more_blocks"] = [(_U8_BLOCKS, _U8_BLOCKS.replace(
    "(Q8 ? 3 : 2) : (Q8 ? 6 : 4)", "(Q8 ? 4 : 3) : (Q8 ? 7 : 5)"))]
PATCHES[conv3x3.SOURCE]["stores_only"] = (
    PATCHES[conv3x3.SOURCE]["no_load"] + PATCHES[conv3x3.SOURCE]["no_mma"]
    + [(_U8_EPI, "")])
for _p in PATCHES.values():
    _p["full"] = []
    _p["no_load_no_epi"] = _p["no_load"] + _p["no_epi"]
    _p["no_mma_no_epi"] = _p["no_mma"] + _p["no_epi"]
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
_K6_SPECS = ((2, False), (1, True))
#: P1's loop counts: the prologue and epilogue alone, the probe's, the
#: slope's
_DOT_LOOPS = (0, 64, 1024)


def variant_source(source: str, variant: str) -> str:
    """The text of `source` with `variant`'s parts taken out."""
    with open(os.path.join(build.CSRC, source)) as f:
        text = f.read()
    for old, new in PATCHES[source][variant]:
        if text.count(old) != 1:
            raise RuntimeError(f"{source} {variant}: the source no longer "
                               f"has the text this variant replaces")
        text = text.replace(old, new)
    return text


def build_variants(tmp: str, sources=None) -> dict:
    """{(source, variant): loaded library} of `sources` (default: all),
    all compiled at once."""
    procs = {}
    for source in sources or PATCHES:
        for variant in PATCHES[source]:
            stem = f"{os.path.splitext(source)[0]}-{variant}"
            cu = os.path.join(tmp, f"{stem}.cu")
            with open(cu, "w") as f:
                f.write(variant_source(source, variant))
            so = os.path.join(tmp, f"lib{stem}.so")
            procs[source, variant] = (so, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC,
                 "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc exited {proc.returncode}\n{log}")
        libs[key] = ctypes.CDLL(so)
    return libs


def _entry(lib, name: str, argtypes) -> ctypes._CFuncPtr:
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(prog="perf_conv_tc_parts",
                                description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--sources", nargs="+", choices=sorted(PATCHES),
                   help="time only these sources' variants")
    args = p.parse_args(argv)
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
            head = _entry(lib, "reve_head_conv_residual_u8_shuffle_f32tc",
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
                build.check(lib, head(
                    planes.data_ptr(), wph.data_ptr(), b.data_ptr(),
                    u8.data_ptr(), o.data_ptr(), B, H, W, R, stream), name)

            def run_head_split():
                run_split()
                run_head()
            return {"k1_f32_ms": run_both, "conv_ms": run_conv,
                    "split_ms": run_split, "k2_f32_ms": run_head_split,
                    "k2_conv_ms": run_head}
        if source == conv3x3.SOURCE:
            k3 = _entry(lib, "reve_conv3x3_u8_bias_prelu",
                        [P] * 5 + [I] * 4 + [P])
            k4a = _entry(lib, "reve_conv3x3_u8_bias_prelu_q8",
                         [P] * 6 + [I] * 4 + [P])

            def run_k3(wt, out, code):
                return lambda: build.check(lib, k3(
                    u8.data_ptr(), wt.data_ptr(), b.data_ptr(),
                    alpha.data_ptr(), out.data_ptr(), B, H, W, code, stream),
                    name)

            def run_k4a(wt, code):
                return lambda: build.check(lib, k4a(
                    u8.data_ptr(), wt.data_ptr(), b.data_ptr(),
                    alpha.data_ptr(), inv.data_ptr(), y8.data_ptr(), B, H, W,
                    code, stream), name)
            return {"k3_ms": run_k3(w3, y, 1),
                    "k3_f32_ms": run_k3(w3f, yf, 0),
                    "k4a_ms": run_k4a(w3, 1), "k4a_f32_ms": run_k4a(w3f, 0)}
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

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, args.sources)
        for _ in range(2):
            for (source, variant), lib in libs.items():
                timer = queued_ms if source == dot_probe.SOURCE else \
                    time_ms
                for timing, fn in timings(source, lib, variant).items():
                    out.setdefault(source, {}).setdefault(
                        variant, {}).setdefault(timing, []).append(
                            timer(fn, args.iters, dev))
    line = {"device": torch.cuda.get_device_name(dev), "shape": [B, H, W],
            "r": R, "variants": out}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
