"""Where the time of the tensor-core K1 and K2 goes.

    python -m reve_tpu_torch.scripts.perf_conv_tc_parts [--iters N]

Builds variants of reve_tpu_torch/kernels/csrc/conv3x3_tc.cu with one or
two of its three parts taken out: the halo loads after the first tile
(`no_load`: later tiles compute on a stale buffer), the wgmmas
(`no_mma`: the accumulators are set, not computed), and the epilogue
(`no_epi`: nothing is written).  It times each variant, beside the kernel
as it is (`full`), on K1 and K2 (r=4) at the main path's shapes: a batch
of 4 1920x1080 frames.  The variants compute wrong results.  They exist
only here, in a temporary directory, and only their times mean anything.
Prints one JSON line: the card, then {variant: {"k1_ms", "k2_ms"}}, each
time the mean over `iters` launches after one untimed launch, with the
variants run in turn, twice.
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

from reve_tpu_torch.kernels import build, conv3x3
from reve_tpu_torch.scripts.perf_int8_dot import time_ms

B, H, W, R = 4, 1080, 1920, 4
_LOAD = "    if (tid == 0 && next < g.count) {"
_LOAD_WAIT = "    mbar_wait(bar + (it & 1) * 8, (it >> 1) & 1);"
_MMA = ("    issue_mma<N>(acc, base + (it & 1) * HALO_BYTES + wg * (TW + 2) "
        "* CIN * 2,\n                 base + (uint32_t)C::OFF_W);\n")
_WAIT = "    wait_mma<N>(acc);\n"
#: variant -> [(text in the source, its replacement)]
PATCHES = {
    "full": [],
    "no_load": [(_LOAD, "    if (false) {"),
                (_LOAD_WAIT, "    if (it == 0) mbar_wait(bar, 0);")],
    "no_mma": [(_MMA, "    for (int i = 0; i < N / 2; ++i) acc[i] = it;\n")],
    "no_epi": [(_WAIT, _WAIT + "    if (acc[0] == 0.5f) *(float*)out = "
                "acc[1];\n    continue;\n")],
}
PATCHES["no_load_no_epi"] = PATCHES["no_load"] + PATCHES["no_epi"]
PATCHES["no_mma_no_epi"] = PATCHES["no_mma"] + PATCHES["no_epi"]


def build_variants(tmp: str) -> dict:
    """{variant: loaded library}, all compiled at once."""
    with open(os.path.join(build.CSRC, conv3x3.TC_SOURCE)) as f:
        src = f.read().replace('#include "common.cuh"',
                               f'#include "{build.CSRC}/common.cuh"')
    procs = {}
    for name, patches in PATCHES.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has the "
                                   f"text this variant replaces")
            text = text.replace(old, new)
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(tmp, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(prog="perf_conv_tc_parts",
                                description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    dev = torch.device("cuda", 0)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(B, H, W, 64).astype(np.float32) - 0.3).to(
        dev, torch.bfloat16)
    w = torch.from_numpy(rs.uniform(-0.04, 0.04, (3, 3, 64, 64)).astype(
        np.float32)).to(dev, torch.bfloat16)
    wh = w[..., :3 * R * R].contiguous()
    b = torch.zeros(64, device=dev)
    alpha = torch.full((64,), 0.2, device=dev)
    u8 = torch.from_numpy(rs.randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)).to(dev)
    y = torch.empty_like(x)
    o = torch.empty((B, H * R, W * R, 3), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        for _ in range(2):
            for name, lib in libs.items():
                k1 = lib.reve_conv3x3_bias_prelu_tc
                k1.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
                    [ctypes.c_void_p]
                k2 = lib.reve_head_conv_residual_u8_shuffle_tc
                k2.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + \
                    [ctypes.c_void_p]
                t1 = time_ms(lambda: build.check(lib, k1(
                    x.data_ptr(), w.data_ptr(), b.data_ptr(),
                    alpha.data_ptr(), y.data_ptr(), B, H, W, 1, stream),
                    name), args.iters, dev)
                t2 = time_ms(lambda: build.check(lib, k2(
                    x.data_ptr(), wh.data_ptr(), b.data_ptr(),
                    u8.data_ptr(), o.data_ptr(), B, H, W, R, 1, stream),
                    name), args.iters, dev)
                out.setdefault(name, {"k1_ms": [], "k2_ms": []})
                out[name]["k1_ms"].append(t1)
                out[name]["k2_ms"].append(t2)
    line = {"device": torch.cuda.get_device_name(dev), "shape": [B, H, W],
            "r": R, "variants": out}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
