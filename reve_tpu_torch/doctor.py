"""`python -m reve_tpu_torch.doctor` — environment diagnostics for
deployments of the port.

Counterpart of reve_tpu/doctor.py.  Checks every layer an operator
depends on and prints one line per probe (plus a JSON summary with
--json): the CUDA devices, the kernels' build (and K3 on a small frame on
each device, held against its plain version), the native C++ core (build
+ mp4/mkv round trip), codec availability (ffmpeg binaries / cv2), model
registry + weight resolution, and a micro end-to-end pipeline run on
cuda:0.  Exit code 0 = all required probes passed (warnings allowed), 1
otherwise, 2 when the hang watchdog fires.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile

#: whole-run deadline (--timeout N overrides).  A first run builds every
#: kernel library with nvcc (minutes); a wedged card or CUDA runtime can block
#: device init or a launch forever inside native code, so diagnostics must
#: self-terminate with an honest verdict.
DEFAULT_TIMEOUT_S = 600.0
#: K3's float32 form against its plain version (its card tests' bound)
K3_TOL = 1e-4


def _arm_hang_watchdog(timeout_s: float, results: list, want_json: bool):
    """Daemon thread that reports a wedged accelerator stack and
    hard-exits (code 2) if the probes haven't all completed in time —
    no Python-level deadline can interrupt a native-code hang, so the
    whole process goes.  Call .set() on the returned event when done."""
    import os
    import threading

    done = threading.Event()

    def fire():
        if done.wait(timeout_s):
            return
        where = (f"hung after the {results[-1]['probe']!r} probe"
                 if results else "hung in the first ('accelerator') probe")
        entry = {"probe": "watchdog", "status": "fail", "required": True,
                 "detail": f"no response in {timeout_s:.0f}s ({where}) — "
                           f"accelerator stack wedged: device init, a "
                           f"kernel build or a launch is blocking in "
                           f"native code (card or CUDA runtime hung?)"}
        results.append(entry)
        print(f" [x] watchdog: {entry['detail']}", flush=True)
        if want_json:
            print(json.dumps({"ok": False, "probes": results}), flush=True)
        print("FAILURES above", file=sys.stderr)
        sys.stderr.flush()
        os._exit(2)

    threading.Thread(target=fire, daemon=True).start()
    return done


def _probe(name, fn, required=True, results=None):
    try:
        detail = fn() or "ok"
        status = "ok"
    except Exception as e:  # noqa: BLE001 — diagnostics must not die
        detail = f"{type(e).__name__}: {e}"
        status = "fail" if required else "warn"
    results.append({"probe": name, "status": status, "detail": str(detail),
                    "required": required})
    mark = {"ok": "+", "warn": "!", "fail": "x"}[status]
    print(f" [{mark}] {name}: {detail}", flush=True)
    return status


def _cuda_devices():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "False); reve_tpu_torch runs on the GPU")
    names = [torch.cuda.get_device_name(i)
             for i in range(torch.cuda.device_count())]
    return (f"cuda ({'; '.join(f'{i}: {n}' for i, n in enumerate(names))})"
            f", {len(names)} device(s), torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}")


def _kernel_build():
    """Build (or load) every kernel library, then K3 in float32 on a small
    frame on each device against its plain version."""
    import time

    import torch

    from reve_tpu_torch.kernels import build, conv3x3

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device to build the kernels for")
    t0 = time.perf_counter()
    info = build.load_all()
    built = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(0)
    u8 = torch.randint(0, 256, (2, 64, 128, 3), dtype=torch.uint8,
                       generator=gen)
    w = (torch.rand((3, 3, 3, conv3x3.FEAT), generator=gen) - 0.5) * 0.4
    b = (torch.rand(conv3x3.FEAT, generator=gen) - 0.5) * 0.2
    alpha = torch.full((conv3x3.FEAT,), 0.25)
    want = conv3x3.conv3x3_u8_bias_prelu_plain(u8, w, b, alpha)
    errs = []
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        got = conv3x3.conv3x3_u8_bias_prelu(u8.to(dev), w.to(dev), b.to(dev),
                                            alpha.to(dev)).cpu()
        err = float((got - want).abs().max())
        if not err <= K3_TOL:
            raise AssertionError(f"K3 on {dev}: max |err| {err:.3g} vs its "
                                 f"plain version > {K3_TOL}")
        errs.append(f"{dev} {err:.2g}")
    cached = sum(1 for v in info.values() if v["cached"])
    return (f"{len(info)} libraries ({cached} from the build cache) in "
            f"{built:.1f} s; K3 max |err| vs plain: {', '.join(errs)}")


def _native_core():
    from reve_tpu_torch import native

    if not native.available():
        raise RuntimeError("the native core is unavailable (g++ missing?)")
    assert native.plan_segments(10, 4) == [(0, 4), (4, 4), (8, 2)]
    return "built + planner parity"


def _native_mp4_mkv():
    import os

    import numpy as np

    from reve_tpu_torch import native

    cv2 = __import__("cv2")
    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "p.mp4")
        wr = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 24,
                             (32, 32))
        for _ in range(3):
            wr.write(np.zeros((32, 32, 3), np.uint8))
        wr.release()
        native.concat_mp4([p], None, os.path.join(tmp, "o.mp4"))
        native.concat_mkv([p], None, os.path.join(tmp, "o.mkv"))
        assert native.probe_mp4(os.path.join(tmp, "o.mp4"))[
            "video_samples"] == 3
        assert native.probe_mkv(os.path.join(tmp, "o.mkv"))[
            "video_blocks"] == 3
    return "mp4 + mkv mux round trip"


def _codecs():
    notes = []
    for exe in ("ffmpeg", "ffprobe"):
        notes.append(f"{exe}: {'found' if shutil.which(exe) else 'absent'}")
    try:
        import cv2

        notes.append(f"cv2 {cv2.__version__}")
    except ImportError:
        notes.append("cv2: absent")
    return "; ".join(notes)


def _models():
    from reve_tpu_torch.models import registry

    names = [n for n, _ in registry.list_models()]
    found = []
    for name, spec in registry.list_models():
        scales = [spec.upscale] if spec.upscale else [2, 3, 4]
        found += [f"{name} x{s}" for s in scales
                  if registry.resolve_weights(name, s)]
    return (f"{len(names)} registered; weights on disk for "
            f"{found or 'none (jobs refuse to start without weights)'}")


def _mini_pipeline():
    """reve_tpu's 4-frame x2 job through the CLI, on cuda:0.  It checks
    the plumbing (decode, engine, kernels, encode, concat), not the
    weights, so it runs on random ones (the model registry probe reports
    which weights are on disk)."""
    import fractions
    import os

    import numpy as np

    from reve_tpu_torch import cli
    from reve_tpu_torch.io import reader, writer

    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "in.y4m")
        with writer.Y4MWriter(inp, 24, 16, fractions.Fraction(24)) as wr:
            for i in range(4):
                wr.write(np.full((16, 24, 3), 40 + i * 10, np.uint8))
        out = os.path.join(tmp, "out.y4m")
        rc = cli.run(["-i", inp, "-s", "2", out, "--yes",
                      "--io-backend", "y4m", "-S", "2", "--batch", "2",
                      "--dtype", "float32", "--allow-random-init"])
        assert rc == 0, f"cli.run exited {rc}"
        rd = reader.Y4MReader(out)
        assert rd.frame_count() == 4 and rd.width == 48
    return "4-frame x2 upscale through the full pipeline on cuda:0"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    timeout_s = DEFAULT_TIMEOUT_S
    if "--timeout" in argv:
        try:
            timeout_s = float(argv[argv.index("--timeout") + 1])
        except (IndexError, ValueError):
            print("--timeout needs a number of seconds", file=sys.stderr)
            return 1
    results: list = []
    print("reve-tpu-torch doctor", flush=True)
    done = _arm_hang_watchdog(timeout_s, results, "--json" in argv)
    _probe("accelerator", _cuda_devices, results=results)
    _probe("kernel build", _kernel_build, results=results)
    _probe("native core", _native_core, results=results)
    _probe("native mp4/mkv mux", _native_mp4_mkv, results=results)
    _probe("codecs", _codecs, required=False, results=results)
    _probe("model registry", _models, required=False, results=results)
    _probe("mini pipeline e2e", _mini_pipeline, results=results)
    done.set()
    ok = all(r["status"] != "fail" for r in results)
    if "--json" in argv:
        print(json.dumps({"ok": ok, "probes": results}))
    print("all good" if ok else "FAILURES above", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
