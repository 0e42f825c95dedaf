"""Drop-in compatible CLI of the PyTorch/CUDA port (video mode).

Counterpart of reve_tpu/cli.py with the same argv surface, defaults and
exit codes (flag-for-flag parity with the reference CLI,
reve-shared/src/lib.rs:209-280):

    reve -i <input.mp4|mkv|y4m> -s {2,3,4} [-S segsize] [-c crf] [-p preset]
         [-x x265params] <output.mp4|mkv|y4m>

This slice ports the video job: fresh and resumed runs, --dtype
auto|float32|bfloat16 (auto = bfloat16), --model/--weights/-m, --batch,
--tile 0|-1, --device N (cuda:N), --io-backend, --workspace, --yes,
--keep-workspace, --progress-json, --trace and --profile-dir
(torch.profiler).  Flags whose feature is not ported yet exit 2 with a
one-line "not yet ported in reve_tpu_torch" message naming the
ROADMAP.md port-queue item; they are never silently ignored.

`run(argv, device=None)`: the `device` keyword is for callers and tests
(e.g. device="cpu"); --device on the command line wins.  With neither,
the job runs on cuda:0 and raises NoCudaDeviceError without CUDA.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from fractions import Fraction
from typing import List, Optional

from reve_tpu_torch.pipeline.planner import plan_segments
from reve_tpu_torch.pipeline.state import JobState, Workspace, repair_pending


PRESETS = (
    "ultrafast", "superfast", "veryfast", "faster", "fast", "medium",
    "slow", "slower", "veryslow",
)
VIDEO_EXTS = (".mp4", ".mkv")
IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def _input_validation(s: str) -> str:
    if not os.path.exists(s):
        raise argparse.ArgumentTypeError("input path not found")
    if os.path.isdir(s):
        return s  # directory of images: refused in run() (not ported)
    if not s.lower().endswith(VIDEO_EXTS + (".y4m",) + IMAGE_EXTS):
        raise argparse.ArgumentTypeError(
            "valid input formats: mp4/mkv (videos), png/jpg/webp/bmp "
            "(images), or a directory of images"
        )
    return s


def _scale_validation(s: str) -> int:
    v = int(s)
    if v not in (2, 3, 4):
        raise argparse.ArgumentTypeError("upscale ratio must be 2, 3 or 4")
    return v


def _positive_int(name):
    def check(s: str) -> int:
        v = int(s)
        if v <= 0:
            raise argparse.ArgumentTypeError(f"{name} must be positive")
        return v
    return check


def _positive_float(name):
    def check(s: str) -> float:
        v = float(s)
        if v <= 0:
            raise argparse.ArgumentTypeError(f"{name} must be positive")
        return v
    return check


def _crf_validation(s: str) -> int:
    v = int(s)
    if not 0 <= v <= 51:
        raise argparse.ArgumentTypeError("crf must be in 0..51")
    return v


def _preset_validation(s: str) -> str:
    if s not in PRESETS:
        raise argparse.ArgumentTypeError(
            "valid: " + "/".join(PRESETS)
        )
    return s


def build_parser() -> argparse.ArgumentParser:
    from reve_tpu_torch.version import __version__

    p = argparse.ArgumentParser(
        prog="reve",
        description="Real-ESRGAN video upscaler with resumability "
                    "(PyTorch/CUDA port)",
    )
    p.add_argument("--version", action="version",
                   version=f"reve-tpu-torch {__version__}")
    p.add_argument("-i", "--inputpath", required=True,
                   type=_input_validation, help="input video path (mp4/mkv)")
    p.add_argument("outputpath", help="output video path (mp4/mkv)")
    p.add_argument("-s", "--scale", required=True, type=_scale_validation,
                   help="upscale ratio (2, 3, 4)")
    # the reference's README documents -P while its clap derive implements
    # -S (README.md:54 vs reve-shared/src/lib.rs:220); accept both
    p.add_argument("-S", "-P", "--segmentsize",
                   type=_positive_int("segment size"), default=1000,
                   help="segment size (in frames)")
    p.add_argument("-c", "--crf", type=_crf_validation, default=15,
                   help="video constant rate factor (crf: 51-0)")
    p.add_argument("-p", "--preset", type=_preset_validation, default="slow",
                   help="video encoding preset")
    p.add_argument("-x", "--x265params",
                   default="psy-rd=2:aq-strength=1:deblock=0,0:bframes=8",
                   help="x265 encoding parameters")
    # --- extensions ---
    p.add_argument("--model", default="realesr-animevideov3")
    p.add_argument("--weights", default=None,
                   help="path to .pth weights (ncnn .param: not ported)")
    p.add_argument("--weights-wdn", default=None,
                   help="denoise-variant .pth for --denoise (not ported)")
    p.add_argument("--denoise", type=float, default=None, metavar="D",
                   help="denoise strength 0..1 (not ported)")
    p.add_argument("--batch", type=_positive_int("batch"), default=4,
                   help="frames per GPU batch")
    p.add_argument("--tile", type=int, default=0,
                   help="tile size (0=auto, -1=never tile; >0 not ported)")
    p.add_argument("--dtype",
                   choices=("auto", "bfloat16", "float32", "int8"),
                   default="auto",
                   help="compute dtype.  auto (default) = bfloat16 "
                        "(int8: not ported)")
    p.add_argument("--int8-calib", default=None, dest="int8_calib",
                   metavar="max|p<PCT>", help="int8 calibration (not "
                                              "ported)")
    p.add_argument("--tta", action="store_true",
                   help="8-transform self-ensemble (not ported)")
    p.add_argument("--int8-gate", type=float, default=None, metavar="DB",
                   help="int8 PSNR gate (not ported)")
    p.add_argument("--device", default=None, metavar="N[,M,...]",
                   help="run on CUDA device N (cuda:N); a comma list "
                        "(several devices) is not ported")
    p.add_argument("-f", "--format", choices=("png", "jpg", "webp"),
                   default=None,
                   help="image output format for image/directory modes "
                        "(not ported)")
    p.add_argument("-m", "--models-dir", default=None, metavar="DIR",
                   dest="models_dir",
                   help="directory searched for --model's weights "
                        "(<name>.pth).  Replaces the default search path "
                        "($REVE_TPU_MODELS_DIR, then ./models); an "
                        "explicit --weights wins")
    p.add_argument("--allow-random-init", action="store_true",
                   dest="allow_random_init",
                   help="run with deterministic RANDOM weights when no "
                        "trained weights resolve for --model (tests/"
                        "benchmarks only: the output will NOT be a trained "
                        "upscale).  Without this flag (or "
                        "REVE_TPU_ALLOW_RANDOM_INIT=1) a job with no "
                        "weights refuses to start")
    p.add_argument("--compile-attempts", type=_positive_int(
                   "compile-attempts"), default=None, metavar="N",
                   help="best-of-N XLA compiles (the JAX package's TPU "
                        "compile-lottery guard; no counterpart here)")
    p.add_argument("--io-backend", choices=("ffmpeg", "cv2", "y4m"),
                   default=None)
    p.add_argument("--workspace", default=None,
                   help="resume workspace dir (default: <output>.revework)")
    p.add_argument("--yes", action="store_true",
                   help="resume without asking (non-interactive)")
    p.add_argument("--keep-workspace", action="store_true",
                   help="do not delete the workspace after success")
    p.add_argument("--scene-align", action="store_true",
                   help="snap segments to scene cuts (not ported)")
    p.add_argument("--progress-json", default=None, metavar="FILE",
                   help="append machine-readable JSON progress snapshots "
                        "to FILE (one object per line)")
    p.add_argument("--trace", default=None, metavar="FILE",
                   help="write JSONL stage-timing events to FILE")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="capture a torch.profiler trace into DIR")
    p.add_argument("--shard-worker", default=None, metavar="ID",
                   help="lease-queue worker (not ported)")
    p.add_argument("--lease-stale-after",
                   type=_positive_float("lease-stale-after"), default=None,
                   metavar="SECONDS", help="shard lease timeout (not "
                                           "ported)")
    return p


def _not_ported(what: str, item: str) -> int:
    print(f"{what}: not yet ported in reve_tpu_torch (ROADMAP.md port "
          f"queue: {item})", file=sys.stderr)
    return 2


def _refuse_unported(args) -> Optional[int]:
    """Exit code 2 for any requested feature this slice does not carry."""
    if os.path.isdir(args.inputpath) or \
            args.inputpath.lower().endswith(IMAGE_EXTS):
        return _not_ported("image and directory inputs", "image mode")
    checks = (
        (args.dtype == "int8", "--dtype int8", "int8 turbo, K4/K5"),
        (args.int8_calib is not None, "--int8-calib", "int8 turbo, K4/K5"),
        (args.int8_gate is not None, "--int8-gate", "int8 turbo, K4/K5"),
        (args.tta, "--tta", "TTA, K6"),
        (args.denoise is not None or args.weights_wdn is not None,
         "--denoise/--weights-wdn", "ncnn/dni weights"),
        (args.tile > 0, f"--tile {args.tile}", "tiling"),
        (args.shard_worker is not None or args.lease_stale_after is not None,
         "--shard-worker/--lease-stale-after", "multi-GPU"),
        (args.scene_align, "--scene-align", "scene-aligned segments"),
        (bool(args.weights) and args.weights.endswith((".param", ".bin")),
         "ncnn --weights", "ncnn/dni weights"),
    )
    for cond, what, item in checks:
        if cond:
            return _not_ported(what, item)
    from reve_tpu_torch.models import registry

    spec, _ = registry.parse_model_name(args.model)
    if spec.arch != "srvgg":
        return _not_ported(f"--model {args.model} ({spec.arch})", "RRDB, K7")
    if args.compile_attempts is not None:
        print("--compile-attempts has no counterpart in reve_tpu_torch "
              "(the JAX package's XLA compile-lottery guard)",
              file=sys.stderr)
        return 2
    return None


def _confirm(prompt: str, assume_yes: bool) -> bool:
    """Explicit consent, mirroring the reference's interactive confirms
    (reve-cli/src/main.rs:47-90).  A non-interactive run (no tty) must not
    silently resume or discard prior work: it aborts unless --yes was
    given."""
    if assume_yes:
        return True
    if not sys.stdin.isatty():
        raise SystemExit(
            f"{prompt} — non-interactive session; pass --yes to confirm"
        )
    answer = input(f"{prompt} [Y/n] ").strip().lower()
    return answer in ("", "y", "yes")


def _fresh_state(args) -> JobState:
    from reve_tpu_torch.io import probe
    from reve_tpu_torch.models import registry

    info = probe.probe(args.inputpath, backend=args.io_backend)
    if info.frame_count <= 0:
        raise SystemExit("could not determine frame count")
    fps = info.fps if info.fps else Fraction(30, 1)
    pending = plan_segments(info.frame_count, args.segmentsize)
    return JobState(
        input_path=os.path.abspath(args.inputpath),
        output_path=os.path.abspath(args.outputpath),
        scale=args.scale,
        segment_size=args.segmentsize,
        frame_count=info.frame_count,
        fps_num=fps.numerator,
        fps_den=fps.denominator,
        width=info.width,
        height=info.height,
        pending=pending,
        plan=list(pending),
        encode={
            "crf": args.crf,
            "preset": args.preset,
            "x265_params": args.x265params,
        },
        model=args.model,
        opts={
            "weights": args.weights,
            "dtype": args.dtype,
            "tta": False,
            "io_backend": args.io_backend,
            # persist the random-init opt-in: a resume continues the
            # decision the job was STARTED with (like every other opt)
            "allow_random_init": bool(
                args.allow_random_init or registry.random_init_allowed()),
        },
    )


def _resolve_device(args, device):
    """--device N -> cuda:N (a comma list of several devices is not
    ported); else the caller's `device`; else None (the engine's default,
    cuda:0).  Returns (device, error_exit_code)."""
    if args.device is None:
        return device, None
    try:
        idxs = [int(t) for t in str(args.device).split(",") if t.strip()]
    except ValueError:
        print(f"--device must be a device index or comma list of "
              f"indices, got {args.device!r}", file=sys.stderr)
        return None, 2
    if not idxs:
        print("--device needs at least one device index", file=sys.stderr)
        return None, 2
    if len(idxs) > 1:
        return None, _not_ported("--device with several devices",
                                 "multi-GPU")
    import torch

    n = torch.cuda.device_count()
    if not 0 <= idxs[0] < n:
        print(f"--device {idxs[0]} out of range: this host has {n} CUDA "
              f"device(s)", file=sys.stderr)
        return None, 2
    return f"cuda:{idxs[0]}", None


def run(argv: Optional[List[str]] = None, device=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if "--list-models" in argv:
        from reve_tpu_torch.models import registry

        dirs = None
        for i, a in enumerate(argv):
            if a in ("-m", "--models-dir") and i + 1 < len(argv):
                dirs = [argv[i + 1]]
            elif a.startswith("--models-dir="):
                dirs = [a.split("=", 1)[1]]
        for name, spec in registry.list_models():
            scales = spec.upscale or "2|3|4"
            found = [s for s in ([spec.upscale] if spec.upscale
                                 else (2, 3, 4))
                     if registry.resolve_weights(name, s, dirs)]
            w = (f"weights: x{'/x'.join(map(str, found))}" if found
                 else "weights: none (jobs refuse to start; "
                      "--allow-random-init to override)")
            ported = "" if spec.arch == "srvgg" else "  (not ported)"
            print(f"{name}  [{spec.arch}, x{scales}]  {w}{ported}")
        return 0
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    err = _refuse_unported(args)
    if err is not None:
        return err
    err = _apply_models_dir(args)
    if err is not None:
        return err
    err = _require_weights(args)
    if err is not None:
        return err
    if os.path.exists(args.outputpath):
        print("output path already exists", file=sys.stderr)
        return 2
    if args.format is not None:
        print("--format applies to image/directory modes (video output "
              "format follows the output extension)", file=sys.stderr)
        return 2
    if not args.outputpath.lower().endswith(VIDEO_EXTS + (".y4m",)):
        print("valid output formats: mp4/mkv", file=sys.stderr)
        return 2
    if args.inputpath.lower().endswith(".mkv") and \
            not args.outputpath.lower().endswith(".mkv"):
        # reference refuses mkv -> mp4 (reve-cli/src/main.rs:124-140)
        print("mkv input requires mkv output", file=sys.stderr)
        return 2

    # resolve the device BEFORE any workspace exists: a rejected
    # invocation must not leave behind a fresh state file
    device, err = _resolve_device(args, device)
    if err is not None:
        return err
    from reve_tpu_torch import device as device_mod

    device = device_mod.resolve_device(device)

    ws = Workspace(args.workspace or args.outputpath + ".revework")
    if not ws.acquire_owner():
        print(f"another live process is already working on this "
              f"workspace ({ws.owner_path}); wait for it to finish",
              file=sys.stderr)
        return 2
    try:
        if ws.has_state():
            if _confirm("found an interrupted job — resume?", args.yes):
                state = ws.load()
                if state.model != args.model:
                    print(f"workspace holds progress for model {state.model!r};"
                          f" resume with the same --model or start fresh",
                          file=sys.stderr)
                    return 2
                if state.scale != args.scale:
                    # the reference resumes with its SAVED args wholesale
                    # (main.rs:92-101); we match that but say so
                    print(f"resume: using saved -s {state.scale} (command "
                          f"line said {args.scale})", file=sys.stderr)
                # resumed segments must go through the same model/weights/
                # container as the committed ones (the reference's
                # args.temp, main.rs:92-101)
                state.opts.setdefault("allow_random_init",
                                      not state.opts.get("weights"))
                for key in ("weights", "dtype", "io_backend",
                            "allow_random_init"):
                    if key in state.opts and \
                            getattr(args, key) != state.opts[key]:
                        if key == "dtype" and args.dtype == "auto":
                            print(f"resume: continuing on the saved "
                                  f"--dtype={state.opts[key]!r} path",
                                  file=sys.stderr)
                        else:
                            print(f"resume: using saved "
                                  f"--{key.replace('_', '-')}"
                                  f"={state.opts[key]!r} (command line said "
                                  f"{getattr(args, key)!r})",
                                  file=sys.stderr)
                        setattr(args, key, state.opts[key])
                if state.opts.get("tta") or \
                        state.opts.get("denoise") is not None or \
                        args.dtype == "int8":
                    return _not_ported(
                        "resuming a job saved with int8, --tta or "
                        "--denoise", "int8 turbo / TTA / ncnn-dni weights")
                ws.create(keep_parts=True)
                state = repair_pending(state, ws, ext=_part_ext(args))
                print(
                    f"resuming: {len(state.pending)} segment(s) remaining",
                    file=sys.stderr,
                )
            else:
                if not _confirm("discard previous progress and start over?",
                                args.yes):
                    return 1
                err = _require_weights(args, skip_if_resumable=False)
                if err is not None:
                    return err
                ws.create(keep_parts=False)
                state = _fresh_state(args)
        else:
            ws.create(keep_parts=False)
            state = _fresh_state(args)
        ws.save(state)

        from reve_tpu_torch.pipeline import scheduler
        from reve_tpu_torch.pipeline.engine import UpscaleEngine
        from reve_tpu_torch.pipeline.progress import (ConsoleRenderer,
                                                      JsonlRenderer,
                                                      ProgressTracker,
                                                      TeeRenderer)
        from reve_tpu_torch.utils import trace as trace_mod

        import time as _time

        tracer = trace_mod.Tracer(args.trace) if args.trace else \
            trace_mod.from_env()
        if args.dtype == "auto":
            # the RESOLVED dtype is persisted so a resume runs the same path
            args.dtype, notes = scheduler.resolve_auto_dtype(ws)
            for msg in notes:
                print(msg, file=sys.stderr)
            state.opts["dtype"] = args.dtype
            ws.save(state)
        engine = UpscaleEngine(
            model=state.model, scale=state.scale, weights=args.weights,
            batch_size=args.batch, tile=args.tile, compute_dtype=args.dtype,
            device=device, allow_random_init=args.allow_random_init or None,
        )
        renderer = ConsoleRenderer()
        jsonl = JsonlRenderer(args.progress_json) if args.progress_json \
            else None
        remaining = sum(s.size for s in state.pending)
        tracker = ProgressTracker(
            total_frames=remaining,
            total_segments=len(state.pending),
            on_update=TeeRenderer(renderer, jsonl),
            source_fps=state.fps_num / max(state.fps_den, 1),
        )
        run_t0 = _time.monotonic()
        job = scheduler.PipelineJob(
            state, ws, engine, io_backend=args.io_backend,
            part_ext=_part_ext(args), progress=tracker, tracer=tracer,
        )
        try:
            with trace_mod.device_profile(args.profile_dir):
                state = job.run()
        except KeyboardInterrupt:
            # committed parts + state are already on disk (checkpoint
            # after every segment)
            job.cancel()
            done = len(ws.completed_parts(_part_ext(args)))
            print(f"\ninterrupted — {done} segment(s) committed; rerun the "
                  f"same command to resume", file=sys.stderr)
            return 130
        report = scheduler.finalize(
            state, ws, io_backend=args.io_backend, part_ext=_part_ext(args)
        )
        enc_note = f", encoder: {job.encoder_desc}" if job.encoder_desc \
            else ""
        # end-to-end x-realtime for the frames THIS run processed
        rate_note = ""
        elapsed = _time.monotonic() - run_t0
        done_frames = tracker.stages["encode"].done
        src_fps = state.fps_num / max(state.fps_den, 1)
        if elapsed > 0 and done_frames and src_fps > 0:
            e2e_fps = done_frames / elapsed
            rate_note = (f", {e2e_fps:.3g} fps end-to-end = "
                         f"{e2e_fps / src_fps:.3g}x realtime")
        print(f"\ndone: {state.output_path} (concat backend: "
              f"{report['backend']}{enc_note}, path: {args.dtype} on "
              f"{engine.device}{rate_note})", file=sys.stderr)
        if not args.keep_workspace:
            ws.destroy()
        return 0
    finally:
        ws.release_owner()


def _require_weights(args, skip_if_resumable: bool = True) -> Optional[int]:
    """Weights are a product requirement: a random-init 'upscale' is
    hours of compute emitting plausible-looking garbage, so it is an
    explicit opt-in (--allow-random-init / REVE_TPU_ALLOW_RANDOM_INIT=1),
    never a fallback.  Runs BEFORE any workspace/probe/decode.

    `skip_if_resumable`: an existing interrupted workspace defers the check
    to the resume path (the saved opts are the contract)."""
    from reve_tpu_torch.models import registry

    if args.weights or registry.random_init_allowed(
            True if args.allow_random_init else None):
        return None
    if skip_if_resumable and Workspace(
            args.workspace or args.outputpath + ".revework").has_state():
        return None
    if registry.resolve_weights(args.model, args.scale) is not None:
        return None
    spec, _ = registry.parse_model_name(args.model)
    stem = spec.canonical if spec.upscale is not None else \
        f"{spec.canonical}-x{args.scale}"
    print(registry.missing_weights_message(args.model, args.scale, stem),
          file=sys.stderr)
    return 2


def _apply_models_dir(args) -> Optional[int]:
    """--models-dir DIR: resolve --model's weights from DIR into
    args.weights.  An explicitly named directory with no matching weights
    is an error."""
    if args.models_dir is None or args.weights:
        return None
    if not os.path.isdir(args.models_dir):
        print(f"--models-dir {args.models_dir!r} is not a directory",
              file=sys.stderr)
        return 2
    from reve_tpu_torch.models import registry

    w = registry.resolve_weights(args.model, args.scale,
                                 [args.models_dir])
    if w is None:
        print(f"no weights for {args.model!r} (x{args.scale}) in "
              f"{args.models_dir!r} (expected <name>.pth or "
              f"<name>.param + .bin)", file=sys.stderr)
        return 2
    if w.endswith(".param"):
        return _not_ported(f"ncnn weights {w!r}", "ncnn/dni weights")
    args.weights = w
    return None


def _part_ext(args) -> str:
    return ".y4m" if args.io_backend == "y4m" else ".mp4"


def main() -> None:
    from reve_tpu_torch.device import NoCudaDeviceError

    try:
        sys.exit(run())
    except NoCudaDeviceError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(2)


if __name__ == "__main__":
    main()
