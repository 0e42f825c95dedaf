"""Model registry: reference-compatible model names -> (arch config, weights).

Counterpart of reve_tpu/models/registry.py with the same names, search
order, environment variables and MissingWeightsError gate.  SRVGG models
(.pth, or the reference's own ncnn .param/.bin files, weights/ncnn.py)
and the RRDB models at x4 and x2 (.pth) are ported.  An ncnn file named
for an RRDB model is refused (ncnn files hold SRVGG graphs; reve_tpu's
RRDB loader reads .pth only).  RRDB x1, which no registered name
selects, is refused where a config reaches the model
(rrdb.check_cfg).

The reference selects models by name string: the CLI hardcodes
`realesr-animevideov3-x2` with the real ratio in `-s`
(reve-shared/src/lib.rs:140-143); the GUI whitelists `realesr-animevideov3`
and `realesr-realvideo` (reve-gui/src-tauri/src/configuration.rs:28-39).
This registry accepts all those spellings plus upstream Real-ESRGAN names.

Weight resolution order:
  1. explicit `weights=` path (.pth, or .param with sibling .bin)
  2. `<models_dir>/<canonical-name>.{pth,param+bin}` for each dir in
     REVE_TPU_MODELS_DIR / ./models
  3. no weights -> MissingWeightsError.  The reference cannot run without
     its model files (realesrgan-ncnn-vulkan loads
     models/realesr-animevideov3-x2.{param,bin} and errors out when they
     are absent; reve-shared/src/lib.rs:140-143 names the model the binary
     must load), and a random-init "upscale" is hours of compute emitting
     plausible-looking garbage.  Deterministic random init (seed 0) is an
     explicit OPT-IN for tests/benchmarks/dry runs: pass
     allow_random_init=True or set REVE_TPU_ALLOW_RANDOM_INIT=1.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional, Tuple

from reve_tpu_torch.models.srvgg import SRVGGConfig, init_params

log = logging.getLogger(__name__)


class MissingWeightsError(FileNotFoundError):
    """No weights resolve for a requested model and random init was not
    explicitly allowed.  Product entry points (CLI/service/API) surface
    this message verbatim; it names the model, the searched path, and how
    to supply weights."""


def random_init_allowed(explicit=None) -> bool:
    """Is the random-init fallback permitted?  `explicit` (a caller's
    allow_random_init argument) wins when not None; otherwise the
    REVE_TPU_ALLOW_RANDOM_INIT env var decides (unset/falsy -> False)."""
    if explicit is not None:
        return bool(explicit)
    env = os.environ.get("REVE_TPU_ALLOW_RANDOM_INIT")
    if env is None:
        return False
    return env.strip().lower() not in ("0", "", "off", "false", "no")


def missing_weights_message(name: str, scale, stem: str,
                            dirs=None) -> str:
    """The one user-facing explanation for 'no weights' — shared by the
    CLI's pre-flight refusal and MissingWeightsError so the two surfaces
    can never drift."""
    searched = list(dirs) if dirs is not None else _search_dirs()
    return (
        f"no weights found for model {name!r}: searched "
        f"{searched} for {stem + '.pth'!r} or "
        f"{stem + '.param'!r}+'.bin'.  Supply weights with "
        f"--weights FILE or -m/--models-dir DIR (CLI), weights=/"
        f"models_dir (API/service), or $REVE_TPU_MODELS_DIR.  To run "
        f"with deterministic RANDOM weights instead (output will NOT "
        f"be a trained upscale — tests/benchmarks only), pass "
        f"--allow-random-init / allow_random_init=True or set "
        f"REVE_TPU_ALLOW_RANDOM_INIT=1"
    )


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    arch: str                # "srvgg" | "rrdb"
    canonical: str           # canonical weight-file stem
    num_feat: int
    num_conv: int            # srvgg: hidden convs; rrdb: num blocks
    upscale: Optional[int]   # None -> taken from request (-s flag)


_SPECS = {
    # reference's shipped family (README.md:52): XS-size SRVGG, scale by name
    "realesr-animevideov3": ModelSpec("srvgg", "realesr-animevideov3", 64, 16, None),
    # GUI alias (configuration.rs:28-39) — maps to the same net in reference
    "realesr-realvideo": ModelSpec("srvgg", "realesr-animevideov3", 64, 16, None),
    # opt-in distilled 8-hidden-conv student of the model above; weights
    # are produced locally (scripts/distill.py in the JAX package)
    "realesr-animevideov3-fast": ModelSpec(
        "srvgg", "realesr-animevideov3-fast", 64, 8, None),
    # upstream general model, S-size SRVGG (+ its weak-denoise twin for
    # --denoise interpolation, weights/interpolate.py)
    "realesr-general-x4v3": ModelSpec("srvgg", "realesr-general-x4v3", 64, 32, 4),
    "realesr-general-wdn-x4v3": ModelSpec("srvgg", "realesr-general-wdn-x4v3", 64, 32, 4),
    # RRDBNet stretch models (BASELINE.json config #4)
    "realesrgan-x4plus": ModelSpec("rrdb", "RealESRGAN_x4plus", 64, 23, 4),
    "realesrgan-x4plus-anime": ModelSpec("rrdb", "RealESRGAN_x4plus_anime_6B", 64, 6, 4),
    # upstream zoo completeness: x2 RRDB (pixel-unshuffled input) and the
    # no-GAN RealESRNet twin of x4plus (same arch, different weights)
    "realesrgan-x2plus": ModelSpec("rrdb", "RealESRGAN_x2plus", 64, 23, 2),
    "realesrnet-x4plus": ModelSpec("rrdb", "RealESRNet_x4plus", 64, 23, 4),
}


def list_models():
    """[(name, spec)] for every registered model (CLI --list-models)."""
    return sorted(_SPECS.items())


def parse_model_name(name: str) -> Tuple[ModelSpec, Optional[int]]:
    """Accepts 'realesr-animevideov3', 'realesr-animevideov3-x2', etc."""
    base, scale = name, None
    if name[-3:-1] == "-x" and name[-1].isdigit():
        base, scale = name[:-3], int(name[-1])
    if base not in _SPECS and name in _SPECS:
        base, scale = name, None
    if base not in _SPECS:
        raise ValueError(
            f"unknown model {name!r}; known: {sorted(_SPECS)}"
        )
    spec = _SPECS[base]
    if spec.upscale is not None:
        scale = spec.upscale
    return spec, scale


def _search_dirs():
    dirs = []
    env = os.environ.get("REVE_TPU_MODELS_DIR")
    if env:
        dirs.extend(env.split(":"))
    dirs.append("models")
    return dirs


def _find_weight_files(stem: str, dirs=None):
    for d in (dirs if dirs is not None else _search_dirs()):
        pth = os.path.join(d, stem + ".pth")
        if os.path.exists(pth):
            return ("pth", pth)
        par = os.path.join(d, stem + ".param")
        if os.path.exists(par) and os.path.exists(os.path.join(d, stem + ".bin")):
            return ("ncnn", par)
    return None


def resolve_weights(name: str, scale: Optional[int] = None,
                    dirs=None) -> Optional[str]:
    """Path of the weight file for model `name` (+ requested scale) under
    `dirs` (default: the REVE_TPU_MODELS_DIR / ./models search path), or
    None when absent.  The CLI's --models-dir (the replaced ncnn engine's
    `-m model-path` switch) resolves through this so an explicitly named
    directory that holds no weights is an error instead of a silent
    random-init fallback."""
    spec, name_scale = parse_model_name(name)
    scale = scale or name_scale or 2
    stem = spec.canonical
    if spec.upscale is None:
        stem = f"{stem}-x{scale}"
    found = (_find_weight_files(stem, dirs)
             or _find_weight_files(spec.canonical, dirs))
    return found[1] if found else None


def load_model(name: str, scale: Optional[int] = None,
               weights: Optional[str] = None,
               allow_random_init: Optional[bool] = None):
    """Resolve a model name (+ requested scale) to (cfg, params).

    Returns (SRVGGConfig, params) for srvgg archs and (RRDBConfig, params)
    for the rrdb archs, params as float32 CPU tensors.  SRVGG loads .pth
    or ncnn .param/.bin (weights/ncnn.py); RRDB loads .pth only: an
    explicit ncnn file is refused (ValueError), and one on the search path
    is passed over, as reve_tpu's rrdb.load_model passes it over.

    Raises MissingWeightsError when no weights resolve, unless random init
    is explicitly allowed (`allow_random_init=True` or
    REVE_TPU_ALLOW_RANDOM_INIT=1) — the reference fails hard without its
    model files (reve-shared/src/lib.rs:140-143).
    """
    spec, name_scale = parse_model_name(name)
    scale = scale or name_scale or 2

    stem = spec.canonical
    if spec.upscale is None:
        stem = f"{stem}-x{scale}"

    if weights:
        if weights.endswith(".param"):
            found = ("ncnn", weights)
        elif weights.endswith(".bin"):
            found = ("ncnn", weights[:-4] + ".param")
        else:
            found = ("pth", weights)
    else:
        found = _find_weight_files(stem) or _find_weight_files(spec.canonical)

    if spec.arch == "rrdb":
        if found is not None and found[0] == "ncnn":
            if weights:
                raise ValueError(
                    f"ncnn weights ({found[1]}) hold SRVGG graphs only: "
                    f"{name!r} is an RRDBNet and loads a .pth")
            found = None  # passed over, as reve_tpu's rrdb.load_model does
        from reve_tpu_torch.models import rrdb

        return rrdb.load_model(spec, scale,
                               None if found is None else found[1],
                               allow_random_init=allow_random_init)

    if found is None:
        if not random_init_allowed(allow_random_init):
            raise MissingWeightsError(
                missing_weights_message(name, scale, stem))
        log.warning(
            "no weights found for %s (searched %s); using deterministic "
            "random init — output will not be a trained upscale",
            stem, _search_dirs(),
        )
        cfg = SRVGGConfig(
            num_feat=spec.num_feat, num_conv=spec.num_conv, upscale=scale
        )
        return cfg, init_params(cfg)

    kind, path = found
    if kind == "ncnn":
        from reve_tpu_torch.weights import ncnn

        cfg, params = ncnn.load_files(path, path[:-6] + ".bin")
    else:
        from reve_tpu_torch.weights.torch_loader import load_srvgg_pth

        cfg, params = load_srvgg_pth(path)
    if cfg.upscale != scale:
        raise ValueError(
            f"weights at {path} are x{cfg.upscale} but x{scale} was requested"
        )
    return cfg, params
