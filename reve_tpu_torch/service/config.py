"""Service configuration: JSON file with validation + default regeneration.

The port's copy of reve_tpu/service/config.py, which mirrors the
reference GUI's config system (reve-gui/src-tauri/src/configuration.rs):
a JSON file under the user config dir, a whitelist-validated default
upscale model, an opt-in logging flag, and silent regeneration of a
default config when the file is missing or invalid (utils.rs:61-69
semantics).  The same kebab-case keys; the port reads its own file,
$XDG_CONFIG_HOME/reve-tpu-torch/reve-tpu-config.json (~/.config when
XDG_CONFIG_HOME is unset), so that the two packages' services never
rewrite each other's settings.  Every name in VALID_MODELS is one the
port's registry serves (models/registry.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

VALID_MODELS = (
    "realesr-animevideov3",
    "realesr-realvideo",          # reference GUI alias (configuration.rs:28-39)
    "realesr-animevideov3-fast",  # distilled 8-conv student
    "realesr-general-x4v3",
    "realesrgan-x4plus",
    "realesrgan-x4plus-anime",
)


@dataclasses.dataclass
class ServiceConfig:
    application_logs: bool = False
    default_upscale_type: str = "realesr-animevideov3"
    default_scale: int = 2
    segment_size: int = 1000
    crf: int = 15
    preset: str = "slow"

    def validate(self) -> bool:
        try:
            return (
                isinstance(self.application_logs, bool)
                and self.default_upscale_type in VALID_MODELS
                and self.default_scale in (2, 3, 4)
                and self.segment_size > 0
                and 0 <= self.crf <= 51
            )
        except TypeError:  # non-numeric JSON values: invalid, not a crash
            return False

    def to_json(self) -> dict:
        # key style matches the reference config file (kebab-case keys,
        # configuration.rs:9-16)
        return {
            "application-logs": self.application_logs,
            "default-upscale-type": self.default_upscale_type,
            "default-scale": self.default_scale,
            "segment-size": self.segment_size,
            "crf": self.crf,
            "preset": self.preset,
        }

    @staticmethod
    def from_json(d: dict) -> "ServiceConfig":
        return ServiceConfig(
            application_logs=d.get("application-logs", False),
            default_upscale_type=d.get(
                "default-upscale-type", "realesr-animevideov3"
            ),
            default_scale=d.get("default-scale", 2),
            segment_size=d.get("segment-size", 1000),
            crf=d.get("crf", 15),
            preset=d.get("preset", "slow"),
        )


def config_dir() -> str:
    base = os.environ.get("XDG_CONFIG_HOME") or os.path.join(
        os.path.expanduser("~"), ".config"
    )
    return os.path.join(base, "reve-tpu-torch")


def config_path() -> str:
    return os.path.join(config_dir(), "reve-tpu-config.json")


def load(path: Optional[str] = None) -> ServiceConfig:
    """Load config; regenerate the default on missing/invalid file."""
    path = path or config_path()
    try:
        with open(path) as f:
            cfg = ServiceConfig.from_json(json.load(f))
        if cfg.validate():
            return cfg
    except (OSError, json.JSONDecodeError, TypeError):
        pass
    cfg = ServiceConfig()
    save(cfg, path)
    return cfg


def save(cfg: ServiceConfig, path: Optional[str] = None) -> None:
    if not cfg.validate():
        raise ValueError("invalid configuration")
    path = path or config_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg.to_json(), f, indent=2)
