"""Architecture registry: ``get_config(name)`` / ``--arch <id>``."""
from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, ShapeConfig, cell_applicable

ARCHS = (
    "internlm2_20b",
    "llama3_8b",
    "granite_20b",
    "qwen3_14b",
    "mamba2_1p3b",
    "internvl2_76b",
    "kimi_k2_1t",
    "grok1_314b",
    "musicgen_medium",
    "hymba_1p5b",
)

# CLI ids (dashes) ↔ module names (underscores)
_ALIAS = {a.replace("_", "-"): a for a in ARCHS}


def get_config(name: str) -> ModelConfig:
    key = name.replace("-", "_").replace(".", "p")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ALIAS)}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.config()


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig",
           "cell_applicable", "get_config", "all_configs"]
