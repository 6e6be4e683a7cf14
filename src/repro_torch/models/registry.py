"""Architecture registry: --arch <id> resolution.

Full production configs live in `repro_torch/configs/<id>.py` (one file per
assigned architecture, exact published hyperparameters). Each config module
exposes `FULL` (the published config), `SMOKE` (a reduced same-family config
for CPU tests) and `SHAPES` (the input-shape set assigned to the arch).
"""

from __future__ import annotations

import importlib
from typing import Any

ARCH_IDS = (
    "nemotron-4-15b",
    "llama3-8b",
    "codeqwen1.5-7b",
    "qwen1.5-110b",
    "musicgen-medium",
    "deepseek-v2-236b",
    "llama4-maverick-400b-a17b",
    "zamba2-2.7b",
    "falcon-mamba-7b",
    "llama-3.2-vision-90b",
)


def _module(arch_id: str):
    name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str, variant: str = "full"):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    mod = _module(arch_id)
    return mod.FULL if variant == "full" else mod.SMOKE


def get_shapes(arch_id: str) -> dict[str, Any]:
    return dict(_module(arch_id).SHAPES)


def list_archs() -> tuple[str, ...]:
    return ARCH_IDS
