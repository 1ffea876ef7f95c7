"""Architecture registry of the port: ``--arch <id>`` resolves here.

A copy of ``repro.configs`` over the port's ``ModelConfig``. Each module
exposes FULL (the exact published config) and SMOKE (a reduced
same-family config for CPU tests), with its source in brackets.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "phi-3-vision-4.2b",
    "nemotron-4-340b",
    "yi-34b",
    "qwen3-32b",
    "granite-8b",
    "phi3.5-moe-42b-a6.6b",
    "olmoe-1b-7b",
    "hymba-1.5b",
    "hubert-xlarge",
    "mamba2-780m",
]

_MODULES = {
    "phi-3-vision-4.2b": "phi3_vision",
    "nemotron-4-340b": "nemotron_340b",
    "yi-34b": "yi_34b",
    "qwen3-32b": "qwen3_32b",
    "granite-8b": "granite_8b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "olmoe-1b-7b": "olmoe",
    "hymba-1.5b": "hymba_1p5b",
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-780m": "mamba2_780m",
}


def get(arch_id: str, smoke: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE if smoke else mod.FULL
