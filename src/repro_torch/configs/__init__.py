"""Architecture registry: one module per assigned architecture.

``get_config(name)`` returns the full-scale ModelConfig; ``get_smoke(name)``
the reduced same-family sibling used by CPU smoke tests.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "qwen3_moe_235b_a22b",
    "moonshot_v1_16b_a3b",
    "qwen1_5_4b",
    "smollm_360m",
    "gemma2_9b",
    "llama3_2_1b",
    "hymba_1_5b",
    "xlstm_350m",
    "chameleon_34b",
    "whisper_large_v3",
]

ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
ALIASES.update({
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen1.5-4b": "qwen1_5_4b",
    "smollm-360m": "smollm_360m",
    "gemma2-9b": "gemma2_9b",
    "llama3.2-1b": "llama3_2_1b",
    "hymba-1.5b": "hymba_1_5b",
    "xlstm-350m": "xlstm_350m",
    "chameleon-34b": "chameleon_34b",
    "whisper-large-v3": "whisper_large_v3",
})


def _module(name: str):
    key = ALIASES.get(name, name)
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE


def list_archs():
    return list(ARCH_IDS)
