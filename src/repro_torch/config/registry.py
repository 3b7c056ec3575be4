"""Architecture registry: ``--arch <id>`` lookup (twin of
``repro/config/registry.py``).

The port has three architectures' blocks: ``paper-target`` (the
Qwen3-8B-shaped target; ``smoke=True`` gives the small target of the
empirical study), ``recurrentgemma-2b`` (RG-LRU + local attention) and
``rwkv6-1.6b`` (RWKV-6). The JAX package's other ids raise until their
blocks and configs are ported.
"""
from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.config.base import ModelConfig

_MODULES = {
    "paper-target": "paper_target",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}
_NOT_PORTED = ("qwen2.5-3b", "internlm2-20b", "gemma2-2b", "stablelm-3b",
               "kimi-k2-1t-a32b", "grok-1-314b", "llama-3.2-vision-11b",
               "whisper-medium", "paper-drafter")


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id in _MODULES:
        mod = importlib.import_module(
            f"repro_torch.configs.{_MODULES[arch_id]}")
        return mod.smoke() if smoke else mod.full()
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported: ROADMAP.md queue 1, slice C "
            "(the configs/* configs and their blocks)")
    raise KeyError(f"unknown arch {arch_id!r}; known: {all_archs()}")


def all_archs() -> Tuple[str, ...]:
    return tuple(_MODULES)
