"""Architecture registry: ``--arch <id>`` lookup (twin of
``repro/config/registry.py``).

The port has one architecture's blocks so far: ``paper-target`` (the
Qwen3-8B-shaped target; ``smoke=True`` gives the small target of the
empirical study). The JAX package's other ids raise until their blocks
and configs are ported.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.config.base import ModelConfig

_NOT_PORTED = ("qwen2.5-3b", "internlm2-20b", "gemma2-2b", "stablelm-3b",
               "recurrentgemma-2b", "kimi-k2-1t-a32b", "grok-1-314b",
               "llama-3.2-vision-11b", "whisper-medium", "rwkv6-1.6b",
               "paper-drafter")


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id == "paper-target":
        from repro_torch.configs import paper_target
        return paper_target.smoke() if smoke else paper_target.full()
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported: ROADMAP.md queue 1, slice C "
            "(the configs/* configs and their blocks)")
    raise KeyError(f"unknown arch {arch_id!r}; known: {all_archs()}")


def all_archs() -> Tuple[str, ...]:
    return ("paper-target",)
