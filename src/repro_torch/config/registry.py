"""Architecture registry: ``--arch <id>`` lookup (twin of
``repro/config/registry.py``).

Every id of the JAX package's ``ARCH_IDS`` resolves, and so does
``paper-target`` (the Qwen3-8B-shaped target; ``smoke=True`` gives the
small target of the empirical study). Each module in
``repro_torch.configs`` has a full-size config (``full()``) and a reduced
smoke config (``smoke()``), field by field the JAX module's.
``paper-drafter`` is not an id here: JAX maps it to a module that never
registers it, so its ``get_config`` raises ``KeyError`` for it, and so
does the port's.
"""
from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.config.base import ModelConfig

ARCH_IDS = (
    "qwen2.5-3b",
    "internlm2-20b",
    "gemma2-2b",
    "stablelm-3b",
    "recurrentgemma-2b",
    "kimi-k2-1t-a32b",
    "grok-1-314b",
    "llama-3.2-vision-11b",
    "whisper-medium",
    "rwkv6-1.6b",
)

_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "internlm2-20b": "internlm2_20b",
    "gemma2-2b": "gemma2_2b",
    "stablelm-3b": "stablelm_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "grok-1-314b": "grok1_314b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "whisper-medium": "whisper_medium",
    "rwkv6-1.6b": "rwkv6_1_6b",
    # the paper's own target (reduced-scale analogue under smoke=True)
    "paper-target": "paper_target",
}


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    mod = _MODULES.get(arch_id)
    if mod is None:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod}")
    return mod.smoke() if smoke else mod.full()


def all_archs() -> Tuple[str, ...]:
    """The JAX package's ``ARCH_IDS``, in its order (``paper-target``
    resolves too, and is not listed, as in JAX)."""
    return ARCH_IDS
