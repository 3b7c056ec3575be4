"""The paper's own setting (copy of ``repro/configs/paper_target.py``).

``full()`` is the Qwen3-8B-shaped target ('paper-target'); ``smoke()``
the small target of the empirical study; ``drafter_small()`` its
DFlash-style drafter.
"""
from repro_torch.config.base import Family, ModelConfig
from repro_torch.core.drafter import DrafterConfig


def full() -> ModelConfig:
    # Qwen3-8B-shaped: 36L, d=4096, 32H/8KV, ff 12288, vocab 151936
    return ModelConfig(
        name="paper-target", family=Family.DENSE,
        num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=12288, vocab_size=151936, qk_norm=True, rope_theta=1e6,
        max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    """The small target actually trained in the empirical study."""
    return ModelConfig(
        name="paper-target-small", family=Family.DENSE,
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=768, vocab_size=512, qk_norm=True, remat=False,
        max_seq_len=2048, dtype="float32",
    )


def drafter_small(gamma: int = 16, causal: bool = False) -> DrafterConfig:
    t = smoke()
    return DrafterConfig(
        d_model=192, num_layers=2, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=t.vocab_size,
        target_feature_dim=3 * t.d_model, gamma=gamma, causal=causal,
        dtype="float32",
    )
