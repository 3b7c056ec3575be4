"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8 + 1 shared.
[arXiv:2501.kimi2; unverified] (copy of
``repro/configs/kimi_k2_1t_a32b.py``)."""
from repro_torch.config.base import Family, ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family=Family.MOE,
        num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=2048, vocab_size=163840,
        moe=MoEConfig(num_experts=384, top_k=8, capacity_factor=1.25,
                      dispatch="scatter", num_shared_experts=1),
        max_seq_len=131072,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-smoke", family=Family.MOE,
        num_layers=3, d_model=128, num_heads=8, num_kv_heads=2,
        d_ff=64, vocab_size=512,
        moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=2.0,
                      dispatch="scatter", num_shared_experts=1),
        remat=False, max_seq_len=128,
    )
