"""grok-1-314b [moe] — 8 experts top-2. [hf:xai-org/grok-1; unverified]
(copy of ``repro/configs/grok1_314b.py``)."""
from repro_torch.config.base import Family, ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family=Family.MOE,
        num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=32768, vocab_size=131072,
        moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25,
                      dispatch="scatter"),
        max_seq_len=8192,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="grok-1-smoke", family=Family.MOE,
        num_layers=3, d_model=128, num_heads=8, num_kv_heads=2,
        d_ff=256, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=2.0,
                      dispatch="scatter"),
        remat=False, max_seq_len=128,
    )
