"""rwkv6-1.6b "Finch" [ssm]: attention-free, data-dependent decay
[arXiv:2404.05892] (copy of ``repro/configs/rwkv6_1_6b.py``)."""
from repro_torch.config.base import Family, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family=Family.SSM,
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        head_dim=64, d_ff=7168, vocab_size=65536,
        layer_pattern=("rwkv",), rwkv_head_dim=64, max_seq_len=1048576,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family=Family.SSM,
        num_layers=3, d_model=128, num_heads=8, num_kv_heads=8, head_dim=16,
        d_ff=256, vocab_size=512, layer_pattern=("rwkv",), rwkv_head_dim=16,
        remat=False, max_seq_len=128,
    )
