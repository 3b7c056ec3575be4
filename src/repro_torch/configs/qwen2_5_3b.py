"""qwen2.5-3b [dense] — GQA kv=2, QKV bias. [hf:Qwen/Qwen2.5-3B; hf] (copy of
``repro/configs/qwen2_5_3b.py``)."""
from repro_torch.config.base import Family, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family=Family.DENSE,
        num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
        d_ff=11008, vocab_size=151936, qkv_bias=True,
        rope_theta=1e6, max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b-smoke", family=Family.DENSE,
        num_layers=4, d_model=128, num_heads=8, num_kv_heads=2,
        d_ff=256, vocab_size=512, qkv_bias=True, remat=False,
        max_seq_len=128,
    )
