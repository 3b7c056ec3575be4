"""stablelm-3b [dense] — MHA (kv=heads). [hf:stabilityai/stablelm-3b;
unverified] (copy of
``repro/configs/stablelm_3b.py``)."""
from repro_torch.config.base import Family, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b", family=Family.DENSE,
        num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
        d_ff=6912, vocab_size=50304, max_seq_len=4096,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b-smoke", family=Family.DENSE,
        num_layers=4, d_model=128, num_heads=8, num_kv_heads=8,
        d_ff=256, vocab_size=512, remat=False, max_seq_len=128,
    )
