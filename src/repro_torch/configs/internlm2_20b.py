"""internlm2-20b [dense] — GQA kv=8. [arXiv:2403.17297; hf] (copy of
``repro/configs/internlm2_20b.py``)."""
from repro_torch.config.base import Family, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", family=Family.DENSE,
        num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16384, vocab_size=92544, rope_theta=1e6, max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b-smoke", family=Family.DENSE,
        num_layers=4, d_model=128, num_heads=8, num_kv_heads=2,
        d_ff=256, vocab_size=512, remat=False, max_seq_len=128,
    )
