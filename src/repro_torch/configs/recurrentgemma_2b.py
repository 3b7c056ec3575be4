"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1 attention : 2
recurrent, MQA kv=1 [arXiv:2402.19427] (copy of
``repro/configs/recurrentgemma_2b.py``)."""
from repro_torch.config.base import Family, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family=Family.HYBRID,
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256000,
        layer_pattern=("recurrent", "recurrent", "local"),
        sliding_window=2048, rglru_width=2560, conv1d_width=4,
        mlp_act="gelu", tie_embeddings=True, max_seq_len=524288,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke", family=Family.HYBRID,
        num_layers=5, d_model=128, num_heads=4, num_kv_heads=1, head_dim=32,
        d_ff=256, vocab_size=512,
        layer_pattern=("recurrent", "recurrent", "local"),
        sliding_window=16, rglru_width=128, conv1d_width=4,
        mlp_act="gelu", tie_embeddings=True, remat=False, max_seq_len=128,
    )
