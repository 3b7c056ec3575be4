"""gemma2-2b [dense] — local+global alternating, logit softcaps, post-norms.
[arXiv:2408.00118; hf] (copy of
``repro/configs/gemma2_2b.py``)."""
from repro_torch.config.base import Family, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family=Family.DENSE,
        num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4,
        head_dim=256, d_ff=9216, vocab_size=256000,
        layer_pattern=("local", "global"), sliding_window=4096,
        logit_softcap=30.0, attn_softcap=50.0, use_post_norm=True,
        mlp_act="gelu", tie_embeddings=True, max_seq_len=8192,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b-smoke", family=Family.DENSE,
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, layer_pattern=("local", "global"),
        sliding_window=16, logit_softcap=30.0, attn_softcap=50.0,
        use_post_norm=True, mlp_act="gelu", tie_embeddings=True,
        remat=False, max_seq_len=128,
    )
