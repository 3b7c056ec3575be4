"""whisper-medium [audio] — enc-dec; conv frontend is a STUB (``input_specs``
provides precomputed frame embeddings). [arXiv:2212.04356; unverified] (copy of
``repro/configs/whisper_medium.py``)."""
from repro_torch.config.base import Family, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family=Family.AUDIO,
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=4096, vocab_size=51865,
        is_encoder_decoder=True, enc_num_layers=24, enc_max_len=1500,
        cross_attn_every=1, mlp_gated=False, mlp_act="gelu",
        max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-smoke", family=Family.AUDIO,
        num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512,
        is_encoder_decoder=True, enc_num_layers=2, enc_max_len=32,
        cross_attn_every=1, mlp_gated=False, mlp_act="gelu",
        remat=False, max_seq_len=128,
    )
