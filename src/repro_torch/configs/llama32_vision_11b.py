"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th block.
Vision frontend is a STUB: ``input_specs`` provides precomputed patch
embeddings (projected to d_model). [hf:meta-llama/Llama-3.2-11B-Vision;
unverified] (copy of
``repro/configs/llama32_vision_11b.py``)."""
from repro_torch.config.base import Family, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family=Family.VLM,
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=128256, cross_attn_every=5,
        num_vision_tokens=1601, rope_theta=5e5, max_seq_len=131072,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-smoke", family=Family.VLM,
        num_layers=5, d_model=128, num_heads=8, num_kv_heads=2,
        d_ff=256, vocab_size=512, cross_attn_every=5,
        num_vision_tokens=16, remat=False, max_seq_len=128,
    )
