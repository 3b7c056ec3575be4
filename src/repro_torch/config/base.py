"""Model, speculative-decoding and training configs of the PyTorch port.

A copy of ``repro/config/base.py`` (``ModelConfig``, ``SpecConfig``,
``MoEConfig``, ``OptimizerConfig``, ``TrainConfig`` and the enums): the
port imports nothing of the JAX package, so it keeps its own. Field
names, defaults and derived properties are unchanged; the differences
are the read-path switch ``attn_impl``, whose values here are
``"gather"`` (plain torch over the cache's logical view) and
``"kernel"`` (the CUDA cascade kernels in ``repro_torch/csrc``), and
``TrainConfig.checkpoint_dir``, which defaults under the temp directory.
"""
from __future__ import annotations

import dataclasses
import enum
import os
import tempfile
from typing import Optional, Tuple


class AttnKind(str, enum.Enum):
    GLOBAL = "global"          # full causal attention
    LOCAL = "local"            # sliding-window causal attention
    RECURRENT = "recurrent"    # RG-LRU block (attention-free)
    RWKV = "rwkv"              # RWKV6 time-mix (attention-free)
    CROSS = "cross"            # cross-attention to external context (VLM / enc-dec)


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    HYBRID = "hybrid"
    SSM = "ssm"
    VLM = "vlm"
    AUDIO = "audio"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    dispatch: str = "einsum"
    num_shared_experts: int = 0
    router_dtype: str = "float32"


#: Values of ``attn_impl`` on ModelConfig and DrafterConfig.
ATTN_IMPLS = ("gather", "kernel")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: Family = Family.DENSE

    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: Optional[int] = None          # default d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 512

    # Layer pattern, repeated cyclically over depth.
    layer_pattern: Tuple[str, ...] = ("global",)
    sliding_window: int = 4096
    logit_softcap: Optional[float] = None      # gemma2 final-logit softcap
    attn_softcap: Optional[float] = None       # gemma2 attention-logit softcap

    # MLP
    mlp_act: str = "silu"                      # silu => SwiGLU
    mlp_gated: bool = True

    # Attention details
    qkv_bias: bool = False                     # qwen2-style QKV bias
    rope_theta: float = 10000.0
    qk_norm: bool = False

    # MoE (None => dense FFN)
    moe: Optional[MoEConfig] = None

    # Encoder-decoder
    is_encoder_decoder: bool = False
    enc_num_layers: int = 0
    enc_max_len: int = 1500

    # VLM / cross attention
    cross_attn_every: int = 0
    num_vision_tokens: int = 0

    # RWKV / recurrent
    rwkv_head_dim: int = 64
    rglru_width: Optional[int] = None
    conv1d_width: int = 4

    # KV-cache read path for decode/verify steps.
    #   "gather": attend over the cache's logical view in plain torch
    #             (paged: the pool gathered in page-table order).
    #   "kernel": the CUDA cascade phase-1 kernels read the cache buffers
    #             in place (paged: pool + page table), then the phase-2
    #             merge with the tree block. On a CPU tensor the kernel
    #             wrappers run their plain torch versions.
    attn_impl: str = "gather"

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "full"
    scan_layers: bool = True
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    use_post_norm: bool = False                # gemma2 sandwich norm

    max_seq_len: int = 8192

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % self.num_kv_heads == 0, (
            f"num_heads={self.num_heads} not divisible by kv={self.num_kv_heads}")
        assert self.attn_impl in ATTN_IMPLS, (
            f"attn_impl={self.attn_impl!r} not in {ATTN_IMPLS}")

    # ---- derived ----
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def pattern_for_depth(self) -> Tuple[str, ...]:
        p = self.layer_pattern
        reps = (self.num_layers + len(p) - 1) // len(p)
        return tuple((p * reps)[: self.num_layers])

    @property
    def is_attention_free(self) -> bool:
        kinds = set(self.pattern_for_depth())
        return kinds <= {"recurrent", "rwkv"}

    @property
    def is_subquadratic(self) -> bool:
        kinds = set(self.pattern_for_depth())
        return "global" not in kinds

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd
        total = v * d
        if not self.tie_embeddings:
            total += v * d
        attn = d * n_q + 2 * d * n_kv + n_q * d
        if self.qkv_bias:
            attn += n_q + 2 * n_kv
        ffn_dense = d * dff * (3 if self.mlp_gated else 2)
        if self.moe is not None:
            ffn = self.moe.num_experts * ffn_dense + d * self.moe.num_experts
            ffn += self.moe.num_shared_experts * ffn_dense
        else:
            ffn = ffn_dense
        rec = 0
        if "recurrent" in self.pattern_for_depth():
            w = self.rglru_width or d
            rec = 2 * d * w + w * d + 2 * w + self.conv1d_width * w
        rwkv = 0
        if "rwkv" in self.pattern_for_depth():
            rwkv = 4 * d * d + 2 * d * dff
        norms = 2 * d
        for kind in self.pattern_for_depth():
            if kind in ("global", "local"):
                per = attn + ffn + norms
            elif kind == "recurrent":
                per = rec + ffn_dense + norms
            elif kind == "rwkv":
                per = rwkv + norms
            else:
                per = attn + ffn + norms
            total += per
        if self.cross_attn_every:
            n_cross = self.num_layers // self.cross_attn_every
            total += n_cross * (attn + norms)
        if self.is_encoder_decoder:
            total += self.enc_num_layers * (attn + ffn_dense + norms)
            total += self.num_layers * (attn + norms)
        return int(total)


# Built-in draft strategies. The port registers "d2sd" and "dflash"
# (core/strategies.py); the others name ROADMAP items.
KNOWN_STRATEGIES: Tuple[str, ...] = (
    "d2sd", "dflash", "naive_k", "dflash_second", "eagle")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """D2SD speculative decoding configuration (paper §3)."""
    gamma: int = 16                 # block size (anchor + gamma-1 drafted)
    top_k_branches: int = 4         # K
    feature_layers: int = 3
    mode: str = "d2sd"              # see KNOWN_STRATEGIES
    third_level: bool = False       # Table 7: one more VP level
    temperature: float = 0.0        # 0 => greedy verification
    prefix_beta: float = 0.8
    loss_tau: float = 4.0
    max_target_len: int = 4096

    def __post_init__(self):
        names = KNOWN_STRATEGIES
        if self.mode not in names:
            try:
                from repro_torch.core import strategies as _strategies
                names = tuple(_strategies.registered_strategies())
            except ImportError:
                pass
        if self.mode not in names:
            raise ValueError(
                f"SpecConfig.mode={self.mode!r} is not a registered draft "
                f"strategy; known: {sorted(names)}")
        if self.gamma < 2:
            raise ValueError(
                "gamma must cover anchor + >=1 drafted token")
        if self.top_k_branches < 1:
            raise ValueError("top_k_branches must be >= 1")

    @property
    def strategy(self) -> str:
        return self.mode


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"             # adamw | adamw8bit | adafactor
    lr: float = 3e-4
    warmup_steps: int = 20
    total_steps: int = 300
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    grad_accum: int = 1
    # int8 gradient all-reduce with error feedback (multi-GPU, not ported)
    compress_grads: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    seq_len: int = 128
    seed: int = 0
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    checkpoint_every: int = 100
    # the JAX default is /tmp/repro_ckpt; here the temp directory's own
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "repro_ckpt"))
    async_checkpoint: bool = False
    log_every: int = 10
    # fault tolerance
    max_restarts: int = 3
