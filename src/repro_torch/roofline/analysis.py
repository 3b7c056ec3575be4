"""Roofline terms of a dry-run cell (twin of
``repro/roofline/analysis.py``), at an NVIDIA H100 SXM's peaks:

    compute term    = FLOPs_per_rank / PEAK_FLOPS
    memory term     = HBM_bytes_per_rank / HBM_BW
    collective term = collective_bytes_per_rank / link rate

These terms are modelled, not measured: the FLOPs and collective bytes
are counted on a shape-only trace of the rank's step
(``roofline/trace_analysis.py``), the HBM bytes come from the analytic
traffic model below (JAX's, term for term), and each is divided by a
published peak. Nothing here ran on a card.

Peaks (the ``hopper-kernels`` guide's H100 SXM figures, in place of the
TPU v5e's of the JAX module): 989 TFLOP/s dense bf16 on the tensor
cores, 3.35 TB/s HBM3. Links: NVLink 4 at 450 GB/s each way for an axis
whose ranks share a host of 8 cards; an axis that crosses hosts goes
over the inter-host network, taken here as one 400 Gb/s NDR InfiniBand
port a card, 50 GB/s each way (:data:`INTER_HOST_BW`, an assumption:
the DGX H100 reference design's eight ConnectX-7 ports a host). Both
16-wide axes of the production meshes span two hosts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

from repro_torch.config.base import ModelConfig, ShapeSpec

# NVIDIA H100 SXM per card
PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s each way, within a host of 8 cards
INTER_HOST_BW = 50e9         # bytes/s each way: one 400 Gb/s NDR port
LINK_BW = INTER_HOST_BW      # the production meshes' axes cross hosts
CARDS_PER_HOST = 8


def link_bw(axis_sizes: Sequence[int],
            cards_per_host: int = CARDS_PER_HOST) -> float:
    """The slowest link a collective over a mesh of ``axis_sizes`` (ranks
    row-major, ``cards_per_host`` consecutive ranks a host) crosses:
    NVLink when every axis of size > 1 stays inside a host (the product
    of it and the axes inside it divides ``cards_per_host``), else the
    inter-host rate."""
    inner = 1
    for n in reversed(list(axis_sizes)):
        inner *= n
        if n > 1 and cards_per_host % inner:
            return INTER_HOST_BW
    return NVLINK_BW


def model_flops(cfg: ModelConfig, tokens: int, train: bool) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); 2*N*D for inference."""
    n = cfg.active_param_count()
    mult = 6.0 if train else 2.0
    return mult * n * tokens


@dataclasses.dataclass
class Terms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_dev: float
    hbm_bytes_per_dev: float
    coll_bytes_per_dev: float
    model_flops: float
    hlo_flops_global: float      # the traced FLOPs of every rank
    chips: int

    @property
    def dominant(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)

    @property
    def useful_ratio(self) -> float:
        return (self.model_flops / self.hlo_flops_global
                if self.hlo_flops_global else 0.0)

    @property
    def roofline_fraction(self) -> float:
        """useful-model-FLOP time / roofline-limited step time: how close
        the step is to the compute roofline on its dominant resource."""
        t = max(self.compute_s, self.memory_s, self.collective_s)
        useful = self.model_flops / (PEAK_FLOPS * self.chips)
        return useful / t if t else 0.0

    def as_dict(self):
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, useful_ratio=self.useful_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def analytic_hbm_bytes(cfg: ModelConfig, shape: ShapeSpec, kind: str,
                       chips: int, param_bytes_per_dev: float,
                       state_bytes_per_dev: float = 0.0,
                       opt_bytes_per_dev: float = 0.0,
                       spec_overhead: float = 1.0) -> float:
    """Per-rank HBM traffic model for one step (JAX's).

    train:   read params (fwd) + read (bwd) + write grads + read+write opt
             + activation traffic (remat: ~2 fwd + 1 bwd passes of layer IO)
    prefill: read params + write KV + activation IO
    decode:  read params + read KV cache (the decisive term) + tree IO
    """
    d = cfg.d_model
    n_layers = cfg.num_layers
    act_bpe = 2.0                                 # bf16 activations
    if kind == "train":
        tokens_dev = shape.global_batch * shape.seq_len / max(chips, 1)
        act_io = 12 * n_layers * tokens_dev * d * act_bpe
        return (4 * param_bytes_per_dev + 3 * opt_bytes_per_dev + act_io)
    if kind == "prefill":
        tokens_dev = shape.global_batch * shape.seq_len / max(chips, 1)
        kv_write = state_bytes_per_dev
        act_io = 8 * n_layers * tokens_dev * d * act_bpe
        return param_bytes_per_dev + kv_write + act_io
    # decode: one spec-decoding cycle
    return (param_bytes_per_dev * spec_overhead + state_bytes_per_dev)


def derive_terms(cfg: ModelConfig, shape: ShapeSpec, kind: str, chips: int,
                 counts: Dict[str, float], hbm_bytes_per_dev: float,
                 tokens_for_model_flops: float,
                 link: float = LINK_BW) -> Terms:
    """``counts``: the rank's ``flops`` and ``coll_bytes`` (the trace's,
    ``trace_analysis.trace_counts``; JAX's HLO reading has the same
    keys); ``link``: the collective rate (:func:`link_bw`)."""
    flops_dev = counts.get("flops", 0.0)
    coll_dev = counts.get("coll_bytes", 0.0)
    mf = model_flops(cfg, int(tokens_for_model_flops), kind == "train")
    return Terms(
        compute_s=flops_dev / PEAK_FLOPS,
        memory_s=hbm_bytes_per_dev / HBM_BW,
        collective_s=coll_dev / link,
        flops_per_dev=flops_dev,
        hbm_bytes_per_dev=hbm_bytes_per_dev,
        coll_bytes_per_dev=coll_dev,
        model_flops=mf,
        hlo_flops_global=flops_dev * chips,
        chips=chips,
    )
