"""PyTorch/CUDA port of the D^2SD engine in ``repro``.

The JAX package ``repro`` is the reference. This package mirrors its
layout module for module (``repro_torch/models/attention.py`` is the twin
of ``repro/models/attention.py``) and imports only ``torch``, ``numpy``
and the standard library. Its kernels are CUDA C++ for ``sm_90a``, in
four sources built with ``nvcc`` at first use: the cascade phase-1
kernels and the flash attention forward, dq and dk/dv kernels, for
bfloat16 on the tensor cores (``csrc/cascade_phase1_sm90.cu``,
``csrc/flash_attention_sm90.cu``) and for float32 on the tensor cores in
3xTF32 (``csrc/cascade_phase1.cu``, ``csrc/flash_attention.cu``). The
sources share ``csrc/sm90_common.cuh``.

Entry points place their tensors on ``device="cuda"`` unless the caller
passes another device; asking for CUDA on a machine without a card
raises instead of falling back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument.

    Raises when CUDA is asked for and no card is visible: the port never
    drops to the CPU unless the caller passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run the plain torch path")
    return dev
