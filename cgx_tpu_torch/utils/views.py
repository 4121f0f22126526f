"""Clamped gathers for the plain PyTorch versions of the kernels.

JAX gathers clamp an out-of-range index into the array's valid range
(cgx_tpu/utils/views.py); torch indexing raises or reads garbage instead.
Every gather of a plain version goes through ``take``, and the CUDA kernels
clamp the same way (``clampi`` in csrc/common.cuh).
"""

from __future__ import annotations

import torch


def take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[idx]`` with ``idx`` clamped into ``[0, len(arr) - 1]``."""
    return arr[idx.clamp(0, arr.shape[0] - 1).long()]
