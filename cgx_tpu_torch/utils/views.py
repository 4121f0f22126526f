"""Clamped gathers and offset views for the plain PyTorch versions of the
kernels.

JAX gathers clamp an out-of-range index into the array's valid range
(cgx_tpu/utils/views.py); torch indexing raises or reads garbage instead.
Every gather of a plain version goes through ``take`` or an ``OffsetView``,
and the CUDA kernels clamp the same way (``clampi`` and ``View`` in
csrc/common.cuh).

An ``OffsetView`` is a local slice of a global array addressed by global
indices (the sharded index keeps each shard's slice of the corpus arrays):
``shape`` reports the global length, and ``view[idx]`` clamps ``idx - off``
into the slice, as the JAX view does.  So ``take(view, idx)`` is a read the
JAX body bounds explicitly against the global length (``View::atg``), and
``view[idx]`` one it leaves unbounded (``View::at``).  On a whole tensor, or
an identity view, the two are the same read.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class OffsetView:
    """``arr`` (a local slice) addressed by global indices: ``arr[0]`` is
    global element ``off`` of a ``glen``-word array."""

    arr: torch.Tensor
    off: int
    glen: int

    @property
    def shape(self):
        return (self.glen,)

    @property
    def device(self):
        return self.arr.device

    def __getitem__(self, idx):
        return self.arr[(idx - self.off).clamp(0, self.arr.shape[0] - 1)
                        .long()]


def as_view(arr) -> OffsetView:
    """``arr`` itself if it is a view, else the identity view of a tensor."""
    if isinstance(arr, OffsetView):
        return arr
    return OffsetView(arr, 0, arr.shape[0])


def take(arr, idx: torch.Tensor) -> torch.Tensor:
    """``arr[idx]`` with ``idx`` clamped into ``[0, len(arr) - 1]`` (for a
    view: into the global array, then into its slice)."""
    return arr[idx.clamp(0, arr.shape[0] - 1).long()]
