"""Vector-quantization primitives: nearest-code search and lookup.

Port of ``wavtokenizer_tpu/ops/vq.py``.  The distance is the reference's
``-(|x|^2 - 2 x.E^T + |E|^2)`` in fp32 with the lowest index winning ties
(ref encoder/quantization/core_vq.py:175-183); on the card it runs in the
hand-written kernel ``ops/kernels.py::vq_nearest``.
"""

from __future__ import annotations

import torch

from .kernels import vq_nearest


def nearest_codebook_indices(x: torch.Tensor, embed: torch.Tensor,
                             esq: torch.Tensor | None = None,
                             pack: torch.Tensor | None = None) -> torch.Tensor:
    """x (N, D), embed (C, D) -> (N,) int32 ids.  ``esq`` = |E|^2 per code,
    ``pack`` = the kernel's split codebook (``kernels.pack_vq_codebook``)."""
    return vq_nearest(x.float().contiguous(), embed, esq, pack)


def codebook_lookup(indices: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """indices (...,) -> (..., D)."""
    return embed[indices.long()]
