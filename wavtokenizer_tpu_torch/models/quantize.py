"""Single-codebook VQ inference and the codes -> features lookup.

Port of the inference part of ``wavtokenizer_tpu/models/quantize.py``
(ref encoder/quantization/core_vq.py + vq.py).  Params:
{"embed": (n_q, bins, dim) f32, "esq": (n_q, bins) f32 = |E|^2 per code,
"pack": (n_q, 2, bins, dim) f32, the VQ kernel's split codebook}.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.vq import codebook_lookup, nearest_codebook_indices


@dataclass(frozen=True)
class VQConfig:
    """Mirror of ResidualVectorQuantizer args (ref vq.py:41-58)."""
    dimension: int = 512
    n_q: int = 1
    bins: int = 4096
    decay: float = 0.99
    kmeans_init: bool = True
    kmeans_iters: int = 50
    threshold_ema_dead_code: int = 2
    commitment_weight: float = 1.0


def vq_infer(params: dict, x: torch.Tensor):
    """Production inference, n_q = 1 (ref vq.py:115-140).

    x (B, T, D) -> (quantized (B, T, D), codes (1, B, T) int32)."""
    B, T, D = x.shape
    idx = nearest_codebook_indices(x.reshape(B * T, D), params["embed"][0],
                                   params["esq"][0], params["pack"][0]).reshape(B, T)
    return codebook_lookup(idx, params["embed"][0]), idx[None]


def codes_to_features(params: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes (K, B, T) or (K, T) -> summed codebook embeddings (B, T, D)
    (ref decoder/pretrained.py:209-239)."""
    if codes.dim() == 2:
        codes = codes[:, None, :]
    embed = params["embed"]
    if codes.shape[0] > embed.shape[0]:
        raise ValueError(f"{codes.shape[0]} code layers for {embed.shape[0]} codebooks")
    out = codebook_lookup(codes[0], embed[0])
    for q in range(1, codes.shape[0]):
        out = out + codebook_lookup(codes[q], embed[q])
    return out
