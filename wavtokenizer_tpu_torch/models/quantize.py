"""Vector quantization inference: single-codebook and residual, and the
codes -> features lookup.

Port of the inference part of ``wavtokenizer_tpu/models/quantize.py``
(ref encoder/quantization/core_vq.py + vq.py).  Params:
{"embed": (n_q, bins, dim) f32, "esq": (n_q, bins) f32 = |E|^2 per code,
"pack": (n_q, 2, bins, dim) f32, the VQ kernel's split codebook}.  Every
nearest-code search goes through ``ops/vq.py::nearest_codebook_indices``,
so on the card through the VQ kernel, with each layer's own ``esq[q]`` and
``pack[q]``.  Quirks kept from the reference:

* production inference (``vq_infer``) uses n_q = 1 (ref vq.py:115-140);
* ``vq_forward_language`` does NOT chain residuals: every layer quantizes
  the same input and the last layer's quantization is returned (ref
  core_vq.py:378-401), while ``vq_encode``/``vq_decode`` are the residual
  loop (ref core_vq.py:403-421).
"""

from __future__ import annotations

import math
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

    def bw_per_q(self, frame_rate: int) -> float:
        return math.log2(self.bins) * frame_rate

    def n_q_for_bandwidth(self, frame_rate: int,
                          bandwidth: float | None = None) -> int:
        """Target bandwidth in kbps -> number of quantizers (ref vq.py:142-152)."""
        if not bandwidth or bandwidth <= 0.0:
            return self.n_q
        return int(max(1, math.floor(bandwidth * 1000 / self.bw_per_q(frame_rate))))


def _nearest(params: dict, q: int, flat: torch.Tensor) -> torch.Tensor:
    return nearest_codebook_indices(flat, params["embed"][q], params["esq"][q],
                                    params["pack"][q])


def vq_infer(params: dict, x: torch.Tensor):
    """Production inference, n_q = 1 (ref vq.py:115-140).

    x (B, T, D) -> (quantized (B, T, D), codes (1, B, T) int32)."""
    B, T, D = x.shape
    idx = _nearest(params, 0, x.reshape(B * T, D)).reshape(B, T)
    return codebook_lookup(idx, params["embed"][0]), idx[None]


def vq_encode(params: dict, cfg: VQConfig, x: torch.Tensor,
              n_q: int | None = None) -> torch.Tensor:
    """Residual VQ encode (ref core_vq.py:403-413): layer q quantizes what
    the layers before it left.  x (B, T, D) -> codes (n_q, B, T) int32.

    Each layer's search waits on the residual of the one before, so the n_q
    kernel launches are a dependent chain.  The residual stays fp32."""
    n_q = n_q or cfg.n_q
    B, T, D = x.shape
    residual = x.reshape(B * T, D).float()
    codes = []
    for q in range(n_q):
        idx = _nearest(params, q, residual)
        codes.append(idx.reshape(B, T))
        if q + 1 < n_q:
            residual = residual - codebook_lookup(idx, params["embed"][q])
    return torch.stack(codes)


def vq_decode(params: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes (n_q, B, T) -> (B, T, D), the layers' codes looked up and summed
    (ref core_vq.py:415-421)."""
    embed = params["embed"]
    out = codebook_lookup(codes[0], embed[0])
    for q in range(1, codes.shape[0]):
        out = out + codebook_lookup(codes[q], embed[q])
    return out


def vq_forward_language(params: dict, cfg: VQConfig, x: torch.Tensor,
                        n_q: int | None = None):
    """Eval-mode LanguageVectorQuantization.forward (ref core_vq.py:378-401):
    every layer quantizes the SAME input; the features returned are the LAST
    layer's quantization.  x (B, T, D) -> (quantized (B, T, D),
    codes (n_q, B, T) int32)."""
    n_q = n_q or cfg.n_q
    B, T, D = x.shape
    flat = x.reshape(B * T, D)
    codes = [_nearest(params, q, flat).reshape(B, T) for q in range(n_q)]
    return codebook_lookup(codes[-1], params["embed"][n_q - 1]), torch.stack(codes)


def codes_to_features(params: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes (K, B, T) or (K, T) -> summed codebook embeddings (B, T, D)
    (ref decoder/pretrained.py:209-239)."""
    if codes.dim() == 2:
        codes = codes[:, None, :]
    if codes.shape[0] > params["embed"].shape[0]:
        raise ValueError(f"{codes.shape[0]} code layers for "
                         f"{params['embed'].shape[0]} codebooks")
    return vq_decode(params, codes)
