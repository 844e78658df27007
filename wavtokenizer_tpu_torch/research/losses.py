"""Losses of the enhancement stack.

Port of ``wavtokenizer_tpu/research/losses.py``:

* ``voice_focused_loss`` (try3.py:834-874): 0.3 * L1(time) + 0.7 * the sum
  over n_fft in (2048, 1024, 512) of mean((||X| - |Y|| + 0.3 * (1 -
  cos(angle X - angle Y))) * weights), 3x weight on the 80-3400 Hz band.
  The reference's ``linspace(0, 12000, n_bins)`` frequency axis is kept,
  hard-coded 12 kHz Nyquist included, and so is the truncation of both
  waveforms to the shorter one.
* ``feature_loss`` (tsne.py:152-169): mean channel-wise L2 distance.
* ``cosine_similarity_loss`` and ``hybrid_tsne_loss``
  (train_with_tsne.py:52-90): 0.7 voice-focused + 0.3 (1 - cosine).

The STFT is ``ops/spectral.py::stft`` with the rectangular window (torch.stft's
default without a window).  Where both spectra are 0 (silence), ``angle``
gives 0 on both sides and torch's gradient of ``abs`` and ``angle`` at 0 is 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.spectral import stft


def _weighted_stft_loss(x: torch.Tensor, y: torch.Tensor, n_fft: int) -> torch.Tensor:
    """One resolution of the weighted STFT loss (try3.py:851-864): hop
    n_fft // 4, rectangular window, centre reflect padding."""
    hop = n_fft // 4
    ones = np.ones(n_fft, np.float32)
    X = stft(x, n_fft, hop, window=ones)  # (B, T, F)
    Y = stft(y, n_fft, hop, window=ones)
    freqs = np.linspace(0, 12000, n_fft // 2 + 1)
    weights = 1.0 + ((freqs >= 80) & (freqs <= 3400)).astype(np.float32) * 2.0
    mag = (X.abs() - Y.abs()).abs()
    phase = 1.0 - torch.cos(torch.angle(X) - torch.angle(Y))
    return torch.mean((mag + 0.3 * phase) * torch.as_tensor(weights, device=x.device))


def voice_focused_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(B, T) waveforms -> scalar (try3.py:834-874)."""
    n = min(output.shape[-1], target.shape[-1])
    output, target = output[..., :n], target[..., :n]
    time_loss = torch.mean((output - target).abs())
    stft_total = (_weighted_stft_loss(output, target, 2048)
                  + _weighted_stft_loss(output, target, 1024)
                  + _weighted_stft_loss(output, target, 512))
    return 0.3 * time_loss + 0.7 * stft_total


def feature_loss(enhanced: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(B, T', D) features -> mean L2 distance over the channel axis
    (tsne.py:152-169; the blessed variant returns the distance term only)."""
    return torch.linalg.vector_norm(enhanced - target, dim=-1).mean()


def cosine_similarity_loss(enhanced: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - mean cosine similarity along the channel axis
    (train_with_tsne.py:52-90's 't-SNE' term)."""
    e = enhanced / (torch.linalg.vector_norm(enhanced, dim=-1, keepdim=True) + 1e-8)
    t = target / (torch.linalg.vector_norm(target, dim=-1, keepdim=True) + 1e-8)
    return 1.0 - torch.mean(torch.sum(e * t, dim=-1))


def hybrid_tsne_loss(output: torch.Tensor, target_audio: torch.Tensor,
                     enhanced_feats: torch.Tensor, target_feats: torch.Tensor) -> torch.Tensor:
    """0.7 voice-focused + 0.3 cosine (train_with_tsne.py:52-90)."""
    return (0.7 * voice_focused_loss(output, target_audio)
            + 0.3 * cosine_similarity_loss(enhanced_feats, target_feats))
