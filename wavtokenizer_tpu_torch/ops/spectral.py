"""Spectral ops: the inverse STFT with "same" padding (the ISTFT head's last
step), and the STFT and mel spectrogram of the training losses and the
spectral discriminators.

Port of ``wavtokenizer_tpu/ops/spectral.py``:

* ``istft_same`` (ref decoder/spectral_ops.py:33-75): irfft of every frame
  (backward norm), periodic Hann window, overlap-add, division by the
  squared-window envelope, and a trim of (n_fft - hop) // 2 samples at both
  ends.  The JAX package computes the windowed inverse DFT as one matmul
  for the TPU; here it is ``torch.fft.irfft``, the same function.
* ``stft`` (torch.stft, center reflect pad), ``mel_filterbank``
  (torchaudio's HTK filterbank without norm, numpy), ``mel_spectrogram``
  and ``safe_log`` (ref decoder/loss.py:12-39, decoder/modules.py:194-205).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window, as ``torch.hann_window(win_length)``."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(B, T, W) frames at the given hop -> (B, (T - 1) * hop + W).

    Needs W % hop == 0 (every shipped config: 1280/320, 2400/600): the sum
    is then R = W // hop shifted adds of hop-wide chunks."""
    B, T, W = frames.shape
    if W % hop_length:
        raise NotImplementedError(f"overlap_add needs W % hop == 0, got {W}, {hop_length}")
    R = W // hop_length
    chunks = frames.reshape(B, T, R, hop_length)
    acc = frames.new_zeros((B, T + R - 1, hop_length))
    for r in range(R):
        acc[:, r:r + T] += chunks[:, :, r]
    return acc.reshape(B, (T + R - 1) * hop_length)


@lru_cache(maxsize=32)
def _window_envelope_np(n_fft: int, hop_length: int, T: int, pad: int) -> np.ndarray:
    """Squared-window overlap-add envelope, trimmed like the signal."""
    w2 = hann_window(n_fft).astype(np.float64) ** 2
    out_len = (T - 1) * hop_length + n_fft
    env = np.zeros(out_len, dtype=np.float64)
    for t in range(T):
        env[t * hop_length:t * hop_length + n_fft] += w2
    env = env[pad:out_len - pad]
    if not (env > 1e-11).all():
        raise ValueError("NOLA check failed")
    return env.astype(np.float32)


def istft_same(spec_real: torch.Tensor, spec_imag: torch.Tensor, n_fft: int,
               hop_length: int) -> torch.Tensor:
    """spec_real/imag (B, T, n_fft // 2 + 1) -> (B, T * hop) waveform."""
    B, T, N = spec_real.shape
    if N != n_fft // 2 + 1:
        raise ValueError(f"{N} bins do not fit n_fft={n_fft}")
    pad = (n_fft - hop_length) // 2
    frames = torch.fft.irfft(torch.complex(spec_real, spec_imag), n=n_fft, dim=-1)
    window = torch.as_tensor(hann_window(n_fft), device=frames.device)
    y = overlap_add(frames * window, hop_length)
    y = y[:, pad:y.shape[1] - pad]
    env = torch.as_tensor(_window_envelope_np(n_fft, hop_length, T, pad),
                          device=y.device)
    return y / env


def stft(x: torch.Tensor, n_fft: int, hop_length: int,
         win_length: int | None = None, window: np.ndarray | None = None) -> torch.Tensor:
    """Complex STFT of (B, L) -> (B, T, n_fft // 2 + 1): torch.stft with
    center reflect padding.  The default window is the periodic Hann; a
    window shorter than n_fft is centre-padded to n_fft (torch.stft's rule)."""
    if win_length is None:
        win_length = n_fft
    if window is None:
        window = hann_window(win_length)
    window = torch.as_tensor(np.asarray(window, np.float32), device=x.device)
    spec = torch.stft(x, n_fft, hop_length, win_length, window, center=True,
                      pad_mode="reflect", onesided=True, return_complex=True)
    return spec.transpose(1, 2)


def _hz_to_mel(f) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) triangular filterbank from 0 Hz to Nyquist,
    torchaudio's ``melscale_fbanks`` with mel_scale="htk" and norm=None (the
    MelSpectrogram defaults of ref decoder/loss.py:21)."""
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2.0), n_mels + 2)
    f_pts = _mel_to_hz(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def mel_spectrogram(x: torch.Tensor, sample_rate: int, n_fft: int,
                    hop_length: int, n_mels: int) -> torch.Tensor:
    """Magnitude mel spectrogram of (B, L) -> (B, n_mels, T), torchaudio's."""
    mag = stft(x, n_fft, hop_length).abs()
    fb = torch.as_tensor(mel_filterbank(sample_rate, n_fft, n_mels), device=x.device)
    return torch.einsum("btf,fm->bmt", mag, fb)


def safe_log(x: torch.Tensor, clip_val: float = 1e-7) -> torch.Tensor:
    """log with clipping (ref decoder/modules.py:194-205)."""
    return torch.log(torch.clamp(x, min=clip_val))
