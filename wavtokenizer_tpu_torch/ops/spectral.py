"""Spectral ops: the inverse STFT with "same" padding (the ISTFT head's last
step), and the STFT and mel spectrogram of the training losses and the
spectral discriminators.

Port of ``wavtokenizer_tpu/ops/spectral.py``:

* ``istft_same`` (ref decoder/spectral_ops.py:33-75): irfft of every frame
  (backward norm), periodic Hann window, overlap-add, division by the
  squared-window envelope, and a trim of (n_fft - hop) // 2 samples at both
  ends.  The JAX package computes the windowed inverse DFT as one matmul
  for the TPU; here it is ``torch.fft.irfft``, the same function.
* ``istft_center`` (torch.istft's center trim of n_fft // 2 at both ends;
  the inverse of ``stft(center=True)``, ref dd.py:34-62).
* ``stft`` (torch.stft's, framed by ``unfold`` so that its backward
  repeats on the card; optionally with the center reflect pad),
  ``mel_filterbank`` (torchaudio's HTK filterbank without norm, numpy),
  ``mel_spectrogram`` and ``safe_log`` (ref decoder/loss.py:12-39,
  decoder/modules.py:194-205, decoder/feature_extractors.py:30-51).
* ``mdct`` / ``imdct`` (ref decoder/spectral_ops.py:78-192), through
  ``torch.fft`` with the twiddles as numpy constants (``_mdct_consts``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window, as ``torch.hann_window(win_length)``."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(B, T, W) frames at the given hop -> (B, (T - 1) * hop + W).

    When W % hop == 0 (every shipped config: 1280/320, 2400/600) the sum is
    R = W // hop shifted adds of hop-wide chunks; otherwise ``F.fold`` adds
    each frame at its offset (the JAX package's scatter-add)."""
    B, T, W = frames.shape
    if W % hop_length:
        out_len = (T - 1) * hop_length + W
        return F.fold(frames.transpose(1, 2), output_size=(1, out_len),
                      kernel_size=(1, W), stride=(1, hop_length)).reshape(B, out_len)
    R = W // hop_length
    chunks = frames.reshape(B, T, R, hop_length)
    acc = frames.new_zeros((B, T + R - 1, hop_length))
    for r in range(R):
        acc[:, r:r + T] += chunks[:, :, r]
    return acc.reshape(B, (T + R - 1) * hop_length)


def _padded_window(n_fft: int, win_length: int) -> np.ndarray:
    """The periodic Hann window of ``win_length`` centred in ``n_fft``
    (torch.stft's rule for a shorter window)."""
    lpad = (n_fft - win_length) // 2
    return np.pad(hann_window(win_length), (lpad, n_fft - win_length - lpad))


@lru_cache(maxsize=32)
def _window_envelope_np(n_fft: int, hop_length: int, win_length: int, T: int,
                        pad: int) -> np.ndarray:
    """Squared-window overlap-add envelope, trimmed like the signal."""
    w2 = _padded_window(n_fft, win_length).astype(np.float64) ** 2
    out_len = (T - 1) * hop_length + n_fft
    env = np.zeros(out_len, dtype=np.float64)
    for t in range(T):
        env[t * hop_length:t * hop_length + n_fft] += w2
    env = env[pad:out_len - pad]
    if not (env > 1e-11).all():
        raise ValueError("NOLA check failed")
    return env.astype(np.float32)


def _istft(spec_real: torch.Tensor, spec_imag: torch.Tensor, n_fft: int,
           hop_length: int, win_length: int, pad: int) -> torch.Tensor:
    """irfft of every frame, window, overlap-add, ``pad`` samples trimmed at
    both ends, division by the squared-window envelope.

    A spectrum below fp32 (bf16: training's ``gen_compute_dtype``) is
    transformed in fp32, which ``torch.fft`` needs, and the windowed frames
    are rounded back to its type, where the JAX package's DFT matmul rounds
    its fp32 sums (``preferred_element_type=float32``, then the input's
    type): the overlap-add runs in that type, the envelope division in
    fp32."""
    B, T, N = spec_real.shape
    if N != n_fft // 2 + 1:
        raise ValueError(f"{N} bins do not fit n_fft={n_fft}")
    dtype = spec_real.dtype
    work = torch.promote_types(dtype, torch.float32)
    # A real inverse DFT has no use for the imaginary parts of the DC and
    # (even n_fft) Nyquist bins: pocketfft on the CPU and the JAX package's
    # DFT matrix ignore them, cuFFT's C2R transform leaves the result
    # undefined (on the H100 it used them at some batch sizes).  Zero them.
    keep = torch.ones(N, device=spec_imag.device, dtype=work)
    keep[0] = 0.0
    if n_fft % 2 == 0:
        keep[-1] = 0.0
    frames = torch.fft.irfft(torch.complex(spec_real.to(work), spec_imag.to(work) * keep),
                             n=n_fft, dim=-1)
    window = torch.as_tensor(_padded_window(n_fft, win_length), device=frames.device)
    y = overlap_add((frames * window).to(dtype), hop_length)
    y = y[:, pad:y.shape[1] - pad]
    env = torch.as_tensor(_window_envelope_np(n_fft, hop_length, win_length, T, pad),
                          device=y.device)
    return y / env


def istft_same(spec_real: torch.Tensor, spec_imag: torch.Tensor, n_fft: int,
               hop_length: int) -> torch.Tensor:
    """spec_real/imag (B, T, n_fft // 2 + 1) -> (B, T * hop) waveform."""
    return _istft(spec_real, spec_imag, n_fft, hop_length, n_fft, (n_fft - hop_length) // 2)


def istft_center(spec_real: torch.Tensor, spec_imag: torch.Tensor, n_fft: int,
                 hop_length: int, win_length: int | None = None) -> torch.Tensor:
    """torch.istft with center=True: (B, T, n_fft // 2 + 1) ->
    (B, (T - 1) * hop) waveform, n_fft // 2 trimmed at both ends."""
    return _istft(spec_real, spec_imag, n_fft, hop_length, win_length or n_fft, n_fft // 2)


def stft(x: torch.Tensor, n_fft: int, hop_length: int,
         win_length: int | None = None, window: np.ndarray | None = None,
         center: bool = True) -> torch.Tensor:
    """Complex STFT of (B, L) -> (B, T, n_fft // 2 + 1), torch.stft's
    (onesided, no normalization), with center reflect padding when
    ``center``.  The default window is the periodic Hann; a window shorter
    than n_fft is centre-padded to n_fft (torch.stft's rule).

    The frames are ``Tensor.unfold``'s view and the transform
    ``torch.fft.rfft``: the same view and transform torch.stft computes (bit
    for bit on the CPU, forward and backward), but a backward that repeats
    on the card.  torch.stft frames through ``as_strided``, whose backward
    over overlapping frames is an ``index_add_`` (float atomics on CUDA, in
    an order that changes from run to run); unfold's backward sums each
    sample's frames in a fixed order."""
    if win_length is None:
        win_length = n_fft
    if window is None:
        window = hann_window(win_length)
    lpad = (n_fft - win_length) // 2
    window = np.pad(np.asarray(window, np.float32), (lpad, n_fft - win_length - lpad))
    window = torch.as_tensor(window, device=x.device, dtype=x.dtype)
    if center:
        x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    return torch.fft.rfft(x.unfold(-1, n_fft, hop_length) * window, dim=-1)


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
                    hop_length: int, n_mels: int, center: bool = True) -> torch.Tensor:
    """Magnitude mel spectrogram of (B, L) -> (B, n_mels, T), torchaudio's."""
    mag = stft(x, n_fft, hop_length, center=center).abs()
    fb = torch.as_tensor(mel_filterbank(sample_rate, n_fft, n_mels), device=x.device,
                         dtype=mag.dtype)
    return torch.einsum("btf,fm->bmt", mag, fb)


def safe_log(x: torch.Tensor, clip_val: float = 1e-7) -> torch.Tensor:
    """log with clipping (ref decoder/modules.py:194-205)."""
    return torch.log(torch.clamp(x, min=clip_val))


# ---------------------------------------------------------------------------
# MDCT / IMDCT (the alternative heads; ref decoder/spectral_ops.py:78-192)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _mdct_consts(frame_len: int):
    """(window, pre, post, ipre, ipost) for a frame of ``frame_len``: the
    sine window (scipy.signal.windows.cosine) and the complex twiddles."""
    N = frame_len // 2
    n0 = (N + 1) / 2
    n = np.arange(frame_len)
    window = np.sin(np.pi / frame_len * (n + 0.5)).astype(np.float32)
    pre = np.exp(-1j * np.pi * np.arange(frame_len) / frame_len)
    post = np.exp(-1j * np.pi * n0 * (np.arange(N) + 0.5) / N)
    ipre = np.exp(1j * np.pi * n0 * np.arange(N * 2) / N)
    ipost = np.exp(1j * np.pi * (np.arange(N * 2) + n0) / (N * 2))
    return window, pre, post, ipre, ipost


def _mdct_pad(frame_len: int, padding: str) -> int:
    if padding == "center":
        return frame_len // 2
    if padding == "same":
        return frame_len // 4
    raise ValueError("Padding must be 'center' or 'same'.")


def _c64(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.complex64), device=device)


def mdct(audio: torch.Tensor, frame_len: int, padding: str = "same") -> torch.Tensor:
    """MDCT of (B, L) -> (B, T, frame_len // 2) (decoder/spectral_ops.py:
    105-130): zero pad, sine-windowed frames at hop frame_len / 2, one FFT
    per frame between the twiddles."""
    window, pre, post, _, _ = _mdct_consts(frame_len)
    p = _mdct_pad(frame_len, padding)
    x = F.pad(audio, (p, p)).unfold(1, frame_len, frame_len // 2)
    x = x * torch.as_tensor(window, device=audio.device)
    N = frame_len // 2
    X = torch.fft.fft(x * _c64(pre, audio.device), dim=-1)[..., :N]
    res = X * _c64(post, audio.device) * np.sqrt(1 / N)
    return res.real * np.sqrt(2)


def imdct(X: torch.Tensor, frame_len: int, padding: str = "same") -> torch.Tensor:
    """IMDCT of (B, T, N) -> (B, L) (decoder/spectral_ops.py:158-192): one
    inverse FFT per frame between the twiddles, the sine window, overlap-add
    at hop N (``overlap_add``; frame_len = 2 N) and the
    padding trimmed."""
    window, _, _, ipre, ipost = _mdct_consts(frame_len)
    N = X.shape[-1]
    Y = torch.cat([X, -torch.flip(X, dims=(-1,))], dim=-1).to(torch.complex64)
    y = torch.fft.ifft(Y * _c64(ipre, X.device), dim=-1)
    y = (y * _c64(ipost, X.device)).real * np.sqrt(N) * np.sqrt(2)
    audio = overlap_add(y * torch.as_tensor(window, device=X.device), frame_len // 2)
    p = _mdct_pad(frame_len, padding)
    return audio[:, p:audio.shape[1] - p]
