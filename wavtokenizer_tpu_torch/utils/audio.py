"""Audio files and resampling on the host, in numpy/scipy.

Port of ``wavtokenizer_tpu/train/data.py::read_audio``/``resample_np`` and
the kernel bank of ``wavtokenizer_tpu/ops/resample.py::_sinc_resample_kernel``
(torchaudio's polyphase sinc design: lowpass_filter_width=6, rolloff=0.99,
sinc_interp_hann window).  WAV files go through ``scipy.io.wavfile``;
``soundfile`` is used when it is installed, for the other formats.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=32)
def _sinc_resample_kernel(orig_freq: int, new_freq: int,
                          lowpass_filter_width: int = 6,
                          rolloff: float = 0.99) -> tuple[np.ndarray, int, int, int]:
    """Polyphase kernel bank: (kernels (K, 1, new), width, orig, new), with
    orig/new reduced by their gcd."""
    gcd = math.gcd(int(orig_freq), int(new_freq))
    orig = int(orig_freq) // gcd
    new = int(new_freq) // gcd
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)

    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    scale = base_freq / orig
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels = kernels * window * scale  # (new, 2*width + orig)
    k = kernels.T[:, None, :].astype(np.float32)
    return k, width, orig, new


def read_audio(path: str) -> tuple[np.ndarray, int]:
    """(samples float32 (T,) or (T, C), sample_rate)."""
    try:
        import soundfile
        y, sr = soundfile.read(path)
        return np.asarray(y, np.float32), int(sr)
    except ImportError:
        pass
    from scipy.io import wavfile
    sr, y = wavfile.read(path)
    y = np.asarray(y)
    if y.dtype == np.int16:
        y = y.astype(np.float32) / 32768.0
    elif y.dtype == np.int32:
        y = y.astype(np.float32) / 2147483648.0
    elif y.dtype == np.uint8:
        y = (y.astype(np.float32) - 128.0) / 128.0
    else:
        y = y.astype(np.float32)
    return y, int(sr)


def resample_np(y: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase sinc resample of a 1-D signal; output length
    ceil(new * T / orig), as torchaudio's."""
    if orig_sr == new_sr:
        return y
    kern, width, orig, new = _sinc_resample_kernel(orig_sr, new_sr)
    k = kern[:, 0, :].T                      # (new, K)
    length = y.shape[-1]
    ypad = np.pad(y, (width, width + orig))
    K = k.shape[1]
    n_frames = (ypad.shape[-1] - K) // orig + 1
    idx = (np.arange(n_frames) * orig)[:, None] + np.arange(K)[None, :]
    out = (ypad[idx] @ k.T).reshape(-1)      # (frames, new) -> samples
    target_length = int(math.ceil(new * length / orig))
    return out[:target_length].astype(np.float32)


def save_pcm16(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """16-bit PCM writer, clamped to +-0.99 (ref encoder/utils.py:95-103)."""
    from scipy.io import wavfile
    wav = np.clip(wav, -0.99, 0.99)
    wavfile.write(path, sample_rate, (wav * 32767.0).astype(np.int16))
