"""Objective audio quality metrics, host-side numpy.

Port of ``wavtokenizer_tpu/metrics/objective.py`` (ref metrics/infer.py:
17-116, test.py:138-172, decoder/experiment.py:227-258).  These are host
code in the JAX package too, and stay numpy here, with the same arithmetic:

* STOI: the classic short-time objective intelligibility measure (stands in
  for pystoi).
* SNR, log-mel spectral distance, envelope similarity: the fork's
  reconstruction metrics (ref test.py:138-172).
* PESQ: the ``pesq`` package when it is installed, else the native P.862
  implementation (``pesq_native.py``), so a wideband MOS-LQO is always
  available; ``WT_NATIVE_PESQ=0`` turns the fallback off.
* UTMOS: the model (``utmos.py``) scores on ``device`` when a local
  checkpoint is given (``WT_UTMOS_CKPT``); without one it returns None.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.spectral import mel_filterbank
from ..utils.audio import resample_np


# --------------------------------------------------------------------------
# STOI (Taal et al. 2010) — native numpy
# --------------------------------------------------------------------------

def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    lo = 2.0 ** ((2 * k - 1) / 6.0) * min_freq
    hi = 2.0 ** ((2 * k + 1) / 6.0) * min_freq
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        l_idx = np.argmin((f - lo[i]) ** 2)
        h_idx = np.argmin((f - hi[i]) ** 2)
        obm[i, l_idx:h_idx] = 1
    return obm, cf


def _stft_frames(x, win, hop, nfft):
    n = 1 + (len(x) - win) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(win)[None, :]
    frames = x[idx] * np.hanning(win)
    return np.fft.rfft(frames, nfft, axis=-1)


def _remove_silent_frames(x, y, dyn_range=40, win=256, hop=128):
    n = 1 + (len(x) - win) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(win)[None, :]
    w = np.hanning(win)
    energies = 20 * np.log10(np.linalg.norm(x[idx] * w, axis=1) + 1e-12)
    mask = energies > (energies.max() - dyn_range)
    xs, ys = np.zeros_like(x), np.zeros_like(y)
    count = np.zeros_like(x)
    pos = 0
    for i in range(n):
        if mask[i]:
            s = pos * hop
            xs[s:s + win] += x[idx[i]] * w
            ys[s:s + win] += y[idx[i]] * w
            count[s:s + win] += w ** 2
            pos += 1
    length = (pos - 1) * hop + win if pos > 0 else 0
    count = np.maximum(count, 1e-8)
    return (xs[:length] / count[:length], ys[:length] / count[:length])


def stoi(ref: np.ndarray, deg: np.ndarray, sample_rate: int) -> float:
    """Classic (non-extended) STOI in [−1, 1]; higher is better."""
    FS = 10000
    if sample_rate != FS:
        ref = resample_np(ref.astype(np.float32), sample_rate, FS)
        deg = resample_np(deg.astype(np.float32), sample_rate, FS)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    WIN, HOP, NFFT, NBANDS, MINFREQ = 256, 128, 512, 15, 150
    N_FRAMES = 30  # 384 ms
    BETA = -15.0

    if len(ref) < WIN:   # shorter than one frame: silent-frame removal
        return float("nan")   # would crash on an empty energy array
    ref, deg = _remove_silent_frames(ref, deg)
    if len(ref) < WIN + HOP * (N_FRAMES - 1):
        return float("nan")
    obm, _ = _thirdoct(FS, NFFT, NBANDS, MINFREQ)
    X = np.sqrt(obm @ (np.abs(_stft_frames(ref, WIN, HOP, NFFT).T) ** 2))
    Y = np.sqrt(obm @ (np.abs(_stft_frames(deg, WIN, HOP, NFFT).T) ** 2))

    d = []
    c = 10 ** (-BETA / 20)
    for m in range(N_FRAMES, X.shape[1] + 1):
        Xm = X[:, m - N_FRAMES:m]
        Ym = Y[:, m - N_FRAMES:m]
        alpha = np.linalg.norm(Xm, axis=1, keepdims=True) / (
            np.linalg.norm(Ym, axis=1, keepdims=True) + 1e-12)
        Ymn = np.minimum(Ym * alpha, Xm * (1 + c))
        Xc = Xm - Xm.mean(axis=1, keepdims=True)
        Yc = Ymn - Ymn.mean(axis=1, keepdims=True)
        num = (Xc * Yc).sum(axis=1)
        den = np.linalg.norm(Xc, axis=1) * np.linalg.norm(Yc, axis=1) + 1e-12
        d.append((num / den).mean())
    return float(np.mean(d))


# --------------------------------------------------------------------------
# Fork reconstruction metrics (ref: test.py:138-172)
# --------------------------------------------------------------------------

def snr_db(ref: np.ndarray, deg: np.ndarray) -> float:
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    noise = ref - deg
    return float(10 * np.log10((ref ** 2).sum() / ((noise ** 2).sum() + 1e-12)))


def mel_spectral_distance(ref: np.ndarray, deg: np.ndarray, sample_rate: int,
                          n_fft: int = 1024, hop: int = 256,
                          n_mels: int = 100) -> float:
    """L1 distance of safe-log mel spectrograms (the training mel loss as an
    offline metric)."""
    n = min(len(ref), len(deg))
    fb = mel_filterbank(sample_rate, n_fft, n_mels)

    def logmel(x):
        nfr = 1 + (len(x) - n_fft) // hop if len(x) >= n_fft else 0
        idx = np.arange(nfr)[:, None] * hop + np.arange(n_fft)[None, :]
        spec = np.abs(np.fft.rfft(x[idx] * np.hanning(n_fft), axis=-1))
        return np.log(np.clip(spec @ fb, 1e-7, None))

    return float(np.abs(logmel(ref[:n]) - logmel(deg[:n])).mean())


def envelope_similarity(ref: np.ndarray, deg: np.ndarray,
                        frame: int = 512) -> float:
    """Cosine similarity of RMS envelopes (ref: test.py:159-170)."""
    n = min(len(ref), len(deg))
    n -= n % frame
    if n == 0:
        return float("nan")
    er = np.sqrt((ref[:n].reshape(-1, frame) ** 2).mean(axis=1))
    ed = np.sqrt((deg[:n].reshape(-1, frame) ** 2).mean(axis=1))
    return float((er @ ed) / (np.linalg.norm(er) * np.linalg.norm(ed) + 1e-12))


# --------------------------------------------------------------------------
# Optional external judges
# --------------------------------------------------------------------------

def pesq_wb(ref: np.ndarray, deg: np.ndarray, sample_rate: int) -> float | None:
    """Wideband PESQ MOS-LQO (ref metrics/infer.py, PESQ at 16 kHz).

    The ITU ``pesq`` C extension when it is installed; otherwise the native
    P.862 implementation (``pesq_native.py``).  ``WT_NATIVE_PESQ=0`` turns
    the fallback off: then None without the package.  None too where the
    native score is undefined (clips under two 32 ms frames)."""
    if sample_rate != 16000:
        ref = resample_np(ref.astype(np.float32), sample_rate, 16000)
        deg = resample_np(deg.astype(np.float32), sample_rate, 16000)
    try:
        from pesq import pesq as _pesq
    except ImportError:
        if os.environ.get("WT_NATIVE_PESQ", "1") == "0":
            return None
        from .pesq_native import pesq_wb_native
        v = pesq_wb_native(ref, deg, 16000)
        return None if np.isnan(v) else float(v)
    n = min(len(ref), len(deg))
    return float(_pesq(16000, ref[:n], deg[:n], "wb", on_error=1))


def utmos_score(wav_16k: np.ndarray, ckpt_path: str | None = None,
                device="cuda") -> np.ndarray | None:
    """UTMOS MOS predictor (ref metrics/UTMOS.py:19-55): clip scores (B,)
    for (B, T) or (T,) 16 kHz audio, or None without a checkpoint
    (``ckpt_path`` or ``$WT_UTMOS_CKPT``; the reference downloads one)."""
    from .utmos import load_utmos, utmos_score_from_params
    params = load_utmos(ckpt_path, device)
    if params is None:
        return None
    return utmos_score_from_params(params, np.asarray(wav_16k, np.float32))
