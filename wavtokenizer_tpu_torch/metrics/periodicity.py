"""Pitch, periodicity and voicing metrics, host-side numpy.

Port of ``wavtokenizer_tpu/metrics/periodicity.py`` (ref
metrics/periodicity.py:16-105): per-frame pitch (Hz), periodicity in
[0, 1], a silence gate, and the three summary metrics: periodicity RMSE,
pitch RMSE in cents over frames voiced in both, voiced/unvoiced F1.

The frame-level estimator, best first:

* ``use_crepe=True`` with a local CREPE checkpoint (``WT_CREPE_CKPT``): the
  CREPE-full net of ``crepe.py`` on ``device``, with the reference's
  viterbi decoding, hop 160 and perceptual silence gate.
* ``use_crepe=True`` with torchcrepe installed: torchcrepe.
* otherwise normalized-autocorrelation (NAC) pitch at hop 80, a standard DSP
  tracker good enough as a training-time quality gate.
"""

from __future__ import annotations

import numpy as np

HOP = 80          # 5 ms at 16 kHz, matching torchcrepe hopsize in the reference
FMIN, FMAX = 50.0, 550.0
SILENCE_DB = -60.0
SR = 16000


def frame_signal(x: np.ndarray, frame: int, hop: int) -> np.ndarray:
    if len(x) < frame:
        # shorter than one analysis window: zero-pad to a single frame
        # (max(0, ...) alone would still index past the end of x)
        x = np.pad(x, (0, frame - len(x)))
    n = 1 + (len(x) - frame) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    return x[idx]


def nac_pitch(x: np.ndarray, sample_rate: int = SR):
    """Normalized-autocorrelation pitch + periodicity per frame.

    Returns (pitch_hz (N,), periodicity (N,)).  Periodicity is the NAC peak
    value in the plausible-lag range, analogous to crepe's confidence.
    """
    frame = 1024
    lo = int(sample_rate / FMAX)
    hi = min(int(sample_rate / FMIN), frame - 1)
    frames = frame_signal(x, frame, HOP)
    frames = frames - frames.mean(axis=1, keepdims=True)
    # autocorrelation via FFT
    nfft = 2048
    spec = np.fft.rfft(frames, nfft, axis=1)
    ac = np.fft.irfft(np.abs(spec) ** 2, nfft, axis=1)[:, :hi + 1]
    ac0 = np.maximum(ac[:, :1], 1e-9)
    nac = ac / ac0
    lag_range = nac[:, lo:hi + 1]
    best = lag_range.argmax(axis=1) + lo
    periodicity = np.clip(lag_range.max(axis=1), 0.0, 1.0)
    pitch = sample_rate / np.maximum(best, 1)
    return pitch.astype(np.float32), periodicity.astype(np.float32)


def a_weighted_silence_mask(x: np.ndarray, sample_rate: int = SR,
                            threshold_db: float = SILENCE_DB) -> np.ndarray:
    """Per-frame loudness gate (ref: metrics/periodicity.py silence gating via
    perceptually-weighted STFT at -60 dB)."""
    frame = 1024
    frames = frame_signal(x, frame, HOP)
    spec = np.abs(np.fft.rfft(frames * np.hanning(frame), axis=1))
    freqs = np.fft.rfftfreq(frame, 1.0 / sample_rate)
    f2 = np.maximum(freqs, 1e-2) ** 2
    ra = (12194.0 ** 2 * f2 ** 2) / (
        (f2 + 20.6 ** 2) * np.sqrt((f2 + 107.7 ** 2) * (f2 + 737.9 ** 2))
        * (f2 + 12194.0 ** 2))
    a_w = 2.0 + 20.0 * np.log10(np.clip(ra, 1e-12, None))
    weighted = spec * (10.0 ** (a_w / 20.0))
    loudness = 20 * np.log10(weighted.mean(axis=1) + 1e-9)
    ref_db = loudness.max() if len(loudness) else 0.0
    return loudness > (ref_db + threshold_db)


def pitch_and_periodicity(x: np.ndarray, sample_rate: int = SR,
                          use_crepe: bool = False, device="cuda"):
    """(pitch, periodicity, voiced_mask) per frame: hop 80 for NAC, CREPE's
    hop 160 when a CREPE estimator runs (on ``device``)."""
    if use_crepe:
        from .crepe import load_crepe
        params = load_crepe(device=device)
        if params is not None:
            # CREPE brings its own silence gate and unvoiced threshold
            # (crepe.py::predict_pitch) at hop 160: the hop-80 NAC mask
            # below does not apply.
            from .crepe import predict_pitch as crepe_predict_pitch
            pitch, per = crepe_predict_pitch(params, x)
            return pitch, per, ~np.isnan(pitch)
        import torch
        import torchcrepe
        audio = torch.from_numpy(x)[None].float()
        pitch, per = torchcrepe.predict(
            audio, sample_rate, hop_length=HOP, fmin=FMIN, fmax=FMAX,
            model="full", return_periodicity=True, batch_size=512)
        pitch, per = pitch[0].numpy(), per[0].numpy()
    else:
        pitch, per = nac_pitch(x, sample_rate)
    n = min(len(pitch), len(per))
    pitch, per = pitch[:n], per[:n]
    mask = a_weighted_silence_mask(x, sample_rate)[:n]
    per = np.where(mask, per, 0.0)
    voiced = (per > 0.5) & mask
    return pitch, per, voiced


def calculate_periodicity_metrics(ref: np.ndarray, deg: np.ndarray,
                                  sample_rate: int = SR,
                                  use_crepe: bool = False, device="cuda"):
    """(periodicity_rmse, pitch_rmse_cents, voiced_f1)
    (ref metrics/periodicity.py:16-105)."""
    n = min(len(ref), len(deg))
    p_r, per_r, v_r = pitch_and_periodicity(ref[:n], sample_rate, use_crepe, device)
    p_d, per_d, v_d = pitch_and_periodicity(deg[:n], sample_rate, use_crepe, device)
    m = min(len(p_r), len(p_d))
    p_r, per_r, v_r = p_r[:m], per_r[:m], v_r[:m]
    p_d, per_d, v_d = p_d[:m], per_d[:m], v_d[:m]

    periodicity_rmse = float(np.sqrt(np.mean((per_r - per_d) ** 2)))
    both = v_r & v_d
    if both.any():
        cents = 1200.0 * np.abs(np.log2(p_r[both] / np.maximum(p_d[both], 1e-6)))
        pitch_rmse = float(np.sqrt(np.mean(cents ** 2)))
    else:
        pitch_rmse = float("nan")
    tp = float((v_r & v_d).sum())
    fp = float((~v_r & v_d).sum())
    fn = float((v_r & ~v_d).sum())
    f1 = 2 * tp / max(2 * tp + fp + fn, 1e-9)
    return periodicity_rmse, pitch_rmse, float(f1)
