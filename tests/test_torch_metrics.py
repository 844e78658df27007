"""The port's host-side metrics against the JAX package's, on seeded
speech-like signals under six degradations: identity, white noise at 20 and
5 dB SNR, a delay, a low-pass and a gain.

Both packages compute these in numpy (the JAX package's are host code too),
so every value is held to rel 1e-6 (equal but for the order of a few float
operations).
"""

import numpy as np
import pytest
from scipy.signal import butter, lfilter

from wavtokenizer_tpu.metrics import objective as jobj
from wavtokenizer_tpu.metrics import periodicity as jper
from wavtokenizer_tpu.metrics.pesq_native import pesq_wb_native as j_pesq_native
from wavtokenizer_tpu_torch.metrics import objective as tobj
from wavtokenizer_tpu_torch.metrics import periodicity as tper
from wavtokenizer_tpu_torch.metrics.pesq_native import pesq_wb_native as t_pesq_native

DEGRADATIONS = ["identity", "noise20", "noise5", "delay", "lowpass", "gain"]


def _speech_like(sr: int, seconds: float, seed: int) -> np.ndarray:
    """Voiced segments (a 110-220 Hz gliding harmonic series, syllable-rate
    amplitude envelope) between pauses, over a faint noise floor."""
    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    t = np.arange(n) / sr
    f0 = 110.0 + 110.0 * (0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum((0.6 / k) * np.sin(k * phase) for k in range(1, 12))
    env = np.clip(np.sin(2 * np.pi * 3.0 * t), 0.0, None) ** 0.5
    env[(t > 0.55 * seconds) & (t < 0.7 * seconds)] = 0.0
    return (0.3 * env * voiced + 0.003 * rng.normal(size=n)).astype(np.float32)


def _degrade(x: np.ndarray, sr: int, kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 100)
    if kind == "identity":
        return x.copy()
    if kind.startswith("noise"):
        snr = float(kind[5:])
        noise = rng.normal(size=len(x))
        noise *= np.sqrt((x ** 2).mean() / (noise ** 2).mean() / 10 ** (snr / 10))
        return (x + noise).astype(np.float32)
    if kind == "delay":
        return np.concatenate([np.zeros(int(0.004 * sr)), x])[:len(x)].astype(np.float32)
    if kind == "lowpass":
        b, a = butter(6, 3000.0 / (sr / 2))
        return lfilter(b, a, x).astype(np.float32)
    if kind == "gain":
        return (0.5 * x).astype(np.float32)
    raise ValueError(kind)


def _close(got, want, rel: float = 1e-6) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.all(np.abs(got[ok] - want[ok]) <= rel * np.maximum(np.abs(want[ok]), 1e-12)), \
        (got, want)


@pytest.fixture(scope="module")
def clips():
    return {sr: _speech_like(sr, 1.5, seed=sr) for sr in (16000, 24000)}


@pytest.mark.parametrize("kind", DEGRADATIONS)
def test_objective_metrics_match_jax(clips, kind):
    """STOI (through its 10 kHz resample), SNR, log-mel distance and
    envelope similarity at 24 kHz."""
    ref = clips[24000]
    deg = _degrade(ref, 24000, kind, 1)
    for name, args in (("stoi", (ref, deg, 24000)), ("snr_db", (ref, deg)),
                       ("mel_spectral_distance", (ref, deg, 24000)),
                       ("envelope_similarity", (ref, deg))):
        _close(getattr(tobj, name)(*args), getattr(jobj, name)(*args))
    if kind == "identity":
        assert tobj.stoi(ref, deg, 24000) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("kind", DEGRADATIONS)
def test_periodicity_metrics_match_jax(clips, kind):
    """NAC pitch and periodicity, the A-weighted silence gate and the three
    summary metrics at 16 kHz."""
    ref = clips[16000]
    deg = _degrade(ref, 16000, kind, 2)
    for fn in ("nac_pitch", "a_weighted_silence_mask"):
        for got, want in zip(np.atleast_2d(getattr(tper, fn)(deg)),
                             np.atleast_2d(getattr(jper, fn)(deg))):
            _close(got, want)
    got = tper.calculate_periodicity_metrics(ref, deg)
    want = jper.calculate_periodicity_metrics(ref, deg)
    _close(got, want)
    if kind == "identity":
        assert got[0] == 0.0 and got[2] == 1.0


@pytest.mark.parametrize("kind", DEGRADATIONS)
def test_pesq_matches_jax(clips, kind):
    """The native P.862 at 16 kHz, and ``pesq_wb`` from 24 kHz (the
    resample, then the native fallback: no ``pesq`` package here)."""
    ref16, ref24 = clips[16000], clips[24000]
    deg16, deg24 = _degrade(ref16, 16000, kind, 3), _degrade(ref24, 24000, kind, 3)
    got = t_pesq_native(ref16, deg16, 16000)
    _close(got, j_pesq_native(ref16, deg16, 16000))
    assert 1.0 <= got <= 4.644
    _close(tobj.pesq_wb(ref24, deg24, 24000), jobj.pesq_wb(ref24, deg24, 24000))
    if kind == "identity":
        assert got == pytest.approx(4.6439, abs=1e-3)


def test_evaluators_without_their_inputs(clips, monkeypatch):
    """WT_NATIVE_PESQ=0 without the pesq package, and UTMOS without a
    checkpoint, give None in both packages; clips too short to score give
    nan (STOI) and None (PESQ) alike."""
    ref = clips[16000]
    monkeypatch.delenv("WT_UTMOS_CKPT", raising=False)
    assert tobj.utmos_score(ref, device="cpu") is None and jobj.utmos_score(ref) is None
    short = ref[:900]
    assert np.isnan(tobj.stoi(short, short, 16000)) and np.isnan(jobj.stoi(short, short, 16000))
    assert tobj.pesq_wb(short, short, 16000) is None and jobj.pesq_wb(short, short, 16000) is None
    monkeypatch.setenv("WT_NATIVE_PESQ", "0")
    assert tobj.pesq_wb(ref, ref, 16000) is None and jobj.pesq_wb(ref, ref, 16000) is None
