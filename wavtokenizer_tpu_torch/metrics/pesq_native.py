"""Native wideband PESQ (ITU-T P.862 structure, P.862.2 mapping), in numpy.

Port of ``wavtokenizer_tpu/metrics/pesq_native.py``, line for line: the
same pipeline, constants, generated Bark/threshold tables and severity
calibration, so both packages give the same score to the same inputs.  The
reference scores with the ``pesq`` C extension (ref metrics/infer.py:17-116,
``pesq(16000, ref, deg, "wb")``); ``objective.pesq_wb`` prefers that package
when it is installed and falls back to this module.

    level alignment -> input filtering -> time alignment ->
    Bark pitch-power densities -> partial frequency/gain compensation ->
    Zwicker loudness -> symmetric + asymmetric disturbance ->
    two-stage Lp time aggregation -> raw PESQ MOS ->
    P.862.2 wideband MOS-LQO logistic mapping.

Scope (not ITU conformance): the Bark partition and the threshold in quiet
are generated from the standard Bark warp and Terhardt's curve rather than
copied from the ITU tables, time alignment is one whole-file delay (codec
resyntheses do not drift), and one severity calibration (``SEVERITY_SYM``,
``SEVERITY_ASYM``) was fitted to the P.862.2 white-noise anchors (SNR
35/25/15/5 dB -> MOS-LQO ~4.2/3.2/2.3/1.5).  Identical signals score the
4.6439 WB ceiling; delay and level changes are compensated; degradations
rank monotonically.
"""

from __future__ import annotations

import numpy as np

FS = 16000
FRAME = 512           # 32 ms analysis window at 16 kHz (P.862 WB)
SHIFT = 256           # 50% overlap
N_BARK = 49           # WB Bark resolution
SP = 6.910853e-6      # power scale, 16 kHz mode
SL = 1.866055e-1      # loudness scale, 16 kHz mode
ZWICKER = 0.23
TARGET_POWER = 1e7    # level-alignment target in the 350-3250 Hz band
DATAPAD_S = 0.32      # 320 ms zero padding appended to both signals
SEVERITY_SYM = 6.0    # disturbance calibration vs ITU tables (module doc)
SEVERITY_ASYM = 4.0


# --------------------------------------------------------------------------
# Bark partition + absolute hearing threshold
# --------------------------------------------------------------------------

def _hz_to_bark(f):
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(7.6e-4 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _bark_bands(fs: int = FS, nfft: int = FRAME, n_bands: int = N_BARK):
    """Assign rFFT bins to n_bands equal-Bark bands over [50 Hz, fs/2].

    Returns (band_of_bin (nfft//2+1,), centers_hz (n_bands,),
    bins_per_band (n_bands,)).  Bins below 50 Hz map to band -1 (dropped,
    matching P.862's 100/50 Hz low cut)."""
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    lo_b, hi_b = _hz_to_bark(50.0), _hz_to_bark(fs / 2)
    edges = np.linspace(lo_b, hi_b, n_bands + 1)
    band = np.digitize(_hz_to_bark(freqs), edges) - 1
    band[freqs < 50.0] = -1
    band[band >= n_bands] = n_bands - 1
    centers_bark = 0.5 * (edges[:-1] + edges[1:])
    # invert the warp numerically for band-center frequencies
    fgrid = np.linspace(1.0, fs / 2, 4096)
    centers_hz = np.interp(centers_bark, _hz_to_bark(fgrid), fgrid)
    bins = np.bincount(band[band >= 0], minlength=n_bands).astype(np.float64)
    return band, centers_hz, np.maximum(bins, 1.0)


def _abs_threshold(centers_hz: np.ndarray) -> np.ndarray:
    """Threshold-in-quiet per band, internal power units.

    Terhardt's threshold curve (dB SPL), rescaled so the most sensitive
    band sits at 0.0625 internal units: the ITU narrowband table floors
    at 0.25 in Sp_8k units, and Sp_16k/Sp_8k = 0.25, so the same
    physical threshold is 4x lower in wideband internal units.  This
    keeps level-aligned speech ~30-45 dB above threshold as in the
    calibrated binary."""
    f_khz = np.maximum(centers_hz, 20.0) / 1000.0
    db = (3.64 * f_khz ** -0.8
          - 6.5 * np.exp(-0.6 * (f_khz - 3.3) ** 2)
          + 1e-3 * f_khz ** 4)
    power = 10.0 ** (db / 10.0)
    return power * (0.0625 / power.min())


_BAND_OF_BIN, _CENTERS_HZ, _BINS_PER_BAND = _bark_bands()
_P0 = _abs_threshold(_CENTERS_HZ)
_BAND_WIDTH_BARK = float(_hz_to_bark(FS / 2) - _hz_to_bark(50.0)) / N_BARK


# --------------------------------------------------------------------------
# Pre-processing: level alignment, WB input filter, time alignment
# --------------------------------------------------------------------------

def _bandpass_fft(x: np.ndarray, lo: float, hi: float, fs: int) -> np.ndarray:
    X = np.fft.rfft(x)
    f = np.fft.rfftfreq(len(x), 1.0 / fs)
    X[(f < lo) | (f > hi)] = 0.0
    return np.fft.irfft(X, len(x))


def _fix_level(x: np.ndarray, fs: int) -> np.ndarray:
    """Scale so the 350-3250 Hz band has mean power TARGET_POWER
    (P.862 fix_power_level)."""
    bp = _bandpass_fft(x, 350.0, 3250.0, fs)
    p = float(np.mean(bp ** 2))
    if p <= 0.0:
        return x
    return x * np.sqrt(TARGET_POWER / p)


def _wb_input_filter(x: np.ndarray) -> np.ndarray:
    """P.862.2 wideband input IIR (one biquad, 100 Hz high-pass with
    presence lift): b = [2.6657628, -5.3315255, 2.6657628],
    a = [1, -1.8890331, 0.89487434]."""
    from scipy.signal import lfilter
    b = np.array([2.6657628, -5.3315255, 2.6657628])
    a = np.array([1.0, -1.8890331, 0.89487434])
    return lfilter(b, a, x)


def _estimate_delay(ref: np.ndarray, deg: np.ndarray, fs: int) -> int:
    """Whole-file delay of deg relative to ref, in samples.

    Sample-accurate FFT cross-correlation over a ±2 s lag range.  P.862's
    crude-envelope + per-utterance fine stages exist to handle clocks
    that drift mid-file; codec resyntheses have one constant offset, for
    which the global correlation peak is exact (see module docstring)."""
    n = min(len(ref), len(deg))
    if n < FRAME:
        return 0
    max_lag = int(min(n - FRAME, 2 * fs))
    if max_lag <= 0:
        return 0
    m = int(2 ** np.ceil(np.log2(2 * n)))
    # R[k] = sum_i deg[i + k] * ref[i]  (circular; k taken mod m)
    R = np.fft.irfft(np.fft.rfft(deg[:n], m) * np.conj(np.fft.rfft(ref[:n], m)), m)
    cand = np.concatenate([R[: max_lag + 1], R[-max_lag:]])
    k = int(np.argmax(cand))
    return k if k <= max_lag else k - (2 * max_lag + 1)


def _align(ref: np.ndarray, deg: np.ndarray, fs: int):
    lag = _estimate_delay(ref, deg, fs)
    if lag > 0:
        deg = deg[lag:]
    elif lag < 0:
        ref = ref[-lag:]
    n = min(len(ref), len(deg))
    return ref[:n], deg[:n]


# --------------------------------------------------------------------------
# Perceptual model
# --------------------------------------------------------------------------

def _pitch_power_density(x: np.ndarray) -> np.ndarray:
    """(n_frames, N_BARK) Bark-binned power spectra, scaled by SP."""
    n = 1 + (len(x) - FRAME) // SHIFT
    idx = np.arange(n)[:, None] * SHIFT + np.arange(FRAME)[None, :]
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(FRAME) / FRAME))
    spec = np.abs(np.fft.rfft(x[idx] * w, axis=-1)) ** 2
    ppd = np.zeros((n, N_BARK))
    for b in range(N_BARK):
        sel = _BAND_OF_BIN == b
        if sel.any():
            ppd[:, b] = spec[:, sel].sum(axis=1) / _BINS_PER_BAND[b]
    return ppd * SP


def _loudness(ppd: np.ndarray) -> np.ndarray:
    """Zwicker loudness density (P.862 intensity_warping_of)."""
    ratio = ppd / _P0[None, :]
    l = (SL * (_P0[None, :] / 0.5) ** ZWICKER
         * ((0.5 + 0.5 * ratio) ** ZWICKER - 1.0))
    return np.where(ratio >= 1.0, l, 0.0)


def _raw_pesq(ref: np.ndarray, deg: np.ndarray) -> float:
    ppx = _pitch_power_density(ref)
    ppy = _pitch_power_density(deg)
    n = ppx.shape[0]

    frame_pow_x = ppx.sum(axis=1)
    active = frame_pow_x > 1e-2 * frame_pow_x.max() if n else np.zeros(0, bool)
    if not active.any():
        active = np.ones(n, bool)

    # partial frequency compensation: equalize time-invariant linear
    # filtering out of the *reference* (P.862 freq_resp_compensation)
    mean_x = ppx[active].mean(axis=0)
    mean_y = ppy[active].mean(axis=0)
    band_ratio = np.clip((mean_y + 1000.0 * SP) / (mean_x + 1000.0 * SP),
                         0.01, 100.0)
    ppx_eq = ppx * band_ratio[None, :]

    # short-term gain compensation of the *degraded* signal
    ex = ppx_eq.sum(axis=1) + 5e3 * SP
    ey = ppy.sum(axis=1) + 5e3 * SP
    h = np.empty(n)
    prev = 1.0
    for t in range(n):
        prev = 0.8 * prev + 0.2 * (ex[t] / ey[t])
        h[t] = min(max(prev, 3e-4), 5.0)
    ppy_eq = ppy * h[:, None]

    lx = _loudness(ppx_eq)
    ly = _loudness(ppy_eq)

    # disturbance with the 0.25*min masking deadzone
    d = ly - lx
    m = 0.25 * np.minimum(lx, ly)
    d = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)

    # asymmetry factor
    af = ((ppy_eq + 50.0 * SP) / (ppx_eq + 50.0 * SP)) ** 1.2
    af = np.where(af < 3.0, 0.0, np.minimum(af, 12.0))
    da = d * af

    w = _BAND_WIDTH_BARK
    # frame disturbances: L2 over bands (symmetric), L1 (asymmetric)
    d_frame = np.sqrt(((np.abs(d) ** 2) * w).sum(axis=1)) * SEVERITY_SYM
    da_frame = (np.abs(da) * w).sum(axis=1) * SEVERITY_ASYM

    # weight quiet frames up (P.862: divide by ((E_ref+1e5)/1e7)^0.04),
    # clip at 45.  E_ref here is the un-SP'd frame power.
    e_ref = ppx.sum(axis=1) / SP
    mult = ((e_ref + 1e5) / 1e7) ** -0.04
    d_frame = np.minimum(d_frame * mult, 45.0)
    da_frame = np.minimum(da_frame * mult, 45.0)

    def _two_stage(dv: np.ndarray, p_in: float) -> float:
        """Lp_in over 50%-overlapped 20-frame windows, L2 across windows."""
        if len(dv) == 0:
            return 0.0
        step, size = 10, 20
        vals = []
        for s in range(0, max(len(dv) - size, 0) + 1, step):
            seg = dv[s:s + size]
            vals.append(np.mean(seg ** p_in) ** (1.0 / p_in))
        if not vals:
            vals = [np.mean(dv ** p_in) ** (1.0 / p_in)]
        v = np.asarray(vals)
        return float(np.sqrt(np.mean(v ** 2)))

    d_symm = _two_stage(d_frame, 6.0)
    d_asymm = _two_stage(da_frame, 1.0)

    return float(np.clip(4.5 - 0.1 * d_symm - 0.0309 * d_asymm, -0.5, 4.5))


def _map_wb(raw: float) -> float:
    """P.862.2 raw-score -> MOS-LQO logistic mapping."""
    return 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))


# --------------------------------------------------------------------------
# Public entry
# --------------------------------------------------------------------------

def pesq_wb_native(ref: np.ndarray, deg: np.ndarray,
                   sample_rate: int = FS) -> float:
    """Wideband PESQ MOS-LQO in (~1.0, 4.644); higher is better.

    Inputs are 1-D float waveforms (any common scale — level alignment
    normalizes).  ``sample_rate`` must be 16000; resample upstream
    (objective.pesq_wb does)."""
    if sample_rate != FS:
        raise ValueError(f"pesq_wb_native expects 16 kHz input, got {sample_rate}")
    ref = np.asarray(ref, np.float64).ravel()
    deg = np.asarray(deg, np.float64).ravel()
    if min(len(ref), len(deg)) < FRAME * 2:
        return float("nan")

    # pad both to a common length (+320 ms) rather than cropping to the
    # shorter — a delayed degraded file keeps its tail, as in P.862
    n = max(len(ref), len(deg)) + int(DATAPAD_S * FS)
    ref = np.concatenate([ref, np.zeros(n - len(ref))])
    deg = np.concatenate([deg, np.zeros(n - len(deg))])

    ref = _wb_input_filter(_fix_level(ref, FS))
    deg = _wb_input_filter(_fix_level(deg, FS))
    ref, deg = _align(ref, deg, FS)
    if len(ref) < FRAME * 2:
        return float("nan")
    return _map_wb(_raw_pesq(ref, deg))
