"""CREPE-full pitch tracker (the reference's torchcrepe dependency).

Port of ``wavtokenizer_tpu/metrics/crepe.py``.  The reference
(metrics/periodicity.py:16-67) calls ``torchcrepe.predict(audio, fmin=50,
fmax=550, sample_rate=16000, model="full", return_periodicity=True,
pad=False)``: CREPE's six-layer conv net over 1024-sample frames at hop 160
(10 ms), sigmoid salience over 360 pitch bins, viterbi decoding, and the
periodicity read as the salience at the decoded bin.

torchcrepe fetches its weights when it is installed, so the net is written
out here over a parameter dict, with a converter from torchcrepe's state
dict (``conv1.weight`` ... ``conv6_BN.running_var``, ``classifier.*``).
Scoring needs a local checkpoint (``WT_CREPE_CKPT`` or a path).

The net (torchcrepe/model.py, model="full"), per frame (1024,): six layers
of [pad time -> conv (kernel 512 stride 4 for layer 1, kernel 64 stride 1
after) -> relu -> BatchNorm (eps 1e-3) -> max-pool 2]; layer 1 pads
(254, 254), layers 2-6 pad (31, 32); the (N, 512, 4) output is flattened
time-major (torch's permute to (N, 4, 512)) -> Linear(2048, 360) -> sigmoid.
It runs on ``device`` in fp32 with TF32 off (``full_fp32``): the voicing
thresholds are decisions, and TF32 convs move the salience by ~1e-3.

Decoding (torchcrepe/decode.py viterbi) stays host numpy, as in the JAX
package: softmax over the bins, viterbi with the banded transition
max(12 - |i - j|, 0) row-normalized and a uniform start; bins -> cents =
20 * bin + 1997.3794084376191 -> Hz = 10 * 2 ** (cents / 1200).  torchcrepe
dithers the decoded cents by +-20; that is off by default (deterministic
metrics) and on with ``dither=True``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
WINDOW_SIZE = 1024
PITCH_BINS = 360
CENTS_PER_BIN = 20.0
CENTS_OFFSET = 1997.3794084376191
UNVOICED = float("nan")
# torchcrepe/loudness.py REF_DB
REF_DB = 20.0

# (out_channels, kernel, stride, (pad_lo, pad_hi)) per layer, model="full"
FULL_LAYERS = (
    (1024, 512, 4, (254, 254)),
    (128, 64, 1, (31, 32)),
    (128, 64, 1, (31, 32)),
    (128, 64, 1, (31, 32)),
    (256, 64, 1, (31, 32)),
    (512, 64, 1, (31, 32)),
)
BN_EPS = 1e-3   # torchcrepe's keras-converted BatchNorm eps (0.001f)


def crepe_salience(params: dict, frames: torch.Tensor) -> torch.Tensor:
    """Normalized frames (N, 1024) -> sigmoid pitch salience (N, 360), on
    the frames' device.  Conv weights (C_out, C_in, K) (torchcrepe's Conv2d
    without its trailing width-1 axis)."""
    x = frames[:, None, :]                      # (N, C=1, T)
    for (_, _, s, pads), lp in zip(FULL_LAYERS, params["layers"]):
        x = F.conv1d(F.pad(x, pads), lp["weight"], lp["bias"], stride=s)
        x = F.relu(x)
        # inference BatchNorm: a per-channel affine from the running stats
        x = (x - lp["bn_mean"][:, None]) * torch.rsqrt(lp["bn_var"][:, None] + BN_EPS)
        x = x * lp["bn_weight"][:, None] + lp["bn_bias"][:, None]
        x = F.max_pool1d(x, 2, 2)
    x = x.transpose(1, 2).reshape(x.shape[0], -1)   # (N, 4 * 512), time-major
    return torch.sigmoid(F.linear(x, params["classifier"]["weight"],
                                  params["classifier"]["bias"]))


def frame_audio(audio: np.ndarray, hop_length: int = 160) -> np.ndarray:
    """(T,) 16 kHz audio -> normalized windows (N, 1024) (torchcrepe
    core.preprocess with pad=False: 1024-sample frames every ``hop_length``,
    mean-centered, divided by the unbiased std)."""
    audio = np.asarray(audio, np.float32)
    if len(audio) < WINDOW_SIZE:
        audio = np.pad(audio, (0, WINDOW_SIZE - len(audio)))
    n = 1 + (len(audio) - WINDOW_SIZE) // hop_length
    idx = (np.arange(n)[:, None] * hop_length
           + np.arange(WINDOW_SIZE)[None, :])
    frames = audio[idx]
    frames = frames - frames.mean(axis=1, keepdims=True)
    std = frames.std(axis=1, ddof=1, keepdims=True)   # torch std: unbiased
    return frames / np.maximum(std, 1e-10)


def frequency_to_bins(freq: float, quantize=np.floor) -> int:
    cents = 1200.0 * np.log2(freq / 10.0)
    return int(quantize((cents - CENTS_OFFSET) / CENTS_PER_BIN))


def bins_to_frequency(bins: np.ndarray, dither: bool = False,
                      seed: int = 0) -> np.ndarray:
    cents = CENTS_PER_BIN * bins + CENTS_OFFSET
    if dither:
        # torchcrepe/convert.py dither: triangular noise on (-20, 20) cents
        rng = np.random.default_rng(seed)
        cents = cents + rng.triangular(-CENTS_PER_BIN, 0.0, CENTS_PER_BIN,
                                       size=cents.shape)
    return 10.0 * 2.0 ** (cents / 1200.0)


_VITERBI_TRANSITION = None


def viterbi_decode(posterior: np.ndarray) -> np.ndarray:
    """Max-product path over (T, 360) frame posteriors, in log space:
    librosa.sequence.viterbi with torchcrepe's banded transition
    max(12 - |i - j|, 0) (row-normalized) and a uniform start."""
    global _VITERBI_TRANSITION
    if _VITERBI_TRANSITION is None:
        i = np.arange(PITCH_BINS)
        t = np.maximum(12.0 - np.abs(i[:, None] - i[None, :]), 0.0)
        _VITERBI_TRANSITION = np.log(t / t.sum(axis=1, keepdims=True) + 1e-300)
    log_t = _VITERBI_TRANSITION
    log_p = np.log(np.maximum(posterior, 1e-300))
    T = log_p.shape[0]
    score = log_p[0] - np.log(PITCH_BINS)
    back = np.zeros((T, PITCH_BINS), np.int32)
    for t in range(1, T):
        cand = score[:, None] + log_t            # (from, to)
        back[t] = cand.argmax(axis=0)
        score = cand.max(axis=0) + log_p[t]
    path = np.zeros(T, np.int64)
    path[-1] = score.argmax()
    for t in range(T - 2, -1, -1):
        path[t] = back[t + 1][path[t + 1]]
    return path


def salience(params: dict, frames: np.ndarray, batch_size: int = 512) -> np.ndarray:
    """Salience of numpy frames (N, 1024) on the params' device, in batches
    of ``batch_size`` frames, TF32 off; returned as numpy (N, 360)."""
    from ..models.wavtokenizer import full_fp32

    device = params["classifier"]["weight"].device
    out = []
    with torch.inference_mode(), full_fp32():
        for i in range(0, len(frames), batch_size):
            x = torch.from_numpy(np.ascontiguousarray(frames[i:i + batch_size])).to(device)
            out.append(crepe_salience(params, x).cpu().numpy())
    return np.concatenate(out, axis=0)


def crepe_predict(params: dict, audio: np.ndarray, fmin: float = 50.0,
                  fmax: float = 550.0, hop_length: int = 160,
                  decoder: str = "viterbi", batch_size: int = 512,
                  dither: bool = False):
    """torchcrepe.predict(..., model="full", return_periodicity=True,
    pad=False) for one clip: (pitch_hz (N,), periodicity (N,)).

    The periodicity is the sigmoid salience at the decoded bin (torchcrepe
    core.periodicity); decoding runs on the softmax posterior restricted to
    the [fmin, fmax] bins (decode.viterbi)."""
    sal = salience(params, frame_audio(audio, hop_length), batch_size)

    lo = frequency_to_bins(fmin)
    hi = frequency_to_bins(fmax, np.ceil)
    masked = sal.copy()
    masked[:, :lo] = -np.inf
    masked[:, hi:] = -np.inf

    if decoder == "viterbi":
        e = np.exp(masked - masked.max(axis=1, keepdims=True))
        posterior = e / e.sum(axis=1, keepdims=True)
        bins = viterbi_decode(posterior)
    elif decoder == "argmax":
        bins = masked.argmax(axis=1)
    else:
        raise ValueError(decoder)

    pitch = bins_to_frequency(bins, dither=dither)
    periodicity = sal[np.arange(len(bins)), bins]
    return pitch.astype(np.float32), periodicity.astype(np.float32)


def perceptual_silence_mask(audio: np.ndarray, hop_length: int = 160,
                            threshold_db: float = -60.0) -> np.ndarray:
    """The reference's silence gate (metrics/periodicity.py:47-63): Hann
    power STFT (n_fft 1024, center=False), A-weighted dB (librosa
    perceptual_weighting: power_to_db with amin 1e-10 and top_db 80 plus the
    IEC 61672 A-curve) minus torchcrepe's REF_DB; frames whose mean over
    frequency is under ``threshold_db`` are silent.  True = silent."""
    audio = np.asarray(audio, np.float32)
    if len(audio) < WINDOW_SIZE:
        audio = np.pad(audio, (0, WINDOW_SIZE - len(audio)))
    n = 1 + (len(audio) - WINDOW_SIZE) // hop_length
    idx = (np.arange(n)[:, None] * hop_length
           + np.arange(WINDOW_SIZE)[None, :])
    win = np.hanning(WINDOW_SIZE + 1)[:-1].astype(np.float32)  # periodic
    spec = np.abs(np.fft.rfft(audio[idx] * win, axis=1)) ** 2   # (N, F)

    # librosa.A_weighting: 2.0 + 20*log10(c0*f^4 / ((f^2+c0)(f^2+c1)
    # sqrt((f^2+c2)(f^2+c3)))), clamped at min_db=-80
    freqs = np.fft.rfftfreq(WINDOW_SIZE, 1.0 / SAMPLE_RATE)
    f2 = freqs ** 2
    const = np.array([12194.217, 20.598997, 107.65265, 737.86223]) ** 2
    num = const[0] * f2 ** 2
    den = ((f2 + const[0]) * (f2 + const[1])
           * np.sqrt((f2 + const[2]) * (f2 + const[3])))
    a_db = 2.0 + 20.0 * np.log10(np.maximum(num / np.maximum(den, 1e-30), 1e-30))
    a_db = np.maximum(a_db, -80.0)

    s_db = 10.0 * np.log10(np.maximum(spec, 1e-10))
    s_db = np.maximum(s_db, s_db.max() - 80.0)          # top_db=80
    weighted = s_db + a_db[None, :] - REF_DB
    return weighted.mean(axis=1) < threshold_db


def predict_pitch(params: dict, audio: np.ndarray,
                  silence_threshold: float = -60.0,
                  unvoiced_threshold: float = 0.21):
    """The reference's predict_pitch (metrics/periodicity.py:16-67): viterbi
    pitch and periodicity, silent frames' periodicity zeroed, pitch nan
    where the periodicity is under 0.21."""
    pitch, periodicity = crepe_predict(params, audio)
    silence = perceptual_silence_mask(audio, threshold_db=silence_threshold)
    m = min(len(pitch), len(silence))
    pitch, periodicity, silence = pitch[:m], periodicity[:m], silence[:m]
    periodicity = np.where(silence, 0.0, periodicity)
    pitch = np.where(periodicity < unvoiced_threshold, UNVOICED, pitch)
    return pitch, periodicity


def crepe_periodicity_metrics(params: dict, ref: np.ndarray, deg: np.ndarray):
    """The reference's calculate_periodicity_metrics (periodicity.py:
    70-105): (periodicity RMSE, pitch RMSE in cents over frames voiced in
    both, voiced F1)."""
    p_r, per_r = predict_pitch(params, ref)
    p_d, per_d = predict_pitch(params, deg)
    m = min(len(p_r), len(p_d))
    p_r, per_r, p_d, per_d = p_r[:m], per_r[:m], p_d[:m], per_d[:m]

    v_r, v_d = ~np.isnan(p_r), ~np.isnan(p_d)
    periodicity_loss = float(np.sqrt(np.mean((per_d - per_r) ** 2)))
    voiced = v_r & v_d
    if voiced.any():
        cents = 1200.0 * (np.log2(p_r[voiced]) - np.log2(p_d[voiced]))
        pitch_loss = float(np.sqrt(np.mean(cents ** 2)))
    else:
        pitch_loss = float("nan")
    tp = float((v_r & v_d).sum())
    fp = float((~v_r & v_d).sum())
    fn = float((v_r & ~v_d).sum())
    precision = tp / max(tp + fp, 1e-9)
    recall = tp / max(tp + fn, 1e-9)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return periodicity_loss, pitch_loss, float(f1)


# ---------------------------------------------------------------------------
# torchcrepe checkpoint conversion
# ---------------------------------------------------------------------------

def crepe_params_from_torch(sd: dict, device="cuda") -> dict:
    """torchcrepe ``Crepe('full').state_dict()`` -> this module's params on
    ``device``.  Layer i lives under ``conv{i}`` / ``conv{i}_BN``; the conv
    weights (C_out, C_in, K, 1) lose their width axis."""
    def a(key):
        v = sd[key]
        v = v.detach().cpu().numpy() if hasattr(v, "detach") else v
        return torch.from_numpy(np.array(v, np.float32)).to(device)

    layers = [{"weight": a(f"conv{i}.weight")[:, :, :, 0].contiguous(),
               "bias": a(f"conv{i}.bias"),
               "bn_weight": a(f"conv{i}_BN.weight"),
               "bn_bias": a(f"conv{i}_BN.bias"),
               "bn_mean": a(f"conv{i}_BN.running_mean"),
               "bn_var": a(f"conv{i}_BN.running_var")}
              for i in range(1, len(FULL_LAYERS) + 1)]
    return {"layers": layers,
            "classifier": {"weight": a("classifier.weight"),
                           "bias": a("classifier.bias")}}


def init_crepe_state_dict(seed: int = 0) -> dict:
    """A seeded random CREPE-full state dict in torchcrepe's layout (numpy):
    uniform(+-1/sqrt(fan_in)) weights and biases, as torch's default init
    bounds them, and BatchNorm affines and running stats near (1, 0).  For
    runs that need a checkpoint where no trained one is at hand."""
    rng = np.random.default_rng(seed)
    u = lambda bound, shape: rng.uniform(-bound, bound, shape).astype(np.float32)
    sd, cin = {}, 1
    for i, (cout, k, _, _) in enumerate(FULL_LAYERS, start=1):
        b = 1.0 / np.sqrt(cin * k)
        sd[f"conv{i}.weight"] = u(b, (cout, cin, k, 1))
        sd[f"conv{i}.bias"] = u(b, (cout,))
        sd[f"conv{i}_BN.weight"] = (1.0 + u(0.1, (cout,))).astype(np.float32)
        sd[f"conv{i}_BN.bias"] = u(0.1, (cout,))
        sd[f"conv{i}_BN.running_mean"] = u(0.1, (cout,))
        sd[f"conv{i}_BN.running_var"] = (1.0 + u(0.4, (cout,))).astype(np.float32)
        cin = cout
    b = 1.0 / np.sqrt(4 * cin)
    sd["classifier.weight"] = u(b, (PITCH_BINS, 4 * cin))
    sd["classifier.bias"] = u(b, (PITCH_BINS,))
    return sd


_CACHED: dict = {}


def load_crepe(ckpt_path: str | None = None, device="cuda"):
    """CREPE-full params from a torch checkpoint on disk (torchcrepe ships
    ``crepe.pth``; the path defaults to ``$WT_CREPE_CKPT``), cached per path
    and device; None when there is no checkpoint."""
    ckpt_path = ckpt_path or os.environ.get("WT_CREPE_CKPT")
    if not ckpt_path or not os.path.exists(ckpt_path):
        return None
    key = (ckpt_path, str(torch.device(device)))
    if key not in _CACHED:
        sd = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        sd = sd.get("state_dict", sd) if isinstance(sd, dict) else sd
        _CACHED[key] = crepe_params_from_torch(sd, device)
    return _CACHED[key]
