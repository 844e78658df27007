"""The port's CREPE and UTMOS nets against the JAX package's, on the CPU.

Both packages read one state dict in the reference layouts: torchcrepe's
for CREPE (through the torchcrepe-layout oracle of ``tests/test_crepe.py``,
and the seeded ``init_crepe_state_dict``), fairseq's for UTMOS (built from a
``transformers`` wav2vec2 model as ``tests/test_utmos.py`` builds it, at
full 768 width and 3 layers, and the seeded ``init_utmos_state_dict``).

Tolerances: the nets are fp32 in both packages in other summation orders.
CREPE's salience within 2e-5 (the oracle test's bound); its decoded bins
equal.  UTMOS's features and scores within rel 1e-4.  The decoders and
the silence gate are numpy on both sides: equal.
"""

import numpy as np
import pytest
import torch

from test_crepe import TorchCrepeOracle
from wavtokenizer_tpu.metrics import crepe as jc
from wavtokenizer_tpu.metrics import periodicity as jper
from wavtokenizer_tpu.metrics import utmos as ju
from wavtokenizer_tpu_torch.metrics import crepe as tc
from wavtokenizer_tpu_torch.metrics import periodicity as tper
from wavtokenizer_tpu_torch.metrics import utmos as tu


def _voiced(n: int, seed: int, f0: float = 220.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = np.sin(2 * np.pi * f0 * t) + 0.3 * np.sin(4 * np.pi * f0 * t)
    x[n // 2: n // 2 + 2000] = 0.0                   # a silent stretch
    return (0.5 * x + 0.01 * rng.normal(size=n)).astype(np.float32)


@pytest.fixture(scope="module")
def crepe_sd():
    torch.manual_seed(42)
    m = TorchCrepeOracle().eval()
    for i in range(1, 7):
        bn = getattr(m, f"conv{i}_BN")
        bn.running_mean.data.normal_(0, 0.1)
        bn.running_var.data.uniform_(0.6, 1.4)
    return m, m.state_dict()


def test_crepe_salience_matches_oracle_and_jax(crepe_sd):
    m, sd = crepe_sd
    frames = np.random.default_rng(0).normal(size=(6, 1024)).astype(np.float32)
    with torch.no_grad():
        ref = m(torch.from_numpy(frames)).numpy()
    got = tc.salience(tc.crepe_params_from_torch(sd, "cpu"), frames)
    want = np.asarray(jc.crepe_salience(jc.crepe_params_from_torch(sd), frames))
    assert got.shape == (6, tc.PITCH_BINS)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_crepe_framing_bins_and_viterbi_match_jax():
    audio = _voiced(4000, 1)
    np.testing.assert_array_equal(tc.frame_audio(audio), jc.frame_audio(audio))
    for f in (50.0, 123.0, 550.0):
        for q in (np.floor, np.ceil):
            assert tc.frequency_to_bins(f, q) == jc.frequency_to_bins(f, q)
    bins = np.arange(0, 360, 7)
    for dither in (False, True):
        np.testing.assert_array_equal(tc.bins_to_frequency(bins, dither=dither, seed=3),
                                      jc.bins_to_frequency(bins, dither=dither, seed=3))
    post = np.random.default_rng(2).random((40, tc.PITCH_BINS)) ** 8
    post /= post.sum(axis=1, keepdims=True)
    np.testing.assert_array_equal(tc.viterbi_decode(post), jc.viterbi_decode(post))
    np.testing.assert_array_equal(tc.perceptual_silence_mask(audio),
                                  jc.perceptual_silence_mask(audio))


@pytest.mark.parametrize("decoder", ["viterbi", "argmax"])
def test_crepe_predict_and_pitch_metrics_match_jax(crepe_sd, decoder):
    """crepe_predict, predict_pitch (silence gate, unvoiced threshold) and
    crepe_periodicity_metrics on a voiced clip with a silent stretch."""
    _, sd = crepe_sd
    tp, jp = tc.crepe_params_from_torch(sd, "cpu"), jc.crepe_params_from_torch(sd)
    ref, deg = _voiced(5000, 3), _voiced(5000, 4, f0=233.0)
    got = tc.crepe_predict(tp, ref, decoder=decoder)
    want = jc.crepe_predict(jp, ref, decoder=decoder)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=2e-5)
    if decoder == "viterbi":
        for a, b in zip(tc.predict_pitch(tp, ref), jc.predict_pitch(jp, ref)):
            np.testing.assert_allclose(a, b, atol=2e-5)
        np.testing.assert_allclose(tc.crepe_periodicity_metrics(tp, ref, deg),
                                   jc.crepe_periodicity_metrics(jp, ref, deg), rtol=1e-4)


def test_periodicity_through_crepe_checkpoint(tmp_path, monkeypatch):
    """use_crepe=True with WT_CREPE_CKPT: both packages load the seeded
    state dict and score the same periodicity metrics."""
    sd = tc.init_crepe_state_dict(seed=5)
    path = tmp_path / "crepe.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    monkeypatch.setenv("WT_CREPE_CKPT", str(path))
    ref, deg = _voiced(4000, 6), _voiced(4000, 7, f0=210.0)
    got = tper.calculate_periodicity_metrics(ref, deg, use_crepe=True, device="cpu")
    want = jper.calculate_periodicity_metrics(ref, deg, use_crepe=True)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_load_crepe_round_trip(tmp_path, crepe_sd):
    _, sd = crepe_sd
    torch.save(sd, tmp_path / "crepe.pth")
    loaded = tc.load_crepe(str(tmp_path / "crepe.pth"), device="cpu")
    assert loaded is tc.load_crepe(str(tmp_path / "crepe.pth"), device="cpu")
    np.testing.assert_array_equal(loaded["classifier"]["weight"].numpy(),
                                  sd["classifier.weight"].numpy())
    np.testing.assert_array_equal(loaded["layers"][0]["weight"].numpy(),
                                  sd["conv1.weight"].numpy()[:, :, :, 0])
    assert tc.load_crepe(str(tmp_path / "absent.pth"), device="cpu") is None


@pytest.fixture(scope="module")
def utmos_oracle():
    """The transformers-built wav2vec2 oracle of tests/test_utmos.py (3
    layers, 768 wide) with the UTMOS head, and its fairseq-named state dict."""
    pytest.importorskip("transformers")
    from test_utmos import _fairseq_style_sd, _oracle_modules, _oracle_score
    w2v, head = _oracle_modules()
    return w2v, head, _oracle_score, _fairseq_style_sd(w2v, head)


def test_utmos_ssl_encoder_and_score_match_jax(utmos_oracle):
    w2v, head, oracle_score, sd = utmos_oracle
    tp, jp = tu.utmos_params_from_torch(sd, "cpu"), ju.utmos_params_from_torch(sd)
    wav = (np.random.default_rng(0).normal(size=(2, 16000)) * 0.1).astype(np.float32)
    ref_x, ref_score = oracle_score(w2v, head, torch.from_numpy(wav))
    with torch.no_grad():
        got_x = tu.ssl_encode(tp, torch.from_numpy(wav)).numpy()
    want_x = np.asarray(ju.ssl_encode(jp, wav))
    np.testing.assert_allclose(got_x, ref_x.numpy(), atol=2e-3, rtol=1e-3)
    assert np.abs(got_x - want_x).max() <= 1e-4 * np.abs(want_x).max()
    got = tu.utmos_score_from_params(tp, wav)
    np.testing.assert_allclose(got, ju.utmos_score_from_params(jp, wav), rtol=1e-4)
    np.testing.assert_allclose(got, ref_score.numpy(), atol=2e-3, rtol=1e-3)
    assert tu.utmos_score_from_params(tp, wav[0]).shape == (1,)


def test_load_utmos_round_trip(tmp_path, utmos_oracle):
    """A Lightning-style checkpoint (prefixed keys under state_dict) loads
    in both packages to the same model; the seeded state dict does too."""
    *_, sd = utmos_oracle
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}},
               tmp_path / "utmos.ckpt")
    loaded = tu.load_utmos(str(tmp_path / "utmos.ckpt"), device="cpu")
    assert loaded is tu.load_utmos(str(tmp_path / "utmos.ckpt"), device="cpu")
    np.testing.assert_array_equal(loaded["judge_emb"].numpy(),
                                  sd["output_layers.0.judge_embedding.weight"].detach().numpy())
    assert len(loaded["layers"]) == 3
    seeded = tu.init_utmos_state_dict(seed=1, cfg=tu.UTMOSConfig(num_layers=2))
    wav = (np.random.default_rng(1).normal(size=(1, 8000)) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        tu.utmos_score_from_params(tu.utmos_params_from_torch(seeded, "cpu"), wav),
        ju.utmos_score_from_params(ju.utmos_params_from_torch(seeded), wav), rtol=1e-4)
    assert tu.load_utmos(str(tmp_path / "absent.ckpt"), device="cpu") is None
