"""The port's residual VQ, training-style encode, copy synthesis and
SEANet-only decode against the JAX package on the CPU, at small widths and
n_q = 2, where the language VQ's overwrite quirk shows (its features are the
LAST layer's quantization of the one embedding, not the first's).

Tolerances: fp32 on both sides, other summation orders: ~1e-6 for a codebook
lookup and sum, 1e-4 for a waveform through the SEANet decoder, 1e-3 where
the port's ConvNeXt rounds its matmul operands to bf16 (as its kernel does)
and JAX's default path does not.  Codes are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavtokenizer_tpu.api.pretrained import WavTokenizer as JWavTokenizer
from wavtokenizer_tpu.models import quantize as jq
from wavtokenizer_tpu.models import wavtokenizer as jw
from wavtokenizer_tpu.models.init import init_wavtokenizer as j_init
from wavtokenizer_tpu.models.quantize import VQConfig as JVQConfig
from wavtokenizer_tpu.models.seanet import SEANetConfig as JSEANetConfig
from wavtokenizer_tpu.models.vocos import (ISTFTHeadConfig as JISTFTHeadConfig,
                                           VocosBackboneConfig as JVocosBackboneConfig)
from wavtokenizer_tpu_torch import (ISTFTHeadConfig, SEANetConfig, VQConfig,
                                    VocosBackboneConfig, WavTokenizer, WavTokenizerSpec)
from wavtokenizer_tpu_torch.api.pretrained import quantizer_from_jax
from wavtokenizer_tpu_torch.models import quantize as tq
from wavtokenizer_tpu_torch.models import wavtokenizer as tw

SMALL = dict(seanet=dict(n_filters=8, dimension=32, ratios=(4, 2, 2, 2)),
             vq=dict(dimension=32, n_q=2, bins=64),
             backbone=dict(input_channels=32, dim=64, intermediate_dim=192,
                           num_layers=2, groupnorm_groups=8),
             head=dict(dim=64, n_fft=128, hop_length=32))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test run's parallel workers share the cores,
    and PyTorch's default pool (a thread per core) in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _codebooks(x: np.ndarray, n_q: int, bins: int, seed: int) -> np.ndarray:
    """(n_q, bins, D) codebooks spread over x (N, D), each layer narrower, so
    both the first codes and the residual codes vary."""
    rng = np.random.default_rng(seed)
    mean, std = x.mean(0), x.std(0)
    books = [mean + rng.normal(size=(bins, x.shape[1])) * std]
    books += [rng.normal(size=(bins, x.shape[1])) * std * 0.5 ** q for q in range(1, n_q)]
    return np.stack(books).astype(np.float32)


@pytest.fixture(scope="module")
def small():
    """(port spec, JAX spec, params, audio): a narrow n_q = 2 model whose
    codebooks are drawn around its own encoder's embeddings."""
    tspec = WavTokenizerSpec(seanet=SEANetConfig(**SMALL["seanet"]), vq=VQConfig(**SMALL["vq"]),
                             backbone=VocosBackboneConfig(**SMALL["backbone"]),
                             head=ISTFTHeadConfig(**SMALL["head"]))
    jspec = jw.WavTokenizerSpec(seanet=JSEANetConfig(**SMALL["seanet"]),
                                vq=JVQConfig(**SMALL["vq"]),
                                backbone=JVocosBackboneConfig(**SMALL["backbone"]),
                                head=JISTFTHeadConfig(**SMALL["head"]))
    audio = (np.random.default_rng(3).normal(size=(2, 2048)) * 0.1).astype(np.float32)
    params = j_init(jspec, seed=3, random_codebook=True)
    emb = np.asarray(jw.seanet_encode(params["encoder"], jspec.seanet,
                                      jnp.asarray(audio[:, :, None])))
    params["quantizer"]["embed"] = _codebooks(emb.reshape(-1, emb.shape[-1]), 2, 64, 3)
    return tspec, jspec, params, audio


def _vq_case(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 40, 16)).astype(np.float32)
    embed = _codebooks(x.reshape(-1, 16), 2, 32, seed)
    return x, embed, jq.VQConfig(dimension=16, n_q=2, bins=32), VQConfig(dimension=16, n_q=2,
                                                                          bins=32)


def test_vq_encode_chains_residuals_like_jax():
    x, embed, jcfg, tcfg = _vq_case(0)
    want = np.asarray(jq.vq_encode({"embed": jnp.asarray(embed)}, jcfg, jnp.asarray(x)))
    got = tq.vq_encode(quantizer_from_jax({"embed": embed}, "cpu"), tcfg, torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (2, 2, 40)
    assert len(np.unique(want[0])) > 5 and len(np.unique(want[1])) > 5
    np.testing.assert_array_equal(got.numpy(), want)
    # The second layer searches the residual, not the input.
    assert not np.array_equal(want[1], np.asarray(jq.vq_forward_language(
        {"embed": jnp.asarray(embed)}, jcfg, jnp.asarray(x))[1])[1])


def test_vq_decode_matches_jax():
    x, embed, jcfg, tcfg = _vq_case(1)
    codes = np.random.default_rng(1).integers(0, 32, size=(2, 2, 40)).astype(np.int32)
    want = jq.vq_decode({"embed": jnp.asarray(embed)}, jnp.asarray(codes))
    got = tq.vq_decode(quantizer_from_jax({"embed": embed}, "cpu"), torch.from_numpy(codes))
    assert got.shape == want.shape == (2, 40, 16)
    assert _rel(got, want) <= 1e-6


def test_vq_forward_language_keeps_the_overwrite_quirk():
    x, embed, jcfg, tcfg = _vq_case(2)
    jq_out, jcodes, _ = jq.vq_forward_language({"embed": jnp.asarray(embed)}, jcfg,
                                               jnp.asarray(x))
    q, codes = tq.vq_forward_language(quantizer_from_jax({"embed": embed}, "cpu"), tcfg,
                                      torch.from_numpy(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert _rel(q, jq_out) <= 1e-6
    # The features are layer 1's lookup of its own codes of the raw input.
    np.testing.assert_array_equal(q.numpy(), embed[1][codes[1].numpy()])


@pytest.mark.parametrize("bins,frame_rate,bandwidth", [
    (1024, 75, 1.5), (1024, 75, 24.0), (1024, 150, 6.0), (4096, 75, None), (64, 40, 0.1),
    (4096, 40, -1.0)])
def test_n_q_for_bandwidth_matches_jax(bins, frame_rate, bandwidth):
    j, t = JVQConfig(bins=bins, n_q=32), VQConfig(bins=bins, n_q=32)
    assert t.bw_per_q(frame_rate) == j.bw_per_q(frame_rate)
    assert t.n_q_for_bandwidth(frame_rate, bandwidth) == j.n_q_for_bandwidth(frame_rate,
                                                                            bandwidth)


def test_frame_rate_matches_jax():
    for sr, ratios in ((24000, (8, 5, 4, 2)), (24000, (8, 5, 4, 3)), (16000, (8, 5, 4, 2))):
        t = WavTokenizerSpec(seanet=SEANetConfig(ratios=ratios), sample_rate=sr)
        j = jw.WavTokenizerSpec(seanet=JSEANetConfig(ratios=ratios), sample_rate=sr)
        assert t.frame_rate == j.frame_rate


@pytest.mark.parametrize("n_q", [1, 2])
def test_encode_forward_matches_jax(small, n_q):
    tspec, jspec, params, audio = small
    feats_j, codes_j = jax.jit(lambda p, a: jw.encode_forward(p, jspec, a, n_q=n_q))(
        params, jnp.asarray(audio))
    model = WavTokenizer.from_jax_params(params, tspec, device="cpu")
    feats, codes = tw.encode_forward(model.params, tspec, torch.from_numpy(audio), n_q=n_q)
    assert codes.shape == (n_q, 2, 64)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    assert _rel(feats, feats_j) <= 1e-4
    if n_q == 1:
        feats_i, codes_i = model.encode_infer(audio)
        np.testing.assert_array_equal(codes.numpy(), codes_i.numpy())
        np.testing.assert_array_equal(feats.numpy(), feats_i.numpy())


def test_forward_matches_jax(small):
    tspec, jspec, params, audio = small
    want = np.asarray(jax.jit(lambda p, a: jw.forward(p, jspec, a, 1))(params,
                                                                      jnp.asarray(audio)))
    got = tw.forward(WavTokenizer.from_jax_params(params, tspec, device="cpu").params, tspec,
                     torch.from_numpy(audio), 1)
    assert got.shape == want.shape == (2, 2048)
    assert _rel(got, want) <= 1e-3


def test_seanet_only_decode_matches_jax(small):
    tspec, jspec, params, _ = small
    feats = np.random.default_rng(4).normal(size=(2, 32, 20)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, f: jw.seanet_only_decode(p, jspec, f))(
        params, jnp.asarray(feats)))
    got = WavTokenizer.from_jax_params(params, tspec, device="cpu").seanet_only_decode(feats)
    assert got.shape == want.shape == (2, 20 * 32)
    assert _rel(got, want) <= 1e-4


def test_facade_encode_and_copy_synthesis_match_jax_at_n_q_2(small):
    """``encode`` and ``__call__``/``forward`` go through the training-style
    VQ forward, whose features at n_q = 2 are layer 1's: not encode_infer's."""
    tspec, jspec, params, audio = small
    jwt = JWavTokenizer(params, jspec)
    twt = WavTokenizer.from_jax_params(params, tspec, device="cpu")
    feats_j, codes_j = jwt.encode(audio)
    feats, codes = twt.encode(audio)
    assert codes.shape == (2, 2, 64)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    assert _rel(feats, feats_j) <= 1e-4
    assert _rel(twt.encode_infer(audio)[0], feats_j) > 1e-2   # the quirk is visible here
    want = np.asarray(jwt(audio, 1))
    assert _rel(twt(audio, 1), want) <= 1e-3
    np.testing.assert_array_equal(twt.forward(audio, 1).numpy(), twt(audio, 1).numpy())
