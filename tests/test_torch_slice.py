"""The PyTorch port's codec round trip against the JAX package on the CPU:
the numpy init, the state-dict road, the round trip at a small spec, and the
committed golden tokens at full width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavtokenizer_tpu.checkpoint.convert import convert_wavtokenizer_state_dict as j_convert
from wavtokenizer_tpu.checkpoint.export import wavtokenizer_state_dict
from wavtokenizer_tpu.models import wavtokenizer as jw
from wavtokenizer_tpu.models.init import init_wavtokenizer as j_init
from wavtokenizer_tpu.models.quantize import VQConfig as JVQConfig
from wavtokenizer_tpu.models.seanet import SEANetConfig as JSEANetConfig
from wavtokenizer_tpu.models.vocos import (ISTFTHeadConfig as JISTFTHeadConfig,
                                           VocosBackboneConfig as JVocosBackboneConfig)
from wavtokenizer_tpu.utils.golden import golden_specs as j_golden_specs
from wavtokenizer_tpu_torch import (ISTFTHeadConfig, SEANetConfig, VQConfig,
                                    VocosBackboneConfig, WavTokenizer,
                                    WavTokenizerSpec, init_wavtokenizer)
from wavtokenizer_tpu_torch.checkpoint.convert import (TrackedStateDict,
                                                       convert_wavtokenizer_state_dict)
from wavtokenizer_tpu_torch.utils.golden import (golden_clip, golden_specs,
                                                 load_golden, max_flips)

SMALL = dict(seanet=dict(n_filters=8, dimension=32, ratios=(4, 2, 2, 2)),
             vq=dict(dimension=32, bins=64),
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


def _small_specs():
    t = WavTokenizerSpec(seanet=SEANetConfig(**SMALL["seanet"]), vq=VQConfig(**SMALL["vq"]),
                         backbone=VocosBackboneConfig(**SMALL["backbone"]),
                         head=ISTFTHeadConfig(**SMALL["head"]))
    j = jw.WavTokenizerSpec(seanet=JSEANetConfig(**SMALL["seanet"]),
                            vq=JVQConfig(**SMALL["vq"]),
                            backbone=JVocosBackboneConfig(**SMALL["backbone"]),
                            head=JISTFTHeadConfig(**SMALL["head"]))
    return t, j


def _small_params(jspec, seed: int, audio: np.ndarray) -> dict:
    """Seeded params whose codebook is drawn around the encoder's own
    embeddings of ``audio``, so that the codes vary (the init's uniform
    codebook sits far from a narrow encoder's output)."""
    params = j_init(jspec, seed=seed, random_codebook=True)
    emb = np.asarray(jw.seanet_encode(params["encoder"], jspec.seanet,
                                      jnp.asarray(audio[:, :, None])))
    emb = emb.reshape(-1, emb.shape[-1])
    rng = np.random.default_rng(seed)
    codes = emb.mean(0) + rng.normal(size=(jspec.vq.bins, emb.shape[1])) * emb.std(0)
    params["quantizer"]["embed"] = codes.astype(np.float32)[None]
    return params


def _assert_tree_equal(a, b, path="params"):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif a is not None:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_small_round_trip_matches_jax():
    tspec, jspec = _small_specs()
    audio = (np.random.default_rng(3).normal(size=(2, 2048)) * 0.1).astype(np.float32)
    params = _small_params(jspec, 3, audio)
    feats_j, codes_j = jax.jit(lambda p, a: jw.encode_infer(p, jspec, a))(params, jnp.asarray(audio))
    wave_j = jax.jit(lambda p, c: jw.decode(p, jspec, jw.codes_to_features(p, c), 1))(params, codes_j)

    model = WavTokenizer.from_jax_params(params, tspec, device="cpu")
    feats_t, codes_t = model.encode_infer(audio)
    assert codes_t.dtype == torch.int32 and codes_t.shape == (1, 2, 64)
    assert len(np.unique(codes_t.numpy())) > 5
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(feats_t.numpy(), np.asarray(feats_j))
    wave_t = model.decode(model.codes_to_features(codes_t), bandwidth_id=1)
    assert wave_t.shape == (2, 2048)
    # bf16 matmul operands in the port's ConvNeXt blocks, fp32 in JAX's
    # default path, two blocks deep (measured ~5e-5).
    wave_j = np.asarray(wave_j)
    rel = np.max(np.abs(wave_t.numpy() - wave_j)) / np.max(np.abs(wave_j))
    print(f"small round trip: waveform rel-max {rel:.2g} against JAX")
    assert rel < 1e-3, rel
    # Copy synthesis is encode then decode.
    np.testing.assert_allclose(model(audio, 1).numpy(), wave_t.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("label", ["small320", "small600", "music16k"])
def test_numpy_init_bit_equal_to_jax(label):
    _assert_tree_equal(init_wavtokenizer(golden_specs()[label], seed=0, random_codebook=True),
                       j_init(j_golden_specs()[label], seed=0, random_codebook=True))


@pytest.mark.parametrize("label", ["small320", "small600", "music16k"])
def test_cpu_codes_match_golden(label):
    spec = golden_specs()[label]
    model = WavTokenizer.from_jax_params(init_wavtokenizer(spec, seed=0, random_codebook=True),
                                         spec, device="cpu")
    _, codes = model.encode_infer(golden_clip(spec))
    want = load_golden()[label]
    assert codes.shape == want.shape
    flips = int((codes.numpy() != want).sum())
    print(f"{label}: {flips} of {want.size} ids differ from the golden tokens")
    assert flips <= max_flips(want.size), flips


def test_from_state_dict_covers_every_key_and_matches_jax_converter():
    tspec, jspec = _small_specs()
    audio = (np.random.default_rng(5).normal(size=(2, 2048)) * 0.1).astype(np.float32)
    params = _small_params(jspec, 5, audio)
    sd = wavtokenizer_state_dict(params, jspec.seanet, jspec.backbone,
                                 head_n_fft=jspec.head.n_fft)
    tracked = TrackedStateDict({k: torch.from_numpy(v) for k, v in sd.items()})
    converted = convert_wavtokenizer_state_dict(tracked, tspec)
    # Every key is read, except the head's registered Hann window buffer.
    assert tracked.unused() == {"head.istft.window"}
    want = j_convert(sd, jspec.seanet, jspec.vq.n_q, jspec.backbone)
    _assert_tree_equal(converted, want)
    a = WavTokenizer.from_state_dict(sd, tspec, device="cpu").encode_infer(audio)[1]
    b = WavTokenizer.from_jax_params(want, tspec, device="cpu").encode_infer(audio)[1]
    assert len(np.unique(b.numpy())) > 5
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    # A missing key is an error, not a silent default.
    del sd["backbone.convnext.1.pwconv2.weight"]
    with pytest.raises(KeyError, match="pwconv2"):
        WavTokenizer.from_state_dict(sd, tspec, device="cpu")
