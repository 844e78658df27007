"""The port's loaders and CLIs on the CPU, against the JAX package: the YAML
configs, Lightning checkpoints written at test time (JAX
``wavtokenizer_state_dict`` saved with ``torch.save``), the 0911 averaging
quirk, audio reading and resampling, and ``tools/infer.py`` /
``tools/extract_features.py`` end to end on scipy-written WAVs.

Codes are compared exactly; audio reading and resampling are the same numpy
arithmetic on both sides and compared exactly.
"""

import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from wavtokenizer_tpu.api.config import spec_from_config as j_spec_from_config
from wavtokenizer_tpu.checkpoint.export import wavtokenizer_state_dict
from wavtokenizer_tpu.models import wavtokenizer as jw
from wavtokenizer_tpu.models.init import init_wavtokenizer as j_init
from wavtokenizer_tpu.train.data import read_audio as j_read_audio, resample_np as j_resample_np
from wavtokenizer_tpu_torch import WavTokenizer
from wavtokenizer_tpu_torch.api.config import spec_from_config
from wavtokenizer_tpu_torch.checkpoint.convert import average_state_dicts, load_torch_state_dict
from wavtokenizer_tpu_torch.models.seanet import seanet_encode
from wavtokenizer_tpu_torch.tools import extract_features, infer
from wavtokenizer_tpu_torch.utils.audio import read_audio, resample_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A real-width encoder (n_filters 32, dimension 512 are fixed by the YAML
# schema) with hop 32 and a narrow backbone, so the CPU runs stay short.
NARROW_YAML = """\
feature_extractor:
  class_path: decoder.feature_extractors.EncodecFeatures
  init_args: {bandwidths: [6.6], dowmsamples: [4, 2, 2, 2], vq_bins: 64, num_quantizers: 1}
backbone:
  class_path: decoder.models.VocosBackbone
  init_args: {input_channels: 512, dim: 64, intermediate_dim: 192, num_layers: 2,
              adanorm_num_embeddings: 4}
head:
  class_path: decoder.heads.ISTFTHead
  init_args: {dim: 64, n_fft: 128, hop_length: 32, padding: same}
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test run's parallel workers share the cores,
    and PyTorch's default pool (a thread per core) in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))))
def test_spec_from_config_matches_jax(path):
    got, want = spec_from_config(path), j_spec_from_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hop_length == want.hop_length


def _params(jspec, seed):
    """Seeded params whose codebook sits around the encoder's embeddings,
    so that the codes vary."""
    params = j_init(jspec, seed=seed, random_codebook=True)
    audio = (np.random.default_rng(seed).normal(size=(2, 2048)) * 0.1).astype(np.float32)
    emb = np.asarray(jw.seanet_encode(params["encoder"], jspec.seanet,
                                      jnp.asarray(audio[:, :, None])))
    emb = emb.reshape(-1, emb.shape[-1])
    rng = np.random.default_rng(seed)
    codes = emb.mean(0) + rng.normal(size=(jspec.vq.bins, emb.shape[1])) * emb.std(0)
    params["quantizer"]["embed"] = codes.astype(np.float32)[None]
    return params


def _state_dict(jspec, params) -> dict:
    sd = wavtokenizer_state_dict(params, jspec.seanet, jspec.backbone,
                                 head_n_fft=jspec.head.n_fft)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """A YAML, a Lightning .ckpt with discriminator keys beside the codec's,
    and the params it holds."""
    d = tmp_path_factory.mktemp("release")
    cfg = d / "narrow.yaml"
    cfg.write_text(NARROW_YAML)
    jspec = j_spec_from_config(str(cfg))
    params = _params(jspec, 0)
    sd = _state_dict(jspec, params)
    sd["multiperioddisc.discriminators.0.convs.0.weight_v"] = torch.zeros(4, 1, 5, 1)
    sd["dac.discriminators.0.convs.0.0.bias"] = torch.zeros(4)
    ckpt = d / "model.ckpt"
    torch.save({"state_dict": sd, "epoch": 3}, ckpt)
    return cfg, ckpt, jspec, params


def test_from_pretrained0802_filters_and_matches_from_jax_params(release):
    cfg, ckpt, jspec, params = release
    sd = load_torch_state_dict(str(ckpt))
    assert not any(k.startswith(("multiperioddisc.", "dac.")) for k in sd)
    assert all(isinstance(v, np.ndarray) for v in sd.values())
    wt = WavTokenizer.from_pretrained0802(str(cfg), str(ckpt), device="cpu")
    ref = WavTokenizer.from_jax_params(params, wt.spec, device="cpu")
    audio = (np.random.default_rng(1).normal(size=(2, 3200)) * 0.1).astype(np.float32)
    codes = wt.encode_infer(audio)[1]
    assert len(np.unique(codes.numpy())) > 5
    assert torch.equal(codes, ref.encode_infer(audio)[1])
    _, codes_j = jw.encode_infer(params, jspec, jnp.asarray(audio))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))


def test_load_torch_state_dict_reads_full_pickles_after_weights_only(release, tmp_path):
    import argparse
    _, ckpt, _, _ = release
    sd = torch.load(ckpt, weights_only=True)["state_dict"]
    path = tmp_path / "hparams.ckpt"
    # A pickled object that weights_only=True refuses.
    torch.save({"state_dict": sd, "hyper_parameters": argparse.Namespace(lr=1e-4)}, path)
    with pytest.raises(Exception):
        torch.load(path, weights_only=True)
    got = load_torch_state_dict(str(path))
    assert got.keys() == load_torch_state_dict(str(ckpt)).keys()


def test_from_pretrained0911_keeps_the_string_sort_quirk(release, tmp_path):
    cfg, _, jspec, params = release
    names = {"10.234": 1.0, "3.1000": 1.1, "4.5670": 0.9, "9.9990": 5.0}
    sds = {}
    for loss, scale in names.items():
        sd = {k: v * scale if v.dtype.is_floating_point else v
              for k, v in _state_dict(jspec, params).items()}
        sds[loss] = sd
        torch.save({"state_dict": sd},
                   tmp_path / f"vocos_checkpoint_epoch=1_val_loss={loss}.ckpt")
    (tmp_path / "other.ckpt").write_bytes(b"not a vocos_ checkpoint")
    wt = WavTokenizer.from_pretrained0911(str(cfg), str(tmp_path), device="cpu")
    # As strings, "10.234" < "3.1000" < "4.5670" < "9.9990": the three kept
    # include the worst loss and leave out 9.999, as the reference does.
    kept = [{k: v.numpy() for k, v in sds[loss].items()}
            for loss in ("10.234", "3.1000", "4.5670")]
    ref = WavTokenizer.from_state_dict(average_state_dicts(kept), wt.spec, device="cpu")
    for a, b in ((wt.params["quantizer"]["embed"], ref.params["quantizer"]["embed"]),
                 (wt.params["head"]["out"]["weight"], ref.params["head"]["out"]["weight"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["int16", "int32", "uint8", "float32"])
def test_read_audio_matches_jax(tmp_path, dtype):
    rng = np.random.default_rng(5)
    y = rng.uniform(-0.9, 0.9, size=(1000, 2))
    data = {"int16": (y * 32767).astype(np.int16),
            "int32": (y * 2 ** 31).astype(np.int32),
            "uint8": (y * 127 + 128).astype(np.uint8),
            "float32": y.astype(np.float32)}[dtype]
    path = str(tmp_path / "a.wav")
    wavfile.write(path, 22050, data)
    got, sr = read_audio(path)
    want, want_sr = j_read_audio(path)
    assert sr == want_sr == 22050 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("orig,new", [(16000, 24000), (44100, 24000), (24000, 16000),
                                      (24000, 24000)])
def test_resample_np_matches_jax(orig, new):
    y = np.random.default_rng(orig).normal(size=4001).astype(np.float32)
    got = resample_np(y, orig, new)
    assert got.shape == (-(-4001 * new // orig),)
    np.testing.assert_array_equal(got, j_resample_np(y, orig, new))


def _write_wavs(d, specs):
    paths = []
    for i, (sr, n) in enumerate(specs):
        y = np.random.default_rng(i).normal(size=n) * 0.1
        path = str(d / f"clip{i}.wav")
        wavfile.write(path, sr, (y * 32767).astype(np.int16))
        paths.append(path)
    return paths


def test_infer_cli_end_to_end(release, tmp_path):
    cfg, ckpt, _, _ = release
    paths = _write_wavs(tmp_path, [(24000, 6000), (16000, 1000)])
    filelist = tmp_path / "files.txt"
    filelist.write_text("\n".join(paths) + "\n")
    out = tmp_path / "out"
    assert infer.main(["--config", str(cfg), "--ckpt", str(ckpt), "--filelist",
                       str(filelist), "--out-dir", str(out), "--device", "cpu",
                       "--chunk-seconds", "0.1", "--batch-size", "4"]) == 0
    wt = WavTokenizer.from_pretrained0802(str(cfg), str(ckpt), device="cpu")
    from wavtokenizer_tpu_torch.api.streaming import reconstruct_long
    for path, n in zip(paths, (6000, 1500)):
        sr, got = wavfile.read(str(out / os.path.basename(path)))
        assert sr == 24000 and got.dtype == np.int16 and got.shape == (n,)
        y, in_sr = read_audio(path)
        want = reconstruct_long(wt, resample_np(y, in_sr, 24000), chunk_seconds=0.1)
        want = (np.clip(want.numpy(), -0.99, 0.99) * 32767).astype(np.int16)
        # Batches of 4 chunks against one call per file: a rounding step at most.
        assert np.abs(got.astype(np.int32) - want).max() <= 1


def test_extract_features_cli_end_to_end(release, tmp_path):
    cfg, ckpt, _, _ = release
    indir = tmp_path / "in"
    indir.mkdir()
    paths = _write_wavs(indir, [(24000, 2400), (24000, 900), (16000, 3000)])
    out = tmp_path / "feats"
    assert extract_features.main(["--config", str(cfg), "--ckpt", str(ckpt), "--input",
                                  str(indir), "--out-dir", str(out), "--device", "cpu",
                                  "--seconds", "0.1", "--batch-size", "2", "--codes"]) == 0
    wt = WavTokenizer.from_pretrained0802(str(cfg), str(ckpt), device="cpu")
    for path in paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        feats = np.load(out / f"{stem}_features.npy")
        codes = np.load(out / f"{stem}_codes.npy")
        assert feats.shape == (512, 75) and codes.shape == (1, 75)
        window = torch.from_numpy(extract_features.load_window(path, 24000, 2400))[None]
        with torch.inference_mode():
            emb = seanet_encode(wt.params["encoder"], wt.spec.seanet, window[:, :, None])
        np.testing.assert_allclose(feats, emb[0].T.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(codes, wt.encode_infer(window)[1][:, 0].numpy())
