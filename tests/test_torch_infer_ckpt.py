"""tools/infer.py with the port's own training checkpoint: a ``save_checkpoint``
file goes to ``WavTokenizer.from_train_checkpoint`` (as the JAX tool sends its
training checkpoints to its ``from_train_checkpoint``), a Lightning
checkpoint to ``from_pretrained0802``.  The CLI's WAVs are held to the same
loader and ``reconstruct_long_batch`` called directly (the same CPU
arithmetic: equal up to the PCM16 rounding of both).
"""

import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from wavtokenizer_tpu_torch import WavTokenizer
from wavtokenizer_tpu_torch.api.config import spec_from_config
from wavtokenizer_tpu_torch.api.streaming import reconstruct_long_batch
from wavtokenizer_tpu_torch.checkpoint.export import (export_training_state_dict,
                                                      save_torch_checkpoint)
from wavtokenizer_tpu_torch.tools import infer as infer_cli
from wavtokenizer_tpu_torch.train.step import TrainConfig, create_train_state
from wavtokenizer_tpu_torch.train.trainer import save_checkpoint
from wavtokenizer_tpu_torch.utils.audio import read_audio

# The narrowest codec a config file can describe (32 filters, dimension 512;
# hop 32), as tests/test_torch_trainer.py writes it.
CODEC_YAML = """\
model:
  class_path: decoder.experiment.WavTokenizer
  init_args:
    sample_rate: 24000
    feature_extractor:
      class_path: decoder.feature_extractors.EncodecFeatures
      init_args: {bandwidths: [6.6, 6.6, 6.6, 6.6], dowmsamples: [4, 2, 2, 2], vq_bins: 64,
                  vq_kmeans: 2, num_quantizers: 1}
    backbone:
      class_path: decoder.models.VocosBackbone
      init_args: {input_channels: 512, dim: 64, intermediate_dim: 192, num_layers: 1,
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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A narrow YAML, a trainer checkpoint of a fresh state (its codebook
    drawn at random, as k-means would leave it), its Lightning export, and
    two WAVs (one longer than a 3 s chunk) with their file list."""
    d = tmp_path_factory.mktemp("infer_ckpt")
    cfg = d / "codec.yaml"
    cfg.write_text(CODEC_YAML)
    spec = spec_from_config(str(cfg))
    state = create_train_state(spec, TrainConfig(disc_channels_scale=0.0625), seed=0,
                               device="cpu")
    g = torch.Generator().manual_seed(1)
    state["vq"]["embed"] = torch.randn(state["vq"]["embed"].shape, generator=g) * 0.01
    state["vq"]["inited"] = torch.ones_like(state["vq"]["inited"])
    state["step"] = 3
    ckpt = d / "last.pt"
    save_checkpoint(str(ckpt), state)
    lightning = d / "export.ckpt"
    save_torch_checkpoint(str(lightning), export_training_state_dict(
        torch.load(ckpt, map_location="cpu", weights_only=True), spec))
    rng = np.random.default_rng(2)
    files = []
    for i, n in enumerate((24000 * 4, 24000)):
        y = 0.3 * np.sin(2 * np.pi * 220 * np.arange(n) / 24000) + 0.05 * rng.normal(size=n)
        files.append(str(d / f"clip{i}.wav"))
        wavfile.write(files[-1], 24000, (np.clip(y, -1, 1) * 32767).astype(np.int16))
    filelist = d / "files.txt"
    filelist.write_text("\n".join(files) + "\n")
    return {"dir": d, "cfg": str(cfg), "ckpt": str(ckpt), "lightning": str(lightning),
            "files": files, "filelist": str(filelist)}


def test_train_checkpoint_is_told_apart_by_content(run):
    assert infer_cli.is_train_checkpoint(run["ckpt"])
    assert not infer_cli.is_train_checkpoint(run["lightning"])


@pytest.mark.parametrize("which", ["ckpt", "lightning"])
def test_infer_cli_reconstructs_through_the_matching_loader(run, which, tmp_path):
    out = tmp_path / "out"
    assert infer_cli.main(["--config", run["cfg"], "--ckpt", run[which],
                           "--filelist", run["filelist"], "--out-dir", str(out),
                           "--device", "cpu", "--batch-size", "4"]) == 0
    load = (WavTokenizer.from_train_checkpoint if which == "ckpt"
            else WavTokenizer.from_pretrained0802)
    model = load(run["cfg"], run[which], device="cpu")
    audios = [read_audio(p)[0] for p in run["files"]]
    wavs = reconstruct_long_batch(model, audios, chunk_seconds=3.0, overlap=0.25,
                                  bandwidth_id=0, batch_size=4)
    for path, y, want in zip(run["files"], audios, wavs):
        got = read_audio(os.path.join(out, os.path.basename(path)))[0]
        want = np.clip(want.numpy()[:len(y)], -0.99, 0.99)
        assert got.shape == want.shape
        assert np.isfinite(want).all() and np.abs(want).max() > 1e-4
        # Both sides through PCM16: at most one step apart.
        np.testing.assert_allclose(got, (want * 32767).astype(np.int16) / 32768.0,
                                   rtol=0, atol=1.5 / 32768)
