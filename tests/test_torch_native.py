"""The port's native data loader (``wavtokenizer_tpu_torch/native/``) against
the JAX package's, and the trainer's use of it.

Both bind the same C++ source (the port keeps a byte-equal copy), so their
batches are bit-equal for one seed, whatever the thread count: mono and
stereo files at 16, 24 and 44.1 kHz, a resumed stream (``start_seq``), the
last batch of an epoch repeat-padded.  The trainer takes the native loader
on an all-``.wav`` list, as JAX's ``_make_train_iter`` does, and the Python
loader otherwise or when the library cannot be built.  Skipped where ``g++``
cannot build the library, as ``tests/test_native.py`` is.
"""

import filecmp
import inspect
import json
import os
import types

import numpy as np
import pytest
from scipy.io import wavfile

from wavtokenizer_tpu import native as jnative
from wavtokenizer_tpu.train import data as jdata
from wavtokenizer_tpu.train.trainer import Trainer as JTrainer
from wavtokenizer_tpu_torch import (ISTFTHeadConfig, SEANetConfig, VQConfig,
                                    VocosBackboneConfig, WavTokenizerSpec, native)
from wavtokenizer_tpu_torch.train import data as tdata
from wavtokenizer_tpu_torch.train import trainer as trainer_mod
from wavtokenizer_tpu_torch.train.helpers import TBLogger
from wavtokenizer_tpu_torch.train.step import TrainConfig

TINY = WavTokenizerSpec(
    seanet=SEANetConfig(dimension=16, n_filters=2, ratios=(8, 5, 4, 2)),
    vq=VQConfig(dimension=16, bins=32, kmeans_iters=2),
    backbone=VocosBackboneConfig(input_channels=16, dim=32, intermediate_dim=64, num_layers=1,
                                 adanorm_num_embeddings=4),
    head=ISTFTHeadConfig(dim=32, n_fft=1280, hop_length=320))


@pytest.fixture(scope="module", autouse=True)
def built():
    if not (native.available() and jnative.available()):
        pytest.skip("g++ cannot build the native loader here")


class _NoTensorBoard(TBLogger):
    """The trainer's TensorBoard writer, off: importing tensorboard takes
    seconds and the loader needs none of it."""

    def __init__(self, logdir):
        self._w = None


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setattr(trainer_mod, "TBLogger", _NoTensorBoard)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Seven files: mono int16 at 16/24/44.1 kHz, stereo at 24 and 44.1 kHz,
    one shorter than a crop; and their file list."""
    d = tmp_path_factory.mktemp("native_wavs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (sr, n, ch) in enumerate([(16000, 9000, 1), (24000, 12000, 1), (44100, 20000, 1),
                                     (24000, 14000, 2), (44100, 16000, 2), (24000, 3000, 1),
                                     (16000, 11000, 2)]):
        t = np.arange(n) / sr
        y = 0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t) + 0.05 * rng.normal(size=n)
        if ch == 2:
            y = np.stack([y, 0.5 * y[::-1]], axis=1)
        paths.append(str(d / f"clip{i}.wav"))
        wavfile.write(paths[-1], sr, (np.clip(y, -1, 1) * 32767).astype(np.int16))
    filelist = d / "files.txt"
    filelist.write_text("\n".join(paths) + "\n")
    return paths, str(filelist)


def test_source_is_the_jax_packages_and_builds_into_the_build_dir():
    assert filecmp.cmp(native.SOURCE, jnative._SRC, shallow=False)
    path = native.build()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "_build"
    assert os.path.dirname(native.SOURCE) != native.BUILD_DIR


@pytest.mark.parametrize("threads,start_seq,train", [(2, 0, True), (4, 0, True),
                                                     (4, 3, True), (2, 0, False)])
def test_batches_bit_equal_to_jax(wavs, threads, start_seq, train):
    """7 files at batch 3 with drop_last=False: an epoch is 2 full batches and
    a tail repeat-padded; 5 batches cross an epoch boundary."""
    paths, _ = wavs
    kw = dict(sample_rate=24000, num_samples=7200, batch_size=3, train=train, seed=11,
              drop_last=False, start_seq=start_seq)
    got = native.NativeDataLoader(paths, num_threads=threads, **kw)
    want = jnative.NativeDataLoader(paths, num_threads=2, **kw)
    try:
        for _ in range(5):
            np.testing.assert_array_equal(got.next_batch(), want.next_batch())
        assert got.errors == want.errors == 0
    finally:
        got.close()
        want.close()


def test_start_seq_resumes_the_stream_and_the_tail_is_repeat_padded(wavs):
    paths, _ = wavs
    kw = dict(sample_rate=24000, num_samples=7200, batch_size=3, num_threads=2, seed=5,
              drop_last=False)
    ldr = native.NativeDataLoader(paths, **kw)
    stream = [ldr.next_batch() for _ in range(5)]
    ldr.close()
    resumed = native.NativeDataLoader(paths, start_seq=2, **kw)
    np.testing.assert_array_equal(resumed.next_batch(), stream[2])
    resumed.close()
    tail = stream[2]                      # 7 files: the third batch holds one
    np.testing.assert_array_equal(tail[0], tail[1])
    np.testing.assert_array_equal(tail[0], tail[2])
    assert np.abs(tail).max() > 0


@pytest.mark.parametrize("i", [0, 2, 3, 4])
def test_read_wav_mono_equals_jax(wavs, i):
    paths, _ = wavs
    y, sr = native.read_wav_mono(paths[i])
    jy, jsr = jnative.read_wav_mono(paths[i])
    assert sr == jsr
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("rates", [(44100, 24000), (16000, 24000), (24000, 16000)])
def test_resample_native_equals_jax(rates):
    x = np.random.default_rng(1).normal(size=9000).astype(np.float32)
    np.testing.assert_array_equal(native.resample_native(x, *rates),
                                  jnative.resample_native(x, *rates))


def _trainer(tmp_path, filelist, name, num_workers=0):
    data = tdata.DataConfig(filelist_path=filelist, num_samples=7200, batch_size=3,
                            num_workers=num_workers)
    return trainer_mod.Trainer(TINY, TrainConfig(max_steps=100, disc_channels_scale=0.0625),
                               data, out_dir=str(tmp_path / name), log_every=1,
                               log_media_every=10 ** 9, seed=11, device="cpu")


def _events(tr):
    with open(os.path.join(tr.out_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "event" in r]


def test_fit_trains_on_the_native_loaders_batches_as_jax(tmp_path, wavs, monkeypatch):
    """``fit(max_batches=2)`` on an all-.wav list logs ``native_loader`` and
    trains on the batches JAX's ``_make_train_iter`` yields."""
    _, filelist = wavs
    seen = []

    def record(state, audio, *args, **kw):
        seen.append(audio.numpy().copy())
        state["step"] += 1
        return state, {}

    monkeypatch.setattr(trainer_mod, "train_step", record)
    tr = _trainer(tmp_path, filelist, "fit")
    tr.fit(max_batches=2)
    tr.close()
    assert _events(tr)[0] == {"event": "native_loader", "files": 7}
    jdata_cfg = jdata.DataConfig(filelist_path=filelist, num_samples=7200, batch_size=3)
    stub = types.SimpleNamespace(train_data=jdata_cfg, seed=11, log=lambda r: None)
    want = JTrainer._make_train_iter(stub, 0)
    for got in seen:
        np.testing.assert_array_equal(got, next(want))
    want.close()


def test_loader_threads_follow_num_workers(tmp_path, wavs, monkeypatch):
    """The YAML's num_workers reaches the native loader as its thread count
    (at least 2), as in the JAX trainer."""
    import yaml

    _, filelist = wavs
    config = yaml.safe_load(f"""\
model:
  init_args:
    feature_extractor:
      class_path: decoder.feature_extractors.EncodecFeatures
      init_args: {{bandwidths: [6.6], dowmsamples: [4, 2, 2, 2], vq_bins: 64, vq_kmeans: 2,
                  num_quantizers: 1}}
    backbone:
      class_path: decoder.models.VocosBackbone
      init_args: {{input_channels: 512, dim: 64, intermediate_dim: 192, num_layers: 1}}
    head:
      class_path: decoder.heads.ISTFTHead
      init_args: {{dim: 64, n_fft: 128, hop_length: 32, padding: same}}
data:
  init_args:
    train_params: {{filelist_path: {filelist}, num_samples: 7200, batch_size: 3,
                   num_workers: 5}}
""")
    _, _, train_data, _ = trainer_mod.train_config_from_yaml(config)
    assert train_data.num_workers == 5
    calls = []
    monkeypatch.setattr(native, "NativeDataLoader",
                        lambda files, **kw: calls.append(kw) or iter([]))
    for workers, threads in ((5, 5), (0, 2)):
        _trainer(tmp_path, filelist, f"w{workers}", workers)._make_train_iter(4)
        assert calls[-1]["num_threads"] == threads
        assert calls[-1]["start_seq"] == 4 and calls[-1]["seed"] == 11
        assert calls[-1]["drop_last"] is False


@pytest.mark.parametrize("ext", [".flac", ".mp3"])
def test_a_list_with_another_format_takes_the_python_loader(tmp_path, wavs, ext):
    paths, _ = wavs
    filelist = tmp_path / "mixed.txt"
    filelist.write_text("\n".join(paths[:2] + [str(tmp_path / f"other{ext}")]) + "\n")
    tr = _trainer(tmp_path, str(filelist), "mixed")
    it = tr._make_train_iter(0)
    tr.close()
    assert inspect.isgenerator(it) and it.gi_code is tdata.data_loader.__code__
    assert _events(tr) == []


def test_a_loader_that_cannot_be_built_falls_back_to_python(tmp_path, wavs, monkeypatch):
    _, filelist = wavs

    def broken(*args, **kw):
        raise RuntimeError("g++ failed to build the data loader")

    monkeypatch.setattr(native, "NativeDataLoader", broken)
    tr = _trainer(tmp_path, filelist, "broken")
    it = tr._make_train_iter(0)
    batch = next(it)
    tr.close()
    assert _events(tr) == [{"event": "native_loader_unavailable",
                            "error": "g++ failed to build the data loader"}]
    want = tdata.data_loader(tdata.WavDataset(tr.train_data, train=True), 3, shuffle=True,
                             seed=11, drop_last=False)
    np.testing.assert_array_equal(batch, next(want))
