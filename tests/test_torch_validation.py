"""The port's validation score against the JAX trainer's, on the CPU.

val_loss = mel + (5 - utmos) + (5 - pesq) + 1000 * commit
(ref decoder/experiment.py:227-270), with periodicity RMSE, pitch RMSE,
voiced F1 and STOI logged beside it.  Both trainers score the same state
(the JAX state carried over by ``train_state_from_jax``) on the same
validation batch.

Tolerances: ``_host_val_metrics`` on the same numpy audio is numpy on both
sides (rel 1e-6).  Through ``validate`` each package makes its own
reconstruction, which differs in float noise (fp32 in other orders), so
val_loss and the ``val_*`` metrics are held to rel 1e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from wavtokenizer_tpu import (ISTFTHeadConfig as JISTFTHeadConfig, SEANetConfig as JSEANetConfig,
                              VQConfig as JVQConfig, VocosBackboneConfig as JVocosBackboneConfig,
                              WavTokenizerSpec as JWavTokenizerSpec)
from wavtokenizer_tpu.train import data as jdata
from wavtokenizer_tpu.train import trainer as jtrainer
from wavtokenizer_tpu.train.step import TrainConfig as JTrainConfig
from wavtokenizer_tpu.train.step import create_train_state as j_create_train_state
from wavtokenizer_tpu_torch import (ISTFTHeadConfig, SEANetConfig, VQConfig,
                                    VocosBackboneConfig, WavTokenizerSpec)
from wavtokenizer_tpu_torch.api.pretrained import train_state_from_jax
from wavtokenizer_tpu_torch.metrics.utmos import UTMOSConfig, init_utmos_state_dict
from wavtokenizer_tpu_torch.train import data as tdata
from wavtokenizer_tpu_torch.train import trainer as ttrainer
from wavtokenizer_tpu_torch.train.step import TrainConfig

SPEC = dict(seanet=dict(dimension=16, n_filters=2, ratios=(8, 5, 4, 2)),
            vq=dict(dimension=16, bins=32, kmeans_iters=2),
            backbone=dict(input_channels=16, dim=32, intermediate_dim=64, num_layers=1,
                          adanorm_num_embeddings=4),
            head=dict(dim=32, n_fft=1280, hop_length=320))
TCFG = dict(max_steps=10, disc_channels_scale=0.0625)
VAL_KEYS = ("val_mel_loss", "val_utmos_score", "val_pesq_score", "val_periodicity_loss",
            "val_pitch_loss", "val_f1_score", "val_stoi")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Four 0.8 s clips at 24 kHz (long enough for PESQ, and for STOI's
    30-frame window after its silent-frame removal)."""
    d = tmp_path_factory.mktemp("val_wavs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        t = np.arange(19200) / 24000
        f0 = 140 + 30 * i + 20 * np.sin(2 * np.pi * 2 * t)
        y = sum(0.2 / k * np.sin(2 * np.pi * k * np.cumsum(f0) / 24000) for k in range(1, 6))
        y = y * np.clip(np.sin(2 * np.pi * 2.5 * t), 0.1, None) + 0.01 * rng.normal(size=len(t))
        paths.append(str(d / f"v{i}.wav"))
        wavfile.write(paths[-1], 24000, (y * 32767).astype(np.int16))
    (d / "files.txt").write_text("\n".join(paths) + "\n")
    return str(d / "files.txt")


@pytest.fixture(scope="module")
def utmos_ckpt(tmp_path_factory):
    """A seeded random UTMOS checkpoint, one transformer layer at full width."""
    path = tmp_path_factory.mktemp("utmos") / "utmos.ckpt"
    sd = init_utmos_state_dict(0, UTMOSConfig(num_layers=1))
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    return str(path)


def _specs():
    t = WavTokenizerSpec(seanet=SEANetConfig(**SPEC["seanet"]), vq=VQConfig(**SPEC["vq"]),
                         backbone=VocosBackboneConfig(**SPEC["backbone"]),
                         head=ISTFTHeadConfig(**SPEC["head"]))
    j = JWavTokenizerSpec(seanet=JSEANetConfig(**SPEC["seanet"]), vq=JVQConfig(**SPEC["vq"]),
                          backbone=JVocosBackboneConfig(**SPEC["backbone"]),
                          head=JISTFTHeadConfig(**SPEC["head"]))
    return t, j


def _jax_state(jspec, jtcfg):
    """A JAX train state whose codebook is inited (random codes around the
    origin), so that validation runs no k-means."""
    state = jax.device_get(j_create_train_state(jspec, jtcfg, seed=0))
    vq = dict(state["vq"])
    rng = np.random.default_rng(1)
    vq["embed"] = (rng.normal(size=np.shape(vq["embed"])) * 0.05).astype(np.float32)
    vq["embed_avg"] = vq["embed"].copy()
    vq["inited"] = np.ones_like(vq["inited"])
    state["vq"] = vq
    return state


def _trainers(tmp_path, files, **flags):
    tspec, jspec = _specs()
    ttcfg, jtcfg = TrainConfig(**TCFG, **flags), JTrainConfig(**TCFG, **flags)
    kw = dict(filelist_path=files, num_samples=19200, batch_size=2)
    jdata_cfg, tdata_cfg = jdata.DataConfig(**kw, num_workers=0), tdata.DataConfig(**kw)
    jtr = jtrainer.Trainer(jspec, jtcfg, jdata_cfg, val_data=jdata_cfg,
                           out_dir=str(tmp_path / "jax"), limit_val_batches=1)
    ttr = ttrainer.Trainer(tspec, ttcfg, tdata_cfg, val_data=tdata_cfg,
                           out_dir=str(tmp_path / "port"), limit_val_batches=1, device="cpu")
    jstate = _jax_state(jspec, jtcfg)
    tstate = train_state_from_jax(jstate, tspec, ttcfg, device="cpu")
    jiter = jdata.data_loader(jdata.WavDataset(jdata_cfg, train=False, seed=0), 2,
                              shuffle=False, seed=0)
    titer = tdata.data_loader(tdata.WavDataset(tdata_cfg, train=False), 2, shuffle=False, seed=0)
    return (jtr, jax.tree.map(jnp.asarray, jstate), jiter), (ttr, tstate, titer)


def _rel(got: float, want: float) -> float:
    if np.isnan(want):
        return 0.0 if np.isnan(got) else np.inf
    return abs(got - want) / max(abs(want), 1e-12)


def test_validate_matches_jax(tmp_path, files, utmos_ckpt, monkeypatch, one_thread):
    """Every evaluator on (UTMOS from a random checkpoint): the same
    val_loss and the same val_* record, and the port's val_loss carries the
    PESQ and UTMOS terms (it once added the constant 10 instead)."""
    monkeypatch.setenv("WT_UTMOS_CKPT", utmos_ckpt)
    monkeypatch.delenv("WT_CREPE_CKPT", raising=False)
    (jtr, jstate, jiter), (ttr, tstate, titer) = _trainers(tmp_path, files)
    # The JAX trainer's resynthesis snapshot is a TensorBoard image, not part
    # of the score: skip its compile.
    jtr._resynth_step = lambda gen, vq, dec, audio: jnp.zeros(audio.shape)
    want = jtr.validate(jstate, jiter, step=0)
    got = ttr.validate(tstate, titer, step=0)
    jtr._metrics_f.close()
    ttr.close()
    jrec = [json.loads(l) for l in open(tmp_path / "jax" / "metrics.jsonl")][-1]
    trec = [json.loads(l) for l in open(tmp_path / "port" / "metrics.jsonl")][-1]
    assert set(trec) == set(jrec) and set(VAL_KEYS) <= set(trec)
    assert _rel(got, want) <= 1e-4, (got, want)
    for k in VAL_KEYS:
        assert _rel(trec[k], jrec[k]) <= 1e-4, (k, trec[k], jrec[k])
    assert 1.0 <= trec["val_pesq_score"] <= 4.644 and trec["val_utmos_score"] != 0.0


@pytest.mark.parametrize("flags", [dict(), dict(evaluate_pesq=False, evaluate_periodicity=False),
                                   dict(evaluate_utmos=False)])
def test_host_val_metrics_match_jax(tmp_path, files, utmos_ckpt, monkeypatch, flags):
    """The objective metrics of one batch, on the same numpy audio: equal;
    an evaluator that is off scores 0 in both."""
    monkeypatch.setenv("WT_UTMOS_CKPT", utmos_ckpt)
    (jtr, _, jiter), (ttr, _, _) = _trainers(tmp_path, files, **flags)
    audio = np.asarray(next(jiter), np.float32)
    deg = (audio + 0.02 * np.random.default_rng(5).normal(size=audio.shape)).astype(np.float32)
    want = jtr._host_val_metrics(audio, deg)
    got = ttr._host_val_metrics(audio, deg)
    jtr._metrics_f.close()
    ttr.close()
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-6, (k, got[k], want[k])
    for flag, keys in (("evaluate_pesq", ("pesq_score",)), ("evaluate_utmos", ("utmos_score",)),
                       ("evaluate_periodicity", ("periodicity_loss", "pitch_loss", "f1_score"))):
        if not flags.get(flag, True):
            assert all(got[k] == 0.0 for k in keys)
        else:
            assert any(got[k] != 0.0 for k in keys)


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


@pytest.mark.parametrize("yaml_flags", [
    {},
    {"evaluate_utmos": False, "evaluate_pesq": True, "evaluate_periodicty": False},
    {"evaluate_pesq": False, "evaluate_periodicity": False},
    {"evaluate_periodicty": True, "evaluate_periodicity": False},
])
def test_yaml_evaluate_keys_parse_as_jax(yaml_flags):
    """The three evaluate_* keys, the reference's misspelt
    ``evaluate_periodicty`` taking precedence over the spelled-out key, as
    the JAX parser reads them."""
    config = yaml.safe_load(CODEC_YAML)
    config["model"]["init_args"].update(yaml_flags)
    _, tcfg, _, _ = ttrainer.train_config_from_yaml(config)
    _, jcfg, _, _ = jtrainer.train_config_from_yaml(config)
    for k in ("evaluate_utmos", "evaluate_pesq", "evaluate_periodicity"):
        assert getattr(tcfg, k) == getattr(jcfg, k), k
    assert tcfg.evaluate_periodicity == yaml_flags.get(
        "evaluate_periodicty", yaml_flags.get("evaluate_periodicity", True))
