"""The port's trainer, checkpoints, export and training CLI on the CPU,
against the JAX package where both have the function: the data loader's
batches (equal), a Lightning export of a port training state read by JAX's
``from_pretrained0828`` (decoded waveforms within rel 1e-3: the port's CPU
ConvNeXt rounds its matmul operands to bf16, as its kernel does on the card,
JAX's does not), crash resume (bit-equal to the uninterrupted run: the same
CPU arithmetic in the same order), the surgical resume (the exported
weights come back within fp32 rounding of the norm split), and the CLI.

No JAX train step is compiled here (``test_torch_train_step.py`` does that,
once).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from wavtokenizer_tpu.api.pretrained import WavTokenizer as JWavTokenizer
from wavtokenizer_tpu.train import data as jdata
from wavtokenizer_tpu_torch import (ISTFTHeadConfig, SEANetConfig, VQConfig,
                                    VocosBackboneConfig, WavTokenizer, WavTokenizerSpec)
from wavtokenizer_tpu_torch.api.config import spec_from_config
from wavtokenizer_tpu_torch.checkpoint.export import (export_training_state_dict,
                                                      save_torch_checkpoint)
from wavtokenizer_tpu_torch.tools import train as train_cli
from wavtokenizer_tpu_torch.train import data as tdata
from wavtokenizer_tpu_torch.train.step import (TrainConfig, create_train_state,
                                               state_to_inference_params, tree_leaves)
from wavtokenizer_tpu_torch.train import trainer as trainer_mod
from wavtokenizer_tpu_torch.train.trainer import Trainer, surgical_train_state

TINY = WavTokenizerSpec(
    seanet=SEANetConfig(dimension=16, n_filters=2, ratios=(8, 5, 4, 2)),
    vq=VQConfig(dimension=16, bins=32, kmeans_iters=2),
    backbone=VocosBackboneConfig(input_channels=16, dim=32, intermediate_dim=64, num_layers=1,
                                 adanorm_num_embeddings=4),
    head=ISTFTHeadConfig(dim=32, n_fft=1280, hop_length=320))
TCFG = TrainConfig(max_steps=100, disc_channels_scale=0.0625)

# The narrowest codec a config file can describe (the YAML fixes the SEANet
# widths: 32 filters, dimension 512); hop 32.
CODEC_YAML = """\
seed_everything: 3407
model:
  class_path: decoder.experiment.WavTokenizer
  init_args:
    sample_rate: 24000
    initial_learning_rate: 2e-4
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
trainer:
  max_steps: 1000
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread avoids contention with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Six 24 kHz clips and a 16 kHz one shorter than a crop (resampled,
    then repeat-padded), and their file list."""
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (sr, n) in enumerate([(24000, 4800)] * 6 + [(16000, 1500)]):
        t = np.arange(n) / sr
        y = 0.3 * np.sin(2 * np.pi * (200 + 37 * i) * t) + 0.02 * rng.normal(size=n)
        paths.append(str(d / f"clip{i}.wav"))
        wavfile.write(paths[-1], sr, (y * 32767).astype(np.int16))
    filelist = d / "files.txt"
    filelist.write_text("\n".join(paths) + "\n")
    return str(filelist)


def _data(filelist, batch=4):
    return tdata.DataConfig(filelist_path=filelist, num_samples=3840, batch_size=batch)


def test_data_loader_yields_jax_batches(files):
    kw = dict(filelist_path=files, num_samples=3840, batch_size=3)
    for train, shuffle, drop_last, skip in ((True, True, False, 1), (False, False, True, 0)):
        want = jdata.data_loader(jdata.WavDataset(jdata.DataConfig(**kw), train, seed=11), 3,
                                 shuffle, seed=11, drop_last=drop_last, skip_batches=skip)
        got = tdata.data_loader(tdata.WavDataset(tdata.DataConfig(**kw), train), 3,
                                shuffle, seed=11, drop_last=drop_last, skip_batches=skip)
        for _ in range(4):
            np.testing.assert_array_equal(next(got), next(want))


def _trainer(tmp_path, files, name, **kw):
    return Trainer(TINY, TCFG, _data(files), _data(files), out_dir=str(tmp_path / name),
                   log_every=1, val_every=2, limit_val_batches=1, log_media_every=10 ** 9,
                   seed=11, device="cpu", **kw)


def test_fit_logs_checkpoints_and_resumes_exactly(tmp_path, files, one_thread):
    """fit writes a JSONL row per logged step, the validation and top-k
    checkpoints and last.pt; a run stopped after 3 steps and resumed to 4
    ends bit-equal to a straight 4-step run (params, VQ state, both
    optimizers' moments, schedules)."""
    tr = _trainer(tmp_path, files, "a")
    tr.fit(max_batches=3)
    tr.close()
    rows = [json.loads(l) for l in open(tmp_path / "a" / "metrics.jsonl")]
    assert [r["step"] for r in rows if "gen_total" in r] == [0, 1, 2]
    assert all(np.isfinite(r["gen_total"]) and np.isfinite(r["disc_total"]) for r in rows
               if "gen_total" in r)
    val = [r for r in rows if "val_loss" in r]
    assert len(val) == 1 and val[0]["step"] == 2 and np.isfinite(val[0]["val_loss"])
    names = os.listdir(tmp_path / "a")
    assert "last.pt" in names
    assert any(n.startswith("wavtokenizer_checkpoint_step=2_val_loss=") for n in names)

    tr = _trainer(tmp_path, files, "b")
    resumed = tr.fit(max_batches=4, resume_path=str(tmp_path / "a" / "last.pt"))
    tr.close()
    tr = _trainer(tmp_path, files, "c")
    straight = tr.fit(max_batches=4)
    tr.close()
    assert resumed["step"] == straight["step"] == 4
    for k in ("gen", "disc", "vq", "decoder"):
        for a, b in zip(tree_leaves(resumed[k]), tree_leaves(straight[k]), strict=True):
            assert torch.equal(a, b), k
    for k in ("opt_gen", "opt_disc"):
        sa, sb = resumed[k].state_dict(), straight[k].state_dict()
        for i in sb["state"]:
            for name in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(sa["state"][i][name], sb["state"][i][name]), (k, i, name)
        assert resumed[f"sched_{k[4:]}"].last_epoch == straight[f"sched_{k[4:]}"].last_epoch


def test_surgical_train_state_from_lightning_checkpoint(tmp_path, files, one_thread):
    tr = _trainer(tmp_path, files, "s")
    src = tr.fit(max_batches=1)
    tr.close()
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_training_state_dict(src, TINY).items()}
    state = surgical_train_state(TINY, TCFG, sd, seed=5, device="cpu")
    want, got = state_to_inference_params(src, TINY), state_to_inference_params(state, TINY)
    for key in ("encoder", "decoder", "quantizer", "backbone", "head"):
        for g, w in zip(jax.tree.leaves(got[key]), jax.tree.leaves(want[key]), strict=True):
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-6 * max(np.abs(w).max(), 1e-6),
                                       err_msg=key)
    for a, b in zip(tree_leaves(state["disc"]), tree_leaves(src["disc"]), strict=True):
        assert torch.equal(a, b)
    assert state["step"] == 0 and not state["opt_gen"].state


def test_export_loads_in_jax_from_pretrained0828(tmp_path):
    """A port training state exported to the Lightning layout is read by the
    JAX package's from_pretrained0828: the same discriminators, and the same
    waveform from the same features as the port's own 0828 loader."""
    cfg = tmp_path / "codec.yaml"
    cfg.write_text(CODEC_YAML)
    spec = spec_from_config(str(cfg))
    state = create_train_state(spec, TrainConfig(disc_channels_scale=0.0625), seed=2,
                               device="cpu")
    ckpt = tmp_path / "model.ckpt"
    save_torch_checkpoint(str(ckpt), export_training_state_dict(state, spec))
    jm = JWavTokenizer.from_pretrained0828(str(cfg), str(ckpt))
    tm = WavTokenizer.from_pretrained0828(str(cfg), str(ckpt), device="cpu")
    # jax.tree.leaves orders every tree (numpy, tensors) by sorted dict keys.
    jl, tl = jax.tree.leaves(jm.discriminators), jax.tree.leaves(tm.discriminators)
    sl = jax.tree.leaves(state["disc"])
    assert len(jl) == len(tl) == len(sl)
    for a, b, c in zip(jl, tl, sl):
        a = np.asarray(a)
        if a.ndim == 4:                      # (Kh, Kw, I, O) -> (O, I, Kh, Kw)
            a = a.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c.detach().numpy())
    feats = (np.random.default_rng(3).normal(size=(2, 512, 20)) * 0.05).astype(np.float32)
    want = np.asarray(jm.decode(jnp.asarray(feats), bandwidth_id=1))
    got = tm.decode(feats, bandwidth_id=1).numpy()
    assert got.shape == want.shape == (2, 20 * 32)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_train_cli_fits_on_cpu_and_reloads(tmp_path, files, one_thread, monkeypatch):
    """``tools.train fit --device cpu`` on a config file: metrics and
    last.pt, which ``from_train_checkpoint`` loads for inference.  The
    parsed config's discriminators are cut to 1/16 width, as in the other CPU
    training tests (a config file always gives the reference's widths)."""
    parse = trainer_mod.train_config_from_yaml

    def narrow_discriminators(config):
        spec, tcfg, train_data, val_data = parse(config)
        return spec, dataclasses.replace(tcfg, disc_channels_scale=0.0625), train_data, val_data

    monkeypatch.setattr(trainer_mod, "train_config_from_yaml", narrow_discriminators)
    cfg = tmp_path / "train.yaml"
    cfg.write_text(CODEC_YAML + f"""\
data:
  class_path: decoder.dataset.VocosDataModule
  init_args:
    train_params: {{filelist_path: {files}, sampling_rate: 24000, num_samples: 3840,
                   batch_size: 2, num_workers: 0}}
""")
    out = tmp_path / "run"
    assert train_cli.main(["fit", "--config", str(cfg), "--out-dir", str(out),
                           "--max-batches", "2", "--seed", "5", "--device", "cpu"]) == 0
    # The step rows (the loader's event comes first: native or Python).
    rows = [r for r in map(json.loads, open(out / "metrics.jsonl")) if "step" in r]
    assert rows[0]["step"] == 0 and np.isfinite(rows[0]["gen_total"])
    model = WavTokenizer.from_train_checkpoint(str(cfg), str(out / "last.pt"), device="cpu")
    ckpt = torch.load(out / "last.pt", weights_only=True)
    assert ckpt["step"] == 2 and float(ckpt["vq"]["inited"][0, 0]) == 1.0
    audio = (np.random.default_rng(4).normal(size=(1, 3840)) * 0.1).astype(np.float32)
    feats, codes = model.encode_infer(audio)
    wave = model.decode(feats, 0)
    assert codes.shape == (1, 1, 120) and wave.shape == (1, 3840)
    assert bool(torch.isfinite(wave).all())
    np.testing.assert_array_equal(
        model.params["quantizer"]["embed"].numpy(), ckpt["vq"]["embed"].numpy())


@pytest.mark.parametrize("dtype,ok", [("float32", True), ("bfloat16", True),
                                      ("bfloat61", False)])
def test_yaml_disc_compute_dtype_is_float32_or_refused(dtype, ok):
    """A YAML's disc_compute_dtype reaches TrainConfig (float32, or bf16
    discriminators); a name that is no floating type is refused, as JAX's
    ``jnp.dtype`` refuses it, not trained in fp32 without a word."""
    import yaml

    config = yaml.safe_load(CODEC_YAML)
    config["model"]["init_args"]["disc_compute_dtype"] = dtype
    if ok:
        spec, tcfg, _, _ = trainer_mod.train_config_from_yaml(config)
        assert tcfg.max_steps == 1000 and spec.vq.bins == 64
        assert tcfg.disc_compute_dtype == dtype
    else:
        with pytest.raises(ValueError, match="disc_compute_dtype"):
            trainer_mod.train_config_from_yaml(config)
