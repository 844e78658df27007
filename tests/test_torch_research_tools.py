"""The research CLIs of the port on the CPU (``--device cpu``), each against
the port's own functions and, where the JAX package has the same function,
against it on the same weights.

One narrow Lightning checkpoint (the narrowest codec a YAML describes: 32
filters, dimension 512, hop 32; written by the JAX package's exporter) feeds
every tool through ``--config``/``--checkpoint``.  The tools' outputs:

* ``lowpass``: the WAVs equal to ``lowpass_batch`` on the same batch, and
  within 2 PCM16 steps of JAX's ``lowpass_batch``.
* ``enhance_train`` (``waveform``, 2 steps, then ``--resume`` for a third):
  its checkpoints equal to ``enhance_step`` driven directly (the same CPU
  arithmetic); ``metrics.jsonl``, ``best_model``/``step_N``/``last``.
* ``enhance_infer``: the WAVs against JAX's ``enhanced_forward`` + chunk and
  cross-fade on the same weights: within 1e-3 of full scale (waveform rel-max
  1e-4 before the PCM16 rounding).
* ``byol_train`` (``--features-dir`` and ``--xvector-scp``, ``--tsne-out``):
  its model equal to ``byol_step`` driven directly.
* ``speaker_cluster`` (``cluster``/``score``) and ``analyze_features``
  (``roundtrip``/``compare``): the pooled features against JAX's encoder,
  ``encode_infer`` and ``enhanced_forward`` on the same clips (1e-5
  absolute; the enhanced features 1e-4 of their largest value), the labels,
  centroids and scores against ``research/analysis.py`` on those features.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from wavtokenizer_tpu.api.config import spec_from_config as j_spec_from_config
from wavtokenizer_tpu.api.pretrained import WavTokenizer as JWavTokenizer
from wavtokenizer_tpu.api.streaming import chunk_audio as j_chunk_audio
from wavtokenizer_tpu.api.streaming import crossfade_join as j_crossfade_join
from wavtokenizer_tpu.checkpoint.export import wavtokenizer_state_dict
from wavtokenizer_tpu.models import wavtokenizer as jw
from wavtokenizer_tpu.models.init import init_wavtokenizer as j_init
from wavtokenizer_tpu.models.seanet import seanet_encode as j_seanet_encode
from wavtokenizer_tpu.research import adapter as ja
from wavtokenizer_tpu_torch.api.pretrained import seanet_from_jax
from wavtokenizer_tpu_torch.checkpoint.convert import adapter_from_jax, byol_from_jax
from wavtokenizer_tpu_torch.models.seanet import decoder_layer_specs
from wavtokenizer_tpu_torch.research import analysis, byol, enhance
from wavtokenizer_tpu_torch.research.adapter import base_params_from_jax, init_adapter
from wavtokenizer_tpu_torch.research.byol_data import write_kaldi_ark_scp
from wavtokenizer_tpu_torch.tools import (analyze_features, byol_train, enhance_infer,
                                          enhance_train, lowpass, speaker_cluster)
from wavtokenizer_tpu_torch.train.step import tree_leaves
from wavtokenizer_tpu_torch.train.trainer import load_tree, save_tree
from wavtokenizer_tpu_torch.utils.audio import read_audio

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
SR = 24000


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wav(path, y, sr=SR):
    wavfile.write(path, sr, (np.clip(y, -1, 1) * 32767).astype(np.int16))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The YAML, a Lightning checkpoint of seeded JAX weights, the JAX
    params as JAX's loader reads them, and folders of WAVs (four 0.5 s clips
    named by material; two noisy/clean pairs)."""
    d = tmp_path_factory.mktemp("research_tools")
    cfg = d / "codec.yaml"
    cfg.write_text(CODEC_YAML)
    jspec = j_spec_from_config(str(cfg))
    params = j_init(jspec, seed=0, random_codebook=True)
    sd = wavtokenizer_state_dict(params, jspec.seanet, jspec.backbone,
                                 head_n_fft=jspec.head.n_fft)
    ckpt = d / "model.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()}}, ckpt)
    jparams = jax.device_get(JWavTokenizer.from_pretrained0802(str(cfg), str(ckpt)).params)
    rng = np.random.default_rng(1)
    wavs = d / "wavs"
    wavs.mkdir()
    for i, name in enumerate(["s1_box_a.wav", "s2_box_b.wav", "s1_cup_a.wav", "s2_cup_b.wav"]):
        t = np.arange(SR // 2) / SR
        _wav(str(wavs / name), 0.3 * np.sin(2 * np.pi * (150 + 60 * i) * t)
             + 0.05 * rng.normal(size=t.size))
    pairs = []
    for i in range(2):
        n = int(0.4 * SR)
        clean = 0.3 * np.sin(2 * np.pi * (200 + 50 * i) * np.arange(n) / SR)
        paths = [str(d / f"noisy{i}.wav"), str(d / f"clean{i}.wav")]
        _wav(paths[0], clean + 0.1 * rng.normal(size=n))
        _wav(paths[1], clean)
        pairs.append("|".join(paths))
    (d / "pairs.txt").write_text("\n".join(pairs) + "\n")
    return {"dir": d, "cfg": str(cfg), "ckpt": str(ckpt), "jspec": jspec, "jparams": jparams,
            "wavs": str(wavs), "pairs": str(d / "pairs.txt"),
            "model": ["--config", str(cfg), "--checkpoint", str(ckpt), "--device", "cpu"]}


def _clips(folder, seconds):
    names, clips = analyze_features.load_clips(folder, SR, seconds)
    assert names == sorted(names) and len(names) == 4
    return names, clips


def test_lowpass_cli(env, tmp_path, one_thread):
    out = tmp_path / "out"
    assert lowpass.main(["--input-dir", env["wavs"], "--output-dir", str(out),
                         "--cutoff", "2000", "--batch-size", "3", "--device", "cpu"]) == 0
    names = sorted(os.listdir(env["wavs"]))
    assert sorted(os.listdir(out)) == names
    # The CLI's first batch: three clips, padded to 4 hops' multiple.
    batch = np.zeros((3, 2048 * 6), np.float32)
    for i, n in enumerate(names[:3]):
        y = read_audio(os.path.join(env["wavs"], n))[0]
        batch[i, :len(y)] = y
    mine = lowpass.lowpass_batch(torch.from_numpy(batch), SR, 2000.0).numpy()
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_jlow", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "tools_tpu", "lowpass.py"))
    jlow = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jlow)
    theirs = np.asarray(jlow.lowpass_batch(jnp.asarray(batch), SR, 2000.0))
    for i, n in enumerate(names[:3]):
        got = read_audio(os.path.join(out, n))[0]
        want = (np.clip(mine[i, :len(got)], -1, 1) * 32767).astype(np.int16) / 32768.0
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, theirs[i, :len(got)], rtol=0, atol=2 / 32768)


def test_enhance_train_cli_and_resume(env, tmp_path, one_thread):
    run = tmp_path / "run"
    args = ["--pairs-file", env["pairs"], "--mode", "waveform", "--batch-size", "2",
            "--num-samples", "6400", "--save-every", "2", "--out-dir", str(run), *env["model"]]
    assert enhance_train.main(args + ["--steps", "2"]) == 0
    assert {"metrics.jsonl", "best_model.pt", "step_2.pt", "last.pt"} <= set(os.listdir(run))
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert rows[0]["step"] == 0 and np.isfinite(rows[0]["loss"])
    last = load_tree(str(run / "last.pt"), device="cpu")
    assert last["step"] == 2

    # The same two steps driven directly.
    spec, params_np = enhance_train.load_base_model(env["cfg"], env["ckpt"])
    base = base_params_from_jax(params_np, spec.seanet, "cpu")
    ap, st = adapter_from_jax(*init_adapter(seed=0), device="cpu")
    dec = base["decoder"]
    ecfg = enhance.EnhanceConfig(mode="waveform")
    opt = enhance.make_enhance_optimizer(ap, dec, ecfg)
    it = enhance.PairedAudioDataset(env["pairs"], num_samples=6400).batches(2, seed=0)
    for _ in range(2):
        noisy, clean = (torch.from_numpy(a) for a in next(it))
        st, _, _ = enhance.enhance_step(opt, ap, st, dec, base, noisy, clean, spec, ecfg)
    for got, want in zip(tree_leaves({"a": last["adapter"], "s": last["adapter_state"],
                                      "d": last["decoder"]}),
                         tree_leaves({"a": ap, "s": st, "d": dec}), strict=True):
        torch.testing.assert_close(got, want.detach(), rtol=0, atol=0)

    # Resume for one more step: Adam restarts, as in the JAX tool.
    assert enhance_train.main(args + ["--steps", "3", "--resume", str(run / "last.pt")]) == 0
    again = load_tree(str(run / "last.pt"), device="cpu")
    assert again["step"] == 3
    assert not torch.equal(again["adapter"]["out_conv"]["weight"],
                           last["adapter"]["out_conv"]["weight"])


def test_enhance_infer_cli_matches_jax(env, tmp_path, one_thread):
    """An adapter checkpoint of seeded weights (the decoder the base
    model's); 1 s files, longer than a 0.5 s chunk."""
    jspec, jparams = env["jspec"], env["jparams"]
    aparams, astate = ja.init_adapter(seed=5)
    ap, st = adapter_from_jax(aparams, astate, device="cpu")
    ckpt = str(tmp_path / "adapter.pt")
    save_tree(ckpt, {"adapter": ap, "adapter_state": st, "step": 0,
                     "decoder": seanet_from_jax(jparams["decoder"],
                                                decoder_layer_specs(jspec.seanet), "cpu",
                                                train=True)})
    noisy = tmp_path / "noisy"
    noisy.mkdir()
    rng = np.random.default_rng(6)
    for i in range(2):
        _wav(str(noisy / f"n{i}.wav"), 0.2 * rng.normal(size=SR))
    out = tmp_path / "out"
    assert enhance_infer.main(["--input-dir", str(noisy), "--output-dir", str(out),
                               "--adapter-ckpt", ckpt, "--chunk-seconds", "0.5",
                               *env["model"]]) == 0
    fwd = jax.jit(lambda c: ja.enhanced_forward(jparams, jspec.seanet, aparams, astate, c,
                                                train=False, feature_scale=1.5)[0])
    for i in range(2):
        y = read_audio(str(noisy / f"n{i}.wav"))[0]
        chunks, stride, n = j_chunk_audio(jnp.asarray(y), SR // 2, 0.25)
        want = np.asarray(j_crossfade_join(fwd(chunks)[:, :SR // 2], stride, n))
        want = want / max(1.0, np.abs(want).max())
        got = read_audio(str(out / f"n{i}.wav"))[0]
        assert got.shape == want.shape == (SR,)
        assert np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_byol_train_cli(env, tmp_path, one_thread):
    feats = tmp_path / "feats"
    feats.mkdir()
    rng = np.random.default_rng(7)
    for i in range(3):
        np.save(feats / f"f{i}.npy", rng.normal(size=(24, 20 + 5 * i)).astype(np.float32))
    run = tmp_path / "byol"
    tsne = tmp_path / "tsne.npy"
    assert byol_train.main(["--features-dir", str(feats), "--steps", "3", "--batch-size", "4",
                            "--crop-frames", "8", "--out-dir", str(run), "--tsne-out", str(tsne),
                            "--device", "cpu"]) == 0
    got = load_tree(str(run / "byol_model.pt"), device="cpu")
    assert np.load(tsne).shape == (3, 2)

    cfg = byol.BYOLConfig(input_dim=24)
    params = byol_from_jax(byol.init_byol(cfg, seed=0), device="cpu")
    online = tree_leaves(params["online"])
    for t in online:
        t.requires_grad_(True)
    opt = torch.optim.Adam(online, lr=3e-4, betas=(0.9, 0.999), eps=1e-8)
    files = byol_train.load_feature_files(str(feats))
    draw = np.random.default_rng(0)
    for _ in range(3):
        v1, v2 = byol_train.two_views(draw, files, 4, 8)
        byol_train.byol_step(params, opt, torch.from_numpy(v1), torch.from_numpy(v2), cfg, 0.996)
    for a, b in zip(tree_leaves(got), tree_leaves(params), strict=True):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)

    # x-vector pairs.
    data = {f"spk{s}_{m}_LDV_00{u}": rng.normal(size=24).astype(np.float32)
            for s in (1, 2) for m in ("box", "papercup") for u in (1, 2)}
    write_kaldi_ark_scp(str(tmp_path / "xv.ark"), str(tmp_path / "xv.scp"), data)
    assert byol_train.main(["--xvector-scp", str(tmp_path / "xv.scp"), "--steps", "2",
                            "--batch-size", "4", "--out-dir", str(tmp_path / "xv"),
                            "--device", "cpu"]) == 0
    assert os.path.exists(tmp_path / "xv" / "byol_model.pt")


def test_speaker_cluster_cli_matches_jax(env, tmp_path, one_thread):
    run = tmp_path / "spk"
    base = ["--input-dir", env["wavs"], "--seconds", "0.25", *env["model"]]
    assert speaker_cluster.main(["cluster", *base, "--n-clusters", "2",
                                 "--out-dir", str(run)]) == 0
    scores = tmp_path / "scores.json"
    assert speaker_cluster.main(["score", *base, "--centroids", str(run / "centroids.npy"),
                                 "--out", str(scores)]) == 0
    names, clips = _clips(env["wavs"], 0.25)
    emb = jax.jit(lambda p, a: j_seanet_encode(p, env["jspec"].seanet, a[:, :, None]))(
        env["jparams"]["encoder"], jnp.asarray(clips))
    pooled = np.asarray(emb).mean(axis=1)
    got_names, got = speaker_cluster.embeddings_from_args(
        type("A", (), {"features_dir": None, "input_dir": env["wavs"], "seconds": 0.25,
                       "config": env["cfg"], "checkpoint": env["ckpt"], "device": "cpu"}))
    assert got_names == names
    np.testing.assert_allclose(got, pooled, rtol=0, atol=1e-5)
    labels, centroids = analysis.kmeans_clusters(got, 2, seed=0)
    np.testing.assert_array_equal(np.load(run / "centroids.npy"), centroids)
    assert json.loads((run / "labels.json").read_text()) == \
        {n: int(lab) for n, lab in zip(names, labels)}
    report = json.loads(scores.read_text())
    for n, e in zip(names, got):
        sims = analysis.speaker_similarity(e, centroids)
        assert report[n]["best_cluster"] == int(np.argmax(sims))


def test_analyze_features_cli_matches_jax(env, tmp_path, one_thread):
    jspec, jparams = env["jspec"], env["jparams"]
    out = tmp_path / "rt"
    assert analyze_features.main(["roundtrip", "--input-dir", env["wavs"], "--out-dir", str(out),
                                  "--seconds", "0.25", "--perplexity", "2", *env["model"]]) == 0
    names, clips = _clips(env["wavs"], 0.25)
    feats, _ = jax.jit(lambda p, a: jw.encode_infer(p, jspec, a))(jparams, jnp.asarray(clips))
    np.testing.assert_allclose(np.load(out / "pooled_features.npy"),
                               np.asarray(feats).mean(axis=2), rtol=0, atol=1e-5)
    assert os.path.exists(out / "tsne.png")
    assert sorted(n for n in os.listdir(out) if n.endswith(".wav")) == names

    # compare: clean (encoder) and enhanced features of an adapter checkpoint.
    aparams, astate = ja.init_adapter(seed=8)
    ap, st = adapter_from_jax(aparams, astate, device="cpu")
    ckpt = str(tmp_path / "adapter.pt")
    save_tree(ckpt, {"adapter": ap, "adapter_state": st, "step": 0,
                     "decoder": seanet_from_jax(jparams["decoder"],
                                                decoder_layer_specs(jspec.seanet), "cpu",
                                                train=True)})
    cmp_dir = tmp_path / "cmp"
    assert analyze_features.main(["compare", "--input-dir", env["wavs"], "--out-dir",
                                  str(cmp_dir), "--adapter-ckpt", ckpt, "--seconds", "0.25",
                                  "--perplexity", "2", *env["model"]]) == 0
    _, enh, clean, _ = jax.jit(lambda p, a: ja.enhanced_forward(
        p, jspec.seanet, aparams, astate, a))(jparams, jnp.asarray(clips))
    got = np.load(cmp_dir / "combined_features.npy")
    np.testing.assert_allclose(got[:4], np.asarray(clean).mean(axis=1), rtol=0, atol=1e-5)
    want = np.asarray(enh).mean(axis=1)
    assert np.abs(got[4:] - want).max() <= 1e-4 * np.abs(want).max()
    assert os.path.exists(cmp_dir / "combined_tsne.png")
