"""The port's plain-Vocos family against the JAX package on the CPU: config
parsing (both YAML layouts and the committed vocos-mel-24khz config), the
numpy init, the mel features, MDCT/IMDCT and ISTFT with center trim, the
forward of four trunk/head pairs, the state-dict converter and the facade.

Tolerances: the spectral ops and the ResNet/IMDCT pairs are fp32 on both
sides in other summation orders, rel-max 1e-5.  Where a ConvNeXt trunk
runs, the port rounds its matmul operands to bf16 as its kernel does on the
card and JAX's default path does not: rel-max 1e-3, as
``tests/test_torch_slice.py`` holds the codec's decode.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from wavtokenizer_tpu.api.config import vocos_spec_from_config_dict as j_parse
from wavtokenizer_tpu.api.pretrained import Vocos as JVocos
from wavtokenizer_tpu.checkpoint import export as jexport
from wavtokenizer_tpu.checkpoint.convert import convert_vocos_state_dict as j_convert
from wavtokenizer_tpu.models import vocos_model as jvm
from wavtokenizer_tpu.models.alt_components import mel_features as j_mel_features
from wavtokenizer_tpu.models.init import init_vocos as j_init_vocos
from wavtokenizer_tpu.ops import spectral as jspec_ops
from wavtokenizer_tpu_torch import Vocos, init_vocos
from wavtokenizer_tpu_torch.api.config import vocos_spec_from_config, vocos_spec_from_config_dict
from wavtokenizer_tpu_torch.checkpoint.convert import TrackedStateDict, convert_vocos_state_dict
from wavtokenizer_tpu_torch.models.alt_components import mel_features
from wavtokenizer_tpu_torch.ops import spectral as tspec_ops

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "wavtokenizer_tpu_torch", "configs", "vocos_mel_24khz.yaml")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread avoids contention with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(backbone: str, head: str, dim: int = 64, layers: int = 1,
            padding: str = "center") -> dict:
    """A flat plain-Vocos config at test width: 24 kHz mel, n_fft 256, hop
    64, 32 mels; the head's hop matches the features'."""
    bb = ({"class_path": "decoder.models.VocosBackbone",
           "init_args": {"input_channels": 32, "dim": dim, "intermediate_dim": 3 * dim,
                         "num_layers": layers}} if backbone == "convnext" else
          {"class_path": "decoder.models.VocosResNetBackbone",
           "init_args": {"input_channels": 32, "dim": dim, "num_blocks": layers}})
    hd = ({"class_path": "decoder.heads.ISTFTHead",
           "init_args": {"dim": dim, "n_fft": 256, "hop_length": 64, "padding": "same"}}
          if head == "istft" else
          {"class_path": f"decoder.heads.{'IMDCTSymExpHead' if head == 'imdct_symexp' else 'IMDCTCosHead'}",
           "init_args": {"dim": dim, "mdct_frame_len": 128, "padding": "same"}})
    return {"feature_extractor": {
        "class_path": "decoder.feature_extractors.MelSpectrogramFeatures",
        "init_args": {"sample_rate": 24000, "n_fft": 256, "hop_length": 64, "n_mels": 32,
                      "padding": padding}},
        "backbone": bb, "head": hd}


def _same_spec(tspec, jspec) -> None:
    assert (tspec.backbone_kind, tspec.head_kind) == (jspec.backbone_kind, jspec.head_kind)
    for part in ("features", "backbone", "head"):
        assert dataclasses.asdict(getattr(tspec, part)) == \
            dataclasses.asdict(getattr(jspec, part)), part


def _rel_max(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _audio(seed: int, n: int = 4000, batch: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 24000
    return (0.3 * np.sin(2 * np.pi * 220 * t)[None] + 0.05 * rng.normal(size=(batch, n))
            ).astype(np.float32)


@pytest.mark.parametrize("layout", ["flat", "lightning"])
def test_config_layouts_parse_to_the_jax_spec(layout):
    for backbone, head in (("convnext", "istft"), ("resnet", "imdct_symexp"),
                           ("resnet", "imdct_cos")):
        cfg = _config(backbone, head, dim=128, layers=2)
        if layout == "lightning":
            cfg = {"model": {"class_path": "decoder.experiment.VocosExp", "init_args": cfg}}
        tspec, jspec = vocos_spec_from_config_dict(cfg), j_parse(cfg)
        _same_spec(tspec, jspec)
        assert tspec.sample_rate == 24000


def test_committed_vocos_mel_24khz_config():
    """The full-width config, read by both packages' parsers: the public
    vocos-mel-24khz numbers."""
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    tspec = vocos_spec_from_config(CONFIG)
    _same_spec(tspec, j_parse(cfg))
    assert (tspec.features.n_fft, tspec.features.hop_length, tspec.features.n_mels,
            tspec.features.padding) == (1024, 256, 100, "center")
    bb = tspec.backbone
    assert (bb.input_channels, bb.dim, bb.intermediate_dim, bb.num_layers,
            bb.adanorm_num_embeddings) == (100, 512, 1536, 8, None)
    assert (tspec.head_kind, tspec.head.dim, tspec.head.n_fft, tspec.head.hop_length) == \
        ("istft", 512, 1024, 256)


@pytest.mark.parametrize("backbone,head", [("convnext", "istft"), ("resnet", "imdct_cos"),
                                           ("resnet", "imdct_symexp")])
def test_init_vocos_draws_jax_numbers(backbone, head):
    cfg = _config(backbone, head, layers=2)
    got = init_vocos(vocos_spec_from_config_dict(cfg), seed=3)
    want = j_init_vocos(j_parse(cfg), seed=3)
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(gl, wl):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("padding", ["center", "same"])
def test_mel_features_match_jax(padding):
    tspec = vocos_spec_from_config_dict(_config("convnext", "istft", padding=padding))
    jspec = j_parse(_config("convnext", "istft", padding=padding))
    audio = _audio(1)
    got = mel_features(tspec.features, torch.from_numpy(audio)).numpy()
    want = np.asarray(jax.jit(lambda a: j_mel_features(jspec.features, a))(audio))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("padding", ["same", "center"])
def test_mdct_imdct_match_jax(padding):
    audio = _audio(2, n=3072)
    got = tspec_ops.mdct(torch.from_numpy(audio), 128, padding)
    want = jax.jit(lambda a: jspec_ops.mdct(a, 128, padding))(audio)
    assert got.shape == want.shape
    assert _rel_max(got.numpy(), want) <= 1e-5
    coeffs = np.array(want)
    back = tspec_ops.imdct(torch.from_numpy(coeffs), 128, padding).numpy()
    jback = jax.jit(lambda x: jspec_ops.imdct(x, 128, padding))(coeffs)
    assert back.shape == jback.shape
    assert _rel_max(back, jback) <= 1e-5


@pytest.mark.parametrize("win_length", [None, 48])
def test_istft_center_matches_jax(win_length):
    rng = np.random.default_rng(3)
    re, im = (rng.normal(size=(2, 30, 33)).astype(np.float32) for _ in range(2))
    got = tspec_ops.istft_center(torch.from_numpy(re), torch.from_numpy(im), 64, 16,
                                 win_length).numpy()
    want = np.asarray(jspec_ops.istft_center(jnp.asarray(re), jnp.asarray(im), 64, 16,
                                             win_length, method="fft"))
    assert got.shape == want.shape == (2, 29 * 16)
    assert _rel_max(got, want) <= 1e-5


@pytest.mark.parametrize("backbone,head,dim,layers,tol", [
    ("convnext", "istft", 128, 2, 1e-3),
    ("resnet", "imdct_cos", 64, 1, 1e-5),
    ("resnet", "imdct_symexp", 64, 2, 1e-5),
    ("convnext", "imdct_symexp", 64, 1, 1e-3),
])
def test_vocos_forward_matches_jax(backbone, head, dim, layers, tol, one_thread):
    cfg = _config(backbone, head, dim=dim, layers=layers)
    tspec, jspec = vocos_spec_from_config_dict(cfg), j_parse(cfg)
    params = j_init_vocos(jspec, seed=4)
    audio = _audio(5)
    want = np.asarray(jax.jit(lambda p, a: jvm.vocos_forward(p, jspec, a))(params, audio))
    model = Vocos.from_jax_params(params, tspec, device="cpu")
    got = model(audio).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_max(got, want) <= tol


def _state_dict(jspec, params: dict) -> dict:
    """A reference-layout state dict of a plain-Vocos model, written with the
    JAX package's exporters (weight-normed ResNet convs as weight_g/weight_v)."""
    sd: dict = {}
    if jspec.backbone_kind == "convnext":
        jexport.vocos_backbone_export(sd, "backbone.", params["backbone"], jspec.backbone)
    else:
        p = params["backbone"]
        jexport.conv1d_export(sd, "backbone.embed", p["embed"], True, "weight_g")
        for i, b in enumerate(p["resnet"]):
            for j in range(3):
                for name in ("convs1", "convs2"):
                    jexport.conv1d_export(sd, f"backbone.resnet.{i}.{name}.{j}", b[name][j],
                                          True, "weight_g")
                sd[f"backbone.resnet.{i}.gamma.{j}"] = b["gamma"][j][:, None]
    jexport.linear_export(sd, "head.out", params["head"]["out"])
    return sd


@pytest.mark.parametrize("backbone,head", [("convnext", "istft"), ("resnet", "imdct_cos")])
def test_convert_vocos_state_dict_matches_jax(backbone, head):
    cfg = _config(backbone, head, layers=2)
    tspec, jspec = vocos_spec_from_config_dict(cfg), j_parse(cfg)
    sd = _state_dict(jspec, j_init_vocos(jspec, seed=6))
    tracked = TrackedStateDict(sd)
    got, want = convert_vocos_state_dict(tracked, tspec), j_convert(sd, jspec)
    assert not tracked.unused()
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7 * max(np.abs(b).max(), 1.0))


def test_vocos_facade_from_state_dict_and_jax_params(tmp_path, one_thread):
    """from_state_dict, from_pretrained (YAML + torch checkpoint) and
    from_jax_params build the same model; feature_extractor then decode is
    __call__, and decode ignores bandwidth_id, as the JAX facade does."""
    cfg = _config("convnext", "istft", dim=64, layers=1)
    tspec, jspec = vocos_spec_from_config_dict(cfg), j_parse(cfg)
    params = j_init_vocos(jspec, seed=7)
    sd = _state_dict(jspec, params)
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(cfg))
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()}}, tmp_path / "model.ckpt")
    audio = _audio(8)[0]
    a = Vocos.from_state_dict(sd, tspec, device="cpu")
    b = Vocos.from_pretrained(str(tmp_path / "config.yaml"), str(tmp_path / "model.ckpt"),
                              device="cpu")
    c = Vocos.from_jax_params(params, tspec, device="cpu")
    feats = a.feature_extractor(audio)
    assert feats.shape == (1, 32, 1 + 4000 // 64)
    out = a.decode(feats)
    torch.testing.assert_close(a(audio), out, rtol=0, atol=0)
    torch.testing.assert_close(a.forward(audio, bandwidth_id=3), out, rtol=0, atol=0)
    torch.testing.assert_close(a.decode(feats, bandwidth_id=2), out, rtol=0, atol=0)
    for m in (b, c):
        np.testing.assert_allclose(m(audio).numpy(), out.numpy(), rtol=0,
                                   atol=1e-6 * float(out.abs().max()))
    want = np.asarray(JVocos(params, jspec)(audio))
    assert _rel_max(out.numpy(), want) <= 1e-3
    assert Vocos.from_hparams(str(tmp_path / "config.yaml"), device="cpu").spec == tspec
