"""Module parity of the PyTorch port (wavtokenizer_tpu_torch) against the JAX
package on the CPU, at small widths, inputs drawn from numpy seeds.

Tolerances: fp32 paths agree to ~1e-5 (the two frameworks sum in other
orders); where the port's ConvNeXt rounds its matmul operands to bf16 (as
its kernel does) and the JAX default path does not, the bound is bf16's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavtokenizer_tpu.models import quantize as jq
from wavtokenizer_tpu.models import seanet as js
from wavtokenizer_tpu.models import vocos as jv
from wavtokenizer_tpu.models import wavtokenizer as jw
from wavtokenizer_tpu.models.init import init_backbone, init_seanet
from wavtokenizer_tpu.ops.conv import sconv1d as j_sconv1d
from wavtokenizer_tpu.ops.lstm import slstm as j_slstm
from wavtokenizer_tpu.ops.spectral import istft_same as j_istft_same
from wavtokenizer_tpu_torch.api.pretrained import backbone_from_jax, seanet_from_jax
from wavtokenizer_tpu_torch.models import quantize as tq
from wavtokenizer_tpu_torch.models import seanet as ts
from wavtokenizer_tpu_torch.models import vocos as tv
from wavtokenizer_tpu_torch.models import wavtokenizer as tw
from wavtokenizer_tpu_torch.ops.conv import sconv1d as t_sconv1d
from wavtokenizer_tpu_torch.ops.kernels import pack_vq_codebook
from wavtokenizer_tpu_torch.ops.lstm import lstm_from_layers, slstm as t_slstm
from wavtokenizer_tpu_torch.ops.spectral import istft_same as t_istft_same


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


@pytest.mark.parametrize("k,stride,dilation,causal,length", [
    (7, 1, 1, False, 100),
    (4, 2, 1, False, 101),
    (16, 8, 1, False, 240),
    (3, 1, 4, False, 57),
    (7, 1, 1, True, 64),
    (4, 2, 1, True, 63),
    (3, 1, 2, False, 2),   # tiny input: the reflect-pad guard
])
def test_sconv1d_matches_jax(k, stride, dilation, causal, length):
    rng = np.random.default_rng(k * 1000 + length)
    x = rng.normal(size=(2, length, 5)).astype(np.float32)
    kern = (rng.normal(size=(k, 5, 8)) * 0.3).astype(np.float32)
    bias = rng.normal(size=(8,)).astype(np.float32)
    want = j_sconv1d(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(bias),
                     stride=stride, dilation=dilation, causal=causal)
    got = t_sconv1d(torch.from_numpy(x), torch.from_numpy(kern.transpose(2, 1, 0).copy()),
                    torch.from_numpy(bias), stride=stride, dilation=dilation,
                    causal=causal)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


def test_slstm_matches_jax():
    rng = np.random.default_rng(1)
    C, layers = 16, []
    for _ in range(2):
        layers.append({n: (rng.normal(size=s) * 0.3).astype(np.float32)
                       for n, s in (("w_ih", (4 * C, C)), ("w_hh", (4 * C, C)),
                                    ("b_ih", (4 * C,)), ("b_hh", (4 * C,)))})
    x = rng.normal(size=(3, 20, C)).astype(np.float32)
    want = j_slstm(jnp.asarray(x), [{k: jnp.asarray(v) for k, v in p.items()}
                                    for p in layers])
    with torch.no_grad():
        got = t_slstm(torch.from_numpy(x), lstm_from_layers(layers, "cpu"))
    assert _rel(got, want) < 1e-5


def test_seanet_encode_matches_jax():
    cfg = js.SEANetConfig(n_filters=8, dimension=32)
    tcfg = ts.SEANetConfig(n_filters=8, dimension=32)
    params = init_seanet(np.random.default_rng(2), cfg, encoder=True)
    audio = (np.random.default_rng(3).normal(size=(2, 3200, 1)) * 0.1).astype(np.float32)
    want = js.seanet_encode(params, cfg, jnp.asarray(audio))
    with torch.no_grad():
        got = ts.seanet_encode(seanet_from_jax(params, ts.encoder_layer_specs(tcfg), "cpu"),
                               tcfg, torch.from_numpy(audio))
    assert got.shape == want.shape == (2, 10, 32)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("n_fft,hop", [(1280, 320), (2400, 600)])
def test_istft_same_matches_jax(n_fft, hop):
    rng = np.random.default_rng(n_fft)
    T, N = 12, n_fft // 2 + 1
    re = rng.normal(size=(2, T, N)).astype(np.float32)
    im = rng.normal(size=(2, T, N)).astype(np.float32)
    want = j_istft_same(jnp.asarray(re), jnp.asarray(im), n_fft, hop, method="fft")
    got = t_istft_same(torch.from_numpy(re), torch.from_numpy(im), n_fft, hop)
    assert got.shape == want.shape == (2, T * hop)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("adanorm", [True, False])
def test_vocos_backbone_matches_jax(adanorm):
    kw = dict(input_channels=16, dim=64, intermediate_dim=192, num_layers=2,
              adanorm_num_embeddings=4 if adanorm else None, groupnorm_groups=8)
    jcfg, tcfg = jv.VocosBackboneConfig(**kw), tv.VocosBackboneConfig(**kw)
    params = init_backbone(np.random.default_rng(4), jcfg)
    rng = np.random.default_rng(5)
    # Perturb the unit/zero norm affines and the layer scale so they matter.
    for block in params["convnext"]:
        block["gamma"] = (rng.normal(size=64) * 0.3).astype(np.float32)
        norm = block.get("adanorm") or block["norm"]
        for key in norm:
            norm[key] = norm[key] + (rng.normal(size=norm[key].shape) * 0.1).astype(np.float32)
    x = rng.normal(size=(2, 30, 16)).astype(np.float32)
    bw = 2 if adanorm else None
    want = jv.vocos_backbone(params, jcfg, jnp.asarray(x), bandwidth_id=bw)
    with torch.no_grad():
        got = tv.vocos_backbone(backbone_from_jax(params, "cpu"), tcfg, torch.from_numpy(x),
                                bandwidth_id=bw)
    assert got.shape == want.shape
    # bf16 matmul operands in the port's ConvNeXt (each product off by up to
    # 2^-9 relative), fp32 in JAX's default path; the errors average out
    # over the sums and enter the residual through gamma (measured ~4e-5).
    rel = _rel(got, want)
    print(f"vocos_backbone adanorm={adanorm}: rel-max {rel:.2g} against JAX")
    assert rel < 1e-3


def test_istft_head_matches_jax():
    rng = np.random.default_rng(6)
    params = {"out": {"weight": (rng.normal(size=(32, 1282)) * 0.05).astype(np.float32),
                      "bias": (rng.normal(size=1282) * 0.1).astype(np.float32)}}
    x = rng.normal(size=(2, 10, 32)).astype(np.float32)
    want = jv.istft_head(params, jv.ISTFTHeadConfig(dim=32), jnp.asarray(x))
    tparams = {"out": {k: torch.from_numpy(v) for k, v in params["out"].items()}}
    got = tv.istft_head(tparams, tv.ISTFTHeadConfig(dim=32), torch.from_numpy(x))
    assert got.shape == want.shape == (2, 3200)
    # JAX's default ISTFT is a DFT matmul, the port's an irfft; both fp32
    # on the CPU (measured ~1e-6).
    assert _rel(got, want) < 1e-5


def test_vq_infer_and_codes_to_features_match_jax():
    rng = np.random.default_rng(7)
    embed = rng.normal(size=(1, 64, 16)).astype(np.float32)
    x = rng.normal(size=(3, 11, 16)).astype(np.float32)
    q_want, c_want, _ = jq.vq_infer({"embed": jnp.asarray(embed)}, jq.VQConfig(), jnp.asarray(x))
    e = torch.from_numpy(embed)
    q_got, c_got = tq.vq_infer({"embed": e, "esq": (e * e).sum(-1),
                                "pack": pack_vq_codebook(e[0])[None]}, torch.from_numpy(x))
    np.testing.assert_array_equal(c_got.numpy(), np.asarray(c_want))
    np.testing.assert_array_equal(q_got.numpy(), np.asarray(q_want))
    f_want = jq.codes_to_features({"embed": jnp.asarray(embed)}, c_want)
    np.testing.assert_array_equal(tq.codes_to_features({"embed": e}, c_got).numpy(),
                                  np.asarray(f_want))


@pytest.mark.parametrize("pair", [
    (js.SEANetConfig, ts.SEANetConfig), (js.LayerSpec, ts.LayerSpec),
    (jq.VQConfig, tq.VQConfig), (jv.VocosBackboneConfig, tv.VocosBackboneConfig),
    (jv.ISTFTHeadConfig, tv.ISTFTHeadConfig), (jw.WavTokenizerSpec, tw.WavTokenizerSpec),
], ids=lambda p: p[0].__name__)
def test_spec_dataclasses_equal_jax(pair):
    jcls, tcls = pair
    jf = [(f.name, f.default) for f in dataclasses.fields(jcls)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcls)]
    # Nested spec defaults compare field by field.
    norm = lambda fs: [(n, dataclasses.asdict(d) if dataclasses.is_dataclass(d) else d)
                       for n, d in fs]
    assert norm(tf) == norm(jf)


def test_layer_specs_equal_jax():
    for ratios in ((8, 5, 4, 2), (6, 5, 5, 4)):
        jcfg, tcfg = js.SEANetConfig(ratios=ratios), ts.SEANetConfig(ratios=ratios)
        for jfn, tfn in ((js.encoder_layer_specs, ts.encoder_layer_specs),
                         (js.decoder_layer_specs, ts.decoder_layer_specs)):
            assert ([dataclasses.asdict(s) for s in tfn(tcfg)]
                    == [dataclasses.asdict(s) for s in jfn(jcfg)])
