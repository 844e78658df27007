"""The training options of ``TrainConfig``: bf16 discriminators and decode
side, rematerialization, and the MS-STFT discriminator, against the JAX
package on the CPU.

* bf16: each family's loss with ``compute_dtype=bfloat16`` against JAX's
  ``*_fused`` with the same type, at ``tests/test_mixed_precision.py``'s
  shapes (B=2, T=8192, discriminators at 1/8 width), within 2e-2 relative
  (the two packages' CPU bf16 convs round their sums in other places);
  against fp32 at that file's tolerances; gradients at cosine > 0.9 with
  fp32's; losses and gradients fp32.  ``generator_forward`` with
  ``gen_compute_dtype`` against JAX's.
* remat: the same step with and without it, in float64 with the pos-net's
  dropout on, every gradient within 1e-10 (a recompute that drew a fresh
  dropout mask would move them by O(1)); the VQ searches run once and the
  EMA state is unchanged; all three ``remat_disc`` modes.
* MS-STFT: ``msstft_discriminator`` and ``weight_norm_conv2d`` against JAX's
  from the same numpy init, within 1e-5.

No JAX ``train_step`` is compiled here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavtokenizer_tpu import (ISTFTHeadConfig as JHead, SEANetConfig as JSEANet,
                              VQConfig as JVQ, VocosBackboneConfig as JBackbone,
                              WavTokenizerSpec as JSpec)
from wavtokenizer_tpu.train import discriminators as jd
from wavtokenizer_tpu.train import losses as jl
from wavtokenizer_tpu.train import step as js
from wavtokenizer_tpu.train import wnorm as jw
from wavtokenizer_tpu_torch import (ISTFTHeadConfig, SEANetConfig, VQConfig,
                                    VocosBackboneConfig, WavTokenizerSpec)
from wavtokenizer_tpu_torch.models.seanet import seanet_encode
from wavtokenizer_tpu_torch.train import discriminators as td
from wavtokenizer_tpu_torch.train import losses as tl
from wavtokenizer_tpu_torch.train import step as ts
from wavtokenizer_tpu_torch.train import vq_train
from wavtokenizer_tpu_torch.train import wnorm as tw

B, T = 2, 8192
TINY = dict(seanet=dict(dimension=16, n_filters=2, ratios=(8, 5, 4, 2)),
            vq=dict(dimension=16, bins=32, kmeans_iters=2),
            backbone=dict(input_channels=16, dim=32, intermediate_dim=64, num_layers=1,
                          adanorm_num_embeddings=4),
            head=dict(dim=32, n_fft=1280, hop_length=320))
JSPEC = JSpec(seanet=JSEANet(**TINY["seanet"]), vq=JVQ(**TINY["vq"]),
              backbone=JBackbone(**TINY["backbone"]), head=JHead(**TINY["head"]))
TSPEC = WavTokenizerSpec(seanet=SEANetConfig(**TINY["seanet"]), vq=VQConfig(**TINY["vq"]),
                         backbone=VocosBackboneConfig(**TINY["backbone"]),
                         head=ISTFTHeadConfig(**TINY["head"]))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def disc():
    """The discriminators of seed 7 at 1/8 width: (JAX's, the port's)."""
    return (jax.tree.map(jnp.asarray, jd.init_discriminators(seed=7, channels_scale=0.125)),
            td.init_discriminators(seed=7, channels_scale=0.125))


@pytest.fixture(scope="module")
def audio():
    r = np.random.default_rng(0)
    return [(r.normal(size=(B, T)) * 0.1).astype(np.float32) for _ in range(2)]


def _port_losses(d, y, y_hat, dt):
    """Every family's loss (the step's wiring) in compute type ``dt``."""
    y, y_hat = torch.from_numpy(y), torch.from_numpy(y_hat)
    out = {f"{fam}_disc": tl.vocos_disc_loss(d[fam], fam, y, y_hat, 1, compute_dtype=dt)
           for fam in ("mpd", "mrd")}
    for fam in ("mpd", "mrd"):
        out[f"{fam}_gen"], out[f"{fam}_fm"] = tl.vocos_gen_loss(d[fam], fam, y, y_hat, 0,
                                                                compute_dtype=dt)
    out["dac_disc"] = tl.dac_disc_loss(d, y_hat, y, compute_dtype=dt)
    out["dac_gen"], out["dac_feat"] = tl.dac_gen_loss(d, y_hat, y, compute_dtype=dt)
    return out


@pytest.fixture(scope="module")
def bf16_losses(disc, audio):
    """(JAX bf16, port bf16, port fp32) losses of every family."""
    jdisc, tdisc = disc
    y, y_hat = map(jnp.asarray, audio)
    bf = jnp.bfloat16

    @jax.jit
    def jax_losses(p):
        out = {f"{fam}_disc": jl.vocos_disc_loss_fused(p[fam], fam, y, y_hat, 1,
                                                       compute_dtype=bf)
               for fam in ("mpd", "mrd")}
        for fam in ("mpd", "mrd"):
            out[f"{fam}_gen"], out[f"{fam}_fm"] = jl.vocos_gen_loss_fused(
                p[fam], fam, y, y_hat, 0, compute_dtype=bf)
        out["dac_disc"] = jl.dac_disc_loss_fused(p, y_hat, y, compute_dtype=bf)
        out["dac_gen"], out["dac_feat"] = jl.dac_gen_loss_fused(p, y_hat, y, compute_dtype=bf)
        return out

    with torch.no_grad():
        return ({k: float(v) for k, v in jax_losses(jdisc).items()},
                {k: float(v) for k, v in _port_losses(tdisc, *audio, torch.bfloat16).items()},
                {k: float(v) for k, v in _port_losses(tdisc, *audio, None).items()})


LOSSES = ("mpd_disc", "mrd_disc", "mpd_gen", "mrd_gen", "mpd_fm", "mrd_fm", "dac_disc",
          "dac_gen", "dac_feat")
# tests/test_mixed_precision.py's tolerances of bf16 against fp32 (rtol, atol).
VS_FP32 = {"mpd_disc": (0.03, 0.02), "mrd_disc": (0.03, 0.02), "mpd_gen": (0.03, 0.02),
           "mrd_gen": (0.03, 0.02), "mpd_fm": (0.05, 0.02), "mrd_fm": (0.05, 0.02),
           "dac_disc": (0.03, 0.05), "dac_gen": (0.05, 0.05), "dac_feat": (0.05, 0.05)}


@pytest.mark.parametrize("name", LOSSES)
def test_bf16_losses_match_jax_and_fp32(bf16_losses, name):
    jax_bf16, port_bf16, port_f32 = bf16_losses
    assert abs(port_bf16[name] - jax_bf16[name]) <= 2e-2 * abs(jax_bf16[name]), (
        name, port_bf16[name], jax_bf16[name])
    rtol, atol = VS_FP32[name]
    np.testing.assert_allclose(port_bf16[name], port_f32[name], rtol=rtol, atol=atol)


def test_bf16_gradients_point_the_same_way_and_stay_fp32(disc, audio):
    _, tdisc = disc
    leaves = ts.tree_leaves(tdisc)
    grads = {}
    for dt in (None, torch.bfloat16):
        params = ts.tree_map(lambda t: t.clone().requires_grad_(True), tdisc)
        losses = _port_losses(params, *audio, dt)
        total = losses["dac_disc"] + losses["mpd_disc"] + losses["mrd_disc"]
        assert all(v.dtype == torch.float32 for v in losses.values())
        g = torch.autograd.grad(total, ts.tree_leaves(params), allow_unused=True)
        grads[dt] = torch.cat([(x if x is not None else torch.zeros_like(p)).reshape(-1)
                               for x, p in zip(g, leaves)])
        assert all(x is None or x.dtype == torch.float32 for x in g)
    a, b = grads[None], grads[torch.bfloat16]
    assert float(a @ b / (a.norm() * b.norm())) > 0.9


PORT_TCFG = ts.TrainConfig(max_steps=1000, pos_dropout=0.0, disc_channels_scale=0.0625)


@pytest.fixture(scope="module")
def generators():
    """The tiny spec's training generator of seed 0, JAX's (numpy) and the
    port's (the same draws), one codebook inited around the encoder's
    output in both, and 38 frames of audio."""
    from wavtokenizer_tpu.models.init import init_wavtokenizer
    from wavtokenizer_tpu.models.seanet import encoder_layer_specs

    rng = np.random.default_rng(0)
    audio = (rng.normal(size=(2, 38 * 320)) * 0.1).astype(np.float32)
    params = init_wavtokenizer(JSPEC, seed=0)
    jgen = {"encoder": jw.seanet_to_weight_norm(params["encoder"],
                                                encoder_layer_specs(JSPEC.seanet)),
            "backbone": params["backbone"], "head": params["head"]}
    port = ts.create_train_state(TSPEC, PORT_TCFG, seed=0, device="cpu")
    with torch.no_grad():
        emb = seanet_encode(tw.fold_tree(port["gen"]["encoder"]), TSPEC.seanet,
                            torch.from_numpy(audio)[:, :, None], front=False)
    emb = emb.reshape(-1, 16).numpy()
    code = (emb.mean(0) + rng.normal(size=(32, 16)) * emb.std(0) * 3).astype(np.float32)
    vq = {"embed": code[None], "embed_avg": code[None],
          "cluster_size": np.ones((1, 32), np.float32), "inited": np.ones((1, 1), np.float32)}
    port["vq"] = {k: torch.from_numpy(v.copy()) for k, v in vq.items()}
    return jgen, vq, port, audio


def test_generator_forward_bf16_matches_jax(generators):
    """The decode side in bf16 (backbone and head cast, the encoder and VQ
    not), audio_hat back in fp32, against JAX's: the two bf16 waveforms lie
    closer to each other than JAX's bf16 one to the fp32 one (the two CPU
    back ends round bf16 sums in other places: 2.9e-2 of the peak measured,
    against 4.1e-2), and their mel losses within 1e-3 (6e-5 measured)."""
    jgen, vq, port, audio = generators
    j16, jcommit = jax.jit(lambda g, v, a: js.generator_forward(
        g, v, JSPEC, a, 2, jax.random.PRNGKey(0), 1, compute_dtype=jnp.bfloat16)[:2])(
        jax.tree.map(jnp.asarray, jgen), jax.tree.map(jnp.asarray, vq), jnp.asarray(audio))
    j16 = np.asarray(j16)
    a = torch.from_numpy(audio)
    with torch.no_grad():
        p16, commit, _ = ts.generator_forward(port["gen"], port["vq"], TSPEC, a, 2, 1,
                                              compute_dtype=torch.bfloat16)
        p32, commit32, _ = ts.generator_forward(port["gen"], port["vq"], TSPEC, a, 2, 1)
    rel = lambda x, y: float(np.abs(np.asarray(x) - np.asarray(y)).max() / np.abs(y).max())
    assert p16.dtype == torch.float32 and p16.shape == j16.shape
    assert float(commit) == float(commit32)          # the encoder and VQ are not cast
    np.testing.assert_allclose(float(commit), float(jcommit), rtol=1e-5)
    assert rel(p16, j16) < rel(j16, p32.numpy())
    mel16 = float(tl.mel_loss(p16, a))
    assert abs(mel16 - float(jl.mel_loss(jnp.asarray(j16), jnp.asarray(audio)))) <= 1e-3 * mel16


def _double_state(tcfg):
    st = ts.create_train_state(TSPEC, tcfg, seed=0, device="cpu")
    d = lambda t: t.double()
    return ts.new_train_state(ts.tree_map(d, st["gen"]), ts.tree_map(d, st["disc"]),
                              ts.tree_map(d, st["vq"]), ts.tree_map(d, st["decoder"]), tcfg)


def _step_grads(tcfg, monkeypatch):
    """One step (k-means on the first batch, dropout 0.1) of a float64 state:
    (metrics, disc grads, gen grads, VQ state, VQ searches)."""
    searches = []
    real = vq_train.nearest_codebook_indices
    monkeypatch.setattr(vq_train, "nearest_codebook_indices",
                        lambda *a, **k: searches.append(1) or real(*a, **k))
    state = _double_state(tcfg)
    audio = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 38 * 320)) * 0.1)
    g = torch.Generator().manual_seed(0)
    drop_d, drop_g = ts._dropout_generators(g, "cpu")
    vq, m = ts.discriminator_phase(state, audio, TSPEC, tcfg, 1, 1, g, drop_d)
    d_grads = [p.grad.clone() for p in state["opt_disc"].param_groups[0]["params"]]
    m.update(ts.generator_phase(state, vq, audio, TSPEC, tcfg, 1, 1, g, drop_g,
                                with_grad_norm=True))
    g_grads = [p.grad.clone() for p in state["opt_gen"].param_groups[0]["params"]]
    return m, d_grads, g_grads, state["vq"], len(searches)


@pytest.fixture(scope="module")
def no_remat():
    mp = pytest.MonkeyPatch()
    try:
        yield _step_grads(ts.TrainConfig(max_steps=1000, disc_channels_scale=0.0625,
                                         pos_dropout=0.1), mp)
    finally:
        mp.undo()


@pytest.mark.parametrize("remat_disc", [True, False, "store_dac"])
def test_remat_changes_no_gradient(no_remat, remat_disc, monkeypatch):
    tcfg = ts.TrainConfig(max_steps=1000, disc_channels_scale=0.0625, pos_dropout=0.1,
                          remat=True, remat_disc=remat_disc)
    m, d_grads, g_grads, vq, searches = _step_grads(tcfg, monkeypatch)
    m0, d0, g0, vq0, searches0 = no_remat
    assert searches == searches0 == TSPEC.vq.kmeans_iters + 2
    for k, v in m0.items():
        got, want = float(m[k].detach()), float(v.detach())
        assert abs(got - want) <= 1e-10 * max(abs(want), 1.0), k
    for a, b in zip(d_grads + g_grads, d0 + g0, strict=True):
        assert a.dtype == torch.float64
        assert float((a - b).abs().max()) <= 1e-10 * max(float(b.abs().max()), 1.0)
    for k in vq0:
        assert torch.equal(vq[k], vq0[k]), k


def test_remat_mode_resolution():
    assert ts.disc_remat_mode(False, True) is False
    assert ts.disc_remat_mode(True, False) is False
    assert ts.disc_remat_mode(True, True) is True
    assert ts.disc_remat_mode(True, "store_dac") == "store_dac"
    assert ts.TrainConfig().remat is False


@pytest.mark.parametrize("name,want", [("float32", None), ("bfloat16", torch.bfloat16),
                                       ("float16", torch.float16), ("int8", ValueError),
                                       ("brainfloat", ValueError)])
def test_compute_dtype_names(name, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            ts.compute_dtype(name)
    else:
        assert ts.compute_dtype(name) is want


def test_weight_norm_conv2d_matches_jax():
    rng = np.random.default_rng(3)
    kernel = rng.normal(size=(3, 9, 4, 6)).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    want = jw.weight_norm_conv2d({"kernel": kernel, "bias": bias})
    got = tw.weight_norm_conv2d({"weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1)),
                                 "bias": torch.from_numpy(bias)})
    np.testing.assert_allclose(got["g"].numpy().reshape(-1), want["g"].reshape(-1), rtol=1e-6)
    np.testing.assert_array_equal(got["v"].numpy(), kernel.transpose(3, 2, 0, 1))
    np.testing.assert_allclose(tw.fold_wn(got["v"], got["g"]).numpy(),
                               np.asarray(jw.fold_wn(jnp.asarray(want["v"]),
                                                     jnp.asarray(want["g"]))).transpose(3, 2, 0, 1),
                               rtol=1e-6, atol=1e-7)


def test_msstft_discriminator_matches_jax():
    """filters 8, 2 x 4096 samples: logits and every feature map (the port's
    (B, C, T', F) against JAX's (B, T', F, C))."""
    jp = jd.init_msstft_discriminator(seed=4, filters=8)
    tp = td.init_msstft_discriminator(seed=4, filters=8)
    x = (np.random.default_rng(5).normal(size=(2, 4096)) * 0.1).astype(np.float32)
    want_logits, want_fmaps = jax.jit(jd.msstft_discriminator)(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    with torch.no_grad():
        got_logits, got_fmaps = td.msstft_discriminator(tp, torch.from_numpy(x))
    assert len(got_logits) == len(got_fmaps) == 3
    for g, w in zip(got_logits + sum(got_fmaps, []), list(want_logits) + sum(want_fmaps, [])):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
