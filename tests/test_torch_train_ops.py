"""The port's training ops against the JAX package on the CPU: STFT, mel
spectrogram and mel loss, the weight-norm fold, the three discriminator
families from one numpy init, and the GAN losses (the list-level
primitives and the per-family sums the step uses, against JAX's ``*_fused``).

Tolerances: the spectral ops and the discriminators run the same fp32
arithmetic in another order (FFT and conv algorithms differ), rel 1e-5 of
each output's scale; loss values rel 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavtokenizer_tpu.ops import spectral as jspec
from wavtokenizer_tpu.train import discriminators as jd
from wavtokenizer_tpu.train import losses as jl
from wavtokenizer_tpu.train import wnorm as jw
from wavtokenizer_tpu_torch.ops import spectral as tspec
from wavtokenizer_tpu_torch.train import discriminators as td
from wavtokenizer_tpu_torch.train import losses as tl
from wavtokenizer_tpu_torch.train import wnorm as tw

SCALE = 0.0625
T = 6000


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and PyTorch's
    thread pool beside the other test workers oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-6))


def _audio(seed, b=2, t=T):
    return (np.random.default_rng(seed).normal(size=(b, t)) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def discs():
    j = jd.init_discriminators(seed=3, num_embeddings=4, channels_scale=SCALE)
    t = td.init_discriminators(seed=3, num_embeddings=4, channels_scale=SCALE)
    return j, t


def _nchw(a):
    """A JAX NHWC feature map in the port's NCHW layout."""
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


@pytest.mark.parametrize("n_fft,hop,win", [(1024, 256, 1024), (512, 128, 400)])
def test_stft_and_mel_match_jax(n_fft, hop, win):
    x = _audio(0)
    want = np.asarray(jspec.stft(jnp.asarray(x), n_fft, hop, win_length=win))
    got = tspec.stft(torch.from_numpy(x), n_fft, hop, win_length=win).numpy()
    _close(got, want)
    want = np.asarray(jspec.mel_spectrogram(jnp.asarray(x), 24000, n_fft, hop, 100))
    got = tspec.mel_spectrogram(torch.from_numpy(x), 24000, n_fft, hop, 100).numpy()
    _close(got, want)
    np.testing.assert_array_equal(tspec.mel_filterbank(24000, n_fft, 100),
                                  jspec.mel_filterbank(24000, n_fft, 100))


def test_mel_loss_matches_jax():
    y, y_hat = _audio(1), _audio(2)
    want = float(jl.mel_loss(jnp.asarray(y_hat), jnp.asarray(y)))
    got = float(tl.mel_loss(torch.from_numpy(y_hat), torch.from_numpy(y)))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_weight_norm_fold_and_round_trip():
    rng = np.random.default_rng(4)
    v = rng.normal(size=(5, 3, 7)).astype(np.float32)        # (K, I, O), JAX's
    g = rng.uniform(0.5, 2, size=(1, 1, 7)).astype(np.float32)
    want = np.asarray(jw.fold_wn(jnp.asarray(v), jnp.asarray(g)))
    got = tw.fold_wn(torch.from_numpy(v.transpose(2, 1, 0).copy()),
                     torch.from_numpy(g.transpose(2, 1, 0).copy())).numpy()
    _close(got, want.transpose(2, 1, 0), 1e-6)
    # weight -> (v, g) -> fold gives the weight back, for 1-D and 2-D convs
    for shape in ((7, 3, 5), (4, 2, 3, 9)):
        w = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        p = tw.weight_norm_conv({"weight": w, "bias": torch.zeros(shape[0])})
        assert p["g"].shape == (shape[0],) + (1,) * (len(shape) - 1)
        _close(tw.fold_tree(p)["weight"].numpy(), w.numpy(), 1e-6)


def test_discriminator_init_matches_jax(discs):
    j, t = discs
    jv = jax.tree.leaves(j)
    tv = [a.numpy() for a in jax.tree.leaves(t)]
    assert len(jv) == len(tv)
    for a, b in zip(jv, tv):
        a = np.asarray(a)
        if a.ndim == 4:                 # (Kh, Kw, I, O) -> (O, I, Kh, Kw)
            a = a.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", ["mpd", "mrd"])
def test_vocos_discriminators_match_jax(discs, family):
    """multi_period_/multi_resolution_discriminator (every discriminator_p
    or _r of the family on the real and the generated audio): scores and
    feature maps."""
    j, t = discs
    y, y_hat = _audio(5), _audio(15)
    fwd_j = jd.multi_period_discriminator if family == "mpd" else jd.multi_resolution_discriminator
    fwd_t = td.multi_period_discriminator if family == "mpd" else td.multi_resolution_discriminator
    want = jax.jit(lambda p, y, y_hat: fwd_j(p, y, y_hat, 2))(
        jax.tree.map(jnp.asarray, j[family]), jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        got = fwd_t(t[family], torch.from_numpy(y), torch.from_numpy(y_hat), 2)
    rs, gs, fr, fg = want
    for a, b in zip(rs + gs, got[0] + got[1], strict=True):
        _close(b.numpy(), np.asarray(a))
    for maps_j, maps_t in zip(fr + fg, got[2] + got[3], strict=True):
        assert len(maps_j) == len(maps_t)
        for a, b in zip(maps_j, maps_t):
            _close(b.numpy(), _nchw(a))


def _dac_maps_nchw(fmap_list):
    return [[_nchw(a) for a in fm] for fm in fmap_list]


def test_dac_discriminator_matches_jax(discs):
    j, t = discs
    x = _audio(6)
    fj = jax.jit(jd.dac_discriminator)(jax.tree.map(jnp.asarray, j), jnp.asarray(x))
    with torch.no_grad():
        ft = td.dac_discriminator(t, torch.from_numpy(x))
    fj = _dac_maps_nchw(fj)
    assert [len(f) for f in fj] == [len(f) for f in ft] == [6] * 5 + [26] * 3
    for a_list, b_list in zip(fj, ft):
        for a, b in zip(a_list, b_list):
            _close(b.numpy(), a)


def test_list_level_losses_match_jax():
    rng = np.random.default_rng(7)
    scores = [rng.normal(size=(2, 11)).astype(np.float32) for _ in range(3)]
    fakes = [rng.normal(size=(2, 11)).astype(np.float32) for _ in range(3)]
    fr = [[rng.normal(size=(2, 4, 5)).astype(np.float32) for _ in range(2)] for _ in range(3)]
    fg = [[rng.normal(size=(2, 4, 5)).astype(np.float32) for _ in range(2)] for _ in range(3)]
    J = lambda t: jax.tree.map(jnp.asarray, t)
    Tt = lambda t: jax.tree.map(torch.from_numpy, t)
    pairs = [(jl.hinge_generator_loss(J(fakes)), tl.hinge_generator_loss(Tt(fakes))),
             (jl.hinge_discriminator_loss(J(scores), J(fakes)),
              tl.hinge_discriminator_loss(Tt(scores), Tt(fakes))),
             (jl.feature_matching_loss(J(fr), J(fg)), tl.feature_matching_loss(Tt(fr), Tt(fg)))]
    for want, got in pairs:
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def test_dac_ls_losses_and_family_sums_match_jax(discs):
    """The LS losses, and the four per-family sums the step uses against
    JAX's ``*_fused`` (no remat: the same values)."""
    j, t = discs
    y, y_hat = _audio(8), _audio(9)
    jp = jax.tree.map(jnp.asarray, j)
    jy, jyh = jnp.asarray(y), jnp.asarray(y_hat)
    ty, tyh = torch.from_numpy(y), torch.from_numpy(y_hat)

    @jax.jit
    def jax_values(p, y, y_hat):
        out = {"dac_d": jl.dac_discriminator_loss(p, y_hat, y),
               "dac_d_fused": jl.dac_disc_loss_fused(p, y_hat, y)}
        out["dac_g"], out["dac_f"] = jl.dac_generator_loss(p, y_hat, y)
        out["dac_g_fused"], out["dac_f_fused"] = jl.dac_gen_loss_fused(p, y_hat, y)
        for fam in ("mpd", "mrd"):
            out[f"{fam}_d"] = jl.vocos_disc_loss_fused(p[fam], fam, y, y_hat, 1)
            out[f"{fam}_g"], out[f"{fam}_fm"] = jl.vocos_gen_loss_fused(p[fam], fam, y,
                                                                         y_hat, 1)
        return out

    want = {k: float(v) for k, v in jax_values(jp, jy, jyh).items()}
    with torch.no_grad():
        got = {"dac_d": tl.dac_discriminator_loss(t, tyh, ty),
               "dac_d_fused": tl.dac_disc_loss(t, tyh, ty)}
        got["dac_g"], got["dac_f"] = tl.dac_generator_loss(t, tyh, ty)
        got["dac_g_fused"], got["dac_f_fused"] = tl.dac_gen_loss(t, tyh, ty)
        for fam in ("mpd", "mrd"):
            got[f"{fam}_d"] = tl.vocos_disc_loss(t[fam], fam, ty, tyh, 1)
            got[f"{fam}_g"], got[f"{fam}_fm"] = tl.vocos_gen_loss(t[fam], fam, ty, tyh, 1)
    for k, w in want.items():
        assert abs(float(got[k]) - w) <= 1e-5 * abs(w), (k, float(got[k]), w)


@pytest.mark.parametrize("adanorm", [True, False])
def test_training_backbone_runs_jax_fp32_block(adanorm):
    """The training layout (fp32 matmul weights) with ``fused=False`` is
    JAX's fp32 ConvNeXt path, not the kernel's bf16 rounding: rel 1e-5."""
    from wavtokenizer_tpu.models import vocos as jvocos
    from wavtokenizer_tpu.models.init import init_backbone
    from wavtokenizer_tpu_torch.api.pretrained import backbone_from_jax
    from wavtokenizer_tpu_torch.models import vocos as tvocos

    kw = dict(input_channels=16, dim=64, intermediate_dim=192, num_layers=2,
              adanorm_num_embeddings=4 if adanorm else None, groupnorm_groups=8)
    params = init_backbone(np.random.default_rng(4), jvocos.VocosBackboneConfig(**kw))
    x = np.random.default_rng(5).normal(size=(2, 30, 16)).astype(np.float32)
    bw = 2 if adanorm else None
    want = jvocos.vocos_backbone(params, jvocos.VocosBackboneConfig(**kw), jnp.asarray(x),
                                 bandwidth_id=bw, fused=False)
    with torch.no_grad():
        got = tvocos.vocos_backbone(backbone_from_jax(params, "cpu", train=True),
                                    tvocos.VocosBackboneConfig(**kw), torch.from_numpy(x),
                                    bandwidth_id=bw, fused=False)
    _close(got.numpy(), np.asarray(want))


def test_training_encoder_matches_inference_encoder_and_trains_lstm():
    """The (v, g) encoder with trainable LSTM tensors gives the inference
    encoder's output (rel 1e-6), and the loss reaches the LSTM weights."""
    from wavtokenizer_tpu_torch import SEANetConfig
    from wavtokenizer_tpu_torch.api.pretrained import seanet_from_jax
    from wavtokenizer_tpu_torch.models.init import init_seanet
    from wavtokenizer_tpu_torch.models.seanet import encoder_layer_specs, seanet_encode

    cfg = SEANetConfig(dimension=16, n_filters=2, ratios=(8, 5, 4, 2))
    specs = encoder_layer_specs(cfg)
    params = init_seanet(np.random.default_rng(6), cfg, encoder=True)
    train = tw.seanet_to_weight_norm(seanet_from_jax(params, specs, "cpu", train=True), specs)
    for t in jax.tree.leaves(train):
        t.requires_grad_(True)
    audio = torch.from_numpy(_audio(7, t=3200))[:, :, None]
    got = seanet_encode(tw.fold_tree(train), cfg, audio, front=False)
    with torch.no_grad():
        want = seanet_encode(seanet_from_jax(params, specs, "cpu"), cfg, audio, front=False)
    _close(got.detach().numpy(), want.numpy(), 1e-6)
    got.pow(2).sum().backward()
    lstm = next(p for p in train if "layers" in p)["layers"][0]
    assert float(lstm["w_hh"].grad.abs().sum()) > 0
