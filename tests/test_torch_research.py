"""The port's enhancement research path against the JAX package on the CPU:
the four losses, the adapter's init and forward with its BatchNorm state,
``enhanced_forward`` (narrow, and at the encoder front's own widths, where
the port's route goes through ``ops/kernels.py::encoder_front``), the
paired dataset's crops, and ``enhance_step`` in the modes ``waveform``,
``feature`` and ``hybrid`` (``byol`` is in ``test_torch_byol.py``).

Narrow spec: SEANet n_filters 2, dimension 16 (hop 320); adapter 16 -> 8,
one residual block.  fp32 on both sides in other summation orders: losses
rtol 1e-5, input features and BN state 1e-5 absolute, enhanced features
(after BatchNorm on batch statistics) and waveforms rel-max 1e-4, gradients
1e-5 absolute.  The steps run in float64 on both sides: in float32 their
gradient is ill-conditioned (a 1e-7 relative change of the input moves it
by more than 1e-4, measured by the last test), so two fp32 implementations
cannot agree to 1e-5 there, while in float64 the packages' gradients agree
to ~1e-7 (the converters' float32 cast).  Parameters after two Adam steps
are compared where the first gradient is above 1e-7 (Adam's first update is
+-lr for every such element whatever its size, so elements whose gradient
is ~0 may flip sign between the packages; those are counted and printed).
One JAX ``enhance_step`` and one gradient function are compiled per mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from wavtokenizer_tpu.models.init import init_wavtokenizer as j_init
from wavtokenizer_tpu.models.seanet import SEANetConfig as JSEANetConfig
from wavtokenizer_tpu.models.seanet import seanet_encode as j_seanet_encode
from wavtokenizer_tpu.models.wavtokenizer import WavTokenizerSpec as JSpec
from wavtokenizer_tpu.research import adapter as ja
from wavtokenizer_tpu.research import enhance as je
from wavtokenizer_tpu.research import losses as jl
from wavtokenizer_tpu_torch import SEANetConfig, WavTokenizerSpec
from wavtokenizer_tpu_torch.api.pretrained import seanet_from_jax
from wavtokenizer_tpu_torch.checkpoint.convert import adapter_from_jax
from wavtokenizer_tpu_torch.models.seanet import decoder_layer_specs, encoder_layer_specs
from wavtokenizer_tpu_torch.ops import kernels as K
from wavtokenizer_tpu_torch.research import adapter as ta
from wavtokenizer_tpu_torch.research import enhance as te
from wavtokenizer_tpu_torch.research import losses as tl
from wavtokenizer_tpu_torch.train.step import tree_leaves, tree_map

NARROW = dict(n_filters=2, dimension=16)
ACFG = dict(encoder_dim=16, hidden=8, num_residual_blocks=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread avoids contention with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(**seanet):
    return (WavTokenizerSpec(seanet=SEANetConfig(**seanet)),
            JSpec(seanet=JSEANetConfig(**seanet)))


def _audio(seed, shape, scale=0.1):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _rel_max(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _flat(tree, path="") -> dict:
    """{path: numpy array} of a tree of tensors (key order does not matter:
    JAX returns its dicts with sorted keys)."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, f"{path}/{i}").items()}
    return {path: tree.detach().numpy()} if isinstance(tree, torch.Tensor) else {}


def _assert_close_trees(got: dict, want: dict, atol: float) -> None:
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def narrow():
    """Both packages' narrow model and adapter from one seed."""
    tspec, jspec = _specs(**NARROW)
    params = j_init(jspec, seed=0, random_codebook=True)
    aparams, astate = ja.init_adapter(ja.AdapterConfig(**ACFG), seed=1)
    return {"tspec": tspec, "jspec": jspec, "params": params, "aparams": aparams,
            "astate": astate}


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("case", ["voice", "voice_unequal", "feature", "cosine", "hybrid"])
def test_losses_match_jax(case, one_thread):
    a, b = _audio(1, (2, 9000), 0.3), _audio(2, (2, 9600 if case == "voice_unequal" else 9000), 0.3)
    e, t = _audio(3, (2, 30, 16), 1.0), _audio(4, (2, 30, 16), 1.0)
    T = lambda x: torch.from_numpy(x)
    J = jnp.asarray
    if case.startswith("voice"):
        got, want = tl.voice_focused_loss(T(a), T(b)), jl.voice_focused_loss(J(a), J(b))
    elif case == "feature":
        got, want = tl.feature_loss(T(e), T(t)), jl.feature_loss(J(e), J(t))
    elif case == "cosine":
        got, want = tl.cosine_similarity_loss(T(e), T(t)), jl.cosine_similarity_loss(J(e), J(t))
    else:
        got = tl.hybrid_tsne_loss(T(a), T(b), T(e), T(t))
        want = jl.hybrid_tsne_loss(J(a), J(b), J(e), J(t))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_voice_focused_loss_gradient_is_finite_with_silence(one_thread):
    """Silent rows give spectra of exact zeros, where ``angle`` is 0 and its
    gradient (torch's: 0) must not turn the loss's gradient non-finite."""
    out = torch.from_numpy(_audio(5, (3, 4096))).requires_grad_(True)
    target = torch.from_numpy(_audio(6, (3, 4096)))
    with torch.no_grad():
        out[1] = 0.0
        target[1] = 0.0
        target[2] = 0.0
    loss = tl.voice_focused_loss(out, target)
    loss.backward()
    assert torch.isfinite(loss) and bool(torch.isfinite(out.grad).all())


# ---------------------------------------------------------------- adapter

@pytest.mark.parametrize("seed,cfg", [(0, {}), (3, ACFG)])
def test_init_adapter_is_bit_equal_to_jax(seed, cfg):
    got = ta.init_adapter(ta.AdapterConfig(**cfg), seed=seed)
    want = ja.init_adapter(ja.AdapterConfig(**cfg), seed=seed)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("train", [True, False])
def test_apply_adapter_and_bn_state_match_jax(narrow, train, one_thread):
    x = _audio(7, (3, 20, 16), 1.0)
    state = jax.tree.map(lambda s: s + np.float32(0.5), narrow["astate"])  # not the init's
    want, want_state = ja.apply_adapter(narrow["aparams"], state, jnp.asarray(x), train=train)
    tp, ts = adapter_from_jax(narrow["aparams"], state, device="cpu")
    got, got_state = ta.apply_adapter(tp, ts, torch.from_numpy(x), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    _assert_close_trees(_flat(got_state), _flat(adapter_from_jax(narrow["aparams"],
                                                                 want_state, "cpu")[1]), 1e-5)
    if not train:   # the stored statistics, untouched
        assert all(a is b for a, b in zip(tree_leaves(got_state), tree_leaves(ts), strict=True))


@pytest.mark.parametrize("feature_scale", [None, 1.5])
def test_enhanced_forward_matches_jax(narrow, feature_scale, one_thread):
    audio = _audio(8, (2, 3200))
    base = ta.base_params_from_jax(narrow["params"], narrow["tspec"].seanet, "cpu")
    tp, ts = adapter_from_jax(narrow["aparams"], narrow["astate"], device="cpu")
    got = ta.enhanced_forward(base, narrow["tspec"].seanet, tp, ts, torch.from_numpy(audio),
                              train=True, feature_scale=feature_scale)
    want = jax.jit(lambda p, a: ja.enhanced_forward(
        p, narrow["jspec"].seanet, narrow["aparams"], narrow["astate"], a, train=True,
        feature_scale=feature_scale))(narrow["params"], jnp.asarray(audio))
    assert got[0].shape == want[0].shape == (2, 3200)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-5)
    # BatchNorm on batch statistics divides by channel spreads down to ~1e-3
    # of the features' size: the input features' ~1e-7 difference reaches the
    # enhanced ones amplified (measured 4.5e-5 of their max).
    assert _rel_max(got[1].detach().numpy(), want[1]) < 1e-4
    assert _rel_max(got[0].detach().numpy(), want[0]) < 1e-4
    _assert_close_trees(_flat(got[3]),
                        _flat(adapter_from_jax(narrow["aparams"], want[3], device="cpu")[1]), 1e-5)


def test_enhanced_forward_at_front_widths_takes_the_front_route(monkeypatch, one_thread):
    """n_filters 32: the encoder the front kernel serves
    (``front_geometry_matches``), at T = 1280 (T % 8 == 0, T >= 1024).  On
    the CPU the route's wrapper runs its plain version; it must be called
    once per forward."""
    tspec, jspec = _specs(n_filters=32, dimension=16)
    params = j_init(jspec, seed=2, random_codebook=True)
    aparams, astate = ja.init_adapter(ja.AdapterConfig(**ACFG), seed=4)
    base = ta.base_params_from_jax(params, tspec.seanet, "cpu")
    assert "front" in base["encoder"][0]
    calls = []
    front = K.encoder_front
    monkeypatch.setattr(K, "encoder_front", lambda *a: calls.append(1) or front(*a))
    audio = _audio(9, (2, 1280))
    tp, ts = adapter_from_jax(aparams, astate, device="cpu")
    got = ta.enhanced_forward(base, tspec.seanet, tp, ts, torch.from_numpy(audio),
                              train=False, feature_scale=1.5)
    assert len(calls) == 1
    want = jax.jit(lambda p, a: ja.enhanced_forward(p, jspec.seanet, aparams, astate, a,
                                                    feature_scale=1.5))(params, jnp.asarray(audio))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-5)
    assert _rel_max(got[0].numpy(), want[0]) < 1e-4


def test_frozen_encoder_refuses_a_gradient(narrow):
    base = ta.base_params_from_jax(narrow["params"], narrow["tspec"].seanet, "cpu")
    audio = torch.from_numpy(_audio(10, (1, 3200))).requires_grad_(True)
    with pytest.raises(ValueError, match="frozen encoder"):
        ta.frozen_encode(base["encoder"], narrow["tspec"].seanet, audio)


# ---------------------------------------------------------------- dataset

def test_paired_dataset_crops_equal_jax(tmp_path):
    """The same pairs file and seed give the same crops: long pairs cropped
    at random, a short pair (16 kHz, resampled) tiled, and a batch clamped
    to the dataset's two pairs."""
    rng = np.random.default_rng(11)
    lines = []
    for i, (sr, n) in enumerate([(24000, 9000), (16000, 2000)]):
        paths = []
        for kind in ("noisy", "clean"):
            paths.append(str(tmp_path / f"{kind}{i}.wav"))
            wavfile.write(paths[-1], sr, (rng.normal(size=n) * 3000).astype(np.int16))
        lines.append("|".join(paths))
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("\n".join(lines) + "\n")
    got = te.PairedAudioDataset(str(pairs), num_samples=4000, seed=3)
    want = je.PairedAudioDataset(str(pairs), num_samples=4000, seed=3)
    for it_got, it_want in ((got.batches(8, seed=5), want.batches(8, seed=5)),):
        for _ in range(3):
            (gn, gc), (wn, wc) = next(it_got), next(it_want)
            assert gn.shape == (2, 4000)
            np.testing.assert_array_equal(gn, wn)
            np.testing.assert_array_equal(gc, wc)


# ---------------------------------------------------------------- steps

def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module", params=["waveform", "feature", "hybrid"])
def steps(request, narrow):
    """Two steps of each package from one state, in float64 on both sides,
    and the first step's gradients (JAX's from ``value_and_grad`` of its
    step's own loss).  See ``test_enhance_step_gradient_is_ill_conditioned_in_float32``
    for why float64."""
    mode = request.param
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tspec, jspec = narrow["tspec"], narrow["jspec"]
    params, aparams, astate = (_f64(narrow[k]) for k in ("params", "aparams", "astate"))
    noisy = _audio(12, (2, 3200), 0.3).astype(np.float64)
    clean = _audio(13, (2, 3200), 0.1).astype(np.float64)
    jcfg, tcfg = je.EnhanceConfig(mode=mode), te.EnhanceConfig(mode=mode)
    out = {"mode": mode, "lr": tcfg.learning_rate}
    train_decoder = mode == "waveform"

    with jax.enable_x64(True):
        def loss_fn(trainable):
            bp = {"encoder": params["encoder"],
                  "decoder": trainable["decoder"] if train_decoder else params["decoder"]}
            o, enh, _, _ = ja.enhanced_forward(bp, jspec.seanet, trainable["adapter"], astate,
                                               je._normalize(noisy), train=True,
                                               feature_scale=1.5 if train_decoder else None)
            if mode == "waveform":
                return jl.voice_focused_loss(o, clean)
            target = j_seanet_encode(params["encoder"], jspec.seanet, clean[:, :, None])
            if mode == "feature":
                return jl.feature_loss(enh, target)
            return jl.hybrid_tsne_loss(o, clean, enh, target)

        trainable = {"adapter": aparams}
        if train_decoder:
            trainable["decoder"] = params["decoder"]
        loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(trainable)
        opt_j = je.make_enhance_optimizer(aparams, params["decoder"], jcfg)
        ap_j, st_j, dec_j = aparams, astate, params["decoder"]
        losses_j = []
        for _ in range(2):
            opt_j, ap_j, st_j, dec_j, _, loss = je.enhance_step(
                opt_j, ap_j, st_j, dec_j, params, noisy, clean, jspec, jcfg)
            losses_j.append(float(loss))
        grads_j, ap_j, st_j, dec_j = jax.device_get((grads_j, ap_j, st_j, dec_j))

    # The port from the same state, every tensor float64 (both SEANets in
    # training form: the frozen encoder's inference form holds an fp32 LSTM).
    dbl = lambda tree: tree_map(lambda t: t.double(), tree)
    base = {"encoder": dbl(seanet_from_jax(params["encoder"], encoder_layer_specs(tspec.seanet),
                                           "cpu", train=True)),
            "decoder": dbl(seanet_from_jax(params["decoder"], decoder_layer_specs(tspec.seanet),
                                           "cpu", train=True))}
    ap_t, st_t = (dbl(t) for t in adapter_from_jax(aparams, astate, device="cpu"))
    dec_t = base["decoder"]
    opt_t = te.make_enhance_optimizer(ap_t, dec_t, tcfg)
    T = lambda x: torch.from_numpy(x)
    loss_t, _ = te.enhance_loss(ap_t, st_t, dec_t, base, T(noisy), T(clean), tspec, tcfg)
    trainable_t = te.enhance_trainable(ap_t, dec_t, tcfg)
    grads_t = dict(zip(_flat(trainable_t), (g.numpy() for g in torch.autograd.grad(
        loss_t, tree_leaves(trainable_t)))))
    losses_t, norms_t = [], []
    for _ in range(2):
        st_t, loss, g_norm = te.enhance_step(opt_t, ap_t, st_t, dec_t, base, T(noisy),
                                             T(clean), tspec, tcfg)
        losses_t.append(float(loss))
        norms_t.append(float(g_norm))
    torch.set_num_threads(n)

    def port_layout(tree):
        """A JAX-layout trainable tree (params or grads) in the port's layout."""
        out_tree = {"adapter": adapter_from_jax(tree["adapter"], astate, device="cpu")[0]}
        if "decoder" in tree:
            out_tree["decoder"] = seanet_from_jax(tree["decoder"],
                                                  decoder_layer_specs(tspec.seanet), "cpu",
                                                  train=True)
        return out_tree

    out["loss"] = (float(loss_t.detach()), float(loss_j))
    out["grads"] = (grads_t, _flat(port_layout(grads_j)))
    out["grad_norm"] = (norms_t[0], float(np.sqrt(sum(
        np.sum(np.asarray(g) ** 2) for g in jax.tree.leaves(grads_j)))))
    out["losses"] = (losses_t, losses_j)
    want_tr = {"adapter": ap_j}
    if train_decoder:
        want_tr["decoder"] = dec_j
    out["params"] = (_flat(trainable_t), _flat(port_layout(want_tr)))
    out["state"] = (_flat(st_t), _flat(adapter_from_jax(ap_j, st_j, device="cpu")[1]))
    return out


def test_enhance_step_loss_and_gradients_match_jax(steps):
    got, want = steps["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(steps["losses"][0], steps["losses"][1], rtol=1e-5)
    np.testing.assert_allclose(*steps["grad_norm"], rtol=1e-5)
    _assert_close_trees(*steps["grads"], 1e-5)


def test_enhance_step_parameters_and_bn_state_after_two_steps(steps):
    """After two Adam steps: every element whose first gradient is above
    1e-7 within lr of JAX's (an update is about lr per step); the rest
    (near-zero gradients, whose Adam sign may flip) within 4 lr."""
    lr = steps["lr"]
    got, want = steps["params"]
    grads = steps["grads"][1]
    assert got.keys() == want.keys() == grads.keys()
    outside = 0
    for k in got:
        diff = np.abs(got[k] - want[k])
        big = np.abs(grads[k]) > 1e-7
        assert diff[big].max(initial=0.0) <= lr, k
        assert diff.max(initial=0.0) <= 4 * lr + 1e-6, k
        outside += int((diff[~big] > lr).sum())
    print(f"{steps['mode']}: {outside} elements with |g| <= 1e-7 moved more than lr apart")
    _assert_close_trees(*steps["state"], 1e-5)


def test_enhance_step_gradient_is_ill_conditioned_in_float32(narrow, one_thread):
    """Why the steps above run in float64: in float32 the step's gradient
    moves, in the port alone, by far more than 1e-5 when the noisy input
    moves by 1e-7 of itself (one float32 rounding).  try3's phase term weighs
    each STFT bin by 1 / |X|, and the random decoder's output has near-null
    bins (|X| ~ 1e-5 against ~1 elsewhere), so those few bins carry the
    gradient.  Any two fp32 implementations differ there as much."""
    tspec = narrow["tspec"]
    noisy, clean = _audio(12, (2, 3200), 0.3), _audio(13, (2, 3200), 0.1)
    cfg = te.EnhanceConfig(mode="waveform")

    def grads(x):
        base = ta.base_params_from_jax(narrow["params"], tspec.seanet, "cpu")
        ap, st = adapter_from_jax(narrow["aparams"], narrow["astate"], device="cpu")
        te.make_enhance_optimizer(ap, base["decoder"], cfg)
        tr = te.enhance_trainable(ap, base["decoder"], cfg)
        loss, _ = te.enhance_loss(ap, st, base["decoder"], base, torch.from_numpy(x),
                                  torch.from_numpy(clean), tspec, cfg)
        return [g.numpy() for g in torch.autograd.grad(loss, tree_leaves(tr))]

    bumped = (noisy * (1 + 1e-7 * _audio(14, noisy.shape, 1.0))).astype(np.float32)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(grads(noisy), grads(bumped)))
    print(f"waveform-mode gradient moved by {moved:.3g} for a 1e-7 relative input change")
    assert moved > 1e-4


def test_enhance_config_fields_match_jax():
    names = lambda c: [f.name for f in dataclasses.fields(c)]
    assert names(te.EnhanceConfig) == names(je.EnhanceConfig)
    assert te.EnhanceConfig().feature_scale == je.EnhanceConfig().feature_scale
