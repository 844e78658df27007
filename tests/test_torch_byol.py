"""The port's BYOL pretrainer, its data readers and try.py's in-path
transformer against the JAX package on the CPU.

* ``research/byol.py``: ``init_byol`` bit-equal; ``simple_transformer``,
  ``projection_mlp``, ``byol_loss`` and its gradient, ``target_update``:
  fp32 in other summation orders, 1e-5 absolute (the loss rtol 1e-5).
* ``research/byol_data.py`` on a Kaldi ark/scp written here: equal.
* ``research/adapter.py``'s in-path half at a narrow width (transformer 16,
  2 heads, 1 layer, FFN 32; adapter 16 -> 8, one block): the transformer,
  ``try_enhancement_stack`` (1e-4 of the largest value: BatchNorm on batch
  statistics and the no-affine LayerNorms divide by small spreads),
  ``load_byol_transformer`` (the JAX count of leaves) and
  ``inpath_transformer_from_torch``.
* ``enhance_step`` in ``byol`` mode, in float64 on both sides (in float32 the
  voice-focused loss's gradient is ill-conditioned, see
  ``tests/test_torch_research.py``): gradients 1e-5 absolute, parameters
  after two steps within lr where the first gradient is above 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavtokenizer_tpu.models.init import init_wavtokenizer as j_init
from wavtokenizer_tpu.models.seanet import SEANetConfig as JSEANetConfig
from wavtokenizer_tpu.models.wavtokenizer import WavTokenizerSpec as JSpec
from wavtokenizer_tpu.research import adapter as ja
from wavtokenizer_tpu.research import byol as jb
from wavtokenizer_tpu.research import byol_data as jd
from wavtokenizer_tpu.research import enhance as je
from wavtokenizer_tpu.research import losses as jl
from wavtokenizer_tpu_torch import SEANetConfig, WavTokenizerSpec
from wavtokenizer_tpu_torch.api.pretrained import seanet_from_jax
from wavtokenizer_tpu_torch.checkpoint.convert import (adapter_from_jax, byol_from_jax,
                                                       inpath_transformer_from_jax)
from wavtokenizer_tpu_torch.models.seanet import decoder_layer_specs, encoder_layer_specs
from wavtokenizer_tpu_torch.research import adapter as ta
from wavtokenizer_tpu_torch.research import byol as tb
from wavtokenizer_tpu_torch.research import byol_data as td
from wavtokenizer_tpu_torch.research import enhance as te
from wavtokenizer_tpu_torch.train.step import tree_leaves, tree_map

BCFG = dict(input_dim=24, hidden_dim=16, projection_dim=8, num_heads=2, num_layers=1,
            ff_dim=32, encoder_out=12)
TCFG = dict(dim=16, num_heads=2, num_layers=1, ffn=32)
ACFG = dict(encoder_dim=16, hidden=8, num_residual_blocks=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _flat(tree, path="") -> dict:
    """{path: numpy array} of a tree of tensors or arrays (key order aside)."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, f"{path}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {path: tree.detach().numpy()}
    return {path: np.asarray(tree)} if hasattr(tree, "shape") else {}


def _assert_close_trees(got, want, atol):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)


# ---------------------------------------------------------------- BYOL

@pytest.mark.parametrize("cfg", [{}, BCFG])
def test_init_byol_is_bit_equal_to_jax(cfg):
    got, want = tb.init_byol(tb.BYOLConfig(**cfg), seed=3), jb.init_byol(jb.BYOLConfig(**cfg), seed=3)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def byol():
    params = jb.init_byol(jb.BYOLConfig(**BCFG), seed=1)
    return {"np": params, "t": byol_from_jax(params, device="cpu"), "tcfg": tb.BYOLConfig(**BCFG),
            "jcfg": jb.BYOLConfig(**BCFG)}


@pytest.mark.parametrize("shape", [(6, 24), (6, 9, 24)])
def test_simple_transformer_and_projection_match_jax(byol, shape, one_thread):
    x = _x(2, shape)
    enc = byol["np"]["online"]["encoder"]
    want = jb.simple_transformer(enc, jnp.asarray(x), byol["jcfg"])
    got = tb.simple_transformer(byol["t"]["online"]["encoder"], torch.from_numpy(x), byol["tcfg"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    proj_j = jb.projection_mlp(byol["np"]["online"]["projector"], want)
    proj_t = tb.projection_mlp(byol["t"]["online"]["projector"], torch.tensor(np.asarray(want)))
    np.testing.assert_allclose(proj_t.detach().numpy(), np.asarray(proj_j), rtol=0, atol=1e-5)


def test_byol_loss_gradient_and_target_update_match_jax(byol, one_thread):
    x1, x2 = _x(3, (6, 9, 24)), _x(4, (6, 9, 24))
    params = jax.tree.map(jnp.asarray, byol["np"])
    loss_j, g_j = jax.jit(jax.value_and_grad(lambda on: jb.byol_loss(
        {"online": on, "target": params["target"]}, jnp.asarray(x1), jnp.asarray(x2),
        byol["jcfg"])))(params["online"])
    tp = byol_from_jax(byol["np"], device="cpu")
    for t in tree_leaves(tp["online"]):
        t.requires_grad_(True)
    loss_t = tb.byol_loss(tp, torch.from_numpy(x1), torch.from_numpy(x2), byol["tcfg"])
    g_t = torch.autograd.grad(loss_t, tree_leaves(tp["online"]))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    want = _flat(jax.device_get(g_j))
    got = dict(zip(_flat(tp["online"]), (g.numpy() for g in g_t)))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    # EMA from a moved online net.
    moved = jax.tree.map(lambda a: a + 0.1, params["online"])
    want_t = jb.target_update({"online": moved, "target": params["target"]}, tau=0.9)["target"]
    tp2 = byol_from_jax({"online": jax.device_get(moved), "target": byol["np"]["target"]},
                        device="cpu")
    assert tb.target_update(tp2, tau=0.9) is tp2
    _assert_close_trees(tp2["target"], jax.device_get(want_t), 1e-6)


# ---------------------------------------------------------------- data

def test_byol_data_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    data = {}
    for spk in ("boy1", "girl2"):
        for mat in ("box", "papercup", "plastic"):
            for utt in ("001", "002"):
                data[f"{spk}_{mat}_LDV_{utt}"] = rng.normal(size=24).astype(np.float32)
    data["boy1_box_clean_001"] = rng.normal(size=24).astype(np.float32)
    data["short_key"] = rng.normal(size=(3, 24)).astype(np.float32)     # a matrix record
    ark, scp = str(tmp_path / "xv.ark"), str(tmp_path / "xv.scp")
    td.write_kaldi_ark_scp(ark, scp, data)
    got, want = td.read_kaldi_scp(scp), jd.read_kaldi_scp(scp)
    assert got.keys() == want.keys() == data.keys()
    for k in data:
        np.testing.assert_array_equal(got[k], data[k])
    for detect in (False, True):
        assert td.make_pairs(data.keys(), detect_clean=detect) == \
            jd.make_pairs(data.keys(), detect_clean=detect)
    pairs_t, pairs_j = td.XVectorPairs(scp), jd.XVectorPairs(scp)
    assert pairs_t.pairs == pairs_j.pairs and pairs_t.feat_dim == 24
    bt = pairs_t.batch(np.random.default_rng(6), 5)
    bj = pairs_j.batch(np.random.default_rng(6), 5)
    for a, b in zip(bt, bj):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    f = rng.normal(size=(7, 24)).astype(np.float32)
    for a, b in zip(td.feature_pair_views(f, np.random.default_rng(7)),
                    jd.feature_pair_views(f, np.random.default_rng(7))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- in-path

@pytest.fixture(scope="module")
def inpath():
    tparams = ja.init_inpath_transformer(ja.InPathTransformerConfig(**TCFG), seed=2)
    aparams, astate = ja.init_adapter(ja.AdapterConfig(**ACFG), seed=3)
    return {"tr": tparams, "ap": aparams, "st": astate,
            "tcfg": ta.InPathTransformerConfig(**TCFG),
            "jcfg": ja.InPathTransformerConfig(**TCFG)}


def test_init_inpath_transformer_is_bit_equal_to_jax():
    for cfg in ({}, TCFG):
        got = ta.init_inpath_transformer(ta.InPathTransformerConfig(**cfg), seed=4)
        want = ja.init_inpath_transformer(ja.InPathTransformerConfig(**cfg), seed=4)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("train", [True, False])
def test_inpath_transformer_and_enhancement_stack_match_jax(inpath, train, one_thread):
    feats = _x(8, (2, 12, 16)) * 0.2 + 1.0
    tr_t = inpath_transformer_from_jax(inpath["tr"], device="cpu")
    want = ja.inpath_transformer(inpath["tr"], jnp.asarray(feats), inpath["jcfg"])
    got = ta.inpath_transformer(tr_t, torch.from_numpy(feats), inpath["tcfg"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    enh_j, st_j = ja.try_enhancement_stack(inpath["tr"], inpath["ap"], inpath["st"],
                                           jnp.asarray(feats), train=train,
                                           transformer_cfg=inpath["jcfg"])
    ap_t, st_t = adapter_from_jax(inpath["ap"], inpath["st"], device="cpu")
    enh_t, new_t = ta.try_enhancement_stack(tr_t, ap_t, st_t, torch.from_numpy(feats),
                                            train=train, transformer_cfg=inpath["tcfg"])
    enh_j = np.asarray(enh_j)
    assert float(np.abs(enh_t.numpy() - enh_j).max() / np.abs(enh_j).max()) < 1e-4
    _assert_close_trees(new_t, adapter_from_jax(inpath["ap"], jax.device_get(st_j), "cpu")[1],
                        1e-5)


def test_load_byol_transformer_copies_the_leaves_jax_copies(inpath):
    """A BYOL encoder whose layers share the in-path widths (hidden 16, FFN
    32): q/k/v/o, both LayerNorms and both FFN linears match; the embedding
    and the 12-wide fc do not."""
    cfg = dict(BCFG, hidden_dim=16, ff_dim=32, input_dim=16)
    ck = jb.init_byol(jb.BYOLConfig(**cfg), seed=9)["online"]["encoder"]
    want, n_j = ja.load_byol_transformer(inpath["tr"], ck)
    got, n_t = ta.load_byol_transformer(inpath_transformer_from_jax(inpath["tr"], device="cpu"),
                                        byol_from_jax({"online": {"encoder": ck},
                                                       "target": {}}, "cpu")["online"]["encoder"])
    assert n_t == n_j == 16
    _assert_close_trees(got, want, 0.0)
    none, n0 = ta.load_byol_transformer(inpath_transformer_from_jax(inpath["tr"], device="cpu"),
                                        {"layers": [{"q": {"weight": torch.zeros(3, 3)}}]})
    assert n0 == 0


def test_inpath_transformer_from_torch_matches_jax(inpath):
    d = TCFG["dim"]
    rng = np.random.default_rng(10)
    sd = {"fc.weight": rng.normal(size=(d, d)), "fc.bias": rng.normal(size=d)}
    pre = "transformer.layers.0."
    for k, shape in (("self_attn.in_proj_weight", (3 * d, d)), ("self_attn.in_proj_bias", (3 * d,)),
                     ("self_attn.out_proj.weight", (d, d)), ("self_attn.out_proj.bias", (d,)),
                     ("norm1.weight", (d,)), ("norm1.bias", (d,)), ("norm2.weight", (d,)),
                     ("norm2.bias", (d,)), ("linear1.weight", (32, d)), ("linear1.bias", (32,)),
                     ("linear2.weight", (d, 32)), ("linear2.bias", (d,))):
        sd[pre + k] = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    got = ta.inpath_transformer_from_torch(sd, ta.InPathTransformerConfig(**TCFG))
    want = ja.inpath_transformer_from_torch(sd, ja.InPathTransformerConfig(**TCFG))
    _assert_close_trees(got, want, 0.0)


# ---------------------------------------------------------------- byol step

def test_enhance_step_byol_mode_matches_jax(inpath, one_thread):
    seanet = dict(n_filters=2, dimension=16)
    tspec = WavTokenizerSpec(seanet=SEANetConfig(**seanet))
    jspec = JSpec(seanet=JSEANetConfig(**seanet))
    f64 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float64), tree)
    params = f64(j_init(jspec, seed=0, random_codebook=True))
    tr, ap, st = f64(inpath["tr"]), f64(inpath["ap"]), f64(inpath["st"])
    noisy = _x(11, (2, 3200), 0.3).astype(np.float64)
    clean = _x(12, (2, 3200), 0.1).astype(np.float64)
    jcfg = je.EnhanceConfig(mode="byol", transformer_cfg=inpath["jcfg"])
    tcfg = te.EnhanceConfig(mode="byol", transformer_cfg=inpath["tcfg"])

    with jax.enable_x64(True):
        def loss_fn(trainable):
            bp = {"encoder": params["encoder"], "decoder": trainable["decoder"]}
            o, _, _, _ = ja.enhanced_forward(bp, jspec.seanet, trainable["adapter"], st,
                                             je._normalize(noisy), train=True,
                                             transformer_params=trainable["transformer"],
                                             transformer_cfg=inpath["jcfg"])
            return jl.voice_focused_loss(o, clean)

        trainable = {"adapter": ap, "decoder": params["decoder"], "transformer": tr}
        loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(trainable)
        opt = je.make_enhance_optimizer(ap, params["decoder"], jcfg, tr)
        ap_j, st_j, dec_j, tr_j = ap, st, params["decoder"], tr
        for _ in range(2):
            opt, ap_j, st_j, dec_j, tr_j, _ = je.enhance_step(
                opt, ap_j, st_j, dec_j, params, noisy, clean, jspec, jcfg, tr_j)
        grads_j, ap_j, st_j, dec_j, tr_j = jax.device_get((grads_j, ap_j, st_j, dec_j, tr_j))

    dbl = lambda tree: tree_map(lambda t: t.double(), tree)
    base = {"encoder": dbl(seanet_from_jax(params["encoder"], encoder_layer_specs(tspec.seanet),
                                           "cpu", train=True)),
            "decoder": dbl(seanet_from_jax(params["decoder"], decoder_layer_specs(tspec.seanet),
                                           "cpu", train=True))}
    ap_t, st_t = (dbl(t) for t in adapter_from_jax(ap, st, device="cpu"))
    tr_t = dbl(inpath_transformer_from_jax(tr, device="cpu"))
    opt_t = te.make_enhance_optimizer(ap_t, base["decoder"], tcfg, tr_t)
    trainable_t = te.enhance_trainable(ap_t, base["decoder"], tcfg, tr_t)
    assert list(trainable_t) == ["adapter", "decoder", "transformer"]
    T = torch.from_numpy
    loss_t, _ = te.enhance_loss(ap_t, st_t, base["decoder"], base, T(noisy), T(clean), tspec,
                                tcfg, tr_t)
    grads_t = torch.autograd.grad(loss_t, tree_leaves(trainable_t))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)

    def port_layout(t):
        return {"adapter": adapter_from_jax(t["adapter"], st, device="cpu")[0],
                "decoder": seanet_from_jax(t["decoder"], decoder_layer_specs(tspec.seanet),
                                           "cpu", train=True),
                "transformer": inpath_transformer_from_jax(t["transformer"], device="cpu")}

    want_g = _flat(port_layout(grads_j))
    got_g = dict(zip(_flat(trainable_t), (g.numpy() for g in grads_t)))
    assert got_g.keys() == want_g.keys()
    for k in got_g:
        np.testing.assert_allclose(got_g[k], want_g[k], rtol=0, atol=1e-5, err_msg=k)
    for _ in range(2):
        st_t, _, _ = te.enhance_step(opt_t, ap_t, st_t, base["decoder"], base, T(noisy),
                                     T(clean), tspec, tcfg, tr_t)
    got_p = _flat(trainable_t)
    want_p = _flat(port_layout({"adapter": ap_j, "decoder": dec_j, "transformer": tr_j}))
    lr = tcfg.learning_rate
    for k in got_p:
        diff = np.abs(got_p[k] - want_p[k])
        assert diff[np.abs(want_g[k]) > 1e-7].max(initial=0.0) <= lr, k
        assert diff.max(initial=0.0) <= 4 * lr + 1e-6, k
    _assert_close_trees(st_t, adapter_from_jax(ap_j, st_j, device="cpu")[1], 1e-5)
