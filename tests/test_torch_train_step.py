"""The port's GAN training step against the JAX package's on the CPU.

JAX's ``train_step`` is jit-compiled ONCE here (a module fixture, ~1 min
on the CPU: it is the whole GAN graph), at ``tests/test_overfit.py``'s tiny
spec with the discriminators at 1/16 width, ``remat=False`` and no pos-net
dropout; the other tests of this file reuse its two steps, and no other
test file compiles it.  Both packages start from one state, whose codebook
is already inited (k-means' sample draws differ between the packages; k-means
itself is compared in ``test_torch_vq_train.py``), drawn around the
encoder's output with a spread wide enough that fp32 separates the codes.
Each step is given JAX's own bandwidth draw.

Tolerances: step 1, every metric within rel 1e-5 (the same fp32 math in
another order).  Step 2 runs on params after one AdamW update: Adam divides
each gradient entry by its own running magnitude, so entries whose gradient
is ~0 move by up to lr in either direction on rounding alone, and the
metrics of step 2 carry that: rel 1e-3.  The generator's and the
discriminators' params after each update: see ``_assert_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavtokenizer_tpu import (ISTFTHeadConfig as JHead, SEANetConfig as JSEANet,
                              VQConfig as JVQ, VocosBackboneConfig as JBackbone,
                              WavTokenizerSpec as JSpec)
from wavtokenizer_tpu.models.seanet import seanet_encode as j_encode
from wavtokenizer_tpu.ops.vq import nearest_codebook_indices as j_nearest
from wavtokenizer_tpu.train import step as js
from wavtokenizer_tpu.train.wnorm import fold_tree as j_fold
from wavtokenizer_tpu_torch import (ISTFTHeadConfig, SEANetConfig, VQConfig,
                                    VocosBackboneConfig, WavTokenizerSpec)
from wavtokenizer_tpu_torch.api.pretrained import train_state_from_jax, train_tree_from_jax
from wavtokenizer_tpu_torch.models.seanet import seanet_encode
from wavtokenizer_tpu_torch.ops.vq import nearest_codebook_indices
from wavtokenizer_tpu_torch.train import step as ts
from wavtokenizer_tpu_torch.train.wnorm import fold_tree

TINY = dict(seanet=dict(dimension=16, n_filters=2, ratios=(8, 5, 4, 2)),
            vq=dict(dimension=16, bins=32, kmeans_iters=2),
            backbone=dict(input_channels=16, dim=32, intermediate_dim=64, num_layers=1,
                          adanorm_num_embeddings=4),
            head=dict(dim=32, n_fft=1280, hop_length=320))
TCFG = dict(max_steps=200_000, initial_learning_rate=2e-3, disc_channels_scale=0.0625,
            pos_dropout=0.0)
JSPEC = JSpec(seanet=JSEANet(**TINY["seanet"]), vq=JVQ(**TINY["vq"]),
              backbone=JBackbone(**TINY["backbone"]), head=JHead(**TINY["head"]))
TSPEC = WavTokenizerSpec(seanet=SEANetConfig(**TINY["seanet"]), vq=VQConfig(**TINY["vq"]),
                         backbone=VocosBackboneConfig(**TINY["backbone"]),
                         head=ISTFTHeadConfig(**TINY["head"]))
JTCFG = js.TrainConfig(remat=False, **TCFG)
TTCFG = ts.TrainConfig(**TCFG)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and PyTorch's
    thread pool beside the other test workers oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bandwidth(key) -> int:
    """JAX's train_step draw of the bandwidth id."""
    return int(jax.random.randint(jax.random.split(key, 5)[0], (), 0, JTCFG.num_bandwidths))


@pytest.fixture(scope="module")
def run():
    """Two JAX steps from one inited state; the states before each step and
    after the second, as numpy, and each step's metrics and bandwidth."""
    rng = np.random.default_rng(0)
    audio = (rng.normal(size=(2, 38 * 320)) * 0.1).astype(np.float32)
    state = js.create_train_state(JSPEC, JTCFG, seed=0)
    emb = np.asarray(jax.jit(lambda enc, a: j_encode(j_fold(enc), JSPEC.seanet, a[:, :, None],
                                                     conv_precision=None))(
        state["gen"]["encoder"], jnp.asarray(audio)))
    emb = emb.reshape(-1, emb.shape[-1])
    code = (emb.mean(0) + rng.normal(size=(32, 16)) * emb.std(0) * 3).astype(np.float32)
    state["vq"] = {"embed": jnp.asarray(code[None]), "embed_avg": jnp.asarray(code[None]),
                   "cluster_size": jnp.ones((1, 32)), "inited": jnp.ones((1, 1))}
    out = {"audio": audio, "emb": emb, "states": [], "metrics": [], "bw": []}
    for i in range(2):
        key = jax.random.PRNGKey(i)
        out["states"].append(jax.device_get(state))   # train_step donates state
        out["bw"].append(_bandwidth(key))
        state, m = js.train_step(state, jnp.asarray(audio), key, JSPEC, JTCFG,
                                 with_grad_norm=True)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["states"].append(jax.device_get(state))
    return out


def _assert_metrics(got: dict, want: dict, rel: float, label: str):
    assert set(got) == set(want), (label, sorted(got), sorted(want))
    for k, w in want.items():
        g = float(got[k])
        assert abs(g - w) <= rel * abs(w), f"{label} {k}: port {g} jax {w}"


def _port_step(state, run, i):
    return ts.train_step(state, torch.from_numpy(run["audio"]), TSPEC, TTCFG,
                         torch.Generator().manual_seed(i), with_grad_norm=True,
                         bandwidth_id=run["bw"][i])


def _flat(tree, path="") -> dict:
    """A tree of dicts and lists -> {path: numpy array}, keys sorted."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flat(tree[key], f"{path}.{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{path}[{i}]").items()}
    return {path: tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)}


def _assert_params(state, want_np: dict, n_steps: int, rel: float):
    """The generator's params (encoder, backbone, head, quantizer, folded)
    and the discriminators' (v, g) params after ``n_steps`` updates: every
    element within what the updates can drift apart (one AdamW update moves
    an element by about lr at most, in either direction), and all but 2% of
    the elements within ``rel`` of their tensor's scale.  The rest are
    mostly tensors whose true gradient is zero, so Adam moves them by
    rounding noise alone: at this spec each pos-net conv bias feeds a
    GroupNorm of one channel per group, and softmax ignores the attention
    key's bias (~0.4% measured at step 1 with rel 1e-5, ~1% at step 2 with
    rel 1e-4).  After one step, rel 1e-5 sees a wrong weight decay: without
    it, lr * wd = 2e-5 of each element, 38% of the generator's elements and
    49% of the discriminators' lie outside."""
    got = ts.state_to_inference_params(state, TSPEC)
    want = js.state_to_inference_params(jax.tree.map(jnp.asarray, want_np), JSPEC)
    pairs = []
    for key in ("encoder", "backbone", "head", "quantizer"):
        gl, wl = jax.tree.leaves(got[key]), jax.tree.leaves(want[key])
        assert len(gl) == len(wl), key
        pairs += [(key, g, np.asarray(w)) for g, w in zip(gl, wl)]
    got_d = _flat(state["disc"])
    want_d = _flat(train_tree_from_jax(want_np["disc"], "cpu"))
    assert got_d.keys() == want_d.keys()
    pairs += [(k, got_d[k], want_d[k]) for k in got_d]
    lr = TCFG["initial_learning_rate"]
    far = total = 0
    for key, g, w in pairs:
        diff = np.abs(g - w)
        assert diff.max() <= 2 * lr * n_steps * 1.1, (key, diff.max())
        far += int((diff > rel * max(np.abs(w).max(), 1e-6)).sum())
        total += w.size
    assert far <= 0.02 * total, (far, total)


def test_codes_equal_before_losses(run):
    """The losses are comparable only if both packages pick the same codes."""
    state = train_state_from_jax(run["states"][0], TSPEC, TTCFG, device="cpu")
    with torch.no_grad():
        emb = seanet_encode(fold_tree(state["gen"]["encoder"]), TSPEC.seanet,
                            torch.from_numpy(run["audio"])[:, :, None], front=False)
    emb = emb.reshape(-1, emb.shape[-1])
    np.testing.assert_allclose(emb.numpy(), run["emb"], rtol=0,
                               atol=1e-5 * np.abs(run["emb"]).max())
    embed = run["states"][0]["vq"]["embed"][0]
    want = np.asarray(j_nearest(jnp.asarray(run["emb"]), jnp.asarray(embed)))
    got = nearest_codebook_indices(emb, state["vq"]["embed"][0]).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(want.tolist())) >= 3


def test_two_steps_match_jax(run):
    state = train_state_from_jax(run["states"][0], TSPEC, TTCFG, device="cpu")
    state, m1 = _port_step(state, run, 0)
    _assert_metrics(m1, run["metrics"][0], 1e-5, "step 1")
    _assert_params(state, run["states"][1], 1, rel=1e-5)
    state, m2 = _port_step(state, run, 1)
    _assert_metrics(m2, run["metrics"][1], 1e-3, "step 2")
    assert state["step"] == 2
    _assert_params(state, run["states"][2], 2, rel=1e-4)


def test_jax_state_and_moments_carried_continue_jax(run):
    """JAX's state after step 1, its AdamW moments and counts included, goes
    on with a port step that lands where JAX's step 2 lands."""
    state = train_state_from_jax(run["states"][1], TSPEC, TTCFG, device="cpu")
    assert state["step"] == 1
    opt = state["opt_gen"]
    assert float(opt.state[opt.param_groups[0]["params"][0]]["step"]) == 1.0
    state, m2 = _port_step(state, run, 1)
    _assert_metrics(m2, run["metrics"][1], 1e-3, "carried step 2")
    _assert_params(state, run["states"][2], 2, rel=1e-4)


def test_without_discriminator_phase(run):
    """train_discriminator=False: the discriminators, their optimizer and
    schedule stay where they were; the generator loss is mel and commitment
    only, on the untouched VQ state, as JAX's generator forward gives them."""
    state = train_state_from_jax(run["states"][0], TSPEC, TTCFG, device="cpu")
    disc_before = [t.clone() for t in ts.tree_leaves(state["disc"])]
    state, m = ts.train_step(state, torch.from_numpy(run["audio"]), TSPEC, TTCFG,
                             torch.Generator().manual_seed(0), train_discriminator=False,
                             bandwidth_id=run["bw"][0])
    assert set(m) == {"mel_loss", "commit_loss", "gen_total"}
    for a, b in zip(ts.tree_leaves(state["disc"]), disc_before):
        assert torch.equal(a, b)
    assert all(float(st["step"]) == 0 for st in state["opt_disc"].state.values())
    assert state["sched_disc"].last_epoch == 0
    assert state["sched_gen"].last_epoch == 1

    @jax.jit
    def j_forward(gen, vq, audio):
        audio_hat, commit, _ = js.generator_forward(gen, vq, JSPEC, audio, run["bw"][0],
                                                    jax.random.PRNGKey(0), 1)
        from wavtokenizer_tpu.train.losses import mel_loss
        return mel_loss(audio_hat, audio), commit

    s0 = jax.tree.map(jnp.asarray, run["states"][0])
    mel, commit = (float(v) for v in j_forward(s0["gen"], s0["vq"], jnp.asarray(run["audio"])))
    _assert_metrics(m, {"mel_loss": mel, "commit_loss": commit,
                        "gen_total": TTCFG.mel_loss_coeff * mel + 1000.0 * commit}, 1e-5,
                    "no disc phase")


@pytest.mark.parametrize("warmup", [0, 7])
def test_lr_schedule_matches_jax(warmup):
    j = js.cosine_schedule_with_warmup(2e-4, warmup, 50)
    t = ts.cosine_schedule_with_warmup(2e-4, warmup, 50)
    for step in (0, 1, 3, 7, 20, 49, 50, 80):
        assert abs(t(step) - float(j(step))) <= 1e-6 * 2e-4, step
    # The LambdaLR reads the schedule at the count before the update.
    tcfg = ts.TrainConfig(num_warmup_steps=warmup, max_steps=100)
    (opt, sched), _ = ts.make_optimizers(tcfg, {"w": torch.zeros(3, requires_grad=True)},
                                         {"w": torch.zeros(3, requires_grad=True)})
    for step in range(4):
        assert opt.param_groups[0]["lr"] == t(step)
        opt.step()
        sched.step()


@pytest.mark.parametrize("decay", [False, True])
def test_mel_coeff_decay_matches_jax(decay):
    kw = dict(decay_mel_coeff=decay, num_warmup_steps=3, max_steps=40)
    for step in (0, 2, 3, 10, 19, 20, 25):
        assert ts.mel_coeff_decay(ts.TrainConfig(**kw), step) == pytest.approx(
            js.mel_coeff_decay(js.TrainConfig(**kw), step), rel=1e-12)
