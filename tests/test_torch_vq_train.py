"""The port's VQ training state machine against the JAX package on the CPU:
k-means (its sample indices drawn by JAX and passed in), the EMA codebook
forward, the straight-through gradient and commitment loss, and the n_q
layer stacking.

Codes must be equal: the inputs are normal draws, whose nearest codes are
well separated in fp32, and equal means (k-means' draws with replacement)
are exact ties that both packages give to the lowest index.  Float state
(means, EMA buffers, losses, gradients): rel 1e-5 of each tensor's scale
(sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavtokenizer_tpu.models.quantize import VQConfig as JVQConfig
from wavtokenizer_tpu.train import vq_train as jv
from wavtokenizer_tpu_torch.models.quantize import VQConfig
from wavtokenizer_tpu_torch.train import vq_train as tv


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
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-6))


def _jax_sample_indices(key, n, num):
    """JAX's ``sample_vectors`` draw, as indices."""
    if n >= num:
        return np.asarray(jax.random.permutation(key, n)[:num])
    return np.asarray(jax.random.randint(key, (num,), 0, n))


@pytest.mark.parametrize("n,c", [(200, 32), (24, 64)])
def test_kmeans_matches_jax(n, c):
    """n < c draws with replacement: duplicated means (exact ties, the
    lowest index wins) and clusters left empty (they keep their mean)."""
    x = np.random.default_rng(n).normal(size=(n, 8)).astype(np.float32)
    key = jax.random.PRNGKey(c)
    means_j, bins_j = jv.kmeans(key, jnp.asarray(x), c, num_iters=3)
    idx = _jax_sample_indices(key, n, c)
    if n < c:
        assert len(set(idx.tolist())) < c          # duplicated means
    xt = torch.from_numpy(x)
    means_t, bins_t, buckets = tv.kmeans(xt, c, 3, means=xt[torch.from_numpy(np.array(idx)).long()])
    np.testing.assert_array_equal(bins_t.numpy(), np.asarray(bins_j))
    if n < c:
        assert int((bins_t == 0).sum()) > 0          # empty clusters
    _close(means_t.numpy(), np.asarray(means_j))
    np.testing.assert_array_equal(buckets.numpy(),
                                  tv.nearest_codebook_indices(xt, means_t).numpy())


def _layer_state(rng, c, d, inited):
    embed = rng.normal(size=(c, d)).astype(np.float32)
    return {"embed": embed, "embed_avg": embed * 1.5,
            "cluster_size": rng.uniform(0, 3, size=(c,)).astype(np.float32),
            "inited": np.full((1,), float(inited), np.float32)}


@pytest.mark.parametrize("inited", [1, 0])
def test_codebook_train_forward_matches_jax(inited):
    rng = np.random.default_rng(5)
    cfg_kw = dict(dimension=8, bins=16, kmeans_iters=4)
    st = _layer_state(rng, 16, 8, inited)
    x = rng.normal(size=(60, 8)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    qj, idx_j, new_j = jv._codebook_train_forward(jax.tree.map(jnp.asarray, st),
                                                  JVQConfig(**cfg_kw), jnp.asarray(x), key)
    init_means = None
    if not inited:
        k_init, _ = jax.random.split(key)
        init_means = torch.from_numpy(x[_jax_sample_indices(k_init, 60, 16)])
    qt, idx_t, new_t = tv.codebook_train_forward({k: torch.from_numpy(v) for k, v in st.items()},
                                                 VQConfig(**cfg_kw), torch.from_numpy(x),
                                                 init_means=init_means)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(qt.numpy(), np.asarray(qj))
    for k in new_j:
        _close(new_t[k].numpy(), np.asarray(new_j[k]))


def _vq_params(rng, n_q, c, d):
    layers = [_layer_state(rng, c, d, 1) for _ in range(n_q)]
    return {k: np.stack([l[k] for l in layers]) for k in layers[0]}


def test_straight_through_and_commitment_match_jax():
    rng = np.random.default_rng(6)
    params = _vq_params(rng, 1, 16, 8)
    x = rng.normal(size=(2, 10, 8)).astype(np.float32)
    w = rng.normal(size=(2, 10, 8)).astype(np.float32)
    cfg_kw = dict(dimension=8, bins=16, commitment_weight=0.7)

    def j_loss(x):
        q, _, commit, _ = jv.vq_train_forward(jax.tree.map(jnp.asarray, params),
                                              JVQConfig(**cfg_kw), x, jax.random.PRNGKey(0))
        return jnp.sum(q * w) + 3.0 * commit, (q, commit)

    (_, (qj, cj)), gj = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    qt, codes, ct, _ = tv.vq_train_forward({k: torch.from_numpy(v) for k, v in params.items()},
                                           VQConfig(**cfg_kw), xt)
    ((qt * torch.from_numpy(w)).sum() + 3.0 * ct).backward()
    assert codes.dtype == torch.int32 and codes.shape == (1, 2, 10)
    _close(qt.detach().numpy(), np.asarray(qj))
    assert abs(float(ct.detach()) - float(cj)) <= 1e-5 * float(cj)
    _close(xt.grad.numpy(), np.asarray(gj))


def test_n_q_2_of_3_layers_matches_jax():
    """Every used layer quantizes the same input; layers >= n_q keep their
    state; the commitment loss is the layers' mean."""
    rng = np.random.default_rng(7)
    params = _vq_params(rng, 3, 16, 8)
    x = rng.normal(size=(2, 10, 8)).astype(np.float32)
    cfg_kw = dict(dimension=8, bins=16, n_q=3)
    qj, cj, lj, new_j = jv.vq_train_forward(jax.tree.map(jnp.asarray, params),
                                            JVQConfig(**cfg_kw), jnp.asarray(x),
                                            jax.random.PRNGKey(1), n_q=2)
    qt, ct, lt, new_t = tv.vq_train_forward({k: torch.from_numpy(v) for k, v in params.items()},
                                            VQConfig(**cfg_kw), torch.from_numpy(x), n_q=2)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    _close(qt.numpy(), np.asarray(qj))
    assert abs(float(lt) - float(lj)) <= 1e-5 * float(lj)
    for k in new_j:
        _close(new_t[k].numpy(), np.asarray(new_j[k]))
        np.testing.assert_array_equal(new_t[k][2].numpy(), params[k][2])
