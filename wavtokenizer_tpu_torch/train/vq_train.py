"""VQ training state machine: k-means init on the first batch and the EMA
codebook.

Port of ``wavtokenizer_tpu/train/vq_train.py`` (ref
encoder/quantization/core_vq.py: :74-96 kmeans, :206-231
EuclideanCodebook.forward, :378-401 LanguageVectorQuantization).  The state
{embed (n_q, C, D), embed_avg (n_q, C, D), cluster_size (n_q, C), inited
(n_q, 1)} is threaded through the step: every forward returns new tensors
and never writes into the ones it was given (autograd may hold them).

Every nearest-code search, k-means' included, goes through
``ops/vq.py::nearest_codebook_indices``: on the card the VQ kernel, with
|E|^2 and the split codebook made per call (the codebook changes every step
and every k-means iteration).  The ids carry no gradient: the kernel gets x
detached, as the JAX wrapper's ``stop_gradient``.

The per-code sums of k-means and of the EMA go through
``ops/kernels.py::segment_sum``: on the card a kernel that adds each code's
rows in ascending row order without float atomics, the order of the CPU's
``index_add_`` and of JAX's ``jax.ops.segment_sum`` on XLA:CPU, so that the
card's sums equal the CPU's bit for bit and a step repeats exactly.

Sample indices (k-means' initial means) come from an explicit CPU
``torch.Generator``, so two devices given generators of one seed start from
the same means; JAX draws them from its key, so the two packages' draws
differ (the tests inject JAX's means).

Under data parallelism (``group``, the data group of ``parallel/mesh.py``)
the statistics are those of the global batch, as the JAX package computes
them on the logically-global batch (``wavtokenizer_tpu/train/vq_train.py``)
and the reference broadcasts its codebooks (core_vq.py:151,169): every
rank's counts and sums are summed over the group before the EMA update, and
k-means runs on the all-gathered rows, in rank order and so in the global
batch's order, on every rank with the same generator, so that every rank
derives the same means (each rank's searches run on its own card).  With one
rank nothing changes.

Dead-code expiry (ref core_vq.py:159-169) is computed only with
``effective_expiry``.  In the reference its write to ``embed`` is
overwritten by the EMA normalization at the end of the same forward (the
quirk the JAX package reproduces by default), so by default it cannot change
the state and is not computed, and no replacement rows are drawn.  With
``effective_expiry`` (the JAX package's option, the fixed behaviour; no
caller of the train step sets it) the codes whose ``cluster_size`` lies
below ``threshold_ema_dead_code`` before the EMA (k-means' counts on the
first batch) take rows drawn from the batch as their ``embed_avg`` and the
threshold as their ``cluster_size``, and the EMA then runs over them.  The
draw comes from the layer's generator after its k-means draw (JAX's split
order, ``k_init`` then ``k_expire``), over the all-gathered rows under
``group``, so every rank replaces the same codes with the same rows.  The
ids, the quantized rows and the commitment loss do not depend on it.
"""

from __future__ import annotations

import torch

from ..ops.kernels import segment_sum
from ..ops.vq import codebook_lookup, nearest_codebook_indices
from ..parallel.mesh import all_gather, all_reduce_sum, group_rank


def sample_indices(n: int, num: int, generator: torch.Generator | None) -> torch.Tensor:
    """``num`` row indices of ``n`` (ref core_vq.py:63-71): a permutation's
    head when n >= num, else uniform draws with replacement (so equal rows,
    exact ties, when n < num).  Drawn on the CPU."""
    if n >= num:
        return torch.randperm(n, generator=generator)[:num]
    return torch.randint(0, n, (num,), generator=generator)


def sample_vectors(samples: torch.Tensor, num: int,
                   generator: torch.Generator | None) -> torch.Tensor:
    idx = sample_indices(samples.shape[0], num, generator)
    return samples[idx.to(samples.device)]


def _assign(samples: torch.Tensor, means: torch.Tensor):
    """Nearest mean per row, and the rows' count per mean."""
    buckets = nearest_codebook_indices(samples, means).long()
    return buckets, torch.bincount(buckets, minlength=means.shape[0])


@torch.no_grad()
def kmeans(samples: torch.Tensor, num_clusters: int, num_iters: int = 10,
           generator: torch.Generator | None = None,
           means: torch.Tensor | None = None):
    """K-means (ref core_vq.py:74-96): hard L2 assignment, an empty cluster
    keeps its previous mean.  Starts from ``means`` when given, else from
    ``sample_vectors``.

    Returns (means (C, D), bins (C,), buckets (N,)): ``buckets`` is the last
    assignment, the nearest mean of every row under the returned means.
    num_iters + 1 searches and num_iters segment sums."""
    if means is None:
        means = sample_vectors(samples, num_clusters, generator)
    samples = samples.contiguous()
    for _ in range(num_iters):
        buckets, bins = _assign(samples, means)
        sums = segment_sum(samples, buckets, num_clusters, bins)
        new_means = sums / bins.clamp(min=1)[:, None]
        means = torch.where((bins == 0)[:, None], means, new_means)
    buckets, bins = _assign(samples, means)
    return means, bins, buckets


def laplace_smoothing(x: torch.Tensor, n_categories: int, epsilon: float = 1e-5):
    return (x + epsilon) / (x.sum() + n_categories * epsilon)


@torch.no_grad()
def codebook_train_forward(state: dict, cfg, x_flat: torch.Tensor,
                           generator: torch.Generator | None = None,
                           init_means: torch.Tensor | None = None, group=None,
                           effective_expiry: bool = False,
                           expiry_rows: torch.Tensor | None = None):
    """One EuclideanCodebook training forward (ref core_vq.py:206-231) for
    ONE layer.  state: {embed (C, D), embed_avg, cluster_size (C,), inited
    (1,)}; x_flat (N, D), detached, this rank's rows when ``group`` splits
    the batch.  Returns (quantized (N, D), ids (N,) int64, new state).

    An un-inited layer first runs k-means on x_flat, all-gathered over
    ``group`` (``init_means`` as ``kmeans``' ``means``); its codes are then
    k-means' last assignment, the same search on the same rows and means, so
    that search is not run twice: kmeans_iters + 1 searches on the first
    batch, 1 after.  The counts and sums of the EMA update are summed over
    ``group``.  ``effective_expiry`` replaces the dead codes' EMA state
    before the update (the module's docstring) with ``expiry_rows`` (C, D)
    where given (a test's injection, as ``init_means``), else with rows drawn
    by ``sample_vectors``."""
    C = cfg.bins
    x_all = None
    if float(state["inited"].reshape(())) > 0:
        embed, embed_avg = state["embed"], state["embed_avg"]
        cluster_size = state["cluster_size"]
        idx = nearest_codebook_indices(x_flat, embed).long()
    else:
        x_all = all_gather(x_flat, group)
        embed, bins, idx = kmeans(x_all, C, cfg.kmeans_iters, generator, init_means)
        n = x_flat.shape[0]
        idx = idx[group_rank(group) * n:(group_rank(group) + 1) * n]
        embed_avg, cluster_size = embed, bins.to(x_flat.dtype)
    quantized = codebook_lookup(idx, embed)

    if effective_expiry:
        expired = cluster_size < cfg.threshold_ema_dead_code
        if expiry_rows is None:
            x_all = all_gather(x_flat, group) if x_all is None else x_all
            expiry_rows = sample_vectors(x_all, C, generator)
        embed_avg = torch.where(expired[:, None], expiry_rows, embed_avg)
        cluster_size = torch.where(
            expired, torch.full_like(cluster_size, float(cfg.threshold_ema_dead_code)),
            cluster_size)

    decay = cfg.decay
    bins = torch.bincount(idx, minlength=C)
    embed_sum = segment_sum(x_flat.contiguous(), idx, C, bins)
    counts = bins.to(x_flat.dtype)
    all_reduce_sum([counts, embed_sum], group)
    cluster_size = cluster_size * decay + counts * (1 - decay)
    embed_avg = embed_avg * decay + embed_sum * (1 - decay)
    smoothed = laplace_smoothing(cluster_size, C) * cluster_size.sum()
    new_state = {"embed": embed_avg / smoothed[:, None], "embed_avg": embed_avg,
                 "cluster_size": cluster_size,
                 "inited": torch.ones_like(state["inited"])}
    return quantized, idx, new_state


def vq_train_forward(params: dict, cfg, x: torch.Tensor, n_q: int | None = None,
                     generator: torch.Generator | None = None, group=None,
                     effective_expiry: bool = False):
    """LanguageVectorQuantization training forward (ref core_vq.py:378-401,
    VectorQuantization.forward :294-315).

    x (B, T, D).  Every layer quantizes the SAME input (no residual chain);
    the LAST layer's straight-through output is returned.  Straight-through
    and commitment as core_vq.py:301-311: q_st = x + sg(q - x),
    commit = mean((sg(q_st) - x)^2) * commitment_weight, averaged over the
    layers.  Returns (q_st (B, T, D), codes (n_q, B, T) int32, commit, new params);
    layers >= n_q keep their state.  ``group``: the data group that splits
    the batch (``codebook_train_forward``); the commitment loss stays this
    rank's mean, which the step's gradient and metric reductions average.
    ``effective_expiry``: each layer's dead codes are replaced
    (``codebook_train_forward``), the layers' draws in layer order."""
    n_q = min(n_q or cfg.n_q, cfg.n_q)
    B, T, D = x.shape
    x_flat = x.reshape(B * T, D)
    x_det = x_flat.detach()
    layers, codes, losses = [], [], []
    q_st = None
    for q in range(n_q):
        layer = {k: v[q] for k, v in params.items()}
        quantized, idx, new_layer = codebook_train_forward(
            layer, cfg, x_det, generator, group=group, effective_expiry=effective_expiry)
        q_st = x_flat + (quantized - x_flat).detach()
        losses.append(((q_st.detach() - x_flat) ** 2).mean() * cfg.commitment_weight)
        codes.append(idx.reshape(B, T).to(torch.int32))
        layers.append(new_layer)
    new_params = {k: torch.stack([layers[q][k] for q in range(n_q)]
                                 + [params[k][q] for q in range(n_q, cfg.n_q)])
                  for k in params}
    return q_st.reshape(B, T, D), torch.stack(codes), torch.stack(losses).mean(), new_params
