"""What makes the training step repeat on the card, on the CPU: the VQ
training's segment sums (the port's ``segment_sum`` against JAX's
``jax.ops.segment_sum``, the kernel's order and control flow emulated in
numpy, k-means and the EMA forward against their form before the sums went
through ``segment_sum``) and the STFT framed by ``unfold`` against
``torch.stft``.

``segment_sum`` adds each code's rows in ascending row order from +0.0, in
fp32: the order of the CPU's ``index_add_`` and of XLA:CPU's scatter, so
every comparison here is bit for bit (tolerance 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavtokenizer_tpu_torch.models.quantize import VQConfig
from wavtokenizer_tpu_torch.ops import kernels as K
from wavtokenizer_tpu_torch.ops.vq import codebook_lookup, nearest_codebook_indices
from wavtokenizer_tpu_torch.train import vq_train as tv


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and PyTorch's
    thread pool beside the other test workers oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(n, d, seed):
    """Rows of very different scales, so that the order of the adds shows
    in the rounding."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) * 10.0 ** rng.uniform(-3, 3, size=(n, 1))).astype(np.float32)


def _ids(kind, n, c, seed):
    rng = np.random.default_rng(seed)
    if kind == "skewed":                     # every row to one code, as under random weights
        return np.full(n, 7, np.int64)
    if kind == "spread":                     # uniform over all but the last 4 codes (empty)
        return rng.integers(0, c - 4, n)
    if kind == "mixed":                      # one heavy code, the rest spread, gaps between
        ids = rng.choice(np.arange(0, c, 3), n)
        ids[rng.random(n) < 0.6] = c // 2
        return ids
    # "chunked": code k holds exactly 32 rows, so a code ends on each stage boundary
    return np.repeat(np.arange(n // 32), 32)[rng.permutation(n)]


@pytest.mark.parametrize("kind", ["skewed", "spread"])
def test_plain_segment_sum_bit_equal_to_jax(kind):
    x, ids = _rows(300, 16, 1), _ids(kind, 300, 32, 2)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(ids), num_segments=32))
    got = K.segment_sum(torch.from_numpy(x), torch.from_numpy(ids), 32).numpy()
    assert got.dtype == np.float32 and got.shape == (32, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[np.bincount(ids, minlength=32) == 0], 0.0)


def test_segment_order_lists_each_codes_rows_in_ascending_order():
    ids = torch.from_numpy(_ids("mixed", 500, 40, 3))
    perm, offsets = K.segment_order(ids, 40)
    assert perm.dtype == offsets.dtype == torch.int32 and offsets.shape == (41,)
    assert int(offsets[0]) == 0 and int(offsets[-1]) == 500
    for c in range(40):
        rows = perm[offsets[c]:offsets[c + 1]].long()
        assert torch.equal(rows, torch.nonzero(ids == c).flatten())
    with pytest.raises(ValueError, match="more than num_segments"):
        K.segment_order(ids, 30)


# segment_sum.cu's constants and steps, in numpy.
ROWS, STAGES, CODES, COLS = 32, 8, 16, 32


def _emulate_kernel(rows, perm, offsets, C, late):
    """``segment_sum_kernel`` warp by warp, the 32 lanes as one vector: the
    ring slots, the commit groups and their waits, the per-code flushes.
    ``late`` applies a group's copies only when a wait completes it (early
    reads then see NaN or -1); otherwise when made (a slot reused too early
    is then overwritten)."""
    N, D = rows.shape
    out = np.full((C, D), np.nan, np.float32)
    for bx in range(-(-D // COLS)):
        cols = bx * COLS + np.arange(COLS)
        live = cols < D
        gcols = np.minimum(cols, D - 1)
        for by in range(-(-C // CODES)):
            c0, c1 = by * CODES, min(C, by * CODES + CODES)
            off = offsets[np.minimum(c0 + np.arange(32), c1)]
            j0, j1 = int(off[0]), int(off[c1 - c0])
            n = j1 - j0
            chunks = -(-n // ROWS)
            ring = np.full((STAGES, ROWS, COLS), np.nan, np.float32)
            pring = np.full((2 * STAGES, ROWS), -1, np.int64)
            groups, group = [], []

            def copy(write):
                if late:
                    group.append(write)
                else:
                    write()

            def commit():
                groups.append(list(group))
                group.clear()

            def wait(keep):
                while len(groups) > keep:
                    for write in groups.pop(0):
                        write()

            def fetch_perm(q):
                if q >= chunks:
                    return
                for lane in range(32):
                    j = j0 + q * ROWS + lane
                    if j < j1:
                        copy(lambda s=q % (2 * STAGES), l=lane, v=perm[j]: pring.__setitem__((s, l), v))

            def fetch_rows(g):
                if g >= chunks:
                    return
                p = pring[g % (2 * STAGES)]
                for i in range(min(ROWS, n - g * ROWS)):
                    assert p[i] >= 0, "gather before its indices arrived"
                    copy(lambda s=g % STAGES, i=i, v=rows[p[i], gcols]:
                         ring.__setitem__((s, i), np.where(live, v, np.nan)))

            for q in range(STAGES):
                fetch_perm(q)
            commit()
            wait(0)
            for g in range(STAGES):
                fetch_rows(g)
                fetch_perm(g + STAGES)
                commit()
            cur, end, acc = c0, int(off[1]), np.zeros(COLS, np.float32)

            def flush():
                nonlocal cur, end, acc
                out[cur, cols[live]] = acc[live]
                acc = np.zeros(COLS, np.float32)
                cur += 1
                end = int(off[cur - c0 + 1])

            for k in range(chunks):
                wait(STAGES - 1)
                jb, valid = j0 + k * ROWS, min(ROWS, n - k * ROWS)
                for i in range(valid):
                    while jb + i == end:
                        flush()
                    acc = acc + ring[k % STAGES, i]
                fetch_rows(k + STAGES)
                fetch_perm(k + 2 * STAGES)
                commit()
            while cur < c1:
                flush()
    return out


@pytest.mark.parametrize("kind", ["skewed", "spread", "mixed", "chunked"])
def test_kernel_steps_emulated_equal_the_plain_sums(kind):
    """700 rows (22 stages: the rings wrap), 40 codes (a last group of 8),
    40 columns (a last slice of 8 live lanes)."""
    x, ids = _rows(704, 40, 4), _ids(kind, 704, 40, 5)
    want = K.segment_sum(torch.from_numpy(x), torch.from_numpy(ids), 40).numpy()
    perm, offsets = (t.numpy() for t in K.segment_order(torch.from_numpy(ids), 40))
    for late in (False, True):
        np.testing.assert_array_equal(_emulate_kernel(x, perm, offsets, 40, late), want)


# k-means and the EMA forward as they were before ``segment_sum``.
def _kmeans_before(samples, num_clusters, num_iters, means):
    def assign(means):
        buckets = nearest_codebook_indices(samples, means).long()
        bins = torch.bincount(buckets, minlength=means.shape[0])
        sums = torch.zeros_like(means).index_add_(0, buckets, samples)
        return buckets, bins, sums

    for _ in range(num_iters):
        _, bins, sums = assign(means)
        new_means = sums / bins.clamp(min=1)[:, None]
        means = torch.where((bins == 0)[:, None], means, new_means)
    buckets, bins, _ = assign(means)
    return means, bins, buckets


def _ema_before(state, cfg, x_flat):
    C = cfg.bins
    embed, embed_avg, cluster_size = state["embed"], state["embed_avg"], state["cluster_size"]
    idx = nearest_codebook_indices(x_flat, embed).long()
    quantized = codebook_lookup(idx, embed)
    counts = torch.bincount(idx, minlength=C).to(x_flat.dtype)
    embed_sum = torch.zeros_like(embed).index_add_(0, idx, x_flat)
    cluster_size = cluster_size * cfg.decay + counts * (1 - cfg.decay)
    embed_avg = embed_avg * cfg.decay + embed_sum * (1 - cfg.decay)
    smoothed = tv.laplace_smoothing(cluster_size, C) * cluster_size.sum()
    return quantized, idx, {"embed": embed_avg / smoothed[:, None], "embed_avg": embed_avg,
                            "cluster_size": cluster_size}


@pytest.mark.parametrize("n,c", [(400, 32), (24, 64)])
def test_kmeans_bit_equal_to_before(n, c):
    x = torch.from_numpy(_rows(n, 8, n))
    means = x[torch.randint(0, n, (c,), generator=torch.Generator().manual_seed(c))]
    got = tv.kmeans(x, c, 5, means=means)
    want = _kmeans_before(x, c, 5, means)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


def test_codebook_train_forward_bit_equal_to_before():
    cfg = VQConfig(dimension=8, bins=32)
    x = torch.from_numpy(_rows(500, 8, 6))
    embed = x[::16].clone()
    state = {"embed": embed, "embed_avg": embed * 0.5,
             "cluster_size": torch.rand(32, generator=torch.Generator().manual_seed(0)),
             "inited": torch.ones(1)}
    q, idx, new = tv.codebook_train_forward(state, cfg, x)
    q0, idx0, want = _ema_before(state, cfg, x)
    assert torch.equal(q, q0) and torch.equal(idx, idx0)
    for k, v in want.items():
        assert torch.equal(new[k], v), k


@pytest.mark.parametrize("n_fft,hop,win,kind,center", [
    (1024, 256, 1024, "hann", True),     # the mel loss
    (2048, 512, 2048, "ones", True),     # a resolution discriminator
    (1024, 256, 800, "hann", True),      # a window shorter than n_fft
    (512, 128, 512, "hann", False)])
def test_stft_bit_equal_to_torch_stft(n_fft, hop, win, kind, center):
    """``ops/spectral.py::stft`` frames by ``unfold`` (its backward repeats
    on the card) where torch.stft frames by ``as_strided`` (its backward is
    float atomics there): on the CPU both give the same values and the same
    gradient, bit for bit."""
    from wavtokenizer_tpu_torch.ops.spectral import hann_window, stft

    w = hann_window(win) if kind == "hann" else np.ones(win, np.float32)
    x = torch.from_numpy(_rows(3, 6000, 7)).requires_grad_(True)
    got = stft(x, n_fft, hop, win, w, center)
    want = torch.stft(x, n_fft, hop, win, torch.from_numpy(w), center=center,
                      pad_mode="reflect", onesided=True, return_complex=True).transpose(1, 2)
    assert torch.equal(got, want)
    up = torch.from_numpy(_rows(*got.shape[1:], 8))
    g_got, = torch.autograd.grad((got.abs() * up).sum(), x)
    g_want, = torch.autograd.grad((want.abs() * up).sum(), x)
    assert torch.equal(g_got, g_want)
