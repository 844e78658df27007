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
ROWS, LOOK, PRODUCERS = 32, 2, 2       # segment_sum_kernel
OWARPS, OCODES, OUNROLL = 16, 256, 4   # segment_order_kernel


class _Barrier:
    """An mbarrier: a phase completes at its ``count``-th arrival.  Deferred
    arrivals (a cp.async's arrive.noinc, with the copies it waits for) land
    as late as they can: when a thread next polls the barrier."""

    def __init__(self, count):
        self.count, self.pending, self.phase, self.deferred = count, count, 0, []

    def arrive(self, n=1):
        for _ in range(n):
            self.pending -= 1
            if self.pending == 0:
                self.phase, self.pending = self.phase + 1, self.count

    def done(self, parity):           # mbarrier.try_wait.parity
        for land, n in self.deferred:
            land()
            self.arrive(n)
        self.deferred.clear()
        return (self.phase & 1) != parity


def _emulate_kernel(rows, perm, seg, offsets, C, late, S, stages, codes, vec):
    """``segment_sum_kernel`` block by block: the PRODUCERS producer warps
    and the S / 32 consumer warps as coroutines (lanes as
    numpy vectors) over the rings of rows and of their codes (``seg``, the
    code of each row of perm), their full and empty barriers, each
    producer's perm indices LOOK of its stages ahead, its 16-byte (``vec``)
    or 4-byte copies and its +0.0 for the group's empty codes, and the
    consumers' register double buffer, their probe of the stage after next,
    the slot reads where a code begins, and the stores at each new code.
    ``late`` lands a stage's copies, and completes its full barrier, only
    when a consumer polls the barrier (reads before that see NaN or code -7);
    otherwise when issued (a slot reused too early is then overwritten)."""
    N, D = rows.shape
    assert not vec or D % 4 == 0
    out = np.full((C, D), np.nan, np.float32)
    lanes = np.arange(32)
    P = PRODUCERS
    for bx in range(-(-D // S)):
        col0 = bx * S
        live_cols = min(S, D - col0)
        for by in range(-(-C // codes)):
            c0, c1 = by * codes, min(C, by * codes + codes)
            soff = offsets[c0:c1 + 1].astype(np.int64)
            j0, j1 = int(soff[0]), int(soff[c1 - c0])
            n = j1 - j0
            chunks = -(-n // ROWS)
            ring = np.full((stages, ROWS, S), np.nan, np.float32)
            sring = np.full((stages, ROWS), -7, np.int64)
            full = [_Barrier(32) for _ in range(stages)]
            empty = [_Barrier(S) for _ in range(stages)]
            progress = [0]

            def index_of(g):
                j = j0 + g * ROWS + lanes
                ok = (g < chunks) & (j < j1)
                return np.where(ok, perm[np.minimum(j, max(N - 1, 0))], 0) if N else lanes * 0

            def producer(p):
                idx = [index_of(p + u * P) for u in range(LOOK)]
                for g in range(p, chunks, P):
                    u, s = (g // P) % LOOK, g % stages
                    if g >= stages:
                        while not empty[s].done((g // stages - 1) & 1):
                            yield
                    valid = min(ROWS, n - g * ROWS)
                    if vec:
                        f = np.arange(S // 4 * 32)
                        i, q = f // (S // 4), f % (S // 4)
                        m = (i < valid) & (q * 4 < live_cols)
                        i, q = i[m], q[m]
                        r = idx[u][i]                    # the shuffle from lane i
                        c = (q * 4)[:, None] + np.arange(4)
                    else:
                        f = np.arange(S * 32)
                        i, q = f // S, f % S
                        m = (i < valid) & (q < live_cols)
                        i, r, c = i[m], idx[u][i[m]], q[m][:, None]
                    vals = rows[r[:, None], col0 + c]
                    cvals = seg[j0 + g * ROWS:j0 + g * ROWS + valid]   # the rows' codes

                    def land(s=s, i=i, c=c, vals=vals, cvals=cvals):
                        ring[s, i[:, None], c] = vals
                        sring[s, :len(cvals)] = cvals

                    if late:                         # every lane's arrive.noinc
                        full[s].deferred.append((land, 32))
                    else:
                        land()
                        full[s].arrive(32)
                    progress[0] += 1
                    idx[u] = index_of(g + LOOK * P)
                for cc in range(c0 + p, c1, P):      # the group's empty codes: +0.0
                    if soff[cc - c0 + 1] == soff[cc - c0]:
                        out[cc, col0:col0 + live_cols] = 0.0

            def consumer(cw):
                lc = cw * 32 + lanes
                live = lc < live_cols
                st = {"cur": -1, "acc": np.zeros(32, np.float32)}

                def next_code(c):
                    if st["cur"] >= 0:
                        out[st["cur"], (col0 + lc)[live]] = st["acc"][live]
                    st["acc"] = np.zeros(32, np.float32)
                    st["cur"] = c

                def wait_full(k):
                    while not full[k % stages].done((k // stages) & 1):
                        yield

                v, last, ready = None, -1, False
                if chunks > 0:
                    yield from wait_full(0)
                    v, last = ring[0, :, lc].copy(), int(sring[0, ROWS - 1])
                for k in range(chunks):
                    more = k + 1 < chunks
                    if more and not ready:
                        yield from wait_full(k + 1)
                    probe = k + 2 >= chunks or full[(k + 2) % stages].done(((k + 2) // stages) & 1)
                    nxt = (k + 1 if more else k) % stages
                    valid = min(ROWS, n - k * ROWS)
                    if valid == ROWS and last == st["cur"]:
                        w = ring[nxt, :, lc].copy()
                        for i in range(ROWS):
                            st["acc"] = st["acc"] + v[:, i]
                    else:                            # from the slot, 8 rows a read
                        for i0 in range(0, valid, 8):
                            t = ring[k % stages, i0:i0 + 8, lc].copy()
                            cs = sring[k % stages, i0:i0 + 8].copy()
                            for j in range(8):
                                if i0 + j < valid:
                                    if cs[j] != st["cur"]:
                                        next_code(int(cs[j]))
                                    st["acc"] = st["acc"] + t[:, j]
                        w = ring[nxt, :, lc].copy()
                    last_w = int(sring[nxt, ROWS - 1])
                    empty[k % stages].arrive(32)
                    progress[0] += 1
                    v, last, ready = w, last_w, probe
                if chunks > 0:
                    next_code(-1)

            cos = [producer(p) for p in range(P)] + [consumer(cw) for cw in range(S // 32)]
            while cos:
                before = progress[0]
                for co in list(cos):
                    try:
                        next(co)
                    except StopIteration:
                        cos.remove(co)
                        progress[0] += 1
                assert not cos or progress[0] > before, "the pipeline deadlocks"
    return out


@pytest.mark.parametrize("kind", ["skewed", "spread", "mixed", "chunked"])
def test_kernel_steps_emulated_equal_the_plain_sums(kind):
    """704 rows (22 stages: the ring wraps), 40 codes in slices of
    SEGMENT_SLICE columns; two plans of ``segment_plan`` (the codes a
    block): 40 columns (a last slice of 8 live columns) by 16-byte copies on
    a card that holds 4 blocks at once (2 groups of 20 codes), and 37
    columns (ragged, rows not 16-byte aligned) by 4-byte copies on a card
    that holds 12 (groups of 7 codes, the last of 5).  "chunked" also runs
    with code 0 one row short, so that codes begin on a stage's last row."""
    variants = [_ids(kind, 704, 40, 5)]
    if kind == "chunked":
        variants.append(variants[0].copy())
        variants[1][np.flatnonzero(variants[0] == 0)[0]] = 39
    for ids in variants:
        perm, offsets = (t.numpy() for t in K.segment_order(torch.from_numpy(ids), 40))
        seg = ids[perm]
        for d, resident, codes in ((40, 4, 20), (37, 12, 7)):
            x = _rows(704, d, 4)
            want = K.segment_sum(torch.from_numpy(x), torch.from_numpy(ids), 40).numpy()
            assert K.segment_plan(40, d, resident) == codes
            for late in (False, True):
                got = _emulate_kernel(x, perm, seg, offsets, 40, late, K.SEGMENT_SLICE,
                                      K.SEGMENT_STAGES, codes, vec=d % 4 == 0)
                np.testing.assert_array_equal(got, want)


def _emulate_order_kernel(ids, C):
    """``segment_order_kernel`` block by block, warp by warp, the lanes as
    numpy vectors: (A) the counts by shared atomics, (B) the warps' first
    slots and the codes' offsets by the warp scans, (C) the ranks by
    ``__match_any_sync``.  Returns (perm, offsets, outside, seg); slots
    nobody wrote hold -1."""
    N = len(ids)
    perm = np.full(N, -1, np.int64)
    seg = np.full(N, -1, np.int64)
    offsets = np.full(C + 1, -1, np.int64)
    outside = None
    lanes = np.arange(32)
    run = -(-(-(-N // OWARPS)) // 32) * 32
    steps = []                                 # (warp, row indices, valid, ids)
    for w in range(OWARPS):
        a, b = min(N, w * run), min(N, w * run + run)
        for base in range(a, b, 32 * OUNROLL):
            for u in range(OUNROLL):
                i = base + u * 32 + lanes
                ok = i < b
                v = np.where(ok, ids[np.minimum(i, max(N - 1, 0))] if N else -1, -1)
                steps.append((w, i, ok, v))
    for bx in range(-(-C // OCODES)):
        c0 = bx * OCODES
        G = min(OCODES, C - c0)
        cnt = np.zeros((OWARPS, OCODES), np.int64)
        below, bad = np.zeros(OWARPS, np.int64), np.zeros(OWARPS, np.int64)
        for w, i, ok, v in steps:                                    # (A)
            below[w] += np.sum(ok & (v >= 0) & (v < c0))
            bad[w] += np.sum(ok & ((v < 0) | (v >= C)))
            m = ok & (v >= c0) & (v < c0 + G)
            np.add.at(cnt[w], v[m] - c0, 1)
        total = np.zeros(OWARPS * 32, np.int64)                      # (B)
        total[:G] = cnt[:, :G].sum(0)
        cnt[:, :G] = np.cumsum(cnt[:, :G], 0) - cnt[:, :G]
        incl = total.reshape(OWARPS, 32).copy()
        d = 1
        while d < 32:                                                # shfl_up scan
            incl[:, d:] = incl[:, d:] + incl[:, :-d].copy()
            d *= 2
        wsum = incl[:, 31]
        start = (incl.reshape(-1) - total + np.repeat(np.cumsum(wsum) - wsum, 32)
                 + below.sum())[:G]
        offsets[c0:c0 + G] = start
        if c0 + G == C:
            offsets[C] = start[G - 1] + total[G - 1]
        cnt[:, :G] += start
        if bx == 0:
            outside = int(bad.sum())
        for w, i, ok, v in steps:                                    # (C)
            inn = ok & (v >= c0) & (v < c0 + G)
            k = np.where(inn, v - c0, OCODES + lanes)
            peers = k[:, None] == k[None, :]                         # __match_any_sync
            rank = np.sum(peers & (lanes[None, :] < lanes[:, None]), 1)
            pos = (cnt[w, np.minimum(k, OCODES - 1)] + rank)[inn]
            perm[pos], seg[pos] = i[inn], (c0 + k)[inn]
            last = inn & ~np.any(peers & (lanes[None, :] > lanes[:, None]), 1)
            cnt[w, k[last]] += np.sum(peers, 1)[last]
    return perm, offsets, outside, seg


@pytest.mark.parametrize("kind", ["skewed", "spread", "mixed", "chunked", "empty", "single",
                                  "last", "outside"])
def test_order_kernel_emulated_equals_the_plain_order(kind):
    """The order kernel's steps against ``segment_order``, exactly: 704 rows
    over 40 codes (one block) and 4992 rows over 600 codes (three blocks,
    warps' runs of three id loads), the four id kinds, no rows, one row,
    every id the last code, and ids outside [0, C) (left out of the order,
    and counted); ``seg`` holds each ordered row's code."""
    for n, c in ((704, 40), (4992, 600)):
        if kind == "empty":
            ids = np.zeros(0, np.int64)
        elif kind == "single":
            ids = np.array([c // 3])
        elif kind == "last":
            ids = np.full(n, c - 1)
        elif kind == "outside":
            ids = _ids("mixed", n, c, 6)
            ids[::7] = c + 3
            ids[::11] = -2
        else:
            ids = _ids(kind, n, c, 5)
        perm, offsets, outside, seg = _emulate_order_kernel(ids, c)
        inside = (ids >= 0) & (ids < c)
        want_perm, want_off = (t.numpy() for t in K.segment_order(
            torch.from_numpy(ids[inside]), c))
        np.testing.assert_array_equal(offsets, want_off)
        np.testing.assert_array_equal(perm[:offsets[c]], np.flatnonzero(inside)[want_perm])
        assert outside == np.sum(~inside)
        np.testing.assert_array_equal(seg[:offsets[c]], ids[perm[:offsets[c]]])
        if kind != "outside":
            np.testing.assert_array_equal(perm, want_perm)


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
