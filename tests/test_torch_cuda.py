"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped without a card.  The file imports no JAX, so it
also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are deliberately off the kernels' tiles (rows, codes and depth not
multiples of 64/16/128; lengths that leave the encoder front's last tiles
partial) so the masked edges are exercised.
"""

import numpy as np
import pytest
import torch

from wavtokenizer_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n,d,c", [(77, 40, 100), (1801, 512, 4096), (5, 512, 4096)])
def test_vq_nearest_kernel_matches_plain(cuda, n, d, c):
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, d, generator=g).to(cuda)
    e = torch.randn(c, d, generator=g).to(cuda)
    before = K.vq_nearest.launches
    got = K.vq_nearest(x, e)
    torch.cuda.synchronize()
    assert K.vq_nearest.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (n,)
    # fp32 on both sides, other summation orders: near-ties only.
    want = K.vq_nearest_reference(x, e)
    bad = torch.nonzero(got != want).flatten()
    d_got = ((x[bad].double() - e[got[bad].long()].double()) ** 2).sum(1)
    d_want = ((x[bad].double() - e[want[bad].long()].double()) ** 2).sum(1)
    assert bool(((d_got - d_want).abs() <= 1e-5 * d_want).all())
    assert len(bad) <= max(2, n // 400)


def test_vq_nearest_ties_go_to_the_lowest_index(cuda):
    e = torch.zeros(300, 32, device=cuda)
    e[7] = e[200] = e[299] = 1.0          # three identical nearest codes
    x = torch.ones(3, 32, device=cuda)
    assert K.vq_nearest(x, e).tolist() == [7, 7, 7]


def _assert_near_ties(x, e, got, want):
    """Every differing id is a near-tie: its two distances, in float64,
    within 1e-5 relative."""
    bad = torch.nonzero(got != want).flatten()
    d_got = ((x[bad].double() - e[got[bad].long()].double()) ** 2).sum(1)
    d_want = ((x[bad].double() - e[want[bad].long()].double()) ** 2).sum(1)
    assert bool(((d_got - d_want).abs() <= 1e-5 * d_want).all())
    return len(bad)


def test_vq_nearest_near_tie_stress(cuda):
    """Copies spread over the codebook (so over different code tiles and
    blocks, combined by the 64-bit atomicMax): exact copies of a row's
    nearest code, which must resolve to the lowest index, also for rows
    equal to the code (distance zero), and copies perturbed by one ulp,
    where either answer is a near-tie."""
    g = torch.Generator().manual_seed(3)
    C, D = 4096, 512
    e = torch.randn(C, D, generator=g) * 0.1
    for src, dst in ((5, (1000, 2100, 4095)), (300, (301, 3000))):
        for d in dst:
            e[d] = e[src]
    e[777] = torch.nextafter(e[40], torch.full_like(e[40], 1.0))
    e[3333] = torch.nextafter(e[41], torch.full_like(e[41], -1.0))
    x = torch.randn(600, D, generator=g) * 0.1
    x[0], x[1], x[2] = e[5], e[300], e[5] + 1e-3        # distance 0 to codes 5, 300
    # Rows near (not on) codes 40 and 41, whose one-ulp copies are near-ties
    # for them; on a code, fp32 cannot rank distances ~1e-16 at all.
    x[3] = e[40] + 0.05 * torch.randn(D, generator=g)
    x[4] = e[41] + 0.05 * torch.randn(D, generator=g)
    x, e = x.to(cuda), e.to(cuda)
    got = K.vq_nearest(x, e)
    want = K.vq_nearest_reference(x, e)
    torch.cuda.synchronize()
    assert got[:3].tolist() == [5, 300, 5]
    assert got[3].item() in (40, 777) and got[4].item() in (41, 3333)
    flips = _assert_near_ties(x, e, got, want)
    assert flips <= max(2, 600 // 400)


def test_vq_nearest_with_and_without_the_build_time_pack(cuda):
    g = torch.Generator().manual_seed(9)
    x = (torch.randn(1000, 512, generator=g) * 0.1).to(cuda)
    e = (torch.randn(4096, 512, generator=g) * 0.1).to(cuda)
    esq = (e * e).sum(1)
    pack = K.pack_vq_codebook(e)
    before = K.vq_nearest.launches
    with_pack = K.vq_nearest(x, e, esq, pack)
    without = K.vq_nearest(x, e)
    torch.cuda.synchronize()
    assert K.vq_nearest.launches == before + 2
    assert torch.equal(with_pack, without)
    with pytest.raises(ValueError, match="pack"):
        K.vq_nearest(x, e, esq, pack[:, :100])


def test_vq_nearest_refuses_a_row_stride_tma_cannot_take(cuda):
    with pytest.raises(ValueError, match="D % 4"):
        K.vq_nearest(torch.zeros(4, 6, device=cuda), torch.zeros(8, 6, device=cuda))


def test_vq_nearest_at_the_main_path_shape(cuda):
    """N = 28 800 (batch 128 x 3 s of small-320), D = 512, C = 4096."""
    g = torch.Generator().manual_seed(28800)
    x = (torch.randn(28800, 512, generator=g) * 0.1).to(cuda)
    e = (torch.randn(4096, 512, generator=g) * 0.1).to(cuda)
    got = K.vq_nearest(x, e)
    want = K.vq_nearest_reference(x, e)
    torch.cuda.synchronize()
    assert got.shape == (28800,) and int(got.min()) >= 0 and int(got.max()) < 4096
    assert _assert_near_ties(x, e, got, want) <= max(2, 28800 // 400)


# M = 300 rows (not a multiple of the 128-row tile); the model's widths at a
# small B x T' (M = 150); C = 96, I = 352: N and K of both GEMMs off the
# 128-wide tile and the 64-deep K step, so TMA zero-fills and the epilogue
# masks.
@pytest.mark.parametrize("B,T,C,I", [(3, 100, 128, 384), (2, 75, 768, 2304),
                                     (1, 37, 96, 352)])
@pytest.mark.parametrize("adanorm", [False, True])
def test_convnext_block_kernel_matches_plain(cuda, adanorm, B, T, C, I):
    g = torch.Generator().manual_seed(int(adanorm))
    f = lambda *s, sc=0.1: (torch.randn(*s, generator=g) * sc).to(cuda)
    scale, shift = ((1 + f(4, C))[1], f(4, C)[1]) if adanorm else (1 + f(C), f(C))
    x = f(B, T, C, sc=1.0)
    args = (x, f(7, C), f(C), scale.contiguous(), shift.contiguous(),
            f(C, I, sc=0.05).to(torch.bfloat16), f(I), f(I, C, sc=0.05).to(torch.bfloat16),
            f(C), f(C, sc=0.3))
    before = K.convnext_block.launches
    got = K.convnext_block(*args)
    torch.cuda.synchronize()
    assert K.convnext_block.launches == before + 1
    want = K.convnext_block_reference(*args)
    # Same bf16 operands and fp32 sums; only the summation order differs.
    err = (got - want).abs().max() / (want - x).abs().max()
    assert float(err) < 1e-2


def test_convnext_block_kernel_refuses_fp32_weights(cuda):
    C, I = 128, 384
    z = lambda *s: torch.zeros(*s, device=cuda)
    with pytest.raises(ValueError, match="w1"):
        K.convnext_block(z(1, 4, C), z(7, C), z(C), z(C), z(C), z(C, I), z(I), z(I, C),
                         z(C), z(C))


@pytest.fixture(scope="module")
def small320_encoder():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from wavtokenizer_tpu_torch import WavTokenizer, WavTokenizerSpec, init_wavtokenizer
    from wavtokenizer_tpu_torch.models.seanet import encoder_layer_specs
    spec = WavTokenizerSpec()
    model = WavTokenizer.from_jax_params(
        init_wavtokenizer(spec, seed=0, random_codebook=True), spec, device="cuda")
    return model.params["encoder"], encoder_layer_specs(spec.seanet), spec


# T=1024 is the shortest length the gate admits (T/8 = 128 = 2*62 + 4: a last
# tile of 4 frames); T=8224 leaves a partial last tile (T/8 = 1028 = 16*62 +
# 36); B=5 x T=24000 makes 5*49 = 245 tiles, not a multiple of the 132 SMs.
@pytest.mark.parametrize("B,T", [(2, 1024), (2, 8224), (1, 6144), (3, 72000),
                                 (5, 24000)])
def test_encoder_front_kernel_matches_plain(small320_encoder, B, T):
    from wavtokenizer_tpu_torch.models.wavtokenizer import full_fp32
    params, specs, _ = small320_encoder
    g = torch.Generator().manual_seed(T)
    audio = (torch.randn(B, T, 1, generator=g) * 0.1).cuda()
    before = K.encoder_front.launches
    with full_fp32():
        got = K.encoder_front(audio, params, specs)
        want = K.encoder_front_reference(audio, params, specs)
    torch.cuda.synchronize()
    assert K.encoder_front.launches == before + 1
    assert got.shape == want.shape == (B, T // 8, 128)
    # fp32 on both sides (TF32 off), other summation orders.
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < 1e-5, rel


def test_encoder_front_gate_keeps_other_lengths_and_geometries_plain(small320_encoder):
    from wavtokenizer_tpu_torch import WavTokenizer, init_wavtokenizer
    from wavtokenizer_tpu_torch.models.seanet import seanet_encode
    from wavtokenizer_tpu_torch.models.wavtokenizer import full_fp32
    from wavtokenizer_tpu_torch.utils.golden import golden_specs
    params, _, spec = small320_encoder
    before = K.encoder_front.launches
    with full_fp32():
        seanet_encode(params, spec.seanet, torch.zeros(1, 2052, 1, device="cuda"))
        spec600 = golden_specs()["small600"]
        p600 = WavTokenizer.from_jax_params(init_wavtokenizer(spec600, seed=0), spec600,
                                            device="cuda").params["encoder"]
        assert "front" not in p600[0]
        seanet_encode(p600, spec600.seanet, torch.zeros(1, 4800, 1, device="cuda"))
        seanet_encode(params, spec.seanet, torch.zeros(1, 4800, 1, device="cuda"))
    torch.cuda.synchronize()
    assert K.encoder_front.launches == before + 1


def test_vq_nearest_at_the_encodec_shape(cuda):
    """N = 14 400 (batch 64 x 3 s at 75 frames/s), C = 1024, D = 128: the
    residual VQ's shape, 600 (row tile, code tile) pairs of 4 k-blocks."""
    g = torch.Generator().manual_seed(14400)
    x = (torch.randn(14400, 128, generator=g) * 0.1).to(cuda)
    e = (torch.randn(1024, 128, generator=g) * 0.1).to(cuda)
    before = K.vq_nearest.launches
    got = K.vq_nearest(x, e)
    want = K.vq_nearest_reference(x, e)
    torch.cuda.synchronize()
    assert K.vq_nearest.launches == before + 1
    assert got.shape == (14400,) and int(got.min()) >= 0 and int(got.max()) < 1024
    assert _assert_near_ties(x, e, got, want) <= max(2, 14400 // 400)


def test_chained_vq_encode_matches_plain_layer_by_layer(cuda):
    """A 4-layer residual chain on the card; each layer's plain search on the
    residual the kernel chain left holds its codes (near-ties only)."""
    from wavtokenizer_tpu_torch.api.pretrained import quantizer_from_jax
    from wavtokenizer_tpu_torch.models.quantize import VQConfig, vq_encode
    from wavtokenizer_tpu_torch.models.wavtokenizer import full_fp32

    rng = np.random.default_rng(4)
    embed = np.stack([rng.normal(size=(1024, 128)) * 0.5 ** q for q in range(4)])
    q = quantizer_from_jax({"embed": embed.astype(np.float32)}, cuda)
    x = torch.as_tensor(rng.normal(size=(8, 225, 128)).astype(np.float32)).to(cuda)
    before = K.vq_nearest.launches
    with full_fp32():
        codes = vq_encode(q, VQConfig(dimension=128, n_q=4, bins=1024), x)
    torch.cuda.synchronize()
    assert K.vq_nearest.launches == before + 4 and codes.shape == (4, 8, 225)
    residual, flips = x.reshape(-1, 128), 0
    for layer in range(4):
        e, got = q["embed"][layer], codes[layer].reshape(-1)
        flips += _assert_near_ties(residual, e, got, K.vq_nearest_reference(residual, e))
        residual = residual - e[got.long()]
    assert flips <= max(2, 4 * 1800 // 400)


@pytest.mark.parametrize("k,stride,causal,gn", [(16, 8, True, False), (10, 5, False, True),
                                                (4, 2, True, True)])
def test_sconv_transpose1d_card_matches_cpu(cuda, k, stride, causal, gn):
    from functools import partial

    from wavtokenizer_tpu_torch.models.seanet import _time_group_norm
    from wavtokenizer_tpu_torch.models.wavtokenizer import full_fp32
    from wavtokenizer_tpu_torch.ops.conv import sconv_transpose1d

    g = torch.Generator().manual_seed(k)
    x, w = torch.randn(4, 200, 64, generator=g), torch.randn(64, 32, k, generator=g) * 0.1
    b, p = torch.randn(32, generator=g), {"weight": torch.randn(32, generator=g) + 1,
                                          "bias": torch.randn(32, generator=g)}

    def run(dev):
        norm = partial(_time_group_norm, {n: t.to(dev) for n, t in p.items()}) if gn else None
        with full_fp32():
            return sconv_transpose1d(x.to(dev), w.to(dev), b.to(dev), stride=stride,
                                     causal=causal, norm_fn=norm)

    got, want = run(cuda).cpu(), run("cpu")
    assert got.shape == want.shape == (4, 200 * stride, 32)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_lm_compression_lossless_on_the_card(cuda):
    from wavtokenizer_tpu_torch.models.lm import (LMConfig, StreamingTransformerConfig,
                                                  init_lm, lm_params_to)
    from wavtokenizer_tpu_torch.ops.entropy import compress_codes, decompress_codes

    cfg = LMConfig(n_q=4, card=1024, transformer=StreamingTransformerConfig(past_context=32))
    params = lm_params_to(init_lm(cfg, seed=0), cuda)
    codes = np.random.default_rng(0).integers(0, 1024, size=(4, 60)).astype(np.int32)
    blob = compress_codes(params, cfg, codes)
    np.testing.assert_array_equal(decompress_codes(params, cfg, blob, 4, 60), codes)


# ---------------------------------------------------------------------------
# Training: the VQ kernel in k-means and in the EMA forwards
# ---------------------------------------------------------------------------

def test_vq_nearest_on_kmeans_inputs_with_duplicated_means(cuda):
    """k-means' first assignment when the batch has fewer rows than codes:
    the means are rows drawn with replacement, so most rows have several
    exact copies among the means (distance ~0, exact ties) and the lowest
    index must win.  Ids equal to the plain version's."""
    g = torch.Generator().manual_seed(11)
    x = torch.randn(1500, 512, generator=g).to(cuda)
    idx = torch.randint(0, 1500, (4096,), generator=g)
    means = x[idx.to(cuda)]
    got = K.vq_nearest(x, means)
    want = K.vq_nearest_reference(x, means)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    first = {}
    for j, i in enumerate(idx.tolist()):
        first.setdefault(i, j)
    drawn = torch.tensor(sorted(first))
    assert torch.equal(got.cpu()[drawn], torch.tensor([first[i] for i in drawn.tolist()],
                                                      dtype=torch.int32))


def _tiny_training():
    from wavtokenizer_tpu_torch import (ISTFTHeadConfig, SEANetConfig, VQConfig,
                                        VocosBackboneConfig, WavTokenizerSpec)
    from wavtokenizer_tpu_torch.train.step import TrainConfig

    spec = WavTokenizerSpec(
        seanet=SEANetConfig(dimension=16, n_filters=2, ratios=(8, 5, 4, 2)),
        vq=VQConfig(dimension=16, bins=32, kmeans_iters=3),
        backbone=VocosBackboneConfig(input_channels=16, dim=32, intermediate_dim=64,
                                     num_layers=1, adanorm_num_embeddings=4),
        head=ISTFTHeadConfig(dim=32, n_fft=1280, hop_length=320))
    return spec, TrainConfig(max_steps=1000, disc_channels_scale=0.0625, pos_dropout=0.0)


def test_training_vq_launches_per_step(cuda):
    """kmeans_iters + 2 searches on the first step (k-means' iterations and
    last assignment, which the first codebook forward reuses as its codes,
    and the generator phase's forward), then 2 a step; as many segment sums
    (k-means' iterations and the two phases' EMA forwards)."""
    from wavtokenizer_tpu_torch.train.step import create_train_state, train_step

    spec, tcfg = _tiny_training()
    state = create_train_state(spec, tcfg, seed=0, device=cuda)
    audio = (torch.randn(2, 12160, generator=torch.Generator().manual_seed(1)) * 0.1).to(cuda)
    counts = []
    for step in range(3):
        K.reset_launch_counts()
        state, m = train_step(state, audio, spec, tcfg, torch.Generator().manual_seed(step))
        torch.cuda.synchronize()
        counts.append((K.vq_nearest.launches, K.segment_sum.launches))
        assert all(bool(torch.isfinite(v)) for v in m.values())
    # The segment sums: one per k-means iteration, one per EMA forward.
    first = spec.vq.kmeans_iters + 2
    assert counts == [(first, first), (2, 2), (2, 2)]


def test_train_step_card_matches_cpu(cuda):
    """Two steps from one state on the card and on the CPU, TF32 off: every
    metric within rel 1e-3 (fp32 in other orders, and the card's VQ search
    is the kernel).  The codebook is inited around the encoder's output so
    that its codes are well separated in fp32.

    The card runs cuDNN's deterministic algorithms, so that its steps repeat
    bit for bit (the VQ's sums and the STFT's backward do without float
    atomics): the second step holds a VQ near-tie (one row of the
    discriminator phase 1.1e-5 from two codes, relative) that the CPU itself
    tips under a 1e-7 relative change of the input, and run-to-run rounding
    on the card tipped it too, the commit loss then 1% off."""
    from wavtokenizer_tpu_torch.models.seanet import seanet_encode
    from wavtokenizer_tpu_torch.models.wavtokenizer import full_fp32
    from wavtokenizer_tpu_torch.train.step import (create_train_state, train_step, tree_map)
    from wavtokenizer_tpu_torch.train.wnorm import fold_tree

    spec, tcfg = _tiny_training()
    audio = torch.randn(2, 12160, generator=torch.Generator().manual_seed(2)) * 0.1
    cpu = create_train_state(spec, tcfg, seed=0, device="cpu")
    with torch.no_grad():
        emb = seanet_encode(fold_tree(cpu["gen"]["encoder"]), spec.seanet, audio[:, :, None],
                            front=False).reshape(-1, 16)
    code = emb.mean(0) + torch.randn(32, 16, generator=torch.Generator().manual_seed(3)) \
        * emb.std(0) * 3
    cpu["vq"] = {"embed": code[None], "embed_avg": code[None].clone(),
                 "cluster_size": torch.ones(1, 32), "inited": torch.ones(1, 1)}
    card = create_train_state(spec, tcfg, seed=0, device=cuda)
    card["vq"] = tree_map(lambda t: t.to(cuda), cpu["vq"])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with full_fp32():
            for step in range(2):
                _, m_cpu = train_step(cpu, audio, spec, tcfg,
                                      torch.Generator().manual_seed(step), bandwidth_id=step + 1)
                _, m_card = train_step(card, audio.to(cuda), spec, tcfg,
                                       torch.Generator().manual_seed(step), bandwidth_id=step + 1)
                for k, v in m_cpu.items():
                    assert abs(float(m_card[k]) - float(v)) <= 1e-3 * abs(float(v)), (step, k)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for k in cpu["vq"]:
        want = cpu["vq"][k]
        assert float((card["vq"][k].cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())


# ---------------------------------------------------------------------------
# The VQ's training statistics: segment sums without float atomics
# ---------------------------------------------------------------------------

def _segment_inputs(n, c, d, kind):
    rng = np.random.default_rng(n + c + d)
    rows = (rng.normal(size=(n, d)) * 10.0 ** rng.uniform(-3, 3, size=(n, 1))).astype(np.float32)
    if kind == "skewed":          # every row to one code, as under random weights
        ids = np.full(n, 573 % c)
    elif kind == "spread":
        ids = rng.integers(0, c, n)
    else:                         # one heavy code, the rest spread over every third code
        ids = rng.choice(np.arange(0, c, 3), n)
        ids[rng.random(n) < 0.6] = c // 2
    return torch.from_numpy(rows), torch.from_numpy(ids)


@pytest.mark.parametrize("n,c,d,kind", [(700, 40, 40, "mixed"), (5, 33, 8, "spread"),
                                        (9000, 4096, 512, "skewed"),
                                        (9000, 4096, 512, "spread"),
                                        (700, 40, 37, "mixed"), (9000, 4096, 512, "mixed")])
def test_segment_sum_kernel_bit_equal_to_cpu(cuda, n, c, d, kind):
    """The kernel against ``index_add_`` on the CPU on the same inputs, bit
    for bit (the same order of fp32 adds), and against itself across
    launches, without counts and with them (int32 ids); at small shapes
    (ragged columns and code groups; D = 37: rows not 16-byte aligned, the
    4-byte copies) and at the training shape (40 x 3 s of small-320 frames,
    4096 codes of 512)."""
    rows, ids = _segment_inputs(n, c, d, kind)
    want = K.segment_sum_reference(rows, ids, c)
    x, i = rows.to(cuda), ids.to(cuda)
    before = K.segment_sum.launches
    a = K.segment_sum(x, i, c)
    b = K.segment_sum(x, i.int(), c, torch.bincount(i, minlength=c))
    torch.cuda.synchronize()
    assert K.segment_sum.launches == before + 2
    assert torch.equal(a.cpu(), want)
    assert torch.equal(b, a)


@pytest.mark.parametrize("n,c,kind", [(700, 40, "mixed"), (9000, 4096, "skewed"),
                                      (9000, 4096, "spread")])
def test_segment_order_kernel_equals_plain_order(cuda, n, c, kind):
    """``segment_order_kernel`` against the plain ``segment_order`` (a stable
    sort and the counts' prefix sum), element for element, from int64 and
    int32 ids; its ``seg`` is each ordered row's id."""
    _, ids = _segment_inputs(n, c, 8, kind)
    want_perm, want_offsets = K.segment_order(ids, c)
    for i in (ids.to(cuda), ids.to(cuda).int()):
        perm, offsets, outside, seg = K.segment_order_card(i, c)
        torch.cuda.synchronize()
        assert torch.equal(perm.cpu(), want_perm)
        assert torch.equal(offsets.cpu(), want_offsets)
        assert int(outside.item()) == 0
        assert torch.equal(seg.cpu().long(), ids[want_perm.long()])


def test_segment_sum_kernel_unaligned_rows_bit_equal_to_cpu(cuda):
    """Rows whose base lies 4 bytes past 16-byte alignment (D = 40, so
    only the base stops the 16-byte copies): the 4-byte copies, bit for bit
    against the CPU, with counts given."""
    rows, ids = _segment_inputs(700, 40, 40, "mixed")
    i = ids.to(cuda)
    x = torch.empty(700 * 40 + 1, device=cuda)[1:].view(700, 40)
    x.copy_(rows.to(cuda))
    assert x.data_ptr() % 16 != 0
    got = K.segment_sum(x, i, 40, torch.bincount(i, minlength=40))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), K.segment_sum_reference(rows, ids, 40))


def test_segment_sum_kernel_refuses_what_it_cannot_take(cuda):
    rows, ids = _segment_inputs(50, 8, 16, "spread")
    x, i = rows.to(cuda), ids.to(cuda)
    with pytest.raises(ValueError, match="float32"):
        K.segment_sum(x.double(), i, 8)
    with pytest.raises(ValueError, match="integer"):
        K.segment_sum(x, i.float(), 8)
    with pytest.raises(ValueError, match="more than num_segments"):
        K.segment_sum(x, i, 4)
    assert torch.equal(K.segment_sum(x[:0], i[:0], 8).cpu(), torch.zeros(8, 16))


def test_stft_gradient_repeats_on_the_card(cuda):
    """The STFT of the mel loss and the spectral discriminators
    (``ops/spectral.py::stft``, framed by ``unfold``) gives the same gradient
    on every run, bit for bit, at the mel loss's shape (40 x 3 s, n_fft 1024,
    hop 256); beside it, printed, torch.stft's (framed by ``as_strided``,
    whose backward sums by float atomics on the card)."""
    from wavtokenizer_tpu_torch.ops.spectral import hann_window, stft

    g = torch.Generator().manual_seed(5)
    x0 = (torch.randn(40, 72000, generator=g) * 0.1).to(cuda)
    up = torch.randn(40, 282, 513, generator=g).to(cuda)
    w = torch.from_numpy(hann_window(1024)).to(cuda)

    def grad(f):
        x = x0.clone().requires_grad_(True)
        (f(x).abs() * up).sum().backward()
        return x.grad

    port = [grad(lambda x: stft(x, 1024, 256)) for _ in range(2)]
    plain = [grad(lambda x: torch.stft(x, 1024, 256, 1024, w, center=True, pad_mode="reflect",
                                       onesided=True, return_complex=True).transpose(1, 2))
             for _ in range(2)]
    torch.cuda.synchronize()
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    print(f"STFT gradient, run against run on the card: the port's {rel(port[1], port[0]):.3g}, "
          f"torch.stft's {rel(plain[1], plain[0]):.3g}; the port's against torch.stft's "
          f"{rel(port[0], plain[0]):.3g}")
    assert torch.equal(port[1], port[0])
    assert rel(port[0], plain[0]) <= 1e-5


# The plain-Vocos family at the vocos-mel-24khz width (C = 512, I = 1536),
# plain LayerNorm's weight and bias as the kernel's scale and shift: rows
# B * T = 564 and 285, neither a multiple of the 128-row tile.
@pytest.mark.parametrize("B,T", [(2, 282), (3, 95)])
def test_convnext_block_kernel_at_vocos_width(cuda, B, T):
    C, I = 512, 1536
    g = torch.Generator().manual_seed(B * T)
    f = lambda *s, sc=0.1: (torch.randn(*s, generator=g) * sc).to(cuda)
    x = f(B, T, C, sc=1.0)
    args = (x, f(7, C), f(C), 1 + f(C), f(C), f(C, I, sc=0.02).to(torch.bfloat16), f(I),
            f(I, C, sc=0.02).to(torch.bfloat16), f(C), f(C, sc=0.3))
    before = K.convnext_block.launches
    got = K.convnext_block(*args)
    torch.cuda.synchronize()
    assert K.convnext_block.launches == before + 1
    want = K.convnext_block_reference(*args)
    # Same bf16 operands and fp32 sums; only the summation order differs.
    assert float((got - want).abs().max() / (want - x).abs().max()) < 1e-2


def _vocos_mel_24khz():
    import os

    from wavtokenizer_tpu_torch.api.config import vocos_spec_from_config
    return vocos_spec_from_config(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "wavtokenizer_tpu_torch",
        "configs", "vocos_mel_24khz.yaml"))


def test_vocos_decode_launches_the_kernel_per_block(cuda):
    """A full-width vocos-mel-24khz decode on the card: 8 ConvNeXt-kernel
    launches (one a block), the waveform within 2e-2 of the CPU's (the
    same bf16-operand arithmetic in another order, as the codec's decode)."""
    from wavtokenizer_tpu_torch import Vocos, init_vocos
    spec = _vocos_mel_24khz()
    params = init_vocos(spec, seed=0)
    card, cpu = (Vocos.from_jax_params(params, spec, device=d) for d in (cuda, "cpu"))
    audio = torch.randn(2, 24000, generator=torch.Generator().manual_seed(0)) * 0.1
    feats = card.feature_extractor(audio)
    before = K.convnext_block.launches
    wave = card.decode(feats)
    torch.cuda.synchronize()
    assert K.convnext_block.launches - before == spec.backbone.num_layers == 8
    want = cpu.decode(feats.cpu())
    assert wave.shape == want.shape == (2, feats.shape[-1] * 256)
    assert float((wave.cpu() - want).abs().max() / want.abs().max()) < 2e-2


def test_crepe_and_utmos_card_match_cpu(cuda):
    """CREPE's salience and UTMOS's score on the card against the CPU, from
    seeded random state dicts, TF32 off (fp32 in other orders).  The random
    CREPE's salience is ~0.5 with an input-dependent part of ~2e-4, so its
    error is held to 1e-2 of that part (the largest deviation from each
    bin's mean over the frames; float32 against float64 reads ~2e-4 of it);
    UTMOS within rel 1e-4."""
    from wavtokenizer_tpu_torch.metrics import crepe, utmos
    sd = crepe.init_crepe_state_dict(seed=0)
    frames = crepe.frame_audio(np.random.default_rng(0).normal(size=8000).astype(np.float32))
    got = crepe.salience(crepe.crepe_params_from_torch(sd, cuda), frames)
    want = crepe.salience(crepe.crepe_params_from_torch(sd, "cpu"), frames)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want - want.mean(axis=0)).max()
    sd = utmos.init_utmos_state_dict(seed=0, cfg=utmos.UTMOSConfig(num_layers=2))
    wav = (np.random.default_rng(1).normal(size=(2, 16000)) * 0.1).astype(np.float32)
    got = utmos.utmos_score_from_params(utmos.utmos_params_from_torch(sd, cuda), wav)
    want = utmos.utmos_score_from_params(utmos.utmos_params_from_torch(sd, "cpu"), wav)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("B,n_fft,hop", [(8, 1024, 256), (2, 1024, 256), (8, 1280, 320)])
def test_istft_same_card_matches_cpu(cuda, B, n_fft, hop):
    """The ISTFT of a head's output, whose DC and Nyquist bins carry
    imaginary parts a real inverse ignores: the card (cuFFT) within 1e-5
    of the CPU (pocketfft).  Before the port zeroed them, cuFFT used them at
    (8, 1024): rel-max 3.4e-2."""
    from wavtokenizer_tpu_torch.ops.spectral import istft_same
    g = torch.Generator().manual_seed(B + n_fft)
    re, im = (torch.randn(B, 282, n_fft // 2 + 1, generator=g) for _ in range(2))
    want = istft_same(re, im, n_fft, hop)
    got = istft_same(re.to(cuda), im.to(cuda), n_fft, hop).cpu()
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


# ---------------------------------------------------------------------------
# The research layer: device resampling, the enhancement path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("orig", [44100, 16000, 48000])
def test_resample_card_matches_the_host_resampler(cuda, orig):
    from wavtokenizer_tpu_torch.ops.resample import resample
    from wavtokenizer_tpu_torch.utils.audio import resample_np
    x = (np.random.default_rng(orig).normal(size=(4, 2 * orig)) * 0.3).astype(np.float32)
    got = resample(torch.from_numpy(x).to(cuda), orig, 24000).cpu().numpy()
    want = np.stack([resample_np(row, orig, 24000) for row in x])
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


@pytest.fixture(scope="module")
def small320_np():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from wavtokenizer_tpu_torch import WavTokenizerSpec, init_wavtokenizer
    spec = WavTokenizerSpec()
    return spec, init_wavtokenizer(spec, seed=0, random_codebook=True)


@pytest.mark.parametrize("train", [False, True])
def test_enhanced_forward_launches_the_front_and_matches_cpu(small320_np, train):
    """Small-320 width, B = 2 x 1 s: one encoder_front launch, and the card
    within the limits chip_smoke.py [15] holds (features rel-max 1e-4,
    waveform 1e-3; TF32 off)."""
    from wavtokenizer_tpu_torch.checkpoint.convert import adapter_from_jax
    from wavtokenizer_tpu_torch.models.wavtokenizer import full_fp32
    from wavtokenizer_tpu_torch.research.adapter import (base_params_from_jax,
                                                         enhanced_forward, init_adapter)
    spec, params_np = small320_np
    audio = torch.from_numpy((np.random.default_rng(1).normal(size=(2, 24000)) * 0.1)
                             .astype(np.float32))
    adapter_np = init_adapter(seed=0)
    res = {}
    with full_fp32(), torch.no_grad():
        for dev in ("cpu", "cuda"):
            ap, st = adapter_from_jax(*adapter_np, dev)
            before = K.encoder_front.launches
            res[dev] = enhanced_forward(base_params_from_jax(params_np, spec.seanet, dev),
                                        spec.seanet, ap, st, audio.to(dev), train=train)
            torch.cuda.synchronize()
            if dev == "cuda":
                assert K.encoder_front.launches == before + 1
    rel = lambda a, b: float((a.cpu() - b).abs().max() / b.abs().max())
    assert rel(res["cuda"][2], res["cpu"][2]) <= 1e-4
    assert rel(res["cuda"][1], res["cpu"][1]) <= 1e-4
    assert rel(res["cuda"][0], res["cpu"][0]) <= 1e-3


@pytest.mark.parametrize("mode", ["waveform", "feature", "hybrid", "byol"])
def test_enhance_step_card_matches_cpu_in_float64(cuda, mode):
    """One step of a narrow model (n_filters 2, dimension 16; adapter 16 ->
    8; transformer 16) in float64 on the card and on the CPU from one state:
    the loss, the gradient norm and the parameters after the step agree to
    1e-6 (in float32 the step's gradient is ill-conditioned, see
    tests/test_torch_research.py)."""
    from wavtokenizer_tpu_torch import SEANetConfig, WavTokenizerSpec, init_wavtokenizer
    from wavtokenizer_tpu_torch.api.pretrained import seanet_from_jax
    from wavtokenizer_tpu_torch.checkpoint.convert import (adapter_from_jax,
                                                           inpath_transformer_from_jax)
    from wavtokenizer_tpu_torch.models.seanet import decoder_layer_specs, encoder_layer_specs
    from wavtokenizer_tpu_torch.research import enhance as E
    from wavtokenizer_tpu_torch.research.adapter import (AdapterConfig,
                                                         InPathTransformerConfig, init_adapter,
                                                         init_inpath_transformer)
    from wavtokenizer_tpu_torch.train.step import tree_leaves, tree_map

    spec = WavTokenizerSpec(seanet=SEANetConfig(n_filters=2, dimension=16))
    p = init_wavtokenizer(spec, seed=0, random_codebook=True)
    tcfg = InPathTransformerConfig(dim=16, num_heads=2, num_layers=1, ffn=32)
    ecfg = E.EnhanceConfig(mode=mode, transformer_cfg=tcfg)
    rng = np.random.default_rng(2)
    noisy, clean = (torch.from_numpy(rng.normal(size=(2, 3200)) * s) for s in (0.3, 0.1))
    out = {}
    for dev in ("cpu", "cuda"):
        dbl = lambda tree: tree_map(lambda t: t.to(dev, torch.float64), tree)
        base = {"encoder": dbl(seanet_from_jax(p["encoder"], encoder_layer_specs(spec.seanet),
                                               "cpu", train=True)),
                "decoder": dbl(seanet_from_jax(p["decoder"], decoder_layer_specs(spec.seanet),
                                               "cpu", train=True))}
        ap, st = (dbl(t) for t in adapter_from_jax(*init_adapter(
            AdapterConfig(encoder_dim=16, hidden=8, num_residual_blocks=1), seed=1), "cpu"))
        tr = dbl(inpath_transformer_from_jax(init_inpath_transformer(tcfg, seed=2), "cpu")) \
            if mode == "byol" else None
        opt = E.make_enhance_optimizer(ap, base["decoder"], ecfg, tr)
        _, loss, g_norm = E.enhance_step(opt, ap, st, base["decoder"], base, noisy.to(dev),
                                         clean.to(dev), spec, ecfg, tr)
        out[dev] = (float(loss), float(g_norm),
                    [t.detach().cpu() for t in tree_leaves(E.enhance_trainable(
                        ap, base["decoder"], ecfg, tr))])
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-6 * abs(out["cpu"][0])
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-6 * abs(out["cpu"][1])
    for a, b in zip(out["cuda"][2], out["cpu"][2], strict=True):
        assert float((a - b).abs().max()) <= 1e-6


def _tiny_train_spec():
    from wavtokenizer_tpu_torch import (ISTFTHeadConfig, SEANetConfig, VQConfig,
                                        VocosBackboneConfig, WavTokenizerSpec)

    return WavTokenizerSpec(
        seanet=SEANetConfig(dimension=16, n_filters=2, ratios=(8, 5, 4, 2)),
        vq=VQConfig(dimension=16, bins=32, kmeans_iters=2),
        backbone=VocosBackboneConfig(input_channels=16, dim=32, intermediate_dim=64,
                                     num_layers=1, adanorm_num_embeddings=4),
        head=ISTFTHeadConfig(dim=32, n_fft=1280, hop_length=320))


@pytest.mark.parametrize("remat_disc", [True, "store_dac"])
def test_remat_changes_no_gradient_on_the_card(cuda, remat_disc):
    """Remat on against off on the card (fp32, TF32 off), dropout 0.1 drawn
    from CUDA generators, which the recompute must replay: phase by phase
    (the generator phase over the same, updated discriminators, since AdamW
    turns rounding-level gradient differences into updates of up to the
    learning rate), every loss and the gradient norm within 2e-4 relative,
    both phases' gradients within 1e-2 (the recompute's rounding moves the
    terms on a kink; a fresh dropout mask moves them by ~0.5); the VQ
    kernel's launches unchanged."""
    from wavtokenizer_tpu_torch.models.wavtokenizer import full_fp32
    from wavtokenizer_tpu_torch.train import step as S

    spec = _tiny_train_spec()
    audio = torch.from_numpy((np.random.default_rng(0).normal(size=(2, 38 * 320)) * 0.1)
                             .astype(np.float32)).to(cuda)
    runs = []
    with full_fp32():
        for remat in (False, True):
            tcfg = S.TrainConfig(max_steps=1000, disc_channels_scale=0.0625, pos_dropout=0.1,
                                 remat=remat, remat_disc=remat_disc)
            st = S.create_train_state(spec, tcfg, seed=0, device=cuda)
            K.reset_launch_counts()
            g = torch.Generator().manual_seed(0)
            drop_d, drop_g = S._dropout_generators(g, cuda)
            vq, m = S.discriminator_phase(st, audio, spec, tcfg, 1, 1, g, drop_d)
            runs.append({"st": st, "tcfg": tcfg, "g": g, "drop_g": drop_g, "vq": vq, "m": m,
                         "launches": K.vq_nearest.launches,
                         "grads": [p.grad.clone()
                                   for p in st["opt_disc"].param_groups[0]["params"]]})
        with torch.no_grad():
            for x, y in zip(S.tree_leaves(runs[0]["st"]["disc"]),
                            S.tree_leaves(runs[1]["st"]["disc"])):
                y.copy_(x)
        for r in runs:
            K.reset_launch_counts()
            r["m"].update(S.generator_phase(r["st"], r["vq"], audio, spec, r["tcfg"], 1, 1,
                                            r["g"], r["drop_g"], with_grad_norm=True))
            r["grads"] += [p.grad.clone() for p in r["st"]["opt_gen"].param_groups[0]["params"]]
            r["launches"] += K.vq_nearest.launches
    torch.cuda.synchronize()
    a, b = runs
    assert a["launches"] == b["launches"] == spec.vq.kmeans_iters + 2
    for k, v in a["m"].items():
        got, want = float(b["m"][k].detach()), float(v.detach())
        assert abs(got - want) <= 2e-4 * abs(want), k
    ga, gb = (torch.cat([t.reshape(-1) for t in r["grads"]]) for r in runs)
    assert float((ga - gb).norm()) <= 1e-2 * float(ga.norm())


def test_bf16_training_step_on_the_card(cuda):
    """Both bf16 compute types at a tiny width: finite fp32 losses and
    gradients, the same codes as the fp32 step (the encoder and VQ are not
    cast), 2 VQ launches a step after the first."""
    import dataclasses

    from wavtokenizer_tpu_torch.train import step as S

    spec = _tiny_train_spec()
    base_cfg = S.TrainConfig(max_steps=1000, disc_channels_scale=0.0625)
    audio = torch.from_numpy((np.random.default_rng(1).normal(size=(2, 38 * 320)) * 0.1)
                             .astype(np.float32)).to(cuda)
    for over in ({}, {"disc_compute_dtype": "bfloat16"},
                 {"disc_compute_dtype": "bfloat16", "gen_compute_dtype": "bfloat16"}):
        tcfg = dataclasses.replace(base_cfg, **over)
        st = S.create_train_state(spec, tcfg, seed=0, device=cuda)
        for step in range(2):
            K.reset_launch_counts()
            _, m = S.train_step(st, audio, spec, tcfg, torch.Generator().manual_seed(step),
                                with_grad_norm=True)
        torch.cuda.synchronize()
        assert K.vq_nearest.launches == 2
        assert all(v.dtype == torch.float32 and bool(torch.isfinite(v)) for v in m.values())
        assert all(p.grad.dtype == torch.float32 for p in st["opt_gen"].param_groups[0]["params"])


def test_stage_flops_same_with_kernels_and_plain_versions(cuda, monkeypatch):
    from wavtokenizer_tpu_torch import WavTokenizer, init_wavtokenizer
    from wavtokenizer_tpu_torch.models import vocos as vocos_mod
    from wavtokenizer_tpu_torch.ops import vq as vq_mod
    from wavtokenizer_tpu_torch.utils.profiling import pipeline_stages, stage_flops

    spec = _tiny_train_spec()
    model = WavTokenizer.from_jax_params(init_wavtokenizer(spec, seed=0, random_codebook=True),
                                         spec, device=cuda)
    audio = (torch.randn(2, 24000, generator=torch.Generator().manual_seed(3)) * 0.1).to(cuda)
    stages = pipeline_stages(model.params, spec, audio)
    with_kernels = stage_flops(stages)
    assert K.vq_nearest.flops > 0 or K.convnext_block.flops > 0     # the roundtrip's launches
    monkeypatch.setattr(vq_mod, "vq_nearest", lambda *a: K.vq_nearest_reference(*a[:3]))
    monkeypatch.setattr(vocos_mod, "convnext_block_kernel",
                        lambda *a: K.convnext_block_reference(*a[:10]))
    assert stage_flops(stages) == with_kernels


def test_msstft_discriminator_card_matches_cpu(cuda):
    from wavtokenizer_tpu_torch.train.discriminators import (init_msstft_discriminator,
                                                             msstft_discriminator)
    from wavtokenizer_tpu_torch.train.step import tree_map

    params = init_msstft_discriminator(seed=0, filters=8)
    x = torch.randn(2, 8000, generator=torch.Generator().manual_seed(4)) * 0.1
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = msstft_discriminator(params, x)
            got = msstft_discriminator(tree_map(lambda t: t.to(cuda), params), x.to(cuda))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for g, w in zip(got[0] + sum(got[1], []), want[0] + sum(want[1], []), strict=True):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_nccl_world_of_one_all_reduces_and_gathers(cuda):
    """An in-process NCCL group of one rank (TCP rendezvous on a free port):
    the mesh's flat-buffer all-reduce and gather run through NCCL and leave
    a world of one's tensors as they were."""
    import socket

    import torch.distributed as dist

    from wavtokenizer_tpu_torch.parallel import mesh as M

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    M.init_distributed("nccl", "cuda:0", f"tcp://127.0.0.1:{port}", 0, 1)
    try:
        mesh = M.make_mesh(1, "cuda:0")
        assert dist.get_backend(mesh.data_group) == "nccl"
        a = torch.randn(5, 3, device=cuda)
        b = torch.randn(7, device=cuda, dtype=torch.float64)
        want = (a.clone(), b.clone())
        before = dict(M.COLLECTIVES)
        M.all_reduce_mean([a, b], mesh.data_group)
        gathered = M.all_gather(a, mesh.data_group)
        torch.cuda.synchronize()
        assert torch.equal(a, want[0]) and torch.equal(b, want[1])
        assert torch.equal(gathered, a)
        # One all-reduce per dtype, one gather.
        assert M.COLLECTIVES["all_reduce"] - before.get("all_reduce", 0) == 2
        assert M.COLLECTIVES["all_gather"] - before.get("all_gather", 0) == 1
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shards", [2, 3])
def test_convnext_kernel_tp_shards_sum_to_the_block(cuda, shards):
    """The kernel launched on each slice of the hidden width (I = 384 in 2
    or 3 slices of 192 or 128; the ranks after the first given zeros for the
    residual and b2) sums to the whole kernel's block and to the plain one."""
    B, T, C, I = 2, 75, 128, 384
    g = torch.Generator().manual_seed(7)
    f = lambda *s, sc=0.1: (torch.randn(*s, generator=g) * sc).to(cuda)
    x, dw, dwb, scale, shift = f(B, T, C, sc=1.0), f(7, C), f(C), 1 + f(C), f(C)
    w1, b1 = f(C, I, sc=0.05).to(torch.bfloat16), f(I)
    w2, b2, gamma = f(I, C, sc=0.05).to(torch.bfloat16), f(C), f(C, sc=0.3)
    whole = K.convnext_block(x, dw, dwb, scale, shift, w1, b1, w2, b2, gamma)
    want = K.convnext_block_reference(x, dw, dwb, scale, shift, w1, b1, w2, b2, gamma)
    w = I // shards
    before = K.convnext_block.launches
    parts = []
    for r in range(shards):
        cols = slice(r * w, (r + 1) * w)
        parts.append(K.convnext_block(
            x, dw, dwb, scale, shift, w1[:, cols].contiguous(), b1[cols].contiguous(),
            w2[cols].contiguous(), b2 if r == 0 else torch.zeros_like(b2), gamma,
            residual=None if r == 0 else torch.zeros_like(x)))
    got = sum(parts)
    torch.cuda.synchronize()
    assert K.convnext_block.launches == before + shards
    scale_ = float((want - x).abs().max())
    assert float((got - whole).abs().max()) / scale_ < 1e-2
    assert float((got - want).abs().max()) / scale_ < 1e-2


def test_dp_engine_launches_every_kernel_in_both_replicas_on_one_card(cuda):
    """ServingEngine(devices=["cuda:0", "cuda:0"]): a batch split over two
    replicas launches the VQ and ConvNeXt kernels once in each, and answers
    what the direct calls give."""
    from wavtokenizer_tpu_torch import (ISTFTHeadConfig, SEANetConfig, VQConfig,
                                        VocosBackboneConfig, WavTokenizer, WavTokenizerSpec,
                                        init_wavtokenizer)
    from wavtokenizer_tpu_torch.api.engine import EngineConfig, ServingEngine

    spec = WavTokenizerSpec(
        seanet=SEANetConfig(dimension=32, n_filters=2, ratios=(8, 5, 4, 2)),
        vq=VQConfig(dimension=32, bins=64),
        backbone=VocosBackboneConfig(input_channels=32, dim=64, intermediate_dim=128,
                                     num_layers=2, adanorm_num_embeddings=4),
        head=ISTFTHeadConfig(dim=64, n_fft=1280, hop_length=320))
    wt = WavTokenizer.from_jax_params(init_wavtokenizer(spec, seed=0, random_codebook=True),
                                      spec, "cuda:0")
    audio = (np.random.default_rng(2).normal(size=(4, 8000)) * 0.1).astype(np.float32)
    _, codes = wt.encode_infer(audio)
    direct = wt.decode(wt.codes_to_features(codes), 0).cpu().numpy()
    eng = ServingEngine(wt, EngineConfig(batch_sizes=(4,), clip_seconds=(8000 / 24000,)),
                        devices=["cuda:0", "cuda:0"])
    try:
        K.reset_launch_counts()
        got_codes = eng._run_encode(audio)[1]
        wave = eng._run_detok(got_codes[0])
        torch.cuda.synchronize()
        assert K.vq_nearest.launches == 2
        assert K.convnext_block.launches == 2 * spec.backbone.num_layers
    finally:
        eng.close()
    np.testing.assert_array_equal(got_codes, codes.cpu().numpy())
    assert np.abs(wave - direct).max() <= 2e-3 * np.abs(direct).max()
