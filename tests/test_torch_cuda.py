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
    and the generator phase's forward), then 2 a step."""
    from wavtokenizer_tpu_torch.train.step import create_train_state, train_step

    spec, tcfg = _tiny_training()
    state = create_train_state(spec, tcfg, seed=0, device=cuda)
    audio = (torch.randn(2, 12160, generator=torch.Generator().manual_seed(1)) * 0.1).to(cuda)
    counts = []
    for step in range(3):
        before = K.vq_nearest.launches
        state, m = train_step(state, audio, spec, tcfg, torch.Generator().manual_seed(step))
        torch.cuda.synchronize()
        counts.append(K.vq_nearest.launches - before)
        assert all(bool(torch.isfinite(v)) for v in m.values())
    assert counts == [spec.vq.kmeans_iters + 2, 2, 2]


def test_train_step_card_matches_cpu(cuda):
    """Two steps from one state on the card and on the CPU, TF32 off: every
    metric within rel 1e-3 (fp32 in other orders, and the card's VQ search
    is the kernel).  The codebook is inited around the encoder's output so
    that its codes are well separated in fp32."""
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
    with full_fp32():
        for step in range(2):
            _, m_cpu = train_step(cpu, audio, spec, tcfg, torch.Generator().manual_seed(step),
                                  bandwidth_id=step + 1)
            _, m_card = train_step(card, audio.to(cuda), spec, tcfg,
                                   torch.Generator().manual_seed(step), bandwidth_id=step + 1)
            for k, v in m_cpu.items():
                assert abs(float(m_card[k]) - float(v)) <= 1e-3 * abs(float(v)), (step, k)
    for k in cpu["vq"]:
        want = cpu["vq"][k]
        assert float((card["vq"][k].cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())


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
