"""The VQ kernel's 3xTF32 arithmetic (wavtokenizer_tpu_torch/csrc/vq_nearest.cu),
rehearsed on the CPU.

There is no interpret mode for CUDA, so this file emulates the kernel's
product in plain torch, over each row's nearest candidates: x split into a
TF32 head and tail with the kernel's integer rounding, the codebook from the
model's pack, and per 32-deep k-block the 8-deep products in the kernel's
order (lo.hi and hi.lo of each step, then hi.hi) added into one f32 sum,
each rounded as it is added (to nearest, or toward zero as tensor cores may
do); then |x|^2 in the kernel's order and the distance formula rounded op
by op.  The emulated codes are held against the JAX package's Pallas kernel
(interpret mode) and its plain path, against the committed golden tokens of
small-320, and on rows placed just beyond the near-tie tolerance, where a
product that drops one of its terms must fail the near-tie rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels import assert_codes_agree
from wavtokenizer_tpu.ops.kernels import vq_nearest_fused
from wavtokenizer_tpu.ops.vq import nearest_codebook_indices
from wavtokenizer_tpu_torch.ops import kernels as K

BK, KS = 32, 8    # the kernel's k-block and wgmma depth


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the emulation is many small ops, which other test
    processes on the same cores slow down by an order of magnitude when
    each op spreads over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _round_f32(s: torch.Tensor, rounding: str) -> torch.Tensor:
    """float64 -> the f32 value (kept in float64), to nearest or toward zero."""
    f = s.float()
    if rounding == "rz":
        over = f.double().abs() > s.abs()
        f = torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)
    return f.double()


def _kernel_xsq(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 in the kernel's order: lane t of a quad sums columns 8 s + t and
    8 s + 4 + t of every 8-deep step s in sequence, then (l0 + l1) + (l2 + l3)."""
    xx = x * x
    lanes = []
    for t in range(4):
        s = torch.zeros(x.shape[0], dtype=torch.float32)
        for k0 in range(0, x.shape[1], KS):
            s = s + xx[:, k0 + t]
            s = s + xx[:, k0 + 4 + t]
        lanes.append(s)
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def emulate_codes(x: torch.Tensor, embed: torch.Tensor, rounding: str = "rn",
                  k: int = 8, terms: tuple = ("lo.hi", "hi.lo", "hi.hi")) -> tuple:
    """The kernel's codes for x (N, D), embed (C, D), emulated on the CPU; the
    largest error of an emulated distance and the smallest gap between a
    row's two nearest codes, both relative to the row's nearest distance.

    Only each row's k nearest codes are emulated: the rest lie more than
    1e-4 relative farther (asserted), far beyond the ~1e-6 that the
    emulated arithmetic can move a distance, so none of them can win.
    ``terms`` names the products summed (x.hi/x.lo against the codebook's
    hi/lo); a product that leaves one out may err by ~1e-4, and then the
    codes are not the kernel's, but a row whose nearest code loses among
    the candidates would lose among all codes too."""
    N, D = x.shape
    C = embed.shape[0]
    k = min(k, C)
    # Candidates by an fp32 search, then their exact distances in float64.
    d32 = (x * x).sum(1, keepdim=True) - 2 * x @ embed.t() + (embed * embed).sum(1)
    near = d32.topk(min(k + 1, C), dim=1, largest=False).indices
    exact = ((x.double()[:, None, :] - embed.double()[near]) ** 2).sum(-1)
    exact, order = exact.sort(dim=1)
    near = near.gather(1, order)
    best = exact[:, 0]
    gap = float(((exact[:, 1] - best) / best).min()) if C > 1 else float("inf")
    if k < C:
        assert bool((exact[:, k] - best > 1e-4 * best).all())
    cand, pos = near[:, :k].sort(dim=1)              # lowest index first on ties
    exact = exact[:, :k].gather(1, pos)
    pad = (-D) % BK
    xp = torch.nn.functional.pad(x.float(), (0, pad))
    pack = torch.nn.functional.pad(K.pack_vq_codebook(embed), (0, pad))
    xh = K._tf32_round(xp)
    xl = K._tf32_round(xp - xh)
    xh, xl = xh[:, None, :], xl[:, None, :]
    eh, el = pack[0][cand], pack[1][cand]            # (N, k, D), exact TF32 values
    acc = torch.zeros(N, k, dtype=torch.float64)     # f32 values
    for k0 in range(0, D + pad, BK):
        small = [(xl, eh) for t in terms if t == "lo.hi"] + [(xh, el) for t in terms if t == "hi.lo"]
        steps = [(a, b, s) for s in range(4) for a, b in small]
        steps += [(xh, eh, s) for s in range(4) if "hi.hi" in terms]
        for a, b, s in steps:
            j = slice(k0 + KS * s, k0 + KS * (s + 1))
            prod = (a[..., j].double() * b[..., j].double()).sum(-1)
            acc = _round_f32(acc + prod, rounding)
    esq = (embed * embed).sum(1)[cand]
    dist = -((_kernel_xsq(xp)[:, None] - 2.0 * acc.float()) + esq)
    err = float(((-dist.double() - exact).abs().max(1).values / best).max())
    return cand.gather(1, dist.argmax(1, keepdim=True))[:, 0].to(torch.int32), err, gap


def test_pack_splits_into_tf32_head_and_tail():
    rng = np.random.default_rng(5)
    e = torch.from_numpy((rng.normal(size=(64, 96)) * 10.0 ** rng.integers(-3, 3, (64, 1)))
                         .astype(np.float32))
    pack = K.pack_vq_codebook(e)
    assert pack.shape == (2, 64, 96) and pack.dtype == torch.float32
    for part in pack:   # at most 10 mantissa bits: the 13 low bits are clear
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    e64 = e.double()
    err = (pack[0].double() + pack[1].double() - e64).abs()
    assert bool((err <= 2.0 ** -21 * e64.abs()).all()), float((err / e64.abs()).max())
    assert bool((pack[0].double() - e64).abs().le(2.0 ** -11 * e64.abs()).all())


def test_model_build_packs_the_codebook():
    from test_torch_slice import _small_specs
    from wavtokenizer_tpu_torch import WavTokenizer, init_wavtokenizer
    tspec, _ = _small_specs()
    wt = WavTokenizer.from_jax_params(init_wavtokenizer(tspec, seed=3, random_codebook=True),
                                      tspec, device="cpu")
    q = wt.params["quantizer"]
    assert q["pack"].shape == (1, 2) + tuple(q["embed"].shape[1:])
    assert torch.equal(q["pack"][0], K.pack_vq_codebook(q["embed"][0]))


@pytest.mark.parametrize("n,d,c", [(300, 512, 4096), (77, 40, 100), (200, 64, 256)])
@pytest.mark.parametrize("rounding", ["rn", "rz"])
@pytest.mark.usefixtures("one_thread")
def test_emulated_codes_match_jax(n, d, c, rounding):
    rng = np.random.default_rng(n + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    embed = rng.normal(size=(c, d)).astype(np.float32)
    # Exact ties on purpose: eight codes repeated, which every version must
    # resolve to the lower index.
    embed[c // 2:c // 2 + 8] = embed[:8]
    got = emulate_codes(torch.from_numpy(x), torch.from_numpy(embed), rounding)[0].numpy()
    fused = vq_nearest_fused(jnp.asarray(x), jnp.asarray(embed), interpret=True)
    plain = nearest_codebook_indices(jnp.asarray(x), jnp.asarray(embed), fused=False)
    assert_codes_agree(x, embed, got, fused)
    assert_codes_agree(x, embed, got, plain)


@pytest.fixture(scope="module")
def small320():
    from wavtokenizer_tpu_torch import WavTokenizer, init_wavtokenizer
    from wavtokenizer_tpu_torch.utils.golden import golden_specs
    spec = golden_specs()["small320"]
    model = WavTokenizer.from_jax_params(init_wavtokenizer(spec, seed=0, random_codebook=True),
                                         spec, device="cpu")
    return spec, model


@pytest.mark.usefixtures("one_thread")
def test_emulated_codes_of_the_small320_golden_clip_equal_the_golden_tokens(small320):
    from wavtokenizer_tpu_torch.models import seanet
    from wavtokenizer_tpu_torch.utils.golden import golden_clip, load_golden
    spec, model = small320
    with torch.inference_mode():
        emb = seanet.seanet_encode(model.params["encoder"], spec.seanet,
                                   torch.as_tensor(golden_clip(spec))[:, :, None])
    x = emb.reshape(-1, emb.shape[-1])
    embed = model.params["quantizer"]["embed"][0]
    want = load_golden()["small320"].reshape(-1)
    for rounding in ("rn", "rz"):
        got, err, gap = emulate_codes(x, embed, rounding)
        flips = int((got.numpy() != want).sum())
        print(f"small320 golden, 3xTF32 emulated ({rounding}): {flips} of {want.size} ids "
              f"differ; largest distance error {err:.3g} and smallest gap between a row's "
              f"two nearest codes {gap:.3g}, both relative to the nearest distance")
        assert flips == 0 and err < 1e-5


ALL_THREE = ("lo.hi", "hi.lo", "hi.hi")


@pytest.fixture(scope="module")
def near_ties(small320):
    """600 rows of small-320's codebook whose two nearest codes lie just
    beyond the near-tie tolerance, and the JAX Pallas kernel's codes."""
    from wavtokenizer_tpu_torch.utils.golden import near_tie_rows, nearest_two
    embed = small320[1].params["quantizer"]["embed"][0]
    x = near_tie_rows(embed, 600)
    idx, d = nearest_two(x, embed)
    assert float(((d[:, 1] - d[:, 0]) / d[:, 0]).min()) > 1e-5
    assert len(set(idx[:, 0].tolist())) > 500
    fused = vq_nearest_fused(jnp.asarray(x.numpy()), jnp.asarray(embed.numpy()), interpret=True)
    assert_codes_agree(x.numpy(), embed.numpy(), np.asarray(fused), idx[:, 0].int().numpy())
    return x, embed, np.asarray(fused)


@pytest.mark.parametrize("terms", [ALL_THREE, ("hi.lo", "hi.hi"), ("lo.hi", "hi.hi"), ("hi.hi",)],
                         ids=["3xTF32", "x_tail_dropped", "codebook_tail_dropped", "1xTF32"])
@pytest.mark.usefixtures("one_thread")
def test_near_tie_rows_tell_a_dropped_product_term_apart(near_ties, terms):
    """The golden ids are one code, so they pass a product that drops a
    TF32 tail (``x`` = x.hi + x.lo, ``codebook`` = hi + lo).  The near-tie
    rows do not: every product that drops one fails the near-tie rule
    there, and the kernel's three products pass it with every row right,
    as chip_smoke.py's [6 resolution] holds the kernel on the card."""
    x, embed, fused = near_ties
    for rounding in ("rn", "rz"):
        got = emulate_codes(x, embed, rounding, terms=terms)[0].numpy()
        if terms == ALL_THREE:
            assert np.array_equal(got, fused)
        else:
            with pytest.raises(AssertionError):
                assert_codes_agree(x.numpy(), embed.numpy(), got, fused)
