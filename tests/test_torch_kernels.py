"""The PyTorch port's kernel modules (wavtokenizer_tpu_torch/ops/kernels.py)
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
themselves are held against the same plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavtokenizer_tpu.ops.kernels import convnext_block_fused, vq_nearest_fused
from wavtokenizer_tpu.ops.vq import nearest_codebook_indices
from wavtokenizer_tpu_torch.ops import kernels as K
from wavtokenizer_tpu_torch.utils.golden import max_flips


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test run's parallel workers share the cores,
    and PyTorch's default pool (a thread per core) in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_codes_agree(x, embed, got, want):
    """Equal codes, except near-ties: a differing id whose two distances,
    recomputed in float64, differ by under 1e-5 relative; at most
    max(2, N // 400) of those."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.int32
    bad = np.nonzero(got != want)[0]
    x64, e64 = np.asarray(x, np.float64), np.asarray(embed, np.float64)
    for n in bad:
        d_got = np.sum((x64[n] - e64[got[n]]) ** 2)
        d_want = np.sum((x64[n] - e64[want[n]]) ** 2)
        assert abs(d_got - d_want) <= 1e-5 * abs(d_want), (n, d_got, d_want)
    assert len(bad) <= max_flips(len(got)), len(bad)


@pytest.mark.parametrize("n,d,c,tile", [(1000, 64, 256, 256), (77, 32, 128, 64),
                                        (300, 512, 4096, 256)])
def test_vq_nearest_matches_jax(n, d, c, tile):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, d)).astype(np.float32)
    embed = rng.normal(size=(c, d)).astype(np.float32)
    got = K.vq_nearest(torch.from_numpy(x), torch.from_numpy(embed)).numpy()
    fused = vq_nearest_fused(jnp.asarray(x), jnp.asarray(embed), tile_n=tile,
                             interpret=True)
    plain = nearest_codebook_indices(jnp.asarray(x), jnp.asarray(embed), fused=False)
    assert_codes_agree(x, embed, got, fused)
    assert_codes_agree(x, embed, got, plain)


def _convnext_inputs(rng, adanorm):
    B, T, C, I = 3, 100, 128, 384
    f32 = lambda *s, scale=0.1: (rng.normal(size=s) * scale).astype(np.float32)
    if adanorm:   # an AdaLN row, as the backbone resolves it
        scale, shift = (1.0 + f32(4, C))[1], f32(4, C)[1]
    else:
        scale, shift = 1.0 + f32(C), f32(C)
    return dict(x=rng.normal(size=(B, T, C)).astype(np.float32), dw=f32(7, C),
                dwb=f32(C), scale=scale, shift=shift, w1=f32(C, I, scale=0.05),
                b1=f32(I), w2=f32(I, C, scale=0.05), b2=f32(C), gamma=f32(C, scale=0.3))


@pytest.mark.parametrize("adanorm", [False, True])
def test_convnext_block_matches_jax(adanorm):
    a = _convnext_inputs(np.random.default_rng(10 + adanorm), adanorm)
    want = np.asarray(convnext_block_fused(*[jnp.asarray(v) for v in a.values()],
                                           interpret=True))
    got = K.convnext_block(*[torch.from_numpy(v) for v in a.values()]).numpy()
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    # Both sides round the matmul operands to bf16 and sum in fp32; the
    # depthwise conv and the LayerNorm sum in other orders, which may move
    # a bf16 rounding by one step.
    assert rel < 2e-3, rel


def test_convnext_pack_layout():
    """The model packs each block's weights K-major for the kernel's GEMMs:
    w1t = w1^T (I, C) and w2t = w2^T (C, I), bf16 and contiguous, and the
    block gives the same output with or without the packed operands."""
    from test_torch_slice import _small_params, _small_specs
    from wavtokenizer_tpu_torch import WavTokenizer
    from wavtokenizer_tpu_torch.models import vocos
    tspec, jspec = _small_specs()
    audio = np.zeros((1, 2048), np.float32)
    wt = WavTokenizer.from_jax_params(_small_params(jspec, 3, audio), tspec, device="cpu")
    block = wt.params["backbone"]["convnext"][0]
    C, I = block["w1"].shape
    for name, w, shape in (("w1t", block["w1"], (I, C)), ("w2t", block["w2"], (C, I))):
        packed = block[name]
        assert packed.shape == shape and packed.dtype == torch.bfloat16
        assert packed.is_contiguous() and torch.equal(packed, w.t())
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 9, C)).astype(np.float32))
    plain = {k: v for k, v in block.items() if k not in ("w1t", "w2t")}
    torch.testing.assert_close(vocos.convnext_block(block, x, 0),
                               vocos.convnext_block(plain, x, 0), rtol=0, atol=0)


def test_wrappers_refuse_a_device_without_a_path():
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.vq_nearest(meta, torch.empty((16, 8), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        K.convnext_block(torch.empty((1, 4, 32), device="meta"), *[None] * 9)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(K, "_lib", None)
    monkeypatch.setattr(K, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        K.load_library()


def test_library_name_hashes_the_shared_header(monkeypatch, tmp_path):
    """A library is named by its source and every csrc/*.cuh, so an edit to
    the shared header rebuilds it instead of loading a stale one."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(K, "CSRC", str(tmp_path))
    before = K._so_path("k.cu")
    assert before == K._so_path("k.cu")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert K._so_path("k.cu") != before


def test_entry_points_default_to_cuda():
    from wavtokenizer_tpu_torch import WavTokenizer, WavTokenizerSpec
    model = WavTokenizer({}, WavTokenizerSpec())
    assert model.device.type == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    # No silent move to the CPU: without a card the call raises.
    with pytest.raises((RuntimeError, AssertionError)):
        model.encode_infer(np.zeros((1, 320), np.float32))


def test_plain_versions_count_no_launches():
    K.reset_launch_counts()
    rng = np.random.default_rng(11)
    K.vq_nearest(torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32)),
                 torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)))
    a = _convnext_inputs(rng, False)
    K.convnext_block(*[torch.from_numpy(v) for v in a.values()])
    assert K.vq_nearest.launches == 0 and K.convnext_block.launches == 0
