"""The port's SEANet encoder front (layers 0-6 of small-320) against the JAX
package on the CPU: the kernel's plain version against JAX's plain front and
its Pallas kernel (interpret mode), the geometry gate, and the dispatch from
``seanet_encode``.  The CUDA kernel itself is held against the plain version
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Inputs are drawn from numpy seeds at the full front widths (1 -> 32 -> 64 ->
128 channels).  Tolerance 1e-5 absolute, as the JAX package holds its fused
and plain fronts: fp32 on both sides, other summation orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavtokenizer_tpu.models import seanet as js
from wavtokenizer_tpu.models.init import init_seanet
from wavtokenizer_tpu.ops import encoder_front as jef
from wavtokenizer_tpu_torch import WavTokenizer, WavTokenizerSpec, init_wavtokenizer
from wavtokenizer_tpu_torch.api.pretrained import seanet_from_jax
from wavtokenizer_tpu_torch.models import seanet as ts
from wavtokenizer_tpu_torch.ops import encoder_front as tef
from wavtokenizer_tpu_torch.ops import kernels as K


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test run's parallel workers share the cores,
    and PyTorch's default pool (a thread per core) in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _front(cfg_kw: dict | None = None, seed: int = 0):
    """(JAX params, JAX specs, port params, port specs) of one encoder."""
    kw = cfg_kw or {}
    jcfg, tcfg = js.SEANetConfig(**kw), ts.SEANetConfig(**kw)
    params = init_seanet(np.random.default_rng(seed), jcfg, encoder=True)
    tspecs = ts.encoder_layer_specs(tcfg)
    return params, js.encoder_layer_specs(jcfg), seanet_from_jax(params, tspecs, "cpu"), tspecs


@pytest.fixture(scope="module")
def small320():
    return _front()


def _audio(B, T, seed):
    return (np.random.default_rng(seed).normal(size=(B, T, 1)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("T", [1024, 2048, 6144])
def test_front_reference_matches_jax_plain_front(small320, T):
    params, specs, tparams, tspecs = small320
    audio = _audio(2, T, T)
    want = np.asarray(js._plain_front(params, specs, jnp.asarray(audio)))
    got = K.encoder_front_reference(torch.from_numpy(audio), tparams, tspecs)
    assert got.shape == want.shape == (2, T // 8, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_front_reference_matches_jax_pallas_kernel(small320):
    """The JAX kernel as its own tests run it on the CPU: interpret mode,
    plain-path edge splice; two blocks, the second one partial."""
    params, specs, tparams, tspecs = small320
    audio = _audio(1, 3072, 7)
    want = np.asarray(jef.encoder_front_fused(params, specs, jnp.asarray(audio),
                                              block_n=256, interpret=True,
                                              edge_fn=js._plain_front))
    got = K.encoder_front(torch.from_numpy(audio), tparams, tspecs)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case,T", [
    ("small320", 72000), ("small320", 1024), ("small320", 72004),
    ("small320", 1016), ("small320", 512), ("small600", 72000),
    ("causal", 72000), ("true_skip", 72000)])
def test_geometry_gate_agrees_with_jax(case, T):
    kw = {"small320": {}, "small600": {"ratios": (6, 5, 5, 4)},
          "causal": {"causal": True}, "true_skip": {"true_skip": True}}[case]
    params, specs, tparams, tspecs = _front(kw)
    want = jef.front_geometry_matches(specs, params, T)
    assert tef.front_geometry_matches(tspecs, tparams, T) == want
    assert ("front" in tparams[0]) == (case == "small320")


def test_seanet_encode_runs_the_front_exactly_when_the_gate_admits(small320, monkeypatch):
    _, _, tparams, _ = small320
    cfg = ts.SEANetConfig()
    calls = []
    real = K.encoder_front

    def spy(audio, params, specs):
        calls.append(audio.shape[1])
        return real(audio, params, specs)

    monkeypatch.setattr(K, "encoder_front", spy)
    a = torch.from_numpy(_audio(1, 1032, 3))
    with torch.inference_mode():
        via_front = ts.seanet_encode(tparams, cfg, a)
        plain = ts.seanet_encode(tparams, cfg, a, front=False)
        ts.seanet_encode(tparams, cfg, a[:, :1028])        # T % 8 != 0
        ts.seanet_encode(tparams, cfg, a[:, :1016])        # T < 1024
    assert calls == [1032]
    # On the CPU the wrapper runs the plain layers: the same numbers.
    assert torch.equal(via_front, plain)


def test_front_wrapper_takes_no_other_device_and_no_card_means_an_error(small320,
                                                                        monkeypatch):
    _, _, tparams, tspecs = small320
    with pytest.raises(ValueError, match="device meta"):
        K.encoder_front(torch.zeros(1, 1024, 1, device="meta"), tparams, tspecs)
    # The entry points default to the card; without one they raise instead
    # of running on the CPU.
    spec = WavTokenizerSpec()
    with pytest.raises((RuntimeError, AssertionError)):
        WavTokenizer.from_jax_params(init_wavtokenizer(spec, seed=0), spec)
    # Without nvcc the kernels cannot be built: an error, not a fallback.
    monkeypatch.setattr(K, "_lib", None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.load_library()


def test_front_pack_layout(small320):
    """The packed operands hold each conv as (C_in, K, C_out) and the last
    conv as rows tap * 64 + c_in, in the kernel's order."""
    _, _, tparams, _ = small320
    pack = tparams[0]["front"]
    assert pack["a"].shape == (11664,) and pack["b"].shape == (12448,)
    w0 = tparams[0]["weight"]                                # (32, 1, 7)
    assert torch.equal(pack["a"][:224].reshape(1, 7, 32), w0.permute(1, 2, 0))
    assert torch.equal(pack["a"][224:256], tparams[0]["bias"])
    wd = tparams[6]["weight"]                                # (128, 64, 8)
    assert torch.equal(pack["wd"][3 * 64 + 5], wd[:, 5, 3])
    k3b = tparams[4]["block"][0]["weight"]                   # (32, 64, 3)
    assert torch.equal(pack["b"][:6144].reshape(64, 3, 32), k3b.permute(1, 2, 0))
