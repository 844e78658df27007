"""Device resampling, the low-pass tool's batch function and the general
overlap-add against the JAX package on the CPU.

* ``ops/resample.py::resample`` / ``convert_audio`` (one strided conv over
  the polyphase bank) against JAX's, at three rate pairs, on 1-D, 2-D and
  3-D inputs, and against the port's host ``resample_np``: 1e-5 absolute
  (fp32 sums in other orders over <= 2 * width + orig taps).
* ``tools/lowpass.py::lowpass_batch`` against JAX's: 1e-5 absolute.
* ``ops/spectral.py``'s ``istft_same`` / ``istft_center`` where n_fft is not
  a multiple of the hop (1000, 300): the general overlap-add (``F.fold``)
  against JAX's scatter-add, 1e-5 absolute.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavtokenizer_tpu.ops.resample import convert_audio as j_convert_audio
from wavtokenizer_tpu.ops.resample import resample as j_resample
from wavtokenizer_tpu.ops import spectral as jspec
from wavtokenizer_tpu_torch.ops import resample as tr
from wavtokenizer_tpu_torch.ops import spectral as tspec
from wavtokenizer_tpu_torch.tools import lowpass as tlow
from wavtokenizer_tpu_torch.utils.audio import resample_np

RATES = [(44100, 24000), (16000, 24000), (48000, 24000)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test run's parallel workers share the cores,
    and PyTorch's default pool (a thread per core) in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _audio(seed, shape):
    return (np.random.default_rng(seed).normal(size=shape) * 0.3).astype(np.float32)


def _jax_lowpass():
    """tools_tpu/lowpass.py, loaded by path (tools_tpu is not a package)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tools_tpu", "lowpass.py")
    spec = importlib.util.spec_from_file_location("_jax_lowpass_tool", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("orig,new", RATES)
@pytest.mark.parametrize("shape", [(4410,), (3, 4410), (2, 2, 4410)])
def test_resample_matches_jax(orig, new, shape):
    x = _audio(orig + len(shape), shape)
    got = tr.resample(torch.from_numpy(x), orig, new)
    want = np.asarray(j_resample(jnp.asarray(x), orig, new))
    assert got.shape == want.shape
    assert got.shape[-1] == -(-new * shape[-1] // orig)      # ceil, as torchaudio
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("orig,new", RATES)
def test_resample_matches_the_host_resampler(orig, new):
    x = _audio(orig, (2, 9000))
    got = tr.resample(torch.from_numpy(x), orig, new).numpy()
    for row, g in zip(x, got):
        np.testing.assert_allclose(g, resample_np(row, orig, new), rtol=0, atol=1e-5)


@pytest.mark.parametrize("channels,target", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_convert_audio_matches_jax(channels, target):
    x = _audio(channels * 10 + target, (2, channels, 4800))
    got = tr.convert_audio(torch.from_numpy(x), 48000, 24000, target)
    want = np.asarray(j_convert_audio(jnp.asarray(x), 48000, 24000, target))
    assert got.shape == want.shape == (2, target, 2400)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_convert_audio_refuses_what_jax_refuses():
    with pytest.raises(ValueError):
        tr.convert_audio(torch.zeros(4800), 48000, 24000, 1)
    with pytest.raises(ValueError):
        tr.convert_audio(torch.zeros(1, 3, 4800), 48000, 24000, 1)
    with pytest.raises(RuntimeError):
        tr.convert_audio(torch.zeros(1, 2, 4800), 48000, 24000, 3)


@pytest.mark.parametrize("cutoff", [4000.0, 1500.0])
def test_lowpass_batch_matches_jax(cutoff):
    x = _audio(int(cutoff), (2, 4 * tlow.HOP * 3))
    got = tlow.lowpass_batch(torch.from_numpy(x), 24000, cutoff).numpy()
    want = np.asarray(_jax_lowpass().lowpass_batch(jnp.asarray(x), 24000, cutoff))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # The energy above the cutoff falls below 1e-3 of the input's there, the
    # peak normalisation's gain (the in-band energy ratio) taken out
    # (measured 3.8e-4 to 7.5e-4: frame-wise masking leaks at frame edges).
    assert tlow.energy_above(got, x, 24000, cutoff) < 1e-3


@pytest.mark.parametrize("fn", ["istft_same", "istft_center"])
def test_istft_where_n_fft_is_not_a_multiple_of_the_hop(fn):
    n_fft, hop = 1000, 300
    rng = np.random.default_rng(3)
    re, im = (rng.normal(size=(2, 12, n_fft // 2 + 1)).astype(np.float32) for _ in range(2))
    got = getattr(tspec, fn)(torch.from_numpy(re), torch.from_numpy(im), n_fft, hop)
    want = np.asarray(getattr(jspec, fn)(jnp.asarray(re), jnp.asarray(im), n_fft, hop))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_overlap_add_general_path_equals_the_shifted_sum():
    """The fold path against the frame-by-frame sum, and the W % hop == 0
    path untouched."""
    frames = torch.from_numpy(_audio(4, (2, 7, 10)))
    for hop in (3, 5):
        want = torch.zeros(2, 6 * hop + 10)
        for t in range(7):
            want[:, t * hop:t * hop + 10] += frames[:, t]
        torch.testing.assert_close(tspec.overlap_add(frames, hop), want, rtol=0, atol=1e-6)
