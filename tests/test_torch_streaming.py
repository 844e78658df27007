"""The port's long-audio path (``api/streaming.py``) against the JAX
package's on the CPU: chunking and the cross-fade on both their strided
fast paths and their general paths, the batch buckets, and chunked
tokenize / copy synthesis at a narrow spec.

Chunking and the overlap-add are copies and fp32 adds in the same order on
both sides: held to 1e-6 relative.  Waveforms carry the port's bf16 ConvNeXt
operands against JAX's fp32 default path: 1e-3 of the peak, as in
``tests/test_torch_slice.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import _small_params, _small_specs
from wavtokenizer_tpu.api import streaming as js
from wavtokenizer_tpu.api.pretrained import WavTokenizer as JWavTokenizer
from wavtokenizer_tpu_torch import WavTokenizer
from wavtokenizer_tpu_torch.api import streaming as ts

# (T, chunk, overlap): fast path (stride a multiple of the overlap), general
# path, a single chunk, an exact fit.
CASES = [(10000, 800, 0.25), (10000, 800, 0.3), (500, 800, 0.25), (2600, 800, 0.25),
         (7001, 1000, 0.5)]


@pytest.mark.parametrize("T,chunk,overlap", CASES)
def test_chunk_audio_and_crossfade_match_jax(T, chunk, overlap):
    y = np.random.default_rng(T).normal(size=T).astype(np.float32)
    want, stride_j, len_j = js.chunk_audio(jnp.asarray(y), chunk, overlap)
    got, stride, orig_len = ts.chunk_audio(y, chunk, overlap)
    assert (stride, orig_len) == (stride_j, len_j)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got2, _, _ = ts.chunk_audio(torch.from_numpy(y)[None], chunk, overlap)
    assert torch.equal(got2, got)

    chunks = np.random.default_rng(T + 1).normal(size=got.shape).astype(np.float32)
    want = np.asarray(js.crossfade_join(jnp.asarray(chunks), stride, orig_len))
    out = ts.crossfade_join(torch.from_numpy(chunks), stride, orig_len)
    assert out.shape == (T,)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-7)


def test_chunk_audio_refuses_several_streams():
    with pytest.raises(ValueError, match="single stream"):
        ts.chunk_audio(np.zeros((2, 100), np.float32), 40)


@pytest.mark.parametrize("n,cap", [(1, 128), (3, 128), (64, 128), (65, 128), (200, 128),
                                   (5, 4)])
def test_bucket_size_matches_jax(n, cap):
    assert ts._bucket_size(n, cap) == js._bucket_size(n, cap)


@pytest.fixture(scope="module")
def narrow():
    tspec, jspec = _small_specs()
    audio = (np.random.default_rng(11).normal(size=(2, 2048)) * 0.1).astype(np.float32)
    params = _small_params(jspec, 11, audio)
    return (WavTokenizer.from_jax_params(params, tspec, device="cpu"),
            JWavTokenizer(params, jspec))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_chunked_tokens_and_long_copy_synthesis_match_jax(narrow):
    wt, jwt = narrow
    y = (np.random.default_rng(12).normal(size=24000) * 0.1).astype(np.float32)
    feats, codes, stride, orig_len = ts.encode_infer_chunked(wt, y, chunk_seconds=0.1)
    jfeats, jcodes, jstride, jlen = js.encode_infer_chunked(jwt, y, chunk_seconds=0.1)
    assert (stride, orig_len) == (jstride, jlen) and codes.shape == (1, 13, 75)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=0, atol=1e-6)

    got = ts.reconstruct_long(wt, y, chunk_seconds=0.1)
    want = np.asarray(js.reconstruct_long(jwt, y, chunk_seconds=0.1))
    assert got.shape == want.shape == (24000,)
    assert _rel(got, want) < 1e-3


def test_reconstruct_long_batch_matches_per_stream(narrow):
    wt, _ = narrow
    rng = np.random.default_rng(13)
    audios = [(rng.normal(size=n) * 0.1).astype(np.float32) for n in (24000, 5000, 13337)]
    # 13 + 3 + 8 = 24 chunks: three full slices of 8, then one slice of 24
    # padded to a bucket of 32.
    for batch_size in (8, 32):
        outs = ts.reconstruct_long_batch(wt, audios, chunk_seconds=0.1,
                                         batch_size=batch_size)
        for y, out in zip(audios, outs):
            want = ts.reconstruct_long(wt, y, chunk_seconds=0.1)
            assert out.shape == (len(y),)
            # Same chunks, same cross-fade; only the batch the rows ride in
            # differs.
            np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0,
                                       atol=1e-5 * float(want.abs().max()))
