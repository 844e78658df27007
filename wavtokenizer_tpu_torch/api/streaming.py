"""Long audio: chunked encode/decode with an overlap cross-fade.

Port of ``wavtokenizer_tpu/api/streaming.py`` (ref tsne_inf.py:63-157: 3 s
segments, 25% overlap, linear fade-in/out; EnCodec's segmented overlap-add,
encoder/model.py:122-178).  All chunks of a stream (or of many streams) are
stacked along the batch axis and go through the model in shared calls; the
cross-fade is a weighted overlap-add on the model's device.  Chunks and the
overlap-add take strided slices where the overlap divides the stride (the
canonical 25%), and an index gather / per-chunk add otherwise; both give the
same numbers as the JAX functions.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def chunk_audio(audio, chunk_samples: int,
                overlap: float = 0.25) -> tuple[torch.Tensor, int, int]:
    """(T,) or (1, T) -> (chunks (num_chunks, chunk_samples), stride, orig_len).

    The tail chunk is zero-padded (trimmed after the decode)."""
    audio = torch.as_tensor(audio, dtype=torch.float32)
    if audio.dim() == 2:
        if audio.shape[0] != 1:
            raise ValueError("chunking expects a single stream")
        audio = audio[0]
    T = audio.shape[0]
    stride = int(chunk_samples * (1 - overlap))
    num_chunks = max(1, math.ceil(max(T - chunk_samples, 0) / stride) + 1)
    total = (num_chunks - 1) * stride + chunk_samples
    audio = F.pad(audio, (0, total - T))
    overlap_samples = chunk_samples - stride
    if num_chunks > 1 and overlap_samples > 0 and stride % overlap_samples == 0:
        # The stream as overlap-units: chunk i is units i*r .. i*r + r, so the
        # stack is r + 1 strided slices of the unit view.
        r = stride // overlap_samples
        units = audio.reshape(total // overlap_samples, overlap_samples)
        cols = [units[k:k + (num_chunks - 1) * r + 1:r] for k in range(r + 1)]
        return (torch.stack(cols, dim=1).reshape(num_chunks, chunk_samples),
                stride, T)
    idx = (torch.arange(num_chunks)[:, None] * stride
           + torch.arange(chunk_samples)[None, :]).to(audio.device)
    return audio[idx], stride, T


def crossfade_join(chunks: torch.Tensor, stride: int, orig_len: int) -> torch.Tensor:
    """Weighted overlap-add with a linear fade over each overlap (ref
    tsne_inf.py:95-123: no fade-in on the first chunk, no fade-out on the
    last, so the stream's ends pass unscaled).  (N, L) -> (orig_len,)."""
    N, L = chunks.shape
    overlap = L - stride
    ramp = np.linspace(0.0, 1.0, max(overlap, 1), dtype=np.float32)
    W = np.ones((N, L), np.float32)
    if overlap > 0:
        W[1:, :overlap] = ramp
        W[:-1, -overlap:] = ramp[::-1]
    total = (N - 1) * stride + L
    den = np.zeros(total, np.float32)
    for i in range(N):
        den[i * stride:i * stride + L] += W[i]
    dev = chunks.device
    den = torch.from_numpy(np.maximum(den, 1e-8)).to(dev)
    weighted = chunks * torch.from_numpy(W).to(dev)
    if N > 1 and overlap > 0 and stride % overlap == 0:
        # Output unit j receives only chunks i*r + k (k <= r): r + 1 strided
        # adds of (N, u) blocks.
        r, u = stride // overlap, overlap
        wu = weighted.reshape(N, r + 1, u)
        out = torch.zeros((total // u, u), dtype=torch.float32, device=dev)
        for k in range(r + 1):
            out[k:k + (N - 1) * r + 1:r] += wu[:, k]
        return (out.reshape(total) / den)[:orig_len]
    out = torch.zeros(total, dtype=torch.float32, device=dev)
    for i in range(N):
        out[i * stride:i * stride + L] += weighted[i]
    return (out / den)[:orig_len]


def encode_infer_chunked(wt, audio, chunk_seconds: float = 3.0,
                         overlap: float = 0.25, bandwidth_id=0):
    """Tokenize long audio in one batched call: (features (N, D, T'),
    codes (1, N, T'), stride, orig_len), tokens per chunk."""
    chunk_samples = int(chunk_seconds * wt.spec.sample_rate)
    audio = torch.as_tensor(audio, dtype=torch.float32, device=wt.device)
    chunks, stride, orig_len = chunk_audio(audio, chunk_samples, overlap)
    features, codes = wt.encode_infer(chunks, bandwidth_id=bandwidth_id)
    return features, codes, stride, orig_len


def _bucket_size(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped: at most log2(cap) batch shapes,
    padding under 2x."""
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


def reconstruct_long_batch(wt, audios, chunk_seconds: float = 3.0,
                           overlap: float = 0.25, bandwidth_id=0,
                           batch_size: int = 128) -> list:
    """Long-form copy synthesis of many streams in shared model calls.

    The chunks of all streams are concatenated along the batch axis and go
    through encode + decode in power-of-two-bucketed slices of up to
    ``batch_size``; each stream is then cross-faded as in
    :func:`reconstruct_long`.  ``audios``: iterable of 1-D arrays or tensors.
    Returns the reconstructed waveforms (tensors on the model's device), in
    input order."""
    chunk_samples = int(chunk_seconds * wt.spec.sample_rate)
    metas, all_chunks = [], []
    for y in audios:
        y = torch.as_tensor(y, dtype=torch.float32, device=wt.device)
        chunks, stride, orig_len = chunk_audio(y, chunk_samples, overlap)
        metas.append((chunks.shape[0], stride, orig_len))
        all_chunks.append(chunks)
    cat = torch.cat(all_chunks, dim=0)
    N = cat.shape[0]
    outs, pos = [], 0
    while pos < N:
        take = min(batch_size, N - pos)
        sl = F.pad(cat[pos:pos + take], (0, 0, 0, _bucket_size(take, batch_size) - take))
        features, _ = wt.encode_infer(sl, bandwidth_id=bandwidth_id)
        decoded = wt.decode(features, bandwidth_id=bandwidth_id)
        outs.append(decoded[:take, :chunk_samples])
        pos += take
    dec_all = torch.cat(outs, dim=0)
    res, pos = [], 0
    for n, stride, orig_len in metas:
        res.append(crossfade_join(dec_all[pos:pos + n], stride, orig_len))
        pos += n
    return res


def reconstruct_long(wt, audio, chunk_seconds: float = 3.0,
                     overlap: float = 0.25, bandwidth_id=0) -> torch.Tensor:
    """Long-form copy synthesis: chunk -> one batched encode/decode ->
    cross-fade.  Each chunk's decode (ceil(chunk/hop)*hop samples) is trimmed
    to the chunk length before the cross-fade."""
    chunk_samples = int(chunk_seconds * wt.spec.sample_rate)
    audio = torch.as_tensor(audio, dtype=torch.float32, device=wt.device)
    chunks, stride, orig_len = chunk_audio(audio, chunk_samples, overlap)
    features, _ = wt.encode_infer(chunks, bandwidth_id=bandwidth_id)
    decoded = wt.decode(features, bandwidth_id=bandwidth_id)
    return crossfade_join(decoded[:, :chunk_samples], stride, orig_len)
