"""Resampling on the device, and the overlap-add of decoded segments.

Port of ``wavtokenizer_tpu/ops/resample.py``:

* ``resample`` / ``convert_audio`` (ref encoder/utils.py:79-92; torchaudio's
  ``Resample`` defaults: lowpass_filter_width=6, rolloff=0.99,
  sinc_interp_hann window).  The polyphase kernel bank is the host one of
  ``utils/audio.py::_sinc_resample_kernel`` (numpy, float64 like
  torchaudio), and the resample is ONE strided ``F.conv1d`` over it, run in
  true fp32 (``models/wavtokenizer.py::full_fp32``): it feeds the encoder.
* ``linear_overlap_add`` (ref encoder/utils.py:17-56), used by the
  segmented EnCodec decode (``models/encodec.py``).  The triangular weights
  are numpy f32, taken from ``linspace`` over the FIRST frame's length, as
  the reference does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..models.wavtokenizer import full_fp32
from ..utils.audio import _sinc_resample_kernel


def resample(x: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99) -> torch.Tensor:
    """Resample (L,), (B, L) or (B, C, L) waveforms along the last axis.
    Output length ceil(new * L / orig), as torchaudio's."""
    if orig_freq == new_freq:
        return x
    kern, width, orig, new = _sinc_resample_kernel(orig_freq, new_freq,
                                                   lowpass_filter_width, rolloff)
    weight = torch.from_numpy(np.ascontiguousarray(kern[:, 0, :].T)[:, None, :]).to(x.device)
    shape, length = x.shape[:-1], x.shape[-1]
    flat = F.pad(x.reshape(-1, 1, length), (width, width + orig))
    with full_fp32():
        y = F.conv1d(flat, weight, stride=orig)            # (N, new, frames)
    target_length = int(math.ceil(new * length / orig))
    y = y.transpose(1, 2).reshape(y.shape[0], -1)[:, :target_length]
    return y.reshape(*shape, target_length)


def convert_audio(wav: torch.Tensor, sr: int, target_sr: int,
                  target_channels: int) -> torch.Tensor:
    """Channel conversion, then ``resample``: wav (..., C, L) with C in {1, 2}
    (ref encoder/utils.py:79-92)."""
    if wav.dim() < 2:
        raise ValueError("Audio tensor must have at least 2 dimensions")
    channels = wav.shape[-2]
    if channels not in (1, 2):
        raise ValueError("Audio must be mono or stereo.")
    if target_channels == 1:
        wav = wav.mean(-2, keepdim=True)
    elif target_channels == 2 or channels == 1:
        wav = wav.expand(*wav.shape[:-2], target_channels, wav.shape[-1])
    else:
        raise RuntimeError(f"Impossible to convert from {channels} to {target_channels}")
    return resample(wav, sr, target_sr)


def linear_overlap_add(frames: list[torch.Tensor], stride: int) -> torch.Tensor:
    """Triangular-weighted overlap-add: frames (..., L_i), each ``stride``
    after the one before -> (..., stride * (n - 1) + L_last)."""
    if not frames:
        raise ValueError("linear_overlap_add needs at least one frame")
    first = frames[0]
    total_size = stride * (len(frames) - 1) + frames[-1].shape[-1]
    t = np.linspace(0, 1, first.shape[-1] + 2)[1:-1]
    weight = torch.from_numpy((0.5 - np.abs(t - 0.5)).astype(np.float32)).to(
        device=first.device, dtype=first.dtype)
    sum_weight = torch.zeros(total_size, dtype=first.dtype, device=first.device)
    out = torch.zeros(*first.shape[:-1], total_size, dtype=first.dtype,
                      device=first.device)
    for i, frame in enumerate(frames):
        fl, offset = frame.shape[-1], i * stride
        w = weight[:fl]
        out[..., offset:offset + fl] += w * frame
        sum_weight[offset:offset + fl] += w
    return out / sum_weight
