"""Overlap-add of decoded segments.

Port of ``wavtokenizer_tpu/ops/resample.py::linear_overlap_add`` (ref
encoder/utils.py:17-56), used by the segmented EnCodec decode
(``models/encodec.py``).  The triangular weights are numpy f32, taken from
``linspace`` over the FIRST frame's length, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch


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
