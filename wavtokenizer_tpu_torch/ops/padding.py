"""Exact "streamable" padding for 1-D convolutions.

Port of ``wavtokenizer_tpu/ops/padding.py`` (itself the padding math of the
reference EnCodec conv wrappers, encoder/modules/conv.py:54-105).  The
shape helpers are plain integer math; ``pad1d`` pads the LAST (time) axis of
a channel-first (B, C, T) tensor, PyTorch's conv layout; ``unpad1d`` trims
the time axis of a channel-last (B, T, C) tensor, as the JAX function does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def get_extra_padding_for_conv1d(length: int, kernel_size: int, stride: int,
                                 padding_total: int = 0) -> int:
    """Extra right padding so the last conv window is full."""
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (kernel_size - padding_total)
    return ideal_length - length


def pad1d(x: torch.Tensor, paddings: tuple[int, int],
          mode: str = "zero") -> torch.Tensor:
    """Pad the time axis of a (B, C, T) tensor.

    Reflect padding of an input no longer than the pad first appends zeros
    on the right, reflects, then trims them again, as the reference does
    (conv.py:79-96); torch's reflect pad would refuse such an input."""
    left, right = paddings
    if left < 0 or right < 0:
        raise ValueError(f"negative padding {paddings}")
    if mode == "reflect":
        length = x.shape[-1]
        max_pad = max(left, right)
        extra = 0
        if length <= max_pad:
            extra = max_pad - length + 1
            x = F.pad(x, (0, extra))
        padded = F.pad(x, (left, right), mode="reflect")
        return padded[..., :padded.shape[-1] - extra]
    if mode in ("zero", "constant"):
        return F.pad(x, (left, right))
    return F.pad(x, (left, right), mode=mode)


def sconv1d_paddings(length: int, kernel_size: int, stride: int, dilation: int,
                     causal: bool) -> tuple[int, int]:
    """(left, right) padding of the streamable conv (ref conv.py:195-210)."""
    k_eff = (kernel_size - 1) * dilation + 1
    padding_total = k_eff - stride
    extra = get_extra_padding_for_conv1d(length, k_eff, stride, padding_total)
    if causal:
        return padding_total, extra
    right = padding_total // 2
    return padding_total - right, right + extra


def unpad1d(x: torch.Tensor, paddings: tuple[int, int]) -> torch.Tensor:
    """Trim the time axis of a (B, T, C) tensor (ref conv.py:99-105)."""
    left, right = paddings
    if left < 0 or right < 0 or left + right > x.shape[1]:
        raise ValueError(f"cannot trim {paddings} from length {x.shape[1]}")
    return x[:, left:x.shape[1] - right]


def sconvtr1d_unpaddings(kernel_size: int, stride: int, causal: bool,
                         trim_right_ratio: float = 1.0) -> tuple[int, int]:
    """(left, right) trim after a transposed conv (ref conv.py:231-253): a
    causal conv trims ``ceil(padding_total * trim_right_ratio)`` on the right
    and the rest on the left; otherwise the right gets the smaller half."""
    padding_total = kernel_size - stride
    if causal:
        right = math.ceil(padding_total * trim_right_ratio)
    else:
        right = padding_total // 2
    return padding_total - right, right
