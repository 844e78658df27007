"""1-D convolutions, channel-last (B, T, C) at the function boundary, and
the discriminators' 2-D convolution.

Port of ``wavtokenizer_tpu/ops/conv.py``.  Activations of the 1-D convs enter
and leave as (B, T, C), like the JAX functions; inside, ``F.conv1d`` runs on
the channel-first view.  ``conv2d`` keeps PyTorch's (B, C, H, W), the layout
of the discriminators (``train/discriminators.py``).  Weights are in PyTorch's layout with weight norm
already folded: (C_out, C_in/groups, K) for a conv, (C_in, C_out, K) for a
transposed conv (``api/pretrained.py`` re-lays out the JAX kernels once, at
model build).

fp32 convolutions on the card go through cuDNN, which uses TF32 unless
``torch.backends.cudnn.allow_tf32`` is off; the encode path turns it off
(``models/wavtokenizer.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .padding import pad1d, sconv1d_paddings, sconvtr1d_unpaddings, unpad1d


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           stride: int = 1, dilation: int = 1, groups: int = 1,
           padding: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Plain zero-padded conv1d.  x (B, T, C_in) -> (B, T', C_out)."""
    h = F.pad(x.transpose(1, 2), padding) if any(padding) else x.transpose(1, 2)
    return F.conv1d(h, weight, bias, stride=stride, dilation=dilation,
                    groups=groups).transpose(1, 2)


def conv_transpose1d(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor | None = None, stride: int = 1) -> torch.Tensor:
    """Transposed conv1d with no implicit padding, out = (T - 1) * stride + K.
    x (B, T, C_in), weight (C_in, C_out, K) -> (B, T', C_out)."""
    return F.conv_transpose1d(x.transpose(1, 2), weight, bias,
                              stride=stride).transpose(1, 2)


def sconv_transpose1d(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor | None, stride: int = 1,
                      causal: bool = False, trim_right_ratio: float = 1.0,
                      norm_fn=None) -> torch.Tensor:
    """Streamable transposed conv: the conv, then the fixed trim (ref
    SConvTranspose1d.forward, encoder/modules/conv.py:231-253).  ``norm_fn``
    (time_group_norm) runs on the UNTRIMMED output, as the reference norms
    inside NormConvTranspose1d before it unpads: the statistics include the
    edges."""
    y = conv_transpose1d(x, weight, bias, stride=stride)
    if norm_fn is not None:
        y = norm_fn(y)
    return unpad1d(y, sconvtr1d_unpaddings(weight.shape[-1], stride, causal,
                                           trim_right_ratio))


def sconv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
            stride: int = 1, dilation: int = 1, groups: int = 1,
            causal: bool = False, pad_mode: str = "reflect") -> torch.Tensor:
    """Streamable conv: the reference's exact asymmetric/causal padding, then
    the conv (ref SConv1d.forward, encoder/modules/conv.py:195-211)."""
    pads = sconv1d_paddings(x.shape[1], weight.shape[-1], stride, dilation,
                            causal)
    h = pad1d(x.transpose(1, 2), pads, mode=pad_mode)
    return F.conv1d(h, weight, bias, stride=stride, dilation=dilation,
                    groups=groups).transpose(1, 2)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           stride: tuple[int, int] = (1, 1),
           padding: tuple[tuple[int, int], tuple[int, int]] = ((0, 0), (0, 0)),
           dilation: tuple[int, int] = (1, 1), groups: int = 1) -> torch.Tensor:
    """Zero-padded conv2d, x (B, C_in, H, W), weight (C_out, C_in/groups, Kh,
    Kw), ``padding`` ((top, bottom), (left, right)) as the JAX function's
    ``padding`` on (H, W); ``dilation`` spreads the taps (the MS-STFT
    discriminator's dilated time axis)."""
    (top, bottom), (left, right) = padding
    if top == bottom and left == right:
        return F.conv2d(x, weight, bias, stride=stride, padding=(top, left),
                        dilation=dilation, groups=groups)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, bias, stride=stride,
                    dilation=dilation, groups=groups)
