"""Vocos decoder: the ConvNeXt backbone with its attention pos-net, and the
ISTFT head.

Port of ``wavtokenizer_tpu/models/vocos.py`` (ref decoder/models.py:152-235,
decoder/modules.py, decoder/heads.py:24-67), channel-last (B, T, C)
throughout.  For inference the 12 ConvNeXt blocks run in the hand-written
kernel ``ops/kernels.py::convnext_block`` on the card (bf16 matmul operands,
fp32 sums; ``fused=True``, the default); everything else is plain PyTorch.
Training passes ``fused=False``: the kernel has no backward, and the JAX
package trains the plain fp32 block
(``wavtokenizer_tpu/train/step.py:206``), whose weights the training params
hold in fp32.  Convolution weights are in PyTorch's
(C_out, C_in, K) layout, Linear weights as (C_in, C_out).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops.conv import conv1d
from ..ops.kernels import convnext_block as convnext_block_kernel
from ..ops.spectral import istft_same


@dataclass(frozen=True)
class VocosBackboneConfig:
    """Mirror of VocosBackbone init args (ref decoder/models.py:166-216)."""
    input_channels: int = 512
    dim: int = 768
    intermediate_dim: int = 2304
    num_layers: int = 12
    adanorm_num_embeddings: int | None = 4
    num_pos_resblocks: int = 4      # fixed 2+attn+2 in the reference
    groupnorm_groups: int = 32


@dataclass(frozen=True)
class ISTFTHeadConfig:
    dim: int = 768
    n_fft: int = 1280
    hop_length: int = 320
    padding: str = "same"


def layer_norm(x: torch.Tensor, weight=None, bias=None, eps: float = 1e-6):
    """LayerNorm over the last dim."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm of a channel-last (B, T, C) tensor, stats over (T, C/G)."""
    B, T, C = x.shape
    g = x.reshape(B, T, num_groups, C // num_groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), unbiased=False, keepdim=True)
    g = (g - mean) * torch.rsqrt(var + eps)
    return g.reshape(B, T, C) * weight + bias


def ada_layer_norm(p: dict, x: torch.Tensor, cond_id: int) -> torch.Tensor:
    """Plain LayerNorm, then the per-condition scale and shift
    (ref decoder/modules.py:63-86)."""
    return layer_norm(x) * p["scale"][cond_id] + p["shift"][cond_id]


def pos_resnet_block(p: dict, x: torch.Tensor, groups: int,
                     dropout_generator: torch.Generator | None = None,
                     dropout_rate: float = 0.0) -> torch.Tensor:
    """GroupNorm -> swish -> conv(k3) -> GroupNorm -> swish -> [dropout] ->
    conv(k3) + x (ref decoder/models.py:19-78; the reference trains with
    Dropout(0.1) there, models.py:66-70,200).  The dropout runs only with a
    generator (on x's device) and a positive rate: the keep mask is uniform
    draws below 1 - rate, the kept values scaled by 1 / (1 - rate)."""
    h = F.silu(group_norm(x, p["norm1"]["weight"], p["norm1"]["bias"], groups))
    h = conv1d(h, p["conv1"]["weight"], p["conv1"]["bias"], padding=(1, 1))
    h = F.silu(group_norm(h, p["norm2"]["weight"], p["norm2"]["bias"], groups))
    if dropout_generator is not None and dropout_rate > 0.0:
        keep = 1.0 - dropout_rate
        mask = torch.rand(h.shape, generator=dropout_generator, device=h.device) < keep
        h = torch.where(mask, h / keep, 0.0)
    h = conv1d(h, p["conv2"]["weight"], p["conv2"]["bias"], padding=(1, 1))
    return x + h


def attn_block(p: dict, x: torch.Tensor, groups: int) -> torch.Tensor:
    """Single-head self-attention through 1x1 convs, scale C^-0.5, plain
    matmuls and softmax (ref decoder/models.py:80-127).  Linear weights
    here are (C_in, C_out)."""
    C = x.shape[-1]
    h = group_norm(x, p["norm"]["weight"], p["norm"]["bias"], groups)
    q = h @ p["q"]["weight"] + p["q"]["bias"]
    k = h @ p["k"]["weight"] + p["k"]["bias"]
    v = h @ p["v"]["weight"] + p["v"]["bias"]
    w = torch.softmax((q @ k.transpose(1, 2)) * C ** -0.5, dim=2)
    out = (w @ v) @ p["proj_out"]["weight"] + p["proj_out"]["bias"]
    return x + out


def convnext_block(p: dict, x: torch.Tensor, cond_id: int | None = None,
                   fused: bool = True) -> torch.Tensor:
    """ConvNeXt block (ref decoder/modules.py:8-60): depthwise conv k7 ->
    (Ada)LN -> Linear -> exact GELU -> Linear -> layer scale -> residual.

    ``fused`` runs the block as ``ops/kernels.py::convnext_block`` (the
    kernel on the card, bf16 matmul operands); ``fused=False`` is the plain
    fp32 block that training differentiates, as the JAX package's
    ``convnext_block(fused=False)``."""
    if "adanorm" in p:
        scale, shift = p["adanorm"]["scale"][cond_id], p["adanorm"]["shift"][cond_id]
    else:
        scale, shift = p["norm"]["weight"], p["norm"]["bias"]
    if fused:
        return convnext_block_kernel(x, p["dw"], p["dwb"], scale, shift, p["w1"],
                                     p["b1"], p["w2"], p["b2"], p["gamma"],
                                     p.get("w1t"), p.get("w2t"))
    C = x.shape[-1]
    h = conv1d(x, p["dw"].t().unsqueeze(1), p["dwb"], padding=(3, 3), groups=C)
    if "adanorm" in p:
        h = layer_norm(h) * scale + shift
    else:
        h = layer_norm(h, scale, shift)
    h = F.gelu(h @ p["w1"] + p["b1"])
    h = h @ p["w2"] + p["b2"]
    if "gamma" in p:
        h = p["gamma"] * h
    return x + h


def backbone_stem(params: dict, cfg: VocosBackboneConfig, x: torch.Tensor,
                  bandwidth_id: int | None = None,
                  dropout_generator: torch.Generator | None = None,
                  dropout_rate: float = 0.0) -> torch.Tensor:
    """The backbone up to its ConvNeXt stack: embed conv -> pos-net (2
    resblocks, attention, 2 resblocks, GroupNorm) -> (Ada)LN; the first
    block's input."""
    g = cfg.groupnorm_groups

    def res(p, x):
        return pos_resnet_block(p, x, g, dropout_generator, dropout_rate)

    x = conv1d(x, params["embed"]["weight"], params["embed"]["bias"], padding=(3, 3))
    pos = params["pos_net"]
    x = res(pos[0], x)
    x = res(pos[1], x)
    x = attn_block(pos[2], x, g)
    x = res(pos[3], x)
    x = res(pos[4], x)
    x = group_norm(x, pos[5]["weight"], pos[5]["bias"], g)
    if cfg.adanorm_num_embeddings:
        if bandwidth_id is None:
            raise ValueError("this backbone needs a bandwidth_id")
        x = ada_layer_norm(params["norm"], x, bandwidth_id)
    else:
        x = layer_norm(x, params["norm"]["weight"], params["norm"]["bias"])
    return x


def vocos_backbone(params: dict, cfg: VocosBackboneConfig, x: torch.Tensor,
                   bandwidth_id: int | None = None, fused: bool = True,
                   dropout_generator: torch.Generator | None = None,
                   dropout_rate: float = 0.0) -> torch.Tensor:
    """x (B, T, input_channels) -> (B, T, dim) (ref decoder/models.py:223-235):
    ``backbone_stem`` -> ConvNeXt stack -> final LayerNorm.  ``fused`` as in
    ``convnext_block``; ``dropout_generator``/``dropout_rate`` turn on the
    pos-net resblocks' training dropout (``pos_resnet_block``)."""
    x = backbone_stem(params, cfg, x, bandwidth_id, dropout_generator, dropout_rate)
    for block in params["convnext"]:
        x = convnext_block(block, x, cond_id=bandwidth_id, fused=fused)
    return layer_norm(x, params["final_layer_norm"]["weight"],
                      params["final_layer_norm"]["bias"])


def istft_head(params: dict, cfg: ISTFTHeadConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, T, dim) -> (B, T * hop) waveform (ref decoder/heads.py:42-67):
    Linear to n_fft + 2, log-magnitude (exp, clipped at 1e2) and phase, then
    the "same"-padded ISTFT."""
    if cfg.padding != "same":
        raise NotImplementedError("only 'same' padding is used by shipped configs")
    x = x @ params["out"]["weight"] + params["out"]["bias"]
    n = cfg.n_fft // 2 + 1
    mag = torch.clamp(torch.exp(x[..., :n]), max=1e2)
    phase = x[..., n:]
    return istft_same(mag * torch.cos(phase), mag * torch.sin(phase), cfg.n_fft,
                      cfg.hop_length)
