"""SEANet encoder and decoder, inference path, driven by the same layer specs
as the JAX package.

Port of ``wavtokenizer_tpu/models/seanet.py`` (ref encoder/modules/seanet.py:
66-238): the config and layer-spec dataclasses are field-for-field copies;
``seanet_encode`` runs the encoder stack and ``seanet_decode`` the decoder.
Activations are channel-last (B, T, C) between layers.  Params per layer:

* conv:     {"weight": (C_out, C_in, K), "bias": (C_out,)}; layer 0 of the
            encoder also holds the front kernel's packed weights under
            "front" when the geometry matches (``ops/encoder_front.py``)
* convtr:   {"weight": (C_in, C_out, K), "bias": (C_out,)}
* resblock: {"block": [conv, conv], "shortcut": conv (unless true_skip)}
* lstm:     {"lstm": nn.LSTM}, or in training {"layers": [{w_ih, w_hh, b_ih,
            b_hh}, ...]}, the weight tensors themselves
* elu, final_act: {}

Under ``norm="time_group_norm"`` every conv and convtr also holds
{"gn": {"weight": (C_out,), "bias": (C_out,)}}: GroupNorm(1, C) after it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import kernels
from ..ops.conv import sconv1d, sconv_transpose1d
from ..ops.encoder_front import front_geometry_matches
from ..ops.lstm import slstm, slstm_layers
from ..ops.remat import checkpointed


@dataclass(frozen=True)
class SEANetConfig:
    """Mirror of the reference constructor args (seanet.py:91-95,174-180)."""
    channels: int = 1
    dimension: int = 512
    n_filters: int = 32
    n_residual_layers: int = 1
    ratios: tuple = (8, 5, 4, 2)       # decoder order, encoder reverses
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_base: int = 2
    causal: bool = False
    pad_mode: str = "reflect"
    true_skip: bool = False
    compress: int = 2
    lstm: int = 2
    trim_right_ratio: float = 1.0
    final_activation: str | None = None
    norm: str = "weight_norm"

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.ratios))


@dataclass(frozen=True)
class LayerSpec:
    """One entry of the (flattened) sequential model."""
    kind: str                  # conv | convtr | lstm | elu | resblock | final_act
    prefix: str = ""           # torch key prefix, e.g. "model.3"
    stride: int = 1
    dilation: int = 1
    causal: bool = False
    pad_mode: str = "reflect"
    trim_right_ratio: float = 1.0
    block_dilations: tuple = ()
    block_kernel_sizes: tuple = ()
    true_skip: bool = True
    num_lstm_layers: int = 0
    norm: str = "weight_norm"


def _resblock_spec(cfg: SEANetConfig, prefix: str, j: int) -> LayerSpec:
    return LayerSpec("resblock", prefix, causal=cfg.causal, pad_mode=cfg.pad_mode,
                     block_kernel_sizes=(cfg.residual_kernel_size, 1),
                     block_dilations=(cfg.dilation_base ** j, 1),
                     true_skip=cfg.true_skip, norm=cfg.norm)


def encoder_layer_specs(cfg: SEANetConfig) -> list[LayerSpec]:
    """Flattened layers with SEANetEncoder's module indices
    (ref seanet.py:107-141), so torch keys line up as model.{i}."""
    specs: list[LayerSpec] = []

    def conv(stride=1):
        specs.append(LayerSpec("conv", f"model.{len(specs)}", stride=stride,
                               causal=cfg.causal, pad_mode=cfg.pad_mode,
                               norm=cfg.norm))

    conv()
    for ratio in reversed(cfg.ratios):
        for j in range(cfg.n_residual_layers):
            specs.append(_resblock_spec(cfg, f"model.{len(specs)}", j))
        specs.append(LayerSpec("elu"))
        conv(stride=ratio)
    if cfg.lstm:
        specs.append(LayerSpec("lstm", f"model.{len(specs)}",
                               num_lstm_layers=cfg.lstm))
    specs.append(LayerSpec("elu"))
    conv()
    return specs


def decoder_layer_specs(cfg: SEANetConfig) -> list[LayerSpec]:
    """Flattened layers with SEANetDecoder's module indices
    (ref seanet.py:192-234)."""
    specs: list[LayerSpec] = [LayerSpec("conv", "model.0", causal=cfg.causal,
                                        pad_mode=cfg.pad_mode, norm=cfg.norm)]
    if cfg.lstm:
        specs.append(LayerSpec("lstm", f"model.{len(specs)}",
                               num_lstm_layers=cfg.lstm))
    for ratio in cfg.ratios:
        specs.append(LayerSpec("elu"))
        specs.append(LayerSpec("convtr", f"model.{len(specs)}", stride=ratio,
                               causal=cfg.causal,
                               trim_right_ratio=cfg.trim_right_ratio,
                               norm=cfg.norm))
        for j in range(cfg.n_residual_layers):
            specs.append(_resblock_spec(cfg, f"model.{len(specs)}", j))
    specs.append(LayerSpec("elu"))
    specs.append(LayerSpec("conv", f"model.{len(specs)}", causal=cfg.causal,
                           pad_mode=cfg.pad_mode, norm=cfg.norm))
    if cfg.final_activation is not None:
        specs.append(LayerSpec("final_act"))
    return specs


def _time_group_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm(1, C) on channel-last (B, T, C): statistics over the whole
    (T, C) slab per batch element (ref conv.py:45-49; torch's eps 1e-5)."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + 1e-5) * p["weight"] + p["bias"]


def _post_norm(p: dict, spec: LayerSpec, x: torch.Tensor) -> torch.Tensor:
    return _time_group_norm(p["gn"], x) if spec.norm == "time_group_norm" else x


def _conv(p: dict, spec: LayerSpec, x: torch.Tensor, stride: int = 1,
          dilation: int = 1) -> torch.Tensor:
    x = sconv1d(x, p["weight"], p["bias"], stride=stride, dilation=dilation,
                causal=spec.causal, pad_mode=spec.pad_mode)
    return _post_norm(p, spec, x)


def _apply_resblock(p: dict, spec: LayerSpec, x: torch.Tensor) -> torch.Tensor:
    """[ELU, conv(k, d), ELU, conv(1)] + shortcut (ref seanet.py:21-63)."""
    h = x
    for conv_p, dil in zip(p["block"], spec.block_dilations):
        h = _conv(conv_p, spec, F.elu(h), dilation=dil)
    short = x if spec.true_skip else _conv(p["shortcut"], spec, x)
    return short + h


_NORMS = ("weight_norm", "none", "time_group_norm")


def _apply_layer(p: dict, spec: LayerSpec, x: torch.Tensor,
                 final_activation: str | None = None) -> torch.Tensor:
    if spec.norm not in _NORMS:
        raise NotImplementedError(f"norm {spec.norm!r}")
    if spec.kind == "conv":
        return _conv(p, spec, x, stride=spec.stride, dilation=spec.dilation)
    if spec.kind == "convtr":
        norm_fn = ((lambda y: _time_group_norm(p["gn"], y))
                   if spec.norm == "time_group_norm" else None)
        return sconv_transpose1d(x, p["weight"], p["bias"], stride=spec.stride,
                                 causal=spec.causal,
                                 trim_right_ratio=spec.trim_right_ratio,
                                 norm_fn=norm_fn)
    if spec.kind == "resblock":
        return _apply_resblock(p, spec, x)
    if spec.kind == "lstm":
        return slstm(x, p["lstm"]) if "lstm" in p else slstm_layers(x, p["layers"])
    if spec.kind == "elu":
        return F.elu(x)
    if spec.kind == "final_act":
        if final_activation == "Tanh":
            return torch.tanh(x)
        raise NotImplementedError(f"final activation {final_activation!r}")
    raise ValueError(f"layer kind {spec.kind!r}")


def _plain_front(params: list, specs: list[LayerSpec], x: torch.Tensor) -> torch.Tensor:
    """Layers 0-6 through the plain path: the front kernel's plain version
    (``ops/kernels.py::encoder_front_reference``)."""
    for p, spec in zip(params[:7], specs[:7]):
        x = _apply_layer(p, spec, x)
    return x


# The layers the training encoder rematerializes one by one; the ELUs
# between them are cheap to run again with the next layer's recompute.
_REMAT_KINDS = ("conv", "convtr", "resblock", "lstm")


def seanet_encode(params: list, cfg: SEANetConfig, audio: torch.Tensor,
                  front: bool = True, remat: bool = False) -> torch.Tensor:
    """audio (B, T, 1) -> latent (B, T', dimension), fp32.

    When ``front`` is set and ``front_geometry_matches`` admits the encoder
    and the length (small-320 geometry, T % 8 == 0, T >= 1024), layers 0-6
    go through ``ops/kernels.py::encoder_front``: its CUDA kernel on the
    card, its plain version (these same layers) on the CPU.  ``front=False``
    runs every layer plainly.  The caller sets the precision:
    ``models/wavtokenizer.encode_infer`` turns TF32 off around this call.
    ``remat`` (training) checkpoints each conv, resblock and LSTM layer
    (``ops/remat.py``), as the JAX package's ``apply_seanet(remat=True)``."""
    specs = encoder_layer_specs(cfg)
    x, start = audio, 0
    if front and front_geometry_matches(specs, params, audio.shape[1]):
        x, start = kernels.encoder_front(audio.contiguous(), params, specs), 7
    for p, spec in zip(params[start:], specs[start:]):
        x = checkpointed(_apply_layer, p, spec, x, remat=remat and spec.kind in _REMAT_KINDS)
    return x


def seanet_decode(params: list, cfg: SEANetConfig, z: torch.Tensor) -> torch.Tensor:
    """z (B, T', dimension) -> audio (B, T' * hop, channels).  Every layer
    runs plainly (cuDNN on the card); the caller sets the precision."""
    for p, spec in zip(params, decoder_layer_specs(cfg)):
        z = _apply_layer(p, spec, z, cfg.final_activation)
    return z
