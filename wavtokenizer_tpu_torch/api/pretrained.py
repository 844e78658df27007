"""Public inference API: the ``WavTokenizer`` facade.

Port of ``wavtokenizer_tpu/api/pretrained.py`` (ref decoder/pretrained.py):

    wt = WavTokenizer.from_pretrained0802(config_path, model_path)  # or
    wt = WavTokenizer.from_state_dict(state_dict, spec)              # or
    wt = WavTokenizer.from_jax_params(init_wavtokenizer(spec), spec)
    features, codes = wt.encode_infer(audio)
    audio_hat = wt.decode(features, bandwidth_id=0)
    features = wt.codes_to_features(codes)
    features, codes = wt.encode(audio, n_q=2)     # training-style encode
    audio_hat = wt(audio, bandwidth_id=0)         # copy synthesis

Everything runs on ``cuda`` unless the caller passes ``device="cpu"``; on
the card the encoder front (layers 0-6), the VQ search and the ConvNeXt
blocks run in this package's own kernels (``ops/kernels.py``).  Inputs may
be numpy arrays or tensors; outputs are tensors on the model's device.
``encodec_from_jax_params`` builds the params of ``models/encodec.py`` from
the same kind of pytree.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..checkpoint.convert import (average_state_dicts, convert_wavtokenizer_state_dict,
                                  load_torch_state_dict)
from ..models import wavtokenizer as wt
from ..models.seanet import decoder_layer_specs, encoder_layer_specs
from ..models.wavtokenizer import WavTokenizerSpec
from ..ops.encoder_front import front_geometry_matches, prepare_front_weights
from ..ops.kernels import pack_convnext_weights, pack_vq_codebook
from ..ops.lstm import lstm_from_layers
from .config import spec_from_config


def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(device=device, dtype=dtype)


def _conv(p: dict, device) -> dict:
    """{'kernel': (K, I, O)} -> {'weight': (O, I, K), 'bias'}, with the
    GroupNorm params ('gn') of a time_group_norm layer."""
    bias = p.get("bias")
    out = {"weight": _t(np.transpose(p["kernel"], (2, 1, 0)), device).contiguous(),
           "bias": None if bias is None else _t(bias, device)}
    if "gn" in p:
        out["gn"] = _norm(p["gn"], device)
    return out


def _convtr(p: dict, device) -> dict:
    """Transposed conv {'kernel': (K, I, O)} -> {'weight': (I, O, K), 'bias'}."""
    out = _conv(p, device)
    out["weight"] = _t(np.transpose(p["kernel"], (1, 2, 0)), device).contiguous()
    return out


def _linear_from_conv1x1(p: dict, device) -> dict:
    """1x1 conv {'kernel': (1, I, O)} -> Linear {'weight': (I, O), 'bias'}."""
    return {"weight": _t(p["kernel"][0], device), "bias": _t(p["bias"], device)}


def _norm(p: dict, device) -> dict:
    return {k: _t(p[k], device) for k in ("weight", "bias")}


def seanet_from_jax(params: list, specs: list, device) -> list:
    """The JAX package's SEANet layer params (numpy) -> this package's, for
    the encoder or the decoder (``specs`` says which).  An encoder the front
    kernel serves gets the kernel's weight pack under ``[0]["front"]``."""
    out = []
    for p, s in zip(params, specs):
        if s.kind == "conv":
            out.append(_conv(p, device))
        elif s.kind == "convtr":
            out.append(_convtr(p, device))
        elif s.kind == "resblock":
            q = {"block": [_conv(c, device) for c in p["block"]]}
            if "shortcut" in p:
                q["shortcut"] = _conv(p["shortcut"], device)
            out.append(q)
        elif s.kind == "lstm":
            out.append({"lstm": lstm_from_layers(p["layers"], device)})
        else:
            out.append({})
    # Any length the gate admits will do: the pack depends on the weights only.
    if front_geometry_matches(specs, out, 1024):
        out[0]["front"] = prepare_front_weights(out)
    return out


def quantizer_from_jax(params: dict, device) -> dict:
    """{'embed': (n_q, bins, dim)} -> the codebooks, |E|^2 per code and the
    VQ kernel's split codebook of every layer, made once here."""
    embed = _t(params["embed"], device)
    return {"embed": embed, "esq": (embed * embed).sum(-1),
            "pack": torch.stack([pack_vq_codebook(e) for e in embed])}


def _convnext(p: dict, device) -> dict:
    C = np.shape(p["dwconv"]["bias"])[0]
    q = {"dw": _t(p["dwconv"]["kernel"][:, 0, :], device).contiguous(),
         "dwb": _t(p["dwconv"]["bias"], device),
         "w1": _t(p["pwconv1"]["weight"], device, torch.bfloat16).contiguous(),
         "b1": _t(p["pwconv1"]["bias"], device),
         "w2": _t(p["pwconv2"]["weight"], device, torch.bfloat16).contiguous(),
         "b2": _t(p["pwconv2"]["bias"], device),
         "gamma": _t(p["gamma"] if "gamma" in p else np.ones(C), device)}
    q["w1t"], q["w2t"] = pack_convnext_weights(q["w1"], q["w2"])
    if "adanorm" in p:
        q["adanorm"] = {k: _t(p["adanorm"][k], device) for k in ("scale", "shift")}
    else:
        q["norm"] = _norm(p["norm"], device)
    return q


def _backbone(p: dict, device) -> dict:
    pos = p["pos_net"]

    def resnet(r):
        return {"norm1": _norm(r["norm1"], device), "conv1": _conv(r["conv1"], device),
                "norm2": _norm(r["norm2"], device), "conv2": _conv(r["conv2"], device)}

    attn = {"norm": _norm(pos[2]["norm"], device),
            **{n: _linear_from_conv1x1(pos[2][n], device)
               for n in ("q", "k", "v", "proj_out")}}
    norm = p["norm"]
    return {
        "embed": _conv(p["embed"], device),
        "pos_net": [resnet(pos[0]), resnet(pos[1]), attn, resnet(pos[3]),
                    resnet(pos[4]), _norm(pos[5], device)],
        "norm": ({k: _t(norm[k], device) for k in ("scale", "shift")}
                 if "scale" in norm else _norm(norm, device)),
        "convnext": [_convnext(b, device) for b in p["convnext"]],
        "final_layer_norm": _norm(p["final_layer_norm"], device),
    }


def encodec_from_jax_params(params_np: dict, cfg, device="cuda") -> dict:
    """The encoder, decoder and quantizer of a JAX param pytree (numpy;
    ``init_encodec``, ``convert_encodec_state_dict`` or the codec part of a
    WavTokenizer's) -> this package's on ``device``: conv weights
    (C_out, C_in, K), transposed-conv weights (C_in, C_out, K), the LSTMs as
    ``nn.LSTM``s, and |E|^2 and the VQ kernel's split codebook of every
    layer.  ``cfg`` is an ``EncodecConfig`` or a ``WavTokenizerSpec``: only
    its ``seanet`` is read."""
    device = torch.device(device)
    return {
        "encoder": seanet_from_jax(params_np["encoder"],
                                   encoder_layer_specs(cfg.seanet), device),
        "decoder": seanet_from_jax(params_np["decoder"],
                                   decoder_layer_specs(cfg.seanet), device),
        "quantizer": quantizer_from_jax(params_np["quantizer"], device),
    }


def from_jax_params(params_np: dict, spec: WavTokenizerSpec, device="cuda") -> dict:
    """The JAX package's param pytree (numpy; ``models/init.py`` or
    ``checkpoint/convert.py`` output, channel-last kernels) -> this package's
    params on ``device``: the codec's as ``encodec_from_jax_params`` makes
    them, and the backbone's, its ConvNeXt matmul weights in bf16."""
    device = torch.device(device)
    return {
        **encodec_from_jax_params(params_np, spec, device),
        "backbone": _backbone(params_np["backbone"], device),
        "head": {"out": {"weight": _t(params_np["head"]["out"]["weight"], device),
                         "bias": _t(params_np["head"]["out"]["bias"], device)}},
    }


class WavTokenizer:
    """Inference facade around (params, WavTokenizerSpec) on one device."""

    def __init__(self, params: dict, spec: WavTokenizerSpec, device="cuda"):
        self.params = params
        self.spec = spec
        self.device = torch.device(device)

    @classmethod
    def from_jax_params(cls, params_np: dict, spec: WavTokenizerSpec,
                        device="cuda") -> "WavTokenizer":
        return cls(from_jax_params(params_np, spec, device), spec, device)

    @classmethod
    def from_state_dict(cls, state_dict: dict, spec: WavTokenizerSpec,
                        device="cuda") -> "WavTokenizer":
        """From a Lightning state dict ({key: tensor or ndarray}, keys under
        feature_extractor. / backbone. / head.)."""
        return cls.from_jax_params(convert_wavtokenizer_state_dict(state_dict, spec),
                                   spec, device)

    @classmethod
    def from_pretrained0802(cls, config_path: str, model_path: str,
                            device="cuda") -> "WavTokenizer":
        """A released Lightning checkpoint and its YAML config, unchanged
        (ref decoder/pretrained.py:95-114).  The YAML needs PyYAML."""
        spec = spec_from_config(config_path)
        return cls.from_state_dict(load_torch_state_dict(model_path), spec, device)

    @classmethod
    def from_pretrained0911(cls, config_path: str, model_folder_path: str,
                            device="cuda") -> "WavTokenizer":
        """Average the 3 best ``vocos_*`` checkpoints of a folder by the
        val_loss in their file names (ref decoder/pretrained.py:117-156).

        Keeps the reference's selection quirks on purpose: val_loss is the
        raw file-name substring [-11:-5], sorted as a STRING (so '10.234'
        sorts before '4.567'), and a file is kept when its substring is among
        the three (so a repeated loss string admits more than 3 files)."""
        spec = spec_from_config(config_path)
        names = [n for n in os.listdir(model_folder_path) if n.startswith("vocos_")]
        val_loss = sorted(n[-11:-5] for n in names)[:3]
        sds = [load_torch_state_dict(os.path.join(model_folder_path, n))
               for n in names if n[-11:-5] in val_loss]
        return cls.from_state_dict(average_state_dicts(sds), spec, device)

    def _audio(self, audio) -> torch.Tensor:
        a = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
        return a[None] if a.dim() == 1 else a

    def encode_infer(self, audio_input, bandwidth_id=None):
        """(B, T) audio -> (features (B, D, T'), codes (1, B, T') int32).
        1-D input is a batch of one."""
        return wt.encode_infer(self.params, self.spec, self._audio(audio_input))

    def encode(self, audio_input, bandwidth_id=None, n_q: int | None = None):
        """Training-style encode (ref pretrained.py:179-182): (B, T) audio ->
        (features (B, D, T'), codes (n_q, B, T') int32); every layer quantizes
        the same embedding and the features are the last layer's."""
        return wt.encode_forward(self.params, self.spec, self._audio(audio_input), n_q=n_q)

    def decode(self, features_input, bandwidth_id) -> torch.Tensor:
        """(B, D, T') features -> (B, T' * hop) waveform."""
        features = torch.as_tensor(features_input, dtype=torch.float32).to(self.device)
        return wt.decode(self.params, self.spec, features, int(bandwidth_id))

    def codes_to_features(self, codes) -> torch.Tensor:
        """(K, B, T') or (K, T') codes -> (B, D, T') features."""
        return wt.codes_to_features(self.params, torch.as_tensor(codes).to(self.device))

    def __call__(self, audio_input, bandwidth_id) -> torch.Tensor:
        """Copy synthesis (ref pretrained.py:159-175): the training-style
        encode (``encode``, all of the spec's quantizers), then decode."""
        return wt.forward(self.params, self.spec, self._audio(audio_input),
                          int(bandwidth_id))

    forward = __call__

    def seanet_only_decode(self, features_input) -> torch.Tensor:
        """(B, D, T') features -> (B, T' * hop) through the SEANet decoder
        alone (bypasses Vocos)."""
        features = torch.as_tensor(features_input, dtype=torch.float32).to(self.device)
        return wt.seanet_only_decode(self.params, self.spec, features)
