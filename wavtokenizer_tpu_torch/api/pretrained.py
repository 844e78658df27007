"""Public inference API: the ``WavTokenizer`` facade.

Port of ``wavtokenizer_tpu/api/pretrained.py`` (ref decoder/pretrained.py):

    wt = WavTokenizer.from_pretrained0802(config_path, model_path)  # or
    wt = WavTokenizer.from_state_dict(state_dict, spec)              # or
    wt = WavTokenizer.from_jax_params(init_wavtokenizer(spec), spec)
    features, codes = wt.encode_infer(audio)
    audio_hat = wt.decode(features, bandwidth_id=0)
    features = wt.codes_to_features(codes)

Everything runs on ``cuda`` unless the caller passes ``device="cpu"``; on
the card the encoder front (layers 0-6), the VQ search and the ConvNeXt
blocks run in this package's own kernels (``ops/kernels.py``).  Inputs may
be numpy arrays or tensors; outputs are tensors on the model's device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..checkpoint.convert import (average_state_dicts, convert_wavtokenizer_state_dict,
                                  load_torch_state_dict)
from ..models import wavtokenizer as wt
from ..models.seanet import encoder_layer_specs
from ..models.wavtokenizer import WavTokenizerSpec
from ..ops.encoder_front import front_geometry_matches, prepare_front_weights
from ..ops.kernels import pack_convnext_weights, pack_vq_codebook
from ..ops.lstm import lstm_from_layers
from .config import spec_from_config


def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(device=device, dtype=dtype)


def _conv(p: dict, device) -> dict:
    """{'kernel': (K, I, O)} -> {'weight': (O, I, K), 'bias'}."""
    bias = p.get("bias")
    return {"weight": _t(np.transpose(p["kernel"], (2, 1, 0)), device).contiguous(),
            "bias": None if bias is None else _t(bias, device)}


def _linear_from_conv1x1(p: dict, device) -> dict:
    """1x1 conv {'kernel': (1, I, O)} -> Linear {'weight': (I, O), 'bias'}."""
    return {"weight": _t(p["kernel"][0], device), "bias": _t(p["bias"], device)}


def _norm(p: dict, device) -> dict:
    return {k: _t(p[k], device) for k in ("weight", "bias")}


def _encoder(params: list, spec: WavTokenizerSpec, device) -> list:
    out = []
    for p, s in zip(params, encoder_layer_specs(spec.seanet)):
        if s.kind == "conv":
            out.append(_conv(p, device))
        elif s.kind == "resblock":
            q = {"block": [_conv(c, device) for c in p["block"]]}
            if "shortcut" in p:
                q["shortcut"] = _conv(p["shortcut"], device)
            out.append(q)
        elif s.kind == "lstm":
            out.append({"lstm": lstm_from_layers(p["layers"], device)})
        else:
            out.append({})
    specs = encoder_layer_specs(spec.seanet)
    # Any length the gate admits will do: the pack depends on the weights only.
    if front_geometry_matches(specs, out, 1024):
        out[0]["front"] = prepare_front_weights(out)
    return out


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


def from_jax_params(params_np: dict, spec: WavTokenizerSpec, device="cuda") -> dict:
    """The JAX package's param pytree (numpy; ``models/init.py`` or
    ``checkpoint/convert.py`` output, channel-last kernels) -> this package's
    params on ``device``: conv weights (C_out, C_in, K), the ConvNeXt matmul
    weights in bf16, the encoder LSTM as an ``nn.LSTM``, |E|^2 per code and
    the codebook split for the VQ kernel.
    The SEANet decoder's weights are not carried over (not run yet)."""
    device = torch.device(device)
    embed = _t(params_np["quantizer"]["embed"], device)
    return {
        "encoder": _encoder(params_np["encoder"], spec, device),
        "quantizer": {"embed": embed, "esq": (embed * embed).sum(-1),
                      "pack": torch.stack([pack_vq_codebook(e) for e in embed])},
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

    def decode(self, features_input, bandwidth_id) -> torch.Tensor:
        """(B, D, T') features -> (B, T' * hop) waveform."""
        features = torch.as_tensor(features_input, dtype=torch.float32).to(self.device)
        return wt.decode(self.params, self.spec, features, int(bandwidth_id))

    def codes_to_features(self, codes) -> torch.Tensor:
        """(K, B, T') or (K, T') codes -> (B, D, T') features."""
        return wt.codes_to_features(self.params, torch.as_tensor(codes).to(self.device))

    def __call__(self, audio_input, bandwidth_id) -> torch.Tensor:
        """Copy synthesis: encode, then decode (ref pretrained.py:159-175).
        The reference encodes through the training-style VQ forward, which
        with the single codebook gives the same features as encode_infer."""
        features, _ = self.encode_infer(audio_input)
        return self.decode(features, bandwidth_id)
