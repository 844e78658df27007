"""Public inference API: the ``WavTokenizer`` facade.

Port of ``wavtokenizer_tpu/api/pretrained.py`` (ref decoder/pretrained.py):

    wt = WavTokenizer.from_pretrained0802(config_path, model_path)  # or
    wt = WavTokenizer.from_pretrained0828(config_path, model_path)  # + discriminators
    wt = WavTokenizer.from_train_checkpoint(config_path, "runs/x/last.pt")  # or
    wt = WavTokenizer.from_state_dict(state_dict, spec)              # or
    wt = WavTokenizer.from_jax_params(init_wavtokenizer(spec), spec)
    features, codes = wt.encode_infer(audio)
    audio_hat = wt.decode(features, bandwidth_id=0)
    features = wt.codes_to_features(codes)
    features, codes = wt.encode(audio, n_q=2)     # training-style encode
    audio_hat = wt(audio, bandwidth_id=0)         # copy synthesis

and the plain-Vocos facade (mel features -> trunk -> head):

    vocos = Vocos.from_pretrained(config_path, model_path)  # or
    vocos = Vocos.from_jax_params(init_vocos(spec), spec)
    audio_hat = vocos.decode(vocos.feature_extractor(audio))  # = vocos(audio)

Everything runs on ``cuda`` unless the caller passes ``device="cpu"``; on
the card the encoder front (layers 0-6), the VQ search and the ConvNeXt
blocks run in this package's own kernels (``ops/kernels.py``).  Inputs may
be numpy arrays or tensors; outputs are tensors on the model's device.
``encodec_from_jax_params`` builds the params of ``models/encodec.py`` from
the same kind of pytree.  The training state's layouts come from the same
converters (``seanet_from_jax``/``backbone_from_jax`` with ``train=True``,
``train_tree_from_jax``, and their inverses), and ``train_state_from_jax``
carries a JAX training state, optimizer moments included, into this
package's.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from ..checkpoint.convert import (DISCRIMINATOR_PREFIXES, INFERENCE_PREFIXES,
                                  average_state_dicts, convert_vocos_state_dict,
                                  convert_wavtokenizer_state_dict, discriminator_params,
                                  load_torch_state_dict)
from ..models import vocos_model
from ..models import wavtokenizer as wt
from ..models.seanet import decoder_layer_specs, encoder_layer_specs
from ..models.wavtokenizer import WavTokenizerSpec
from ..ops.encoder_front import front_geometry_matches, prepare_front_weights
from ..ops.kernels import pack_convnext_weights, pack_vq_codebook
from ..ops.lstm import lstm_from_layers
from .config import spec_from_config, vocos_spec_from_config


def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)


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


def seanet_from_jax(params: list, specs: list, device, train: bool = False) -> list:
    """The JAX package's SEANet layer params (numpy) -> this package's, for
    the encoder or the decoder (``specs`` says which).  For inference an
    LSTM becomes a frozen ``nn.LSTM`` and an encoder the front kernel serves
    gets the kernel's weight pack under ``[0]["front"]``; for training
    (``train=True``) an LSTM stays its weight tensors {"layers": [...]}, and
    there is no pack."""
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
            out.append({"layers": [{k: _t(v, device) for k, v in layer.items()}
                                   for layer in p["layers"]]} if train
                       else {"lstm": lstm_from_layers(p["layers"], device)})
        else:
            out.append({})
    # Any length the gate admits will do: the pack depends on the weights only.
    if not train and front_geometry_matches(specs, out, 1024):
        out[0]["front"] = prepare_front_weights(out)
    return out


def quantizer_from_jax(params: dict, device) -> dict:
    """{'embed': (n_q, bins, dim)} -> the codebooks, |E|^2 per code and the
    VQ kernel's split codebook of every layer, made once here."""
    embed = _t(params["embed"], device)
    return {"embed": embed, "esq": (embed * embed).sum(-1),
            "pack": torch.stack([pack_vq_codebook(e) for e in embed])}


def _convnext(p: dict, device, train: bool) -> dict:
    q = {"dw": _t(p["dwconv"]["kernel"][:, 0, :], device).contiguous(),
         "dwb": _t(p["dwconv"]["bias"], device),
         "w1": _t(p["pwconv1"]["weight"], device),
         "b1": _t(p["pwconv1"]["bias"], device),
         "w2": _t(p["pwconv2"]["weight"], device),
         "b2": _t(p["pwconv2"]["bias"], device)}
    if "gamma" in p:
        q["gamma"] = _t(p["gamma"], device)
    if "adanorm" in p:
        q["adanorm"] = {k: _t(p["adanorm"][k], device) for k in ("scale", "shift")}
    else:
        q["norm"] = _norm(p["norm"], device)
    if not train:
        q.setdefault("gamma", torch.ones_like(q["dwb"]))
        q["w1"] = q["w1"].to(torch.bfloat16).contiguous()
        q["w2"] = q["w2"].to(torch.bfloat16).contiguous()
        q["w1t"], q["w2t"] = pack_convnext_weights(q["w1"], q["w2"])
    return q


def backbone_from_jax(p: dict, device, train: bool = False) -> dict:
    """The JAX package's backbone params (numpy) -> this package's on
    ``device``.  For inference (``train=False``) the ConvNeXt matmul weights
    are bf16 with the kernel's K-major packs; for training they stay fp32,
    without packs, and every tensor is one of the JAX tree's leaves
    re-laid-out (so the same function maps optimizer moments)."""
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
        "convnext": [_convnext(b, device, train) for b in p["convnext"]],
        "final_layer_norm": _norm(p["final_layer_norm"], device),
    }


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _conv_to_jax(c: dict) -> dict:
    return {"kernel": _np(c["weight"]).transpose(2, 1, 0), "bias": _np(c["bias"])}


def backbone_to_jax(q: dict) -> dict:
    """Inverse of ``backbone_from_jax(train=True)``: this package's fp32
    backbone -> the JAX package's layout, in numpy."""
    norm = lambda n: {k: _np(v) for k, v in n.items()}
    pos = q["pos_net"]

    def resnet(r):
        return {"norm1": norm(r["norm1"]), "conv1": _conv_to_jax(r["conv1"]),
                "norm2": norm(r["norm2"]), "conv2": _conv_to_jax(r["conv2"])}

    def block(b):
        out = {"dwconv": {"kernel": _np(b["dw"])[:, None, :], "bias": _np(b["dwb"])},
               "pwconv1": {"weight": _np(b["w1"]), "bias": _np(b["b1"])},
               "pwconv2": {"weight": _np(b["w2"]), "bias": _np(b["b2"])}}
        if "gamma" in b:
            out["gamma"] = _np(b["gamma"])
        out["adanorm" if "adanorm" in b else "norm"] = norm(b.get("adanorm", b.get("norm")))
        return out

    attn = {"norm": norm(pos[2]["norm"]),
            **{n: {"kernel": _np(pos[2][n]["weight"])[None], "bias": _np(pos[2][n]["bias"])}
               for n in ("q", "k", "v", "proj_out")}}
    return {"embed": _conv_to_jax(q["embed"]),
            "pos_net": [resnet(pos[0]), resnet(pos[1]), attn, resnet(pos[3]),
                        resnet(pos[4]), norm(pos[5])],
            "norm": norm(q["norm"]),
            "convnext": [block(b) for b in q["convnext"]],
            "final_layer_norm": norm(q["final_layer_norm"])}


def encoder_to_jax(params: list, specs: list) -> list:
    """Inverse of ``seanet_from_jax(train=True)`` for an encoder: folded
    convs and LSTM layers -> the JAX package's layout, in numpy."""
    out = []
    for p, s in zip(params, specs):
        if s.kind == "conv":
            out.append(_conv_to_jax(p))
        elif s.kind == "resblock":
            q = {"block": [_conv_to_jax(c) for c in p["block"]]}
            if "shortcut" in p:
                q["shortcut"] = _conv_to_jax(p["shortcut"])
            out.append(q)
        elif s.kind == "lstm":
            out.append({"layers": [{k: _np(v) for k, v in layer.items()}
                                   for layer in p["layers"]]})
        else:
            out.append({})
    return out


def train_tree_from_jax(tree, device):
    """A tree of the JAX package's training-form convs -> this package's:
    every {v, g, ...} node's v and g re-laid-out channel-first ((K, C_in,
    C_out) -> (C_out, C_in, K); (Kh, Kw, C_in, C_out) -> (C_out, C_in, Kh,
    Kw); g alike), every other array copied to a tensor on ``device``.  Works
    on optimizer moments too, which have the params' shapes."""
    if isinstance(tree, dict):
        if "v" in tree and "g" in tree:
            perm = (2, 1, 0) if np.ndim(tree["v"]) == 3 else (3, 2, 0, 1)
            out = {k: train_tree_from_jax(v, device) for k, v in tree.items()}
            out["v"] = _t(np.transpose(tree["v"], perm), device).contiguous()
            out["g"] = _t(np.transpose(tree["g"], perm), device).contiguous()
            return out
        return {k: train_tree_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [train_tree_from_jax(v, device) for v in tree]
    return _t(tree, device)


def train_state_from_jax(state: dict, spec: WavTokenizerSpec, tcfg, device="cuda") -> dict:
    """The JAX package's train state (``train/step.py::create_train_state``
    or ``train_step`` output, as numpy: ``jax.device_get(state)``) -> this
    package's (``train/step.py``), so that a JAX step can be continued here.

    Carries the (v, g) encoder, backbone, head, discriminators, VQ state,
    decoder and step and, when present, optax's AdamW state: the moments
    ``mu``/``nu`` re-laid-out like their params, the update count as each
    tensor's AdamW step, and the schedule's count as the LambdaLR's
    position.  ``tcfg`` is this package's ``TrainConfig``."""
    from ..train.step import new_train_state, tree_leaves

    device = torch.device(device)

    def gen_from_jax(g):
        return {"encoder": train_tree_from_jax(g["encoder"], device),
                "backbone": backbone_from_jax(g["backbone"], device, train=True),
                "head": train_tree_from_jax(g["head"], device)}

    disc_from_jax = lambda d: train_tree_from_jax(d, device)
    out = new_train_state(gen_from_jax(state["gen"]), disc_from_jax(state["disc"]),
                          train_tree_from_jax(state["vq"], device),
                          train_tree_from_jax(state["decoder"], device), tcfg,
                          step=int(np.asarray(state["step"])))
    for name, convert in (("gen", gen_from_jax), ("disc", disc_from_jax)):
        opt_state = state.get(f"opt_{name}")
        if opt_state is None:
            continue
        adam = next(s for s in opt_state if hasattr(s, "mu"))
        sched_count = int(np.asarray(
            [s for s in opt_state if hasattr(s, "count") and not hasattr(s, "mu")][-1].count))
        opt, sched = out[f"opt_{name}"], out[f"sched_{name}"]
        step = torch.tensor(float(np.asarray(adam.count)))
        for p, m, v in zip(opt.param_groups[0]["params"], tree_leaves(convert(adam.mu)),
                           tree_leaves(convert(adam.nu))):
            opt.state[p] = {"step": step.clone(), "exp_avg": m, "exp_avg_sq": v}
        sched.last_epoch = sched_count
        for group in opt.param_groups:
            group["lr"] = sched.lr_lambdas[0](sched_count)
    return out


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
        "backbone": backbone_from_jax(params_np["backbone"], device),
        "head": {"out": {"weight": _t(params_np["head"]["out"]["weight"], device),
                         "bias": _t(params_np["head"]["out"]["bias"], device)}},
    }


def _params_to(tree, device: torch.device):
    """A copy of a params tree on ``device``: tensors copied, modules (the
    inference LSTMs) deep-copied and moved."""
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_params_to(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    if isinstance(tree, torch.nn.Module):
        return copy.deepcopy(tree).to(device)
    return tree


class WavTokenizer:
    """Inference facade around (params, WavTokenizerSpec) on one device."""

    def __init__(self, params: dict, spec: WavTokenizerSpec, device="cuda"):
        self.params = params
        self.spec = spec
        self.device = torch.device(device)

    def to(self, device) -> "WavTokenizer":
        """A replica on ``device``, with its own copy of the weights (the
        data-parallel engine and extraction keep one per device)."""
        device = torch.device(device)
        return WavTokenizer(_params_to(self.params, device), self.spec, device)

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
    def from_pretrained0828(cls, config_path: str, model_path: str,
                            device="cuda") -> "WavTokenizer":
        """As ``from_pretrained0802``, for a checkpoint that also carries
        the MPD/MRD (and DAC) discriminators (ref
        decoder/pretrained_model.py:52-86): they are kept, in the training
        layout (``train/discriminators.py``, numpy), as
        ``self.discriminators``."""
        spec = spec_from_config(config_path)
        sd = load_torch_state_dict(model_path,
                                   prefixes=INFERENCE_PREFIXES + DISCRIMINATOR_PREFIXES)
        model = cls.from_state_dict(sd, spec, device)
        model.discriminators = discriminator_params(sd)
        return model

    @classmethod
    def from_train_checkpoint(cls, config_path: str, ckpt_path: str,
                              device="cuda") -> "WavTokenizer":
        """One of this package's training checkpoints (``Trainer`` output:
        ``last.pt``, ``wavtokenizer_checkpoint_step=...pt``) for inference:
        weight norm folded, the codebook, backbone and head as trained."""
        from ..train.step import state_to_inference_params
        spec = spec_from_config(config_path)
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        return cls.from_jax_params(state_to_inference_params(ckpt, spec), spec, device)

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


def vocos_from_jax_params(params_np: dict, spec, device="cuda") -> dict:
    """The JAX package's plain-Vocos params (numpy; ``init_vocos`` or
    ``convert_vocos_state_dict`` output) -> this package's on ``device``:
    a ConvNeXt trunk as ``backbone_from_jax`` makes it (bf16 matmul weights
    with the kernel's packs), a ResNet trunk's convs (C_out, C_in, K), the
    head's Linear (C_in, C_out)."""
    device = torch.device(device)
    p = params_np["backbone"]
    if spec.backbone_kind == "convnext":
        backbone = backbone_from_jax(p, device)
    else:
        backbone = {"embed": _conv(p["embed"], device),
                    "resnet": [{"convs1": [_conv(c, device) for c in b["convs1"]],
                                "convs2": [_conv(c, device) for c in b["convs2"]],
                                "gamma": [None if g is None else _t(g, device)
                                          for g in b["gamma"]]}
                               for b in p["resnet"]]}
    out = params_np["head"]["out"]
    return {"backbone": backbone,
            "head": {"out": {"weight": _t(out["weight"], device),
                             "bias": _t(out["bias"], device)}}}


class Vocos:
    """Plain-Vocos facade (mel features -> trunk -> head) around (params,
    ``VocosSpec``) on one device: the upstream Vocos mode the reference
    carries beside WavTokenizer (MelSpectrogramFeatures + VocosBackbone or
    VocosResNetBackbone + ISTFT or IMDCT heads)."""

    def __init__(self, params: dict, spec, device="cuda"):
        self.params = params
        self.spec = spec
        self.device = torch.device(device)

    @classmethod
    def from_hparams(cls, config_path: str, device="cuda") -> "Vocos":
        """The spec of a YAML config, with no params (as the JAX facade's:
        draw them with ``init_vocos`` and use ``from_jax_params``)."""
        return cls({}, vocos_spec_from_config(config_path), device)

    @classmethod
    def from_jax_params(cls, params_np: dict, spec, device="cuda") -> "Vocos":
        return cls(vocos_from_jax_params(params_np, spec, device), spec, device)

    @classmethod
    def from_state_dict(cls, state_dict: dict, spec, device="cuda") -> "Vocos":
        """From a state dict ({key: tensor or ndarray}, keys under backbone. /
        head.)."""
        return cls.from_jax_params(convert_vocos_state_dict(state_dict, spec), spec, device)

    @classmethod
    def from_pretrained(cls, config_path: str, model_path: str, device="cuda") -> "Vocos":
        """A YAML config and a torch checkpoint of the model."""
        return cls.from_state_dict(load_torch_state_dict(model_path),
                                   vocos_spec_from_config(config_path), device)

    def _audio(self, audio) -> torch.Tensor:
        a = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
        return a[None] if a.dim() == 1 else a

    def feature_extractor(self, audio_input) -> torch.Tensor:
        """(B, T) or (T,) audio -> (B, n_mels, T') log-mel features."""
        return vocos_model.vocos_features(self.params, self.spec, self._audio(audio_input))

    def decode(self, features_input, bandwidth_id=None) -> torch.Tensor:
        """(B, C, T') features -> (B, L) waveform.  ``bandwidth_id`` is
        ignored, as the JAX facade ignores it: the plain-Vocos trunks have
        no AdaLN."""
        features = torch.as_tensor(features_input, dtype=torch.float32).to(self.device)
        return vocos_model.vocos_decode(self.params, self.spec, features)

    def __call__(self, audio_input, bandwidth_id=None) -> torch.Tensor:
        """Copy synthesis: features, then decode."""
        return vocos_model.vocos_forward(self.params, self.spec, self._audio(audio_input))

    forward = __call__
