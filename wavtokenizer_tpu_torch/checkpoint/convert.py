"""Lightning state dict -> the JAX package's param pytree, in numpy.

Port of the inference subset of ``wavtokenizer_tpu/checkpoint/convert.py``:
weight norm (g * v / |v|) folded in float64 as torch's ``_weight_norm`` does,
and every tensor re-laid-out channel-last like the JAX package:

* Conv1d   (O, I, K)  ->  (K, I, O)
* ConvTr1d (I, O, K)  ->  (K, I, O)
* Linear   (O, I)     ->  (I, O)

``api.pretrained.WavTokenizer.from_state_dict`` feeds the result to
``from_jax_params``, so weights reach this package by one road.  Values may
be torch tensors or numpy arrays.  ``convert_encodec_state_dict`` reads a
pretrained EnCodec model's state dict the same way, and
``convert_vocos_state_dict`` a plain-Vocos model's (the ResNet trunk and the
IMDCT heads beside the ConvNeXt trunk and the ISTFT head).

The discriminators (``discriminator_params``, for ``from_pretrained0828``
and the surgical training resume) stay in weight-norm (v, g) form and in
PyTorch's own layout, the training state's (``train/discriminators.py``).
"""

from __future__ import annotations

import numpy as np

from ..models.seanet import LayerSpec, decoder_layer_specs, encoder_layer_specs
from ..models.vocos import VocosBackboneConfig
from ..models.wavtokenizer import WavTokenizerSpec


class MissingKey(KeyError):
    pass


class TrackedStateDict:
    """Read-only view of a state dict that records the keys read, so a
    caller can check that a conversion used every key."""

    def __init__(self, sd: dict):
        self._sd = sd
        self.used: set[str] = set()

    def __contains__(self, key: str) -> bool:
        return key in self._sd

    def __getitem__(self, key: str) -> np.ndarray:
        if key not in self._sd:
            raise MissingKey(key)
        self.used.add(key)
        v = self._sd[key]
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        return np.asarray(v, dtype=np.float32)

    def keys(self):
        return self._sd.keys()

    def unused(self) -> set[str]:
        return set(self._sd) - self.used


def fold_weight_norm_weight(sd: TrackedStateDict, prefix: str) -> np.ndarray:
    """Effective weight of a conv/linear in any of the three layouts: legacy
    ``weight_g``/``weight_v``, ``parametrizations.weight.original0/1``, or a
    plain ``weight``."""
    if f"{prefix}.weight_v" in sd:
        g, v = sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"]
    elif f"{prefix}.parametrizations.weight.original0" in sd:
        g = sd[f"{prefix}.parametrizations.weight.original0"]
        v = sd[f"{prefix}.parametrizations.weight.original1"]
    else:
        return sd[f"{prefix}.weight"]
    g, v = g.astype(np.float64), v.astype(np.float64)
    norm = np.sqrt((v * v).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return (v * (g / norm)).astype(np.float32)


def _bias(sd: TrackedStateDict, prefix: str):
    return sd[f"{prefix}.bias"] if f"{prefix}.bias" in sd else None


def conv1d_params(sd: TrackedStateDict, prefix: str) -> dict:
    """Conv1d (O, I, K) -> {'kernel': (K, I, O), 'bias': (O,)}."""
    w = fold_weight_norm_weight(sd, prefix)
    return {"kernel": np.transpose(w, (2, 1, 0)), "bias": _bias(sd, prefix)}


def convtr1d_params(sd: TrackedStateDict, prefix: str) -> dict:
    """ConvTranspose1d (I, O, K) -> {'kernel': (K, I, O), 'bias': (O,)}."""
    w = fold_weight_norm_weight(sd, prefix)
    return {"kernel": np.transpose(w, (2, 0, 1)), "bias": _bias(sd, prefix)}


def linear_params(sd: TrackedStateDict, prefix: str) -> dict:
    w = fold_weight_norm_weight(sd, prefix)
    return {"weight": np.ascontiguousarray(w.T), "bias": sd[f"{prefix}.bias"]}


def norm_params(sd: TrackedStateDict, prefix: str) -> dict:
    return {"weight": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def lstm_params(sd: TrackedStateDict, prefix: str, num_layers: int) -> dict:
    return {"layers": [{"w_ih": sd[f"{prefix}.weight_ih_l{k}"],
                        "w_hh": sd[f"{prefix}.weight_hh_l{k}"],
                        "b_ih": sd[f"{prefix}.bias_ih_l{k}"],
                        "b_hh": sd[f"{prefix}.bias_hh_l{k}"]}
                       for k in range(num_layers)]}


def seanet_params(sd: TrackedStateDict, root: str, specs: list[LayerSpec]) -> list:
    """Flat per-layer params from torch keys under ``root``
    (e.g. 'feature_extractor.encodec.encoder.')."""

    def with_gn(p: dict, norm_prefix: str, spec: LayerSpec) -> dict:
        # time_group_norm: NormConv(Transpose)1d holds a GroupNorm(1, C) as
        # `.norm` beside the inner conv (ref conv.py:112-122,145-155).
        if spec.norm == "time_group_norm":
            p["gn"] = norm_params(sd, norm_prefix)
        return p

    def conv(pre: str, spec: LayerSpec) -> dict:
        return with_gn(conv1d_params(sd, f"{pre}.conv.conv"), f"{pre}.conv.norm", spec)

    params = []
    for spec in specs:
        pre = f"{root}{spec.prefix}"
        if spec.kind == "conv":
            params.append(conv(pre, spec))
        elif spec.kind == "convtr":
            params.append(with_gn(convtr1d_params(sd, f"{pre}.convtr.convtr"),
                                  f"{pre}.convtr.norm", spec))
        elif spec.kind == "resblock":
            # Sequential [ELU, conv, ELU, conv]: the convs sit at 1 and 3.
            p = {"block": [conv(f"{pre}.block.{2 * i + 1}", spec)
                           for i in range(len(spec.block_kernel_sizes))]}
            if not spec.true_skip:
                p["shortcut"] = conv(f"{pre}.shortcut", spec)
            params.append(p)
        elif spec.kind == "lstm":
            params.append(lstm_params(sd, f"{pre}.lstm", spec.num_lstm_layers))
        else:
            params.append({})
    return params


def quantizer_params(sd: TrackedStateDict, root: str, n_q: int) -> dict:
    """Stacked codebooks from vq.layers.{q}._codebook.* under ``root``,
    with the EMA buffers when present."""
    pre = [f"{root}vq.layers.{q}._codebook" for q in range(n_q)]
    out = {"embed": np.stack([sd[f"{p}.embed"] for p in pre])}
    if f"{pre[0]}.embed_avg" in sd:
        for name in ("embed_avg", "cluster_size", "inited"):
            out[name] = np.stack([sd[f"{p}.{name}"] for p in pre])
    return out


def _adaln_params(sd: TrackedStateDict, p: str) -> dict:
    return {"scale": sd[f"{p}.scale.weight"], "shift": sd[f"{p}.shift.weight"]}


def vocos_backbone_params(sd: TrackedStateDict, root: str,
                          cfg: VocosBackboneConfig) -> dict:
    def resnet(p):
        return {"norm1": norm_params(sd, f"{p}.norm1"),
                "conv1": conv1d_params(sd, f"{p}.conv1"),
                "norm2": norm_params(sd, f"{p}.norm2"),
                "conv2": conv1d_params(sd, f"{p}.conv2")}

    attn = f"{root}pos_net.2"
    params = {
        "embed": conv1d_params(sd, f"{root}embed"),
        "pos_net": [
            resnet(f"{root}pos_net.0"), resnet(f"{root}pos_net.1"),
            {"norm": norm_params(sd, f"{attn}.norm"),
             **{n: conv1d_params(sd, f"{attn}.{n}") for n in ("q", "k", "v", "proj_out")}},
            resnet(f"{root}pos_net.3"), resnet(f"{root}pos_net.4"),
            norm_params(sd, f"{root}pos_net.5"),
        ],
    }
    params["norm"] = (_adaln_params(sd, f"{root}norm") if cfg.adanorm_num_embeddings
                      else norm_params(sd, f"{root}norm"))
    convnext = []
    for i in range(cfg.num_layers):
        p = f"{root}convnext.{i}"
        block = {"dwconv": conv1d_params(sd, f"{p}.dwconv"),
                 "pwconv1": linear_params(sd, f"{p}.pwconv1"),
                 "pwconv2": linear_params(sd, f"{p}.pwconv2")}
        if cfg.adanorm_num_embeddings:
            block["adanorm"] = _adaln_params(sd, f"{p}.norm")
        else:
            block["norm"] = norm_params(sd, f"{p}.norm")
        if f"{p}.gamma" in sd:
            block["gamma"] = sd[f"{p}.gamma"]
        convnext.append(block)
    params["convnext"] = convnext
    params["final_layer_norm"] = norm_params(sd, f"{root}final_layer_norm")
    return params


def istft_head_params(sd: TrackedStateDict, root: str) -> dict:
    return {"out": linear_params(sd, f"{root}out")}


def resnet_backbone_params(sd: TrackedStateDict, root: str, num_blocks: int = 3) -> dict:
    """VocosResNetBackbone (ref decoder/models.py:238-264): the weight-normed
    embed conv k3 and ``num_blocks`` ResBlock1s (convs1/convs2 x 3, gamma)."""
    blocks = [{"convs1": [conv1d_params(sd, f"{root}resnet.{i}.convs1.{j}") for j in range(3)],
               "convs2": [conv1d_params(sd, f"{root}resnet.{i}.convs2.{j}") for j in range(3)],
               "gamma": [sd[f"{root}resnet.{i}.gamma.{j}"][:, 0] for j in range(3)]}
              for i in range(num_blocks)]
    return {"embed": conv1d_params(sd, f"{root}embed"), "resnet": blocks}


def imdct_head_params(sd: TrackedStateDict, root: str) -> dict:
    """IMDCTSymExpHead / IMDCTCosHead's Linear (ref decoder/heads.py:70-157)."""
    return {"out": linear_params(sd, f"{root}out")}


def convert_vocos_state_dict(sd, spec) -> dict:
    """A plain-Vocos state dict (keys under backbone. / head.) -> the JAX
    package's param pytree for ``spec`` (a ``VocosSpec``)."""
    if not isinstance(sd, TrackedStateDict):
        sd = TrackedStateDict(sd)
    if spec.backbone_kind == "convnext":
        backbone = vocos_backbone_params(sd, "backbone.", spec.backbone)
    else:
        backbone = resnet_backbone_params(sd, "backbone.", spec.backbone.num_blocks)
    head = (istft_head_params(sd, "head.") if spec.head_kind == "istft"
            else imdct_head_params(sd, "head."))
    return {"backbone": backbone, "head": head}


def convert_wavtokenizer_state_dict(sd, spec: WavTokenizerSpec) -> dict:
    """Lightning state dict (or a ``TrackedStateDict`` over one) -> the JAX
    package's param pytree for the WavTokenizer facade."""
    if not isinstance(sd, TrackedStateDict):
        sd = TrackedStateDict(sd)
    fe = "feature_extractor.encodec."
    return {
        "encoder": seanet_params(sd, f"{fe}encoder.", encoder_layer_specs(spec.seanet)),
        "decoder": seanet_params(sd, f"{fe}decoder.", decoder_layer_specs(spec.seanet)),
        "quantizer": quantizer_params(sd, f"{fe}quantizer.", spec.vq.n_q),
        "backbone": vocos_backbone_params(sd, "backbone.", spec.backbone),
        "head": istft_head_params(sd, "head."),
    }


def convert_encodec_state_dict(sd, cfg) -> dict:
    """A raw pretrained-EnCodec state dict (``encodec_*.th``, keys under
    encoder. / decoder. / quantizer.; ref encoder/model.py:250-281) -> the
    JAX package's param pytree for ``models/encodec.py``.  ``cfg`` is an
    ``EncodecConfig``; the GroupNorm params of a time_group_norm model are
    read through the layer specs."""
    if not isinstance(sd, TrackedStateDict):
        sd = TrackedStateDict(sd)
    return {
        "encoder": seanet_params(sd, "encoder.", encoder_layer_specs(cfg.seanet)),
        "decoder": seanet_params(sd, "decoder.", decoder_layer_specs(cfg.seanet)),
        "quantizer": quantizer_params(sd, "quantizer.", cfg.vq.n_q),
    }


INFERENCE_PREFIXES = ("backbone.", "head.", "feature_extractor.")
DISCRIMINATOR_PREFIXES = ("multiperioddisc.", "multiresddisc.", "dac.")


def load_torch_state_dict(path: str, prefixes=INFERENCE_PREFIXES) -> dict:
    """A torch/Lightning checkpoint file -> {key: np.ndarray}, keeping only
    the keys under ``prefixes`` (ref decoder/pretrained.py:101-105; the 0828
    loader keeps the discriminators' too, pretrained_model.py:75-79).

    Tries ``weights_only=True`` first; a checkpoint that pickles other
    objects (Lightning's hyper-parameters) is loaded in full after that."""
    import torch
    try:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        raw = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in raw.items()
            if k.startswith(prefixes)}


def average_state_dicts(sds: list[dict]) -> dict:
    """Checkpoint averaging, in float64 (ref decoder/pretrained.py:117-156)."""
    keys = sds[0].keys()
    return {k: np.mean([np.asarray(sd[k], dtype=np.float64) for sd in sds], axis=0)
                .astype(np.float32) for k in keys}


# --------------------------------------------------------------------------
# Discriminators (from_pretrained0828 and the surgical training resume)
# --------------------------------------------------------------------------

def conv2d_wn_params(sd: TrackedStateDict, prefix: str) -> dict:
    """A weight-normed Conv2d, kept UNFOLDED (the discriminators train):
    {v (O, I, Kh, Kw), g (O, 1, 1, 1), bias}, the reference's own layout."""
    if f"{prefix}.weight_v" in sd:
        g, v = sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"]
    elif f"{prefix}.parametrizations.weight.original0" in sd:
        g = sd[f"{prefix}.parametrizations.weight.original0"]
        v = sd[f"{prefix}.parametrizations.weight.original1"]
    else:
        raise MissingKey(f"{prefix}.weight_v")
    return {"v": v, "g": g.reshape(-1, 1, 1, 1), "bias": sd[f"{prefix}.bias"]}


def _disc_unit_params(sd: TrackedStateDict, p: str, n_convs: int) -> dict:
    d = {"convs": [conv2d_wn_params(sd, f"{p}.convs.{j}") for j in range(n_convs)],
         "conv_post": conv2d_wn_params(sd, f"{p}.conv_post")}
    if f"{p}.emb.weight" in sd:
        d["emb"] = sd[f"{p}.emb.weight"]
    return d


def discriminator_params(sd, include_dac: bool = True) -> dict:
    """The Vocos MPD/MRD and (when present) DAC discriminators of a
    Lightning state dict (attributes multiperioddisc / multiresddisc / dac,
    ref experiment.py:70-74, pretrained_model.py:49-50) -> the training
    layout of ``train/discriminators.py``, in numpy."""
    if not isinstance(sd, TrackedStateDict):
        sd = TrackedStateDict(sd)
    out = {"mpd": [_disc_unit_params(sd, f"multiperioddisc.discriminators.{i}", 5)
                   for i in range(5)],
           "mrd": [_disc_unit_params(sd, f"multiresddisc.discriminators.{i}", 5)
                   for i in range(3)]}
    if include_dac and any(k.startswith("dac.") for k in sd.keys()):
        # DAC's list: 5 MPDs (periods 2, 3, 5, 7, 11), then 3 MRDs; each
        # conv but conv_post sits in a Sequential (WNConv2d), hence ".0".
        out["dac_mpd"] = [
            {"convs": [conv2d_wn_params(sd, f"dac.discriminators.{i}.convs.{j}.0")
                       for j in range(5)],
             "conv_post": conv2d_wn_params(sd, f"dac.discriminators.{i}.conv_post")}
            for i in range(5)]
        out["dac_mrd"] = [
            {"bands": [[conv2d_wn_params(sd, f"dac.discriminators.{i}.band_convs.{b}.{j}.0")
                        for j in range(5)] for b in range(5)],
             "conv_post": conv2d_wn_params(sd, f"dac.discriminators.{i}.conv_post")}
            for i in range(5, 8)]
    return out


def surgical_resume_params(sd, spec: WavTokenizerSpec, keep_quantizer_layers: int = 8) -> dict:
    """Per-submodule checkpoint surgery for a training resume (ref
    decoder/experiment.py:398-445): encoder, decoder, the quantizer's layers
    below ``keep_quantizer_layers`` only (the reference's filter), backbone
    and head in the JAX package's layout, and "discriminators" when the
    checkpoint carries them."""
    if not isinstance(sd, TrackedStateDict):
        sd = TrackedStateDict(sd)
    fe = "feature_extractor.encodec."
    params = {
        "encoder": seanet_params(sd, f"{fe}encoder.", encoder_layer_specs(spec.seanet)),
        "decoder": seanet_params(sd, f"{fe}decoder.", decoder_layer_specs(spec.seanet)),
        "quantizer": quantizer_params(sd, f"{fe}quantizer.",
                                      min(spec.vq.n_q, keep_quantizer_layers)),
        "backbone": vocos_backbone_params(sd, "backbone.", spec.backbone),
        "head": istft_head_params(sd, "head."),
    }
    if any(k.startswith("multiperioddisc.") for k in sd.keys()):
        params["discriminators"] = discriminator_params(sd)
    return params
