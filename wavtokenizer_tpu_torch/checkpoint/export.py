"""The JAX package's param pytree, or a training state -> a Lightning
state dict that the PyTorch reference loads.

Port of ``wavtokenizer_tpu/checkpoint/export.py``, the inverse of
``checkpoint/convert.py``: the codec's params in the JAX package's layout
(numpy, what ``train/step.py::state_to_inference_params`` returns) go out
under ``feature_extractor.* / backbone.* / head.*`` (ref
decoder/pretrained.py:95-114), the discriminators of a training state under
``multiperioddisc. / multiresddisc. / dac.`` (ref experiment.py:60-74).

Weight norm: the folded weights w of the codec go out as ``weight_v = w``
and ``weight_g = |w|`` (per first-axis slice), so g * v / |v| = w exactly;
the discriminators' (v, g) go out as they are trained.  ``wn_layout``
names the keys: ``"weight_g"`` (``torch.nn.utils.weight_norm``, the
reference's and its released checkpoints') or ``"parametrizations"``
(torch >= 2.1).
"""

from __future__ import annotations

import numpy as np

from ..models.seanet import LayerSpec, SEANetConfig, decoder_layer_specs, encoder_layer_specs
from ..models.vocos import VocosBackboneConfig


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _emit_weight_norm(out: dict, prefix: str, g: np.ndarray, v: np.ndarray,
                      wn_layout: str) -> None:
    if wn_layout == "weight_g":
        out[f"{prefix}.weight_g"] = g
        out[f"{prefix}.weight_v"] = v
    elif wn_layout == "parametrizations":
        out[f"{prefix}.parametrizations.weight.original0"] = g
        out[f"{prefix}.parametrizations.weight.original1"] = v
    else:
        raise ValueError(wn_layout)


def _emit_weight(out: dict, prefix: str, w: np.ndarray, wn: bool, wn_layout: str) -> None:
    if not wn:
        out[f"{prefix}.weight"] = w
        return
    w64 = w.astype(np.float64)
    g = np.sqrt((w64 * w64).sum(axis=tuple(range(1, w.ndim)), keepdims=True))
    _emit_weight_norm(out, prefix, g.astype(np.float32), w.astype(np.float32), wn_layout)


def conv1d_export(out: dict, prefix: str, p: dict, wn: bool, wn_layout: str) -> None:
    """{'kernel': (K, I, O)} -> torch Conv1d weight (O, I, K) (+ bias)."""
    _emit_weight(out, prefix, np.transpose(_np(p["kernel"]), (2, 1, 0)), wn, wn_layout)
    if p.get("bias") is not None:
        out[f"{prefix}.bias"] = _np(p["bias"])


def convtr1d_export(out: dict, prefix: str, p: dict, wn: bool, wn_layout: str) -> None:
    """{'kernel': (K, I, O)} -> torch ConvTranspose1d weight (I, O, K)."""
    _emit_weight(out, prefix, np.transpose(_np(p["kernel"]), (1, 2, 0)), wn, wn_layout)
    if p.get("bias") is not None:
        out[f"{prefix}.bias"] = _np(p["bias"])


def linear_export(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = np.ascontiguousarray(_np(p["weight"]).T)
    out[f"{prefix}.bias"] = _np(p["bias"])


def norm_export(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = _np(p["weight"])
    out[f"{prefix}.bias"] = _np(p["bias"])


def lstm_export(out: dict, prefix: str, p: dict) -> None:
    for k, layer in enumerate(p["layers"]):
        out[f"{prefix}.weight_ih_l{k}"] = _np(layer["w_ih"])
        out[f"{prefix}.weight_hh_l{k}"] = _np(layer["w_hh"])
        out[f"{prefix}.bias_ih_l{k}"] = _np(layer["b_ih"])
        out[f"{prefix}.bias_hh_l{k}"] = _np(layer["b_hh"])


def seanet_export(out: dict, root: str, params: list, specs: list[LayerSpec],
                  wn_layout: str) -> None:
    """Inverse of ``convert.seanet_params`` (same module indices and keys)."""
    for p, spec in zip(params, specs):
        wn = spec.norm in ("weight_norm", "spectral_norm")
        gn = spec.norm == "time_group_norm"
        if spec.kind == "conv":
            conv1d_export(out, f"{root}{spec.prefix}.conv.conv", p, wn, wn_layout)
            if gn:
                norm_export(out, f"{root}{spec.prefix}.conv.norm", p["gn"])
        elif spec.kind == "convtr":
            convtr1d_export(out, f"{root}{spec.prefix}.convtr.convtr", p, wn, wn_layout)
            if gn:
                norm_export(out, f"{root}{spec.prefix}.convtr.norm", p["gn"])
        elif spec.kind == "resblock":
            for bi, conv_p in enumerate(p["block"]):
                pre = f"{root}{spec.prefix}.block.{2 * bi + 1}.conv"
                conv1d_export(out, f"{pre}.conv", conv_p, wn, wn_layout)
                if gn:
                    norm_export(out, f"{pre}.norm", conv_p["gn"])
            if "shortcut" in p:
                pre = f"{root}{spec.prefix}.shortcut.conv"
                conv1d_export(out, f"{pre}.conv", p["shortcut"], wn, wn_layout)
                if gn:
                    norm_export(out, f"{pre}.norm", p["shortcut"]["gn"])
        elif spec.kind == "lstm":
            lstm_export(out, f"{root}{spec.prefix}.lstm", p)


def quantizer_export(out: dict, root: str, p: dict) -> None:
    """Inverse of ``convert.quantizer_params``.  Params without the EMA
    buffers get the state of a fresh EMA reset (embed_avg = embed,
    cluster_size = 1, inited = 1; ref core_vq.py:140-151)."""
    embed = _np(p["embed"])                      # (n_q, bins, dim)
    n_q, bins, _ = embed.shape
    embed_avg = _np(p["embed_avg"]) if "embed_avg" in p else embed.copy()
    cluster = _np(p["cluster_size"]) if "cluster_size" in p else np.ones((n_q, bins), np.float32)
    inited = _np(p["inited"]) if "inited" in p else np.ones((n_q, 1), np.float32)
    for q in range(n_q):
        pre = f"{root}vq.layers.{q}._codebook"
        out[f"{pre}.embed"] = embed[q]
        out[f"{pre}.embed_avg"] = embed_avg[q]
        out[f"{pre}.cluster_size"] = cluster[q]
        out[f"{pre}.inited"] = np.reshape(inited[q], (1,))


def vocos_backbone_export(out: dict, root: str, p: dict, cfg: VocosBackboneConfig) -> None:
    """Inverse of ``convert.vocos_backbone_params`` (the backbone's convs and
    linears carry no weight norm in the reference)."""
    conv1d_export(out, f"{root}embed", p["embed"], False, "weight_g")
    pos = p["pos_net"]
    for i in (0, 1, 3, 4):
        pre = f"{root}pos_net.{i}"
        norm_export(out, f"{pre}.norm1", pos[i]["norm1"])
        conv1d_export(out, f"{pre}.conv1", pos[i]["conv1"], False, "weight_g")
        norm_export(out, f"{pre}.norm2", pos[i]["norm2"])
        conv1d_export(out, f"{pre}.conv2", pos[i]["conv2"], False, "weight_g")
    norm_export(out, f"{root}pos_net.2.norm", pos[2]["norm"])
    for name in ("q", "k", "v", "proj_out"):
        conv1d_export(out, f"{root}pos_net.2.{name}", pos[2][name], False, "weight_g")
    norm_export(out, f"{root}pos_net.5", pos[5])
    if "scale" in p["norm"]:
        out[f"{root}norm.scale.weight"] = _np(p["norm"]["scale"])
        out[f"{root}norm.shift.weight"] = _np(p["norm"]["shift"])
    else:
        norm_export(out, f"{root}norm", p["norm"])
    for i, block in enumerate(p["convnext"]):
        pre = f"{root}convnext.{i}"
        conv1d_export(out, f"{pre}.dwconv", block["dwconv"], False, "weight_g")
        if "adanorm" in block:
            out[f"{pre}.norm.scale.weight"] = _np(block["adanorm"]["scale"])
            out[f"{pre}.norm.shift.weight"] = _np(block["adanorm"]["shift"])
        else:
            norm_export(out, f"{pre}.norm", block["norm"])
        linear_export(out, f"{pre}.pwconv1", block["pwconv1"])
        linear_export(out, f"{pre}.pwconv2", block["pwconv2"])
        if "gamma" in block:
            out[f"{pre}.gamma"] = _np(block["gamma"])
    norm_export(out, f"{root}final_layer_norm", p["final_layer_norm"])


def wavtokenizer_state_dict(params: dict, seanet_cfg: SEANetConfig,
                            backbone_cfg: VocosBackboneConfig,
                            head_n_fft: int | None = None,
                            wn_layout: str = "weight_g") -> dict:
    """Inference pytree (the JAX package's layout) -> reference-layout state
    dict (inverse of ``convert.convert_wavtokenizer_state_dict``).
    ``head_n_fft`` adds the ISTFT head's registered periodic Hann window
    (``head.istft.window``, spectral_ops.py:30-31), so torch's
    ``load_state_dict(strict=True)`` finds every key."""
    out: dict = {}
    fe = "feature_extractor.encodec."
    seanet_export(out, f"{fe}encoder.", params["encoder"], encoder_layer_specs(seanet_cfg),
                  wn_layout)
    seanet_export(out, f"{fe}decoder.", params["decoder"], decoder_layer_specs(seanet_cfg),
                  wn_layout)
    quantizer_export(out, f"{fe}quantizer.", params["quantizer"])
    vocos_backbone_export(out, "backbone.", params["backbone"], backbone_cfg)
    linear_export(out, "head.out", params["head"]["out"])
    if head_n_fft is not None:
        n = np.arange(head_n_fft)
        out["head.istft.window"] = (0.5 * (1.0 - np.cos(2.0 * np.pi * n / head_n_fft))
                                    ).astype(np.float32)
    return out


def _conv2d_wn_export(out: dict, prefix: str, p: dict, wn_layout: str) -> None:
    """A training-form Conv2d {v (O, I, Kh, Kw), g (O, 1, 1, 1), bias}: the
    reference's own layout, so (v, g) go out unchanged."""
    _emit_weight_norm(out, prefix, _np(p["g"]), _np(p["v"]), wn_layout)
    out[f"{prefix}.bias"] = _np(p["bias"])


def discriminators_export(out: dict, disc: dict, wn_layout: str = "weight_g") -> None:
    """Inverse of ``convert.discriminator_params``: the Lightning attribute
    layout multiperioddisc. / multiresddisc. / dac. (DAC wraps each conv but
    conv_post in a Sequential, hence the '.0' segments)."""
    def unit(prefix, d):
        for j, c in enumerate(d["convs"]):
            _conv2d_wn_export(out, f"{prefix}.convs.{j}", c, wn_layout)
        _conv2d_wn_export(out, f"{prefix}.conv_post", d["conv_post"], wn_layout)
        if "emb" in d:
            out[f"{prefix}.emb.weight"] = _np(d["emb"])

    for i, d in enumerate(disc.get("mpd", [])):
        unit(f"multiperioddisc.discriminators.{i}", d)
    for i, d in enumerate(disc.get("mrd", [])):
        unit(f"multiresddisc.discriminators.{i}", d)
    for i, d in enumerate(disc.get("dac_mpd", [])):
        p = f"dac.discriminators.{i}"
        for j, c in enumerate(d["convs"]):
            _conv2d_wn_export(out, f"{p}.convs.{j}.0", c, wn_layout)
        _conv2d_wn_export(out, f"{p}.conv_post", d["conv_post"], wn_layout)
    for i, d in enumerate(disc.get("dac_mrd", [])):
        p = f"dac.discriminators.{i + 5}"
        for b, stack in enumerate(d["bands"]):
            for j, c in enumerate(stack):
                _conv2d_wn_export(out, f"{p}.band_convs.{b}.{j}.0", c, wn_layout)
        _conv2d_wn_export(out, f"{p}.conv_post", d["conv_post"], wn_layout)


def export_training_state_dict(state: dict, spec, wn_layout: str = "weight_g") -> dict:
    """A training state (``train/step.py``) -> the reference's Lightning
    state dict: the generator, the quantizer's EMA buffers and all three
    discriminator families; the reference's surgical resume
    (experiment.py:398-445), ``trainer.surgical_train_state`` and
    ``from_pretrained0828`` (this package's and the JAX package's) load it."""
    from ..train.step import state_to_inference_params

    out = wavtokenizer_state_dict(state_to_inference_params(state, spec), spec.seanet,
                                  spec.backbone, head_n_fft=spec.head.n_fft,
                                  wn_layout=wn_layout)
    discriminators_export(out, state["disc"], wn_layout)
    return out


def save_torch_checkpoint(path: str, state_dict: dict) -> None:
    """A Lightning-style checkpoint ({'state_dict': tensors}) that the
    reference's from_pretrained0802 reads."""
    import torch
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v))
                               for k, v in state_dict.items()}}, path)
