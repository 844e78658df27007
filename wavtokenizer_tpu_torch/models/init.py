"""Seeded random parameters for the whole model, in numpy only.

A copy of ``wavtokenizer_tpu/models/init.py::init_wavtokenizer`` that draws
the same numbers in the same order from ``np.random.default_rng(seed)``, so
that both packages build bit-identical weights from one seed; the golden
tokens in ``tests/golden/bench_tokens.npz`` come from
``init_wavtokenizer(spec, seed=0, random_codebook=True)``.  The result is the JAX
package's param pytree (numpy, channel-last kernels (K, C_in, C_out), Linear
weights (C_in, C_out)); ``api.pretrained.WavTokenizer.from_jax_params`` turns
it into this package's tensors.

Init semantics (ref): SEANet convs as torch Conv1d defaults (weight norm g =
|v|, so the folded kernel is v); Vocos embed/ConvNeXt/head trunc_normal(0.02)
with zero bias, pos-net in torch defaults; AdaLN scale 1, shift 0; layer
scale 1/num_layers; LSTM U(-1/sqrt(H), 1/sqrt(H)); codebook kaiming-uniform
when ``random_codebook`` (else zeros awaiting k-means).
"""

from __future__ import annotations

import numpy as np

from .quantize import VQConfig
from .seanet import SEANetConfig, decoder_layer_specs, encoder_layer_specs
from .vocos import ISTFTHeadConfig, VocosBackboneConfig
from .wavtokenizer import WavTokenizerSpec


def _conv_default(rng, k, cin, cout, groups=1):
    fan_in = (cin // groups) * k
    bound = 1.0 / np.sqrt(fan_in)
    return {
        "kernel": rng.uniform(-bound, bound, size=(k, cin // groups, cout)).astype(np.float32),
        "bias": rng.uniform(-bound, bound, size=(cout,)).astype(np.float32),
    }


def _convtr_default(rng, k, cin, cout):
    # torch ConvTranspose1d fan_in = out_channels * k (weight (in, out, k), dim0=in)
    fan_in = cout * k
    bound = 1.0 / np.sqrt(fan_in)
    return {
        "kernel": rng.uniform(-bound, bound, size=(k, cin, cout)).astype(np.float32),
        "bias": rng.uniform(-bound, bound, size=(cout,)).astype(np.float32),
    }


def _trunc_normal(rng, shape, std=0.02):
    # torch trunc_normal_: truncated to [-2std, 2std]
    x = rng.normal(0.0, std, size=shape)
    while True:
        bad = np.abs(x) > 2 * std
        if not bad.any():
            break
        x[bad] = rng.normal(0.0, std, size=bad.sum())
    return x.astype(np.float32)


def _conv_trunc(rng, k, cin, cout, groups=1):
    return {"kernel": _trunc_normal(rng, (k, cin // groups, cout)),
            "bias": np.zeros(cout, np.float32)}


def _linear_trunc(rng, cin, cout):
    return {"weight": _trunc_normal(rng, (cin, cout)),
            "bias": np.zeros(cout, np.float32)}


def _norm_ones(c):
    return {"weight": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}


def _lstm_default(rng, num_layers, dim):
    bound = 1.0 / np.sqrt(dim)
    layers = []
    for _ in range(num_layers):
        layers.append({
            "w_ih": rng.uniform(-bound, bound, (4 * dim, dim)).astype(np.float32),
            "w_hh": rng.uniform(-bound, bound, (4 * dim, dim)).astype(np.float32),
            "b_ih": rng.uniform(-bound, bound, (4 * dim,)).astype(np.float32),
            "b_hh": rng.uniform(-bound, bound, (4 * dim,)).astype(np.float32),
        })
    return {"layers": layers}


def _seanet_channel_plan(cfg: SEANetConfig, encoder: bool):
    """Per-layer (cin, cout, k) plan mirroring the layer-spec functions."""
    plan = []
    if encoder:
        ratios = tuple(reversed(cfg.ratios))
        mult = 1
        plan.append(("conv", cfg.channels, mult * cfg.n_filters, cfg.kernel_size))
        for ratio in ratios:
            for _ in range(cfg.n_residual_layers):
                plan.append(("resblock", mult * cfg.n_filters, mult * cfg.n_filters,
                             cfg.residual_kernel_size))
            plan.append(("elu",))
            plan.append(("conv", mult * cfg.n_filters, mult * cfg.n_filters * 2,
                         ratio * 2))
            mult *= 2
        if cfg.lstm:
            plan.append(("lstm", mult * cfg.n_filters))
        plan.append(("elu",))
        plan.append(("conv", mult * cfg.n_filters, cfg.dimension,
                     cfg.last_kernel_size))
    else:
        mult = int(2 ** len(cfg.ratios))
        plan.append(("conv", cfg.dimension, mult * cfg.n_filters, cfg.kernel_size))
        if cfg.lstm:
            plan.append(("lstm", mult * cfg.n_filters))
        for ratio in cfg.ratios:
            plan.append(("elu",))
            plan.append(("convtr", mult * cfg.n_filters, mult * cfg.n_filters // 2,
                         ratio * 2))
            for _ in range(cfg.n_residual_layers):
                plan.append(("resblock", mult * cfg.n_filters // 2,
                             mult * cfg.n_filters // 2, cfg.residual_kernel_size))
            mult //= 2
        plan.append(("elu",))
        plan.append(("conv", cfg.n_filters, cfg.channels, cfg.last_kernel_size))
        if cfg.final_activation is not None:
            plan.append(("final_act",))
    return plan


def init_seanet(rng, cfg: SEANetConfig, encoder: bool) -> list:
    specs = encoder_layer_specs(cfg) if encoder else decoder_layer_specs(cfg)
    plan = _seanet_channel_plan(cfg, encoder)
    assert len(plan) == len(specs), (len(plan), len(specs))
    params = []
    for spec, entry in zip(specs, plan):
        if spec.kind == "conv":
            _, cin, cout, k = entry
            params.append(_conv_default(rng, k, cin, cout))
        elif spec.kind == "convtr":
            _, cin, cout, k = entry
            params.append(_convtr_default(rng, k, cin, cout))
        elif spec.kind == "resblock":
            _, dim, _, k = entry
            hidden = dim // 2  # compress=2
            block = [_conv_default(rng, k, dim, hidden),
                     _conv_default(rng, 1, hidden, dim)]
            p = {"block": block}
            if not spec.true_skip:
                p["shortcut"] = _conv_default(rng, 1, dim, dim)
            params.append(p)
        elif spec.kind == "lstm":
            _, dim = entry
            params.append(_lstm_default(rng, spec.num_lstm_layers, dim))
        else:
            params.append({})
    return params


def init_quantizer(rng, cfg: VQConfig, random_codebook: bool = False) -> dict:
    if cfg.kmeans_init and not random_codebook:
        embed = np.zeros((cfg.n_q, cfg.bins, cfg.dimension), np.float32)
        inited = np.zeros((cfg.n_q, 1), np.float32)
    else:
        # kaiming_uniform on (bins, dim) (ref: core_vq.py:57-60)
        bound = np.sqrt(3.0) * np.sqrt(2.0 / ((1 + 5) * cfg.dimension))
        embed = rng.uniform(-bound, bound,
                            (cfg.n_q, cfg.bins, cfg.dimension)).astype(np.float32)
        inited = np.ones((cfg.n_q, 1), np.float32)
    return {"embed": embed, "embed_avg": embed.copy(),
            "cluster_size": np.zeros((cfg.n_q, cfg.bins), np.float32),
            "inited": inited}


def init_backbone(rng, cfg: VocosBackboneConfig) -> dict:
    dim = cfg.dim
    params = {"embed": _conv_trunc(rng, 7, cfg.input_channels, dim)}

    def pos_resnet():
        return {"norm1": _norm_ones(dim), "conv1": _conv_default(rng, 3, dim, dim),
                "norm2": _norm_ones(dim), "conv2": _conv_default(rng, 3, dim, dim)}

    params["pos_net"] = [
        pos_resnet(), pos_resnet(),
        {"norm": _norm_ones(dim),
         "q": _conv_default(rng, 1, dim, dim), "k": _conv_default(rng, 1, dim, dim),
         "v": _conv_default(rng, 1, dim, dim),
         "proj_out": _conv_default(rng, 1, dim, dim)},
        pos_resnet(), pos_resnet(),
        _norm_ones(dim),
    ]
    if cfg.adanorm_num_embeddings:
        params["norm"] = {"scale": np.ones((cfg.adanorm_num_embeddings, dim), np.float32),
                          "shift": np.zeros((cfg.adanorm_num_embeddings, dim), np.float32)}
    else:
        params["norm"] = _norm_ones(dim)
    gamma0 = 1.0 / cfg.num_layers
    convnext = []
    for _ in range(cfg.num_layers):
        block = {
            "dwconv": _conv_trunc(rng, 7, dim, dim, groups=dim),
            "pwconv1": _linear_trunc(rng, dim, cfg.intermediate_dim),
            "pwconv2": _linear_trunc(rng, cfg.intermediate_dim, dim),
            "gamma": np.full(dim, gamma0, np.float32),
        }
        if cfg.adanorm_num_embeddings:
            block["adanorm"] = {
                "scale": np.ones((cfg.adanorm_num_embeddings, dim), np.float32),
                "shift": np.zeros((cfg.adanorm_num_embeddings, dim), np.float32)}
        else:
            block["norm"] = _norm_ones(dim)
        convnext.append(block)
    params["convnext"] = convnext
    params["final_layer_norm"] = _norm_ones(dim)
    return params


def init_head(rng, cfg: ISTFTHeadConfig) -> dict:
    return {"out": _linear_trunc(rng, cfg.dim, cfg.n_fft + 2)}


def init_wavtokenizer(spec: WavTokenizerSpec, seed: int = 0,
                      random_codebook: bool = False) -> dict:
    """Full random param pytree for training-from-scratch / benchmarking."""
    rng = np.random.default_rng(seed)
    return {
        "encoder": init_seanet(rng, spec.seanet, encoder=True),
        "decoder": init_seanet(rng, spec.seanet, encoder=False),
        "quantizer": init_quantizer(rng, spec.vq, random_codebook=random_codebook),
        "backbone": init_backbone(rng, spec.backbone),
        "head": init_head(rng, spec.head),
    }


def init_encodec(cfg, seed: int = 0) -> dict:
    """Seeded random EnCodec params (``cfg`` an ``EncodecConfig``): encoder,
    decoder and a kaiming-uniform codebook per quantizer, drawn in that
    order with the JAX package's ``init_seanet``/``init_quantizer`` draws.
    A time_group_norm model also gets its GroupNorm affines at torch's init
    (weight 1, bias 0), which the JAX init does not draw."""
    rng = np.random.default_rng(seed)
    params = {"encoder": init_seanet(rng, cfg.seanet, encoder=True),
              "decoder": init_seanet(rng, cfg.seanet, encoder=False),
              "quantizer": init_quantizer(rng, cfg.vq, random_codebook=True)}
    if cfg.seanet.norm == "time_group_norm":
        for p in params["encoder"] + params["decoder"]:
            convs = [p] if "kernel" in p else p.get("block", []) + (
                [p["shortcut"]] if "shortcut" in p else [])
            for conv in convs:
                conv["gn"] = _norm_ones(conv["kernel"].shape[-1])
    return params


def init_vocos(spec, seed: int = 0) -> dict:
    """Seeded random params of the plain-Vocos family
    (``models/vocos_model.py::VocosSpec``), in the JAX package's layout: the
    same draws as ``wavtokenizer_tpu/models/init.py::init_vocos``.
    ``api/pretrained.py::Vocos.from_jax_params`` turns them into tensors."""
    from .alt_components import mel_scaled_head_init_scale

    rng = np.random.default_rng(seed)
    if spec.backbone_kind == "convnext":
        backbone = init_backbone(rng, spec.backbone)
    else:
        cfg = spec.backbone
        blocks = [{"convs1": [_conv_default(rng, 3, cfg.dim, cfg.dim) for _ in range(3)],
                   "convs2": [_conv_default(rng, 3, cfg.dim, cfg.dim) for _ in range(3)],
                   "gamma": [np.full((cfg.dim,), 1.0 / cfg.num_blocks, np.float32)
                             for _ in range(3)]}
                  for _ in range(cfg.num_blocks)]
        backbone = {"embed": _conv_default(rng, 3, cfg.input_channels, cfg.dim),
                    "resnet": blocks}
    if spec.head_kind == "istft":
        head = {"out": _linear_trunc(rng, spec.head.dim, spec.head.n_fft + 2)}
    elif spec.head_kind == "imdct_symexp":
        out = _linear_trunc(rng, spec.head.dim, spec.head.mdct_frame_len // 2)
        scale = mel_scaled_head_init_scale(spec.sample_rate, spec.head.mdct_frame_len // 2)
        out["weight"] = out["weight"] * scale[None, :]
        head = {"out": out}
    else:  # imdct_cos
        head = {"out": _linear_trunc(rng, spec.head.dim, spec.head.mdct_frame_len)}
    return {"backbone": backbone, "head": head}
