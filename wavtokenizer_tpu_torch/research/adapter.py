"""Feature-enhancement adapter (the fork's noisy -> clean restoration layer).

Port of ``wavtokenizer_tpu/research/adapter.py`` (ref try3.py:19-90,
tsne.py:89-150, try.py:36-134): frozen SEANet encoder -> trainable adapter
(1x1 conv 512 -> 256, BatchNorm, ReLU, 2x ResidualBlock(256) [conv3 - BN -
ReLU - conv3 - BN + residual, ReLU], 1x1 conv 256 -> 512, ReLU) -> SEANet
decoder, bypassing the VQ and the Vocos stack.  try.py's variant puts the
BYOL SimpleTransformer between the encoder and the adapter
(``try_enhancement_stack``).

The inits (``init_adapter``, ``init_inpath_transformer``) are numpy and draw
what the JAX package draws, in its layout (conv kernels (K, C_in, C_out),
linear weights (in, out)); ``checkpoint/convert.py``'s ``adapter_from_jax``
and ``inpath_transformer_from_jax`` turn them into this package's tensors
(conv weights (C_out, C_in, K), linear weights kept (in, out)).

BatchNorm running statistics are explicit state, as in the JAX package:
``train=True`` normalises with the batch statistics over (B, T) and returns
running statistics updated with the unbiased variance at momentum 0.1
(``F.batch_norm`` on the (B, C, T) view does exactly that, on copies);
``train=False`` normalises with the stored ones.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..models.seanet import seanet_decode, seanet_encode
from ..models.wavtokenizer import full_fp32
from ..train.step import tree_leaves
from .byol import _layer_norm, _mha


@dataclass(frozen=True)
class AdapterConfig:
    encoder_dim: int = 512
    hidden: int = 256
    num_residual_blocks: int = 2
    bn_momentum: float = 0.1  # torch BatchNorm1d default
    bn_eps: float = 1e-5


def _bn_init(c):
    return {"weight": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}


def _bn_state_init(c):
    return {"mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}


def _conv_default(rng, k, cin, cout):
    bound = 1.0 / np.sqrt(cin * k)
    return {"kernel": rng.uniform(-bound, bound, (k, cin, cout)).astype(np.float32),
            "bias": rng.uniform(-bound, bound, (cout,)).astype(np.float32)}


def init_adapter(cfg: AdapterConfig = AdapterConfig(), seed: int = 0):
    """(params, bn_state), numpy in the JAX package's layout."""
    rng = np.random.default_rng(seed)
    h = cfg.hidden
    params = {
        "adapter_conv": _conv_default(rng, 1, cfg.encoder_dim, h),
        "adapter_bn": _bn_init(h),
        "blocks": [],
        "out_conv": _conv_default(rng, 1, h, cfg.encoder_dim),
    }
    state = {"adapter_bn": _bn_state_init(h), "blocks": []}
    for _ in range(cfg.num_residual_blocks):
        params["blocks"].append({
            "conv1": _conv_default(rng, 3, h, h), "bn1": _bn_init(h),
            "conv2": _conv_default(rng, 3, h, h), "bn2": _bn_init(h),
        })
        state["blocks"].append({"bn1": _bn_state_init(h), "bn2": _bn_state_init(h)})
    return params, state


def _batch_norm(x, p, s, train: bool, momentum: float, eps: float):
    """BatchNorm1d of (B, C, T): statistics over (B, T) per channel."""
    if not train:
        return F.batch_norm(x, s["mean"], s["var"], p["weight"], p["bias"], False, 0.0, eps), s
    new_s = {"mean": s["mean"].clone(), "var": s["var"].clone()}
    y = F.batch_norm(x, new_s["mean"], new_s["var"], p["weight"], p["bias"], True,
                     momentum, eps)
    return y, new_s


def _conv(p, x, padding: int = 0):
    return F.conv1d(x, p["weight"], p["bias"], padding=padding)


def apply_adapter(params: dict, state: dict, x: torch.Tensor, train: bool = False,
                  cfg: AdapterConfig = AdapterConfig()):
    """x (B, T', 512) encoder features -> (enhanced (B, T', 512), new_state).

    EnhancedFeatureExtractor.forward (try3.py:64-80): conv -> BN -> ReLU ->
    residual blocks -> conv -> ReLU."""
    m, eps = cfg.bn_momentum, cfg.bn_eps
    h = _conv(params["adapter_conv"], x.transpose(1, 2))
    h, bn_state = _batch_norm(h, params["adapter_bn"], state["adapter_bn"], train, m, eps)
    h = F.relu(h)
    blocks = []
    for bp, bs in zip(params["blocks"], state["blocks"]):
        o = _conv(bp["conv1"], h, padding=1)
        o, s1 = _batch_norm(o, bp["bn1"], bs["bn1"], train, m, eps)
        o = _conv(bp["conv2"], F.relu(o), padding=1)
        o, s2 = _batch_norm(o, bp["bn2"], bs["bn2"], train, m, eps)
        h = F.relu(o + h)
        blocks.append({"bn1": s1, "bn2": s2})
    h = F.relu(_conv(params["out_conv"], h))
    return h.transpose(1, 2), {"adapter_bn": bn_state, "blocks": blocks}


# ---------------------------------------------------------------------------
# try.py's variant: the BYOL SimpleTransformer between the frozen encoder and
# the adapter (ref try.py:36-134)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InPathTransformerConfig:
    """try.py:76 SimpleTransformer(512, 128, 128, 4, 2): d_model is the
    encoder dim, torch TransformerEncoderLayer defaults (ffn 2048, ReLU,
    post-LN), then a per-frame Linear(512, 512)."""
    dim: int = 512
    num_heads: int = 4
    num_layers: int = 2
    ffn: int = 2048
    ln_eps: float = 1e-5


def _linear_default(rng, cin, cout):
    bound = 1.0 / np.sqrt(cin)
    return {"weight": rng.uniform(-bound, bound, (cin, cout)).astype(np.float32),
            "bias": rng.uniform(-bound, bound, (cout,)).astype(np.float32)}


def init_inpath_transformer(cfg: InPathTransformerConfig = InPathTransformerConfig(),
                            seed: int = 0) -> dict:
    """Numpy, the JAX package's draws and layout (linear weights (in, out))."""
    rng = np.random.default_rng(seed)
    d = cfg.dim

    def xavier(cin, cout):
        bound = np.sqrt(6.0 / (cin + cout))
        return rng.uniform(-bound, bound, (cin, cout)).astype(np.float32)

    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            # torch MultiheadAttention xavier-inits the packed in_proj
            "q": {"weight": xavier(d, d), "bias": np.zeros(d, np.float32)},
            "k": {"weight": xavier(d, d), "bias": np.zeros(d, np.float32)},
            "v": {"weight": xavier(d, d), "bias": np.zeros(d, np.float32)},
            "o": _linear_default(rng, d, d),
            "ln1": {"weight": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)},
            "ff1": _linear_default(rng, d, cfg.ffn),
            "ff2": _linear_default(rng, cfg.ffn, d),
            "ln2": {"weight": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)},
        })
    return {"layers": layers, "fc": _linear_default(rng, d, d)}


def inpath_transformer(params: dict, x: torch.Tensor,
                       cfg: InPathTransformerConfig = InPathTransformerConfig()) -> torch.Tensor:
    """Per frame (B, T, 512) -> (B, T, 512) (try.py:45-53: the transformer
    over the time axis, then fc, keeping the time axis)."""
    h = x
    for lp in params["layers"]:
        h = _layer_norm(h + _mha(lp, h, cfg.num_heads), lp["ln1"], cfg.ln_eps)
        ff = F.relu(h @ lp["ff1"]["weight"] + lp["ff1"]["bias"])
        ff = ff @ lp["ff2"]["weight"] + lp["ff2"]["bias"]
        h = _layer_norm(h + ff, lp["ln2"], cfg.ln_eps)
    return h @ params["fc"]["weight"] + params["fc"]["bias"]


def load_byol_transformer(params: dict, ckpt_tree: dict) -> tuple[dict, int]:
    """try.py:101-104's ``load_state_dict(ckpt, strict=False)``: copy exactly
    the leaves whose path and shape match, keep the rest.  (With the fork's
    own BYOL checkpoints nothing matches: tr_byol's SimpleTransformer has
    d_model 128 against 512 here, so the in-path transformer stays at its
    init; the quirk is kept on purpose.)  Returns (params, leaves loaded)."""
    loaded = [0]

    def merge(dst, src):
        if isinstance(dst, dict) and isinstance(src, dict):
            return {k: merge(v, src[k]) if k in src else v for k, v in dst.items()}
        if isinstance(dst, list) and isinstance(src, (list, tuple)):
            return [merge(d, s) for d, s in zip(dst, src)] + dst[len(src):]
        if isinstance(dst, torch.Tensor) and hasattr(src, "shape") \
                and tuple(dst.shape) == tuple(src.shape):
            loaded[0] += 1
            return torch.as_tensor(src, dtype=torch.float32).detach().to(dst.device).clone()
        return dst

    return merge(params, ckpt_tree), loaded[0]


def inpath_transformer_from_torch(sd: dict, cfg: InPathTransformerConfig =
                                  InPathTransformerConfig()) -> dict:
    """try.py's SimpleTransformer state dict -> the numpy tree of
    ``init_inpath_transformer`` (the packed in_proj split into q/k/v,
    weights transposed to (in, out))."""
    def a(k):
        v = sd[k]
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float32)

    d = cfg.dim
    layers = []
    for i in range(cfg.num_layers):
        pre = f"transformer.layers.{i}."
        in_w, in_b = a(pre + "self_attn.in_proj_weight"), a(pre + "self_attn.in_proj_bias")
        layers.append({
            "q": {"weight": in_w[:d].T, "bias": in_b[:d]},
            "k": {"weight": in_w[d:2 * d].T, "bias": in_b[d:2 * d]},
            "v": {"weight": in_w[2 * d:].T, "bias": in_b[2 * d:]},
            "o": {"weight": a(pre + "self_attn.out_proj.weight").T,
                  "bias": a(pre + "self_attn.out_proj.bias")},
            "ln1": {"weight": a(pre + "norm1.weight"), "bias": a(pre + "norm1.bias")},
            "ff1": {"weight": a(pre + "linear1.weight").T, "bias": a(pre + "linear1.bias")},
            "ff2": {"weight": a(pre + "linear2.weight").T, "bias": a(pre + "linear2.bias")},
            "ln2": {"weight": a(pre + "norm2.weight"), "bias": a(pre + "norm2.bias")},
        })
    return {"layers": layers, "fc": {"weight": a("fc.weight").T, "bias": a("fc.bias")}}


def _ln_noaffine(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch's F.layer_norm(x, [C]) over the channel axis, no affine."""
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def try_enhancement_stack(transformer_params: dict, adapter_params: dict,
                          adapter_state: dict, feats: torch.Tensor, train: bool = False,
                          transformer_cfg: InPathTransformerConfig = InPathTransformerConfig()):
    """try.py:108-133 between encoder and decoder: amplitude boost and
    no-affine channel LayerNorm -> SimpleTransformer -> adapter -> ReLU * 2.5
    -> no-affine LayerNorm * 3.  feats (B, T', 512) -> (enhanced,
    new_adapter_state)."""
    x = _ln_noaffine(feats.detach() * 3.0)
    x = inpath_transformer(transformer_params, x, transformer_cfg)
    enhanced, new_state = apply_adapter(adapter_params, adapter_state, x, train=train)
    # The ReLU is already the adapter's tail; * 2.5 is then absorbed by the
    # scale-invariant LayerNorm (kept for 1:1 readability with the ref).
    return _ln_noaffine(enhanced * 2.5) * 3.0, new_state


def base_params_from_jax(params_np: dict, seanet_cfg, device="cuda") -> dict:
    """The encoder and decoder of a JAX-layout WavTokenizer pytree (numpy)
    for ``enhanced_forward``: the encoder in inference form (the front
    kernel's weight pack when its geometry matches, the LSTM frozen), the
    decoder in training form (LSTM weight tensors), through which a gradient
    reaches the adapter and, in the modes that train it, the decoder."""
    from ..api.pretrained import seanet_from_jax
    from ..models.seanet import decoder_layer_specs, encoder_layer_specs

    device = torch.device(device)
    return {"encoder": seanet_from_jax(params_np["encoder"], encoder_layer_specs(seanet_cfg),
                                       device),
            "decoder": seanet_from_jax(params_np["decoder"], decoder_layer_specs(seanet_cfg),
                                       device, train=True)}


def frozen_encode(encoder_params: list, seanet_cfg, audio: torch.Tensor) -> torch.Tensor:
    """The frozen SEANet encoder: audio (B, T) -> features (B, T', D), in true
    fp32 and without a graph.  At small-320 geometry layers 0-6 are the
    encoder-front kernel, which has no backward; nothing here may ask for
    one, so an input or weight that requires a gradient is refused rather
    than silently cut off."""
    if audio.requires_grad or any(t.requires_grad for t in tree_leaves(encoder_params)):
        raise ValueError("the frozen encoder got an input or a weight that requires a gradient")
    with torch.no_grad(), full_fp32():
        return seanet_encode(encoder_params, seanet_cfg, audio[:, :, None])


def enhanced_forward(base_params: dict, seanet_cfg, adapter_params: dict,
                     adapter_state: dict, audio: torch.Tensor, train: bool = False,
                     feature_scale: float | None = None,
                     transformer_params: dict | None = None,
                     transformer_cfg: InPathTransformerConfig = InPathTransformerConfig()):
    """The whole enhancement path.

    Without ``transformer_params`` (try3.py:1038-1041): frozen encoder ->
    adapter -> optional tanh(features * scale) -> decoder.  With them
    (try.py:108-134): frozen encoder -> ``try_enhancement_stack`` -> decoder
    (no tanh: try.py's EnhancedModel decodes raw).

    audio (B, T) -> (audio_hat (B, T~), enhanced (B, T', 512), input
    features (B, T', 512), new_adapter_state).  ``base_params`` as
    ``base_params_from_jax`` makes them."""
    feats = frozen_encode(base_params["encoder"], seanet_cfg, audio)
    if transformer_params is not None:
        enhanced, new_state = try_enhancement_stack(
            transformer_params, adapter_params, adapter_state, feats, train=train,
            transformer_cfg=transformer_cfg)
        dec_in = enhanced
    else:
        enhanced, new_state = apply_adapter(adapter_params, adapter_state, feats, train=train)
        dec_in = enhanced if feature_scale is None else torch.tanh(enhanced * feature_scale)
    out = seanet_decode(base_params["decoder"], seanet_cfg, dec_in)
    return out[:, :, 0], enhanced, feats, new_state
