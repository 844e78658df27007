"""UTMOS MOS predictor.

Port of ``wavtokenizer_tpu/metrics/utmos.py`` (ref metrics/UTMOS.py:19-117):
a wav2vec2-base SSL encoder, a domain embedding (3 x 128, domain 0), a judge
embedding (3000 x 128, judge 288), a one-layer bidirectional LSTM (hidden
512, ``nn.LSTM``) over the 1024-wide concatenation, and a 2048-wide MLP to
one score per frame; a clip scores ``frame_scores.mean() * 2 + 3``.

The reference downloads fairseq's ``wav2vec_small.pt`` and the UTMOS
Lightning checkpoint; here the model runs over a parameter dict read from a
local checkpoint in the same fairseq naming (``WT_UTMOS_CKPT`` or a path).
It runs on ``device`` in fp32 with TF32 off (``full_fp32``).

wav2vec2-base (fairseq ``wav2vec_small``): 7 conv layers (512 channels,
kernels 10/3/3/3/3/2/2, strides 5/2/2/2/2/2/2, no bias, GroupNorm(512, 512)
after the first), LayerNorm and a 512 -> 768 projection, a grouped
positional conv (kernel 128, 16 groups, weight-normed, SamePad trim, GELU),
and a post-LN transformer (12 layers, 12 heads, FFN 3072, exact GELU).
Weights stay in PyTorch's layouts: conv (C_out, C_in/groups, K), Linear
(out, in).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CONV_SPECS = ((10, 5), (3, 2), (3, 2), (3, 2), (3, 2), (2, 2), (2, 2))


@dataclass(frozen=True)
class UTMOSConfig:
    conv_channels: int = 512
    ssl_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    num_domains: int = 3
    domain_dim: int = 128
    num_judges: int = 3000
    judge_dim: int = 128
    lstm_hidden: int = 512
    proj_hidden: int = 2048
    ln_eps: float = 1e-5


def _ln(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["weight"], p["bias"], eps)


def _linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    return F.linear(x, p["weight"], p["bias"])


def _feature_extractor(params: dict, wav: torch.Tensor, cfg: UTMOSConfig) -> torch.Tensor:
    """(B, T) -> (B, 512, T'): the strided conv stack, channel-first.
    GroupNorm(512, 512) after layer 0 is a per-channel norm over time
    (fairseq mode="default")."""
    x = wav[:, None, :]
    for i, ((_, s), w) in enumerate(zip(CONV_SPECS, params["conv_layers"])):
        x = F.conv1d(x, w, stride=s)
        if i == 0:
            gn = params["group_norm"]
            x = F.group_norm(x, x.shape[1], gn["weight"], gn["bias"], cfg.ln_eps)
        x = F.gelu(x)
    return x


def _attention(p: dict, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, T, D = x.shape
    hd = D // num_heads
    q, k, v = (_linear(x, p[n]).reshape(B, T, num_heads, hd).transpose(1, 2)
               for n in ("q", "k", "v"))
    w = torch.softmax((q @ k.transpose(2, 3)) / math.sqrt(hd), dim=-1)
    o = (w @ v).transpose(1, 2).reshape(B, T, D)
    return _linear(o, p["o"])


def ssl_encode(params: dict, wav: torch.Tensor, cfg: UTMOSConfig = UTMOSConfig()) -> torch.Tensor:
    """wav (B, T) at 16 kHz -> wav2vec2 features (B, T', 768) (fairseq
    ``ssl_model(wav, mask=False, features_only=True)["x"]``)."""
    x = _feature_extractor(params, wav, cfg).transpose(1, 2)
    x = _linear(_ln(x, params["feat_ln"], cfg.ln_eps), params["proj"])
    # Grouped positional conv, padded K/2 on both sides, then the extra
    # rightmost step trimmed (fairseq SamePad for an even kernel), GELU,
    # residual.
    pc = F.conv1d(x.transpose(1, 2), params["pos_conv"]["weight"],
                  params["pos_conv"]["bias"], padding=cfg.pos_conv_kernel // 2,
                  groups=cfg.pos_conv_groups)
    x = x + F.gelu(pc[:, :, :-1]).transpose(1, 2)
    x = _ln(x, params["enc_ln"], cfg.ln_eps)
    for lp in params["layers"]:
        # post-LN (layer_norm_first=False): LN(x + attn), LN(x + ff)
        x = _ln(x + _attention(lp, x, cfg.num_heads), lp["ln1"], cfg.ln_eps)
        ff = _linear(F.gelu(_linear(x, lp["fc1"])), lp["fc2"])
        x = _ln(x + ff, lp["ln2"], cfg.ln_eps)
    return x


def utmos_frame_scores(params: dict, wav: torch.Tensor, domain_id: int = 0,
                       judge_id: int = 288, cfg: UTMOSConfig = UTMOSConfig()) -> torch.Tensor:
    """(B, T) -> per-frame scores (B, T', 1) (ref UTMOS.py:119-223: SSL
    features ++ domain ++ judge embeddings -> BiLSTM -> MLP)."""
    x = ssl_encode(params, wav, cfg)
    B, T, _ = x.shape
    d = params["domain_emb"][domain_id].expand(B, T, -1)
    j = params["judge_emb"][judge_id].expand(B, T, -1)
    h, _ = params["lstm"](torch.cat([x, d, j], dim=-1))
    h = F.relu(_linear(h, params["proj1"]))
    return _linear(h, params["proj2"])


def utmos_score_from_params(params: dict, wav_16k) -> np.ndarray:
    """Clip MOS scores (B,) for (B, T) or (T,) audio at 16 kHz, on the
    params' device (ref UTMOS.py:30-55: ``model(batch).mean(dim=1)
    .squeeze(1) * 2 + 3``)."""
    from ..models.wavtokenizer import full_fp32

    device = params["proj"]["weight"].device
    wav = torch.as_tensor(np.asarray(wav_16k, np.float32)).to(device)
    if wav.dim() == 1:
        wav = wav[None]
    with torch.inference_mode(), full_fp32():
        s = utmos_frame_scores(params, wav).mean(dim=1)[:, 0] * 2.0 + 3.0
    return s.cpu().numpy()


# ---------------------------------------------------------------------------
# torch checkpoint conversion (fairseq naming, as the UTMOS checkpoint has it)
# ---------------------------------------------------------------------------

def _strip_prefixes(sd: dict) -> dict:
    """Lightning/module prefixes off, so keys start at feature_extractors.*
    / output_layers.*."""
    out = {}
    for k, v in sd.items():
        for pre in ("model.", "module."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def utmos_params_from_torch(sd: dict, device="cuda") -> dict:
    """UTMOS Lightning state dict (fairseq wav2vec2 naming; torch tensors or
    numpy arrays) -> this module's params on ``device``.  Reads both
    weight-norm layouts of the positional conv (``weight_g``/``weight_v`` and
    ``parametrizations.weight.original0/1``); the depth comes from the
    checkpoint (12 for wav2vec2-base)."""
    sd = _strip_prefixes(sd)

    def n(key) -> np.ndarray:
        v = sd[key]
        return np.array(v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float32)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    a = lambda key: t(n(key))
    ssl = "feature_extractors.0.ssl_model."
    lin = lambda key: {"weight": a(key + ".weight"), "bias": a(key + ".bias")}
    ln = lin

    # weight = g * v / |v|, fairseq's weight_norm(dim=2): g is (1, 1, K) and
    # the norm runs over (C_out, C_in/groups) at each kernel position.
    pc = f"{ssl}encoder.pos_conv.0"
    if f"{pc}.weight_g" in sd:
        g, v = n(f"{pc}.weight_g"), n(f"{pc}.weight_v")
    else:
        g = n(f"{pc}.parametrizations.weight.original0")
        v = n(f"{pc}.parametrizations.weight.original1")
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    pos_w = g * v / np.maximum(norm, 1e-12)

    n_layers = 1 + max(int(k.split("encoder.layers.")[1].split(".")[0])
                       for k in sd if "encoder.layers." in k)
    layers = []
    for i in range(n_layers):
        lp = f"{ssl}encoder.layers.{i}."
        layers.append({"q": lin(lp + "self_attn.q_proj"), "k": lin(lp + "self_attn.k_proj"),
                       "v": lin(lp + "self_attn.v_proj"), "o": lin(lp + "self_attn.out_proj"),
                       "ln1": ln(lp + "self_attn_layer_norm"), "fc1": lin(lp + "fc1"),
                       "fc2": lin(lp + "fc2"), "ln2": ln(lp + "final_layer_norm")})

    rnn = "output_layers.0.decoder_rnn."
    w_ih = n(rnn + "weight_ih_l0")
    lstm = nn.LSTM(w_ih.shape[1], w_ih.shape[0] // 4, num_layers=1, batch_first=True,
                   bidirectional=True)
    with torch.no_grad():
        for name, p in lstm.named_parameters():
            p.copy_(torch.from_numpy(n(rnn + name)))
    return {
        "conv_layers": [a(f"{ssl}feature_extractor.conv_layers.{i}.0.weight")
                        for i in range(len(CONV_SPECS))],
        "group_norm": ln(f"{ssl}feature_extractor.conv_layers.0.2"),
        "feat_ln": ln(f"{ssl}layer_norm"),
        "proj": lin(f"{ssl}post_extract_proj"),
        "pos_conv": {"weight": t(pos_w), "bias": a(f"{pc}.bias")},
        "enc_ln": ln(f"{ssl}encoder.layer_norm"),
        "layers": layers,
        "domain_emb": a("feature_extractors.1.embedding.weight"),
        "judge_emb": a("output_layers.0.judge_embedding.weight"),
        "lstm": lstm.to(device).eval().requires_grad_(False),
        "proj1": lin("output_layers.1.net.0"),
        "proj2": lin("output_layers.1.net.3"),
    }


def init_utmos_state_dict(seed: int = 0, cfg: UTMOSConfig = UTMOSConfig()) -> dict:
    """A seeded random UTMOS state dict in the checkpoint's fairseq naming
    (numpy), ``cfg.num_layers`` transformer layers deep: uniform(+-1/sqrt(
    fan_in)) weights and biases as torch's default init bounds them, norms
    near (1, 0), unit-normal embeddings, the positional conv as
    weight_g/weight_v.  For runs that need a checkpoint where no trained one
    is at hand."""
    rng = np.random.default_rng(seed)
    u = lambda bound, shape: rng.uniform(-bound, bound, shape).astype(np.float32)
    ssl = "feature_extractors.0.ssl_model."
    sd: dict = {}

    def lin(key, cout, cin):
        sd[key + ".weight"] = u(1.0 / np.sqrt(cin), (cout, cin))
        sd[key + ".bias"] = u(1.0 / np.sqrt(cin), (cout,))

    def ln(key, c):
        sd[key + ".weight"] = (1.0 + u(0.1, (c,))).astype(np.float32)
        sd[key + ".bias"] = u(0.1, (c,))

    C, D = cfg.conv_channels, cfg.ssl_dim
    cin = 1
    for i, (k, _) in enumerate(CONV_SPECS):
        sd[f"{ssl}feature_extractor.conv_layers.{i}.0.weight"] = u(1.0 / np.sqrt(cin * k),
                                                                     (C, cin, k))
        cin = C
    ln(f"{ssl}feature_extractor.conv_layers.0.2", C)
    ln(f"{ssl}layer_norm", C)
    lin(f"{ssl}post_extract_proj", D, C)
    pc = f"{ssl}encoder.pos_conv.0"
    fan_in = D // cfg.pos_conv_groups * cfg.pos_conv_kernel
    sd[f"{pc}.weight_v"] = u(1.0 / np.sqrt(fan_in),
                             (D, D // cfg.pos_conv_groups, cfg.pos_conv_kernel))
    sd[f"{pc}.weight_g"] = rng.uniform(0.5, 1.5, (1, 1, cfg.pos_conv_kernel)).astype(np.float32)
    sd[f"{pc}.bias"] = u(1.0 / np.sqrt(fan_in), (D,))
    ln(f"{ssl}encoder.layer_norm", D)
    for i in range(cfg.num_layers):
        lp = f"{ssl}encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(lp + "self_attn." + n, D, D)
        ln(lp + "self_attn_layer_norm", D)
        lin(lp + "fc1", cfg.ffn_dim, D)
        lin(lp + "fc2", D, cfg.ffn_dim)
        ln(lp + "final_layer_norm", D)
    sd["feature_extractors.1.embedding.weight"] = rng.normal(
        size=(cfg.num_domains, cfg.domain_dim)).astype(np.float32)
    sd["output_layers.0.judge_embedding.weight"] = rng.normal(
        size=(cfg.num_judges, cfg.judge_dim)).astype(np.float32)
    H, I = cfg.lstm_hidden, D + cfg.domain_dim + cfg.judge_dim
    for sfx in ("", "_reverse"):
        rnn = "output_layers.0.decoder_rnn."
        sd[f"{rnn}weight_ih_l0{sfx}"] = u(1.0 / np.sqrt(H), (4 * H, I))
        sd[f"{rnn}weight_hh_l0{sfx}"] = u(1.0 / np.sqrt(H), (4 * H, H))
        sd[f"{rnn}bias_ih_l0{sfx}"] = u(1.0 / np.sqrt(H), (4 * H,))
        sd[f"{rnn}bias_hh_l0{sfx}"] = u(1.0 / np.sqrt(H), (4 * H,))
    lin("output_layers.1.net.0", cfg.proj_hidden, 2 * H)
    lin("output_layers.1.net.3", 1, cfg.proj_hidden)
    return sd


_CACHED: dict = {}


def load_utmos(ckpt_path: str | None = None, device="cuda"):
    """UTMOS params from a torch checkpoint on disk (the path defaults to
    ``$WT_UTMOS_CKPT``), cached per path and device; None when there is no
    checkpoint (the reference would download it, ref UTMOS.py:23-27)."""
    ckpt_path = ckpt_path or os.environ.get("WT_UTMOS_CKPT")
    if not ckpt_path or not os.path.exists(ckpt_path):
        return None
    key = (ckpt_path, str(torch.device(device)))
    if key not in _CACHED:
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        _CACHED[key] = utmos_params_from_torch(ckpt.get("state_dict", ckpt), device)
    return _CACHED[key]
