"""BYOL speaker-representation pretrainer.

Port of ``wavtokenizer_tpu/research/byol.py`` (ref tr_byol.py:12-86,
train_byol.py): SimpleTransformer (Linear embed -> 2-layer post-LN
TransformerEncoder (4 heads, FF 2048, ReLU, batch-first) -> mean-pool ->
Linear to 256), ProjectionMLP (3 Linear layers with BatchNorm + ReLU
between), online predictor, EMA target network (tau = 0.996), symmetric MSE.

``init_byol`` is numpy and draws what the JAX package draws, in its layout
(linear weights (in, out), kept so here); ``checkpoint/convert.py::
byol_from_jax`` makes the tensors.  The attention is a plain product and
softmax, as in the JAX package (no kernel).  Dropout is off, as there.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class BYOLConfig:
    input_dim: int = 512
    hidden_dim: int = 512
    projection_dim: int = 128
    num_heads: int = 4
    num_layers: int = 2
    ff_dim: int = 2048
    encoder_out: int = 256
    tau: float = 0.996


def _linear(rng, cin, cout):
    bound = 1.0 / np.sqrt(cin)
    return {"weight": rng.uniform(-bound, bound, (cin, cout)).astype(np.float32),
            "bias": rng.uniform(-bound, bound, (cout,)).astype(np.float32)}


def _ln(c):
    return {"weight": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}


def init_transformer(rng, cfg: BYOLConfig) -> dict:
    d = cfg.hidden_dim
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "q": _linear(rng, d, d), "k": _linear(rng, d, d),
            "v": _linear(rng, d, d), "o": _linear(rng, d, d),
            "ln1": _ln(d), "ln2": _ln(d),
            "ff1": _linear(rng, d, cfg.ff_dim),
            "ff2": _linear(rng, cfg.ff_dim, d),
        })
    return {"embedding": _linear(rng, cfg.input_dim, d), "layers": layers,
            "fc": _linear(rng, d, cfg.encoder_out)}


def init_projection_mlp(rng, cin, hidden, cout) -> dict:
    return {"layer1": _linear(rng, cin, hidden), "bn1": _ln(hidden),
            "layer2": _linear(rng, hidden, hidden), "bn2": _ln(hidden),
            "layer3": _linear(rng, hidden, cout)}


def init_byol(cfg: BYOLConfig = BYOLConfig(), seed: int = 0) -> dict:
    """{"online": {encoder, projector, predictor}, "target": {encoder,
    projector}}, numpy; the target starts as a copy of the online nets."""
    rng = np.random.default_rng(seed)
    online = {
        "encoder": init_transformer(rng, cfg),
        "projector": init_projection_mlp(rng, cfg.encoder_out, cfg.hidden_dim,
                                         cfg.projection_dim),
        "predictor": init_projection_mlp(rng, cfg.projection_dim, cfg.hidden_dim,
                                         cfg.projection_dim),
    }
    target = {"encoder": copy.deepcopy(online["encoder"]),
              "projector": copy.deepcopy(online["projector"])}
    return {"online": online, "target": target}


def _layer_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p["weight"], p["bias"], eps)


def _mha(p: dict, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Multi-head self-attention, torch's layout: (B, T, D) -> (B, T, D)."""
    B, T, D = x.shape
    H = num_heads
    q = (x @ p["q"]["weight"] + p["q"]["bias"]).reshape(B, T, H, D // H)
    k = (x @ p["k"]["weight"] + p["k"]["bias"]).reshape(B, T, H, D // H)
    v = (x @ p["v"]["weight"] + p["v"]["bias"]).reshape(B, T, H, D // H)
    w = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(D // H)
    o = torch.einsum("bhts,bshd->bthd", torch.softmax(w, dim=-1), v).reshape(B, T, D)
    return o @ p["o"]["weight"] + p["o"]["bias"]


def simple_transformer(params: dict, x: torch.Tensor, cfg: BYOLConfig) -> torch.Tensor:
    """x (B, D_in) or (B, T, D_in) -> (B, encoder_out) (tr_byol.py:12-29)."""
    if x.dim() == 2:
        x = x[:, None, :]
    h = x @ params["embedding"]["weight"] + params["embedding"]["bias"]
    for lp in params["layers"]:
        # post-LN TransformerEncoderLayer: LN(x + attn), LN(x + ff)
        h = _layer_norm(h + _mha(lp, h, cfg.num_heads), lp["ln1"])
        ff = F.relu(h @ lp["ff1"]["weight"] + lp["ff1"]["bias"])
        ff = ff @ lp["ff2"]["weight"] + lp["ff2"]["bias"]
        h = _layer_norm(h + ff, lp["ln2"])
    return h.mean(dim=1) @ params["fc"]["weight"] + params["fc"]["bias"]


def projection_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm over the batch axis as torch's BatchNorm1d on (B, C) in
    training (tr_byol.py:31-46): the batch's statistics, no running state."""
    def bn(x, p):
        return F.batch_norm(x, None, None, p["weight"], p["bias"], True, 0.0, 1e-5)

    h = F.relu(bn(x @ params["layer1"]["weight"] + params["layer1"]["bias"], params["bn1"]))
    h = F.relu(bn(h @ params["layer2"]["weight"] + params["layer2"]["bias"], params["bn2"]))
    return h @ params["layer3"]["weight"] + params["layer3"]["bias"]


def byol_loss(params: dict, x1: torch.Tensor, x2: torch.Tensor,
              cfg: BYOLConfig = BYOLConfig()) -> torch.Tensor:
    """Symmetric BYOL MSE (tr_byol.py:71-85); no gradient reaches the target."""
    on, tg = params["online"], params["target"]

    def online(x):
        return projection_mlp(on["predictor"], projection_mlp(
            on["projector"], simple_transformer(on["encoder"], x, cfg)))

    with torch.no_grad():
        t1 = projection_mlp(tg["projector"], simple_transformer(tg["encoder"], x1, cfg))
        t2 = projection_mlp(tg["projector"], simple_transformer(tg["encoder"], x2, cfg))
    return torch.mean((online(x1) - t2) ** 2) + torch.mean((online(x2) - t1) ** 2)


def _ema_(target, online, tau: float) -> None:
    """target <- tau * target + (1 - tau) * online, leaf by leaf, matched by
    key (the two trees may hold their keys in different orders)."""
    if isinstance(target, dict):
        for k in target:
            _ema_(target[k], online[k], tau)
    elif isinstance(target, (list, tuple)):
        for t, o in zip(target, online, strict=True):
            _ema_(t, o, tau)
    else:
        target.copy_(tau * target + (1 - tau) * online)


@torch.no_grad()
def target_update(params: dict, tau: float = 0.996) -> dict:
    """EMA, in place: target <- tau * target + (1 - tau) * online
    (tr_byol.py:66-70).  Returns ``params``."""
    for k in ("encoder", "projector"):
        _ema_(params["target"][k], params["online"][k], tau)
    return params
