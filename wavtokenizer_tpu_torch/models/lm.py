"""Streaming transformer and token LM for entropy coding.

Port of ``wavtokenizer_tpu/models/lm.py`` (ref encoder/modules/
transformer.py:16-120, StreamingTransformerEncoder: sinusoidal positions
with an offset, per-layer state carried across calls, attention limited to
``past_context``; and encoder/model.py:27-65, LMModel: per-codebook
embeddings summed, a shared trunk, per-codebook heads, softmax over the
cardinality).  As in the JAX package the state is a fixed-length
``past_context`` ring per layer, so every streamed step has the same
shapes; the reference grows a Python list instead.

``init_lm`` draws the JAX package's numbers (numpy, same order) and returns
its pytree; ``lm_params_to(params, device)`` turns it into tensors.  Plain
torch ops: the LM has no TPU kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class StreamingTransformerConfig:
    dim: int = 200
    hidden_scale: float = 4.0
    num_heads: int = 8
    num_layers: int = 5
    max_period: float = 10000.0
    past_context: int = 1000
    gelu: bool = True
    norm_in: bool = True


@dataclass(frozen=True)
class LMConfig:
    n_q: int = 32
    card: int = 1024
    transformer: StreamingTransformerConfig = StreamingTransformerConfig()


def create_sin_embedding(positions: torch.Tensor, dim: int,
                         max_period: float = 10000.0) -> torch.Tensor:
    """(1, T, 1) positions -> (1, T, dim) (ref transformer.py:16-27)."""
    half_dim = dim // 2
    adim = torch.arange(half_dim, device=positions.device).reshape(1, 1, -1)
    phase = positions / (max_period ** (adim / (half_dim - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def _linear(rng, cin, cout):
    bound = 1.0 / np.sqrt(cin)
    return {"weight": rng.uniform(-bound, bound, (cin, cout)).astype(np.float32),
            "bias": rng.uniform(-bound, bound, (cout,)).astype(np.float32)}


def _ln(c):
    return {"weight": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}


def init_streaming_transformer(cfg: StreamingTransformerConfig, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    d, h = cfg.dim, int(cfg.dim * cfg.hidden_scale)
    layers = [{"in_proj": _linear(rng, d, 3 * d), "out_proj": _linear(rng, d, d),
               "ln1": _ln(d), "ln2": _ln(d),
               "ff1": _linear(rng, d, h), "ff2": _linear(rng, h, d)}
              for _ in range(cfg.num_layers)]
    p = {"layers": layers}
    if cfg.norm_in:
        p["norm_in"] = _ln(d)
    return p


def init_lm(cfg: LMConfig, seed: int = 0) -> dict:
    """Seeded LM params, numpy, bit-equal to the JAX package's ``init_lm``."""
    rng = np.random.default_rng(seed)
    d = cfg.transformer.dim
    return {
        "transformer": init_streaming_transformer(cfg.transformer, seed),
        "emb": [rng.normal(0, 1, (cfg.card + 1, d)).astype(np.float32)
                for _ in range(cfg.n_q)],
        "linears": [_linear(rng, d, cfg.card) for _ in range(cfg.n_q)],
    }


def lm_params_to(params, device):
    """The LM pytree (numpy leaves) -> the same tree of f32 tensors on ``device``."""
    if isinstance(params, dict):
        return {k: lm_params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [lm_params_to(v, device) for v in params]
    return torch.as_tensor(np.asarray(params, np.float32)).to(device)


def _layer_norm(x: torch.Tensor, p: dict) -> torch.Tensor:
    """torch nn.LayerNorm, eps 1e-5 (the transformer layers' value)."""
    return F.layer_norm(x, (x.shape[-1],), p["weight"], p["bias"], eps=1e-5)


def _streaming_attention(p: dict, x: torch.Tensor, x_past: torch.Tensor,
                         past_context: int, num_heads: int, offset: int) -> torch.Tensor:
    """Self-attention over [past, current] with the reference's validity mask
    (ref transformer.py:44-59): a key at most ``past_context`` behind its
    query and not after it.

    ``x_past`` is the fixed-length (B, past_context, D) ring.  Past slot j
    sits at absolute position offset - past_context + j.  The reference's
    initial state is ONE zero step that its mask attends as a token at
    position -1 until ``past_context`` tokens age it out; slots below -1 are
    padding and stay masked."""
    B, T, D = x.shape
    H_len = x_past.shape[1]
    wq, wk, wv = p["in_proj"]["weight"].split(D, dim=1)
    bq, bk, bv = p["in_proj"]["bias"].split(D)
    keys_in = torch.cat([x_past, x], dim=1)
    hd = D // num_heads
    q = (x @ wq + bq).reshape(B, T, num_heads, hd)
    k = (keys_in @ wk + bk).reshape(B, T + H_len, num_heads, hd)
    v = (keys_in @ wv + bv).reshape(B, T + H_len, num_heads, hd)
    q_pos = offset + torch.arange(T, device=x.device).reshape(-1, 1)
    k_pos = (offset - H_len) + torch.arange(T + H_len, device=x.device).reshape(1, -1)
    delta = q_pos - k_pos
    valid = (delta >= 0) & (delta <= past_context) & (k_pos >= -1)
    w = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    w = torch.softmax(w.masked_fill(~valid, -math.inf), dim=-1)
    o = torch.einsum("bhts,bshd->bthd", w, v).reshape(B, T, D)
    return o @ p["out_proj"]["weight"] + p["out_proj"]["bias"]


def streaming_transformer(params: dict, cfg: StreamingTransformerConfig,
                          x: torch.Tensor, states: list | None = None,
                          offset: int = 0):
    """x (B, T, D) -> (y, new_states, new_offset) (ref transformer.py:103-120).
    Post-LN layers (torch's norm_first=False): LN(x + attn), LN(x + ff)."""
    B, T, C = x.shape
    if states is None and offset != 0:
        # Fresh buffers are masked by ABSOLUTE position: a fresh stream at
        # offset > 0 would attend up to past_context zero slots where the
        # reference attends exactly one.
        raise ValueError(
            f"states=None implies a fresh stream: offset must be 0, got {offset} "
            "(resume mid-stream by passing the states returned by the previous call)")
    if states is None:
        states = [x.new_zeros(B, cfg.past_context, C) for _ in params["layers"]]
    positions = (torch.arange(T, device=x.device).reshape(1, -1, 1) + offset).to(x.dtype)
    pos_emb = create_sin_embedding(positions, C, cfg.max_period)
    if "norm_in" in params:
        x = _layer_norm(x, params["norm_in"])
    x = x + pos_emb
    # The reference's F.gelu is the exact erf form (transformer.py:86).
    act = F.gelu if cfg.gelu else F.relu
    new_states = []
    for lp, st in zip(params["layers"], states):
        sa_in = x
        x = _layer_norm(x + _streaming_attention(lp, x, st, cfg.past_context,
                                                 cfg.num_heads, offset), lp["ln1"])
        ff = act(x @ lp["ff1"]["weight"] + lp["ff1"]["bias"])
        x = _layer_norm(x + ff @ lp["ff2"]["weight"] + lp["ff2"]["bias"], lp["ln2"])
        new_states.append(torch.cat([st, sa_in], dim=1)[:, -cfg.past_context:])
    return x, new_states, offset + T


@torch.inference_mode()
def lm_forward(params: dict, cfg: LMConfig, indices: torch.Tensor,
               states: list | None = None, offset: int = 0):
    """indices (B, K, T) shifted token ids (0 = missing) -> (probabilities
    (B, card, K, T), states, offset) (ref encoder/model.py:46-65)."""
    K = indices.shape[1]
    idx = indices.long()
    x = params["emb"][0][idx[:, 0]]
    for k in range(1, K):
        x = x + params["emb"][k][idx[:, k]]
    out, states, offset = streaming_transformer(params["transformer"], cfg.transformer,
                                                x, states, offset)
    logits = torch.stack([out @ params["linears"][k]["weight"] + params["linears"][k]["bias"]
                          for k in range(K)], dim=1)              # (B, K, T, card)
    return torch.softmax(logits.permute(0, 3, 1, 2), dim=1), states, offset
