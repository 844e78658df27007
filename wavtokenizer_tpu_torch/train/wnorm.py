"""Weight-norm parametrization for training.

Port of ``wavtokenizer_tpu/train/wnorm.py``.  The reference trains the
SEANet convs and every discriminator conv under torch's ``weight_norm``
(w = g * v / |v|), so (v, g) are the trained tensors and the fold runs
inside every forward, where autograd differentiates through it as it does
through torch's reparametrization.

A conv in training form is {"v", "g", "bias"} in PyTorch's layout: v is the
weight, its first axis the one torch's ``weight_norm(dim=0)`` keeps (C_out
for a conv, C_in for a transposed conv), and g has that axis' extent and 1
elsewhere, e.g. v (C_out, C_in, K) and g (C_out, 1, 1) for a Conv1d, v
(C_out, C_in, Kh, Kw) and g (C_out, 1, 1, 1) for a Conv2d.  The norm runs
over every axis but the first, so one rule serves every kind of conv:
``weight_norm_conv`` is the JAX package's ``weight_norm_conv`` and
``weight_norm_conv2d`` in one, and ``weight_norm_conv2d`` is its Conv2d name.
"""

from __future__ import annotations

import torch


def fold_wn(v: torch.Tensor, g: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """g * v / |v|, the norm over every axis of v but the first."""
    norm = v.pow(2).sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return v * (g / (norm + eps))


def fold_tree(tree):
    """Recursively turn {v, g, bias} convs into {weight, bias}."""
    if isinstance(tree, dict):
        if "v" in tree and "g" in tree:
            out = {"weight": fold_wn(tree["v"], tree["g"])}
            if "bias" in tree:
                out["bias"] = tree["bias"]
            return out
        return {k: fold_tree(x) for k, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fold_tree(x) for x in tree)
    return tree


def weight_norm_conv(params: dict) -> dict:
    """{weight, (bias)} -> {v, g, (bias)} with v = weight and g = |weight|
    per first-axis slice (computed in float64), so the fold gives the weight
    back: torch's ``weight_norm`` init."""
    w = params["weight"]
    g = w.double().pow(2).sum(dim=tuple(range(1, w.dim())), keepdim=True).sqrt()
    out = {"v": w, "g": g.to(w.dtype)}
    if params.get("bias") is not None:
        out["bias"] = params["bias"]
    return out


# A Conv2d weight (C_out, C_in, Kh, Kw) folds over (C_in, Kh, Kw), the same
# rule: the JAX package's name for it.
weight_norm_conv2d = weight_norm_conv


def seanet_to_weight_norm(params: list, specs) -> list:
    """SEANet layer params with plain conv weights -> training (v, g) form;
    LSTM and parameter-free layers pass through."""
    out = []
    for p, spec in zip(params, specs):
        if spec.kind in ("conv", "convtr"):
            out.append(weight_norm_conv(p))
        elif spec.kind == "resblock":
            q = {"block": [weight_norm_conv(c) for c in p["block"]]}
            if "shortcut" in p:
                q["shortcut"] = weight_norm_conv(p["shortcut"])
            out.append(q)
        else:
            out.append(p)
    return out
