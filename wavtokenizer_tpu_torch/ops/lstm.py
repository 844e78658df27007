"""Stacked LSTM with residual skip (the SEANet SLSTM), channel-last.

Port of ``wavtokenizer_tpu/ops/lstm.py``.  The JAX package scans a time loop;
here one ``nn.LSTM`` runs all layers (cuDNN on the card).  Gate order is
PyTorch's own (i, f, g, o) and the bias is ``b_ih + b_hh``, so the JAX
package's weights load unchanged.  cuDNN runs an fp32 LSTM in TF32 unless
``torch.backends.cudnn.allow_tf32`` is off; the encode path turns it off.

Inference holds a frozen ``nn.LSTM`` (``lstm_from_layers``); training holds
the per-layer weight tensors and runs ``nn.LSTM``'s own forward over them
(``slstm_layers``), differentiable in those tensors.
"""

from __future__ import annotations

import torch
from torch import nn


_NAMES = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih",
          "b_hh": "bias_hh"}


def lstm_from_layers(layers: list[dict], device) -> nn.LSTM:
    """nn.LSTM holding the given per-layer weights
    ({w_ih (4H, C), w_hh (4H, H), b_ih (4H,), b_hh (4H,)})."""
    hidden = layers[0]["w_hh"].shape[1]
    inp = layers[0]["w_ih"].shape[1]
    lstm = nn.LSTM(inp, hidden, num_layers=len(layers), batch_first=True)
    with torch.no_grad():
        for k, p in enumerate(layers):
            for ours, theirs in _NAMES.items():
                getattr(lstm, f"{theirs}_l{k}").copy_(
                    torch.as_tensor(p[ours], dtype=torch.float32))
    return lstm.to(device).eval().requires_grad_(False)


def slstm(x: torch.Tensor, lstm: nn.LSTM, skip: bool = True) -> torch.Tensor:
    """x (B, T, C) -> LSTM(x) (+ x when ``skip``), (B, T, C)
    (ref SLSTM.forward, encoder/modules/lstm.py:31-39)."""
    y, _ = lstm(x)
    return y + x if skip else y


def slstm_layers(x: torch.Tensor, layers: list[dict], skip: bool = True) -> torch.Tensor:
    """``slstm`` over per-layer weight tensors ({w_ih, w_hh, b_ih, b_hh}),
    differentiable in them: ``nn.LSTM``'s forward (cuDNN on the card) with
    those tensors swapped in by ``torch.func.functional_call`` for a module
    that holds no weights of its own (on the meta device, in training mode,
    which cuDNN's backward needs; the module has no dropout)."""
    hidden, inp = layers[0]["w_hh"].shape[1], layers[0]["w_ih"].shape[1]
    lstm = nn.LSTM(inp, hidden, num_layers=len(layers), batch_first=True, device="meta")
    weights = {f"{theirs}_l{k}": p[ours] for k, p in enumerate(layers)
               for ours, theirs in _NAMES.items()}
    y, _ = torch.func.functional_call(lstm, weights, (x,))
    return y + x if skip else y
