"""The SEANet encoder front (layers 0-6 of the small-320 geometry): the
geometry gate and the weight packing of its CUDA kernel.

Port of the host side of ``wavtokenizer_tpu/ops/encoder_front.py``.  The
kernel itself is ``csrc/encoder_front.cu``, launched by
``ops/kernels.py::encoder_front``; ``models/seanet.py::seanet_encode`` calls
it for layers 0-6 whenever ``front_geometry_matches`` admits the encoder and
the length.  The JAX module's bf16 hi/lo stacks, phase-major layout and
edge splice are TPU workarounds and are not carried over (see the kernel's
source note): the weights are only re-laid out for the CUDA cores, once,
when the model is built (``api/pretrained.py``), and kept with the params
under ``params[0]["front"]``.
"""

from __future__ import annotations

import torch

# (C_out, C_in, K) of every conv the kernel hardcodes, PyTorch layout.
FRONT_SHAPES = ((32, 1, 7), (64, 32, 4), (128, 64, 8),
                (16, 32, 3), (32, 16, 1), (32, 32, 1),
                (32, 64, 3), (64, 32, 1), (64, 64, 1))


def _conv_shapes(params: list) -> tuple:
    return tuple(tuple(w.shape) for w in (
        params[0]["weight"], params[3]["weight"], params[6]["weight"],
        params[1]["block"][0]["weight"], params[1]["block"][1]["weight"],
        params[1]["shortcut"]["weight"],
        params[4]["block"][0]["weight"], params[4]["block"][1]["weight"],
        params[4]["shortcut"]["weight"]))


def front_geometry_matches(specs, params, T: int) -> bool:
    """True when the front kernel serves this encoder and length.

    The exact small-320-family geometry the kernel hardcodes (k7 init conv
    to 32 channels, single k3/k1 resblocks with conv shortcuts, downsample
    strides 2 then 4, reflect padding, not causal) and the JAX gate's length
    conditions: T % 8 == 0 (no extra right padding at any front layer) and
    T >= 1024 (two of the JAX kernel's 512-sample edge windows; the CUDA
    kernel reflects the edges in-kernel and needs no windows, but keeps the
    gate so that both packages run the kernel on the same inputs)."""
    if len(specs) < 7 or T % 8 != 0 or T < 1024:
        return False
    kinds = [s.kind for s in specs[:7]]
    if kinds != ["conv", "resblock", "elu", "conv", "resblock", "elu", "conv"]:
        return False
    c0, rb1, _, d1, rb2, _, d2 = specs[:7]
    if any(s.causal or s.pad_mode != "reflect" for s in (c0, rb1, d1, rb2, d2)):
        return False
    if any(s.norm not in ("weight_norm", "none") for s in (c0, rb1, d1, rb2, d2)):
        return False
    if (c0.stride, d1.stride, d2.stride) != (1, 2, 4):
        return False
    for rb in (rb1, rb2):
        if (rb.true_skip or rb.block_kernel_sizes != (3, 1)
                or rb.block_dilations != (1, 1)):
            return False
    try:
        shapes = _conv_shapes(params)
    except (KeyError, IndexError, TypeError):
        return False
    return shapes == FRONT_SHAPES


def _cko(p: dict) -> list:
    """Conv {'weight': (C_out, C_in, K), 'bias'} -> [(C_in, K, C_out) flat, bias]."""
    return [p["weight"].permute(1, 2, 0).reshape(-1), p["bias"]]


def prepare_front_weights(params: list) -> dict:
    """Encoder layers 0-6 -> the kernel's operands, on the params' device.

    ``a``: conv0, k3, k1, shortcut, down k4 of resblock 32 as (C_in, K,
    C_out) + bias each, concatenated in the order of ``csrc/encoder_front.cu``
    (``A_*`` offsets); ``b``: k3, k1, shortcut of resblock 64 (``B_*``);
    ``wd``: the last conv as (8 * 64, 128), row ``tap * 64 + c_in``; ``bd``."""
    p0, rb1, _, d1, rb2, _, d2 = params[:7]
    k3a, k1a = rb1["block"]
    k3b, k1b = rb2["block"]
    a = torch.cat(_cko(p0) + _cko(k3a) + _cko(k1a) + _cko(rb1["shortcut"]) + _cko(d1))
    b = torch.cat(_cko(k3b) + _cko(k1b) + _cko(rb2["shortcut"]))
    wd = d2["weight"].permute(2, 1, 0).reshape(8 * 64, 128)
    return {"a": a.float().contiguous(), "b": b.float().contiguous(),
            "wd": wd.float().contiguous(), "bd": d2["bias"].float().contiguous()}
