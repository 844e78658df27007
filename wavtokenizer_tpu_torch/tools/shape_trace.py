"""Per-layer input/output shapes of the whole codec, computed without data.

Port of ``tools_tpu/shape_trace.py`` (the reference's captured module tree
with per-layer shapes, wavtokenizer.txt, is its shape oracle): the same text
for the same spec, batch and length, so that converted checkpoints and
config edits can be shape-checked on any machine.  The JAX tool runs on
``jax.eval_shape``; here the params are built on the meta device and every
layer runs on fake tensors (``torch._subclasses.FakeTensorMode``): shapes
and types propagate through each op's meta kernel, no arithmetic is done on
data and no memory is held for it.  Fake tensors report the CPU as their
device, so the kernels' wrappers (``ops/kernels.py``) take their plain path.

Every op of the trace has a meta kernel in PyTorch 2.11 and 2.13, the LSTM's
(``nn.LSTM``) and the ISTFT head's ``torch.fft.irfft`` included, so no op
needs a shape rule of its own.  An ``nn.LSTM`` module cannot hold fake
parameters, so the encoder's LSTM runs in its per-layer-weights form
(``ops/lstm.py::slstm_layers``, the training form of the same forward).

    python -m wavtokenizer_tpu_torch.tools.shape_trace [--config configs/...yaml] \\
        [--batch 1] [--seconds 3] [-o trace.txt]

``--config`` needs PyYAML; without it the trace is small-320's.
"""

from __future__ import annotations

import argparse
import io

import torch

_LSTM_NAMES = (("w_ih", "weight_ih"), ("w_hh", "weight_hh"), ("b_ih", "bias_ih"),
               ("b_hh", "bias_hh"))


def _fake(tree):
    """A params tree on the meta device -> the same tree of fake tensors;
    an ``nn.LSTM`` becomes its per-layer weights ({w_ih, w_hh, b_ih, b_hh})."""
    if isinstance(tree, dict):
        return {("layers" if k == "lstm" else k): _fake(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_fake(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype)
    if isinstance(tree, torch.nn.LSTM):
        return [{ours: torch.empty(getattr(tree, f"{theirs}_l{k}").shape)
                 for ours, theirs in _LSTM_NAMES} for k in range(tree.num_layers)]
    return tree


def shape_trace(spec, batch: int = 1, seconds: float = 3.0) -> str:
    """The formatted trace of ``spec`` for a (batch, seconds) clip."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..api.pretrained import from_jax_params
    from ..models.init import init_wavtokenizer
    from ..models.quantize import vq_infer
    from ..models.seanet import _apply_layer, encoder_layer_specs
    from ..models.vocos import (attn_block, convnext_block, group_norm, istft_head,
                                pos_resnet_block)
    from ..ops.conv import conv1d

    meta = from_jax_params(init_wavtokenizer(spec, seed=0, random_codebook=True), spec,
                           "meta")
    T = int(spec.sample_rate * seconds)
    out = io.StringIO()
    w = lambda depth, name, shape, extra="": out.write(
        "  " * depth + f"{name:<28s} {tuple(shape)} {extra}\n".rstrip() + "\n")

    with FakeTensorMode(), torch.no_grad():
        params = _fake(meta)
        out.write(f"WavTokenizer shape trace  (batch={batch}, clip={seconds}s @ "
                  f"{spec.sample_rate} Hz, hop={spec.hop_length})\n")
        x = torch.empty(batch, T, 1)
        w(0, "input", x.shape)

        out.write("feature_extractor.encoder (SEANet)\n")
        for i, (p, ls) in enumerate(zip(params["encoder"], encoder_layer_specs(spec.seanet))):
            x = _apply_layer(p, ls, x)
            label = ls.kind + (f" s{ls.stride}" if ls.stride > 1 else "")
            w(1, f"model.{i} {label}", x.shape)

        feats, codes = vq_infer(params["quantizer"], x)
        w(0, "quantizer (VQ)", feats.shape,
          f"codes {tuple(codes.shape)}  [{spec.vq.bins} bins x {spec.vq.dimension}]")

        out.write("backbone (Vocos)\n")
        bp = params["backbone"]
        g = spec.backbone.groupnorm_groups
        h = conv1d(feats, bp["embed"]["weight"], bp["embed"]["bias"], padding=(3, 3))
        w(1, "embed conv k7", h.shape)
        pos = bp["pos_net"]
        for i, blk in enumerate(pos[:-1]):
            if "q" in blk:
                h = attn_block(blk, h, g)
                w(1, f"pos_net.{i} attn", h.shape)
            else:
                h = pos_resnet_block(blk, h, g)
                w(1, f"pos_net.{i} resblock", h.shape)
        h = group_norm(h, pos[-1]["weight"], pos[-1]["bias"], g)
        w(1, f"pos_net.{len(pos) - 1} groupnorm", h.shape)
        for i, blk in enumerate(bp["convnext"]):
            h = convnext_block(blk, h, cond_id=0, fused=False)
            w(1, f"convnext.{i}", h.shape)

        y = istft_head(params["head"], spec.head, h)
        w(0, "head (ISTFT)", y.shape, f"[n_fft={spec.head.n_fft} hop={spec.head.hop_length}]")
    return out.getvalue()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=None)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)

    if args.config:
        from ..api.config import spec_from_config
        spec = spec_from_config(args.config)
    else:
        from ..models.wavtokenizer import WavTokenizerSpec
        spec = WavTokenizerSpec()

    text = shape_trace(spec, args.batch, args.seconds)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"wrote {args.output}")
    else:
        print(text, end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
