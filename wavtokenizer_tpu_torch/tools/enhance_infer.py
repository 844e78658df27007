"""Enhanced-model inference over a folder of (long) WAVs.

Port of ``tools_tpu/enhance_infer.py`` (ref tsne_inf.py:63-157): each file is
cut into 3 s chunks with 25% overlap (``api/streaming.py::chunk_audio``), all
chunks of a file go through ``enhanced_forward(..., train=False,
feature_scale=1.5)`` in one batch, and the outputs are cross-faded back
together (``crossfade_join``), peak-clipped and written as 16-bit PCM.

    python -m wavtokenizer_tpu_torch.tools.enhance_infer --input-dir noisy/ \\
        --output-dir out/ --adapter-ckpt runs/enhance/best_model.pt \\
        [--config c.yaml --checkpoint model.ckpt] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input-dir", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--adapter-ckpt", required=True, help="tools.enhance_train checkpoint")
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--chunk-seconds", type=float, default=3.0)
    ap.add_argument("--overlap", type=float, default=0.25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from scipy.io import wavfile

    from ..api.streaming import chunk_audio, crossfade_join
    from ..research.adapter import base_params_from_jax, enhanced_forward
    from ..train.trainer import load_tree
    from ..utils.audio import read_audio, resample_np
    from .enhance_train import load_base_model

    device = torch.device(args.device)
    spec, params_np = load_base_model(args.config, args.checkpoint)
    base_params = base_params_from_jax(params_np, spec.seanet, device)
    ck = load_tree(args.adapter_ckpt, device)
    base_params["decoder"] = ck["decoder"]

    sr = spec.sample_rate
    chunk_samples = int(args.chunk_seconds * sr)
    os.makedirs(args.output_dir, exist_ok=True)
    names = sorted(n for n in os.listdir(args.input_dir) if n.endswith(".wav"))
    for i, name in enumerate(names):
        y, in_sr = read_audio(os.path.join(args.input_dir, name))
        if y.ndim > 1:
            y = y.mean(axis=-1)
        if in_sr != sr:
            y = resample_np(y, in_sr, sr)
        chunks, stride, orig_len = chunk_audio(y, chunk_samples, args.overlap)
        with torch.no_grad():
            out, _, _, _ = enhanced_forward(base_params, spec.seanet, ck["adapter"],
                                            ck["adapter_state"], chunks.to(device),
                                            train=False, feature_scale=1.5)
            joined = crossfade_join(out[:, :chunk_samples], stride, orig_len).cpu().numpy()
        peak = np.abs(joined).max()
        if peak > 1.0:
            joined = joined / peak
        wavfile.write(os.path.join(args.output_dir, name), sr,
                      (np.clip(joined, -1, 1) * 32767).astype(np.int16))
        print(f"{i + 1}/{len(names)} {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
