"""Feature-space analysis: round-trip t-SNE and clean-against-enhanced plots.

Port of ``tools_tpu/analyze_features.py``:

* ``roundtrip`` (wav_re.py:39-100): encode every file of a folder with the
  plain tokenizer (``encode_infer``), decode (``decode``), save the
  reconstructions and the pooled features, and t-SNE them (one point per
  file, coloured by the file name's group).
* ``compare`` (add.py:354-443): one t-SNE of the clean features (the
  encoder) and the enhanced ones (``enhanced_forward`` with an
  ``tools.enhance_train`` checkpoint), one group per (material, variant).

All clips are cropped or repeat-padded to a fixed window and go through the
model in one batch.  The t-SNE and its plot are host-side sklearn and
matplotlib (``research/analysis.py``), imported only when they run.

    python -m wavtokenizer_tpu_torch.tools.analyze_features roundtrip \\
        --input-dir wavs/ --out-dir out/ [--config c.yaml --checkpoint m.ckpt]
    python -m wavtokenizer_tpu_torch.tools.analyze_features compare \\
        --input-dir wavs/ --adapter-ckpt runs/enhance/best_model.pt --out-dir out/
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np
import torch


def material_of(name: str, pattern: str = r"([A-Za-z]+)") -> str:
    """Group label from a file name (add.py keys its plots off the material
    token in the name, e.g. ``s1_box_LDV.wav`` -> ``box``)."""
    parts = re.split(r"[_\-.]", os.path.splitext(os.path.basename(name))[0])
    for p in parts[1:]:
        m = re.fullmatch(pattern, p)
        if m:
            return m.group(1)
    return parts[0]


def load_clips(input_dir: str, sample_rate: int, seconds: float = 3.0):
    """Every WAV/FLAC of a folder, mono-mixed, resampled, cropped or
    repeat-padded to ``seconds`` -> (names, (N, T) float32)."""
    from ..utils.audio import read_audio, resample_np

    T = int(seconds * sample_rate)
    names, clips = [], []
    for name in sorted(os.listdir(input_dir)):
        if not name.lower().endswith((".wav", ".flac")):
            continue
        y, sr = read_audio(os.path.join(input_dir, name))
        if y.ndim > 1:
            y = y.mean(axis=-1)
        if sr != sample_rate:
            y = resample_np(y, sr, sample_rate)
        if len(y) < T:
            y = np.tile(y, 1 + T // max(len(y), 1))[:T]
        else:
            y = y[:T]
        names.append(name)
        clips.append(np.asarray(y, np.float32))
    if not clips:
        raise SystemExit(f"no audio files in {input_dir}")
    return names, np.stack(clips)


def run_roundtrip(args) -> int:
    from ..api.pretrained import WavTokenizer
    from ..research.analysis import plot_tsne, pool_features, tsne_project
    from ..utils.audio import save_pcm16
    from .enhance_train import load_base_model

    spec, params_np = load_base_model(args.config, args.checkpoint)
    model = WavTokenizer.from_jax_params(params_np, spec, device=args.device)
    names, clips = load_clips(args.input_dir, spec.sample_rate, args.seconds)
    feats, _ = model.encode_infer(clips)
    recon = model.decode(feats, args.bandwidth_id).cpu().numpy()
    feats = feats.cpu().numpy()

    os.makedirs(args.out_dir, exist_ok=True)
    for name, wav in zip(names, recon):
        # reconstructions are PCM WAV whatever the source container
        save_pcm16(os.path.join(args.out_dir, os.path.splitext(name)[0] + ".wav"), wav,
                   spec.sample_rate)
    pooled = pool_features(feats, time_axis=2)   # encode_infer: (B, D, T')
    np.save(os.path.join(args.out_dir, "pooled_features.npy"), pooled)
    if len(names) >= 3:
        pts = tsne_project(pooled, perplexity=args.perplexity)
        plot_tsne(pts, [material_of(n) for n in names], os.path.join(args.out_dir, "tsne.png"),
                  title="encoder features (wav_re-style roundtrip)")
        print(f"t-SNE -> {os.path.join(args.out_dir, 'tsne.png')}")
    print(f"wrote {len(names)} reconstructions to {args.out_dir}")
    return 0


def run_compare(args) -> int:
    from ..research.adapter import base_params_from_jax, enhanced_forward, frozen_encode
    from ..research.analysis import plot_tsne, pool_features, tsne_project
    from ..train.trainer import load_tree
    from .enhance_train import load_base_model

    device = torch.device(args.device)
    spec, params_np = load_base_model(args.config, args.checkpoint)
    base_params = base_params_from_jax(params_np, spec.seanet, device)
    names, clips = load_clips(args.input_dir, spec.sample_rate, args.seconds)
    ck = load_tree(args.adapter_ckpt, device)
    audio = torch.from_numpy(clips).to(device)
    clean = frozen_encode(base_params["encoder"], spec.seanet, audio)
    with torch.no_grad():
        _, enhanced, _, _ = enhanced_forward(base_params, spec.seanet, ck["adapter"],
                                             ck["adapter_state"], audio, train=False)
    # channel-last (B, T', D)
    pooled = np.concatenate([pool_features(clean.cpu().numpy(), time_axis=1),
                             pool_features(enhanced.cpu().numpy(), time_axis=1)])
    labels = ([f"{material_of(n)}/clean" for n in names]
              + [f"{material_of(n)}/enhanced" for n in names])

    os.makedirs(args.out_dir, exist_ok=True)
    np.save(os.path.join(args.out_dir, "combined_features.npy"), pooled)
    out_png = os.path.join(args.out_dir, "combined_tsne.png")
    pts = tsne_project(pooled, perplexity=args.perplexity)
    plot_tsne(pts, labels, out_png, title="clean vs enhanced features (add.py-style)")
    print(f"combined t-SNE ({len(names)} files x 2 variants) -> {out_png}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="mode", required=True)
    for mode in ("roundtrip", "compare"):
        p = sub.add_parser(mode)
        p.add_argument("--input-dir", required=True)
        p.add_argument("--out-dir", required=True)
        p.add_argument("--config", default=None)
        p.add_argument("--checkpoint", default=None)
        p.add_argument("--seconds", type=float, default=3.0)
        p.add_argument("--perplexity", type=float, default=30.0)
        p.add_argument("--bandwidth-id", type=int, default=0)
        p.add_argument("--device", default="cuda")
    sub.choices["compare"].add_argument("--adapter-ckpt", required=True)
    args = ap.parse_args(argv)
    return run_roundtrip(args) if args.mode == "roundtrip" else run_compare(args)


if __name__ == "__main__":
    raise SystemExit(main())
