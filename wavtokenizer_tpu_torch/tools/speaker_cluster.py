"""Speaker clustering and similarity scoring over codec features.

Port of ``tools_tpu/speaker_cluster.py``:

* ``cluster`` (tr_encodec.py:264-344): pool each utterance's encoder
  features, k-means them into speaker clusters, save the centroids and
  labels (and optionally a t-SNE plot of the clustered embeddings).
* ``score`` (recon.py:95-165): cosine similarity of each utterance's pooled
  embedding against saved centroids; the best-matching cluster per file.

The features come from .npy files (extract_features output, (D, T)) or from
WAVs through the port's frozen SEANet encoder, all clips in one batch.
k-means and t-SNE are host-side sklearn (``research/analysis.py``).

    python -m wavtokenizer_tpu_torch.tools.speaker_cluster cluster --input-dir wavs/ \\
        --n-clusters 4 --out-dir runs/spk [--tsne-png runs/spk/tsne.png] [--device cuda]
    python -m wavtokenizer_tpu_torch.tools.speaker_cluster score --input-dir wavs/ \\
        --centroids runs/spk/centroids.npy --out runs/spk/scores.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def embeddings_from_args(args) -> tuple[list[str], np.ndarray]:
    """-> (names, (N, D) pooled embeddings) from --features-dir or --input-dir."""
    from ..research.analysis import pool_features

    if args.features_dir:
        names, pooled = [], []
        for n in sorted(os.listdir(args.features_dir)):
            if not n.endswith(".npy"):
                continue
            f = np.load(os.path.join(args.features_dir, n))
            if f.ndim != 2:
                raise SystemExit(f"{n}: expected 2-D features, got {f.shape}")
            if args.layout == "dt":
                f = f.T
            names.append(n)
            pooled.append(f.mean(axis=0))
        if not names:
            raise SystemExit(f"no .npy files in {args.features_dir}")
        return names, np.stack(pooled).astype(np.float32)

    from ..api.pretrained import seanet_from_jax
    from ..models.seanet import encoder_layer_specs
    from ..research.adapter import frozen_encode
    from .analyze_features import load_clips
    from .enhance_train import load_base_model

    spec, params_np = load_base_model(args.config, args.checkpoint)
    encoder = seanet_from_jax(params_np["encoder"], encoder_layer_specs(spec.seanet),
                              torch.device(args.device))
    names, clips = load_clips(args.input_dir, spec.sample_rate, args.seconds)
    feats = frozen_encode(encoder, spec.seanet, torch.from_numpy(clips).to(args.device))
    return names, pool_features(feats.cpu().numpy(), time_axis=1)


def run_cluster(args) -> int:
    from ..research.analysis import kmeans_clusters, plot_tsne, tsne_project

    names, embs = embeddings_from_args(args)
    if len(names) < args.n_clusters:
        raise SystemExit(f"{len(names)} utterances < {args.n_clusters} clusters")
    labels, centroids = kmeans_clusters(embs, args.n_clusters, seed=args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    np.save(os.path.join(args.out_dir, "centroids.npy"), centroids)
    with open(os.path.join(args.out_dir, "labels.json"), "w") as f:
        json.dump({n: int(lab) for n, lab in zip(names, labels)}, f, indent=2)
    print(f"{len(names)} utterances -> {args.n_clusters} clusters; "
          f"centroids + labels in {args.out_dir}")
    if args.tsne_png:
        pts = tsne_project(embs, perplexity=min(30.0, max(2.0, len(embs) / 3)))
        plot_tsne(pts, labels, args.tsne_png, title="speaker clusters")
        print(f"t-SNE -> {args.tsne_png}")
    return 0


def run_score(args) -> int:
    from ..research.analysis import speaker_similarity

    names, embs = embeddings_from_args(args)
    centroids = np.load(args.centroids)
    report = {}
    for n, e in zip(names, embs):
        sims = speaker_similarity(e, centroids)
        report[n] = {"best_cluster": int(np.argmax(sims)),
                     "similarities": [round(float(s), 4) for s in sims]}
    out = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
        print(f"scores for {len(names)} files -> {args.out}")
    else:
        print(out)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="mode", required=True)
    for mode in ("cluster", "score"):
        p = sub.add_parser(mode)
        p.add_argument("--input-dir", default=None, help="wav folder")
        p.add_argument("--features-dir", default=None,
                       help=".npy features (extract_features output)")
        p.add_argument("--layout", choices=["dt", "td"], default="dt")
        p.add_argument("--config", default=None)
        p.add_argument("--checkpoint", default=None)
        p.add_argument("--seconds", type=float, default=3.0)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--device", default="cuda")
    sub.choices["cluster"].add_argument("--n-clusters", type=int, required=True)
    sub.choices["cluster"].add_argument("--out-dir", required=True)
    sub.choices["cluster"].add_argument("--tsne-png", default=None)
    sub.choices["score"].add_argument("--centroids", required=True)
    sub.choices["score"].add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not args.input_dir and not args.features_dir:
        ap.error("one of --input-dir / --features-dir is required")
    return run_cluster(args) if args.mode == "cluster" else run_score(args)


if __name__ == "__main__":
    raise SystemExit(main())
