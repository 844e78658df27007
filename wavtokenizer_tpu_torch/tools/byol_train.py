"""BYOL speaker-representation pretraining.

Port of ``tools_tpu/byol_train.py`` (ref tr_byol.py / train_byol.py): online
and target SimpleTransformer + ProjectionMLP, the online predictor, EMA
tau = 0.996, symmetric MSE on two views of one utterance.  The views are
two random time crops of saved features (``--features-dir``: .npy files,
extract_features output (D, T)), or Kaldi x-vector pairs (``--xvector-scp``,
byol_dataset.py's XVectorDataset).  Adam (``torch.optim.Adam``, optax's
defaults) trains the online nets.  The model goes to
``<out-dir>/byol_model.pt`` (a ``train/trainer.py::save_tree`` file:
{"online", "target"}); ``--tsne-out`` writes a 2-D t-SNE of the learned
embeddings (sklearn, imported only then).

    python -m wavtokenizer_tpu_torch.tools.byol_train --features-dir feats/ \\
        --steps 500 --out-dir runs/byol [--tsne-out runs/byol/tsne.npy] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def load_feature_files(features_dir: str, layout: str = "dt") -> list[np.ndarray]:
    """layout "dt": files are (D, T) like extract_features output; "td":
    already time-major (T, D)."""
    feats = []
    for name in sorted(os.listdir(features_dir)):
        if name.endswith(".npy"):
            f = np.load(os.path.join(features_dir, name))
            if f.ndim == 2 and layout == "dt":
                f = f.T
            feats.append(np.asarray(f, np.float32))
    return feats


def two_views(rng, feats: list[np.ndarray], batch: int, crop: int):
    """(B, crop, D) view pairs: two random crops of one utterance per row."""
    d = feats[0].shape[-1]
    v1 = np.zeros((batch, crop, d), np.float32)
    v2 = np.zeros((batch, crop, d), np.float32)
    for b in range(batch):
        f = feats[rng.integers(0, len(feats))]
        for v in (v1, v2):
            if f.shape[0] <= crop:
                reps = 1 + crop // f.shape[0]
                fc = np.tile(f, (reps, 1))[:crop]
            else:
                s = rng.integers(0, f.shape[0] - crop + 1)
                fc = f[s:s + crop]
            v[b] = fc
    return v1, v2


def byol_step(params: dict, opt: torch.optim.Optimizer, v1: torch.Tensor, v2: torch.Tensor,
              cfg, tau: float) -> torch.Tensor:
    """One BYOL step: Adam on the online nets, then the target's EMA.
    Returns the loss."""
    from ..research.byol import byol_loss, target_update

    loss = byol_loss(params, v1, v2, cfg)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    target_update(params, tau=tau)
    return loss.detach()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--features-dir", default=None,
                    help=".npy feature files (extract_features output)")
    ap.add_argument("--xvector-scp", default=None,
                    help="Kaldi xvector.scp: train on speaker/material x-vector pairs "
                         "instead of feature crops (byol_dataset.py XVectorDataset mode)")
    ap.add_argument("--detect-clean", action="store_true",
                    help="fix the reference's inert clean-pairing phase "
                         "(see research/byol_data.py)")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--crop-frames", type=int, default=64)
    ap.add_argument("--learning-rate", type=float, default=3e-4)
    ap.add_argument("--tau", type=float, default=0.996)
    ap.add_argument("--out-dir", default="runs/byol")
    ap.add_argument("--tsne-out", default=None)
    ap.add_argument("--layout", choices=["dt", "td"], default="dt",
                    help="feature file layout: dt=(D,T) extract_features output, td=(T,D)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..checkpoint.convert import byol_from_jax
    from ..research.byol import BYOLConfig, init_byol, simple_transformer
    from ..train.step import tree_leaves
    from ..train.trainer import save_tree

    device = torch.device(args.device)
    xv = None
    if args.xvector_scp:
        from ..research.byol_data import XVectorPairs
        xv = XVectorPairs(args.xvector_scp, detect_clean=args.detect_clean)
        print(f"{len(xv)} x-vector pairs (dim {xv.feat_dim})")
        cfg = BYOLConfig(input_dim=xv.feat_dim)
    elif args.features_dir:
        feats = load_feature_files(args.features_dir, args.layout)
        if not feats:
            print("no .npy files found", file=sys.stderr)
            return 1
        cfg = BYOLConfig(input_dim=feats[0].shape[-1])
    else:
        ap.error("one of --features-dir / --xvector-scp is required")
    params = byol_from_jax(init_byol(cfg, seed=args.seed), device)
    online = tree_leaves(params["online"])
    for t in online:
        t.requires_grad_(True)
    opt = torch.optim.Adam(online, lr=args.learning_rate, betas=(0.9, 0.999), eps=1e-8)

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "metrics.jsonl"), "a") as logf:
        for s in range(args.steps):
            if xv is not None:
                v1, v2, _ = xv.batch(rng, args.batch_size)
            else:
                v1, v2 = two_views(rng, feats, args.batch_size, args.crop_frames)
            loss = byol_step(params, opt, torch.from_numpy(v1).to(device),
                             torch.from_numpy(v2).to(device), cfg, args.tau)
            if s % 20 == 0:
                rec = {"step": s, "byol_loss": float(loss)}
                print(rec)
                logf.write(json.dumps(rec) + "\n")
                logf.flush()
    save_tree(os.path.join(args.out_dir, "byol_model.pt"), params)
    print(f"saved {args.out_dir}/byol_model.pt")

    if args.tsne_out:
        from ..research.analysis import tsne_project

        def embed(x: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                return simple_transformer(params["online"]["encoder"],
                                          torch.from_numpy(x).to(device), cfg).cpu().numpy()

        if xv is not None:
            embs = [embed(np.asarray(xv.vectors[utt], np.float32)[None])[0]
                    for utt in sorted(xv.vectors)]
        else:
            embs = [embed(two_views(rng, [f], 1, args.crop_frames)[0])[0] for f in feats]
        embs = np.stack(embs)
        pts = tsne_project(embs, perplexity=min(30.0, max(2.0, len(embs) / 3)))
        np.save(args.tsne_out, pts)
        print(f"t-SNE projection saved to {args.tsne_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
