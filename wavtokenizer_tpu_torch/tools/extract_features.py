"""Bulk feature extraction: the raw pre-VQ SEANet encoder features of a file
or a directory tree, saved as ``<stem>_features.npy`` (D, T'), and with
``--codes`` the token ids as ``<stem>_codes.npy`` (1, T').

Port of ``extract_features.py`` (ref extract_features.py:32-178): every
file is peak-normalised, repeat-padded or cropped to ``--seconds``, and the
windows go through the encoder in batches of ``--batch-size`` (the encoder
front runs in its CUDA kernel), data-parallel over ``--devices`` (default:
every visible card, or ``--device``) as the JAX tool shards its batches
over every device (``extract_features.py:57-88``): one replica of the
weights per device, the batch size rounded down to a multiple of their
number, and a ragged last batch padded with zero rows that are cut back.

    python -m wavtokenizer_tpu_torch.tools.extract_features --config c.yaml \\
        --ckpt m.ckpt --input dir/ --out-dir feats/ [--codes] [--device cuda] \\
        [--devices cuda:0,cuda:1]
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np


def iter_audio_files(path: str):
    p = Path(path)
    if p.is_file():
        yield p
        return
    for ext in ("*.wav", "*.flac", "*.mp3"):
        yield from sorted(p.rglob(ext))


def load_window(path, sr: int, T: int) -> np.ndarray:
    """Mono, resampled to ``sr``, peak-normalised (ref extract_features.py:43),
    repeat-padded or cropped to ``T`` samples."""
    from ..utils.audio import read_audio, resample_np
    y, in_sr = read_audio(str(path))
    if y.ndim > 1:
        y = y.mean(axis=-1)
    y = resample_np(y, in_sr, sr)
    y = y / (np.abs(y).max() + 1e-9)
    if len(y) < T:
        reps = 1 + (T - len(y)) // len(y)
        y = np.concatenate([y] * (reps + 1))[:T]
    return y[:T].astype(np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--input", required=True, help="audio file or directory")
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--devices", default=None,
                        help="comma-separated devices, one replica each (default: every "
                             "visible card for --device cuda, else --device)")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--seconds", type=float, default=3.0,
                        help="window length per item (repeat-pad/crop)")
    parser.add_argument("--codes", action="store_true", help="also save the token ids")
    args = parser.parse_args(argv)

    import torch

    from ..api.pretrained import WavTokenizer
    from ..models.quantize import vq_infer
    from ..models.seanet import seanet_encode
    from ..models.wavtokenizer import full_fp32
    from ..parallel.replicas import Replicas, device_list

    if args.devices is None and args.device == "cuda":
        args.devices = ",".join(f"cuda:{i}" for i in range(torch.cuda.device_count()))
    devices = device_list(args.devices, args.device)
    wt = WavTokenizer.from_pretrained0802(args.config, args.ckpt, device=devices[0])
    replicas = Replicas(wt, devices)
    n_dev = len(replicas)
    spec = wt.spec
    T = int(args.seconds * spec.sample_rate)
    os.makedirs(args.out_dir, exist_ok=True)
    files = list(iter_audio_files(args.input))
    B = args.batch_size - args.batch_size % n_dev or n_dev
    print(f"{len(files)} files, batch {B} over {n_dev} device(s): "
          + ", ".join(str(d) for d in devices))

    def extract(model, rows):
        audio = torch.from_numpy(rows).to(model.device)
        with torch.inference_mode(), full_fp32():
            emb = seanet_encode(model.params["encoder"], spec.seanet, audio[:, :, None])
            _, codes = vq_infer(model.params["quantizer"], emb)
        return emb.transpose(1, 2), codes                # (b, D, T'), (1, b, T')

    for i in range(0, len(files), B):
        chunk = files[i:i + B]
        batch = np.stack([load_window(p, spec.sample_rate, T) for p in chunk])
        if len(batch) % n_dev:      # zero rows to divide over the devices
            pad = n_dev - len(batch) % n_dev
            batch = np.concatenate([batch, np.zeros((pad, T), np.float32)])
        out = replicas.map(extract, batch)
        feats = np.concatenate([f.cpu().numpy() for f, _ in out])[:len(chunk)]
        codes = np.concatenate([c.cpu().numpy() for _, c in out], axis=1)[:, :len(chunk)]
        for j, p in enumerate(chunk):
            np.save(os.path.join(args.out_dir, p.stem + "_features.npy"), feats[j])
            if args.codes:
                np.save(os.path.join(args.out_dir, p.stem + "_codes.npy"), codes[:, j])
        print(f"[{i + len(chunk)}/{len(files)}]")
    replicas.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
