"""Batch reconstruction: load a checkpoint, encode + decode every file of a
file list, write 16-bit PCM WAVs.

Port of ``infer.py`` (ref infer.py:31-70).  ``--ckpt`` is a Lightning
checkpoint, or one of this package's training checkpoints
(``train/trainer.py::save_checkpoint``), told apart by content: a training
checkpoint loads through ``WavTokenizer.from_train_checkpoint``, as the JAX
tool sends its training checkpoints.  The files of a group share
batched model calls: every file is cut into overlapping chunks
(``api.streaming.reconstruct_long_batch``), the chunks of all files ride
power-of-two batches of up to ``--batch-size``, and each file is
cross-faded back together.

    python -m wavtokenizer_tpu_torch.tools.infer --config c.yaml --ckpt m.ckpt \\
        --filelist files.txt --out-dir out/ [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import pickle

import torch

from ..utils.audio import save_pcm16


def is_train_checkpoint(path: str) -> bool:
    """True for a ``train/trainer.py::save_checkpoint`` file: a dict that
    holds ``gen`` and ``step``.  A file that ``weights_only`` cannot read
    (a Lightning checkpoint pickling its hyper-parameters) is not one."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except (pickle.UnpicklingError, RuntimeError):
        return False
    return isinstance(ckpt, dict) and "gen" in ckpt and "step" in ckpt


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", required=True,
                        help="torch/Lightning .ckpt, or a tools.train checkpoint (last.pt)")
    parser.add_argument("--filelist", required=True)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--bandwidth-id", type=int, default=0)
    parser.add_argument("--batch-size", type=int, default=128,
                        help="model batch: chunks of MANY files share each call")
    parser.add_argument("--chunk-seconds", type=float, default=3.0)
    parser.add_argument("--overlap", type=float, default=0.25,
                        help="chunk overlap fraction (the reference's 0.25)")
    parser.add_argument("--files-per-group", type=int, default=64,
                        help="files read per host-side group (bounds host RAM)")
    args = parser.parse_args(argv)

    from ..api.pretrained import WavTokenizer
    from ..api.streaming import reconstruct_long_batch
    from ..utils.audio import read_audio, resample_np

    load = (WavTokenizer.from_train_checkpoint if is_train_checkpoint(args.ckpt)
            else WavTokenizer.from_pretrained0802)
    wt = load(args.config, args.ckpt, device=args.device)
    sr = wt.spec.sample_rate
    os.makedirs(args.out_dir, exist_ok=True)
    with open(args.filelist) as f:
        files = [line.strip() for line in f if line.strip()]

    for g in range(0, len(files), args.files_per_group):
        group = files[g:g + args.files_per_group]
        audios = []
        for path in group:
            y, in_sr = read_audio(path)
            if y.ndim > 1:
                y = y.mean(axis=-1)
            audios.append(resample_np(y, in_sr, sr))
        wavs = reconstruct_long_batch(wt, audios, chunk_seconds=args.chunk_seconds,
                                      overlap=args.overlap,
                                      bandwidth_id=args.bandwidth_id,
                                      batch_size=args.batch_size)
        for path, y, wav in zip(group, audios, wavs):
            out = os.path.join(args.out_dir, os.path.basename(path))
            save_pcm16(out, wav.cpu().numpy()[:len(y)], sr)
            print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
