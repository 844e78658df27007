"""Offline evaluation over a (ground-truth dir, prediction dir) pair.

Port of ``metrics_infer.py`` (ref metrics/infer.py:17-116), with the same
flags and the same JSON, plus ``--device``: STOI at the files' rate,
PESQ-wb at 16 kHz (the ``pesq`` package or the native P.862), UTMOS (with
``WT_UTMOS_CKPT``), periodicity, pitch and voicing F1 at 16 kHz (CREPE with
``WT_CREPE_CKPT``, else NAC), SNR, log-mel distance and envelope similarity.
CREPE and UTMOS run on ``--device`` (``cuda`` unless asked otherwise); the
other metrics are host numpy.

    python -m wavtokenizer_tpu_torch.tools.metrics_infer --gt-dir GT \\
        --pred-dir PRED [--out summary.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np

from ..metrics.objective import (envelope_similarity, mel_spectral_distance, pesq_wb, snr_db,
                                 stoi, utmos_score)
from ..metrics.periodicity import calculate_periodicity_metrics
from ..utils.audio import read_audio, resample_np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--gt-dir", required=True)
    parser.add_argument("--pred-dir", required=True)
    parser.add_argument("--out", default=None, help="write JSON summary here")
    parser.add_argument("--device", default="cuda",
                        help="device of the CREPE and UTMOS nets (default cuda)")
    args = parser.parse_args(argv)

    gt_files = {p.name: p for p in Path(args.gt_dir).rglob("*.wav")}
    pred_files = {p.name: p for p in Path(args.pred_dir).rglob("*.wav")}
    common = sorted(set(gt_files) & set(pred_files))
    if not common:
        print("no matching filenames between dirs")
        return 1

    rows = []
    for name in common:
        ref, sr_r = read_audio(str(gt_files[name]))
        deg, sr_d = read_audio(str(pred_files[name]))
        if ref.ndim > 1:
            ref = ref.mean(axis=-1)
        if deg.ndim > 1:
            deg = deg.mean(axis=-1)
        if sr_d != sr_r:
            deg = resample_np(deg, sr_d, sr_r)
        ref16 = resample_np(ref, sr_r, 16000)
        deg16 = resample_np(deg, sr_r, 16000)
        # the reference's CREPE when its weights are on disk, NAC otherwise
        per_rmse, pitch_rmse, f1 = calculate_periodicity_metrics(
            ref16, deg16, use_crepe=bool(os.environ.get("WT_CREPE_CKPT")), device=args.device)
        u = utmos_score(deg16, device=args.device)
        rows.append({
            "file": name,
            "stoi": stoi(ref, deg, sr_r),
            "pesq_wb": pesq_wb(ref, deg, sr_r),
            "utmos": float(np.mean(u)) if u is not None else None,
            "snr_db": snr_db(ref, deg),
            "mel_dist": mel_spectral_distance(ref, deg, sr_r),
            "env_sim": envelope_similarity(ref, deg),
            "periodicity_rmse": per_rmse,
            "pitch_rmse_cents": pitch_rmse,
            "voiced_f1": f1,
        })

    def agg(key):
        vals = [r[key] for r in rows if r[key] is not None
                and not (isinstance(r[key], float) and np.isnan(r[key]))]
        return float(np.mean(vals)) if vals else None

    summary = {k: agg(k) for k in rows[0] if k != "file"}
    summary["num_files"] = len(rows)
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "files": rows}, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
