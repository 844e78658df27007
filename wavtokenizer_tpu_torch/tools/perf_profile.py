"""Per-stage profile of the codec's round trip on one device.

Port of ``tools_tpu/perf_profile.py``: the stage table (encoder, VQ,
backbone, ISTFT head, and the encode, decode and round-trip totals) with ms
per call, TFLOP/s and MFU, and the round trip's real-time factor.  FLOPs
come from ``utils/profiling.py::stage_flops`` (the kernels' work counted from
their shapes); each stage's MFU is against the card's peak for the
arithmetic it runs (``STAGE_PRECISION``: the encoder fp32, the VQ 3xTF32,
the backbone's ConvNeXt GEMMs bf16, the head fp32; the totals mix them and
have none).  TF32 is off for matmuls and cuDNN throughout, as the encode
path always runs.  ``--trace-dir`` also writes a ``torch.profiler`` trace of
one round trip.  The last line is the table as one JSON object.

    python -m wavtokenizer_tpu_torch.tools.perf_profile [--batch 128] [--seconds 3] \\
        [--config c.yaml --checkpoint m.ckpt] [--trace-dir d/] [--iters 20] [--device cuda]

Without ``--config``/``--checkpoint`` it profiles small-320 with random
weights (``init_wavtokenizer(seed=0, random_codebook=True)``).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--config", default=None, help="reference YAML config")
    ap.add_argument("--checkpoint", default=None,
                    help="Lightning checkpoint (default: random small-320 weights)")
    ap.add_argument("--trace-dir", default=None,
                    help="also write a torch.profiler trace of one round trip here")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..models.wavtokenizer import full_fp32

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (use --device cpu for the plain versions on the CPU)")
        return 1
    with full_fp32():
        return _profile(args, device)


def _profile(args, device: torch.device) -> int:
    from ..api.pretrained import WavTokenizer
    from ..models.init import init_wavtokenizer
    from ..models.wavtokenizer import WavTokenizerSpec
    from ..utils.profiling import (STAGE_PRECISION, device_peak_flops, pipeline_stages,
                                   stage_flops, stage_timings, torch_trace)

    if args.config and args.checkpoint:
        model = WavTokenizer.from_pretrained0802(args.config, args.checkpoint, device=device)
    else:
        spec = WavTokenizerSpec()
        model = WavTokenizer.from_jax_params(init_wavtokenizer(spec, seed=0, random_codebook=True),
                                             spec, device=device)
    spec, params = model.spec, model.params
    B, T = args.batch, int(spec.sample_rate * args.seconds)
    audio = torch.as_tensor((np.random.default_rng(0).normal(size=(B, T)) * 0.1)
                            .astype(np.float32)).to(device)

    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {card}  batch={B}  clip={args.seconds}s  TF32 off", flush=True)
    stages = pipeline_stages(params, spec, audio)
    times = stage_timings(stages, iters=args.iters)
    flops = stage_flops(stages)
    rows = {}
    print(f"  {'stage':13s} {'ms':>9s} {'TFLOP/s':>9s} {'precision':>9s} {'mfu':>7s}")
    for name, ms in times.items():
        f = flops[name]
        tfs = f / (ms / 1e3) / 1e12 if ms > 0 else 0.0
        precision = STAGE_PRECISION.get(name)
        peak = (device_peak_flops(precision, card) if device.type == "cuda" and precision
                else None)
        mfu = tfs * 1e12 / peak if peak else None
        rows[name] = {"ms": ms, "flops": f, "tflops": tfs, "precision": precision, "mfu": mfu}
        print(f"  {name:13s} {ms:9.3f} {tfs:9.2f} {precision or 'mixed':>9s} "
              + (f"{mfu:7.3f}" if mfu is not None else "      -"), flush=True)
    rtf = B * args.seconds / (times["roundtrip"] / 1e3)
    print(f"  realtime factor: {rtf:.1f}x audio-sec/sec on {card}"
          + ("" if device.type == "cuda" else " (CPU: no device metric; MFU not measured)"))

    if args.trace_dir:
        fn, fargs = stages["roundtrip"]
        with torch.inference_mode(), torch_trace(args.trace_dir):
            fn(*fargs)
        print(f"torch.profiler trace written to {args.trace_dir}")
    print(json.dumps({"device": card, "batch": B, "seconds": args.seconds, "stages": rows,
                      "rtf": rtf}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
