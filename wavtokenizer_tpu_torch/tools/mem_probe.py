"""Peak device memory of the GAN training step at a batch size.

Port of ``tools_tpu/mem_probe.py``, with its flags (its ``--cpu`` is
``--device`` here).  PyTorch has no ahead-of-time memory analysis, so this
runs the step: a fresh small-320 state (discriminators at full width), one
batch of seeded noise, two ``train_step`` calls (the first runs k-means on
the un-inited codebook) at PyTorch's default precision, as
``tools/train.py`` trains, and ``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``.  A batch that does not fit prints the
out-of-memory error and exits 2.  The last line is one JSON object.  As in
the JAX tool, remat is on unless ``--no-remat``.

``--max-batch`` searches for the largest batch that fits: each probe is
this tool at one batch in a subprocess of its own (a failed allocation can
leave the caching allocator fragmented), doubling from ``--batch`` until one
fails, then bisecting.

    python -m wavtokenizer_tpu_torch.tools.mem_probe [--batch 40] [--seconds 3.0] \\
        [--no-remat] [--no-remat-encoder] [--no-remat-disc] [--remat-disc on|off|store_dac] \\
        [--disc-dtype float32|bfloat16] [--device cuda] [--max-batch]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

GB = 1e9


def train_config(args):
    """The step's (spec, TrainConfig) from the flags."""
    from ..models.wavtokenizer import WavTokenizerSpec
    from ..train.step import TrainConfig

    if args.remat_disc is not None:
        remat_disc = {"on": True, "off": False, "store_dac": "store_dac"}[args.remat_disc]
    else:
        remat_disc = not args.no_remat_disc
    return WavTokenizerSpec(), TrainConfig(remat=not args.no_remat,
                                           remat_encoder=not args.no_remat_encoder,
                                           remat_disc=remat_disc,
                                           disc_compute_dtype=args.disc_dtype)


def probe(args) -> dict:
    """One batch: the peak of two steps, or the out-of-memory error."""
    from ..train.step import create_train_state, train_step

    spec, tcfg = train_config(args)
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    B, T = args.batch, int(args.seconds * spec.sample_rate)
    out = {"batch": B, "T": T, "remat": tcfg.remat, "remat_encoder": tcfg.remat_encoder,
           "remat_disc": tcfg.remat_disc, "disc_dtype": tcfg.disc_compute_dtype,
           "tf32": torch.backends.cudnn.allow_tf32,
           "device": torch.cuda.get_device_name(device) if cuda else "cpu"}
    state = create_train_state(spec, tcfg, seed=0, device=device)
    audio = torch.as_tensor((np.random.default_rng(0).normal(size=(B, T)) * 0.1)
                            .astype(np.float32)).to(device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    try:
        times = []
        for step in range(2):
            t0 = time.perf_counter()
            train_step(state, audio, spec, tcfg, torch.Generator().manual_seed(step))
            if cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    except torch.cuda.OutOfMemoryError as e:
        out.update(fits=False, error=str(e).splitlines()[0])
        return out
    out.update(fits=True, step_ms=times,
               peak_bytes=torch.cuda.max_memory_allocated(device) if cuda else 0,
               total_bytes=torch.cuda.get_device_properties(device).total_memory if cuda else 0)
    return out


def _probe_in_subprocess(argv: list, batch: int) -> dict:
    cmd = [sys.executable, "-m", "wavtokenizer_tpu_torch.tools.mem_probe", *argv,
           "--batch", str(batch)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    lines = res.stdout.strip().splitlines()
    if res.returncode not in (0, 2) or not lines:
        raise RuntimeError(f"probe at batch {batch} failed ({res.returncode}):\n"
                           f"{res.stderr[-3000:]}")
    return json.loads(lines[-1])


def max_batch(args, argv: list) -> dict:
    """The largest batch that fits: doubling from ``--batch``, then
    bisection between the last batch that fit and the first that did not."""
    argv = [a for a in argv if a != "--max-batch"]
    probes = {}

    def fits(b):
        probes[b] = _probe_in_subprocess(argv, b)
        print(json.dumps(probes[b]), flush=True)
        return probes[b]["fits"]

    lo, hi = 0, args.batch
    while fits(hi):
        lo, hi = hi, hi * 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return {"max_batch": lo, "first_oom": hi,
            "peak_bytes": probes[lo]["peak_bytes"] if lo else None,
            "probes": len(probes)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=40)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-remat-encoder", action="store_true",
                    help="selective remat: store the encoder's activations")
    ap.add_argument("--no-remat-disc", action="store_true",
                    help="selective remat: store the discriminators' activations")
    ap.add_argument("--remat-disc", default=None, choices=["on", "off", "store_dac"],
                    help="discriminator remat mode (overrides --no-remat-disc; store_dac "
                         "stores only the DAC family's activations)")
    ap.add_argument("--disc-dtype", default="float32",
                    help="discriminator compute dtype (e.g. bfloat16)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-batch", action="store_true",
                    help="search the largest batch that fits (one subprocess per probe)")
    args = ap.parse_args(argv)

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device (use --device cpu)")
        return 1
    if args.max_batch:
        if not args.device.startswith("cuda"):
            print("--max-batch needs a card")
            return 1
        print(json.dumps(max_batch(args, argv)), flush=True)
        return 0
    out = probe(args)
    if not out["fits"]:
        print(f"batch={out['batch']} does not fit: {out['error']}")
    elif out["device"] == "cpu":
        print(f"batch={out['batch']} T={out['T']} remat={out['remat']} on the CPU: peak "
              "device memory not measured (no card), reported as 0")
    else:
        print(f"batch={out['batch']} T={out['T']} remat={out['remat']} "
              f"remat_enc={out['remat_encoder']} remat_disc={out['remat_disc']} "
              f"disc_dtype={out['disc_dtype']} on {out['device']}: peak "
              f"{out['peak_bytes'] / GB:.2f} GB of {out['total_bytes'] / GB:.1f} GB "
              "(max_memory_allocated over two steps)")
    print(json.dumps(out), flush=True)
    return 0 if out["fits"] else 2


if __name__ == "__main__":
    raise SystemExit(main())
