"""Environment check: the card, the toolchain, the kernels, and a checkpoint.

Port of ``tools_tpu/check_env.py`` (ref test_env.py:6-36: the device is
visible and a checkpoint loads).  Prints the card, its power limit, the
torch and CUDA versions and a small computation on the device; builds the
three CUDA kernels and launches each once against its plain version (the
VQ kernel's ids equal, the ConvNeXt and front kernels within 1e-2 and 1e-5
of their output's largest value); says whether the native data loader
builds; and with ``--config`` and ``--checkpoint`` loads the checkpoint.
Prints OK or FAILED last; exits 1 on a failure, and without a card unless
``--device cpu`` (which checks the rest on the CPU and builds no kernel).

    python -m wavtokenizer_tpu_torch.tools.check_env [--device cuda] \\
        [--config c.yaml --checkpoint m.ckpt]
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or why not."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    if res.returncode != 0:
        return f"nvidia-smi failed ({res.stderr.strip()})"
    return res.stdout.strip().splitlines()[0]


def kernel_checks(device: torch.device) -> dict:
    """Each kernel launched once beside its plain version, at small-320's
    widths: {name: (ok, what was compared)}."""
    from ..api.pretrained import WavTokenizer
    from ..models.init import init_wavtokenizer
    from ..models.seanet import encoder_layer_specs
    from ..models.wavtokenizer import WavTokenizerSpec, full_fp32
    from ..ops import kernels as K

    spec = WavTokenizerSpec()
    model = WavTokenizer.from_jax_params(init_wavtokenizer(spec, seed=0, random_codebook=True),
                                         spec, device=device)
    p = model.params
    gen = torch.Generator().manual_seed(0)
    out = {}
    with torch.inference_mode(), full_fp32():
        q = p["quantizer"]
        x = (torch.randn(512, spec.vq.dimension, generator=gen) * 0.1).to(device)
        got = K.vq_nearest(x, q["embed"][0], q["esq"][0], q["pack"][0])
        want = K.vq_nearest_reference(x, q["embed"][0], q["esq"][0])
        flips = int((got != want).sum())
        out["vq_nearest"] = (flips <= 2, f"{flips} of {x.shape[0]} ids differ (limit 2)")

        b = p["backbone"]["convnext"][0]
        h = torch.randn(2, 64, spec.backbone.dim, generator=gen).to(device)
        args = (h, b["dw"], b["dwb"], b["adanorm"]["scale"][0], b["adanorm"]["shift"][0],
                b["w1"], b["b1"], b["w2"], b["b2"], b["gamma"])
        got = K.convnext_block(*args, b["w1t"], b["w2t"])
        want = K.convnext_block_reference(*args)
        rel = float((got - want).abs().max() / (want - h).abs().max())
        out["convnext_block"] = (rel < 1e-2, f"max abs err over max |out - x| {rel:.3g} "
                                             "(limit 1e-2)")

        a = (torch.randn(2, 9600, 1, generator=gen) * 0.1).to(device)
        specs = encoder_layer_specs(spec.seanet)
        got = K.encoder_front(a, p["encoder"], specs)
        want = K.encoder_front_reference(a, p["encoder"], specs)
        rel = float((got - want).abs().max() / want.abs().max())
        out["encoder_front"] = (rel < 1e-5, f"max abs err over max |out| {rel:.3g} "
                                            "(limit 1e-5)")
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import native

    device = torch.device(args.device)
    cuda = torch.cuda.is_available()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"devices: {torch.cuda.device_count() if cuda else 0} CUDA")
    if device.type == "cuda":
        if not cuda:
            print("no CUDA device (use --device cpu to check the rest on the CPU)")
            print("FAILED")
            return 1
        print(f"card: {card_line()}; {torch.cuda.get_device_name(device)}, "
              f"{torch.cuda.get_device_properties(device).total_memory / 1e9:.1f} GB")
    ok = True

    t0 = time.perf_counter()
    x = torch.arange(1024.0, device=device)
    val = float((x * x).sum())
    good = abs(val - 357389824.0) / 357389824.0 < 1e-5
    ok &= good
    print(f"sum of squares 0..1023 on {device}: {val:.0f} (expect 357389824) in "
          f"{time.perf_counter() - t0:.2f} s: {'ok' if good else 'WRONG'}")

    if device.type == "cuda":
        from ..ops import kernels as K

        t0 = time.perf_counter()
        try:
            K.load_library()
        except RuntimeError as e:
            print(f"kernels: build FAILED: {e}")
            ok = False
        else:
            print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
            for name, (good, what) in kernel_checks(device).items():
                ok &= good
                print(f"kernel {name} vs plain: {what}: {'ok' if good else 'WRONG'}")
    else:
        print("kernels: not built (no card; the CPU runs their plain versions)")

    print(f"native data loader: "
          + ("builds and loads" if native.available()
             else "unavailable (the trainer runs the Python loader)"))

    if args.config and args.checkpoint:
        from ..api.pretrained import WavTokenizer
        from ..train.step import tree_leaves
        from .infer import is_train_checkpoint

        load = (WavTokenizer.from_train_checkpoint if is_train_checkpoint(args.checkpoint)
                else WavTokenizer.from_pretrained0802)
        model = load(args.config, args.checkpoint, device=device)
        n = sum(t.numel() for t in tree_leaves(model.params))
        print(f"checkpoint loads: {args.checkpoint} ({n / 1e6:.1f} M values)")

    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
