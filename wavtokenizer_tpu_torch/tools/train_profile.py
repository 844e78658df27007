"""Per-phase attribution of the GAN training step on one device.

Port of ``tools_tpu/train_profile.py``: at the reference batch (40 x 3 s)
it times slices of the step (ref decoder/experiment.py:121-218):

  full_train_step  ``train_step`` (discriminator update, then generator update)
  disc_phase       generator forward without gradients, the discriminator
                   losses' backward, AdamW
  gen_phase        the generator's losses (all terms), backward, AdamW
  gen_fwd          the generator forward alone (encoder, VQ, backbone, head)
  disc_fwd_all     the three discriminator families' losses, forward only
  mpd_step         the MPD hinge loss and its gradient alone
  mrd_step         the MRD hinge loss and its gradient alone
  dac_step         the DAC least-squares loss and its gradient alone
  melcommit_step   the generator's mel and commitment losses and their
                   gradient (the pretraining graph, no discriminator)

It runs at PyTorch's default precision, as ``tools/train.py`` trains (cuDNN
convolutions in TF32; the line it prints first says which).  Each estimate
is a host clock around ``--iters`` calls that end in
``torch.cuda.synchronize()``; the stages are timed round-robin, one estimate
each per pass, and the least of ``--passes`` is reported, so a stall must
hit the same stage in every pass to survive.  The slices share the state and
do not add up to the full step exactly.  Before the passes it splits the
first step (the codebook un-inited) into k-means (timed alone on the same
batch's encoder output) and the rest, beside a steady step.

``--remat-ab B`` instead times the full step with remat on and off at batch
B, each from a fresh state, with each one's peak memory.  ``--config`` takes
the spec and training options of a reference YAML (default: small-320 and
``TrainConfig()``).  The last line is the table as one JSON object.

    python -m wavtokenizer_tpu_torch.tools.train_profile [--batch 40] [--passes 6] \\
        [--config c.yaml] [--device cuda]
    python -m wavtokenizer_tpu_torch.tools.train_profile --remat-ab 16
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch


def spec_and_config(config_path: str | None):
    """(spec, TrainConfig) of a reference YAML, or small-320's defaults."""
    from ..models.wavtokenizer import WavTokenizerSpec
    from ..train.step import TrainConfig

    if config_path is None:
        return WavTokenizerSpec(), TrainConfig()
    import yaml

    from ..train.trainer import train_config_from_yaml

    with open(config_path) as f:
        spec, tcfg, _, _ = train_config_from_yaml(yaml.safe_load(f))
    return spec, tcfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def estimate(fn, iters: int, device: torch.device) -> float:
    """Seconds per call of fn() over ``iters`` calls."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


def first_step_split(spec, tcfg, audio: torch.Tensor, device: torch.device) -> dict:
    """The first step of a fresh state, its k-means alone (the same batch's
    encoder output, the same iterations), and the step after it, in ms."""
    from ..models.seanet import seanet_encode
    from ..train.step import create_train_state, train_step
    from ..train.vq_train import kmeans
    from ..train.wnorm import fold_tree

    state = create_train_state(spec, tcfg, seed=0, device=device)
    with torch.no_grad():
        emb = seanet_encode(fold_tree(state["gen"]["encoder"]), spec.seanet, audio[:, :, None],
                            front=False).reshape(-1, spec.vq.dimension)
        kmeans_s = estimate(lambda: kmeans(emb, spec.vq.bins, spec.vq.kmeans_iters,
                                           torch.Generator().manual_seed(0)), 1, device)
    del emb
    first_s = estimate(lambda: train_step(state, audio, spec, tcfg,
                                          torch.Generator().manual_seed(0)), 1, device)
    steady_s = estimate(lambda: train_step(state, audio, spec, tcfg,
                                           torch.Generator().manual_seed(1)), 1, device)
    return {"first_ms": first_s * 1e3, "kmeans_ms": kmeans_s * 1e3,
            "rest_ms": (first_s - kmeans_s) * 1e3, "steady_ms": steady_s * 1e3,
            "kmeans_iters": spec.vq.kmeans_iters}


def stages_of(state: dict, spec, tcfg, audio: torch.Tensor) -> list:
    """The (name, fn) slices of the step over ``state`` (updated in place by
    the slices that update)."""
    from ..train import step as S
    from ..train.losses import dac_disc_loss, vocos_disc_loss

    bw = 0
    remat = S.disc_remat_mode(tcfg.remat, tcfg.remat_disc)
    dt = S.compute_dtype(tcfg.disc_compute_dtype)
    gen_dt = S.compute_dtype(tcfg.gen_compute_dtype)
    with torch.no_grad():
        audio_hat = S.generator_forward(state["gen"], state["vq"], spec, audio, bw, 1,
                                        torch.Generator().manual_seed(1),
                                        compute_dtype=gen_dt)[0]
    disc_leaves = S.tree_leaves(state["disc"])
    gen_leaves = S.tree_leaves(state["gen"])

    def grads(loss, leaves):
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    def full():
        S.train_step(state, audio, spec, tcfg, torch.Generator().manual_seed(2))

    def disc_phase():
        S.discriminator_phase(state, audio, spec, tcfg, bw, 1, torch.Generator().manual_seed(3))

    def gen_phase():
        S.generator_phase(state, state["vq"], audio, spec, tcfg, bw, 1,
                          torch.Generator().manual_seed(4), mel_coeff=tcfg.mel_loss_coeff)

    def gen_fwd():
        with torch.no_grad():
            S.generator_forward(state["gen"], state["vq"], spec, audio, bw, 1,
                                torch.Generator().manual_seed(5), compute_dtype=gen_dt)

    def disc_fwd_all():
        with torch.no_grad():
            S._disc_loss_fn(state["disc"], audio_hat, audio, bw, tcfg.mrd_loss_coeff, remat, dt)

    def family(name):
        d = state["disc"]
        if name == "dac":
            return lambda: grads(dac_disc_loss(d, audio_hat, audio, remat is True, dt),
                                 disc_leaves)
        return lambda: grads(vocos_disc_loss(d[name], name, audio, audio_hat, bw, bool(remat),
                                             dt), disc_leaves)

    def melcommit():
        loss, _, _ = S._gen_loss_fn(state["gen"], state["disc"], state["vq"], spec, tcfg, audio,
                                    bw, 1, tcfg.mel_loss_coeff, False,
                                    torch.Generator().manual_seed(6), None)
        grads(loss, gen_leaves)

    return [("full_train_step", full), ("disc_phase", disc_phase), ("gen_phase", gen_phase),
            ("gen_fwd", gen_fwd), ("disc_fwd_all", disc_fwd_all),
            ("mpd_step", family("mpd")), ("mrd_step", family("mrd")),
            ("dac_step", family("dac")), ("melcommit_step", melcommit)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=40)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--iters", type=int, default=4, help="calls per estimate")
    ap.add_argument("--passes", type=int, default=6,
                    help="round-robin passes; the least per stage is reported")
    ap.add_argument("--remat-ab", type=int, default=0, metavar="B",
                    help="time ONLY the full step with remat on and off at batch B")
    ap.add_argument("--config", default=None,
                    help="reference YAML (default: small-320, TrainConfig())")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..train.step import create_train_state, train_step

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("no CUDA device (use --device cpu)")
        return 1
    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    spec, tcfg = spec_and_config(args.config)
    B = args.remat_ab or args.batch
    T = int(spec.sample_rate * args.seconds)
    audio = torch.as_tensor((np.random.default_rng(0).normal(size=(B, T)) * 0.1)
                            .astype(np.float32)).to(device)
    print(f"# device {card}, batch {B} x {T} samples, cuDNN TF32 "
          f"{'on' if torch.backends.cudnn.allow_tf32 else 'off'} (PyTorch's default: on)",
          flush=True)

    if args.remat_ab:
        rows = []
        for remat in (True, False):
            tc = dataclasses.replace(tcfg, remat=remat)
            state = create_train_state(spec, tc, seed=0, device=device)
            step = lambda: train_step(state, audio, spec, tc, torch.Generator().manual_seed(0))
            step()                                   # k-means and first calls
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            t = min(estimate(step, args.iters, device) for _ in range(args.passes))
            rows.append({"stage": f"full_b{B}_remat_{str(remat).lower()}", "ms": t * 1e3,
                         "train_rtf": B * args.seconds / t,
                         "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9 if cuda
                         else None})
            print(json.dumps(rows[-1]), flush=True)
            del state, step
            if cuda:
                torch.cuda.empty_cache()
        print(json.dumps({"device": card, "tf32": torch.backends.cudnn.allow_tf32,
                          "table": rows}), flush=True)
        return 0

    split = first_step_split(spec, tcfg, audio, device)
    print(f"# first step {split['first_ms']:.1f} ms = k-means ({split['kmeans_iters']} "
          f"iterations, timed alone) {split['kmeans_ms']:.1f} ms + the rest "
          f"{split['rest_ms']:.1f} ms; the step after it {split['steady_ms']:.1f} ms",
          flush=True)
    state = create_train_state(spec, tcfg, seed=0, device=device)
    train_step(state, audio, spec, tcfg, torch.Generator().manual_seed(0))   # inits the codebook
    stages = stages_of(state, spec, tcfg, audio)
    for name, fn in stages:                          # first calls outside the passes
        fn()
    best = {name: float("inf") for name, _ in stages}
    for p in range(args.passes):
        for name, fn in stages:
            best[name] = min(best[name], estimate(fn, args.iters, device))
        print(f"# pass {p + 1}/{args.passes}: "
              + " ".join(f"{n}={best[n] * 1e3:.0f}ms" for n, _ in stages), flush=True)
    rows = [{"stage": name, "ms": best[name] * 1e3,
             "train_rtf": B * args.seconds / best[name]} for name, _ in stages]
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({"device": card, "tf32": torch.backends.cudnn.allow_tf32, "batch": B,
                      "passes": args.passes, "first_step": split, "table": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
