"""Feature-enhancement training (the fork's research trainers).

Port of ``tools_tpu/enhance_train.py``.  ``--mode``:

    waveform  adapter + SEANet decoder train on the voice-focused waveform
              loss, features * 1.5 -> tanh before the decode (try3.py:1038-1053)
    feature   adapter only, L2 between enhanced(noisy) and encoder(clean)
              features (tsne.py:152-169)
    hybrid    0.7 voice-focused + 0.3 cosine feature loss (train_with_tsne.py:52-90)
    byol      try.py:36-134: the BYOL SimpleTransformer between the frozen
              encoder and the adapter; transformer, adapter and decoder train
              on the voice-focused loss.  ``--byol-ckpt`` (a
              ``tools.byol_train`` file) loads transformer weights with the
              reference's strict=False rule (shape-matching leaves only).

Checkpoints (``train/trainer.py::save_tree`` files) go to ``--out-dir`` as
``best_model.pt`` (lowest loss so far), ``step_N.pt`` and ``last.pt``; loss
rows to ``metrics.jsonl``.  ``--resume`` restarts from one; as in the JAX
tool, the checkpoint holds no optimizer state, so Adam starts afresh.

    python -m wavtokenizer_tpu_torch.tools.enhance_train --pairs-file pairs.txt \\
        [--config c.yaml --checkpoint model.ckpt] --mode waveform --steps 1000 \\
        --out-dir runs/enhance [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch


def load_base_model(config: str | None, checkpoint: str | None, seed: int = 0):
    """(spec, JAX-layout numpy params) of a Lightning checkpoint and its
    YAML, or of ``init_wavtokenizer(seed, random_codebook=True)`` at the
    default spec when neither is given."""
    from ..models.init import init_wavtokenizer
    from ..models.wavtokenizer import WavTokenizerSpec

    if config and checkpoint:
        from ..api.config import spec_from_config
        from ..checkpoint.convert import convert_wavtokenizer_state_dict, load_torch_state_dict
        spec = spec_from_config(config)
        return spec, convert_wavtokenizer_state_dict(load_torch_state_dict(checkpoint), spec)
    print("note: no --config/--checkpoint given, using random base model")
    spec = WavTokenizerSpec()
    return spec, init_wavtokenizer(spec, seed=seed, random_codebook=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pairs-file", required=True,
                    help="noisy|clean lines (prepare_data_lists.py output)")
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="base WavTokenizer torch checkpoint (frozen encoder)")
    ap.add_argument("--mode", choices=["waveform", "feature", "hybrid", "byol"],
                    default="waveform")
    ap.add_argument("--byol-ckpt", default=None,
                    help="tools.byol_train checkpoint (byol mode; strict=False-style load)")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--num-samples", type=int, default=72000)
    ap.add_argument("--learning-rate", type=float, default=1e-4)
    ap.add_argument("--out-dir", default="runs/enhance")
    ap.add_argument("--resume", default=None, help="checkpoint to resume from")
    ap.add_argument("--save-every", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..checkpoint.convert import adapter_from_jax, inpath_transformer_from_jax
    from ..research.adapter import (base_params_from_jax, init_adapter,
                                    init_inpath_transformer, load_byol_transformer)
    from ..research.enhance import (EnhanceConfig, PairedAudioDataset, enhance_step,
                                    make_enhance_optimizer)
    from ..train.trainer import load_tree, save_tree

    device = torch.device(args.device)
    spec, params_np = load_base_model(args.config, args.checkpoint, args.seed)
    base_params = base_params_from_jax(params_np, spec.seanet, device)
    ecfg = EnhanceConfig(mode=args.mode, learning_rate=args.learning_rate)
    adapter_params, adapter_state = adapter_from_jax(*init_adapter(seed=args.seed), device)
    decoder_params = base_params["decoder"]
    transformer_params = None
    if args.mode == "byol":
        transformer_params = inpath_transformer_from_jax(init_inpath_transformer(seed=args.seed),
                                                         device)
        if args.byol_ckpt:
            ck = load_tree(args.byol_ckpt, device)
            tree = ck.get("online", ck).get("encoder", ck) if isinstance(ck, dict) else ck
            transformer_params, n = load_byol_transformer(transformer_params, tree)
            print(f"byol ckpt: {n} shape-matching leaves loaded "
                  "(strict=False semantics, try.py:101-104)")
    start_step = 0

    os.makedirs(args.out_dir, exist_ok=True)
    if args.resume:
        ck = load_tree(args.resume, device)
        adapter_params, adapter_state = ck["adapter"], ck["adapter_state"]
        decoder_params = ck["decoder"]
        transformer_params = ck.get("transformer", transformer_params)
        start_step = int(ck["step"])
        print(f"resumed from {args.resume} at step {start_step}")
    opt = make_enhance_optimizer(adapter_params, decoder_params, ecfg, transformer_params)

    ds = PairedAudioDataset(args.pairs_file, sample_rate=spec.sample_rate,
                            num_samples=args.num_samples, seed=args.seed)
    print(f"{len(ds)} pairs, mode={args.mode}")
    it = ds.batches(args.batch_size, shuffle=True, seed=args.seed)

    def checkpoint(step: int) -> dict:
        ck = {"adapter": adapter_params, "adapter_state": adapter_state,
              "decoder": decoder_params, "step": step}
        if transformer_params is not None:
            ck["transformer"] = transformer_params
        return ck

    best = float("inf")
    t0 = time.time()
    with open(os.path.join(args.out_dir, "metrics.jsonl"), "a") as logf:
        for step in range(start_step, args.steps):
            noisy, clean = (torch.from_numpy(a).to(device) for a in next(it))
            adapter_state, loss, _ = enhance_step(
                opt, adapter_params, adapter_state, decoder_params, base_params, noisy,
                clean, spec, ecfg, transformer_params)
            loss = float(loss)
            if step % 10 == 0:
                rec = {"step": step, "loss": loss, "sec": round(time.time() - t0, 1)}
                print(rec)
                logf.write(json.dumps(rec) + "\n")
                logf.flush()
            if loss < best:
                best = loss
                save_tree(os.path.join(args.out_dir, "best_model.pt"), checkpoint(step + 1))
            if (step + 1) % args.save_every == 0:
                save_tree(os.path.join(args.out_dir, f"step_{step + 1}.pt"), checkpoint(step + 1))
    save_tree(os.path.join(args.out_dir, "last.pt"), checkpoint(max(args.steps, start_step)))
    print(f"done; best loss {best:.5f}; checkpoints in {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
