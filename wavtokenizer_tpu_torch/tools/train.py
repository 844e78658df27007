"""Training CLI: the reference's Lightning YAML schema, this package's trainer.

Port of ``train.py`` (ref train.py:8-12 and LightningCLI):

    python -m wavtokenizer_tpu_torch.tools.train fit --config configs/<config>.yaml \\
        [--out-dir runs/x] [--max-batches N] [--seed S] [--resume runs/x/last.pt] \\
        [--device cuda] [--model-parallel M]

Over N cards of one machine: ``torchrun --nproc_per_node N -m
wavtokenizer_tpu_torch.tools.train fit --config ...`` (or ``python -m
torch.distributed.run --nproc_per_node N -m ...``); plain ``python`` is one
rank without a process group.  The config's batch_size stays the global
batch, split over the data axis; ``--model-parallel`` (or
``WT_MODEL_PARALLEL``) ranks split each ConvNeXt MLP (``train/trainer.py``).

Writes ``metrics.jsonl``, ``last.pt`` (the whole training state, for
``--resume`` and ``WavTokenizer.from_train_checkpoint``) and, every
validation, the top-k ``wavtokenizer_checkpoint_step=..._val_loss=....pt``
into the output directory (default: the config's logger ``save_dir``).
The config's ``resume: true`` with ``resume_model`` (and optionally
``resume_config``) grafts a Lightning checkpoint's weights into a fresh
state (``train/trainer.py::surgical_train_state``).  Needs PyYAML.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)
    fit = sub.add_parser("fit", help="train a model from a YAML config")
    fit.add_argument("--config", required=True)
    fit.add_argument("--out-dir", default=None,
                     help="output directory (default: the config's logger save_dir)")
    fit.add_argument("--max-batches", type=int, default=None,
                     help="stop after N batches (smoke runs)")
    fit.add_argument("--seed", type=int, default=None)
    fit.add_argument("--resume", default=None, metavar="CKPT",
                     help="continue the full training state (optimizers and step) of "
                          "a checkpoint this trainer wrote")
    fit.add_argument("--device", default="cuda",
                     help="cuda (each rank of a torchrun launch takes cuda:LOCAL_RANK) or cpu "
                          "(gloo between ranks)")
    fit.add_argument("--model-parallel", type=int, default=1,
                     help="ranks that split each ConvNeXt MLP (WT_MODEL_PARALLEL overrides)")
    args = parser.parse_args(argv)

    import yaml

    from ..api.config import spec_from_config_dict
    from ..checkpoint.convert import load_torch_state_dict
    from ..parallel.mesh import local_device
    from ..train.trainer import (Trainer, resume_from_yaml, surgical_train_state,
                                 train_config_from_yaml)

    with open(args.config) as f:
        config = yaml.safe_load(f)
    spec, tcfg, train_data, val_data = train_config_from_yaml(config)
    if train_data is None:
        print("config has no data.init_args.train_params", file=sys.stderr)
        return 2
    out_dir = args.out_dir or (config.get("trainer", {}).get("logger", {})
                               .get("init_args", {}).get("save_dir", "runs/default"))
    seed = args.seed if args.seed is not None else int(config.get("seed_everything", 3407))
    device = local_device(args.device)
    trainer = Trainer(spec, tcfg, train_data, val_data, out_dir=out_dir, seed=seed,
                      device=device, model_parallel=args.model_parallel)

    # The config's surgical resume (ref experiment.py:398-445): module
    # weights from a Lightning checkpoint, fresh optimizers.
    state = None
    resume_config, resume_model = resume_from_yaml(config)
    if resume_model and not args.resume:
        surg_spec = spec
        if resume_config:
            with open(resume_config) as f:
                surg_spec = spec_from_config_dict(yaml.safe_load(f))
        sd = load_torch_state_dict(resume_model, prefixes=("",))
        state = surgical_train_state(surg_spec, tcfg, sd, seed=seed, device=device)
    try:
        trainer.fit(max_batches=args.max_batches, state=state, resume_path=args.resume)
    finally:
        trainer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
