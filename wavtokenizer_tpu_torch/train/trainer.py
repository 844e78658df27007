"""Training orchestration: what ``tools/train.py fit --config`` runs.

Port of ``wavtokenizer_tpu/train/trainer.py`` (ref train.py and the
Lightning wiring of decoder/experiment.py): per batch the discriminator
then the generator update, a random bandwidth_id, validation with
val_loss = mel + (5 - utmos) + (5 - pesq) + 1000 * commit
(experiment.py:227-270), top-k checkpoints on val_loss plus the last one
(configs/*.yaml ModelCheckpoint), JSONL metrics (the TensorBoard scalars'
stand-in) and TensorBoard media when tensorboard is installed.

On one device (``cuda`` unless the caller asks for the CPU), or over the
ranks of a ``torchrun`` launch (``WORLD_SIZE`` > 1; JAX's trainer meshes
every device it sees, ``trainer.py:182-221``): data parallelism over NCCL
between cards (gloo on the CPU), with the ConvNeXt MLPs split over
``model_parallel`` ranks (the argument, or ``WT_MODEL_PARALLEL``).  The
global batch stays the config's ``batch_size``: every rank reads the global
batch the one-process loader yields at that step and trains on its own rows
of it (``parallel/mesh.py::shard_batch``), so a run does not depend on the
world size; the state is broadcast from rank 0 at the start, sharded for
tensor parallelism, and gathered whole before every save, so a checkpoint
does not depend on the world size or on ``model_parallel``.  Rank 0 alone
writes ``metrics.jsonl``, TensorBoard and the checkpoints, and validates on
the whole state as one process does while the other ranks wait at a
barrier.  Validation scores the
reconstructions with the objective evaluators of ``metrics/`` on 16 kHz
audio, as the JAX package does: periodicity, pitch and voicing (NAC, or
CREPE with ``WT_CREPE_CKPT``), UTMOS (with ``WT_UTMOS_CKPT``, else 0), PESQ
(the ``pesq`` package or the native P.862) and STOI.  Checkpoints are
``torch.save`` files of the whole state (params, VQ state, decoder, both
optimizers and schedules, step).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..api.config import spec_from_config_dict
from ..api.pretrained import WavTokenizer
from ..checkpoint.convert import surgical_resume_params
from ..models.wavtokenizer import WavTokenizerSpec, repeatable_steps
from ..parallel.mesh import (barrier, batch_shard, gather_train_state, init_distributed,
                             make_mesh, replicate_train_state, shard_train_state,
                             world_size_from_env)
from .data import DataConfig, WavDataset, data_loader
from .helpers import TBLogger
from .losses import mel_loss
from .step import (TrainConfig, compute_dtype, create_train_state, generator_forward,
                   generator_from_jax, mel_coeff_decay, new_train_state,
                   state_to_inference_params, to_tensors, train_step, tree_leaves, tree_map)


def train_config_from_yaml(config: dict) -> tuple:
    """A reference-style Lightning YAML (parsed) -> (spec, tcfg, train data,
    val data).

    The evaluate_* keys switch validation's evaluators, the reference's
    misspelt ``evaluate_periodicty`` first.  ``disc_compute_dtype`` (a key of
    the JAX package, absent from the reference's YAMLs) runs the
    discriminators in that type (``TrainConfig``); a name that is no
    floating type is refused with a ``ValueError``.  ``num_workers`` is the
    native loader's thread count (at least 2)."""
    spec = spec_from_config_dict(config)
    init = config.get("model", {}).get("init_args", {})
    disc_dtype = str(init.get("disc_compute_dtype", "float32"))
    try:
        compute_dtype(disc_dtype)
    except ValueError as e:
        raise ValueError(f"disc_compute_dtype: {e}") from None
    trainer = config.get("trainer", {})
    tcfg = TrainConfig(
        sample_rate=int(init.get("sample_rate", 24000)),
        initial_learning_rate=float(init.get("initial_learning_rate", 2e-4)),
        num_warmup_steps=int(init.get("num_warmup_steps", 0)),
        mel_loss_coeff=float(init.get("mel_loss_coeff", 45)),
        mrd_loss_coeff=float(init.get("mrd_loss_coeff", 1.0)),
        pretrain_mel_steps=int(init.get("pretrain_mel_steps", 0)),
        decay_mel_coeff=bool(init.get("decay_mel_coeff", False)),
        max_steps=int(trainer.get("max_steps", 2_000_000)),
        num_bandwidths=len(init.get("feature_extractor", {}).get("init_args", {})
                           .get("bandwidths", [1, 1, 1, 1])),
        evaluate_utmos=bool(init.get("evaluate_utmos", True)),
        evaluate_pesq=bool(init.get("evaluate_pesq", True)),
        # the reference YAML key keeps the upstream typo "periodicty"
        evaluate_periodicity=bool(init.get("evaluate_periodicty",
                                           init.get("evaluate_periodicity", True))),
        disc_compute_dtype=disc_dtype)

    def data_cfg(block):
        if not block:
            return None
        return DataConfig(filelist_path=block["filelist_path"],
                          sampling_rate=int(block.get("sampling_rate", 24000)),
                          num_samples=int(block.get("num_samples", 72000)),
                          batch_size=int(block.get("batch_size", 40)),
                          num_workers=int(block.get("num_workers", 0)))

    data = config.get("data", {}).get("init_args", {})
    return spec, tcfg, data_cfg(data.get("train_params")), data_cfg(data.get("val_params"))


def resume_from_yaml(config: dict) -> tuple:
    """The reference's surgical-resume keys (configs/...yaml
    resume/resume_config/resume_model, read by experiment.py:398-445):
    (resume_config, resume_model) when ``resume: true``, else (None, None)."""
    init = config.get("model", {}).get("init_args", {})
    if not init.get("resume"):
        return None, None
    return init.get("resume_config"), init.get("resume_model")


def surgical_train_state(spec: WavTokenizerSpec, tcfg: TrainConfig, sd: dict,
                         seed: int = 3407, keep_quantizer_layers: int = 8,
                         device="cuda") -> dict:
    """A fresh state with the weights of a Lightning checkpoint's state dict
    grafted in per submodule (ref experiment.py:398-445): encoder, decoder,
    the quantizer's layers below ``keep_quantizer_layers``, backbone, head,
    and the discriminators when the checkpoint has them (unit by unit, so a
    unit without its ``emb`` keeps the fresh one).  The optimizers restart,
    as the reference reloads module weights only.  The checkpoint's folded
    encoder weights w re-enter as v = w, g = |w|: the same forward."""
    device = torch.device(device)
    fresh = create_train_state(spec, tcfg, seed=seed, device=device)
    p = surgical_resume_params(sd, spec, keep_quantizer_layers)
    vq = {k: v.clone() for k, v in fresh["vq"].items()}
    kept = min(spec.vq.n_q, keep_quantizer_layers)
    for k, v in p["quantizer"].items():
        if k in vq:
            vq[k][:kept] = torch.as_tensor(np.asarray(v)[:kept], device=device)
    disc = fresh["disc"]
    for fam, units in p.get("discriminators", {}).items():
        if fam in disc:
            disc[fam] = [{**fresh_unit, **to_tensors(unit, device)}
                         for fresh_unit, unit in zip(disc[fam], units)]
    return new_train_state(generator_from_jax(p, spec, device), disc, vq,
                           to_tensors(p["decoder"], device), tcfg)


_TREES = ("gen", "disc", "vq", "decoder")
_OPTIM = ("opt_gen", "opt_disc", "sched_gen", "sched_disc")


def save_checkpoint(path: str, state: dict) -> None:
    """The whole state as one ``torch.save`` file, written atomically."""
    ckpt = {k: tree_map(lambda t: t.detach(), state[k]) for k in _TREES}
    ckpt.update({k: state[k].state_dict() for k in _OPTIM})
    ckpt["step"] = state["step"]
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, template: dict) -> dict:
    """Fill ``template`` (a state of the same spec and config, e.g. from
    ``create_train_state``) from a ``save_checkpoint`` file, on the
    template's device."""
    device = tree_leaves(template["gen"])[0].device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    with torch.no_grad():
        for k in ("gen", "disc"):
            for dst, src in zip(tree_leaves(template[k]), tree_leaves(ckpt[k]), strict=True):
                dst.copy_(src)
    template["vq"], template["decoder"] = ckpt["vq"], ckpt["decoder"]
    for k in _OPTIM:
        template[k].load_state_dict(ckpt[k])
    template["step"] = int(ckpt["step"])
    return template


def save_tree(path: str, tree) -> None:
    """Any tree of dicts, lists, tensors and numbers as one ``torch.save``
    file, written atomically (the enhancement and BYOL tools' checkpoints,
    where the JAX package saves any pytree)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree_map(lambda t: t.detach(), tree), tmp)
    os.replace(tmp, path)


def load_tree(path: str, device="cuda"):
    """A ``save_tree`` file, its tensors on ``device``."""
    return torch.load(path, map_location=torch.device(device), weights_only=True)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one training step, a pure function of (seed,
    step), so that a resumed run draws what the uninterrupted run drew."""
    return torch.Generator().manual_seed(
        int(np.random.default_rng((seed, step)).integers(0, 2 ** 62)))


class Trainer:
    """The training loop, on one device or over the ranks of a mesh."""

    def __init__(self, spec: WavTokenizerSpec, tcfg: TrainConfig, train_data: DataConfig,
                 val_data: DataConfig | None = None, out_dir: str = "runs/default",
                 seed: int = 3407, log_every: int = 100, val_every: int = 10_000,
                 save_top_k: int = 10, limit_val_batches: int = 100,
                 log_media_every: int = 1000, device="cuda", model_parallel: int = 1,
                 mesh=None):
        """``mesh`` (``parallel/mesh.py::make_mesh``) defaults to one made
        from the ``torchrun`` environment when ``WORLD_SIZE`` > 1 (the
        process group joined here if it is not yet), with ``model_parallel``
        or ``WT_MODEL_PARALLEL`` ranks on the model axis; else one device."""
        self.spec, self.tcfg = spec, tcfg
        self.train_data, self.val_data = train_data, val_data
        self.out_dir = out_dir
        self.seed = seed
        self.log_every = log_every
        self.val_every = val_every
        self.save_top_k = save_top_k
        self.limit_val_batches = limit_val_batches
        self.log_media_every = log_media_every
        self.model_parallel = int(os.environ.get("WT_MODEL_PARALLEL", model_parallel))
        self._owns_group = False
        if mesh is None and world_size_from_env() > 1:
            if not torch.distributed.is_initialized():
                init_distributed(device=device)
                self._owns_group = True
            mesh = make_mesh(self.model_parallel, device)
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        self.is_main = mesh is None or mesh.rank == 0
        self._metrics_f = None
        if self.is_main:
            os.makedirs(out_dir, exist_ok=True)
            self._metrics_f = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self._topk: list[tuple[float, str]] = []
        self.tb = TBLogger(os.path.join(out_dir, "tb") if self.is_main else None)

    def close(self) -> None:
        if self._metrics_f is not None:
            self._metrics_f.close()
        self.tb.close()
        if self._owns_group:
            torch.distributed.destroy_process_group()
            self._owns_group = False

    def log(self, record: dict) -> None:
        """One JSONL record (rank 0 only)."""
        if self._metrics_f is None:
            return
        self._metrics_f.write(json.dumps(record) + "\n")
        self._metrics_f.flush()

    def _audio(self, batch: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(batch, np.float32)).to(self.device)

    # ------------------------------------------------------------------ val

    def _host_val_metrics(self, audio: np.ndarray, audio_hat: np.ndarray) -> dict:
        """The objective metrics of one validation batch, on audio resampled
        to 16 kHz as the reference scores it (experiment.py:231-256):
        periodicity RMSE, pitch RMSE (cents) and voiced F1, UTMOS and PESQ,
        and STOI besides (logged, not in val_loss).

        UTMOS needs a local checkpoint (``WT_UTMOS_CKPT``); PESQ is the
        ``pesq`` package when installed, else the native P.862.  An evaluator
        that is off or unavailable scores 0, so its (5 - score) val_loss term
        is a constant, as in the reference with evaluate_* off.  CREPE and
        UTMOS run on this trainer's device."""
        from ..metrics.objective import pesq_wb, stoi, utmos_score
        from ..metrics.periodicity import calculate_periodicity_metrics
        from ..utils.audio import resample_np

        sr = self.spec.sample_rate
        ref16 = np.stack([resample_np(a.astype(np.float32), sr, 16000) for a in audio])
        deg16 = np.stack([resample_np(a.astype(np.float32), sr, 16000) for a in audio_hat])
        out = {"utmos_score": 0.0, "pesq_score": 0.0, "periodicity_loss": 0.0,
               "pitch_loss": 0.0, "f1_score": 0.0, "stoi": 0.0}

        if self.tcfg.evaluate_periodicity:
            use_crepe = bool(os.environ.get("WT_CREPE_CKPT"))
            per = [calculate_periodicity_metrics(r, d, use_crepe=use_crepe, device=self.device)
                   for r, d in zip(ref16, deg16)]
            for k, col in zip(("periodicity_loss", "pitch_loss", "f1_score"), zip(*per)):
                out[k] = float(np.nanmean(col))

        if self.tcfg.evaluate_utmos:
            scores = utmos_score(deg16, device=self.device)
            if scores is not None:
                out["utmos_score"] = float(np.mean(scores))

        if self.tcfg.evaluate_pesq:
            scores = [pesq_wb(r, d, 16000) for r, d in zip(ref16, deg16)]
            if all(s is not None for s in scores):
                out["pesq_score"] = float(np.mean(scores))

        out["stoi"] = float(np.nanmean([stoi(r, d, 16000) for r, d in zip(ref16, deg16)]))
        return out

    def validate(self, state: dict, val_iter, step: int) -> float:
        """val_loss = mel + (5 - utmos) + (5 - pesq) + 1000 * commit over up
        to ``limit_val_batches`` batches (ref experiment.py:257-258), with
        each batch's objective metrics (``_host_val_metrics``) logged as
        ``val_*``, and, when TensorBoard logs, the first batch's audio and mel
        images and the EnCodec-style resynthesis through the carried SEANet
        decoder (ref experiment.py:272-294, 464-474)."""
        spec = self.spec
        losses, mel_losses, batch_metrics = [], [], []
        g = step_generator(self.seed + 1, step)
        with torch.no_grad():
            for i in range(self.limit_val_batches):
                try:
                    audio = self._audio(next(val_iter))
                except StopIteration:
                    break
                audio_hat, commit, _ = generator_forward(state["gen"], state["vq"], spec,
                                                         audio, 0, n_q=1, generator=g)
                m = float(mel_loss(audio_hat, audio, spec.sample_rate))
                bm = self._host_val_metrics(audio.cpu().numpy(), audio_hat.cpu().numpy())
                batch_metrics.append(bm)
                mel_losses.append(m)
                losses.append(m + (5.0 - bm["utmos_score"]) + (5.0 - bm["pesq_score"])
                              + 1000.0 * float(commit))
                if i == 0 and self.tb.enabled:
                    sr = spec.sample_rate
                    self.tb.audio_and_spectrogram("val/reconstructed",
                                                  audio_hat[0].cpu().numpy(), sr, step)
                    self.tb.audio_and_spectrogram("val/original", audio[0].cpu().numpy(),
                                                  sr, step)
                    self.tb.audio("val/encodec", self._resynth(state, audio[:1])[0], sr, step)
        val_loss = float(np.mean(losses)) if losses else float("inf")
        rec = {"step": step, "val_loss": val_loss,
               "val_mel_loss": float(np.mean(mel_losses)) if mel_losses else float("inf")}
        for k in (batch_metrics[0] if batch_metrics else ()):
            rec[f"val_{k}"] = float(np.nanmean([bm[k] for bm in batch_metrics]))
        self.log(rec)
        self.tb.scalars({k: v for k, v in rec.items() if k != "step"}, step)
        self.tb.flush()
        return val_loss

    def _resynth(self, state: dict, audio: torch.Tensor) -> np.ndarray:
        """encode_infer (n_q = 1), then the carried SEANet decoder."""
        model = WavTokenizer.from_jax_params(state_to_inference_params(state, self.spec),
                                             self.spec, self.device)
        return model.seanet_only_decode(model.encode_infer(audio)[0]).cpu().numpy()

    def _save_topk(self, state: dict, step: int, val_loss: float) -> None:
        path = os.path.join(self.out_dir,
                            f"wavtokenizer_checkpoint_step={step}_val_loss={val_loss:.4f}.pt")
        save_checkpoint(path, state)
        self._topk.append((val_loss, path))
        self._topk.sort()
        while len(self._topk) > self.save_top_k:
            _, worst = self._topk.pop()
            os.remove(worst)

    # ---------------------------------------------------------------- train

    def resume_state(self, path: str) -> dict:
        """The full state of a ``save_checkpoint`` file (crash resume,
        Lightning's ``fit(ckpt_path=...)``): the loop restarts at its step."""
        template = create_train_state(self.spec, self.tcfg, seed=self.seed, device=self.device)
        state = load_checkpoint(path, template)
        self.log({"event": "resume", "path": path, "step": state["step"]})
        return state

    def _make_train_iter(self, skip_batches: int = 0):
        """The training batches: the native loader (``native/``) when every
        file is a ``.wav`` and the library builds, the Python loader
        otherwise; both decode, normalize, resample and crop alike (ref
        decoder/dataset.py:44-84), with their own draws.  ``skip_batches``
        starts the stream at the batch an interrupted run would have read
        next, without decoding the ones before it."""
        cfg = self.train_data
        with open(cfg.filelist_path) as f:
            files = [l for l in f.read().splitlines() if l.strip()]
        if all(p.endswith(".wav") for p in files):
            from ..native import NativeDataLoader
            try:
                # drop_last=False: the reference trains on the last, short
                # batch (torch's DataLoader default); the loader repeat-pads it.
                loader = NativeDataLoader(
                    files, sample_rate=cfg.sampling_rate, num_samples=cfg.num_samples,
                    batch_size=cfg.batch_size, train=True,
                    num_threads=max(2, cfg.num_workers), seed=self.seed,
                    start_seq=skip_batches, drop_last=False)
            except (OSError, RuntimeError) as e:     # no g++, or it failed
                self.log({"event": "native_loader_unavailable", "error": str(e)})
            else:
                self.log({"event": "native_loader", "files": len(files)})
                return iter(loader)
        return data_loader(WavDataset(cfg, train=True), cfg.batch_size, shuffle=True,
                           seed=self.seed, drop_last=False, skip_batches=skip_batches)

    def _pad_batch(self, batch: np.ndarray) -> np.ndarray:
        """Repeat-pad an underfull last batch to the batch size: the
        reference trains on the full last batch (drop_last=False)."""
        want = self.train_data.batch_size
        if batch.shape[0] >= want:
            return batch
        reps = -(-want // batch.shape[0])
        return np.concatenate([batch] * reps, axis=0)[:want]

    def _whole(self, state: dict) -> dict:
        """The state with its tensor-parallel shards gathered (a collective
        of every rank; the state itself without them)."""
        return state if self.mesh is None else gather_train_state(self.mesh, state)

    def _save(self, state: dict, step: int | None = None,
              val_loss: float | None = None) -> None:
        """``last.pt`` (and, with a val_loss, the top-k checkpoint of
        ``step``) of the whole state, written by rank 0 while the others
        wait."""
        whole = self._whole(state)
        if self.is_main:
            if val_loss is not None:
                self._save_topk(whole, step, val_loss)
            save_checkpoint(os.path.join(self.out_dir, "last.pt"), whole)
        barrier(self.mesh)

    def _validate(self, state: dict, val_iter, step: int) -> float | None:
        """Validation on rank 0 over the whole state, as one process runs
        it; the other ranks wait at the barrier (None)."""
        whole = self._whole(state)
        val_loss = self.validate(whole, val_iter, step) if self.is_main else None
        barrier(self.mesh)
        return val_loss

    def fit(self, max_batches: int | None = None, state: dict | None = None,
            resume_path: str | None = None) -> dict:
        spec, tcfg = self.spec, self.tcfg
        if state is None:
            state = (self.resume_state(resume_path) if resume_path
                     else create_train_state(spec, tcfg, seed=self.seed, device=self.device))
        mesh = self.mesh
        if mesh is not None and mesh.size > 1:
            state = shard_train_state(mesh, replicate_train_state(mesh, state))
            self.log({"event": "mesh", "data": mesh.data, "model": mesh.model})
        total = max_batches if max_batches is not None else tcfg.max_steps // 2
        start = state["step"]
        # A resumed run's loader starts at the batch the interrupted run
        # would have read next.
        train_iter = self._make_train_iter(skip_batches=start)
        val_iter = None
        if self.val_data is not None:
            val_iter = data_loader(WavDataset(self.val_data, train=False),
                                   self.val_data.batch_size, shuffle=False, seed=self.seed)
        t_last = time.time()
        # Every step repeats run for run, as the JAX step does (no switch).
        with repeatable_steps():
            for step in range(start, total):
                batch = self._pad_batch(next(train_iter))
                # Multi-quantizer configs draw n_q from [4, 6, 8] per step (ref
                # vq.py:103-108); the shipped n_q = 1 models use 1.
                n_q = (min(int(np.random.default_rng((self.seed + 1, step)).choice([4, 6, 8])),
                           spec.vq.n_q) if spec.vq.n_q > 1 else 1)
                # Every rank holds the global batch; it trains on its own rows.
                shard = batch_shard(mesh, len(batch), self.log)
                state, metrics = train_step(
                    state, self._audio(batch[shard.start:shard.stop]), spec, tcfg,
                    step_generator(self.seed, step), mel_coeff=mel_coeff_decay(tcfg, step + 1),
                    train_discriminator=step >= tcfg.pretrain_mel_steps, n_q=n_q,
                    with_grad_norm=step % self.log_every == 0, shard=shard)
                if step % self.log_every == 0:
                    rec = {"step": step, **{k: float(v) for k, v in metrics.items()},
                           "sec_per_step": (time.time() - t_last) / max(1, self.log_every)}
                    t_last = time.time()
                    self.log(rec)
                    self.tb.scalars({k: v for k, v in rec.items() if k != "step"}, step)
                if step > 0 and step % self.log_media_every == 0:
                    self._log_train_media(state, batch, step)
                if val_iter is not None and step > 0 and step % self.val_every == 0:
                    self._save(state, step, self._validate(state, val_iter, step))
        self._save(state)
        return state

    def _log_train_media(self, state: dict, batch: np.ndarray, step: int) -> None:
        """Audio and mel images every ``log_media_every`` steps (ref
        experiment.py:195-216), from one more forward of the first row, on
        rank 0 when TensorBoard logs."""
        state = self._whole(state)
        if not self.tb.enabled:
            return
        audio = self._audio(batch[:1])
        with torch.no_grad():
            audio_hat, _, _ = generator_forward(state["gen"], state["vq"], self.spec, audio, 0,
                                                n_q=1, generator=step_generator(self.seed, step))
        sr = self.spec.sample_rate
        self.tb.audio_and_spectrogram("train/reconstructed", audio_hat[0].cpu().numpy(), sr, step)
        self.tb.audio_and_spectrogram("train/original", audio[0].cpu().numpy(), sr, step)
        self.tb.flush()
