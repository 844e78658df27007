"""The two-optimizer GAN training step.

Port of ``wavtokenizer_tpu/train/step.py`` (ref decoder/experiment.py:86-218,
338-462): AdamW x2 (discriminators: MPD + MRD + DAC; generator: encoder +
backbone + head), cosine LR with warmup over max_steps // 2, per batch the
discriminator update THEN the generator update (so the generator sees the
updated discriminators, Lightning's multi-optimizer order), a random
bandwidth_id per step, and the VQ EMA state advancing in BOTH forwards.

* Only {encoder, backbone, head} are optimized: the SEANet decoder and the
  codebooks are carried (experiment.py:92-96).  Weight decay applies to
  every optimized tensor, as optax's ``adamw`` decays every leaf.
* The weight-normed convs train as (v, g) (``train/wnorm.py``); the
  backbone's ConvNeXt blocks run plain (``fused=False``: the kernel has no
  backward); the encoder runs every layer plainly (no front kernel); the
  VQ's nearest-code searches run in the VQ kernel on the card.
* ``remat`` checkpoints the encoder layers, the pos-net and ConvNeXt blocks
  and each sub-discriminator's scalar loss (``ops/remat.py``) at the JAX
  package's boundaries; the VQ's training forward (k-means, the EMA update,
  its searches) stays outside every checkpoint, so nothing of it runs twice.
  ``disc_compute_dtype``/``gen_compute_dtype`` run the discriminators'
  conv stacks and the decode side (backbone and head) in bf16; the encoder
  and the VQ are never cast, so the codes do not depend on them.
* ``torch.optim.AdamW`` computes optax's ``adamw`` update (eps outside the
  square root of the bias-corrected second moment, decay p - lr * wd * p).
  The LR is the schedule read at the update count before the update: each
  optimizer's ``LambdaLR`` (over a base LR of 1, so the lambda is the LR)
  steps after it.

The state is a dict: "gen", "disc" (trees of leaf tensors that require
grad), "vq" (the codebook state, new tensors every step), "decoder" (the
JAX package's layout, as tensors), "opt_gen"/"opt_disc" (AdamW),
"sched_gen"/"sched_disc" (LambdaLR) and "step" (int).  ``train_step``
updates it in place and returns it.

Randomness comes from one CPU ``torch.Generator`` per step: the
bandwidth_id, the seeds of the two dropout generators (on the audio's
device) and k-means' sample indices, in that order.  JAX draws from its own
keys, so the two packages agree only where the draws do not matter or are
passed in: a given ``bandwidth_id``, an inited codebook, no dropout.

Data parallelism (``shard``, a ``parallel/mesh.py::BatchShard``): ``audio``
holds this rank's rows of the global batch; every rank draws from a
generator of the same seed, so the bandwidth_id, n_q, k-means' means and the
dropout masks (drawn for the global batch, this rank's rows taken) are
those of one process on the global batch; the VQ statistics are the global
batch's (``train/vq_train.py``); the gradients of both optimizers are
averaged over the data group right after each backward, and the logged
metrics are the global batch's means.  Tensor parallelism lives in the
generator tree (``parallel/mesh.py::shard_train_state``): the gradient norm
then sums the shards' squares over the model group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..api.pretrained import (backbone_from_jax, backbone_to_jax, encoder_to_jax,
                              seanet_from_jax)
from ..models.init import init_wavtokenizer
from ..models.seanet import encoder_layer_specs, seanet_encode
from ..models.vocos import istft_head, vocos_backbone
from ..models.wavtokenizer import WavTokenizerSpec
from ..parallel.mesh import BatchShard, all_reduce_mean, grad_norm
from .discriminators import cast_floats, init_discriminators
from .losses import dac_disc_loss, dac_gen_loss, mel_loss, vocos_disc_loss, vocos_gen_loss
from .vq_train import vq_train_forward
from .wnorm import fold_tree, seanet_to_weight_norm


@dataclass(frozen=True)
class TrainConfig:
    """The experiment's hyperparameters (ref experiment.py:24-42 and
    configs/*.yaml model.init_args)."""
    sample_rate: int = 24000
    initial_learning_rate: float = 2e-4
    num_warmup_steps: int = 0
    mel_loss_coeff: float = 45.0
    mrd_loss_coeff: float = 1.0
    pretrain_mel_steps: int = 0
    decay_mel_coeff: bool = False
    max_steps: int = 2_000_000
    num_bandwidths: int = 4
    weight_decay: float = 0.01  # torch AdamW default
    # Rematerialization: the backward recomputes the activations of the
    # encoder layers (with remat_encoder), the pos-net and ConvNeXt blocks,
    # and of each sub-discriminator's scalar loss (by remat_disc: True, False
    # stores every family's activations, "store_dac" stores only the DAC
    # family's), instead of keeping them.  It changes memory and time, never
    # values.  The JAX package defaults it on to fit its 16 GB chip; an
    # 80 GB H100 holds the reference batch (40 x 3 s) without it, so it is
    # off here.
    remat: bool = False
    remat_encoder: bool = True
    remat_disc: bool | str = True
    # Training-time dropout inside the backbone pos-net resblocks (the
    # reference trains with 0.1, decoder/models.py:200).
    pos_dropout: float = 0.1
    # Validation's objective evaluators (ref configs/*.yaml model.init_args
    # evaluate_utmos/evaluate_pesq/evaluate_periodicty): one that is off, or
    # has no checkpoint (UTMOS), scores 0, so its (5 - score) val_loss term
    # is the constant 5 (train/trainer.py::Trainer._host_val_metrics).
    evaluate_utmos: bool = True
    evaluate_pesq: bool = True
    evaluate_periodicity: bool = True
    # Discriminator hidden-width multiplier: 1.0 is the reference's widths;
    # tests and smoke runs shrink it and keep every family, period,
    # resolution and band.
    disc_channels_scale: float = 1.0
    # Mixed precision (the reference trains fp32, the default): the
    # discriminators' conv stacks, and the decode side (backbone and ISTFT
    # head), in this type.  Parameters, the weight-norm folds, the loss
    # arithmetic, gradients and AdamW stay fp32; the encoder and the VQ are
    # never cast.
    disc_compute_dtype: str = "float32"
    gen_compute_dtype: str = "float32"


def compute_dtype(name: str) -> torch.dtype | None:
    """A compute type by name: None for "float32" (nothing is cast), else
    the torch floating type; a name that is no floating type raises
    ``ValueError``."""
    if name == "float32":
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute dtype {name!r} is not a floating type")
    return dtype


def disc_remat_mode(remat: bool, remat_disc) -> bool | str:
    """``remat_disc`` under the global ``remat``: False stores every
    family's activations, True rematerializes every family, "store_dac"
    stores the DAC family's and rematerializes MPD and MRD."""
    if not remat or remat_disc is False:
        return False
    return "store_dac" if remat_disc == "store_dac" else True


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def cosine_schedule_with_warmup(base_lr: float, num_warmup_steps: int,
                                num_training_steps: int):
    """transformers.get_cosine_schedule_with_warmup (ref
    experiment.py:102-107): the LR at a step."""
    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            return base_lr * step / max(1.0, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(1.0, num_training_steps - num_warmup_steps)
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))
    return schedule


def make_optimizers(tcfg: TrainConfig, disc: dict, gen: dict) -> tuple:
    """((AdamW, LambdaLR) of the discriminators, the same of the generator)."""
    sched = cosine_schedule_with_warmup(tcfg.initial_learning_rate,
                                        tcfg.num_warmup_steps, tcfg.max_steps // 2)

    def one(tree):
        opt = torch.optim.AdamW(tree_leaves(tree), lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=tcfg.weight_decay)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, sched)
    return one(disc), one(gen)


def new_train_state(gen: dict, disc: dict, vq: dict, decoder, tcfg: TrainConfig,
                    step: int = 0) -> dict:
    """A state over copies of the given trees (gen and disc leaves made
    trainable), with fresh optimizers at the schedule's step 0."""
    own = lambda t: t.detach().clone()
    gen = tree_map(lambda t: own(t).requires_grad_(True), gen)
    disc = tree_map(lambda t: own(t).requires_grad_(True), disc)
    (opt_disc, sched_disc), (opt_gen, sched_gen) = make_optimizers(tcfg, disc, gen)
    return {"gen": gen, "disc": disc, "vq": tree_map(own, vq),
            "decoder": tree_map(own, decoder), "opt_gen": opt_gen, "opt_disc": opt_disc,
            "sched_gen": sched_gen, "sched_disc": sched_disc, "step": int(step)}


def to_tensors(tree, device):
    """A tree of arrays -> the same tree of float32 tensors on ``device``
    (copies)."""
    if isinstance(tree, dict):
        return {k: to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_tensors(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def generator_from_jax(params: dict, spec: WavTokenizerSpec, device) -> dict:
    """The optimized part of a JAX-layout inference pytree (numpy: the
    init's, a converted checkpoint's) -> the training tree: the encoder in
    (v, g) form with v = w, g = |w| (the same forward), the backbone and
    head in fp32."""
    specs = encoder_layer_specs(spec.seanet)
    return {"encoder": seanet_to_weight_norm(
                seanet_from_jax(params["encoder"], specs, device, train=True), specs),
            "backbone": backbone_from_jax(params["backbone"], device, train=True),
            "head": to_tensors(params["head"], device)}


def create_train_state(spec: WavTokenizerSpec, tcfg: TrainConfig, seed: int = 0,
                       device="cuda") -> dict:
    """Fresh state: the generator from ``init_wavtokenizer(spec, seed)`` (the
    JAX package's draws), discriminators from ``init_discriminators(seed +
    1)``, the codebook un-inited (k-means on the first batch), the decoder
    carried."""
    device = torch.device(device)
    params = init_wavtokenizer(spec, seed=seed)
    disc = tree_map(lambda t: t.to(device),
                    init_discriminators(seed=seed + 1, num_embeddings=tcfg.num_bandwidths,
                                        channels_scale=tcfg.disc_channels_scale))
    return new_train_state(generator_from_jax(params, spec, device), disc,
                           to_tensors(params["quantizer"], device),
                           to_tensors(params["decoder"], device), tcfg)


def generator_forward(gen: dict, vq: dict, spec: WavTokenizerSpec, audio: torch.Tensor,
                      bandwidth_id: int, n_q: int, generator: torch.Generator | None = None,
                      dropout_generator: torch.Generator | None = None,
                      dropout_rate: float = 0.0, remat: bool = False,
                      remat_encoder: bool | None = None, compute_dtype=None,
                      shard: BatchShard | None = None):
    """Training forward: encoder -> VQ (train) -> backbone -> head (ref
    experiment.py:114-119 via feature_extractors.py:105-119).  audio (B, T)
    -> (audio_hat (B, T), commit loss, new VQ state).

    ``remat`` checkpoints the backbone's blocks and, unless
    ``remat_encoder`` is False, the encoder's layers; the VQ runs outside
    every checkpoint.  ``compute_dtype`` runs the backbone and head in that
    type (their weights and the quantized input cast); audio_hat comes back
    in the audio's type.  ``shard``: where audio's rows lie in the global
    batch (the VQ statistics and the dropout masks are the global batch's)."""
    enc = fold_tree(gen["encoder"])
    remat_enc = remat if remat_encoder is None else (remat and remat_encoder)
    emb = seanet_encode(enc, spec.seanet, audio[:, :, None], front=False, remat=remat_enc)
    quantized, _, commit, new_vq = vq_train_forward(vq, spec.vq, emb, n_q, generator,
                                                    shard.group if shard else None)
    backbone, head = gen["backbone"], gen["head"]
    if compute_dtype is not None:
        backbone, head = cast_floats(backbone, compute_dtype), cast_floats(head, compute_dtype)
        quantized = quantized.to(compute_dtype)
    h = vocos_backbone(backbone, spec.backbone, quantized, bandwidth_id=bandwidth_id,
                       fused=False, dropout_generator=dropout_generator,
                       dropout_rate=dropout_rate, remat=remat,
                       dropout_rows=(shard.start, shard.total) if shard else None)
    return istft_head(head, spec.head, h).to(audio.dtype), commit, new_vq


def _disc_loss_fn(disc: dict, audio_hat, audio, bandwidth_id: int, mrd_coeff: float,
                  remat=False, compute_dtype=None):
    """ref experiment.py:125-148; ``remat`` is ``disc_remat_mode``'s."""
    loss_dac = dac_disc_loss(disc, audio_hat, audio, remat is True, compute_dtype)
    loss_mp = vocos_disc_loss(disc["mpd"], "mpd", audio, audio_hat, bandwidth_id,
                              bool(remat), compute_dtype)
    loss_mrd = vocos_disc_loss(disc["mrd"], "mrd", audio, audio_hat, bandwidth_id,
                               bool(remat), compute_dtype)
    loss = loss_mp + mrd_coeff * loss_mrd + loss_dac
    return loss, {"disc_total": loss, "disc_mp": loss_mp, "disc_mrd": loss_mrd,
                  "disc_dac": loss_dac}


def _gen_loss_fn(gen, disc, vq, spec, tcfg, audio, bandwidth_id, n_q, mel_coeff,
                 train_discriminator, generator, dropout_generator, shard=None):
    """ref experiment.py:151-218."""
    audio_hat, commit_loss, new_vq = generator_forward(
        gen, vq, spec, audio, bandwidth_id, n_q, generator, dropout_generator,
        tcfg.pos_dropout, tcfg.remat, tcfg.remat_encoder, compute_dtype(tcfg.gen_compute_dtype),
        shard)
    l_mel = mel_loss(audio_hat, audio, spec.sample_rate)
    metrics = {"mel_loss": l_mel, "commit_loss": commit_loss}
    loss = mel_coeff * l_mel + 1000.0 * commit_loss
    if train_discriminator:
        remat = disc_remat_mode(tcfg.remat, tcfg.remat_disc)
        dt = compute_dtype(tcfg.disc_compute_dtype)
        dac_g, dac_feat = dac_gen_loss(disc, audio_hat, audio, remat is True, dt)
        gen_mp, fm_mp = vocos_gen_loss(disc["mpd"], "mpd", audio, audio_hat, bandwidth_id,
                                       bool(remat), dt)
        gen_mrd, fm_mrd = vocos_gen_loss(disc["mrd"], "mrd", audio, audio_hat, bandwidth_id,
                                         bool(remat), dt)
        c = tcfg.mrd_loss_coeff
        loss = loss + gen_mp + c * gen_mrd + fm_mp + c * fm_mrd + dac_g + dac_feat
        metrics.update({"gen_mp": gen_mp, "gen_mrd": gen_mrd, "fm_mp": fm_mp,
                        "fm_mrd": fm_mrd, "dac_gen": dac_g, "dac_feat": dac_feat})
    metrics["gen_total"] = loss
    return loss, metrics, new_vq


def _backward(loss: torch.Tensor, opt: torch.optim.Optimizer,
              shard: BatchShard | None = None) -> list:
    """Gradients of ``loss`` into the optimizer's tensors; a tensor the loss
    does not reach gets a zero gradient, so AdamW still decays it and moves
    its moments, as optax updates every leaf.  With ``shard`` the gradients
    are then averaged over its data group: each rank's loss is the mean over
    an equal block of the global batch, so the average is the global batch's
    gradient."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    params = opt.param_groups[0]["params"]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    all_reduce_mean(grads, shard.group if shard else None)
    return grads


def _dropout_generators(generator: torch.Generator, device) -> list:
    seeds = torch.randint(0, 2 ** 62, (2,), generator=generator).tolist()
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def discriminator_phase(state: dict, audio: torch.Tensor, spec: WavTokenizerSpec,
                        tcfg: TrainConfig, bandwidth_id: int, n_q: int = 1,
                        generator: torch.Generator | None = None,
                        dropout_generator: torch.Generator | None = None,
                        shard: BatchShard | None = None) -> tuple:
    """The discriminator update (ref experiment.py:125-148): a generator
    forward without gradients (it advances the VQ state, k-means included
    on an un-inited codebook), the discriminator loss on its detached
    output, one AdamW step.  Returns (the new VQ state, metrics); the
    discriminators and their optimizer are updated in ``state``."""
    with torch.no_grad():
        audio_hat, _, vq = generator_forward(state["gen"], state["vq"], spec, audio,
                                             bandwidth_id, n_q, generator, dropout_generator,
                                             tcfg.pos_dropout,
                                             compute_dtype=compute_dtype(tcfg.gen_compute_dtype),
                                             shard=shard)
    loss, metrics = _disc_loss_fn(state["disc"], audio_hat, audio, bandwidth_id,
                                  tcfg.mrd_loss_coeff, disc_remat_mode(tcfg.remat, tcfg.remat_disc),
                                  compute_dtype(tcfg.disc_compute_dtype))
    _backward(loss, state["opt_disc"], shard)
    state["opt_disc"].step()
    state["sched_disc"].step()
    return vq, metrics


def generator_phase(state: dict, vq: dict, audio: torch.Tensor, spec: WavTokenizerSpec,
                    tcfg: TrainConfig, bandwidth_id: int, n_q: int = 1,
                    generator: torch.Generator | None = None,
                    dropout_generator: torch.Generator | None = None,
                    mel_coeff: float = 45.0, train_discriminator: bool = True,
                    with_grad_norm: bool = False, shard: BatchShard | None = None) -> dict:
    """The generator update (ref experiment.py:151-218) from the VQ state
    ``vq``: the training forward, mel and commitment losses and, with
    ``train_discriminator``, the adversarial and feature losses of the
    (updated) discriminators; one AdamW step.  The new VQ state goes into
    ``state``; returns the metrics."""
    # No discriminator gradient in this phase: with the discriminators
    # frozen, autograd keeps nothing for their weights.
    disc_params = tree_leaves(state["disc"])
    for p in disc_params:
        p.requires_grad_(False)
    try:
        loss, metrics, new_vq = _gen_loss_fn(
            state["gen"], state["disc"], vq, spec, tcfg, audio, bandwidth_id, n_q, mel_coeff,
            train_discriminator, generator, dropout_generator, shard)
        grads = _backward(loss, state["opt_gen"], shard)
    finally:
        for p in disc_params:
            p.requires_grad_(True)
    if with_grad_norm:
        # Global generator gradient norm (GradNormCallback, helpers.py:49-55).
        metrics["grad_norm"] = grad_norm(state["opt_gen"].param_groups[0]["params"], grads,
                                         state["gen"])
    state["opt_gen"].step()
    state["sched_gen"].step()
    state["vq"] = new_vq
    return metrics


def train_step(state: dict, audio: torch.Tensor, spec: WavTokenizerSpec,
               tcfg: TrainConfig, generator: torch.Generator | None = None,
               mel_coeff: float = 45.0, train_discriminator: bool = True, n_q: int = 1,
               with_grad_norm: bool = False, bandwidth_id: int | None = None,
               shard: BatchShard | None = None):
    """One batch: ``discriminator_phase``, then ``generator_phase``
    (Lightning's order).  audio (B, T) 24 kHz crops on the state's device:
    with ``shard``, this rank's rows of the global batch
    (``parallel/mesh.py::batch_shard``).

    ``generator`` (CPU; default: seeded with the step count) draws the
    bandwidth_id unless one is given, the dropout seeds and k-means' sample
    indices.  Returns (state, metrics), the metrics as 0-d tensors (the
    global batch's means)."""
    if generator is None:
        generator = torch.Generator().manual_seed(state["step"])
    if bandwidth_id is None:
        bandwidth_id = int(torch.randint(0, tcfg.num_bandwidths, (), generator=generator))
    drop_d, drop_g = _dropout_generators(generator, audio.device)
    vq, metrics = state["vq"], {}
    if train_discriminator:
        vq, metrics = discriminator_phase(state, audio, spec, tcfg, bandwidth_id, n_q,
                                          generator, drop_d, shard)
    metrics.update(generator_phase(state, vq, audio, spec, tcfg, bandwidth_id, n_q, generator,
                                   drop_g, mel_coeff, train_discriminator, with_grad_norm,
                                   shard))
    state["step"] += 1
    metrics = {k: v.detach() for k, v in metrics.items()}
    if shard is not None and shard.group is not None:
        # Each rank's means -> the global batch's; the gradient norm is
        # already the global one.
        metrics = {k: v.clone() for k, v in metrics.items()}
        all_reduce_mean([v for k, v in metrics.items() if k != "grad_norm"], shard.group)
    return state, metrics


def mel_coeff_decay(tcfg: TrainConfig, step: int, num_cycles: float = 0.5) -> float:
    """Host-side mel-coefficient cosine decay (ref experiment.py:324-335)."""
    if not tcfg.decay_mel_coeff:
        return tcfg.mel_loss_coeff
    max_steps = tcfg.max_steps // 2
    if step < tcfg.num_warmup_steps:
        return tcfg.mel_loss_coeff
    progress = float(step - tcfg.num_warmup_steps) / float(
        max(1, max_steps - tcfg.num_warmup_steps))
    return tcfg.mel_loss_coeff * max(
        0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))


def state_to_inference_params(state: dict, spec: WavTokenizerSpec) -> dict:
    """Weight norm folded, the inference param pytree in the JAX package's
    layout (numpy): ``WavTokenizer.from_jax_params`` and
    ``checkpoint/export.py`` take it."""
    to_np = lambda t: t.detach().cpu().numpy()
    with torch.no_grad():
        encoder = encoder_to_jax(fold_tree(state["gen"]["encoder"]),
                                 encoder_layer_specs(spec.seanet))
    head = state["gen"]["head"]["out"]
    return {"encoder": encoder,
            "decoder": _numpy_tree(state["decoder"]),
            "quantizer": _numpy_tree(state["vq"]),
            "backbone": backbone_to_jax(state["gen"]["backbone"]),
            "head": {"out": {"weight": to_np(head["weight"]), "bias": to_np(head["bias"])}}}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return tree.detach().cpu().numpy()
