"""Process groups, the ('data', 'model') mesh, and the collectives of data
and tensor parallelism.

Port of ``wavtokenizer_tpu/parallel/mesh.py``.  The reference trains with
8-GPU DDP: an NCCL all-reduce of the gradients plus codebook broadcasts
(SURVEY.md §2.4; encoder/distrib.py, core_vq.py:151,169).  The JAX package
gets the same by computing on the logically-global batch under jit.  Here
every rank is a process (``torchrun``) and the collectives are explicit:

* **data**: each data rank holds a batch-major block of the global batch
  (``shard_batch``).  The step all-reduces the mean of the gradients over
  the data group in one flat buffer per dtype (``all_reduce_mean``: DDP's
  arithmetic, without wrapping the functional step's trees in modules);
  the VQ's statistics are summed over it, and k-means runs on the
  all-gathered samples (``train/vq_train.py``).
* **model** (additive, not in the reference, as in the JAX package): each
  ConvNeXt MLP is split over the model group, pwconv1 (C, I) by columns and
  pwconv2 (I, C) by rows, with one all-reduce per block
  (``models/vocos.py::convnext_block``).  Its autograd is the Megatron pair
  ``copy_to_model`` (identity forward, all-reduce backward) and
  ``reduce_from_model`` (all-reduce forward, identity backward):
  ``torch.distributed.nn``'s all-reduce would all-reduce the gradient in its
  backward as well, which the model ranks already share, and so give
  model x the true gradient.

The mesh is row-major like JAX's (``mesh.py:29-39``): mesh rank r sits at
(r // model, r % model).  A CUDA tensor goes through host memory for a
gloo group (``_to_backend``), so that the same code runs NCCL on cards,
gloo on the CPU, and gloo between processes that share one card.
``COLLECTIVES`` counts the collective calls made here, by kind.
"""

from __future__ import annotations

import collections
import datetime
import inspect
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


COLLECTIVES: collections.Counter = collections.Counter()
# How long a collective may wait for the slowest rank: the trainer's rank 0
# validates alone (host metrics over up to limit_val_batches batches) while
# the other ranks wait at a barrier, far longer than NCCL's default 10 min.
GROUP_TIMEOUT = datetime.timedelta(hours=2)


def local_device(device=None) -> torch.device:
    """The device of this process: ``cuda:LOCAL_RANK`` for ``cuda`` (the
    default) without an index, the CPU or an indexed card as given."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def world_size_from_env() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_distributed(backend: str | None = None, device=None, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None) -> torch.device:
    """Join this run's process group and return this process's device.

    The rank, world size and rendezvous come from the ``torchrun``
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
    unless given (``init_method`` such as ``tcp://localhost:29500``).  The
    backend is NCCL for a card and gloo for the CPU unless named; a backend
    this PyTorch lacks, or NCCL without a card, raises ``RuntimeError``."""
    device = local_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    have = {"nccl": dist.is_available() and dist.is_nccl_available(),
            "gloo": dist.is_available() and dist.is_gloo_available()}
    if not have.get(backend, False):
        raise RuntimeError(f"torch.distributed backend {backend!r} is not available in "
                           f"this PyTorch build")
    if backend == "nccl" and device.type != "cuda":
        raise RuntimeError(f"the NCCL backend needs a CUDA device, not {device}")
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = world_size_from_env() if world_size is None else world_size
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=GROUP_TIMEOUT)
    return device


@dataclass
class Mesh:
    """One process's view of the ('data', 'model') mesh: its position
    ``rank`` among the mesh's ``ranks`` (global ranks), the axis sizes, the
    groups over all of the mesh, its data axis and its model axis (None
    without a process group: no collective runs), and its device."""
    rank: int
    data: int
    model: int
    device: torch.device
    ranks: tuple = (0,)
    group: object = None
    data_group: object = None
    model_group: object = None
    trim_logged: bool = False

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def size(self) -> int:
        return self.data * self.model


def make_mesh(model_parallel: int = 1, device=None, ranks=None) -> Mesh | None:
    """The ('data', 'model') mesh over ``ranks`` (default: every rank of the
    process group; one process without a group gets a mesh of one).

    Every process of the group must call it with the same arguments, since
    each group is made by ``dist.new_group``, which all processes enter;
    a process outside ``ranks`` gets None."""
    device = local_device(device)
    if not dist.is_initialized():
        if model_parallel != 1:
            raise ValueError("model_parallel > 1 needs a process group")
        return Mesh(0, 1, 1, device)
    ranks = tuple(range(dist.get_world_size()) if ranks is None else ranks)
    n, mp = len(ranks), model_parallel
    if mp < 1 or n % mp:
        raise ValueError(f"{n} ranks do not divide into model_parallel={mp}")
    nd = n // mp
    me = dist.get_rank()
    new = lambda rs: dist.new_group(list(rs), timeout=GROUP_TIMEOUT)
    group = new(ranks)
    model_groups = [new(ranks[d * mp:(d + 1) * mp]) for d in range(nd)]
    data_groups = [new(ranks[m::mp]) for m in range(mp)]
    if me not in ranks:
        return None
    r = ranks.index(me)
    return Mesh(r, nd, mp, device, ranks, group, data_groups[r % mp], model_groups[r // mp])


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)


# ---------------------------------------------------------------------------
# Collectives on flat buffers
# ---------------------------------------------------------------------------

def _to_backend(t: torch.Tensor, group) -> torch.Tensor:
    """The buffer the group's backend takes: a CUDA tensor goes through host
    memory for gloo, whose CUDA support covers only some collectives
    (all_gather_into_tensor none) and differs between builds."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


def _all_reduce(t: torch.Tensor, group) -> None:
    """In-place sum of ``t`` over ``group``."""
    buf = _to_backend(t, group)
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(buf, group=group)
    if buf is not t:
        t.copy_(buf)


@torch.no_grad()
def _all_reduce_flat(tensors, group, mean: bool) -> None:
    """Sum (``mean``: average) each tensor in place over ``group`` (None:
    nothing), one all-reduce per flat buffer of one dtype and device."""
    if group is None:
        return
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    n = dist.get_world_size(group)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        _all_reduce(flat, group)
        if mean:
            flat /= n
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_sum(tensors, group) -> None:
    """Each tensor summed over ``group`` in place, in flat buffers."""
    _all_reduce_flat(tensors, group, mean=False)


def all_reduce_mean(tensors, group) -> None:
    """Each tensor averaged over ``group`` in place, in flat buffers."""
    _all_reduce_flat(tensors, group, mean=True)


@torch.no_grad()
def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's equal-shaped tensors concatenated along ``dim`` in group
    rank order (None: ``t``)."""
    if group is None:
        return t
    buf = _to_backend(t.contiguous(), group)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    COLLECTIVES["all_gather"] += 1
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim).to(t.device)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


# ---------------------------------------------------------------------------
# Data parallelism
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BatchShard:
    """Where one rank's rows lie in the global batch: rows [start, stop) of
    ``total``, split over ``group`` (None: this rank holds the whole batch,
    in one process or replicated)."""
    start: int
    stop: int
    total: int
    group: object = None


def batch_shard(mesh: Mesh | None, n: int, log=None) -> BatchShard:
    """The layout of an n-row global batch over the data axis, as the JAX
    trainer places it (``trainer.py:201-221``): batch-major blocks; trimmed
    to a multiple of the data size, with the ``batch_trimmed`` event given
    once to ``log``; replicated when smaller than the data size."""
    if mesh is None or mesh.data_group is None or n < mesh.data:
        return BatchShard(0, n, n, None)
    dp = mesh.data
    if n % dp:
        trimmed = n // dp * dp
        if not mesh.trim_logged and log is not None:
            log({"event": "batch_trimmed", "from": n, "to": trimmed, "data_parallel": dp})
        mesh.trim_logged = True
        n = trimmed
    per = n // dp
    start = mesh.data_rank * per
    return BatchShard(start, start + per, n, mesh.data_group)


def shard_batch(mesh: Mesh | None, batch, log=None):
    """This data rank's rows of the global batch (``batch_shard``'s block)."""
    s = batch_shard(mesh, len(batch), log)
    return batch[s.start:s.stop]


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@torch.no_grad()
def replicate(mesh: Mesh | None, tree):
    """Every tensor of the tree overwritten with mesh rank 0's, one
    broadcast per flat buffer of one dtype and device; returns the tree."""
    if mesh is None or mesh.group is None:
        return tree
    buckets: dict = {}
    for t in _tensors(tree):
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        buf = _to_backend(flat, mesh.group)
        COLLECTIVES["broadcast"] += 1
        dist.broadcast(buf, src=mesh.ranks[0], group=mesh.group)
        offset = 0
        for t in ts:
            t.copy_(buf[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tree


def replicate_train_state(mesh: Mesh | None, state: dict) -> dict:
    """``replicate`` over a training state's trees and AdamW moments."""
    moments = [s[k] for name in ("opt_gen", "opt_disc") for s in state[name].state.values()
               for k in ("exp_avg", "exp_avg_sq") if k in s]
    replicate(mesh, [state[k] for k in ("gen", "disc", "vq", "decoder")] + moments)
    return state


# ---------------------------------------------------------------------------
# Tensor parallelism of the ConvNeXt MLP
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelShard:
    """A ConvNeXt block's tensor-parallel placement, kept in the block's
    params under "tp": slice ``rank`` of ``size`` of the MLP's hidden width,
    the partial outputs summed over ``group``."""
    group: object
    rank: int
    size: int


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        _all_reduce(grad, ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        _all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the shards' input gradients."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The shards' partial outputs summed; the backward passes the (shared)
    gradient to every shard as it is."""
    return _ReduceFromModel.apply(x, group)


# Split axis of each ConvNeXt tensor that tensor parallelism slices, in the
# training layout (w1 (C, I), b1 (I,), w2 (I, C)) and in the inference one
# (the same in bf16, and the kernel's packs w1t (I, C), w2t (C, I)).  b2
# stays whole: it is added once, after the reduction.
_SPLIT = {"w1": 1, "b1": 0, "w2": 0, "w1t": 0, "w2t": 1}


def _blocks(params: dict) -> list:
    return params.get("backbone", params)["convnext"]


def _split_axes(params: dict) -> dict:
    """{id(tensor): split axis} of the tensors tensor parallelism slices."""
    return {id(b[k]): ax for b in _blocks(params) for k, ax in _SPLIT.items() if k in b}


def generator_shardings(params: dict):
    """The params' tree with each tensor replaced by the axis it is split
    over the model axis (None: replicated): the ConvNeXt MLPs' pwconv1
    weight by columns and bias, pwconv2 weight by rows.  Takes the inference
    params (backbone under "backbone") and the training generator tree."""
    axes = _split_axes(params)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v) for v in tree]
        return axes.get(id(tree)) if isinstance(tree, torch.Tensor) else tree
    return walk(params)


def _slice(mesh: Mesh, t: torch.Tensor, axis: int) -> torch.Tensor:
    n = t.shape[axis]
    if n % mesh.model:
        raise ValueError(f"hidden width {n} does not split into model_parallel={mesh.model}")
    w = n // mesh.model
    return t.detach().narrow(axis, mesh.model_rank * w, w).contiguous().requires_grad_(
        t.requires_grad)


def shard_generator_params(mesh: Mesh, params: dict) -> dict:
    """This model rank's params: every ConvNeXt block's split tensors cut to
    its slice (``generator_shardings``) and its placement under "tp"; other
    tensors are the same objects.  For the inference params the shard's
    widths must be ones the kernel takes (``check_convnext_widths``), else
    ``ValueError``: a shard never runs the plain version instead."""
    if mesh is None or mesh.model == 1:
        return params
    from ..ops.kernels import check_convnext_widths

    axes = _split_axes(params)
    shard = ModelShard(mesh.model_group, mesh.model_rank, mesh.model)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v) for v in tree]
        if isinstance(tree, torch.Tensor) and id(tree) in axes:
            return _slice(mesh, tree, axes[id(tree)])
        return tree

    out = walk(params)
    for b in _blocks(out):
        if "w1t" in b:
            check_convnext_widths(b["w1"].shape[0], b["w1"].shape[1])
        b["tp"] = shard
    return out


def model_shard_of(params: dict) -> ModelShard | None:
    """The "tp" placement of the params' ConvNeXt blocks (None: whole)."""
    blocks = _blocks(params)
    return blocks[0].get("tp") if blocks else None


def _rebuilt_optimizer(opt, sched, params: list, convert):
    """An optimizer of ``opt``'s type and hyperparameters over ``params``,
    its per-tensor state converted by ``convert(index, moment)``, and a
    LambdaLR over it at ``sched``'s position."""
    accepted = inspect.signature(type(opt).__init__).parameters
    new = type(opt)(params, **{k: v for k, v in opt.defaults.items() if k in accepted})
    new_sched = torch.optim.lr_scheduler.LambdaLR(new, sched.lr_lambdas[0])
    sd = opt.state_dict()
    sd["state"] = {i: {k: (convert(i, v) if k in ("exp_avg", "exp_avg_sq") else v)
                       for k, v in s.items()} for i, s in sd["state"].items()}
    new.load_state_dict(sd)
    new_sched.load_state_dict(sched.state_dict())
    return new, new_sched


def _leaf_axes(gen: dict) -> list:
    from ..train.step import tree_leaves
    axes = _split_axes(gen)
    return [axes.get(id(t)) for t in tree_leaves(gen)]


def shard_train_state(mesh: Mesh, state: dict) -> dict:
    """The training state of this model rank: the generator's ConvNeXt MLPs
    sharded (``shard_generator_params``) and the AdamW moments of those
    tensors sliced alike (``mesh.py:93-135``), so that tensor parallelism
    divides their optimizer memory too; everything else as it was."""
    if mesh is None or mesh.model == 1:
        return state
    from ..train.step import tree_leaves
    axes = _leaf_axes(state["gen"])
    gen = shard_generator_params(mesh, state["gen"])
    opt, sched = _rebuilt_optimizer(
        state["opt_gen"], state["sched_gen"], tree_leaves(gen),
        lambda i, m: m if axes[i] is None else _slice(mesh, m, axes[i]))
    return {**state, "gen": gen, "opt_gen": opt, "sched_gen": sched}


def gather_train_state(mesh: Mesh, state: dict) -> dict:
    """Inverse of ``shard_train_state``: the whole generator and its whole
    AdamW moments on every rank of each model group (a collective of every
    rank), so that a checkpoint does not depend on ``model_parallel``."""
    shard = model_shard_of(state["gen"])
    if shard is None:
        return state
    from ..train.step import tree_leaves
    axes = _leaf_axes(state["gen"])
    by_id = _split_axes(state["gen"])

    def whole(t, axis):
        return all_gather(t.detach(), shard.group, axis).requires_grad_(t.requires_grad)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items() if k != "tp"}
        if isinstance(tree, (list, tuple)):
            return [walk(v) for v in tree]
        if isinstance(tree, torch.Tensor) and id(tree) in by_id:
            return whole(tree, by_id[id(tree)])
        return tree

    gen = walk(state["gen"])
    opt, sched = _rebuilt_optimizer(
        state["opt_gen"], state["sched_gen"], tree_leaves(gen),
        lambda i, m: m if axes[i] is None else whole(m, axes[i]))
    return {**state, "gen": gen, "opt_gen": opt, "sched_gen": sched}


def grad_norm(params: list, grads: list, tree: dict) -> torch.Tensor:
    """The global gradient norm of ``params`` (the tree's leaves, in
    order) after the data reduction: the squares of the tensor-parallel
    shards summed over the model group, the replicated tensors counted
    once."""
    shard = model_shard_of(tree)
    if shard is None:
        return torch.sqrt(sum(g.pow(2).sum() for g in grads))
    axes = _split_axes(tree)
    split = [g.pow(2).sum() for p, g in zip(params, grads) if id(p) in axes]
    whole = [g.pow(2).sum() for p, g in zip(params, grads) if id(p) not in axes]
    sq = torch.stack(split).sum()
    all_reduce_sum([sq], shard.group)
    return torch.sqrt(torch.stack(whole).sum() + sq)
