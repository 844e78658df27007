"""Rematerialization for training (the JAX package's ``jax.checkpoint``).

``checkpointed`` runs a block under ``torch.utils.checkpoint``: the backward
recomputes the block's activations instead of keeping them.  That changes
memory and time, never values, with one trap the JAX package avoids by its
explicit keys: a block that draws from a ``torch.Generator`` (the pos-net's
dropout) would draw a fresh mask in the recompute, from the generator the
forward already advanced, and its gradient would belong to another mask than
its forward.  ``checkpoint``'s ``preserve_rng_state`` saves only the default
generators, so the generators a block draws from are named here: the
recompute runs from their state at the forward, and leaves them as it found
them.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def checkpointed(fn, *args, remat: bool, generators=()):
    """fn(*args), rematerialized when ``remat`` and autograd records (under
    ``no_grad`` there is nothing to keep); ``generators`` are those fn draws
    from."""
    if not remat or not torch.is_grad_enabled():
        return fn(*args)
    generators = [g for g in generators if g is not None]
    at_forward = [g.get_state() for g in generators]
    calls = 0

    def run(*a):
        nonlocal calls
        calls += 1
        if calls == 1:
            return fn(*a)
        held = [g.get_state() for g in generators]
        for g, s in zip(generators, at_forward):
            g.set_state(s)
        try:
            return fn(*a)
        finally:
            for g, s in zip(generators, held):
                g.set_state(s)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
