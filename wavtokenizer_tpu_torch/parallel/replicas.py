"""Data parallelism within one process: a replica of the model per device.

The counterpart of the JAX package's data mesh for serving and bulk
extraction (``wavtokenizer_tpu/api/engine.py:105-120, 341-347``,
``extract_features.py:57-88``): JAX runs one program over a batch sharded on
the 'data' axis.  Here a batch is split into equal row blocks, one per
device, and each replica's call is issued on a worker thread of its own
before any result is read, so that the cards (and the host-side kernel
launches) overlap.  No process group is involved.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch


def device_list(devices, default) -> list:
    """``devices`` (names, devices, or a comma-separated string) as
    ``torch.device``s; ``default`` when None or empty."""
    if isinstance(devices, str):
        devices = [d for d in devices.split(",") if d.strip()]
    devices = list(devices) if devices else [default]
    return [torch.device(d) for d in devices]


class Replicas:
    """One replica of ``wt`` (a ``WavTokenizer``) on each of ``devices``
    (default: the model's own device).  The first is ``wt`` itself when it
    lives on the first device; every other holds its own copy of the
    weights (``WavTokenizer.to``), two entries of one card included."""

    def __init__(self, wt, devices=None):
        self.devices = device_list(devices, wt.device)
        self.models = [wt if i == 0 and d == wt.device else wt.to(d)
                       for i, d in enumerate(self.devices)]
        self._pool = (ThreadPoolExecutor(len(self.models), thread_name_prefix="wt-replica")
                      if len(self.models) > 1 else None)

    def __len__(self) -> int:
        return len(self.models)

    def map(self, fn, rows) -> list:
        """[fn(model, block)] for the equal row blocks of ``rows`` (numpy or
        tensor, split along axis 0), in device order.  Each call is issued
        on its replica's thread; the results are collected once all are
        issued, and are read (moved to the host) by the caller."""
        n = len(self.models)
        if len(rows) % n:
            raise ValueError(f"{len(rows)} rows do not split over {n} devices")
        if self._pool is None:
            return [fn(self.models[0], rows)]
        size = len(rows) // n
        futures = [self._pool.submit(fn, m, rows[i * size:(i + 1) * size])
                   for i, m in enumerate(self.models)]
        return [f.result() for f in futures]

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
