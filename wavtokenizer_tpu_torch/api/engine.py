"""Serving engine: dynamic micro-batching of tokenize/detokenize requests.

Port of ``wavtokenizer_tpu/api/engine.py``.  The reference serves one
request at a time (infer.py:31-70); this engine coalesces concurrent
requests into batched model calls:

* **Exact-length groups, padded batch rows.**  Requests are grouped by their
  EXACT length and batched along the batch axis only; spare batch rows are
  zeros.  Rows are independent through every op, so other requests' outputs
  are untouched.  Time is never padded: zero-padding time changes the conv
  edge frames and, in the decoder, the pos-net attention over every frame,
  so each request gets what ``WavTokenizer.encode_infer``/``decode`` give at
  its natural length.
* **One worker thread** drains a queue, lingers ``max_wait_ms`` to coalesce
  requests of the same op, makes every model call, and fans results out to
  per-request futures.
* **Three ops.**  ``encode`` (audio -> features + codes), ``decode``
  (features -> audio), ``detokenize`` (codes -> audio:
  ``codes_to_features`` then ``decode``, ref decoder/pretrained.py:209-239
  and :192-207).

``clip_seconds`` caps the request length (chunk longer audio with
``api.streaming``), and ``warmup()`` runs every (batch bucket x clip bucket)
once, so the first requests find the kernels built.

* **Data-parallel over devices** (the JAX engine's ``mesh``/``_place``,
  ``engine.py:105-120, 341-347, 387-390``): ``devices`` holds one replica
  of the weights per entry (``parallel/replicas.py``); each bucket batch is
  split into equal row blocks, one per replica, every replica's call issued
  before any result is read.  Every bucket size must divide by the number
  of devices.  One process, no process group.

Left out of the JAX engine: the LRU of per-shape compiled programs
(``_program``, ``max_programs``), because eager PyTorch compiles nothing.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from ..parallel.replicas import Replicas


def _resolve(fut: Future, value) -> None:
    """Deliver a result unless the caller already cancelled the future:
    ``set_running_or_notify_cancel()`` fails for a cancelled future and
    blocks ``cancel()`` afterwards, so one caller's cancel never surfaces
    as a failure of the other requests in its batch."""
    if fut.set_running_or_notify_cancel():
        fut.set_result(value)


@dataclass
class EngineConfig:
    batch_sizes: tuple = (1, 8, 32)     # per-bucket max batch, ascending
    clip_seconds: tuple = (3.0,)        # length buckets, ascending
    max_wait_ms: float = 4.0            # linger for batch coalescing
    max_queue: int = 4096
    # Default Future.result timeout of the blocking helpers encode()/
    # decode()/detokenize(); None waits forever.
    request_timeout_s: float | None = None


# Written by the worker thread, read by HTTP handler threads.
_STATS_LOCK = threading.Lock()


@dataclass
class EngineStats:
    requests: int = 0
    batches: int = 0
    by_op: dict = field(default_factory=dict)

    @property
    def mean_batch_occupancy(self) -> float:
        return self.requests / max(self.batches, 1)

    def snapshot(self) -> dict:
        """A consistent copy for readers on other threads."""
        with _STATS_LOCK:
            return {"requests": self.requests, "batches": self.batches,
                    "mean_batch_occupancy": self.mean_batch_occupancy,
                    "by_op": dict(self.by_op)}


class ServingEngine:
    """Micro-batching server around a loaded ``WavTokenizer``.

    >>> eng = ServingEngine(wt)                  # or devices=["cuda:0", "cuda:1"]
    >>> fut = eng.submit("encode", audio_np)     # non-blocking
    >>> feats, codes = fut.result()
    >>> wav = eng.detokenize(codes_np)           # blocking
    """

    def __init__(self, wt, config: EngineConfig | None = None, devices=None):
        """``devices``: where the replicas live (default: the model's own
        device); a bucket size that does not divide by their number raises
        ``ValueError``."""
        self.wt = wt
        self.cfg = config if config is not None else EngineConfig()
        self.replicas = Replicas(wt, devices)
        bad = [b for b in self.cfg.batch_sizes if b % len(self.replicas)]
        if bad:
            self.replicas.close()
            raise ValueError(f"batch buckets {bad} not divisible by the {len(self.replicas)} "
                             "devices")
        self.hop = wt.spec.seanet.hop_length
        self.sr = wt.spec.sample_rate
        self.stats = EngineStats()
        self._q: queue.Queue = queue.Queue(maxsize=self.cfg.max_queue)
        self._closed = False
        self._lifecycle = threading.Lock()   # serializes submit against close
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="wt-serving-engine")
        self._worker.start()

    # ---- public API ----------------------------------------------------

    def submit(self, op: str, payload) -> Future:
        """op in {encode, decode, detokenize}; returns a Future.

        encode: (T,) float audio -> (features (D, T'), codes (T',))
        decode: (D, T') features -> (T,) float audio
        detokenize: (T',) int codes -> (T,) float audio

        The payload's shape, type and bucket are checked HERE, so a malformed
        or oversized payload fails only its own future and never the batch
        it would have joined.  That includes detokenize codes outside
        ``[-bins, bins)`` (negative ones wrap, as ``jnp.take`` does): such a
        request fails with ``ValueError`` (a 400 from ``tools/serve.py``)
        where the JAX package returns NaN audio for that row, because on the
        card the out-of-range lookup is a device-side assert that leaves the
        process's CUDA context unusable."""
        if op not in ("encode", "decode", "detokenize"):
            raise ValueError(op)
        fut: Future = Future()
        try:
            arr = np.asarray(payload)
            if op == "encode":
                if arr.ndim != 1 or not np.issubdtype(arr.dtype, np.floating):
                    raise ValueError(f"encode expects 1-D float audio (T,), got "
                                     f"shape {arr.shape} dtype {arr.dtype}")
                self._bucket_samples(arr.shape[-1])
            elif op == "decode":
                dim = self.wt.spec.backbone.input_channels
                if (arr.ndim != 2 or arr.shape[0] != dim
                        or not np.issubdtype(arr.dtype, np.floating)):
                    raise ValueError(f"decode expects 2-D float features ({dim}, T'), "
                                     f"got shape {arr.shape} dtype {arr.dtype}")
                self._bucket_frames(arr.shape[-1])
            else:
                if arr.ndim != 1 or not np.issubdtype(arr.dtype, np.integer):
                    raise ValueError(f"detokenize expects 1-D int codes (T',), got "
                                     f"shape {arr.shape} dtype {arr.dtype}")
                self._bucket_frames(arr.shape[-1])
                bins = self.wt.spec.vq.bins
                if arr.size and (arr.min() < -bins or arr.max() >= bins):
                    raise ValueError(f"detokenize codes must lie in [-{bins}, {bins}), "
                                     f"got min {arr.min()} max {arr.max()}")
        except ValueError as e:
            fut.set_exception(e)
            return fut
        with self._lifecycle:
            if self._closed:
                raise RuntimeError("engine closed")
            self._q.put((op, arr, fut))
        return fut

    def _timeout(self, timeout):
        return timeout if timeout is not None else self.cfg.request_timeout_s

    def encode(self, audio, timeout: float | None = None):
        return self.submit("encode", audio).result(self._timeout(timeout))

    def decode(self, features, timeout: float | None = None):
        return self.submit("decode", features).result(self._timeout(timeout))

    def detokenize(self, codes, timeout: float | None = None):
        return self.submit("detokenize", codes).result(self._timeout(timeout))

    def warmup(self) -> None:
        """Run every (op, bucket) once, so the first real requests find the
        kernels built and cuDNN's algorithms chosen."""
        dim = self.wt.spec.backbone.input_channels
        for secs in self.cfg.clip_seconds:
            T = int(secs * self.sr)
            Tp = math.ceil(T / self.hop)
            for b in self.cfg.batch_sizes:
                self._run_encode(np.zeros((b, T), np.float32))
                self._run_decode(np.zeros((b, dim, Tp), np.float32))
                self._run_detok(np.zeros((b, Tp), np.int32))

    def close(self) -> None:
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=30)
        # Drain only once the worker is gone: while it is still busy the
        # queue holds its sentinel and work it will still serve.
        if self._worker.is_alive():
            return
        self.replicas.close()
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[2].done():
                item[2].set_exception(RuntimeError("engine closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- batching loop -------------------------------------------------

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            deadline = time.perf_counter() + self.cfg.max_wait_ms / 1e3
            max_b = self.cfg.batch_sizes[-1]
            while len(batch) < max_b:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._dispatch(batch)
                    return
                if nxt[0] != batch[0][0]:   # another op: flush, start anew
                    self._dispatch(batch)
                    batch = [nxt]
                    deadline = time.perf_counter() + self.cfg.max_wait_ms / 1e3
                    continue
                batch.append(nxt)
            self._dispatch(batch)

    def _bucket_batch(self, n: int) -> int:
        for b in self.cfg.batch_sizes:
            if n <= b:
                return b
        return self.cfg.batch_sizes[-1]

    def _bucket_samples(self, t: int) -> int:
        for secs in self.cfg.clip_seconds:
            if t <= int(secs * self.sr):
                return int(secs * self.sr)
        raise ValueError(f"clip of {t} samples exceeds the largest bucket "
                         f"({self.cfg.clip_seconds[-1]} s); chunk long audio via "
                         "api.streaming first")

    def _bucket_frames(self, tp: int) -> int:
        """Frame bucket: each sample bucket's capacity in frames,
        ceil(samples / hop), as warmup's shapes."""
        for secs in self.cfg.clip_seconds:
            cap = math.ceil(int(secs * self.sr) / self.hop)
            if tp <= cap:
                return cap
        raise ValueError(f"{tp} frames exceeds the largest bucket "
                         f"({self.cfg.clip_seconds[-1]} s); chunk long audio via "
                         "api.streaming first")

    def _dispatch(self, batch) -> None:
        try:
            self._dispatch_inner(batch[0][0], batch)
        except Exception as e:  # fan the failure out to every waiter
            for _, _, fut in batch:
                try:
                    if not fut.done():
                        fut.set_exception(e)
                except Exception:   # lost a cancel race; nothing to deliver
                    pass

    def _dispatch_inner(self, op, batch) -> None:
        with _STATS_LOCK:
            self.stats.requests += len(batch)
            self.stats.batches += 1
            self.stats.by_op[op] = self.stats.by_op.get(op, 0) + len(batch)
        groups: dict = {}
        for _, p, fut in batch:
            groups.setdefault(p.shape[-1], []).append((fut, p))
        for items in groups.values():
            B = self._bucket_batch(len(items))
            first = items[0][1]
            dtype = np.int32 if op == "detokenize" else np.float32
            x = np.zeros((B,) + first.shape, dtype)
            for i, (_, p) in enumerate(items):
                x[i] = p
            if op == "encode":
                feats, codes = self._run_encode(x)
                for i, (fut, _) in enumerate(items):
                    _resolve(fut, (feats[i], codes[0, i]))
            else:
                wav = self._run_decode(x) if op == "decode" else self._run_detok(x)
                for i, (fut, _) in enumerate(items):
                    _resolve(fut, wav[i])

    # ---- model calls (on the worker thread, or in warmup), one row block
    # per replica; codes (B, T') are axis 1 of the model's (1, B, T') -------

    def _run_encode(self, x: np.ndarray):
        out = self.replicas.map(lambda m, rows: m.encode_infer(torch.from_numpy(rows)), x)
        return (np.concatenate([f.cpu().numpy() for f, _ in out]),
                np.concatenate([c.cpu().numpy() for _, c in out], axis=1))

    def _run_decode(self, x: np.ndarray) -> np.ndarray:
        out = self.replicas.map(lambda m, rows: m.decode(torch.from_numpy(rows), 0), x)
        return np.concatenate([w.cpu().numpy() for w in out])

    def _run_detok(self, codes: np.ndarray) -> np.ndarray:
        out = self.replicas.map(lambda m, rows: m.decode(
            m.codes_to_features(torch.from_numpy(rows)[None]), 0), codes)
        return np.concatenate([w.cpu().numpy() for w in out])
