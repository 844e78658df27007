"""Profiling: stage timings, FLOP counts, the card's peaks and the kernels'
bounds.

Port of ``wavtokenizer_tpu/utils/profiling.py``:

* ``stage_timings`` times each ``name -> (fn, args)`` stage: CUDA events
  around ``iters`` calls on the card (a host clock on the CPU), the best of
  ``repeats``.
* ``stage_flops`` counts each stage's floating-point operations:
  ``torch.utils.flop_counter.FlopCounterMode`` for what PyTorch runs, plus
  each hand-written kernel's work from its shapes (the kernels are ``ctypes``
  launches, which the counter does not see).  The kernels' work is counted
  as the multiply-adds of the function they compute, whatever route computes
  it (the VQ kernel's 3xTF32 products count once), and equals what the
  counter counts for their plain versions, so a stage counts the same on
  the card as on the CPU.
* ``PEAKS`` and ``device_peak_flops``: the data-sheet peaks of the card
  (FLOP/s per precision, HBM bytes/s), keyed by
  ``torch.cuda.get_device_name()``.
* ``vq_bound_of``, ``convnext_bound``, ``front_bound_of``,
  ``segment_sum_bound``: the least time of one kernel call on the card, the larger of its operations over the peak of
  their type and its bytes (each input read once, each output written once)
  over the memory rate.
* ``pipeline_stages``: the codec's stages (encoder, VQ, backbone, head and
  the totals) as a stage map.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch

# Data-sheet peaks of one card, dense (no sparsity), at its full power limit
# (NVIDIA's H100 SXM data sheet: 700 W): FLOP/s per precision and the HBM rate
# in bytes/s.  "3xtf32" is a TF32 tensor-core rate shared by the three TF32
# products with which the VQ and front kernels reach fp32-class products.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12,
                              "bytes": 3.35e12},
}
H100 = PEAKS["NVIDIA H100 80GB HBM3"]

# Multiply-adds per audio sample of the encoder front (small-320's layers
# 0-6): conv0 224, resblock 32 3072, down k4 s2 4096, resblock 64 6144 (fp32
# FMAs on the CUDA cores), and down k8 s4 8192 (3xTF32 on the tensor cores).
FRONT_FP32_MACS_PER_SAMPLE = 224 + 3072 + 4096 + 6144
FRONT_TF32_MACS_PER_SAMPLE = 8192


def device_peaks(name: str | None = None) -> dict | None:
    """The peaks of the card named ``name`` (default: CUDA device 0), or
    None for a card the table does not hold (or no card)."""
    if name is None:
        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(0)
    return PEAKS.get(name)


def device_peak_flops(precision: str = "bf16", name: str | None = None) -> float | None:
    """Peak FLOP/s of the card in ``precision`` ("fp32", "tf32", "3xtf32",
    "bf16"), None where unknown."""
    peaks = device_peaks(name)
    if peaks is None:
        return None
    if precision == "3xtf32":
        return peaks["tf32"] / 3
    return peaks[precision]


# ---------------------------------------------------------------------------
# The kernels' work and bounds
# ---------------------------------------------------------------------------

def vq_flops(N: int, C: int, D: int) -> int:
    """One nearest-code search of N rows over C codes of dim D: the x.E^T
    products (the plain version's one matmul)."""
    return 2 * N * C * D


def convnext_flops(M: int, C: int, I: int) -> int:
    """One ConvNeXt block over M rows: the two GEMMs (4 M C I) and the
    depthwise conv k7 (14 M C)."""
    return 4 * M * C * I + 14 * M * C


def front_flops(S: int) -> int:
    """The encoder front over S audio samples (T % 8 == 0): layers 0-6's
    convs."""
    return 2 * (FRONT_FP32_MACS_PER_SAMPLE + FRONT_TF32_MACS_PER_SAMPLE) * S


def _bound(ops_s: float, bytes_s: float) -> tuple:
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s > bytes_s else "bytes"


def vq_bound_of(N: int, C: int, D: int, peaks: dict = H100) -> tuple:
    """(least ms, "operations" or "bytes") of one VQ search: the products as
    3xTF32 on the tensor cores (three TF32 products per multiply-add, the
    kernel's route to fp32-class accuracy), or the bytes (x, the split
    codebook, |E|^2 read once, the ids written once)."""
    return _bound(3 * vq_flops(N, C, D) / peaks["tf32"],
                  (N * D * 4 + 2 * C * D * 4 + C * 4 + N * 4) / peaks["bytes"])


def convnext_bound(M: int, C: int, I: int, peaks: dict = H100) -> tuple:
    """(least ms, bound) of one ConvNeXt block over M rows: the two GEMMs'
    bf16 products and the dw conv/LayerNorm/GELU/residual work in fp32,
    against each input read once and the output written once."""
    return _bound(4 * M * C * I / peaks["bf16"] + 14 * M * C / peaks["fp32"],
                  (2 * M * C * 4 + 2 * C * I * 2 + (13 * C + I) * 4) / peaks["bytes"])


def front_bound_of(S: int, pack: dict, peaks: dict = H100) -> tuple:
    """(least ms, bound) of the encoder front over S audio samples: the CUDA
    cores and the tensor cores can run at once, so the operations' time is
    the larger of the two units' times; the bytes are the audio read once,
    the (S/8, 128) output written once and the weight pack read once."""
    ops_s = max(2 * FRONT_FP32_MACS_PER_SAMPLE * S / peaks["fp32"],
                3 * 2 * FRONT_TF32_MACS_PER_SAMPLE * S / peaks["tf32"])
    n_weights = sum(t.numel() for t in pack.values())
    return _bound(ops_s, (S * 4 + S // 8 * 128 * 4 + n_weights * 4) / peaks["bytes"])


def segment_sum_bound(N: int, C: int, D: int, peaks: dict = H100) -> tuple:
    """(least ms, bound) of one segment sum of N rows of D into C codes: the
    N D fp32 adds, against the rows (f32) and ids (int64) read once and the
    (C, D) sums written once."""
    return _bound(N * D / peaks["fp32"], (N * D * 4 + N * 8 + C * D * 4) / peaks["bytes"])


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------

def _device_of(args) -> torch.device:
    """The device of the first tensor in ``args`` (nested lists and dicts)."""
    stack = list(args)
    while stack:
        a = stack.pop(0)
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, dict):
            stack.extend(a.values())
        elif isinstance(a, (list, tuple)):
            stack.extend(a)
    return torch.device("cpu")


def stage_timings(stages: dict[str, tuple[Callable, tuple]], iters: int = 20,
                  repeats: int = 3) -> dict[str, float]:
    """ms per call of each ``name -> (fn, args)`` stage, the best of
    ``repeats`` runs of ``iters`` calls after one warm-up call: CUDA events
    on the card (where the stage's first tensor argument lies), a host clock
    after the calls on the CPU."""
    out = {}
    with torch.inference_mode():
        for name, (fn, args) in stages.items():
            cuda = _device_of(args).type == "cuda"
            fn(*args)
            best = float("inf")
            for _ in range(repeats):
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    start.record()
                    for _ in range(iters):
                        fn(*args)
                    end.record()
                    torch.cuda.synchronize()
                    ms = start.elapsed_time(end) / iters
                else:
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        fn(*args)
                    ms = (time.perf_counter() - t0) * 1e3 / iters
                best = min(best, ms)
            out[name] = best
    return out


def _lstm_flops(input, hx, params, *args, out_shape=None, **kwargs) -> int:
    """``aten.lstm``'s matmuls (``FlopCounterMode`` has no formula for it):
    per time step and row, each layer's input and recurrent products, 2 x
    4H x (I + H); ``params`` are the weights' shapes, the biases 1-D."""
    steps = input[0] * input[1]
    return 2 * steps * sum(s[0] * s[1] for s in params if len(s) == 2)


def stage_flops(stages: dict[str, tuple[Callable, tuple]]) -> dict[str, float]:
    """FLOPs of one call of each stage: what ``FlopCounterMode`` counts (the
    matmuls and convolutions PyTorch runs, and the LSTM's products) plus the
    work of each kernel launch (the wrappers' ``flops``, from the launch's
    shapes)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops import kernels

    out = {}
    with torch.inference_mode():
        for name, (fn, args) in stages.items():
            kernels.reset_launch_counts()
            # The counter looks an op up by its overload (one it does not
            # find, it decomposes: the LSTM into backend RNN calls it cannot
            # count) and counts it under its packet: the formula under both.
            counter = FlopCounterMode(display=False,
                                      custom_mapping={torch.ops.aten.lstm: _lstm_flops,
                                                      torch.ops.aten.lstm.input: _lstm_flops})
            with counter:
                fn(*args)
            out[name] = float(counter.get_total_flops() + kernels.launched_flops())
    return out


# Each stage's arithmetic, for its MFU: the encoder runs fp32 with TF32 off
# (its front kernel's last conv 3xTF32), the VQ 3xTF32, the backbone's
# ConvNeXt GEMMs (two thirds of its FLOPs at small-320) bf16 and the rest of
# it fp32, the head fp32.  The totals mix them and have no one peak.
STAGE_PRECISION = {"encoder": "fp32", "vq": "3xtf32", "backbone": "bf16", "head": "fp32"}


def pipeline_stages(params: dict, spec, audio: torch.Tensor) -> dict:
    """The codec's stage map (``params`` as ``WavTokenizer.params``, audio
    (B, T) on their device): encoder, vq, backbone, head, encode_total,
    decode_total and roundtrip, each ``(fn, args)``; the encoder and VQ in
    true fp32 (``full_fp32``), as ``encode_infer`` runs them."""
    from ..models import wavtokenizer as wt
    from ..models.quantize import vq_infer
    from ..models.seanet import seanet_encode
    from ..models.vocos import istft_head, vocos_backbone

    def encoder(p, a):
        with wt.full_fp32():
            return seanet_encode(p["encoder"], spec.seanet, a[:, :, None])

    def vq(p, e):
        with wt.full_fp32():
            return vq_infer(p["quantizer"], e)[1]

    def backbone(p, f):
        return vocos_backbone(p["backbone"], spec.backbone, f.transpose(1, 2), bandwidth_id=0)

    def head(p, h):
        return istft_head(p["head"], spec.head, h)

    def roundtrip(p, a):
        return wt.decode(p, spec, wt.encode_infer(p, spec, a)[0], 0)

    with torch.inference_mode():
        emb = encoder(params, audio)
        feats = wt.encode_infer(params, spec, audio)[0]
        hidden = backbone(params, feats)
    return {
        "encoder": (encoder, (params, audio)),
        "vq": (vq, (params, emb)),
        "backbone": (backbone, (params, feats)),
        "head": (head, (params, hidden)),
        "encode_total": (lambda p, a: wt.encode_infer(p, spec, a), (params, audio)),
        "decode_total": (lambda p, f: wt.decode(p, spec, f, 0), (params, feats)),
        "roundtrip": (roundtrip, (params, audio)),
    }


@contextlib.contextmanager
def torch_trace(logdir: str):
    """A ``torch.profiler`` trace of the block (CPU and, on a card, CUDA
    activity), written to ``logdir`` as a Chrome/Perfetto trace file."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
