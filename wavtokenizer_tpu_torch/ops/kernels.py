"""Hand-written Hopper kernels of the codec's hot ops, and their plain versions.

Four kernels, CUDA C++ for ``sm_90a`` under ``wavtokenizer_tpu_torch/csrc/``:

* ``vq_nearest`` (``csrc/vq_nearest.cu``) replaces the Pallas kernel
  ``wavtokenizer_tpu/ops/kernels.py::vq_nearest_fused``: the distance
  ``-(|x|^2 - 2 x.E^T + |E|^2)`` and its argmax in one pass, the (N, C)
  distance matrix never written out; the product is 3xTF32 ``wgmma``
  (fp32-class accuracy) with the codebook split once at model build.
* ``convnext_block`` (``csrc/convnext.cu``) replaces
  ``convnext_block_fused``: depthwise conv k7 -> (Ada)LayerNorm -> Linear ->
  exact GELU -> Linear -> layer scale -> residual, with bf16 matmul operands
  and fp32 sums, in three launches; the two GEMMs are wgmma + TMA.
* ``encoder_front`` (``csrc/encoder_front.cu``) replaces
  ``wavtokenizer_tpu/ops/encoder_front.py::encoder_front_fused``: SEANet
  encoder layers 0-6 of the small-320 geometry in one launch with every
  intermediate in shared memory: layers 0-5 as fp32 FMAs, the last conv as
  3xTF32 on the tensor cores (fp32-class accuracy).
* ``segment_sum`` (``csrc/segment_sum.cu``) replaces no Pallas kernel: the
  VQ training's k-means and EMA sums, which the JAX package takes with
  ``jax.ops.segment_sum`` (``wavtokenizer_tpu/train/vq_train.py:54,111``),
  in ascending row order per code without float atomics, so that the
  card's sums equal the CPU's bit for bit and a training step repeats.

Each source is built at first use by its own ``nvcc`` call, all started
together (the shared header ``csrc/hopper.cuh`` is part of every source's
hash), into a shared library with a plain C interface (``_build/`` next
to this package, listed in ``.gitignore``) and loaded with ``ctypes``; no
PyTorch header is compiled.

Every wrapper dispatches on the device of its input: a CPU tensor goes to
the plain PyTorch version beside it (``*_reference``, what the CPU tests
run), a CUDA tensor to the kernel, anything else raises.  There is no
fallback from the card to the plain version.  A kernel launches on its
input's card, on that card's current stream, whichever card is current
(the data-parallel engine drives several from one process).  Each wrapper
counts its kernel launches in its ``launches`` attribute, and the launches'
work (the FLOPs of the function computed, ``utils/profiling.py``) in
``flops``, under a lock (replicas launch from several threads).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import types

import torch
import torch.nn.functional as F

from ..utils.profiling import convnext_flops, front_flops, vq_flops
from .encoder_front import front_geometry_matches

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# C entry points of each source: name -> argument types (c_void_p for every
# pointer and the stream, c_int for every int).
_vp, _i = ctypes.c_void_p, ctypes.c_int
ENTRY_POINTS = {
    "vq_nearest.cu": {"wt_vq_nearest": [_vp] * 5 + [_i, _i, _i, _vp]},
    "convnext.cu": {
        "wt_convnext_dwln": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _vp],
        "wt_convnext_gemm1": [_vp, _vp, _vp, _vp, _i, _i, _i, _vp],
        "wt_convnext_gemm2": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _vp],
    },
    "encoder_front.cu": {
        "wt_encoder_front": [_vp] * 6 + [_i, _i, _vp]},
    "segment_sum.cu": {"wt_segment_sum": [_vp] * 4 + [_i, _i, _vp]},
}

_lib = None
_lib_lock = threading.Lock()   # the first build may run on a worker thread
_count_lock = threading.Lock()
build_seconds = None   # wall time of the nvcc calls that built the libraries


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of wavtokenizer_tpu_torch cannot be built")
    return found


def _so_path(source: str) -> str:
    """The library of one source, named by the hash of the source and of
    every shared header beside it, so that an edit to either rebuilds it."""
    h = hashlib.sha256()
    for name in [source] + sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh")):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{source[:-3]}_{digest}.so")


def load_library() -> types.SimpleNamespace:
    """Build (once per source content) and load the kernels' libraries.

    One ``nvcc`` per source, all started together, each into its own shared
    library keyed by the source's hash; returns a namespace of the C entry
    points."""
    global _lib, build_seconds
    with _lib_lock:
        if _lib is not None:
            return _lib
        sos = {s: _so_path(s) for s in ENTRY_POINTS}
        todo = {s: so for s, so in sos.items() if not os.path.exists(so)}
        if todo:
            os.makedirs(BUILD_DIR, exist_ok=True)
            nvcc = _nvcc()
            t0 = time.perf_counter()
            procs = {s: (so, subprocess.Popen(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                 f"{so}.{os.getpid()}.tmp", os.path.join(CSRC, s)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
                for s, so in todo.items()}
            errors = []
            for s, (so, proc) in procs.items():
                _, err = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"nvcc {s} failed ({proc.returncode}):\n{err}")
                else:
                    os.replace(f"{so}.{os.getpid()}.tmp", so)
            build_seconds = time.perf_counter() - t0
            if errors:
                raise RuntimeError("\n".join(errors))
        lib = types.SimpleNamespace()
        for source, entries in ENTRY_POINTS.items():
            cdll = ctypes.CDLL(sos[source])
            for name, argtypes in entries.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(lib, name, fn)
        _lib = lib
        return lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
             device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _count(wrapper, flops: int) -> None:
    with _count_lock:
        wrapper.launches += 1
        wrapper.flops += flops


def _dispatch(x: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device {x.device}")


# ---------------------------------------------------------------------------
# VQ nearest-code search
# ---------------------------------------------------------------------------

def vq_nearest_reference(x: torch.Tensor, embed: torch.Tensor,
                         esq: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: fp32 matmul distance and argmax (first index on ties).

    Full fp32 only with ``torch.backends.cuda.matmul.allow_tf32`` off, which
    is PyTorch's default and what the encode path sets."""
    x = x.float()
    e = embed.float()
    xsq = (x * x).sum(1, keepdim=True)
    if esq is None:
        esq = (e * e).sum(1)
    dist = -(xsq - 2.0 * (x @ e.t()) + esq[None, :])
    return dist.argmax(1).to(torch.int32)


def _tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), half away from
    zero: half a TF32 ulp added to the bits, the 13 low bits cleared, as the
    kernel does it."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_vq_codebook(embed: torch.Tensor) -> torch.Tensor:
    """embed (C, D) -> (2, C, D) f32: the kernel's B operand, the codebook's
    TF32 head ``hi`` and tail ``lo = tf32(e - hi)``, so e = hi + lo to
    ~2^-22 relative.  Made once when the model is built."""
    hi = _tf32_round(embed)
    return torch.stack([hi, _tf32_round(embed.float() - hi)])


def vq_nearest(x: torch.Tensor, embed: torch.Tensor, esq: torch.Tensor | None = None,
               pack: torch.Tensor | None = None) -> torch.Tensor:
    """x (N, D) f32, embed (C, D) f32 -> (N,) int32 nearest-code ids.

    ``esq`` (C,) = |E|^2 per code, computed here when not given (the JAX
    wrapper computes it outside its kernel too).  On the card the kernel
    reads the codebook as ``pack`` = ``pack_vq_codebook(embed)``; the model
    makes it when it is built, and a caller without it gets it here, per
    call.  The kernel needs D > 0 and D % 4 == 0 (TMA's 16-byte row
    stride)."""
    if not _dispatch(x, "vq_nearest"):
        return vq_nearest_reference(x, embed, esq)
    N, D = x.shape
    C = embed.shape[0]
    if D % 4 or D == 0 or C == 0:
        raise ValueError(f"vq_nearest kernel needs D % 4 == 0 and D, C > 0; got D={D}, C={C}")
    if esq is None:
        esq = (embed * embed).sum(1)
    if pack is None:
        pack = pack_vq_codebook(embed)
    _require(x, "x", torch.float32, (N, D), x.device)
    _require(embed, "embed", torch.float32, (C, D), x.device)
    _require(esq, "esq", torch.float32, (C,), x.device)
    _require(pack, "pack", torch.float32, (2, C, D), x.device)
    out = torch.empty(N, dtype=torch.int32, device=x.device)
    if N == 0:
        return out
    keys = torch.empty(N, dtype=torch.int64, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.wt_vq_nearest(x.data_ptr(), pack.data_ptr(), esq.data_ptr(), keys.data_ptr(),
                               out.data_ptr(), N, C, D, _stream(x.device))
    _count(vq_nearest, vq_flops(N, C, D))
    _check(rc, "vq_nearest")
    return out


vq_nearest.launches = 0
vq_nearest.flops = 0


# ---------------------------------------------------------------------------
# ConvNeXt block
# ---------------------------------------------------------------------------

def pack_convnext_weights(w1: torch.Tensor, w2: torch.Tensor) -> tuple:
    """w1 (C, I), w2 (I, C) -> the kernel's K-major B operands (w1^T (I, C),
    w2^T (C, I)), contiguous, in the weights' own type."""
    return w1.t().contiguous(), w2.t().contiguous()


def convnext_block_reference(x, dw, dwb, scale, shift, w1, b1, w2, b2, gamma,
                             residual=None):
    """Plain version of the block with the kernel's rounding: the matmul
    operands rounded to bf16, the products summed in fp32.

    x (B, T, C) f32; dw (7, C); dwb, scale, shift, b2, gamma (C,);
    w1 (C, I), w2 (I, C) (any float type, rounded to bf16); b1 (I,).
    ``residual`` (B, T, C), x when not given, is what the layer-scaled
    update is added to."""
    B, T, C = x.shape
    h = F.conv1d(x.transpose(1, 2), dw.t().unsqueeze(1), dwb, padding=3,
                 groups=C).transpose(1, 2)
    h = F.layer_norm(h, (C,), eps=1e-6) * scale + shift
    bf = lambda t: t.to(torch.bfloat16).float()
    g = F.gelu(bf(h) @ bf(w1) + b1)
    y = bf(g) @ bf(w2) + b2
    return (x if residual is None else residual) + gamma * y


def check_convnext_widths(C: int, I: int) -> None:
    """Raise ``ValueError`` unless the kernel takes channels C and hidden
    width I (a tensor-parallel shard's I included): C <= 1024 (one warp
    holds a row in dw+LN) and C, I multiples of 32.  The GEMMs' 128-wide
    tiles need no more: TMA zero-fills a ragged last K block and the
    epilogue masks a ragged last N tile."""
    if C > 1024 or C % 32 or I % 32:
        raise ValueError(f"convnext_block kernel needs C <= 1024 and C, I "
                         f"multiples of 32; got C={C}, I={I}")


def convnext_block(x, dw, dwb, scale, shift, w1, b1, w2, b2, gamma,
                   w1t=None, w2t=None, residual=None):
    """One ConvNeXt block, arguments as in ``convnext_block_reference``.

    On the card ``w1``/``w2`` must already be bf16 (the model stores them
    so) and every other argument f32, all contiguous.  The kernel's GEMMs
    read their weights K-major, as ``w1t`` = w1^T (I, C) and ``w2t`` = w2^T
    (C, I); the model packs them once when it is built
    (``pack_convnext_weights``), and a caller without them gets them
    transposed here, per call.  ``residual`` goes to the second GEMM's
    epilogue in x's place (a tensor-parallel shard after the first passes
    zeros there and for b2, so that the shards' outputs sum to the block's)."""
    if not _dispatch(x, "convnext_block"):
        return convnext_block_reference(x, dw, dwb, scale, shift, w1, b1, w2,
                                        b2, gamma, residual)
    B, T, C = x.shape
    I = w1.shape[1]
    dev = x.device
    check_convnext_widths(C, I)
    f32, bf16 = torch.float32, torch.bfloat16
    _require(x, "x", f32, (B, T, C), dev)
    if residual is None:
        residual = x
    _require(residual, "residual", f32, (B, T, C), dev)
    _require(dw, "dw", f32, (7, C), dev)
    for name, t in (("dwb", dwb), ("scale", scale), ("shift", shift),
                    ("b2", b2), ("gamma", gamma)):
        _require(t, name, f32, (C,), dev)
    _require(w1, "w1", bf16, (C, I), dev)
    _require(b1, "b1", f32, (I,), dev)
    _require(w2, "w2", bf16, (I, C), dev)
    if w1t is None or w2t is None:
        w1t, w2t = pack_convnext_weights(w1, w2)
    _require(w1t, "w1t", bf16, (I, C), dev)
    _require(w2t, "w2t", bf16, (C, I), dev)
    M = B * T
    h = torch.empty((M, C), dtype=bf16, device=dev)
    g = torch.empty((M, I), dtype=bf16, device=dev)
    out = torch.empty_like(x)
    if M == 0:
        return out
    lib = load_library()
    s = _stream(dev)
    with torch.cuda.device(dev):
        _check(lib.wt_convnext_dwln(x.data_ptr(), dw.data_ptr(), dwb.data_ptr(),
                                    scale.data_ptr(), shift.data_ptr(),
                                    h.data_ptr(), B, T, C, s), "convnext dwln")
        _check(lib.wt_convnext_gemm1(h.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
                                     g.data_ptr(), M, C, I, s), "convnext gemm1")
        _check(lib.wt_convnext_gemm2(g.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
                                     gamma.data_ptr(), residual.data_ptr(),
                                     out.data_ptr(), M, I, C, s), "convnext gemm2")
    _count(convnext_block, convnext_flops(M, C, I))
    return out


convnext_block.launches = 0
convnext_block.flops = 0


# ---------------------------------------------------------------------------
# SEANet encoder front (layers 0-6)
# ---------------------------------------------------------------------------

def encoder_front_reference(audio: torch.Tensor, params: list, specs: list) -> torch.Tensor:
    """Plain version: the port's own encoder layers 0-6 (``_apply_layer``).

    cuDNN fp32 on the card only with ``torch.backends.cudnn.allow_tf32``
    off, which the encode path sets (``models/wavtokenizer.py::full_fp32``)."""
    # Imported here: models/seanet.py imports this module.
    from ..models.seanet import _plain_front
    return _plain_front(params, specs, audio)


def encoder_front(audio: torch.Tensor, params: list, specs: list) -> torch.Tensor:
    """audio (B, T, 1) f32 -> (B, T/8, 128) f32: encoder layers 0-6.

    ``params``/``specs`` are the encoder's layer params and specs; on the
    card the kernel takes the packed weights ``params[0]["front"]``
    (``ops/encoder_front.py::prepare_front_weights``, made when the model is
    built) and needs ``front_geometry_matches``."""
    if not _dispatch(audio, "encoder_front"):
        return encoder_front_reference(audio, params, specs)
    B, T, _ = audio.shape
    if not front_geometry_matches(specs, params, T):
        raise ValueError(f"encoder_front kernel: geometry or length T={T} not "
                         "served (front_geometry_matches is False)")
    pack = params[0].get("front")
    if pack is None:
        raise ValueError("encoder_front kernel: params[0] has no 'front' weight "
                         "pack (build the model with api.pretrained)")
    dev, f32 = audio.device, torch.float32
    _require(audio, "audio", f32, (B, T, 1), dev)
    _require(pack["a"], "front a", f32, (11664,), dev)
    _require(pack["b"], "front b", f32, (12448,), dev)
    _require(pack["wd"], "front wd", f32, (512, 128), dev)
    _require(pack["bd"], "front bd", f32, (128,), dev)
    out = torch.empty((B, T // 8, 128), dtype=f32, device=dev)
    if B == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.wt_encoder_front(audio.data_ptr(), pack["a"].data_ptr(),
                                  pack["b"].data_ptr(), pack["wd"].data_ptr(),
                                  pack["bd"].data_ptr(), out.data_ptr(), B, T, _stream(dev))
    _count(encoder_front, front_flops(B * T))
    _check(rc, "encoder_front")
    return out


encoder_front.launches = 0
encoder_front.flops = 0

# ---------------------------------------------------------------------------
# Segment sum (the VQ's training statistics)
# ---------------------------------------------------------------------------

def segment_sum_reference(rows: torch.Tensor, ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Plain version: ``index_add_`` into zeros.  On the CPU it adds each
    row in ascending row order, as XLA:CPU's scatter does; on CUDA it lowers
    to float atomics, whose order changes from run to run."""
    out = torch.zeros(num_segments, rows.shape[1], dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, ids, rows)


def segment_order(ids: torch.Tensor, num_segments: int,
                  counts: torch.Tensor | None = None) -> tuple:
    """The kernel's order of the rows: (perm (N,) int32, offsets (C + 1,)
    int32), code c's rows being ``perm[offsets[c]:offsets[c + 1]]`` in
    ascending row order.  ``perm`` is a stable sort by id (a unique
    permutation); ``offsets`` the prefix sum of ``counts``, the ids'
    ``bincount(minlength=C)`` (computed here when not given), all integer."""
    if counts is None:
        counts = torch.bincount(ids, minlength=num_segments)
    if counts.shape != (num_segments,):
        raise ValueError(f"segment_sum: ids reach {counts.shape[0]} segments, more than "
                         f"num_segments={num_segments}")
    perm = torch.sort(ids, stable=True).indices.to(torch.int32)
    offsets = torch.zeros(num_segments + 1, dtype=torch.int32, device=ids.device)
    offsets[1:] = counts.cumsum(0)
    return perm, offsets


def segment_sum(rows: torch.Tensor, ids: torch.Tensor, num_segments: int,
                counts: torch.Tensor | None = None) -> torch.Tensor:
    """rows (N, D) f32, ids (N,) integer in [0, num_segments) -> (C, D) f32:
    the sum of each segment's rows, in ascending row order from +0.0.

    ``counts``: the ids' ``bincount(minlength=num_segments)``, where the
    caller has it already.  On the card the same inputs give the CPU's sums
    bit for bit, on every launch."""
    if not _dispatch(rows, "segment_sum"):
        return segment_sum_reference(rows, ids, num_segments)
    N, D = rows.shape
    dev = rows.device
    _require(rows, "rows", torch.float32, (N, D), dev)
    if ids.device != dev or ids.shape != (N,) or ids.dtype.is_floating_point:
        raise ValueError(f"ids must be an integer (N,) = ({N},) tensor on {dev}; got "
                         f"{ids.dtype} {tuple(ids.shape)} on {ids.device}")
    if (num_segments + 15) // 16 > 65535:
        raise ValueError(f"segment_sum kernel takes at most 1048560 segments; got {num_segments}")
    out = torch.empty((num_segments, D), dtype=torch.float32, device=dev)
    if num_segments == 0 or D == 0:
        return out
    if N == 0:
        return out.zero_()
    perm, offsets = segment_order(ids, num_segments, counts)
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.wt_segment_sum(rows.data_ptr(), perm.data_ptr(), offsets.data_ptr(),
                                out.data_ptr(), num_segments, D, _stream(dev))
    # No work counted: FlopCounterMode counts none for the plain index_add_.
    _count(segment_sum, 0)
    _check(rc, "segment_sum")
    return out


segment_sum.launches = 0
segment_sum.flops = 0

WRAPPERS = (vq_nearest, convnext_block, encoder_front, segment_sum)


def reset_launch_counts() -> None:
    """Every wrapper's launches and their work back to 0."""
    for w in WRAPPERS:
        w.launches = 0
        w.flops = 0


def launched_flops() -> int:
    """The work of the kernel launches since the last reset."""
    return sum(w.flops for w in WRAPPERS)
