"""Golden tokens: the committed token ids of a seeded clip per config.

This package's copy of the geometry of ``wavtokenizer_tpu/utils/golden.py``:
batch 8, 3 s, the clip ``np.random.default_rng(0).normal(size=(8, T)) * 0.1``,
weights ``init_wavtokenizer(spec, seed=0, random_codebook=True)``.  The ids
in ``tests/golden/bench_tokens.npz`` were computed by the JAX package on
XLA:CPU; since the numpy init draws the same weights here, this package's
codes are held against the same file, anywhere, without JAX.

The tolerance is the one the JAX package's benchmark uses on its chip,
``max(2, n // 400)`` differing ids, with 0 as the goal: a backend that sums
in another order may flip a genuine near-tie between two codes.

The API is the JAX module's (``compute_codes``, ``write_golden``,
``load_golden``, ``check_codes``) with the device named: the codes are
this package's, computed on ``device`` (the card by default), so a run
gates its own tokens against the committed file with no JAX anywhere.
``write_golden`` never writes the committed file: its ids come from the
JAX package on XLA:CPU (``tools_tpu/make_golden_tokens.py``), where parity
with the reference is proven, and stay the contract.

The random weights send almost every frame of the clip to one code (the
small-320 ids are all 573), so the golden ids cannot tell a nearest-code
search that loses precision from one that keeps it.  ``near_tie_rows``
makes rows that can: each has one right answer, only just beyond the
near-tie tolerance.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..api.pretrained import WavTokenizer
from ..models.init import init_wavtokenizer
from ..models.seanet import SEANetConfig
from ..models.vocos import ISTFTHeadConfig
from ..models.wavtokenizer import WavTokenizerSpec

GOLDEN_BATCH = 8
GOLDEN_SECONDS = 3.0


def golden_path() -> str:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(repo, "tests", "golden", "bench_tokens.npz")


def golden_specs() -> dict:
    """label -> WavTokenizerSpec of every golden config."""
    return {
        "small320": WavTokenizerSpec(),
        "small600": WavTokenizerSpec(seanet=SEANetConfig(ratios=(6, 5, 5, 4)),
                                     head=ISTFTHeadConfig(n_fft=2400, hop_length=600)),
        "music16k": WavTokenizerSpec(sample_rate=16000),
    }


def golden_clip(spec: WavTokenizerSpec) -> np.ndarray:
    """The seeded (GOLDEN_BATCH, T) float32 clip."""
    T = int(spec.sample_rate * GOLDEN_SECONDS)
    rng = np.random.default_rng(0)
    return rng.normal(size=(GOLDEN_BATCH, T)).astype(np.float32) * 0.1


def compute_codes(spec: WavTokenizerSpec, device="cuda") -> np.ndarray:
    """Token ids (1, GOLDEN_BATCH, T') of the seeded golden clip through
    ``WavTokenizer.encode_infer`` on ``device``, weights
    ``init_wavtokenizer(spec, seed=0, random_codebook=True)``."""
    model = WavTokenizer.from_jax_params(init_wavtokenizer(spec, seed=0, random_codebook=True),
                                         spec, device=device)
    _, codes = model.encode_infer(golden_clip(spec))
    return codes.cpu().numpy()


def write_golden(path: str, device="cuda") -> str:
    """Every golden config's codes on ``device`` into ``path`` (npz, int32).
    Refuses the committed file, which holds the JAX package's ids."""
    if os.path.realpath(path) == os.path.realpath(golden_path()):
        raise ValueError(f"{path} is the committed golden file, written by the JAX package on "
                         "XLA:CPU (tools_tpu/make_golden_tokens.py); write elsewhere")
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **{label: compute_codes(spec, device).astype(np.int32)
                      for label, spec in golden_specs().items()})
    return path


def load_golden(path: str | None = None) -> dict:
    with np.load(path or golden_path()) as z:
        return {k: z[k] for k in z.files}


def check_codes(label: str, path: str | None = None, max_flips: int = 0,
                device="cuda") -> int:
    """Recompute ``label``'s codes on ``device``, compare them with the
    golden file's (``path``, default the committed one) and return the
    number of differing ids.

    Raises ``RuntimeError`` when the shapes differ or more than
    ``max_flips`` ids do (a run must stop rather than report on wrong
    tokens), ``KeyError`` for a label the file lacks.  0, the default, is
    the goal; a device that sums in another order passes the module-level
    ``max_flips(n)`` here."""
    golden = load_golden(path)
    if label not in golden:
        raise KeyError(f"no golden tokens for config {label!r} in {path or golden_path()}")
    got = compute_codes(golden_specs()[label], device)
    want = golden[label]
    n_bad = int(np.sum(got != want)) if got.shape == want.shape else -1
    if got.shape != want.shape or n_bad > max_flips:
        raise RuntimeError(
            f"GOLDEN TOKEN MISMATCH for {label} on {device}: shape {got.shape} vs "
            f"{want.shape}, {n_bad} differing ids (allowed {max_flips}): the encode path "
            "no longer gives the committed tokens")
    return n_bad


def max_flips(n_ids: int) -> int:
    """Differing ids allowed among ``n_ids`` (the JAX bench's bench.py:91)."""
    return max(2, n_ids // 400)


def nearest_two(x: torch.Tensor, embed: torch.Tensor, k: int = 8) -> tuple:
    """Each row's two nearest codes (N, 2) and their squared distances in
    float64 (N, 2), the candidates taken from an fp32 search of the k nearest."""
    d32 = (x * x).sum(1, keepdim=True) - 2 * x @ embed.t() + (embed * embed).sum(1)
    near = d32.topk(min(k, embed.shape[0]), dim=1, largest=False).indices
    exact = ((x.double()[:, None, :] - embed.double()[near]) ** 2).sum(-1)
    exact, order = exact.sort(dim=1)
    return near.gather(1, order[:, :2]), exact[:, :2]


def near_tie_rows(embed: torch.Tensor, n: int, lo: float = 1.2e-5, hi: float = 2.4e-5,
                  seed: int = 0) -> torch.Tensor:
    """(n, D) f32 rows that hold a nearest-code search to a known resolution.

    Each row starts at the midpoint of two random codes plus noise as large
    as a code, and is moved along the line between its two nearest codes
    until the farther lies ``lo``..``hi`` (log-spaced over the rows) farther
    than the nearer, relative to the nearer's distance.  With ``lo`` above
    the near-tie tolerance (1e-5), no row may flip: a search whose distances
    err by less than ``lo`` gets every row right, one that drops the TF32
    tail of an operand (~2^-12 relative per element) does not."""
    C, D = embed.shape
    dev = embed.device
    g = torch.Generator().manual_seed(seed)
    pair = torch.randint(0, C, (n, 2), generator=g).to(dev)
    noise = torch.randn(n, D, generator=g, dtype=torch.float64).to(dev)
    e64 = embed.double()
    x = ((e64[pair[:, 0]] + e64[pair[:, 1]]) / 2
         + noise * e64.norm(dim=1).mean() / math.sqrt(D)).float()
    gaps = torch.logspace(math.log10(lo), math.log10(hi), n, dtype=torch.float64,
                          device=dev)
    for _ in range(2):   # the second step corrects for the nearer distance's own move
        idx, d = nearest_two(x, embed)
        ea, eb = e64[idx[:, 0]], e64[idx[:, 1]]
        s = (d[:, 1] - d[:, 0] - gaps * d[:, 0]) / (2 * ((ea - eb) ** 2).sum(1))
        x = (x.double() + s[:, None] * (eb - ea)).float()
    return x
