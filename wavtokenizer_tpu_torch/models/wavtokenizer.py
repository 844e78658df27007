"""Full WavTokenizer round trip: SEANet encoder -> VQ -> Vocos backbone ->
ISTFT head, the training-style encode, and the SEANet-only decode.

Port of ``wavtokenizer_tpu/models/wavtokenizer.py`` (ref
decoder/feature_extractors.py:131-142, decoder/pretrained.py:192-239).  The
layouts at the boundary are the JAX package's: audio (B, T), features
(B, D, T'), codes (K, B, T') int32.  Channel-last inside.
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass

import torch

from .quantize import (VQConfig, codes_to_features as _codes_to_features,
                       vq_forward_language, vq_infer)
from .seanet import SEANetConfig, seanet_decode, seanet_encode
from .vocos import ISTFTHeadConfig, VocosBackboneConfig, istft_head, vocos_backbone


@dataclass(frozen=True)
class WavTokenizerSpec:
    seanet: SEANetConfig = SEANetConfig()
    vq: VQConfig = VQConfig()
    backbone: VocosBackboneConfig = VocosBackboneConfig()
    head: ISTFTHeadConfig = ISTFTHeadConfig()
    bandwidths: tuple = (6.6, 6.6, 6.6, 6.6)
    sample_rate: int = 24000

    @property
    def hop_length(self) -> int:
        return self.seanet.hop_length

    @property
    def frame_rate(self) -> int:
        return math.ceil(self.sample_rate / self.hop_length)


class _SharedFlags:
    """Process-global backend flags, set for the callers inside a ``with``
    and back to the callers' settings once the last one has left.

    Concurrent callers (a serving engine's worker beside direct callers, a
    training loop beside an encode) share one depth count under a lock: the
    first to enter saves the flags and sets them, the last to leave restores
    them.  Saving and restoring per caller would let one thread restore a
    flag while another is still inside."""

    def __init__(self, *settings):
        self._settings = settings      # (namespace, attribute, value) each
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    @contextlib.contextmanager
    def __call__(self):
        with self._lock:
            if self._depth == 0:
                self._saved = [getattr(ns, name) for ns, name, _ in self._settings]
                for ns, name, value in self._settings:
                    setattr(ns, name, value)
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    for (ns, name, _), value in zip(self._settings, self._saved):
                        setattr(ns, name, value)


_TF32_OFF = _SharedFlags((torch.backends.cudnn, "allow_tf32", False),
                         (torch.backends.cuda.matmul, "allow_tf32", False))
_REPEATABLE = _SharedFlags((torch.backends.cudnn, "deterministic", True),
                           (torch.backends.cudnn, "benchmark", False))


def full_fp32():
    """TF32 off for both cuBLAS matmuls and cuDNN (convolutions, LSTM), and
    back to the callers' settings once the last caller has left.

    PyTorch leaves ``torch.backends.cudnn.allow_tf32`` on by default, so an
    fp32 conv on the card keeps only ~10 mantissa bits; in the encoder that
    moves the embedding enough to flip tokens near a Voronoi boundary (the
    same trap flipped 23/960 small600 tokens on the TPU before its encoder
    convs were pinned to fp32-equivalent precision).

    The flags are process-global, so concurrent callers share one depth
    count (``_SharedFlags``)."""
    return _TF32_OFF()


def repeatable_steps():
    """cuDNN's deterministic algorithms (``cudnn.deterministic`` on,
    ``cudnn.benchmark`` off) for the training steps inside, and back to the
    callers' settings once the last caller has left; TF32 is left as it is.

    The JAX step is one XLA program and repeats run for run.  On the card a
    step repeats bit for bit only when no kernel sums in an order that
    changes from run to run: the port's own sums do without float atomics
    (the VQ's segment sums, the STFT's backward), and cuDNN's deterministic
    algorithms cover its convolutions' and LSTM's backward.  Without them
    two runs from one seed differ by ~1e-7 in the gradients from the first
    step on, and VQ near-ties turn that into other codes.  Every trainer
    (``train/trainer.py::Trainer.fit``, ``tools/enhance_train.py``,
    ``tools/byol_train.py``) runs its steps inside; there is no switch, as
    the JAX step has none.

    ``torch.use_deterministic_algorithms`` is not set: the steps repeat
    without it, and it raises on ops that have no deterministic form.
    The flags are process-global: concurrent callers share one depth count
    (``_SharedFlags``)."""
    return _REPEATABLE()


@torch.inference_mode()
def encode_infer(params: dict, spec: WavTokenizerSpec, audio: torch.Tensor):
    """Tokenize: audio (B, T) -> (features (B, D, T'), codes (1, B, T') int32).

    Runs in true fp32 (``full_fp32``): the tokens are the contract."""
    with full_fp32():
        emb = seanet_encode(params["encoder"], spec.seanet, audio[:, :, None])
        quantized, codes = vq_infer(params["quantizer"], emb)
    return quantized.transpose(1, 2), codes


@torch.inference_mode()
def encode_forward(params: dict, spec: WavTokenizerSpec, audio: torch.Tensor,
                   n_q: int | None = None):
    """Eval-mode training-style encode (ref feature_extractors.py:105-119 ->
    LanguageVectorQuantization.forward): audio (B, T) -> (features
    (B, D, T'), codes (n_q, B, T') int32).  Every layer quantizes the same
    embedding and the features are the last layer's; at n_q = 1 this is
    ``encode_infer``.  Runs in true fp32 (``full_fp32``)."""
    with full_fp32():
        emb = seanet_encode(params["encoder"], spec.seanet, audio[:, :, None])
        quantized, codes = vq_forward_language(params["quantizer"], spec.vq, emb,
                                               n_q=n_q)
    return quantized.transpose(1, 2), codes


@torch.inference_mode()
def decode(params: dict, spec: WavTokenizerSpec, features: torch.Tensor,
           bandwidth_id: int) -> torch.Tensor:
    """features (B, D, T') -> waveform (B, T' * hop)."""
    h = vocos_backbone(params["backbone"], spec.backbone,
                       features.transpose(1, 2), bandwidth_id=bandwidth_id)
    return istft_head(params["head"], spec.head, h)


@torch.inference_mode()
def codes_to_features(params: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes (K, B, T) or (K, T) -> features (B, D, T)."""
    return _codes_to_features(params["quantizer"], codes).transpose(1, 2)


@torch.inference_mode()
def forward(params: dict, spec: WavTokenizerSpec, audio: torch.Tensor,
            bandwidth_id: int) -> torch.Tensor:
    """Copy synthesis (ref decoder/pretrained.py:159-175): the training-style
    encode, then ``decode``.  audio (B, T) -> (B, T' * hop)."""
    features, _ = encode_forward(params, spec, audio)
    return decode(params, spec, features, bandwidth_id)


@torch.inference_mode()
def seanet_only_decode(params: dict, spec: WavTokenizerSpec,
                       features: torch.Tensor) -> torch.Tensor:
    """The SEANet decoder alone, bypassing Vocos: features (B, D, T') ->
    (B, T' * hop), the first audio channel (the EnCodec-style resynthesis)."""
    return seanet_decode(params["decoder"], spec.seanet, features.transpose(1, 2))[:, :, 0]
