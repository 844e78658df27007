"""Enhancement trainers: the fork's try3 / tsne / train_with_tsne / try loops.

Port of ``wavtokenizer_tpu/research/enhance.py``.  Four regimes over the
adapter stack (``research/adapter.py``):

* ``waveform`` (try3.py): adapter + SEANet decoder train on the
  voice-focused waveform loss against the clean target, features * 1.5 ->
  tanh before the decode (try3.py:1038-1053).
* ``feature`` (tsne.py): only the adapter trains; L2 between the enhanced
  noisy features and the encoder's clean ones (tsne.py:152-169).
* ``hybrid`` (train_with_tsne.py): 0.7 voice-focused + 0.3 cosine feature
  loss, adapter only; its gradient reaches the adapter through the frozen
  decoder.
* ``byol`` (try.py): the BYOL SimpleTransformer between the frozen encoder
  and the adapter, the amplitude hacks, the voice-focused loss.

The optimizer is ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``
behind a global-norm clip written as optax's ``clip_by_global_norm`` (the
JAX package's): every gradient scaled by max_norm / |g| only when |g| >=
max_norm.  The trainable tensors are updated in place.

``PairedAudioDataset`` reads "noisy|clean" pair files
(tools_tpu/prepare_data_lists.py's format) and draws the JAX package's crops
for the same file and seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.wavtokenizer import WavTokenizerSpec
from ..train.step import tree_leaves
from ..utils.audio import read_audio, resample_np
from .adapter import InPathTransformerConfig, enhanced_forward, frozen_encode
from .losses import feature_loss, hybrid_tsne_loss, voice_focused_loss


class PairedAudioDataset:
    """Paired (noisy, clean) crops from a pairs file of ``noisy|clean`` lines."""

    def __init__(self, pairs_file: str, sample_rate: int = 24000,
                 num_samples: int = 72000, seed: int = 0):
        self.pairs = []
        with open(pairs_file) as f:
            for line in f:
                line = line.strip()
                if line and "|" in line:
                    noisy, clean = line.split("|", 1)
                    self.pairs.append((noisy, clean))
        self.sample_rate = sample_rate
        self.num_samples = num_samples
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.pairs)

    def _load(self, path):
        y, sr = read_audio(path)
        if y.ndim > 1:
            y = y.mean(axis=-1)
        if sr != self.sample_rate:
            y = resample_np(y, sr, self.sample_rate)
        return y

    def __getitem__(self, i):
        noisy, clean = (self._load(p) for p in self.pairs[i])
        n = min(len(noisy), len(clean))
        noisy, clean = noisy[:n], clean[:n]
        if n < self.num_samples:
            reps = 1 + (self.num_samples - n) // n
            noisy = np.tile(noisy, reps + 1)[:self.num_samples]
            clean = np.tile(clean, reps + 1)[:self.num_samples]
        else:
            start = self.rng.integers(0, n - self.num_samples + 1)
            noisy = noisy[start:start + self.num_samples]
            clean = clean[start:start + self.num_samples]
        return noisy.astype(np.float32), clean.astype(np.float32)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0):
        """Endless (noisy (B, L), clean (B, L)) numpy batches.  The batch is
        clamped to the dataset's size: with fewer pairs than ``batch_size``
        no batch would ever fill and the loop would spin forever."""
        batch_size = min(batch_size, len(self))
        if batch_size == 0:
            raise ValueError("empty paired dataset")
        rng = np.random.default_rng(seed)
        while True:
            order = rng.permutation(len(self)) if shuffle else np.arange(len(self))
            for i in range(0, len(self) - batch_size + 1, batch_size):
                items = [self[int(j)] for j in order[i:i + batch_size]]
                yield (np.stack([a for a, _ in items]), np.stack([b for _, b in items]))


@dataclass(frozen=True)
class EnhanceConfig:
    """mode: ``waveform`` (try3.py), ``feature`` (tsne.py), ``hybrid``
    (train_with_tsne.py) or ``byol`` (try.py:36-134: transformer, adapter and
    decoder all train, try.py:83's freeze_byol_transformer=False default)."""
    mode: str = "waveform"             # waveform | feature | hybrid | byol
    learning_rate: float = 1e-4
    grad_clip: float = 1.0
    feature_scale: float | None = 1.5  # try3's features * 1.5 -> tanh
    normalize_inputs: bool = True      # try3 peak-normalises the noisy input
    transformer_cfg: InPathTransformerConfig = InPathTransformerConfig()


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """Per-utterance peak normalisation of (B, T): the reference loads the
    noisy input as ``wav / (wav.abs().max() + 1e-8)`` (try3.py:183) and the
    clean target un-normalised (try3.py:292-293)."""
    return x / (x.abs().amax(dim=-1, keepdim=True) + 1e-8)


def enhance_trainable(adapter_params: dict, decoder_params, ecfg: EnhanceConfig,
                      transformer_params: dict | None = None) -> dict:
    """The trees the mode trains: the adapter; the decoder in ``waveform``
    and ``byol``; the transformer in ``byol`` when there is one."""
    trainable = {"adapter": adapter_params}
    if ecfg.mode in ("waveform", "byol"):
        trainable["decoder"] = decoder_params
    if ecfg.mode == "byol" and transformer_params is not None:
        trainable["transformer"] = transformer_params
    return trainable


def make_enhance_optimizer(adapter_params: dict, decoder_params, ecfg: EnhanceConfig,
                           transformer_params: dict | None = None) -> torch.optim.Adam:
    """Adam over the mode's trainable tensors, which it marks
    ``requires_grad``; the clip is ``enhance_step``'s."""
    leaves = tree_leaves(enhance_trainable(adapter_params, decoder_params, ecfg,
                                           transformer_params))
    for t in leaves:
        t.requires_grad_(True)
    return torch.optim.Adam(leaves, lr=ecfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)


def enhance_loss(adapter_params: dict, adapter_state: dict, decoder_params,
                 base_params: dict, noisy: torch.Tensor, clean: torch.Tensor,
                 spec: WavTokenizerSpec, ecfg: EnhanceConfig,
                 transformer_params: dict | None = None) -> tuple:
    """The mode's loss of one batch -> (loss, new_adapter_state).  The
    encoder is ``base_params["encoder"]``, the decoder ``decoder_params``."""
    if ecfg.normalize_inputs:
        noisy = _normalize(noisy)
    use_tr = ecfg.mode == "byol" and transformer_params is not None
    bp = {"encoder": base_params["encoder"], "decoder": decoder_params}
    out, enhanced, _, new_state = enhanced_forward(
        bp, spec.seanet, adapter_params, adapter_state, noisy, train=True,
        feature_scale=ecfg.feature_scale if ecfg.mode == "waveform" else None,
        transformer_params=transformer_params if use_tr else None,
        transformer_cfg=ecfg.transformer_cfg)
    if ecfg.mode in ("waveform", "byol"):
        return voice_focused_loss(out, clean), new_state
    target = frozen_encode(base_params["encoder"], spec.seanet, clean)
    if ecfg.mode == "feature":
        return feature_loss(enhanced, target), new_state
    if ecfg.mode == "hybrid":
        return hybrid_tsne_loss(out, clean, enhanced, target), new_state
    raise ValueError(f"enhancement mode {ecfg.mode!r}")


def enhance_step(opt: torch.optim.Adam, adapter_params: dict, adapter_state: dict,
                 decoder_params, base_params: dict, noisy: torch.Tensor,
                 clean: torch.Tensor, spec: WavTokenizerSpec, ecfg: EnhanceConfig,
                 transformer_params: dict | None = None) -> tuple:
    """One training step: the trainable tensors are updated in place by
    ``opt`` (``make_enhance_optimizer`` over the same trees).  Returns
    (new_adapter_state, loss, global gradient norm before the clip)."""
    loss, new_state = enhance_loss(adapter_params, adapter_state, decoder_params,
                                   base_params, noisy, clean, spec, ecfg, transformer_params)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    grads = [p.grad for group in opt.param_groups for p in group["params"]
             if p.grad is not None]
    g_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(g_norm < ecfg.grad_clip, torch.ones_like(g_norm),
                        ecfg.grad_clip / g_norm)
    for g in grads:
        g.mul_(scale)
    opt.step()
    return new_state, loss.detach(), g_norm.detach()
