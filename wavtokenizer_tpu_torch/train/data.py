"""Host-side data pipeline: filelist dataset -> batched 24 kHz crops.

Port of ``wavtokenizer_tpu/train/data.py`` (ref decoder/dataset.py:44-84):
read -> mono mix -> sox "norm <gain>" peak normalization (random -1..-6 dB
in training, -3 dB in validation) -> resample to the target rate ->
repeat-pad or random crop to num_samples.  The same numpy draws as the JAX
package's Python loader, so one seed gives both the same batches.  Files are
read by ``utils/audio.py::read_audio`` and resampled by ``resample_np``.
The trainer runs it where the C++ loader (``native/``, whose thread count is
``num_workers``) cannot: a file that is not a ``.wav``, or no ``g++``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.audio import read_audio, resample_np


@dataclass
class DataConfig:
    """Mirror of the reference DataConfig (dataset.py:15-21)."""
    filelist_path: str
    sampling_rate: int = 24000
    num_samples: int = 72000
    batch_size: int = 40
    num_workers: int = 0


def sox_norm(y: np.ndarray, gain_db: float) -> np.ndarray:
    """sox ``norm <gain>``: scale so that the peak sits at gain_db dBFS
    (ref dataset.py:69-70)."""
    peak = np.abs(y).max()
    if peak == 0:
        return y
    return y * (10.0 ** (gain_db / 20.0) / peak)


class WavDataset:
    """The file list with VocosDataset's semantics (dataset.py:44-84)."""

    def __init__(self, cfg: DataConfig, train: bool):
        with open(cfg.filelist_path) as f:
            self.filelist = [l for l in f.read().splitlines() if l.strip()]
        self.cfg = cfg
        self.train = train

    def __len__(self):
        return len(self.filelist)

    def sample(self, index: int, rng) -> np.ndarray:
        """One crop drawn with ``rng`` (the loader passes a generator per
        (seed, epoch, index), so a resumed run replays the gains and crops
        of an uninterrupted one)."""
        cfg = self.cfg
        y, sr = read_audio(self.filelist[index])
        if y.ndim > 1:
            y = y.mean(axis=-1)
        y = sox_norm(y, rng.uniform(-6, -1) if self.train else -3.0)
        if sr != cfg.sampling_rate:
            y = resample_np(y, sr, cfg.sampling_rate)
        n = y.shape[-1]
        if n < cfg.num_samples:
            reps = 1 + (cfg.num_samples - n) // n
            y = np.concatenate([y] + [y] * reps)[:cfg.num_samples]
        elif self.train:
            start = rng.integers(0, n - cfg.num_samples + 1)
            y = y[start:start + cfg.num_samples]
        else:
            y = y[:cfg.num_samples]
        return y.astype(np.float32)


def data_loader(dataset: WavDataset, batch_size: int, shuffle: bool, seed: int = 0,
                drop_last: bool = True, skip_batches: int = 0):
    """Endless epoch iterator of (B, num_samples) float32 batches.
    ``skip_batches`` fast-forwards the shuffle and crop stream without
    reading audio, so a resumed run's loader starts where the interrupted
    run stopped."""
    rng = np.random.default_rng(seed)
    n = len(dataset)
    epoch = 0
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for i in range(0, n - (batch_size - 1 if drop_last else 0), batch_size):
            idx = order[i:i + batch_size]
            if drop_last and len(idx) < batch_size:
                break
            if skip_batches > 0:
                skip_batches -= 1
                continue
            yield np.stack([dataset.sample(int(j), np.random.default_rng((seed, epoch, int(j))))
                            for j in idx])
        epoch += 1
