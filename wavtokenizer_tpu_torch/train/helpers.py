"""Training observability: spectrogram images and TensorBoard logging.

Port of ``wavtokenizer_tpu/train/helpers.py`` (ref decoder/helpers.py and
the experiment's TensorBoard streams: scalars per loss term, audio and
mel-spectrogram images, decoder/experiment.py:195-216, 272-294).
TensorBoard is optional: without it the logger does nothing and the JSONL
metrics stream is the record.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.spectral import mel_spectrogram, safe_log


def plot_spectrogram_to_numpy(spectrogram: np.ndarray) -> np.ndarray:
    """(n_mels, T) log-mel -> (3, H, W) RGB image (CHW, as TensorBoard takes)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(np.asarray(spectrogram), aspect="auto", origin="lower",
                   interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.xlabel("Frames")
    plt.ylabel("Channels")
    plt.tight_layout()
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
    plt.close(fig)
    return data.transpose(2, 0, 1)


def log_mel(audio: np.ndarray, sample_rate: int) -> np.ndarray:
    """(T,) waveform -> (n_mels, frames) log-mel for plotting."""
    mel = mel_spectrogram(torch.as_tensor(np.asarray(audio, np.float32))[None],
                          sample_rate, 1024, 256, 100)
    return safe_log(mel)[0].numpy()


class TBLogger:
    """Thin TensorBoard writer; does nothing without tensorboard."""

    def __init__(self, logdir: str | None):
        """``logdir`` None: a logger that writes nothing (the ranks of a
        multi-card run after the first)."""
        self._w = None
        if logdir is None:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._w = SummaryWriter(logdir)
        except Exception:
            pass

    @property
    def enabled(self) -> bool:
        return self._w is not None

    def scalars(self, metrics: dict, step: int) -> None:
        if self._w is None:
            return
        for k, v in metrics.items():
            if isinstance(v, (int, float, np.floating, np.integer)):
                self._w.add_scalar(k, float(v), step)

    def audio(self, tag: str, audio: np.ndarray, sample_rate: int, step: int) -> None:
        """Audio-only snapshot (ref experiment.py:469-473 ``add_audio``)."""
        if self._w is None:
            return
        self._w.add_audio(tag, np.asarray(audio, np.float32).reshape(-1), step,
                          sample_rate=sample_rate)

    def audio_and_spectrogram(self, tag: str, audio: np.ndarray, sample_rate: int,
                              step: int) -> None:
        """An audio clip and its mel-spectrogram image (ref experiment.py:195-216)."""
        if self._w is None:
            return
        audio = np.asarray(audio, np.float32).reshape(-1)
        self._w.add_audio(f"{tag}/audio", audio, step, sample_rate=sample_rate)
        self._w.add_image(f"{tag}/spectrogram",
                          plot_spectrogram_to_numpy(log_mel(audio, sample_rate)), step)

    def flush(self) -> None:
        if self._w is not None:
            self._w.flush()

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
