"""Batch low-pass filter: remove the content above a cutoff from a folder of WAVs.

Port of ``tools_tpu/lowpass.py`` (ref dd.py:6-74): per file, load, mono-mix,
resample to the target rate, STFT (n_fft 2048, hop 512, Hann), zero every
bin above the cutoff (default 4 kHz), inverse STFT, peak-normalise, save.
The files are zero-padded into batches of a shared length (a multiple of
four hops) and each batch is one call on the device.

    python -m wavtokenizer_tpu_torch.tools.lowpass --input-dir noisy/ \\
        --output-dir filtered/ [--cutoff 4000] [--sample-rate 24000] \\
        [--batch-size 16] [--device cuda]
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from ..ops.spectral import istft_center, stft

N_FFT = 2048
HOP = N_FFT // 4


@torch.inference_mode()
def lowpass_batch(audio: torch.Tensor, sample_rate: int, cutoff: float) -> torch.Tensor:
    """(B, L) -> (B, L') low-passed and peak-normalised."""
    spec = stft(audio, N_FFT, HOP, center=True)            # (B, T, F)
    freqs = np.linspace(0, sample_rate // 2, N_FFT // 2 + 1)
    spec = spec * torch.as_tensor((freqs <= cutoff).astype(np.float32), device=audio.device)
    y = istft_center(spec.real, spec.imag, N_FFT, HOP)
    peak = y.abs().amax(dim=1, keepdim=True)
    return y / torch.clamp(peak, min=1e-9)


def energy_above(out: np.ndarray, audio: np.ndarray, sample_rate: int, cutoff: float) -> float:
    """The output's energy above the cutoff over the input's, with the peak
    normalisation's gain (the ratio of their energies at and below the
    cutoff) divided out: what the filter let through."""
    power = lambda y: np.abs(np.fft.rfft(y, axis=-1)) ** 2
    f = np.fft.rfftfreq(audio.shape[-1], 1 / sample_rate)
    p_out, p_in = power(out), power(audio)
    gain = p_out[..., f <= cutoff].sum() / p_in[..., f <= cutoff].sum()
    return float(p_out[..., f > cutoff].sum() / gain / p_in[..., f > cutoff].sum())


def process_folder(input_dir: str, output_dir: str, sample_rate: int = 24000,
                   cutoff: float = 4000.0, batch_size: int = 16, device="cuda") -> int:
    from scipy.io import wavfile

    from ..utils.audio import read_audio, resample_np

    os.makedirs(output_dir, exist_ok=True)
    names = sorted(n for n in os.listdir(input_dir) if n.endswith(".wav"))
    done = 0
    for start in range(0, len(names), batch_size):
        chunk = names[start:start + batch_size]
        waves = []
        for name in chunk:
            y, sr = read_audio(os.path.join(input_dir, name))
            if y.ndim > 1:
                y = y.mean(axis=-1)
            if sr != sample_rate:
                y = resample_np(y, sr, sample_rate)
            waves.append(y.astype(np.float32))
        lens = [len(y) for y in waves]
        bucket = math.ceil(max(lens) / (4 * HOP)) * 4 * HOP
        batch = np.zeros((len(waves), bucket), dtype=np.float32)
        for i, y in enumerate(waves):
            batch[i, :len(y)] = y
        out = lowpass_batch(torch.from_numpy(batch).to(device), sample_rate, cutoff).cpu().numpy()
        for i, name in enumerate(chunk):
            y = out[i, :min(lens[i], out.shape[1])]
            wavfile.write(os.path.join(output_dir, name), sample_rate,
                          (np.clip(y, -1.0, 1.0) * 32767.0).astype(np.int16))
            done += 1
        print(f"{done}/{len(names)} files")
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input-dir", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--cutoff", type=float, default=4000.0)
    ap.add_argument("--sample-rate", type=int, default=24000)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n = process_folder(args.input_dir, args.output_dir, args.sample_rate,
                       args.cutoff, args.batch_size, args.device)
    print(f"filtered {n} files -> {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
