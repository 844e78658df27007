"""Neural audio compression: wav <-> an entropy-coded token stream.

Port of ``tools_tpu/compress.py``: tokenize (SEANet encoder + VQ), code the
token stream with the streaming LM and the arithmetic coder
(``ops/entropy.py``), and write the ``WTC1`` container; ``decode`` reverses
it (tokens -> ``codes_to_features`` -> Vocos decode -> 16-bit WAV).  The
token level is lossless.  Without ``--config/--checkpoint`` the codec is the
random small-320 model, and the LM is always the random one of seed 0 (as
in the JAX tool): expect about log2(bins) bits per token.  ``--no-lm``
packs the ids at a fixed log2(bins) bits instead; that container is the
same bytes as the JAX tool's for the same codes.

An LM-coded stream decodes only on the device type it was coded on: the
two directions must compute bit-identical probabilities.

    python -m wavtokenizer_tpu_torch.tools.compress encode in.wav out.wtc \\
        [--config c.yaml --checkpoint m.ckpt] [--no-lm] [--device cuda]
    python -m wavtokenizer_tpu_torch.tools.compress decode out.wtc rec.wav [...]

Container: b"WTC1", then little-endian (mode u8: 0 fixed-rate, 1 LM;
K u16; T u32; samples u32), then the payload.
"""

from __future__ import annotations

import argparse
import struct

import numpy as np

MAGIC = b"WTC1"
HEADER = "<BHII"


def _load_model(args):
    from ..api.pretrained import WavTokenizer
    if args.config and args.checkpoint:
        return WavTokenizer.from_pretrained0802(args.config, args.checkpoint,
                                                device=args.device)
    from ..models.init import init_wavtokenizer
    from ..models.wavtokenizer import WavTokenizerSpec
    spec = WavTokenizerSpec()
    print("note: random model (no --config/--checkpoint)")
    return WavTokenizer.from_jax_params(init_wavtokenizer(spec, random_codebook=True),
                                        spec, device=args.device)


def _lm_setup(wt, device, seed: int = 0):
    from ..models.lm import LMConfig, StreamingTransformerConfig, init_lm, lm_params_to
    cfg = LMConfig(n_q=wt.spec.vq.n_q, card=wt.spec.vq.bins,
                   transformer=StreamingTransformerConfig(dim=200))
    return lm_params_to(init_lm(cfg, seed=seed), device), cfg


def _pack_fixed(codes: np.ndarray, bins: int) -> bytes:
    """Ids at ceil(log2(bins)) bits each, MSB first, zero-padded to a byte."""
    bits = int(np.ceil(np.log2(bins)))
    out, acc, n = [], 0, 0
    for v in codes.reshape(-1):
        acc = (acc << bits) | int(v)
        n += bits
        while n >= 8:
            n -= 8
            out.append((acc >> n) & 0xFF)
    if n:
        out.append((acc << (8 - n)) & 0xFF)
    return bytes(out)


def _unpack_fixed(data: bytes, bins: int, count: int) -> np.ndarray:
    bits = int(np.ceil(np.log2(bins)))
    out = np.zeros(count, np.int32)
    acc, n, pos = 0, 0, 0
    for i in range(count):
        while n < bits:
            acc = (acc << 8) | data[pos]
            pos += 1
            n += 8
        n -= bits
        out[i] = (acc >> n) & ((1 << bits) - 1)
    return out


def encode_cmd(args) -> None:
    from ..ops.entropy import compress_codes
    from ..utils.audio import read_audio, resample_np

    wt = _load_model(args)
    sr = wt.spec.sample_rate
    y, in_sr = read_audio(args.input)
    if y.ndim > 1:
        y = y.mean(axis=-1)
    y = resample_np(y, in_sr, sr)
    _, codes = wt.encode_infer(y[None])
    codes = codes[:, 0, :].cpu().numpy()            # (K, T)
    K, T = codes.shape
    if args.no_lm:
        blob, mode = _pack_fixed(codes, wt.spec.vq.bins), 0
    else:
        lm_params, lm_cfg = _lm_setup(wt, wt.device)
        blob, mode = compress_codes(lm_params, lm_cfg, codes), 1
    with open(args.output, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack(HEADER, mode, K, T, len(y)))
        f.write(blob)
    seconds = len(y) / sr
    raw_bits = K * T * int(np.ceil(np.log2(wt.spec.vq.bins)))
    print(f"{seconds:.2f}s audio -> {K}x{T} tokens -> {len(blob)} bytes "
          f"({len(blob) * 8 / seconds:.0f} bps, {len(blob) * 8 / (K * T):.3f} bits/token; "
          f"raw tokens {raw_bits / seconds:.0f} bps)")


def decode_cmd(args) -> None:
    from scipy.io import wavfile

    from ..ops.entropy import decompress_codes

    wt = _load_model(args)
    with open(args.input, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{args.input} is not a WTC1 file")
        mode, K, T, n_samples = struct.unpack(HEADER, f.read(struct.calcsize(HEADER)))
        blob = f.read()
    if mode == 0:
        codes = _unpack_fixed(blob, wt.spec.vq.bins, K * T).reshape(K, T)
    elif mode == 1:
        lm_params, lm_cfg = _lm_setup(wt, wt.device)
        codes = decompress_codes(lm_params, lm_cfg, blob, K, T)
    else:
        raise ValueError(f"{args.input}: unknown mode {mode}")
    wav = wt.decode(wt.codes_to_features(codes[:, None, :]), 0)[0].cpu().numpy()[:n_samples]
    sr = wt.spec.sample_rate
    wavfile.write(args.output, sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    print(f"decoded {K}x{T} tokens -> {args.output} ({len(wav) / sr:.2f}s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("command", choices=["encode", "decode"])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--no-lm", action="store_true",
                    help="fixed-rate token packing instead of LM coding")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    (encode_cmd if args.command == "encode" else decode_cmd)(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
