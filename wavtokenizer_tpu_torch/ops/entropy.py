"""Arithmetic coding of token streams, driven by the streaming token LM.

Port of ``wavtokenizer_tpu/ops/entropy.py``: a Witten-Neal-Cleary integer
arithmetic coder over quantized CDFs (the same integer arithmetic, so a
stream coded with the same CDFs is the same bytes), and
``compress_codes``/``decompress_codes`` over this package's
``models/lm.py::lm_forward``, one LM step per frame with carried state.

Lossless decoding needs bit-identical probabilities on both sides: compress
and decompress run the same per-step call, with the same shapes, on the
same device.  A stream compressed on the card is not promised to decompress
on the CPU, or with the JAX package (whose tool has the same limit across
backends): another device sums in another order.
"""

from __future__ import annotations

import numpy as np
import torch

_PRECISION = 32
_FULL = (1 << _PRECISION) - 1
_HALF = 1 << (_PRECISION - 1)
_QUARTER = 1 << (_PRECISION - 2)
_THREE_Q = _HALF + _QUARTER


def quantize_pdf(pdf: np.ndarray, total_bits: int = 16) -> np.ndarray:
    """Probabilities -> integer cumulative frequencies (C+1,), each symbol
    guaranteed a nonzero span (decodability for any symbol)."""
    total = 1 << total_bits
    pdf = np.asarray(pdf, np.float64)
    pdf = np.maximum(pdf, 0) + 1e-12
    pdf = pdf / pdf.sum()
    freqs = np.maximum(1, np.round(pdf * (total - len(pdf))).astype(np.int64))
    # repair rounding drift off the largest bins
    drift = int(freqs.sum()) - (total - len(pdf))
    while drift != 0:
        i = int(np.argmax(freqs)) if drift > 0 else int(np.argmin(freqs))
        step = -1 if drift > 0 else 1
        freqs[i] += step
        drift += step
    freqs = freqs + 1  # the reserved +1 per symbol
    cum = np.zeros(len(pdf) + 1, np.int64)
    np.cumsum(freqs, out=cum[1:])
    assert cum[-1] == total
    return cum


class BitWriter:
    def __init__(self):
        self._bits: list[int] = []

    def write(self, bit: int):
        self._bits.append(bit)

    def bytes(self) -> bytes:
        bits = self._bits + [0] * (-len(self._bits) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | bits[i + j]
            out.append(b)
        return bytes(out)


class BitReader:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def read(self) -> int:
        byte_i, bit_i = divmod(self._pos, 8)
        self._pos += 1
        if byte_i >= len(self._data):
            return 0
        return (self._data[byte_i] >> (7 - bit_i)) & 1


class ArithmeticEncoder:
    def __init__(self):
        self.low = 0
        self.high = _FULL
        self.pending = 0
        self.out = BitWriter()

    def _emit(self, bit: int):
        self.out.write(bit)
        inv = 1 - bit
        for _ in range(self.pending):
            self.out.write(inv)
        self.pending = 0

    def encode(self, cum: np.ndarray, symbol: int):
        total = int(cum[-1])
        span = self.high - self.low + 1
        self.high = self.low + span * int(cum[symbol + 1]) // total - 1
        self.low = self.low + span * int(cum[symbol]) // total
        while True:
            if self.high < _HALF:
                self._emit(0)
            elif self.low >= _HALF:
                self._emit(1)
                self.low -= _HALF
                self.high -= _HALF
            elif self.low >= _QUARTER and self.high < _THREE_Q:
                self.pending += 1
                self.low -= _QUARTER
                self.high -= _QUARTER
            else:
                break
            self.low <<= 1
            self.high = (self.high << 1) | 1

    def finish(self) -> bytes:
        self.pending += 1
        self._emit(0 if self.low < _QUARTER else 1)
        return self.out.bytes()


class ArithmeticDecoder:
    def __init__(self, data: bytes):
        self.reader = BitReader(data)
        self.low = 0
        self.high = _FULL
        self.value = 0
        for _ in range(_PRECISION):
            self.value = (self.value << 1) | self.reader.read()

    def decode(self, cum: np.ndarray) -> int:
        total = int(cum[-1])
        span = self.high - self.low + 1
        scaled = ((self.value - self.low + 1) * total - 1) // span
        symbol = int(np.searchsorted(cum, scaled, side="right")) - 1
        self.high = self.low + span * int(cum[symbol + 1]) // total - 1
        self.low = self.low + span * int(cum[symbol]) // total
        while True:
            if self.high < _HALF:
                pass
            elif self.low >= _HALF:
                self.low -= _HALF
                self.high -= _HALF
                self.value -= _HALF
            elif self.low >= _QUARTER and self.high < _THREE_Q:
                self.low -= _QUARTER
                self.high -= _QUARTER
                self.value -= _QUARTER
            else:
                break
            self.low <<= 1
            self.high = (self.high << 1) | 1
            self.value = (self.value << 1) | self.reader.read()
        return symbol


def _lm_steps(lm_params, lm_cfg, K: int):
    """Per-frame LM probabilities: ``step(prev)`` takes the previous frame's
    shifted ids (K,) int and returns this frame's (card, K) probabilities as
    numpy; the state is carried between calls."""
    from ..models.lm import lm_forward

    device = lm_params["emb"][0].device
    state = {"states": None, "offset": 0}

    def step(prev: np.ndarray) -> np.ndarray:
        ids = torch.as_tensor(prev.reshape(1, K, 1), dtype=torch.long).to(device)
        probs, state["states"], state["offset"] = lm_forward(
            lm_params, lm_cfg, ids, state["states"], state["offset"])
        return probs[0, :, :, 0].cpu().numpy()

    return step


def compress_codes(lm_params, lm_cfg, codes: np.ndarray, total_bits: int = 16) -> bytes:
    """Losslessly compress codes (K, T) with the streaming LM (``lm_params``:
    tensors from ``models/lm.py::lm_params_to``, on the device it runs on).

    Each frame's distribution conditions on all earlier frames (input ids
    shifted by one, 0 = start); the coder interleaves the K codebooks
    within a frame."""
    codes = np.asarray(codes)
    K, T = codes.shape
    step = _lm_steps(lm_params, lm_cfg, K)
    enc = ArithmeticEncoder()
    prev = np.zeros(K, np.int64)            # start symbol (0 = missing)
    for t in range(T):
        p = step(prev)
        for k in range(K):
            enc.encode(quantize_pdf(p[:, k], total_bits), int(codes[k, t]))
        prev = codes[:, t].astype(np.int64) + 1
    return enc.finish()


def decompress_codes(lm_params, lm_cfg, data: bytes, K: int, T: int,
                     total_bits: int = 16) -> np.ndarray:
    """Inverse of ``compress_codes`` -> (K, T) int32."""
    step = _lm_steps(lm_params, lm_cfg, K)
    dec = ArithmeticDecoder(data)
    out = np.zeros((K, T), np.int32)
    prev = np.zeros(K, np.int64)
    for t in range(T):
        p = step(prev)
        for k in range(K):
            out[k, t] = dec.decode(quantize_pdf(p[:, k], total_bits))
        prev = out[:, t].astype(np.int64) + 1
    return out
