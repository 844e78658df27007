"""EncodecModel-level wrapper: segmented encode/decode with overlap-add and
optional per-segment volume normalization, over the residual VQ.

Port of ``wavtokenizer_tpu/models/encodec.py`` (ref encoder/model.py:68-191):
fixed ``segment`` windows with a 1% ``overlap``, per-segment RMS scaling
``1e-8 + sqrt(mean(mono^2))`` when ``normalize``, triangular-weight
overlap-add on decode, and the full resynthesis ``forward``.  The last,
ragged segment is NOT padded: the reference encodes the shorter tail as it
is (encoder/model.py:139-145), and zero padding would change the codes at
the boundary.

Params are this package's (``api/pretrained.py::encodec_from_jax_params``):
{"encoder", "decoder": SEANet layer params, "quantizer": {"embed", "esq",
"pack"} of all n_q layers}.  The encode runs in true fp32 (``full_fp32``);
on the card each segment's residual VQ is a chain of n_q VQ-kernel launches.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from ..ops.resample import linear_overlap_add
from .quantize import VQConfig, vq_decode, vq_encode
from .seanet import SEANetConfig, seanet_decode, seanet_encode
from .wavtokenizer import full_fp32


@dataclass(frozen=True)
class EncodecConfig:
    seanet: SEANetConfig
    vq: VQConfig
    sample_rate: int = 24000
    channels: int = 1
    normalize: bool = False
    segment: float | None = None
    overlap: float = 0.01
    target_bandwidths: tuple = (6.6, 6.6, 6.6, 6.6)
    # Selected target bandwidth in kbps (ref encoder/model.py:193-197);
    # None = all vq.n_q quantizers.
    bandwidth: float | None = None
    name: str = "unset"

    @property
    def frame_rate(self) -> int:
        return math.ceil(self.sample_rate / self.seanet.hop_length)

    @property
    def segment_length(self) -> int | None:
        if self.segment is None:
            return None
        return int(self.segment * self.sample_rate)

    @property
    def segment_stride(self) -> int | None:
        sl = self.segment_length
        if sl is None:
            return None
        return max(1, int((1 - self.overlap) * sl))


def set_target_bandwidth(cfg: EncodecConfig, bandwidth: float) -> EncodecConfig:
    """EncodecModel.set_target_bandwidth (ref encoder/model.py:193-197)."""
    if bandwidth not in cfg.target_bandwidths:
        raise ValueError(
            f"This model doesn't support the bandwidth {bandwidth}. "
            f"Select one of {cfg.target_bandwidths}.")
    return dataclasses.replace(cfg, bandwidth=bandwidth)


def _effective_n_q(cfg: EncodecConfig, n_q: int | None) -> int | None:
    if n_q is not None:
        return n_q
    if cfg.bandwidth is not None:
        return cfg.vq.n_q_for_bandwidth(cfg.frame_rate, cfg.bandwidth)
    return None


def _encode_frame(params: dict, cfg: EncodecConfig, x: torch.Tensor,
                  n_q: int | None = None):
    """x (B, C, L) -> (codes (B, K, T') int32, scale (B, 1) or None)
    (ref encoder/model.py:147-165)."""
    scale = None
    if cfg.normalize:
        mono = x.mean(dim=1, keepdim=True)
        scale = 1e-8 + (mono ** 2).mean(dim=2, keepdim=True).sqrt()
        x = x / scale
        scale = scale.reshape(-1, 1)
    emb = seanet_encode(params["encoder"], cfg.seanet, x.transpose(1, 2))
    codes = vq_encode(params["quantizer"], cfg.vq, emb, n_q=n_q)   # (K, B, T')
    return codes.transpose(0, 1), scale


def _decode_frame(params: dict, cfg: EncodecConfig, codes: torch.Tensor,
                  scale) -> torch.Tensor:
    """codes (B, K, T') -> (B, C, L) (ref encoder/model.py:180-187)."""
    emb = vq_decode(params["quantizer"], codes.transpose(0, 1))
    out = seanet_decode(params["decoder"], cfg.seanet, emb).transpose(1, 2)
    if scale is not None:
        out = out * scale.reshape(-1, 1, 1)
    return out


@torch.inference_mode()
def encode(params: dict, cfg: EncodecConfig, x: torch.Tensor,
           n_q: int | None = None) -> list:
    """Segmented encode (ref encoder/model.py:122-145): x (B, C, L) ->
    [(codes (B, K, T'), scale or None) per segment]."""
    if x.dim() != 3 or not 0 < x.shape[1] <= 2:
        raise ValueError(f"encode needs (B, C, L) audio with 1 or 2 channels, "
                         f"got shape {tuple(x.shape)}")
    length = x.shape[-1]
    n_q = _effective_n_q(cfg, n_q)
    segment_length, stride = cfg.segment_length, cfg.segment_stride
    if segment_length is None:
        segment_length = stride = length
    with full_fp32():
        return [_encode_frame(params, cfg, x[:, :, offset:offset + segment_length], n_q=n_q)
                for offset in range(0, length, stride)]


@torch.inference_mode()
def decode(params: dict, cfg: EncodecConfig, encoded_frames: list) -> torch.Tensor:
    """Overlap-add decode (ref encoder/model.py:167-178) -> (B, C, L)."""
    if cfg.segment_length is None:
        if len(encoded_frames) != 1:
            raise ValueError(f"{len(encoded_frames)} frames for an unsegmented model")
        return _decode_frame(params, cfg, *encoded_frames[0])
    frames = [_decode_frame(params, cfg, c, s) for c, s in encoded_frames]
    return linear_overlap_add(frames, cfg.segment_stride)


@torch.inference_mode()
def forward(params: dict, cfg: EncodecConfig, x: torch.Tensor,
            n_q: int | None = None) -> torch.Tensor:
    """Full resynthesis (ref encoder/model.py:189-191): x (B, C, L) ->
    (B, C, L)."""
    return decode(params, cfg, encode(params, cfg, x, n_q=n_q))[:, :, :x.shape[-1]]


# Pretrained-EnCodec factory configs (ref encoder/model.py:221-301).  No
# weights are downloaded: a local encodec_*.th state dict goes through
# checkpoint/convert.py::convert_encodec_state_dict.

def _get_model_config(target_bandwidths: tuple, sample_rate: int = 24_000,
                      channels: int = 1, causal: bool = True,
                      model_norm: str = "weight_norm",
                      audio_normalize: bool = False,
                      segment: float | None = None,
                      name: str = "unset") -> EncodecConfig:
    """EncodecModel._get_model as a config builder (ref model.py:221-248):
    SEANet with dimension 128 and n_q = 1000 * max_bw // (frame_rate * 10)
    codebooks of 1024 bins."""
    seanet = SEANetConfig(channels=channels, dimension=128, causal=causal,
                          norm=model_norm)
    frame_rate = math.ceil(sample_rate / seanet.hop_length)
    n_q = int(1000 * target_bandwidths[-1] // (frame_rate * 10))
    return EncodecConfig(seanet, VQConfig(dimension=128, n_q=n_q, bins=1024),
                         sample_rate=sample_rate, channels=channels,
                         normalize=audio_normalize, segment=segment,
                         target_bandwidths=tuple(target_bandwidths), name=name)


def encodec_model_24khz_config() -> EncodecConfig:
    """Pretrained causal 24 kHz EnCodec (ref model.py:263-281): mono,
    weight_norm, bandwidths up to 24 kbps -> 32 quantizers."""
    return _get_model_config((1.5, 3.0, 6.0, 12.0, 24.0), sample_rate=24_000,
                             channels=1, causal=True, model_norm="weight_norm",
                             audio_normalize=False, name="encodec_24khz")


def encodec_model_48khz_config() -> EncodecConfig:
    """Pretrained 48 kHz EnCodec (ref model.py:283-301): stereo,
    time_group_norm, volume-normalized 1 s segments -> 16 quantizers."""
    return _get_model_config((3.0, 6.0, 12.0, 24.0), sample_rate=48_000,
                             channels=2, causal=False,
                             model_norm="time_group_norm",
                             audio_normalize=True, segment=1.0,
                             name="encodec_48khz")


def encodec_lm_config(cfg: EncodecConfig):
    """Config of the token LM paired with an EnCodec model (ref
    encoder/model.py:199-217 get_lm_model): 5 layers, dim 200, past_context
    = 3.5 s of frames."""
    from .lm import LMConfig, StreamingTransformerConfig
    return LMConfig(n_q=cfg.vq.n_q, card=cfg.vq.bins,
                    transformer=StreamingTransformerConfig(
                        dim=200, num_layers=5,
                        past_context=int(3.5 * cfg.frame_rate)))
