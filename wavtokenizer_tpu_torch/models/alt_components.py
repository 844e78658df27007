"""The plain-Vocos components the reference carries beside WavTokenizer.

Port of ``wavtokenizer_tpu/models/alt_components.py``, channel-last (B, T, C)
like ``models/vocos.py``:

* MelSpectrogramFeatures (ref decoder/feature_extractors.py:30-51):
  ``MelFeaturesConfig``, ``mel_features``;
* VocosResNetBackbone and ResBlock1, the HiFi-GAN-style trunk (ref
  decoder/models.py:238-264, decoder/modules.py:89-191): ``res_block1``,
  ``VocosResNetBackboneConfig``, ``vocos_resnet_backbone``;
* IMDCTSymExpHead / IMDCTCosHead (ref decoder/heads.py:70-157):
  ``IMDCTHeadConfig``, ``imdct_symexp_head``, ``imdct_cos_head``,
  ``mel_scaled_head_init_scale``;
* ``conv_layer_norm`` (ref encoder/modules/norm.py:16-28, written as the
  LayerNorm it means to be: the reference's forward returns None).

Conv weights are (C_out, C_in, K) with weight norm folded, Linear weights
(C_in, C_out), as in ``models/vocos.py``.  None of these has a TPU kernel in
the JAX package; on the card they are cuDNN convs, cuBLAS matmuls and
``torch.fft``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import conv1d
from ..ops.spectral import imdct, mel_spectrogram, safe_log
from .vocos import layer_norm


@dataclass(frozen=True)
class MelFeaturesConfig:
    sample_rate: int = 24000
    n_fft: int = 1024
    hop_length: int = 256
    n_mels: int = 100
    padding: str = "center"


def mel_features(cfg: MelFeaturesConfig, audio: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, n_mels, T') log-mel features: magnitude mel (power 1),
    safe log (ref decoder/feature_extractors.py:45-51).  "center" pads
    n_fft // 2 by reflection inside the STFT; "same" pads (n_fft - hop) // 2
    by reflection on both sides first, then frames without centering."""
    if cfg.padding == "same":
        pad = (cfg.n_fft - cfg.hop_length) // 2
        audio = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    elif cfg.padding != "center":
        raise ValueError("Padding must be 'center' or 'same'.")
    mel = mel_spectrogram(audio, cfg.sample_rate, cfg.n_fft, cfg.hop_length,
                          cfg.n_mels, center=cfg.padding == "center")
    return safe_log(mel)


def res_block1(p: dict, x: torch.Tensor, dilations=(1, 3, 5),
               lrelu_slope: float = 0.1) -> torch.Tensor:
    """(B, T, C) -> (B, T, C): three [leaky relu -> dilated conv k3 ->
    leaky relu -> conv k3 -> layer scale] residual units (ref
    decoder/modules.py:172-181)."""
    for c1, c2, gamma, d in zip(p["convs1"], p["convs2"], p["gamma"], dilations):
        xt = F.leaky_relu(x, lrelu_slope)
        xt = conv1d(xt, c1["weight"], c1["bias"], dilation=d, padding=(d, d))
        xt = F.leaky_relu(xt, lrelu_slope)
        xt = conv1d(xt, c2["weight"], c2["bias"], padding=(1, 1))
        if gamma is not None:
            xt = gamma * xt
        x = xt + x
    return x


@dataclass(frozen=True)
class VocosResNetBackboneConfig:
    input_channels: int = 100
    dim: int = 512
    num_blocks: int = 3


def vocos_resnet_backbone(params: dict, cfg: VocosResNetBackboneConfig,
                          x: torch.Tensor) -> torch.Tensor:
    """(B, T, C_in) -> (B, T, dim): embed conv k3, then ResBlock1s (ref
    decoder/models.py:260-264)."""
    x = conv1d(x, params["embed"]["weight"], params["embed"]["bias"], padding=(1, 1))
    for block in params["resnet"]:
        x = res_block1(block, x)
    return x


@dataclass(frozen=True)
class IMDCTHeadConfig:
    dim: int = 768
    mdct_frame_len: int = 640
    padding: str = "same"
    clip_audio: bool = False


def _symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(x.abs()) - 1.0)


def imdct_symexp_head(params: dict, cfg: IMDCTHeadConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, T, dim) -> (B, L): Linear to frame_len / 2 MDCT coefficients,
    symexp, clipped at +-1e2, IMDCT (ref decoder/heads.py:102-120)."""
    x = _symexp(x @ params["out"]["weight"] + params["out"]["bias"])
    audio = imdct(torch.clamp(x, -1e2, 1e2), cfg.mdct_frame_len, cfg.padding)
    return torch.clamp(audio, -1.0, 1.0) if cfg.clip_audio else audio


def imdct_cos_head(params: dict, cfg: IMDCTHeadConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, T, dim) -> (B, L): Linear to frame_len values, split into a
    log-magnitude (exp, clipped at 1e2) and a phase, IMDCT of m * cos(p)
    (ref decoder/heads.py:140-157)."""
    x = x @ params["out"]["weight"] + params["out"]["bias"]
    m, p = x.chunk(2, dim=-1)
    m = torch.clamp(torch.exp(m), max=1e2)
    audio = imdct(m * torch.cos(p), cfg.mdct_frame_len, cfg.padding)
    return torch.clamp(audio, -1.0, 1.0) if cfg.clip_audio else audio


def conv_layer_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
                    bias: torch.Tensor | None = None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of channel-last conv activations (ref ConvLayerNorm,
    encoder/modules/norm.py:16-28, whose forward lacks its ``return``; the
    activations here are channel-last already, so this is a last-axis
    LayerNorm)."""
    return layer_norm(x, weight, bias, eps=eps)


def mel_scaled_head_init_scale(sample_rate: int, out_dim: int) -> np.ndarray:
    """Perceptual init scaling of IMDCTSymExpHead's output columns (ref
    heads.py:92-100)."""
    m_max = 2595.0 * np.log10(1.0 + (sample_rate // 2) / 700.0)
    m_pts = np.linspace(0, m_max, out_dim)
    f_pts = 700.0 * (10.0 ** (m_pts / 2595.0) - 1.0)
    return (1.0 - f_pts / f_pts.max()).astype(np.float32)
