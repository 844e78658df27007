"""The plain-Vocos family: mel features -> trunk -> waveform head.

Port of ``wavtokenizer_tpu/models/vocos_model.py``.  The reference carries
upstream Vocos beside WavTokenizer (MelSpectrogramFeatures, VocosBackbone or
VocosResNetBackbone, ISTFT or IMDCT heads); a ``VocosSpec`` picks the
feature extractor, trunk and head by kind, and ``vocos_forward`` runs
features -> backbone -> head, the composition decoder/pretrained.py:159-175
uses for WavTokenizer.

The ConvNeXt trunk is ``models/vocos.py::vocos_backbone``: on the card each
of its blocks is one ``ops/kernels.py::convnext_block`` (``csrc/convnext.cu``)
call, with plain LayerNorm's weight and bias as the kernel's scale and
shift.  In this fork's ``VocosBackbone`` the trunk also holds the pos-net
and attention block, so the family follows the JAX package, not upstream
Vocos's weights.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .alt_components import (IMDCTHeadConfig, MelFeaturesConfig, VocosResNetBackboneConfig,
                             imdct_cos_head, imdct_symexp_head, mel_features,
                             vocos_resnet_backbone)
from .vocos import ISTFTHeadConfig, VocosBackboneConfig, istft_head, vocos_backbone


@dataclass(frozen=True)
class VocosSpec:
    """A composed plain-Vocos model: the kinds select among the reference's
    interchangeable components (decoder/feature_extractors.py,
    decoder/models.py, decoder/heads.py)."""
    features: MelFeaturesConfig = MelFeaturesConfig()
    backbone_kind: str = "convnext"          # convnext | resnet
    backbone: VocosBackboneConfig | VocosResNetBackboneConfig = (
        VocosBackboneConfig(input_channels=100, adanorm_num_embeddings=None))
    head_kind: str = "istft"                 # istft | imdct_symexp | imdct_cos
    head: ISTFTHeadConfig | IMDCTHeadConfig = ISTFTHeadConfig(n_fft=1024, hop_length=256)

    @property
    def sample_rate(self) -> int:
        return self.features.sample_rate


_HEADS = {"istft": istft_head, "imdct_symexp": imdct_symexp_head,
          "imdct_cos": imdct_cos_head}


def vocos_features(params: dict, spec: VocosSpec, audio: torch.Tensor) -> torch.Tensor:
    """(B, T) audio -> (B, n_mels, T') log-mel features."""
    return mel_features(spec.features, audio)


def vocos_decode(params: dict, spec: VocosSpec, features: torch.Tensor,
                 bandwidth_id=None) -> torch.Tensor:
    """(B, C, T') features -> (B, L) waveform."""
    x = features.transpose(1, 2)
    if spec.backbone_kind == "convnext":
        h = vocos_backbone(params["backbone"], spec.backbone, x, bandwidth_id=bandwidth_id)
    elif spec.backbone_kind == "resnet":
        h = vocos_resnet_backbone(params["backbone"], spec.backbone, x)
    else:
        raise ValueError(spec.backbone_kind)
    if spec.head_kind not in _HEADS:
        raise ValueError(spec.head_kind)
    return _HEADS[spec.head_kind](params["head"], spec.head, h)


def vocos_forward(params: dict, spec: VocosSpec, audio: torch.Tensor,
                  bandwidth_id=None) -> torch.Tensor:
    """Copy synthesis through the plain-Vocos pipeline."""
    return vocos_decode(params, spec, vocos_features(params, spec, audio),
                        bandwidth_id=bandwidth_id)
