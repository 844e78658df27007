"""YAML config parsing: the reference's config files, unchanged.

Port of ``wavtokenizer_tpu/api/config.py``: WavTokenizer configs
(``spec_from_config_dict``) and plain-Vocos ones
(``vocos_spec_from_config_dict``).  The
reference uses LightningCLI-style ``class_path``/``init_args`` blocks
(ref configs/*.yaml, parsed at decoder/pretrained.py:81-92 through a dynamic
``__import__``); here the class names resolve into the frozen config
dataclasses, with no dynamic import.  Reading a file needs PyYAML, which is
imported only by ``spec_from_config``; nothing else in this package needs it.
"""

from __future__ import annotations

from ..models.quantize import VQConfig
from ..models.seanet import SEANetConfig
from ..models.vocos import ISTFTHeadConfig, VocosBackboneConfig
from ..models.wavtokenizer import WavTokenizerSpec


def _build_encodec_features(init_args: dict) -> tuple[SEANetConfig, VQConfig, tuple]:
    """Mirror of EncodecFeatures.__init__ (ref decoder/feature_extractors.py:
    54-96): fixed SEANet hyperparameters, ratios from ``dowmsamples`` [sic],
    VQ sizes from vq_bins / vq_kmeans / num_quantizers."""
    bandwidths = tuple(init_args.get("bandwidths", [1.5, 3.0, 6.0, 12.0]))
    seanet = SEANetConfig(
        channels=1, dimension=512, n_filters=32, n_residual_layers=1,
        ratios=tuple(init_args.get("dowmsamples", [6, 5, 5, 4])),
        kernel_size=7, last_kernel_size=7, residual_kernel_size=3,
        dilation_base=2, causal=False, pad_mode="reflect", true_skip=False,
        compress=2, lstm=2)
    vq = VQConfig(
        dimension=512,
        n_q=int(init_args.get("num_quantizers", 1)),
        bins=int(init_args.get("vq_bins", 16384)),
        kmeans_iters=int(init_args.get("vq_kmeans", 800)),
        decay=0.99, kmeans_init=True)
    return seanet, vq, bandwidths


def _class_name(class_path: str) -> str:
    return class_path.rsplit(".", 1)[-1]


def spec_from_config_dict(config: dict) -> WavTokenizerSpec:
    """A WavTokenizerSpec from a parsed YAML dict, in the Lightning layout
    (model.init_args.{feature_extractor, backbone, head}) or the flat one
    ({feature_extractor, backbone, head}), as the reference's from_hparams
    and from_hparams0802 accept."""
    if "model" in config and "init_args" in config.get("model", {}):
        blocks = config["model"]["init_args"]
        sample_rate = int(blocks.get("sample_rate", 24000))
    else:
        blocks = config
        sample_rate = int(config.get("sample_rate", 24000))

    fe = blocks["feature_extractor"]
    if _class_name(fe["class_path"]) != "EncodecFeatures":
        raise NotImplementedError(
            f"feature extractor {fe['class_path']}: use "
            "vocos_spec_from_config_dict / api.pretrained.Vocos for plain-Vocos configs")
    seanet, vq, bandwidths = _build_encodec_features(fe.get("init_args", {}))

    bb = blocks["backbone"]
    if _class_name(bb["class_path"]) != "VocosBackbone":
        raise NotImplementedError(f"backbone {bb['class_path']} not supported yet")
    a = bb.get("init_args", {})
    backbone = VocosBackboneConfig(
        input_channels=int(a.get("input_channels", 512)),
        dim=int(a.get("dim", 768)),
        intermediate_dim=int(a.get("intermediate_dim", 2304)),
        num_layers=int(a.get("num_layers", 12)),
        adanorm_num_embeddings=a.get("adanorm_num_embeddings"))

    hd = blocks["head"]
    if _class_name(hd["class_path"]) != "ISTFTHead":
        raise NotImplementedError(f"head {hd['class_path']} not supported yet")
    a = hd.get("init_args", {})
    head = ISTFTHeadConfig(
        dim=int(a.get("dim", 768)),
        n_fft=int(a.get("n_fft", 1280)),
        hop_length=int(a.get("hop_length", 320)),
        padding=a.get("padding", "same"))

    return WavTokenizerSpec(seanet=seanet, vq=vq, backbone=backbone, head=head,
                            bandwidths=bandwidths, sample_rate=sample_rate)


def _load_yaml(config_path: str) -> dict:
    import yaml
    with open(config_path) as f:
        return yaml.safe_load(f)


def spec_from_config(config_path: str) -> WavTokenizerSpec:
    """Parse a YAML config file (needs PyYAML)."""
    return spec_from_config_dict(_load_yaml(config_path))


def vocos_spec_from_config_dict(config: dict):
    """A plain-Vocos ``VocosSpec`` from a parsed YAML dict, Lightning or
    flat layout: MelSpectrogramFeatures + {VocosBackbone |
    VocosResNetBackbone} + {ISTFTHead | IMDCTSymExpHead | IMDCTCosHead}."""
    from ..models.alt_components import (IMDCTHeadConfig, MelFeaturesConfig,
                                         VocosResNetBackboneConfig)
    from ..models.vocos_model import VocosSpec

    blocks = (config["model"]["init_args"]
              if "model" in config and "init_args" in config.get("model", {}) else config)

    fe = blocks["feature_extractor"]
    if _class_name(fe["class_path"]) != "MelSpectrogramFeatures":
        raise NotImplementedError(fe["class_path"])
    a = fe.get("init_args", {})
    features = MelFeaturesConfig(
        sample_rate=int(a.get("sample_rate", 24000)), n_fft=int(a.get("n_fft", 1024)),
        hop_length=int(a.get("hop_length", 256)), n_mels=int(a.get("n_mels", 100)),
        padding=a.get("padding", "center"))

    bb = blocks["backbone"]
    a = bb.get("init_args", {})
    if _class_name(bb["class_path"]) == "VocosBackbone":
        backbone_kind = "convnext"
        backbone = VocosBackboneConfig(
            input_channels=int(a.get("input_channels", features.n_mels)),
            dim=int(a.get("dim", 512)),
            intermediate_dim=int(a.get("intermediate_dim", 1536)),
            num_layers=int(a.get("num_layers", 8)),
            adanorm_num_embeddings=a.get("adanorm_num_embeddings"))
    elif _class_name(bb["class_path"]) == "VocosResNetBackbone":
        backbone_kind = "resnet"
        backbone = VocosResNetBackboneConfig(
            input_channels=int(a.get("input_channels", features.n_mels)),
            dim=int(a.get("dim", 512)), num_blocks=int(a.get("num_blocks", 3)))
    else:
        raise NotImplementedError(bb["class_path"])

    hd = blocks["head"]
    a = hd.get("init_args", {})
    name = _class_name(hd["class_path"])
    if name == "ISTFTHead":
        head_kind = "istft"
        head = ISTFTHeadConfig(dim=int(a.get("dim", 512)), n_fft=int(a.get("n_fft", 1024)),
                               hop_length=int(a.get("hop_length", 256)),
                               padding=a.get("padding", "same"))
    elif name in ("IMDCTSymExpHead", "IMDCTCosHead"):
        head_kind = "imdct_symexp" if name == "IMDCTSymExpHead" else "imdct_cos"
        head = IMDCTHeadConfig(dim=int(a.get("dim", 512)),
                               mdct_frame_len=int(a.get("mdct_frame_len", 512)),
                               padding=a.get("padding", "same"),
                               clip_audio=bool(a.get("clip_audio", False)))
    else:
        raise NotImplementedError(hd["class_path"])

    return VocosSpec(features=features, backbone_kind=backbone_kind, backbone=backbone,
                     head_kind=head_kind, head=head)


def vocos_spec_from_config(config_path: str):
    """Parse a plain-Vocos YAML config file (needs PyYAML)."""
    return vocos_spec_from_config_dict(_load_yaml(config_path))
