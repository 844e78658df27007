"""YAML config parsing: the reference's config files, unchanged.

Port of the WavTokenizer part of ``wavtokenizer_tpu/api/config.py``.  The
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
            f"feature extractor {fe['class_path']}: plain-Vocos configs are "
            "not ported yet")
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


def spec_from_config(config_path: str) -> WavTokenizerSpec:
    """Parse a YAML config file (needs PyYAML)."""
    import yaml
    with open(config_path) as f:
        config = yaml.safe_load(f)
    return spec_from_config_dict(config)
