"""GAN discriminators: Vocos MPD/MRD and DAC (MPD + multi-band complex MRD).

Port of ``wavtokenizer_tpu/train/discriminators.py`` (ref
decoder/discriminators.py:9-202, decoder/discriminator_dac.py:36-237), in
PyTorch's NCHW layout, the reference's own: the period discriminators fold
audio (B, T) to (B, 1, T/p, p), the Vocos MRD reads its magnitude STFT as
(B, 1, F, T'), the DAC MRD its complex STFT as (B, 2, T', F) (real and imag
as channels).  The JAX package keeps the same axes channel-last, so its
feature maps are these with the channel axis moved last.

Every conv is weight-normed in training form {v (C_out, C_in, Kh, Kw),
g (C_out, 1, 1, 1), bias} (``train/wnorm.py``), folded in each forward.
LeakyReLU runs in place on each conv's output: its backward reads the
output, and nothing else reads the conv's output, so this keeps one
activation per layer for the backward instead of two, with the same values.

``compute_dtype`` (training's ``disc_compute_dtype``, e.g. bf16) runs the conv
stacks in that type, as the JAX package does (its ``_cast_floats``): the
weight norm is folded in fp32 and the folded weights, the inputs (the Vocos
MRD's magnitude after ``abs``, the DAC MRD's bands after the fp32 STFT) and
the conditional embeddings are cast; the conditional projection sums in
fp32.  The parameters stay fp32, and gradients come back fp32 through the
casts.

The MS-STFT discriminator (EnCodec's family, ref encoder/msstftd.py; no
WavTokenizer config selects it) is at the end.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import conv2d
from ..ops.spectral import hann_window, stft
from .wnorm import fold_tree, fold_wn

LRELU_SLOPE = 0.1

VOCOS_MPD_PERIODS = (2, 3, 5, 7, 11)
VOCOS_MRD_RESOLUTIONS = ((1024, 256, 1024), (2048, 512, 2048), (512, 128, 512))
DAC_PERIODS = (2, 3, 5, 7, 11)
DAC_FFT_SIZES = (2048, 1024, 512)
DAC_BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))


def _lrelu_(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE, inplace=True)


def cast_floats(tree, dtype):
    """Every floating tensor of a tree of dicts and lists cast to ``dtype``
    (None: the tree itself)."""
    if dtype is None:
        return tree
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_floats(v, dtype) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _folded(params, dtype):
    """The weight norm folded in fp32, then cast to the compute type."""
    return cast_floats(fold_tree(params), dtype)


def _cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


# --------------------------------------------------------------------------
# Init (torch Conv2d defaults U(+-1/sqrt(fan_in)), then weight_norm), drawn
# in the JAX package's order and (Kh, Kw, C_in, C_out) shapes, so that one
# seed gives both packages the same weights.
# --------------------------------------------------------------------------

def _conv2d_wn_init(rng, kh, kw, cin, cout) -> dict:
    bound = 1.0 / np.sqrt(cin * kh * kw)
    kernel = rng.uniform(-bound, bound, size=(kh, kw, cin, cout)).astype(np.float32)
    g = np.sqrt((kernel.astype(np.float64) ** 2).sum(axis=(0, 1, 2))).astype(np.float32)
    bias = rng.uniform(-bound, bound, size=(cout,)).astype(np.float32)
    return {"v": torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))),
            "g": torch.from_numpy(g.reshape(cout, 1, 1, 1)),
            "bias": torch.from_numpy(bias)}


def init_discriminators(seed: int = 0, num_embeddings: int | None = 4,
                        channels_scale: float = 1.0) -> dict:
    """All three families (ref experiment.py:387-389), on the CPU.
    ``channels_scale`` shrinks every hidden width (min 1) and keeps every
    family, period, resolution and band; training uses 1.0."""
    rng = np.random.default_rng(seed)
    params = {"mpd": [], "mrd": [], "dac_mpd": [], "dac_mrd": []}

    def s(c: int) -> int:
        return max(1, int(round(c * channels_scale)))

    def period_convs():
        chans = [(1, s(32)), (s(32), s(128)), (s(128), s(512)), (s(512), s(1024)),
                 (s(1024), s(1024))]
        return {"convs": [_conv2d_wn_init(rng, 5, 1, ci, co) for ci, co in chans],
                "conv_post": _conv2d_wn_init(rng, 3, 1, s(1024), 1)}

    for _ in VOCOS_MPD_PERIODS:
        d = period_convs()
        if num_embeddings is not None:
            d["emb"] = torch.zeros(num_embeddings, s(1024))
        params["mpd"].append(d)
    for _ in VOCOS_MRD_RESOLUTIONS:
        ch = s(64)
        specs = [(7, 5, 1, ch), (5, 3, ch, ch), (5, 3, ch, ch), (3, 3, ch, ch), (3, 3, ch, ch)]
        d = {"convs": [_conv2d_wn_init(rng, *k) for k in specs],
             "conv_post": _conv2d_wn_init(rng, 3, 3, ch, 1)}
        if num_embeddings is not None:
            d["emb"] = torch.zeros(num_embeddings, ch)
        params["mrd"].append(d)
    for _ in DAC_PERIODS:
        params["dac_mpd"].append(period_convs())
    for _ in DAC_FFT_SIZES:
        ch = s(32)
        bands = [[_conv2d_wn_init(rng, 3, 9, 2, ch), _conv2d_wn_init(rng, 3, 9, ch, ch),
                  _conv2d_wn_init(rng, 3, 9, ch, ch), _conv2d_wn_init(rng, 3, 9, ch, ch),
                  _conv2d_wn_init(rng, 3, 3, ch, ch)] for _ in DAC_BANDS]
        params["dac_mrd"].append({"bands": bands,
                                  "conv_post": _conv2d_wn_init(rng, 3, 3, ch, 1)})
    return params


def _conv(c: dict, h: torch.Tensor, stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    ph, pw = padding
    return conv2d(h, c["weight"], c["bias"], stride=stride, padding=((ph, ph), (pw, pw)))


def _cond(params: dict, h: torch.Tensor, cond_embedding_id) -> torch.Tensor | float:
    """The conditional projection sum_c emb[id]_c * h_c, (B, 1, H, W), the
    embedding in h's type and the sum in fp32 (or wider)."""
    if cond_embedding_id is None:
        return 0.0
    emb = params["emb"][cond_embedding_id].to(h.dtype)
    prod = emb[None, :, None, None] * h
    return prod.to(torch.promote_types(h.dtype, torch.float32)).sum(
        dim=1, keepdim=True).to(h.dtype)


# --------------------------------------------------------------------------
# Vocos DiscriminatorP / DiscriminatorR (ref discriminators.py:42-202)
# --------------------------------------------------------------------------

def _fold_to_period(x: torch.Tensor, period: int, always_pad: bool) -> torch.Tensor:
    """(B, T) -> (B, 1, T'/p, p) after a reflect right-pad to a multiple of
    p.  Vocos pads only when T % p != 0; DAC pads p - T % p always (p more
    samples when T is a multiple; ref discriminator_dac.py:53-56)."""
    B, T = x.shape
    rem = T % period
    if rem != 0 or always_pad:
        x = F.pad(x[:, None], (0, period - rem), mode="reflect")[:, 0]
    return x.reshape(B, 1, -1, period)


def discriminator_p(params: dict, period: int, x: torch.Tensor, cond_embedding_id=None,
                    compute_dtype=None):
    """x (B, T) -> (logits (B, N), fmap list), in ``compute_dtype``."""
    folded = _folded({"convs": params["convs"], "conv_post": params["conv_post"]},
                     compute_dtype)
    h = _fold_to_period(_cast(x, compute_dtype), period, always_pad=False)
    fmap = []
    for i, c in enumerate(folded["convs"]):
        h = _lrelu_(_conv(c, h, (3, 1) if i < 4 else (1, 1), (2, 0)))
        if i > 0:
            fmap.append(h)
    cond = _cond(params, h, cond_embedding_id)
    out = _conv(folded["conv_post"], h, padding=(1, 0))
    fmap.append(out)
    out = out + cond
    return out.reshape(out.shape[0], -1), fmap


_MRD_CONV_CFG = [((2, 2), (3, 2)), ((2, 1), (2, 1)), ((2, 2), (2, 1)), ((2, 1), (1, 1)),
                 ((2, 2), (1, 1))]


def discriminator_r(params: dict, resolution: tuple, x: torch.Tensor, cond_embedding_id=None,
                    compute_dtype=None):
    """x (B, T) -> (logits, fmap): the rectangular-window magnitude STFT as
    (B, 1, F, T') (the STFT in x's type, the conv stack in
    ``compute_dtype``)."""
    n_fft, hop, win = resolution
    folded = _folded({"convs": params["convs"], "conv_post": params["conv_post"]},
                     compute_dtype)
    spec = stft(x, n_fft, hop, win_length=win, window=np.ones(win, np.float32))
    h = _cast(spec.abs(), compute_dtype).transpose(1, 2)[:, None]
    fmap = []
    for c, (s, p) in zip(folded["convs"], _MRD_CONV_CFG):
        h = _lrelu_(_conv(c, h, s, p))
        fmap.append(h)
    cond = _cond(params, h, cond_embedding_id)
    out = _conv(folded["conv_post"], h, padding=(1, 1))
    fmap.append(out)
    out = out + cond
    return out.reshape(out.shape[0], -1), fmap


def multi_period_discriminator(params: list, y, y_hat, bandwidth_id=None):
    """ref discriminators.py:24-39: (real scores, fake scores, real fmaps,
    fake fmaps), each a list over periods."""
    rs, gs, fr, fg = [], [], [], []
    for p, period in zip(params, VOCOS_MPD_PERIODS):
        r, fmap_r = discriminator_p(p, period, y, bandwidth_id)
        g, fmap_g = discriminator_p(p, period, y_hat, bandwidth_id)
        rs.append(r); gs.append(g); fr.append(fmap_r); fg.append(fmap_g)
    return rs, gs, fr, fg


def multi_resolution_discriminator(params: list, y, y_hat, bandwidth_id=None):
    rs, gs, fr, fg = [], [], [], []
    for p, res in zip(params, VOCOS_MRD_RESOLUTIONS):
        r, fmap_r = discriminator_r(p, res, y, bandwidth_id)
        g, fmap_g = discriminator_r(p, res, y_hat, bandwidth_id)
        rs.append(r); gs.append(g); fr.append(fmap_r); fg.append(fmap_g)
    return rs, gs, fr, fg


# --------------------------------------------------------------------------
# DAC discriminator (ref discriminator_dac.py)
# --------------------------------------------------------------------------

def _dac_preprocess(y: torch.Tensor) -> torch.Tensor:
    """DC removal and 0.8 peak normalization (ref discriminator_dac.py:227-232)."""
    y = y - y.mean(dim=-1, keepdim=True)
    return 0.8 * y / (y.abs().amax(dim=-1, keepdim=True) + 1e-9)


def _dac_mpd(params: dict, period: int, x: torch.Tensor, compute_dtype=None) -> list:
    """x (B, T) -> fmap: every conv's activation, then conv_post's output."""
    folded = _folded(params, compute_dtype)
    h = _fold_to_period(_cast(x, compute_dtype), period, always_pad=True)
    fmap = []
    for i, c in enumerate(folded["convs"]):
        h = _lrelu_(_conv(c, h, (3, 1) if i < 4 else (1, 1), (2, 0)))
        fmap.append(h)
    fmap.append(_conv(folded["conv_post"], h, padding=(1, 0)))
    return fmap


_DAC_MRD_CONV_CFG = [((1, 1), (1, 4)), ((1, 2), (1, 4)), ((1, 2), (1, 4)), ((1, 2), (1, 4)),
                     ((1, 1), (1, 1))]


def _dac_mrd_spectrogram(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    """torch.stft defaults (hop n_fft // 4, rectangular window, center reflect
    pad); real and imag as 2 channels: (B, 2, T', F)."""
    spec = stft(x, n_fft, n_fft // 4, win_length=n_fft, window=np.ones(n_fft, np.float32))
    return torch.stack([spec.real, spec.imag], dim=1)


def _dac_mrd_band_slices(n_fft: int) -> list:
    n_bins = n_fft // 2 + 1
    return [(int(lo * n_bins), int(hi * n_bins)) for lo, hi in DAC_BANDS]


def _dac_mrd_band(stack: list, b: torch.Tensor, compute_dtype=None) -> list:
    """One band's conv stack over its slice of the spectrogram: the 5
    activations, the last the band's output."""
    fmap = []
    b = _cast(b, compute_dtype)
    for c, (s, p) in zip(_folded(stack, compute_dtype), _DAC_MRD_CONV_CFG):
        b = _lrelu_(_conv(c, b, s, p))
        fmap.append(b)
    return fmap


def _dac_mrd_post(post: dict, band_outs: list, compute_dtype=None) -> torch.Tensor:
    """conv_post over the band outputs concatenated along F."""
    return _conv(_folded(post, compute_dtype), torch.cat(band_outs, dim=3), padding=(1, 1))


def _dac_mrd(params: dict, n_fft: int, x: torch.Tensor, compute_dtype=None) -> list:
    """Complex multi-band spectrogram discriminator (ref :110-191): fmap of
    every band's 5 activations, band by band, then conv_post's output.  The
    spectrogram stays in x's type."""
    h = _dac_mrd_spectrogram(x, n_fft)
    fmap, outs = [], []
    for (lo, hi), stack in zip(_dac_mrd_band_slices(n_fft), params["bands"]):
        band = _dac_mrd_band(stack, h[..., lo:hi], compute_dtype)
        fmap.extend(band)
        outs.append(band[-1])
    fmap.append(_dac_mrd_post(params["conv_post"], outs, compute_dtype))
    return fmap


def dac_discriminator(params: dict, x: torch.Tensor, compute_dtype=None) -> list:
    """x (B, T) -> one fmap list per sub-discriminator, the 5 MPDs then the
    3 MRDs (ref discriminator_dac.py:234-237)."""
    x = _dac_preprocess(x)
    return ([_dac_mpd(p, period, x, compute_dtype)
             for p, period in zip(params["dac_mpd"], DAC_PERIODS)]
            + [_dac_mrd(p, n_fft, x, compute_dtype)
               for p, n_fft in zip(params["dac_mrd"], DAC_FFT_SIZES)])


# --------------------------------------------------------------------------
# MS-STFT discriminator (ref encoder/msstftd.py:28-128, EnCodec's family)
# --------------------------------------------------------------------------

# (n_fft, hop_length, win_length) per scale (ref msstftd.py:113-115).
MSSTFT_SCALES = ((1024, 256, 1024), (2048, 512, 2048), (512, 128, 512))
MSSTFT_DILATIONS = (1, 2, 4)
MSSTFT_FILTERS = 32


def init_msstft_discriminator(seed: int = 0, filters: int = MSSTFT_FILTERS) -> list:
    """The conv stacks of the 3 scales (ref msstftd.py:66-85), drawn as the
    JAX package draws them: every hidden layer ``filters`` wide, the input
    2 channels (real and imag).  The reference builds the FIRST conv of each
    scale without the norm argument (msstftd.py:69-71), so it is a plain
    conv {weight, bias} (its draw folded once); the others carry weight
    norm."""
    rng = np.random.default_rng(seed)
    params = []
    for _ in MSSTFT_SCALES:
        first = _conv2d_wn_init(rng, 3, 9, 2, filters)
        convs = [{"weight": fold_wn(first["v"], first["g"]), "bias": first["bias"]}]
        convs += [_conv2d_wn_init(rng, 3, 9, filters, filters) for _ in MSSTFT_DILATIONS]
        convs.append(_conv2d_wn_init(rng, 3, 3, filters, filters))
        params.append({"convs": convs, "conv_post": _conv2d_wn_init(rng, 3, 3, filters, 1)})
    return params


def discriminator_stft(params: dict, scale: tuple, x: torch.Tensor) -> tuple:
    """One DiscriminatorSTFT scale (ref msstftd.py:87-97): x (B, T) ->
    (logits (B, 1, T', F'), fmap).  The spectrogram is the Hann-windowed
    complex STFT without centering, divided by sqrt(sum(window^2))
    (torchaudio's Spectrogram(normalized=True, power=None)), as (B, 2, T', F)
    with real and imag as channels; the convs dilate the time axis; the
    LeakyReLU slope is 0.2 (msstftd.py:50)."""
    n_fft, hop, win = scale
    folded = fold_tree(params)
    w = hann_window(win)
    spec = stft(x, n_fft, hop, win_length=win, window=w, center=False)
    spec = spec * (1.0 / np.sqrt(np.sum(w.astype(np.float64) ** 2)))
    h = torch.stack([spec.real, spec.imag], dim=1)
    # (stride, time dilation, padding) per conv; the padding is the
    # reference's get_2d_padding: (k - 1) * d // 2 on time, (k - 1) // 2 on
    # frequency (msstftd.py:24-25).
    cfg = ([((1, 1), 1, ((1, 1), (4, 4)))]
           + [((1, 2), d, ((d, d), (4, 4))) for d in MSSTFT_DILATIONS]
           + [((1, 1), 1, ((1, 1), (1, 1)))])
    fmap = []
    for c, (stride, d, pad) in zip(folded["convs"], cfg):
        h = F.leaky_relu(conv2d(h, c["weight"], c["bias"], stride, pad, dilation=(d, 1)),
                         0.2, inplace=True)
        fmap.append(h)
    out = conv2d(h, folded["conv_post"]["weight"], folded["conv_post"]["bias"],
                 padding=((1, 1), (1, 1)))
    return out, fmap


def msstft_discriminator(params: list, x: torch.Tensor) -> tuple:
    """MultiScaleSTFTDiscriminator (ref msstftd.py:122-128): (logits, fmaps),
    each a list over the 3 scales."""
    logits, fmaps = [], []
    for p, scale in zip(params, MSSTFT_SCALES):
        out, fmap = discriminator_stft(p, scale, x)
        logits.append(out)
        fmaps.append(fmap)
    return logits, fmaps
