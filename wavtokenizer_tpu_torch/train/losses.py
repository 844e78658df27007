"""GAN and reconstruction losses (ref decoder/loss.py:12-158).

Port of ``wavtokenizer_tpu/train/losses.py``.  The list-level primitives
(``hinge_*``, ``feature_matching_loss``, ``dac_*_loss``) work on scores and
feature maps already computed.  The per-family losses the step calls
(``vocos_disc_loss``, ``vocos_gen_loss``, ``dac_disc_loss``,
``dac_gen_loss``) give the values of the JAX package's ``*_fused`` functions,
built, like them, from the primitives sub-discriminator by
sub-discriminator.  JAX fuses them to set its rematerialization boundaries;
here they are plain functions.

The generator-phase losses run the discriminators on the real audio under
``torch.no_grad``: no gradient reaches the generator through the real
branch (DAC's feature loss stops it explicitly, and the Vocos feature
matching's real maps depend on no generator tensor), and the step takes no
discriminator gradient in that phase.  That keeps no activation of the real
branch for the backward.
"""

from __future__ import annotations

import torch

from ..ops.spectral import mel_spectrogram, safe_log
from .discriminators import (DAC_FFT_SIZES, DAC_PERIODS, VOCOS_MPD_PERIODS,
                             VOCOS_MRD_RESOLUTIONS, _dac_mpd, _dac_mrd,
                             _dac_preprocess, dac_discriminator, discriminator_p,
                             discriminator_r)


def mel_loss(y_hat: torch.Tensor, y: torch.Tensor, sample_rate: int = 24000,
             n_fft: int = 1024, hop_length: int = 256, n_mels: int = 100) -> torch.Tensor:
    """L1 between safe_log mel magnitudes (ref loss.py:12-39)."""
    mel_hat = safe_log(mel_spectrogram(y_hat, sample_rate, n_fft, hop_length, n_mels))
    mel = safe_log(mel_spectrogram(y, sample_rate, n_fft, hop_length, n_mels))
    return (mel - mel_hat).abs().mean()


def hinge_generator_loss(disc_outputs: list) -> torch.Tensor:
    """sum of mean(clamp(1 - dg, min=0)) (ref loss.py:42-63)."""
    return sum(torch.clamp(1.0 - dg, min=0.0).mean() for dg in disc_outputs)


def hinge_discriminator_loss(disc_real: list, disc_gen: list) -> torch.Tensor:
    """sum of the real and fake hinge terms (ref loss.py:66-94)."""
    loss = 0.0
    for dr, dg in zip(disc_real, disc_gen):
        loss = loss + torch.clamp(1.0 - dr, min=0.0).mean()
        loss = loss + torch.clamp(1.0 + dg, min=0.0).mean()
    return loss


def feature_matching_loss(fmap_r: list, fmap_g: list) -> torch.Tensor:
    """sum over discriminators and layers of mean |real - gen| (ref loss.py:97-116)."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + (rl - gl).abs().mean()
    return loss


def _ls_disc_terms(d_fake: list, d_real: list) -> torch.Tensor:
    loss = 0.0
    for x_fake, x_real in zip(d_fake, d_real):
        loss = loss + (x_fake[-1] ** 2).mean()
        loss = loss + ((1.0 - x_real[-1]) ** 2).mean()
    return loss


def _ls_gen_terms(d_fake: list, d_real: list) -> tuple:
    loss_g = 0.0
    for x_fake in d_fake:
        loss_g = loss_g + ((1.0 - x_fake[-1]) ** 2).mean()
    loss_feature = 0.0
    for x_fake, x_real in zip(d_fake, d_real):
        for a, b in zip(x_fake[:-1], x_real[:-1]):
            loss_feature = loss_feature + (a - b.detach()).abs().mean()
    return loss_g, loss_feature


def dac_discriminator_loss(disc_params: dict, fake: torch.Tensor,
                           real: torch.Tensor) -> torch.Tensor:
    """Least-squares discriminator loss over the conv_post outputs
    (ref loss.py:137-144); ``fake`` comes detached."""
    return _ls_disc_terms(dac_discriminator(disc_params, fake),
                          dac_discriminator(disc_params, real))


def dac_generator_loss(disc_params: dict, fake: torch.Tensor, real: torch.Tensor) -> tuple:
    """LS generator loss and L1 feature loss (ref loss.py:146-158):
    (loss_g, loss_feature)."""
    return _ls_gen_terms(dac_discriminator(disc_params, fake),
                         dac_discriminator(disc_params, real))


# --------------------------------------------------------------------------
# Per-family losses, as the step wires them (ref experiment.py:125-218)
# --------------------------------------------------------------------------

def _vocos_subs(params: list, family: str) -> list:
    if family == "mpd":
        return [(p, lambda p, x, bw, per=per: discriminator_p(p, per, x, bw))
                for p, per in zip(params, VOCOS_MPD_PERIODS)]
    return [(p, lambda p, x, bw, res=res: discriminator_r(p, res, x, bw))
            for p, res in zip(params, VOCOS_MRD_RESOLUTIONS)]


def vocos_disc_loss(params: list, family: str, y: torch.Tensor, y_hat: torch.Tensor,
                    bandwidth_id=None) -> torch.Tensor:
    """Discriminator-phase hinge loss of one Vocos family ("mpd" or "mrd"),
    divided by its sub-discriminator count (experiment.py:140-148); the
    value of JAX's ``vocos_disc_loss_fused``."""
    subs = _vocos_subs(params, family)
    total = 0.0
    for p, fwd in subs:
        r, _ = fwd(p, y, bandwidth_id)
        g, _ = fwd(p, y_hat, bandwidth_id)
        total = total + hinge_discriminator_loss([r], [g])
    return total / len(subs)


def vocos_gen_loss(params: list, family: str, y: torch.Tensor, y_hat: torch.Tensor,
                   bandwidth_id=None) -> tuple:
    """Generator-phase (hinge, feature matching) of one Vocos family, each
    divided by the sub-discriminator count (experiment.py:164-171); the
    values of JAX's ``vocos_gen_loss_fused``."""
    subs = _vocos_subs(params, family)
    total_g, total_fm = 0.0, 0.0
    for p, fwd in subs:
        out, fmap_g = fwd(p, y_hat, bandwidth_id)
        with torch.no_grad():
            _, fmap_r = fwd(p, y, bandwidth_id)
        total_g = total_g + hinge_generator_loss([out])
        total_fm = total_fm + feature_matching_loss([fmap_r], [fmap_g])
    return total_g / len(subs), total_fm / len(subs)


def _dac_subs(disc_params: dict) -> list:
    return ([lambda x, p=p, per=per: _dac_mpd(p, per, x)
             for p, per in zip(disc_params["dac_mpd"], DAC_PERIODS)]
            + [lambda x, p=p, n=n: _dac_mrd(p, n, x)
               for p, n in zip(disc_params["dac_mrd"], DAC_FFT_SIZES)])


def dac_disc_loss(disc_params: dict, fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """= ``dac_discriminator_loss``, sub-discriminator by sub-discriminator
    (the value of JAX's ``dac_disc_loss_fused``)."""
    fake, real = _dac_preprocess(fake), _dac_preprocess(real)
    loss = 0.0
    for fwd in _dac_subs(disc_params):
        loss = loss + _ls_disc_terms([fwd(fake)], [fwd(real)])
    return loss


def dac_gen_loss(disc_params: dict, fake: torch.Tensor, real: torch.Tensor) -> tuple:
    """= ``dac_generator_loss``, sub-discriminator by sub-discriminator
    (the values of JAX's ``dac_gen_loss_fused``): (loss_g, loss_feature)."""
    fake, real = _dac_preprocess(fake), _dac_preprocess(real)
    loss_g, loss_feature = 0.0, 0.0
    for fwd in _dac_subs(disc_params):
        d_fake = fwd(fake)
        with torch.no_grad():
            d_real = fwd(real)
        lg, lf = _ls_gen_terms([d_fake], [d_real])
        loss_g, loss_feature = loss_g + lg, loss_feature + lf
    return loss_g, loss_feature
