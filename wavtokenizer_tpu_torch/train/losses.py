"""GAN and reconstruction losses (ref decoder/loss.py:12-158).

Port of ``wavtokenizer_tpu/train/losses.py``.  The list-level primitives
(``hinge_*``, ``feature_matching_loss``, ``dac_*_loss``) work on scores and
feature maps already computed.  The per-family losses the step calls
(``vocos_disc_loss``, ``vocos_gen_loss``, ``dac_disc_loss``,
``dac_gen_loss``) are the JAX package's ``*_fused`` functions: the same
values, built from the primitives sub-discriminator by sub-discriminator,
with the same rematerialization boundaries under ``remat``
(``ops/remat.py``): each scalar term of a sub-discriminator in its own
checkpoint (the real and fake hinge or least-squares terms apart in the
discriminator phase, together in the generator phase), the DAC MRDs band
by band.  ``compute_dtype`` runs the conv stacks in that type
(``train/discriminators.py``); the loss arithmetic is fp32 (or wider).

The generator-phase losses run the discriminators on the real audio under
``torch.no_grad``: no gradient reaches the generator through the real
branch (DAC's feature loss stops it explicitly, and the Vocos feature
matching's real maps depend on no generator tensor), and the step takes no
discriminator gradient in that phase.  That keeps no activation of the real
branch for the backward.
"""

from __future__ import annotations

import torch

from ..ops.remat import checkpointed
from ..ops.spectral import mel_spectrogram, safe_log
from .discriminators import (DAC_FFT_SIZES, DAC_PERIODS, VOCOS_MPD_PERIODS,
                             VOCOS_MRD_RESOLUTIONS, _dac_mpd, _dac_mrd_band,
                             _dac_mrd_band_slices, _dac_mrd_post, _dac_mrd_spectrogram,
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

def _wide(t: torch.Tensor) -> torch.Tensor:
    """A discriminator output in the loss arithmetic's type: fp32, or wider."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _vocos_subs(params: list, family: str) -> list:
    if family == "mpd":
        return [(p, lambda p, x, bw, dt, per=per: discriminator_p(p, per, x, bw, dt))
                for p, per in zip(params, VOCOS_MPD_PERIODS)]
    return [(p, lambda p, x, bw, dt, res=res: discriminator_r(p, res, x, bw, dt))
            for p, res in zip(params, VOCOS_MRD_RESOLUTIONS)]


def vocos_disc_loss(params: list, family: str, y: torch.Tensor, y_hat: torch.Tensor,
                    bandwidth_id=None, remat: bool = False,
                    compute_dtype=None) -> torch.Tensor:
    """Discriminator-phase hinge loss of one Vocos family ("mpd" or "mrd"),
    divided by its sub-discriminator count (experiment.py:140-148); JAX's
    ``vocos_disc_loss_fused``."""
    def real_term(p, y, fwd):
        r, _ = fwd(p, y, bandwidth_id, compute_dtype)
        return torch.clamp(1.0 - _wide(r), min=0.0).mean()

    def fake_term(p, y_hat, fwd):
        g, _ = fwd(p, y_hat, bandwidth_id, compute_dtype)
        return torch.clamp(1.0 + _wide(g), min=0.0).mean()

    subs = _vocos_subs(params, family)
    total = 0.0
    for p, fwd in subs:
        total = total + checkpointed(real_term, p, y, fwd, remat=remat)
        total = total + checkpointed(fake_term, p, y_hat, fwd, remat=remat)
    return total / len(subs)


def vocos_gen_loss(params: list, family: str, y: torch.Tensor, y_hat: torch.Tensor,
                   bandwidth_id=None, remat: bool = False, compute_dtype=None) -> tuple:
    """Generator-phase (hinge, feature matching) of one Vocos family, each
    divided by the sub-discriminator count (experiment.py:164-171); JAX's
    ``vocos_gen_loss_fused``."""
    def one(p, y_hat, fwd):
        out, fmap_g = fwd(p, y_hat, bandwidth_id, compute_dtype)
        with torch.no_grad():
            _, fmap_r = fwd(p, y, bandwidth_id, compute_dtype)
        return (hinge_generator_loss([_wide(out)]),
                feature_matching_loss([[_wide(a) for a in fmap_r]],
                                      [[_wide(a) for a in fmap_g]]))

    subs = _vocos_subs(params, family)
    total_g, total_fm = 0.0, 0.0
    for p, fwd in subs:
        lg, lfm = checkpointed(one, p, y_hat, fwd, remat=remat)
        total_g, total_fm = total_g + lg, total_fm + lfm
    return total_g / len(subs), total_fm / len(subs)


def _dac_mrd_out(p: dict, n_fft: int, x: torch.Tensor, remat: bool, compute_dtype,
                 real: torch.Tensor | None = None) -> tuple:
    """One DAC MRD's conv_post output, each band's stack in its own
    checkpoint; with ``real``, also the sum over the bands of the feature L1
    against the real audio's maps (JAX's ``_dac_mrd_conv_post``)."""
    spec = _dac_mrd_spectrogram(x, n_fft)
    spec_r = None if real is None else _dac_mrd_spectrogram(real, n_fft)

    def band(stack, s):
        return _dac_mrd_band(stack, s, compute_dtype)[-1]

    def band_pair(stack, s, sr):
        fmap = _dac_mrd_band(stack, s, compute_dtype)
        with torch.no_grad():
            fmap_r = _dac_mrd_band(stack, sr, compute_dtype)
        l1 = sum((_wide(a) - _wide(b)).abs().mean() for a, b in zip(fmap, fmap_r))
        return l1, fmap[-1]

    outs, l1 = [], 0.0
    for (lo, hi), stack in zip(_dac_mrd_band_slices(n_fft), p["bands"]):
        if spec_r is None:
            outs.append(checkpointed(band, stack, spec[..., lo:hi], remat=remat))
        else:
            lf, out = checkpointed(band_pair, stack, spec[..., lo:hi], spec_r[..., lo:hi],
                                   remat=remat)
            outs.append(out)
            l1 = l1 + lf
    return _dac_mrd_post(p["conv_post"], outs, compute_dtype), l1


def dac_disc_loss(disc_params: dict, fake: torch.Tensor, real: torch.Tensor,
                  remat: bool = False, compute_dtype=None) -> torch.Tensor:
    """= ``dac_discriminator_loss``, sub-discriminator by sub-discriminator
    (JAX's ``dac_disc_loss_fused``)."""
    fake, real = _dac_preprocess(fake), _dac_preprocess(real)

    def mpd_fake(p, x, period):
        return (_wide(_dac_mpd(p, period, x, compute_dtype)[-1]) ** 2).mean()

    def mpd_real(p, x, period):
        return ((1.0 - _wide(_dac_mpd(p, period, x, compute_dtype)[-1])) ** 2).mean()

    loss = 0.0
    for p, period in zip(disc_params["dac_mpd"], DAC_PERIODS):
        loss = loss + checkpointed(mpd_fake, p, fake, period, remat=remat)
        loss = loss + checkpointed(mpd_real, p, real, period, remat=remat)
    for p, n_fft in zip(disc_params["dac_mrd"], DAC_FFT_SIZES):
        out_f = _wide(_dac_mrd_out(p, n_fft, fake, remat, compute_dtype)[0])
        out_r = _wide(_dac_mrd_out(p, n_fft, real, remat, compute_dtype)[0])
        loss = loss + (out_f ** 2).mean() + ((1.0 - out_r) ** 2).mean()
    return loss


def dac_gen_loss(disc_params: dict, fake: torch.Tensor, real: torch.Tensor,
                 remat: bool = False, compute_dtype=None) -> tuple:
    """= ``dac_generator_loss``, sub-discriminator by sub-discriminator
    (JAX's ``dac_gen_loss_fused``): (loss_g, loss_feature)."""
    fake, real = _dac_preprocess(fake), _dac_preprocess(real)

    def mpd_pair(p, fake, period):
        fmap = _dac_mpd(p, period, fake, compute_dtype)
        with torch.no_grad():
            fmap_r = _dac_mpd(p, period, real, compute_dtype)
        lf = sum((_wide(a) - _wide(b)).abs().mean() for a, b in zip(fmap[:-1], fmap_r[:-1]))
        return ((1.0 - _wide(fmap[-1])) ** 2).mean(), lf

    loss_g, loss_feature = 0.0, 0.0
    for p, period in zip(disc_params["dac_mpd"], DAC_PERIODS):
        lg, lf = checkpointed(mpd_pair, p, fake, period, remat=remat)
        loss_g, loss_feature = loss_g + lg, loss_feature + lf
    for p, n_fft in zip(disc_params["dac_mrd"], DAC_FFT_SIZES):
        out_f, lf = _dac_mrd_out(p, n_fft, fake, remat, compute_dtype, real=real)
        loss_g = loss_g + ((1.0 - _wide(out_f)) ** 2).mean()
        loss_feature = loss_feature + lf
    return loss_g, loss_feature
