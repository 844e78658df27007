"""The port's SEANet decoder and EnCodec path against the JAX package on the
CPU: transposed convs and their trims (causal and not, with and without the
GroupNorm on the untrimmed output), the decoder stack, the EnCodec round
trip (full-sequence and segmented with volume normalization and a ragged
tail; causal weight_norm and stereo time_group_norm), the EnCodec state-dict
converter on a state dict written at test time, the overlap-add and the
factory configs.

Narrow widths (n_filters 4, dimension 32, clips of at most 0.2 s), weights
from seeded numpy; the GroupNorm affines are drawn here, since the JAX init
draws none.  Codes are compared exactly; waveforms to 1e-4 relative (fp32
on both sides, other summation orders).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavtokenizer_tpu.checkpoint.convert import convert_encodec_state_dict as j_convert
from wavtokenizer_tpu.checkpoint.export import quantizer_export, seanet_export
from wavtokenizer_tpu.models import encodec as je
from wavtokenizer_tpu.models import seanet as js
from wavtokenizer_tpu.models.init import init_quantizer, init_seanet
from wavtokenizer_tpu.models.quantize import VQConfig as JVQConfig
from wavtokenizer_tpu.ops.conv import sconv_transpose1d as j_sconvtr
from wavtokenizer_tpu.ops.resample import linear_overlap_add as j_ola
from wavtokenizer_tpu_torch.api.pretrained import encodec_from_jax_params, seanet_from_jax
from wavtokenizer_tpu_torch.checkpoint.convert import (TrackedStateDict,
                                                       convert_encodec_state_dict)
from wavtokenizer_tpu_torch.models import encodec as te
from wavtokenizer_tpu_torch.models import seanet as ts
from wavtokenizer_tpu_torch.models.init import init_encodec
from wavtokenizer_tpu_torch.models.quantize import VQConfig
from wavtokenizer_tpu_torch.ops.conv import sconv_transpose1d as t_sconvtr
from wavtokenizer_tpu_torch.ops.resample import linear_overlap_add as t_ola

SEANET_KW = dict(dimension=32, n_filters=4, n_residual_layers=1, ratios=(8, 5, 4, 2), lstm=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test run's parallel workers share the cores,
    and PyTorch's default pool (a thread per core) in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _tree_equal(a, b, path="params"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def _add_gn(params: list, rng) -> None:
    """Random GroupNorm affines on every conv of a time_group_norm stack."""
    for p in params:
        convs = [p] if "kernel" in p else p.get("block", []) + (
            [p["shortcut"]] if "shortcut" in p else [])
        for conv in convs:
            c = conv["kernel"].shape[-1]
            conv["gn"] = {"weight": (rng.normal(size=c) * 0.5 + 1).astype(np.float32),
                          "bias": (rng.normal(size=c) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("k,stride,causal,trim,gn", [
    (4, 2, False, 1.0, False),
    (16, 8, False, 1.0, False),
    (10, 5, True, 1.0, False),
    (8, 4, True, 0.5, False),
    (7, 3, True, 0.25, True),
    (4, 2, False, 1.0, True),
    (3, 1, False, 1.0, False),
    (16, 8, True, 1.0, True),
])
def test_sconv_transpose1d_matches_jax(k, stride, causal, trim, gn):
    rng = np.random.default_rng(k * 100 + stride)
    x = rng.normal(size=(2, 13, 6)).astype(np.float32)
    kern = (rng.normal(size=(k, 6, 5)) * 0.3).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    gnp = {"weight": (rng.normal(size=5) + 1).astype(np.float32),
           "bias": rng.normal(size=5).astype(np.float32)}
    want = j_sconvtr(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(bias), stride=stride,
                     causal=causal, trim_right_ratio=trim,
                     norm_fn=functools.partial(js._time_group_norm, gnp) if gn else None)
    tgn = {n: torch.from_numpy(v) for n, v in gnp.items()}
    got = t_sconvtr(torch.from_numpy(x), torch.from_numpy(kern.transpose(1, 2, 0).copy()),
                    torch.from_numpy(bias), stride=stride, causal=causal,
                    trim_right_ratio=trim,
                    norm_fn=functools.partial(ts._time_group_norm, tgn) if gn else None)
    assert got.shape == want.shape == (2, 13 * stride, 5)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("extra", [
    dict(), dict(causal=True), dict(norm="time_group_norm", channels=2),
    dict(final_activation="Tanh", true_skip=True)])
def test_seanet_decode_matches_jax(extra):
    kw = {**SEANET_KW, **extra}
    jcfg, tcfg = js.SEANetConfig(**kw), ts.SEANetConfig(**kw)
    rng = np.random.default_rng(len(extra))
    params = init_seanet(rng, jcfg, encoder=False)
    if jcfg.norm == "time_group_norm":
        _add_gn(params, rng)
    z = rng.normal(size=(2, 7, 32)).astype(np.float32)
    want = jax.jit(lambda p, v: js.seanet_decode(p, jcfg, v))(params, jnp.asarray(z))
    got = ts.seanet_decode(seanet_from_jax(params, ts.decoder_layer_specs(tcfg), "cpu"),
                           tcfg, torch.from_numpy(z))
    assert got.shape == want.shape == (2, 7 * 320, jcfg.channels)
    assert _rel(got, want) <= 1e-4


def _configs(norm, channels, causal, segment, normalize, bandwidth=None):
    seanet = dict(SEANET_KW, channels=channels, norm=norm, causal=causal)
    # 64 bins at 75 frames/s: 0.45 kbps a quantizer, so 0.5 kbps selects one.
    common = dict(sample_rate=24000, channels=channels, normalize=normalize,
                  segment=segment, target_bandwidths=(0.5, 1.0), bandwidth=bandwidth)
    return (je.EncodecConfig(js.SEANetConfig(**seanet), JVQConfig(dimension=32, n_q=2, bins=64),
                             **common),
            te.EncodecConfig(ts.SEANetConfig(**seanet), VQConfig(dimension=32, n_q=2, bins=64),
                             **common))


def _jax_params(jcfg, x: np.ndarray, seed: int) -> dict:
    """JAX EnCodec params in ``init_encodec``'s draw order, GroupNorm affines
    randomized, codebooks drawn around the encoder's embeddings of ``x``."""
    rng = np.random.default_rng(seed)
    params = {"encoder": init_seanet(rng, jcfg.seanet, encoder=True),
              "decoder": init_seanet(rng, jcfg.seanet, encoder=False),
              "quantizer": init_quantizer(rng, jcfg.vq, random_codebook=True)}
    if jcfg.seanet.norm == "time_group_norm":
        _add_gn(params["encoder"], rng)
        _add_gn(params["decoder"], rng)
    # The port's encoder, for speed: only the embeddings' spread is needed.
    tcfg = ts.SEANetConfig(**dataclasses.asdict(jcfg.seanet))
    with torch.inference_mode():
        emb = ts.seanet_encode(seanet_from_jax(params["encoder"], ts.encoder_layer_specs(tcfg),
                                               "cpu"), tcfg,
                               torch.from_numpy(x.transpose(0, 2, 1).copy())).numpy()
    emb = emb.reshape(-1, emb.shape[-1])
    books = [emb.mean(0) + rng.normal(size=(64, 32)) * emb.std(0),
             rng.normal(size=(64, 32)) * emb.std(0) * 0.5]
    params["quantizer"]["embed"] = np.stack(books).astype(np.float32)
    return params


@pytest.mark.parametrize("case", ["causal_full", "tgn_stereo_segmented", "normalized_bandwidth"])
def test_encodec_round_trip_matches_jax(case):
    jcfg, tcfg = {
        # the 24 kHz model's layout: causal, weight_norm, one full-length frame
        "causal_full": _configs("weight_norm", 1, True, None, False),
        # the 48 kHz model's: stereo, GroupNorm, normalized 0.05 s segments
        # (1200 samples, stride 1188) over 2400 samples: 3 frames, the last
        # one 24 samples long, encoded unpadded
        "tgn_stereo_segmented": _configs("time_group_norm", 2, False, 0.05, True),
        # a selected bandwidth picks n_q = 1 of the 2 layers
        "normalized_bandwidth": _configs("weight_norm", 1, False, 0.05, True, bandwidth=0.5),
    }[case]
    x = (np.random.default_rng(7).normal(size=(2, jcfg.channels, 2400)) * 0.3).astype(np.float32)
    params = _jax_params(jcfg, x, 11)
    frames_j = jax.jit(lambda p, a: je.encode(p, jcfg, a))(params, jnp.asarray(x))
    out_j = np.asarray(jax.jit(lambda p, f: je.decode(p, jcfg, f))(params, frames_j))
    tparams = encodec_from_jax_params(params, tcfg, device="cpu")
    frames = te.encode(tparams, tcfg, torch.from_numpy(x))
    assert len(frames) == len(frames_j)
    for (codes, scale), (codes_j, scale_j) in zip(frames, frames_j):
        assert codes.dtype == torch.int32
        np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
        if scale_j is None:
            assert scale is None
        else:
            assert _rel(scale, scale_j) <= 1e-6
    n_q = 1 if case == "normalized_bandwidth" else 2
    assert frames[0][0].shape[1] == n_q
    assert len(np.unique(frames[0][0][:, 0].numpy())) > 3
    if case == "tgn_stereo_segmented":
        assert [f[0].shape[-1] for f in frames] == [4, 4, 1]
    out = te.decode(tparams, tcfg, frames)
    assert out.shape == out_j.shape
    assert _rel(out, out_j) <= 1e-4
    fwd = te.forward(tparams, tcfg, torch.from_numpy(x))
    assert fwd.shape == x.shape
    np.testing.assert_array_equal(fwd.numpy(), out.numpy()[:, :, :x.shape[-1]])


def test_init_encodec_draws_like_jax():
    """``init_encodec`` = JAX init_seanet (encoder, decoder) + init_quantizer
    from one generator, plus unit GroupNorm affines."""
    _, tcfg = _configs("time_group_norm", 2, False, 1.0, True)
    jcfg = _configs("time_group_norm", 2, False, 1.0, True)[0]
    rng = np.random.default_rng(5)
    want = {"encoder": init_seanet(rng, jcfg.seanet, encoder=True),
            "decoder": init_seanet(rng, jcfg.seanet, encoder=False),
            "quantizer": init_quantizer(rng, jcfg.vq, random_codebook=True)}
    got = init_encodec(tcfg, seed=5)
    gn = got["encoder"][0].pop("gn")
    np.testing.assert_array_equal(gn["weight"], np.ones(4, np.float32))
    np.testing.assert_array_equal(gn["bias"], np.zeros(4, np.float32))
    for p in got["encoder"] + got["decoder"]:
        for conv in [p] + p.get("block", []) + ([p["shortcut"]] if "shortcut" in p else []):
            conv.pop("gn", None)
    _tree_equal(got, want)


@pytest.mark.parametrize("norm", ["weight_norm", "time_group_norm"])
def test_convert_encodec_state_dict_uses_every_key(norm):
    jcfg, tcfg = _configs(norm, 1, norm == "weight_norm", None, False)
    x = (np.random.default_rng(2).normal(size=(1, 1, 1600)) * 0.3).astype(np.float32)
    params = _jax_params(jcfg, x, 2)
    sd = {}
    seanet_export(sd, "encoder.", params["encoder"], js.encoder_layer_specs(jcfg.seanet),
                  "weight_g")
    seanet_export(sd, "decoder.", params["decoder"], js.decoder_layer_specs(jcfg.seanet),
                  "weight_g")
    quantizer_export(sd, "quantizer.", params["quantizer"])
    assert any(k.endswith(".norm.weight") for k in sd) == (norm == "time_group_norm")
    tracked = TrackedStateDict({k: torch.from_numpy(np.ascontiguousarray(v))
                                for k, v in sd.items()})
    got = convert_encodec_state_dict(tracked, tcfg)
    assert tracked.unused() == set()
    _tree_equal(got, j_convert(sd, jcfg))
    a = te.encode(encodec_from_jax_params(got, tcfg, "cpu"), tcfg, torch.from_numpy(x))
    b = jax.jit(lambda p, v: je.encode(p, jcfg, v))(params, jnp.asarray(x))
    np.testing.assert_array_equal(a[0][0].numpy(), np.asarray(b[0][0]))
    del sd[next(k for k in sd if k.startswith("decoder.model.0.conv.conv.weight"))]
    with pytest.raises(KeyError, match="decoder.model.0"):
        convert_encodec_state_dict(sd, tcfg)


@pytest.mark.parametrize("shape,lengths,stride", [
    ((2, 2), (100, 100, 100, 37), 90),
    ((1,), (64,), 60),
    ((3, 1), (50, 50, 30), 40)])
def test_linear_overlap_add_matches_jax(shape, lengths, stride):
    rng = np.random.default_rng(len(lengths))
    frames = [rng.normal(size=(*shape, n)).astype(np.float32) for n in lengths]
    want = np.asarray(j_ola([jnp.asarray(f) for f in frames], stride))
    got = t_ola([torch.from_numpy(f) for f in frames], stride)
    assert got.shape == want.shape == (*shape, stride * (len(lengths) - 1) + lengths[-1])
    assert _rel(got, want) <= 1e-6


def test_factory_configs_match_jax():
    for jfn, tfn in ((je.encodec_model_24khz_config, te.encodec_model_24khz_config),
                     (je.encodec_model_48khz_config, te.encodec_model_48khz_config)):
        j, t = jfn(), tfn()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.frame_rate, t.segment_length, t.segment_stride) == \
            (j.frame_rate, j.segment_length, j.segment_stride)
        assert dataclasses.asdict(te.encodec_lm_config(t)) == \
            dataclasses.asdict(je.encodec_lm_config(j))
        for bw in t.target_bandwidths:
            a, b = te.set_target_bandwidth(t, bw), je.set_target_bandwidth(j, bw)
            assert te._effective_n_q(a, None) == je._effective_n_q(b, None)
        with pytest.raises(ValueError):
            te.set_target_bandwidth(t, 7.5)
    c24, c48 = te.encodec_model_24khz_config(), te.encodec_model_48khz_config()
    assert (c24.vq.n_q, c24.vq.bins, c24.frame_rate, c24.seanet.causal) == (32, 1024, 75, True)
    assert (c48.vq.n_q, c48.channels, c48.seanet.norm, c48.segment_stride) == \
        (16, 2, "time_group_norm", 47520)


def test_encoder_front_gate_refuses_both_encodec_encoders():
    """The front kernel serves small-320's geometry only: the causal 24 kHz
    and the GroupNorm 48 kHz encoders run every layer plainly, as in JAX."""
    for cfg in (te.encodec_model_24khz_config(), te.encodec_model_48khz_config()):
        params = encodec_from_jax_params(init_encodec(cfg, seed=0), cfg, device="cpu")
        assert "front" not in params["encoder"][0]
        assert params["quantizer"]["pack"].shape == (cfg.vq.n_q, 2, 1024, 128)


def test_near_tie_rows_on_the_encodec_codebook_tell_dropped_tails_apart():
    """The rows ``chip_smoke.py`` [9 resolution] puts on the 24 kHz model's
    layer-0 codebook (C = 1024, D = 128, N = 14 400, seed 0): the plain
    search gets every one right, and distances whose x or codebook lost its
    TF32 tail (computed in float64 from the rounded operands) get some wrong,
    so the check on the card can tell the kernel's three products from a
    product that drops one."""
    from wavtokenizer_tpu_torch.ops.kernels import _tf32_round, vq_nearest_reference
    from wavtokenizer_tpu_torch.utils.golden import near_tie_rows, nearest_two

    cfg = te.encodec_model_24khz_config()
    embed = torch.from_numpy(init_encodec(cfg, seed=0)["quantizer"]["embed"][0])
    rows = near_tie_rows(embed, 14400)
    near, d2 = nearest_two(rows, embed)
    truth = near[:, 0]
    assert float(((d2[:, 1] - d2[:, 0]) / d2[:, 0]).min()) > 1e-5

    def wrong(x, e):
        x, e = x.double(), e.double()
        d = (x * x).sum(1, keepdim=True) - 2 * x @ e.t() + (e * e).sum(1)
        return int((d.argmin(1) != truth).sum())

    counts = {"x tail dropped": wrong(_tf32_round(rows), embed),
              "codebook tail dropped": wrong(rows, _tf32_round(embed)),
              "both": wrong(_tf32_round(rows), _tf32_round(embed))}
    print(f"near-tie rows on EnCodec's layer-0 codebook, of 14400: {counts}")
    assert int((vq_nearest_reference(rows, embed).long() != truth).sum()) == 0
    assert all(v > 0 for v in counts.values())
