"""The port's profiling layer and tools on the CPU: ``utils/profiling.py``
(FLOP counts held to a count by hand from the spec, the same whether the
kernels or their plain versions run; stage timings; the stage map, as
``tests/test_profiling_tools.py`` holds JAX's) and the four CLIs
(``tools/{perf_profile,mem_probe,train_profile,check_env}.py``) in-process
with ``--device cpu`` at a tiny size.  What needs a card is in
``tests/test_torch_cuda.py``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from wavtokenizer_tpu_torch import (ISTFTHeadConfig, SEANetConfig, VQConfig,
                                    VocosBackboneConfig, WavTokenizer, WavTokenizerSpec,
                                    init_wavtokenizer)
from wavtokenizer_tpu_torch.models import vocos as vocos_mod
from wavtokenizer_tpu_torch.models import wavtokenizer as wt_mod
from wavtokenizer_tpu_torch.ops import kernels as K
from wavtokenizer_tpu_torch.ops import vq as vq_mod
from wavtokenizer_tpu_torch.tools import check_env, mem_probe, perf_profile, train_profile
from wavtokenizer_tpu_torch.train.step import TrainConfig
from wavtokenizer_tpu_torch.utils import profiling as P

TINY = WavTokenizerSpec(
    seanet=SEANetConfig(dimension=16, n_filters=2, ratios=(8, 5, 4, 2)),
    vq=VQConfig(dimension=16, bins=32, kmeans_iters=2),
    backbone=VocosBackboneConfig(input_channels=16, dim=32, intermediate_dim=64, num_layers=2,
                                 adanorm_num_embeddings=4),
    head=ISTFTHeadConfig(dim=32, n_fft=1280, hop_length=320))
B, T = 2, 24000


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    model = WavTokenizer.from_jax_params(init_wavtokenizer(TINY, seed=0, random_codebook=True),
                                         TINY, device="cpu")
    audio = torch.as_tensor((np.random.default_rng(0).normal(size=(B, T)) * 0.1)
                            .astype(np.float32))
    return model, audio


def _hand_counted_flops(spec: WavTokenizerSpec, batch: int, samples: int) -> dict:
    """2 x the multiply-adds of every conv and matmul of each stage, from the
    spec: SEANet's convs (stride-r downsampling convs of kernel 2r keep
    L / r frames), its LSTM, the VQ's x.E^T, the backbone (embed conv, the
    pos-net's k3 convs, attention's four projections and its two (T, T)
    products, each ConvNeXt block's dw conv k7 and two GEMMs) and the head's
    linear layer."""
    s, bb = spec.seanet, spec.backbone
    L, c, macs = samples, s.n_filters, s.kernel_size * s.channels * s.n_filters * samples
    for r in reversed(s.ratios):
        h = c // s.compress
        macs += L * (c * h * s.residual_kernel_size + h * c + c * c)   # block + shortcut
        macs += (L // r) * c * 2 * c * 2 * r                            # down conv
        L, c = L // r, 2 * c
    macs += L * 4 * c * (c + c) * s.lstm                                 # the LSTM layers
    macs += L * c * s.dimension * s.last_kernel_size
    enc = 2 * batch * macs
    F, C = L, bb.dim
    vq = 2 * batch * F * spec.vq.bins * spec.vq.dimension
    macs = F * C * bb.input_channels * 7 + 4 * 2 * F * C * C * 3
    macs += 4 * F * C * C + 2 * F * F * C
    macs += bb.num_layers * (F * C * 7 + 2 * F * C * bb.intermediate_dim)
    backbone = 2 * batch * macs
    head = 2 * batch * F * C * (spec.head.n_fft + 2)
    return {"encoder": enc, "vq": vq, "backbone": backbone, "head": head,
            "encode_total": enc + vq, "decode_total": backbone + head,
            "roundtrip": enc + vq + backbone + head}


def test_stage_flops_equal_the_hand_count(tiny):
    model, audio = tiny
    got = P.stage_flops(P.pipeline_stages(model.params, TINY, audio))
    assert got == _hand_counted_flops(TINY, B, T)


def _launch(wrapper, plain, work):
    """A wrapper as the card runs it: each call adds its kernel's work to
    the wrapper's count and computes the plain version out of the FLOP
    counter's sight, as a ctypes launch is."""
    def run(*args, **kw):
        wrapper.flops += work(*args)
        with _disable_current_modes():
            return plain(*args, **kw)
    return run


@pytest.fixture
def kernel_route(monkeypatch):
    monkeypatch.setattr(vq_mod, "vq_nearest", _launch(
        K.vq_nearest, K.vq_nearest, lambda x, e, *a: P.vq_flops(x.shape[0], *e.shape)))
    monkeypatch.setattr(vocos_mod, "convnext_block_kernel", _launch(
        K.convnext_block, K.convnext_block,
        lambda x, dw, dwb, sc, sh, w1, *a: P.convnext_flops(x.shape[0] * x.shape[1], *w1.shape)))
    monkeypatch.setattr(K, "encoder_front", _launch(
        K.encoder_front, K.encoder_front_reference, lambda a, *r: P.front_flops(a.numel())))


def test_stage_flops_count_the_kernels_work_as_their_plain_versions(tiny, kernel_route):
    model, audio = tiny
    assert P.stage_flops(P.pipeline_stages(model.params, TINY, audio)) == \
        _hand_counted_flops(TINY, B, T)


def test_front_formula_is_the_plain_front(monkeypatch):
    """Small-320's encoder, whose layers 0-6 the front kernel runs: its stage
    counts the same through the kernel route as through the plain one."""
    spec = WavTokenizerSpec()
    model = WavTokenizer.from_jax_params(init_wavtokenizer(spec, seed=0, random_codebook=True),
                                         spec, device="cpu")
    audio = torch.as_tensor((np.random.default_rng(1).normal(size=(1, 8000)) * 0.1)
                            .astype(np.float32))
    stage = {"encoder": P.pipeline_stages(model.params, spec, audio)["encoder"]}
    plain = P.stage_flops(stage)
    monkeypatch.setattr(K, "encoder_front", _launch(
        K.encoder_front, K.encoder_front_reference, lambda a, *r: P.front_flops(a.numel())))
    assert P.stage_flops(stage) == plain
    assert plain["encoder"] > P.front_flops(8000)


def test_stage_timings_runs():
    x = torch.ones(4, 64)
    times = P.stage_timings({"double": (lambda a: a * 2, (x,)),
                             "tree": (lambda a: {"y": a + 1, "z": a - 1}, (x,))},
                            iters=2, repeats=1)
    assert set(times) == {"double", "tree"} and all(v >= 0 for v in times.values())


def test_pipeline_stages_cover_roundtrip(tiny):
    model, audio = tiny
    stages = P.pipeline_stages(model.params, TINY, audio)
    assert {"encoder", "vq", "backbone", "head", "roundtrip"} <= set(stages)
    fn, args = stages["roundtrip"]
    with torch.inference_mode():
        assert fn(*args).shape == (B, T)
    assert P.stage_timings({"roundtrip": stages["roundtrip"]}, iters=1, repeats=1)["roundtrip"] > 0


def test_peaks_and_bounds():
    assert P.device_peak_flops("bf16", "NVIDIA H100 80GB HBM3") == 989e12
    assert P.device_peak_flops("3xtf32", "NVIDIA H100 80GB HBM3") == 495e12 / 3
    assert P.PEAKS["NVIDIA H100 80GB HBM3"]["bytes"] == 3.35e12
    assert P.device_peak_flops("fp32", "a card the table lacks") is None
    # The bounds chip_smoke.py printed before they moved here (PERF.md §6).
    assert P.vq_bound_of(28800, 4096, 512)[0] == pytest.approx(0.7320, abs=1e-4)
    assert P.vq_bound_of(9000, 4096, 512) == (pytest.approx(0.2288, abs=1e-4), "operations")
    assert P.convnext_bound(28800, 768, 2304)[0] == pytest.approx(0.211, abs=1e-3)
    assert P.convnext_bound(36096, 512, 1536)[0] == pytest.approx(0.1187, abs=1e-4)


def _tiny_train(monkeypatch):
    narrow = TrainConfig(disc_channels_scale=0.0625)
    monkeypatch.setattr(train_profile, "spec_and_config", lambda path: (TINY, narrow))
    real = mem_probe.train_config
    monkeypatch.setattr(mem_probe, "train_config", lambda args: (
        TINY, dataclasses.replace(real(args)[1], disc_channels_scale=0.0625)))


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_perf_profile_cli(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(wt_mod, "WavTokenizerSpec", lambda: TINY)
    tf32 = torch.backends.cudnn.allow_tf32
    assert perf_profile.main(["--device", "cpu", "--batch", "1", "--seconds", "0.4",
                              "--iters", "1", "--trace-dir", str(tmp_path)]) == 0
    out = _last_json(capsys)
    assert out["device"] == "cpu" and out["batch"] == 1
    assert set(out["stages"]) == set(_hand_counted_flops(TINY, 1, 9600))
    assert all(r["mfu"] is None for r in out["stages"].values())     # no device peak
    assert out["stages"]["vq"]["flops"] == _hand_counted_flops(TINY, 1, 9600)["vq"]
    assert (tmp_path / "trace.json").exists()
    assert torch.backends.cudnn.allow_tf32 == tf32                   # restored
    assert perf_profile.main(["--batch", "1"]) == 1                   # no card


def test_mem_probe_cli(monkeypatch, capsys):
    _tiny_train(monkeypatch)
    for argv in (["--no-remat"], ["--remat-disc", "store_dac", "--disc-dtype", "bfloat16"]):
        assert mem_probe.main(["--device", "cpu", "--batch", "1", "--seconds", "0.2",
                               *argv]) == 0
        text = capsys.readouterr().out
        out = json.loads(text.strip().splitlines()[-1])
        assert "not measured" in text
        assert out["fits"] and out["peak_bytes"] == 0 and out["device"] == "cpu"
    assert out["remat"] and out["remat_disc"] == "store_dac" and out["disc_dtype"] == "bfloat16"
    assert mem_probe.main(["--batch", "1"]) == 1                      # no card


def test_train_profile_cli(monkeypatch, capsys):
    _tiny_train(monkeypatch)
    assert train_profile.main(["--device", "cpu", "--batch", "1", "--seconds", "0.2",
                               "--iters", "1", "--passes", "1"]) == 0
    out = _last_json(capsys)
    assert [r["stage"] for r in out["table"]] == [
        "full_train_step", "disc_phase", "gen_phase", "gen_fwd", "disc_fwd_all", "mpd_step",
        "mrd_step", "dac_step", "melcommit_step"]
    split = out["first_step"]
    assert split["kmeans_iters"] == 2 and split["first_ms"] > split["kmeans_ms"] > 0
    assert train_profile.main(["--device", "cpu", "--remat-ab", "1", "--seconds", "0.2",
                               "--iters", "1", "--passes", "1"]) == 0
    out = _last_json(capsys)
    assert [r["stage"] for r in out["table"]] == ["full_b1_remat_true", "full_b1_remat_false"]


def test_check_env_cli(capsys):
    assert check_env.main([]) == 1                                    # no card
    assert "no CUDA device" in capsys.readouterr().out
    assert check_env.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.strip().endswith("OK") and "native data loader" in out
    # What it runs on the card, with the plain versions on both sides here.
    checks = check_env.kernel_checks(torch.device("cpu"))
    assert set(checks) == {"vq_nearest", "convnext_block", "encoder_front", "segment_sum"}
    assert all(ok for ok, _ in checks.values())
