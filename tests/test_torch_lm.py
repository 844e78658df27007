"""The port's streaming token LM, arithmetic coder, LM compression and the
``tools/compress.py`` CLI on the CPU, against the JAX package.

``lm_forward`` runs several streamed calls with carried state, past the
point where the ``past_context`` ring has aged out the pre-history token,
and is held to JAX's probabilities within 1e-5 absolute (fp32, other
summation orders).  The coder is the same integer arithmetic, so it must
give the JAX coder's bytes for the same CDFs.  The LM-coded stream is
lossless on the device it was made on; only the fixed-rate ``--no-lm``
container is promised to be the same bytes as the JAX tool's.
"""

import importlib.util
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from wavtokenizer_tpu.api.config import spec_from_config as j_spec_from_config
from wavtokenizer_tpu.checkpoint.export import wavtokenizer_state_dict
from wavtokenizer_tpu.models import lm as jlm
from wavtokenizer_tpu.models.init import init_wavtokenizer as j_init
from wavtokenizer_tpu.ops import entropy as jent
from wavtokenizer_tpu_torch import WavTokenizer
from wavtokenizer_tpu_torch.api.config import spec_from_config
from wavtokenizer_tpu_torch.models.seanet import seanet_encode
from wavtokenizer_tpu_torch.models import lm as tlm
from wavtokenizer_tpu_torch.ops import entropy as tent
from wavtokenizer_tpu_torch.tools import compress

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Hop 32 and a narrow backbone over the YAML schema's fixed encoder widths.
NARROW_YAML = """\
feature_extractor:
  class_path: decoder.feature_extractors.EncodecFeatures
  init_args: {bandwidths: [6.6], dowmsamples: [4, 2, 2, 2], vq_bins: 64, num_quantizers: 1}
backbone:
  class_path: decoder.models.VocosBackbone
  init_args: {input_channels: 512, dim: 64, intermediate_dim: 192, num_layers: 2,
              adanorm_num_embeddings: 4}
head:
  class_path: decoder.heads.ISTFTHead
  init_args: {dim: 64, n_fft: 128, hop_length: 32, padding: same}
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file: the LM runs one tiny step per
    frame, and beside other test workers torch's threads only contend (the
    CLI round trip took 325 s under six pytest-xdist workers, 3.5 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(past_context=4):
    kw = dict(dim=32, num_heads=4, num_layers=2, past_context=past_context)
    return (jlm.LMConfig(n_q=2, card=32, transformer=jlm.StreamingTransformerConfig(**kw)),
            tlm.LMConfig(n_q=2, card=32, transformer=tlm.StreamingTransformerConfig(**kw)))


def test_init_lm_draws_like_jax():
    jcfg, tcfg = _cfgs()
    a, b = tlm.init_lm(tcfg, seed=3), jlm.init_lm(jcfg, seed=3)
    flat = lambda t: ([t] if isinstance(t, np.ndarray) else [x for v in (
        t.values() if isinstance(t, dict) else t) for x in flat(v)])
    for x, y in zip(flat(a), flat(b), strict=True):
        np.testing.assert_array_equal(x, y)


def test_lm_forward_streams_like_jax():
    """Calls of 3, 1, 1, 1, 1, 2 frames with carried state: the 4-slot ring
    drops the pre-history zero step at frame 4 and real frames after it."""
    jcfg, tcfg = _cfgs()
    params = jlm.init_lm(jcfg, seed=0)
    tparams = tlm.lm_params_to(params, "cpu")
    ids = np.random.default_rng(0).integers(0, 33, size=(2, 2, 9)).astype(np.int32)
    step = jax.jit(lambda p, i, st, off: jlm.lm_forward(p, jcfg, i, st, off))
    jst = tst = None
    joff = toff = 0
    start = 0
    for n in (3, 1, 1, 1, 1, 2):
        chunk = ids[:, :, start:start + n]
        start += n
        pj, jst, joff = step(params, jnp.asarray(chunk), jst, joff)
        pt, tst, toff = tlm.lm_forward(tparams, tcfg, torch.from_numpy(chunk), tst, toff)
        assert pt.shape == pj.shape == (2, 32, 2, n) and toff == int(joff) == start
        assert float(np.abs(pt.numpy() - np.asarray(pj)).max()) <= 1e-5
        np.testing.assert_allclose(pt.sum(1).numpy(), 1.0, atol=1e-5)
        for a, b in zip(tst, jst):
            assert a.shape == b.shape == (2, 4, 32)
            assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-5


def test_fresh_stream_at_an_offset_is_refused():
    jcfg, tcfg = _cfgs()
    x = np.zeros((1, 3, 32), np.float32)
    params = jlm.init_lm(jcfg, seed=0)
    with pytest.raises(ValueError, match="offset must be 0"):
        jlm.streaming_transformer(params["transformer"], jcfg.transformer, jnp.asarray(x),
                                  None, 5)
    with pytest.raises(ValueError, match="offset must be 0"):
        tlm.streaming_transformer(tlm.lm_params_to(params, "cpu")["transformer"],
                                  tcfg.transformer, torch.from_numpy(x), None, 5)


def _round_trip(cums, symbols):
    enc = tent.ArithmeticEncoder()
    for cum, s in zip(cums, symbols):
        enc.encode(cum, int(s))
    data = enc.finish()
    dec = tent.ArithmeticDecoder(data)
    assert [dec.decode(c) for c in cums] == [int(s) for s in symbols]
    # The same integer arithmetic as the JAX package's coder: the same bytes.
    jenc = jent.ArithmeticEncoder()
    for cum, s in zip(cums, symbols):
        jenc.encode(cum, int(s))
    assert jenc.finish() == data
    return data


def test_static_pdf_round_trip():
    rng = np.random.default_rng(0)
    pdf = np.array([0.7, 0.1, 0.1, 0.05, 0.05])
    cum = tent.quantize_pdf(pdf)
    np.testing.assert_array_equal(cum, jent.quantize_pdf(pdf))
    symbols = rng.choice(5, size=500, p=pdf)
    data = _round_trip([cum] * 500, symbols)
    assert len(data) * 8 / len(symbols) < 1.6      # entropy ~1.46 bits


def test_uniform_pdf_near_log2():
    symbols = np.random.default_rng(1).integers(0, 64, size=400)
    data = _round_trip([tent.quantize_pdf(np.full(64, 1 / 64))] * 400, symbols)
    assert len(data) * 8 / len(symbols) < np.log2(64) + 0.2


def test_varying_cdfs_round_trip():
    rng = np.random.default_rng(2)
    cums, symbols = [], []
    for _ in range(300):
        pdf = rng.dirichlet(np.ones(17))
        cums.append(tent.quantize_pdf(pdf))
        symbols.append(int(rng.choice(17, p=pdf)))
    _round_trip(cums, symbols)


def test_lm_compression_lossless():
    _, tcfg = _cfgs(past_context=16)
    params = tlm.lm_params_to(tlm.init_lm(tcfg, seed=0), "cpu")
    codes = np.random.default_rng(0).integers(0, 32, size=(2, 24)).astype(np.int32)
    blob = tent.compress_codes(params, tcfg, codes)
    assert len(blob) > 0
    np.testing.assert_array_equal(tent.decompress_codes(params, tcfg, blob, K=2, T=24), codes)


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """A narrow YAML, a Lightning .ckpt of seeded params, and a 0.2 s WAV."""
    d = tmp_path_factory.mktemp("compress")
    cfg = d / "narrow.yaml"
    cfg.write_text(NARROW_YAML)
    jspec = j_spec_from_config(str(cfg))
    params = j_init(jspec, seed=0, random_codebook=True)
    # The random encoder's output is a large constant offset plus small
    # variation, so |x|^2 >> |x - e|^2 and the fp32 distance formula
    # -(|x|^2 - 2 x.e + |e|^2), the reference's in both packages, cannot tell
    # codes apart: a first draft of this fixture gave JAX and the port
    # different ids, at gaps within that formula's fp32 error.  Trained
    # encoders have no such
    # offset; the last conv's bias takes it out here, and the codebook is
    # drawn around the centred embeddings of noise, so the codes vary.
    tspec = spec_from_config(str(cfg))
    wt = WavTokenizer.from_jax_params(params, tspec, device="cpu")
    noise = (np.random.default_rng(0).normal(size=(2, 4096, 1)) * 0.2).astype(np.float32)
    with torch.inference_mode():
        emb = seanet_encode(wt.params["encoder"], tspec.seanet,
                            torch.from_numpy(noise)).reshape(-1, 512).numpy()
    params["encoder"][-1]["bias"] = params["encoder"][-1]["bias"] - emb.mean(0)
    rng = np.random.default_rng(1)
    params["quantizer"]["embed"] = (rng.normal(size=(1, 64, 512)) * emb.std(0)).astype(np.float32)
    sd = wavtokenizer_state_dict(params, jspec.seanet, jspec.backbone,
                                 head_n_fft=jspec.head.n_fft)
    ckpt = d / "model.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()}}, ckpt)
    wav = d / "in.wav"
    y = (np.random.default_rng(2).normal(size=4800) * 0.2).clip(-1, 1)
    wavfile.write(wav, 24000, (y * 32767).astype(np.int16))
    return d, cfg, ckpt, wav


def _header(path):
    data = open(path, "rb").read()
    assert data[:4] == b"WTC1"
    return struct.unpack("<BHII", data[4:15]), data


def test_compress_cli_lm_round_trip_is_lossless(release):
    d, cfg, ckpt, wav = release
    model = ["--config", str(cfg), "--checkpoint", str(ckpt), "--device", "cpu"]
    assert compress.main(["encode", str(wav), str(d / "lm.wtc")] + model) == 0
    assert compress.main(["decode", str(d / "lm.wtc"), str(d / "lm.wav")] + model) == 0
    (mode, K, T, n), _ = _header(d / "lm.wtc")
    assert (mode, K, T, n) == (1, 1, 150, 4800)
    wt = WavTokenizer.from_pretrained0802(str(cfg), str(ckpt), device="cpu")
    y = wavfile.read(wav)[1].astype(np.float32) / 32768.0
    codes = wt.encode_infer(y[None])[1]
    assert len(np.unique(codes.numpy())) > 5
    want = wt.decode(wt.codes_to_features(codes), 0)[0].numpy()[:n]
    want = (np.clip(want, -1, 1) * 32767).astype(np.int16)
    np.testing.assert_array_equal(wavfile.read(d / "lm.wav")[1], want)


def test_compress_cli_fixed_rate_container_is_the_jax_tools(release, monkeypatch):
    d, cfg, ckpt, wav = release
    model = ["--config", str(cfg), "--checkpoint", str(ckpt)]
    assert compress.main(["encode", str(wav), str(d / "port.wtc"), "--no-lm",
                          "--device", "cpu"] + model) == 0
    spec = importlib.util.spec_from_file_location(
        "_jax_compress_tool", os.path.join(REPO, "tools_tpu", "compress.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    # The JAX tool turns on its compile cache: keep it read-only in this process.
    monkeypatch.setenv("WT_JAX_CACHE_READONLY", "1")
    jtool.main(["encode", str(wav), str(d / "jax.wtc"), "--no-lm"] + model)
    (mode, K, T, n), port = _header(d / "port.wtc")
    assert (mode, K, T, n) == (0, 1, 150, 4800) and len(port) == 15 + (150 * 6 + 7) // 8
    assert port == open(d / "jax.wtc", "rb").read()
    # Both tools read each other's fixed-rate ids back.
    np.testing.assert_array_equal(compress._unpack_fixed(port[15:], 64, 150),
                                  jtool._unpack_fixed(port[15:], 64, 150))
    assert compress.main(["decode", str(d / "jax.wtc"), str(d / "port.wav"),
                          "--device", "cpu"] + model) == 0
    assert wavfile.read(d / "port.wav")[1].shape == (4800,)
