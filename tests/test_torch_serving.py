"""The port's serving engine and HTTP daemon on the CPU, against the port's
direct entry points and the JAX package's ``encode_infer``, as
``tests/test_engine.py`` pins the JAX engine: coalescing, exact lengths,
payload checks that fail only their own request, timeouts, ``close()``, the
HTTP endpoints; and ``full_fp32`` under concurrent callers.

A narrow spec (hop 32, 0.1 s clips) keeps the file fast: the engine's
semantics do not depend on the widths.  Codes are compared exactly.
Features and waveforms served from a padded batch bucket are compared at
1e-6 / 1e-5 absolute: the CPU convolutions may block a batch of 4 other than
a batch of 1.
"""

import concurrent.futures as cf
import http.client
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import _small_params, _small_specs
from wavtokenizer_tpu.models import wavtokenizer as jw
from wavtokenizer_tpu_torch import WavTokenizer
from wavtokenizer_tpu_torch.api.engine import EngineConfig, ServingEngine
from wavtokenizer_tpu_torch.models.wavtokenizer import full_fp32
from wavtokenizer_tpu_torch.tools import serve

CLIP = 2400   # 0.1 s at 24 kHz, 75 frames of hop 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test run's parallel workers share the cores,
    and PyTorch's default pool (a thread per core) in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def narrow():
    tspec, jspec = _small_specs()
    audio = (np.random.default_rng(21).normal(size=(2, 2048)) * 0.1).astype(np.float32)
    params = _small_params(jspec, 21, audio)
    return WavTokenizer.from_jax_params(params, tspec, device="cpu"), params, jspec


def _clips(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=n) * 0.1).astype(np.float32) for n in lengths]


def test_engine_coalesces_and_matches_direct_and_jax(narrow):
    wt, params, jspec = narrow
    clips = _clips(1, [CLIP] * 4)
    cfg = EngineConfig(batch_sizes=(4,), clip_seconds=(0.1,), max_wait_ms=50.0)
    with ServingEngine(wt, cfg) as eng:
        outs = [f.result(timeout=120) for f in [eng.submit("encode", c) for c in clips]]
        feats_ref, codes_ref = wt.encode_infer(np.stack(clips))
        _, codes_j = jw.encode_infer(params, jspec, jnp.asarray(np.stack(clips)))
        assert len(np.unique(codes_ref.numpy())) > 5
        for i, (feats, codes) in enumerate(outs):
            np.testing.assert_array_equal(codes, codes_ref[0, i].numpy())
            np.testing.assert_array_equal(codes, np.asarray(codes_j)[0, i])
            np.testing.assert_allclose(feats, feats_ref[i].numpy(), rtol=0, atol=1e-6)
        wav = eng.decode(outs[0][0], timeout=120)
        wav_ref = wt.decode(feats_ref, bandwidth_id=0)[0].numpy()
        np.testing.assert_allclose(wav, wav_ref, rtol=0, atol=1e-5)
        assert eng.stats.by_op["encode"] == 4 and eng.stats.batches <= 4
        assert eng.stats.snapshot()["mean_batch_occupancy"] > 1


def test_engine_detokenize_equals_codes_to_features_then_decode(narrow):
    wt, _, _ = narrow
    codes = np.random.default_rng(2).integers(0, wt.spec.vq.bins, size=75).astype(np.int32)
    with ServingEngine(wt, EngineConfig(batch_sizes=(1,), clip_seconds=(0.1,))) as eng:
        wav = eng.detokenize(codes, timeout=120)
    want = wt.decode(wt.codes_to_features(codes[None, None]), bandwidth_id=0)[0]
    assert wav.shape == (75 * 32,)
    np.testing.assert_allclose(wav, want.numpy(), rtol=0, atol=1e-5)


def test_engine_serves_each_request_at_its_own_length(narrow):
    wt, params, jspec = narrow
    clips = _clips(3, [CLIP, 1583, 1022, CLIP - 1])
    cfg = EngineConfig(batch_sizes=(4,), clip_seconds=(0.1,), max_wait_ms=30.0)
    with ServingEngine(wt, cfg) as eng:
        outs = [f.result(timeout=120) for f in [eng.submit("encode", c) for c in clips]]
    for clip, (feats, codes) in zip(clips, outs):
        feats_ref, codes_ref = wt.encode_infer(clip[None])
        _, codes_j = jw.encode_infer(params, jspec, jnp.asarray(clip[None]))
        assert codes.shape == (-(-len(clip) // 32),)
        np.testing.assert_array_equal(codes, codes_ref[0, 0].numpy())
        np.testing.assert_array_equal(codes, np.asarray(codes_j)[0, 0])
        np.testing.assert_allclose(feats, feats_ref[0].numpy(), rtol=0, atol=1e-6)


def test_engine_bad_payloads_fail_only_their_own_future(narrow):
    wt, _, _ = narrow
    D = wt.spec.backbone.input_channels
    cfg = EngineConfig(batch_sizes=(2,), clip_seconds=(0.1,), max_wait_ms=50.0)
    with ServingEngine(wt, cfg) as eng:
        bad = [eng.submit("encode", np.zeros((2, CLIP), np.float32)),
               eng.submit("encode", np.zeros(CLIP, np.int32)),
               eng.submit("encode", np.zeros(CLIP + 1, np.float32)),   # oversized
               eng.submit("decode", np.zeros((D + 1, 10), np.float32)),
               eng.submit("decode", np.zeros((10,), np.float32)),
               eng.submit("detokenize", np.zeros(10, np.float32)),
               eng.submit("detokenize", np.zeros(76, np.int32))]       # oversized
        good = eng.submit("encode", _clips(4, [CLIP])[0])
        for fut in bad:
            with pytest.raises(ValueError):
                fut.result(timeout=10)
        feats, codes = good.result(timeout=120)
        assert feats.shape == (D, 75) and codes.shape == (75,)
        with pytest.raises(ValueError):
            eng.submit("transcode", np.zeros(4))
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit("encode", np.zeros(10, np.float32))
    eng.close()   # a second close is a no-op


def test_engine_out_of_range_code_fails_only_its_own_request(narrow):
    """A detokenize request holding code 67 (>= the 64 bins) coalesced with a
    valid one: the bad one fails with ValueError, the valid one returns the
    audio of a direct decode.  Negative codes down to -bins wrap."""
    wt, _, _ = narrow
    bins = wt.spec.vq.bins
    rng = np.random.default_rng(6)
    codes = rng.integers(0, bins, size=75).astype(np.int32)
    bad = codes.copy()
    bad[10] = 67
    cfg = EngineConfig(batch_sizes=(4,), clip_seconds=(0.1,), max_wait_ms=50.0)
    with ServingEngine(wt, cfg) as eng:
        fut_good = eng.submit("detokenize", codes)
        fut_bad = eng.submit("detokenize", bad)
        fut_low = eng.submit("detokenize", np.full(75, -bins - 1, np.int32))
        fut_wrap = eng.submit("detokenize", codes - bins)
        for fut in (fut_bad, fut_low):
            with pytest.raises(ValueError, match="must lie in"):
                fut.result(timeout=10)
        wav = fut_good.result(timeout=120)
        wav_wrap = fut_wrap.result(timeout=120)
    want = wt.decode(wt.codes_to_features(codes[None, None]), bandwidth_id=0)[0].numpy()
    np.testing.assert_allclose(wav, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(wav_wrap, want, rtol=0, atol=1e-5)


def test_engine_blocking_helpers_honor_timeouts(narrow):
    wt, _, _ = narrow
    cfg = EngineConfig(batch_sizes=(2,), clip_seconds=(0.1,), request_timeout_s=0.05)
    with ServingEngine(wt, cfg) as eng:
        eng.submit = lambda op, payload: cf.Future()   # a wedged worker
        with pytest.raises(cf.TimeoutError):
            eng.encode(np.zeros(CLIP, np.float32))                     # config default
        with pytest.raises(cf.TimeoutError):
            eng.detokenize(np.zeros(75, np.int32), timeout=0.05)       # per call


def test_engine_warmup_runs_every_bucket(narrow):
    wt, _, _ = narrow
    cfg = EngineConfig(batch_sizes=(1, 2), clip_seconds=(0.05, 0.1))
    with ServingEngine(wt, cfg) as eng:
        eng.warmup()
        assert eng.stats.requests == 0    # warmup is not traffic


def test_serve_http_endpoints(narrow):
    wt, _, _ = narrow
    eng = ServingEngine(wt, EngineConfig(batch_sizes=(4,), clip_seconds=(0.1,)))
    httpd = serve.build_server("127.0.0.1", 0, eng, "cpu-test")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=120)
        conn.request(method, path, body, {"Content-Type": "application/json"})
        r = conn.getresponse()
        out = r.status, json.loads(r.read())
        conn.close()
        return out

    try:
        assert call("GET", "/healthz") == (200, {"ok": True, "device": "cpu-test"})
        audio = _clips(5, [CLIP])[0]
        status, out = call("POST", "/encode",
                           json.dumps({"audio": serve.encode_tensor(audio)}))
        assert status == 200
        feats_ref, codes_ref = wt.encode_infer(audio[None])
        codes = serve.decode_tensor(out["codes"])
        np.testing.assert_array_equal(codes, codes_ref[0, 0].numpy())
        np.testing.assert_allclose(serve.decode_tensor(out["features"]),
                                   feats_ref[0].numpy(), rtol=0, atol=1e-6)
        status, out = call("POST", "/detokenize",
                           json.dumps({"codes": serve.encode_tensor(codes)}))
        assert status == 200 and serve.decode_tensor(out["audio"]).shape == (CLIP,)
        status, out = call("POST", "/decode", json.dumps(
            {"features": serve.encode_tensor(feats_ref[0].numpy())}))
        assert status == 200 and serve.decode_tensor(out["audio"]).shape == (CLIP,)
        # The caller's faults: 400, and the server stays up.
        assert call("POST", "/decode", json.dumps({"wrong": 1}))[0] == 400
        assert call("POST", "/encode", "{not json")[0] == 400
        too_long = np.zeros(CLIP + 32, np.float32)
        status, out = call("POST", "/encode",
                           json.dumps({"audio": serve.encode_tensor(too_long)}))
        assert status == 400 and "largest bucket" in out["error"]
        bad_codes = codes.copy()
        bad_codes[3] = 67
        status, out = call("POST", "/detokenize",
                           json.dumps({"codes": serve.encode_tensor(bad_codes)}))
        assert status == 400 and "must lie in" in out["error"]
        assert call("POST", "/transcode", "{}")[0] == 404
        status, stats = call("GET", "/stats")
        assert status == 200 and stats["by_op"] == {"encode": 1, "detokenize": 1,
                                                    "decode": 1}
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.close()


def test_serve_answers_a_burst_of_concurrent_connections(narrow):
    """128 clients connecting at once are all answered: socketserver's
    default listen backlog of 5 reset some of them."""
    wt, _, _ = narrow
    eng = ServingEngine(wt, EngineConfig(batch_sizes=(4,), clip_seconds=(0.1,)))
    httpd = serve.build_server("127.0.0.1", 0, eng, "cpu-test")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def post(_):
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
        conn.request("POST", "/encode", "{}", {"Content-Type": "application/json"})
        status = conn.getresponse().status
        conn.close()
        return status

    try:
        with cf.ThreadPoolExecutor(64) as pool:
            assert list(pool.map(post, range(128))) == [400] * 128
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.close()


def test_full_fp32_keeps_tf32_off_until_the_last_caller_leaves():
    flags = lambda: (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    saved = flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    both_inside = threading.Barrier(2)
    first_left = threading.Event()
    seen = {}

    def first():
        with full_fp32():
            both_inside.wait(10)
            seen["first"] = flags()
        first_left.set()

    def second():
        with full_fp32():
            both_inside.wait(10)
            assert first_left.wait(10)
            seen["second, after the first left"] = flags()

    try:
        threads = [threading.Thread(target=f) for f in (first, second)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert not any(t.is_alive() for t in threads)
        assert seen == {"first": (False, False),
                        "second, after the first left": (False, False)}
        assert flags() == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_full_fp32_depth_count_under_many_threads():
    """Many threads entering and leaving at once: inside, TF32 is always
    off; once all have left, the callers' settings are back."""
    import sys
    import time
    flags = lambda: (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    saved, interval = flags(), sys.getswitchinterval()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    sys.setswitchinterval(1e-6)
    seen_on = []

    def worker():
        for _ in range(300):
            with full_fp32():
                time.sleep(0)   # let the other threads in and out meanwhile
                if flags() != (False, False):
                    seen_on.append(flags())

    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert seen_on == []
        assert flags() == (True, True)
    finally:
        sys.setswitchinterval(interval)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
