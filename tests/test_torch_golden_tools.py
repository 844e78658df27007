"""The port's golden-token API and its two JAX-free tools against the JAX
package on the CPU: ``utils/golden.py`` (``compute_codes``,
``write_golden``, ``check_codes``) with ``tools/make_golden_tokens.py`` on
narrow specs, and ``tools/shape_trace.py`` against
``tools_tpu/shape_trace.py`` text for text.
"""

import os
import sys

import numpy as np
import pytest
import torch

import wavtokenizer_tpu as J
from wavtokenizer_tpu.api.config import spec_from_config as j_spec_from_config
from wavtokenizer_tpu.utils.golden import compute_codes as j_compute_codes
import wavtokenizer_tpu_torch as T
from wavtokenizer_tpu_torch.api.config import spec_from_config
from wavtokenizer_tpu_torch.tools import make_golden_tokens, shape_trace as st
from wavtokenizer_tpu_torch.utils import golden

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools_tpu"))
from shape_trace import shape_trace as j_shape_trace  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test run's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(m):
    """tests/test_profiling_tools.py's TINY, in package ``m``."""
    return m.WavTokenizerSpec(
        seanet=m.SEANetConfig(dimension=16, n_filters=2, ratios=(8, 5, 4, 2)),
        vq=m.VQConfig(dimension=16, bins=32),
        backbone=m.VocosBackboneConfig(input_channels=16, dim=32, intermediate_dim=64,
                                       num_layers=2, adanorm_num_embeddings=4),
        head=m.ISTFTHeadConfig(dim=32, n_fft=1280, hop_length=320))


def _narrow(m, sample_rate=24000):
    """A narrow codec (hop 32, 64 codes of 32) for the golden clip."""
    return m.WavTokenizerSpec(
        seanet=m.SEANetConfig(n_filters=4, dimension=32, ratios=(4, 2, 2, 2)),
        vq=m.VQConfig(dimension=32, bins=64),
        backbone=m.VocosBackboneConfig(input_channels=32, dim=32, intermediate_dim=64,
                                       num_layers=1, groupnorm_groups=8),
        head=m.ISTFTHeadConfig(dim=32, n_fft=128, hop_length=32), sample_rate=sample_rate)


def test_write_golden_refuses_the_committed_file():
    path = golden.golden_path()
    with open(path, "rb") as f:
        before = f.read()
    relative = os.path.relpath(path)
    for p in (path, relative):
        with pytest.raises(ValueError, match="committed golden file"):
            golden.write_golden(p, device="cpu")
        with pytest.raises(ValueError, match="committed golden file"):
            make_golden_tokens.main(["--out", p, "--device", "cpu"])
    with open(path, "rb") as f:
        assert f.read() == before


def test_golden_api_on_narrow_specs_matches_jax(monkeypatch, tmp_path):
    """make_golden_tokens writes every config's codes; they equal JAX's
    compute_codes on the same spec; check_codes passes on them, raises on a
    copy with one id changed (and returns 1 when allowed 1), on a shape
    change, and on a label the file lacks."""
    specs = {"narrow": _narrow(T), "narrow16k": _narrow(T, 16000)}
    monkeypatch.setattr(golden, "golden_specs", lambda: specs)
    out = str(tmp_path / "codes.npz")
    assert make_golden_tokens.main(["--out", out, "--device", "cpu"]) == 0
    written = golden.load_golden(out)
    assert set(written) == set(specs)
    for label, jspec in (("narrow", _narrow(J)), ("narrow16k", _narrow(J, 16000))):
        codes = written[label]
        assert codes.dtype == np.int32
        assert codes.shape == (1, golden.GOLDEN_BATCH,
                               int(specs[label].sample_rate * golden.GOLDEN_SECONDS) // 32)
        np.testing.assert_array_equal(codes, j_compute_codes(jspec))
        print(f"{label}: {len(np.unique(codes))} distinct codes")
    assert golden.check_codes("narrow", out, device="cpu") == 0

    bins = specs["narrow"].vq.bins
    tampered = dict(written)
    tampered["narrow"] = written["narrow"].copy()
    tampered["narrow"][0, 3, 5] = (tampered["narrow"][0, 3, 5] + 1) % bins
    tampered["narrow16k"] = written["narrow16k"][:, :, :-1]
    bad = str(tmp_path / "tampered.npz")
    np.savez(bad, **tampered)
    with pytest.raises(RuntimeError, match="1 differing ids"):
        golden.check_codes("narrow", bad, device="cpu")
    assert golden.check_codes("narrow", bad, max_flips=1, device="cpu") == 1
    with pytest.raises(RuntimeError, match="shape"):
        golden.check_codes("narrow16k", bad, max_flips=10 ** 6, device="cpu")
    with pytest.raises(KeyError):
        golden.check_codes("small320", bad, device="cpu")


@pytest.mark.parametrize("name,batch,seconds", [("tiny", 2, 1.0), ("small320", 1, 3.0)])
def test_shape_trace_text_equals_jax(name, batch, seconds):
    spec, jspec = ((_tiny(T), _tiny(J)) if name == "tiny"
                   else (T.WavTokenizerSpec(), J.WavTokenizerSpec()))
    text = st.shape_trace(spec, batch, seconds)
    assert text == j_shape_trace(jspec, batch, seconds)
    assert "(batch=%d, clip=%ss" % (batch, seconds) in text


def test_shape_trace_cli_with_a_config(tmp_path, capsys):
    config = os.path.join(REPO, "configs", "wavtokenizer_small_600_24k_4096.yaml")
    out = str(tmp_path / "trace.txt")
    assert st.main(["--config", config, "--batch", "2", "--seconds", "1.5", "-o", out]) == 0
    assert capsys.readouterr().out.strip() == f"wrote {out}"
    with open(out) as f:
        text = f.read()
    assert text == j_shape_trace(j_spec_from_config(config), 2, 1.5)
    assert spec_from_config(config).hop_length == 600 and "hop=600" in text
