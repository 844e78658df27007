"""The port's metrics CLI (``tools/metrics_infer.py --device cpu``) against
the JAX package's ``metrics_infer.py`` on two WAV pairs (24 kHz references,
one 16 kHz prediction), without and with the CREPE and UTMOS checkpoints.

The numpy metrics are held to rel 1e-6 (the same arithmetic).  UTMOS, the
CREPE pitch RMSE and voiced F1, computed through nets in each package's own
fp32, to rel 1e-4; the CREPE periodicity RMSE, an RMSE of differences of
saliences that agree within 2e-5 (``tests/test_torch_crepe_utmos.py``), to
2e-5 absolute.
"""

import json

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import metrics_infer as jcli
from wavtokenizer_tpu_torch.metrics.crepe import init_crepe_state_dict
from wavtokenizer_tpu_torch.metrics.utmos import UTMOSConfig, init_utmos_state_dict
from wavtokenizer_tpu_torch.tools import metrics_infer as tcli

NETS = ("utmos", "periodicity_rmse", "pitch_rmse_cents", "voiced_f1")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test run's parallel workers share the cores,
    and PyTorch's default pool (a thread per core) in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    for sub in ("gt", "pred"):
        (d / sub).mkdir()
    for i, (n, pred_sr) in enumerate(((7200, 24000), (6000, 16000))):
        t = np.arange(n) / 24000
        y = 0.4 * np.sin(2 * np.pi * (180 + 40 * i) * t) * np.clip(np.sin(2 * np.pi * 3 * t),
                                                                   0.05, None)
        y = y + 0.01 * rng.normal(size=n)
        deg = y + 0.03 * rng.normal(size=n)
        if pred_sr != 24000:
            deg = np.interp(np.arange(n * pred_sr // 24000) * 24000 / pred_sr, np.arange(n), deg)
        wavfile.write(d / "gt" / f"c{i}.wav", 24000, (y * 32767).astype(np.int16))
        wavfile.write(d / "pred" / f"c{i}.wav", pred_sr, (deg * 32767).astype(np.int16))
    return d


def _close(got, want, rel: float, atol: float = 0.0) -> bool:
    if want is None or got is None:
        return got is want
    if np.isnan(want):
        return bool(np.isnan(got))
    return abs(got - want) <= max(rel * max(abs(want), 1e-12), atol)


@pytest.mark.parametrize("nets", [False, True])
def test_metrics_cli_matches_jax(dirs, tmp_path, monkeypatch, nets):
    monkeypatch.delenv("WT_CREPE_CKPT", raising=False)
    monkeypatch.delenv("WT_UTMOS_CKPT", raising=False)
    if nets:
        crepe, utmos = tmp_path / "crepe.pth", tmp_path / "utmos.ckpt"
        torch.save({k: torch.from_numpy(v) for k, v in init_crepe_state_dict(1).items()}, crepe)
        sd = init_utmos_state_dict(2, UTMOSConfig(num_layers=1))
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, utmos)
        monkeypatch.setenv("WT_CREPE_CKPT", str(crepe))
        monkeypatch.setenv("WT_UTMOS_CKPT", str(utmos))
    args = ["--gt-dir", str(dirs / "gt"), "--pred-dir", str(dirs / "pred")]
    assert tcli.main(args + ["--out", str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    assert jcli.main(args + ["--out", str(tmp_path / "jax.json")]) == 0
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert set(got) == set(want) and set(got["summary"]) == set(want["summary"])
    assert got["summary"]["num_files"] == want["summary"]["num_files"] == 2
    for g, w in zip(got["files"] + [got["summary"]], want["files"] + [want["summary"]]):
        assert set(g) == set(w)
        for k in w:
            if k in ("file", "num_files"):
                assert g[k] == w[k]
            else:
                tol = ((0.0, 2e-5) if k == "periodicity_rmse" else (1e-4, 0.0)) if nets \
                    and k in NETS else (1e-6, 0.0)
                assert _close(g[k], w[k], *tol), (k, g[k], w[k])
    assert (got["summary"]["utmos"] is None) == (not nets)
