"""The trainers run every step under ``repeatable_steps`` (cuDNN's
deterministic algorithms, no autotuning), so that a step repeats run for
run on the card, as the JAX step does; and the context manager keeps the
callers' settings across nesting, threads and exceptions.

The flags are recorded where the steps run, through stand-in steps: what is
checked is the loops' wiring, not the steps (their bit-for-bit repeat on
the card is ``chip_smoke.py`` [12] (d) and [15]).  Nothing here imports
JAX.
"""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from wavtokenizer_tpu_torch import (ISTFTHeadConfig, SEANetConfig, VQConfig,
                                    VocosBackboneConfig, WavTokenizerSpec, init_wavtokenizer)
from wavtokenizer_tpu_torch.models.wavtokenizer import repeatable_steps
from wavtokenizer_tpu_torch.research import enhance
from wavtokenizer_tpu_torch.tools import byol_train, enhance_train
from wavtokenizer_tpu_torch.train import trainer as trainer_mod
from wavtokenizer_tpu_torch.train.data import DataConfig
from wavtokenizer_tpu_torch.train.helpers import TBLogger
from wavtokenizer_tpu_torch.train.step import TrainConfig

TINY = WavTokenizerSpec(
    seanet=SEANetConfig(dimension=16, n_filters=2, ratios=(8, 5, 4, 2)),
    vq=VQConfig(dimension=16, bins=32, kmeans_iters=2),
    backbone=VocosBackboneConfig(input_channels=16, dim=32, intermediate_dim=64, num_layers=1,
                                 adanorm_num_embeddings=4),
    head=ISTFTHeadConfig(dim=32, n_fft=1280, hop_length=320))

REPEATABLE = (True, False)     # (cudnn.deterministic, cudnn.benchmark) inside
CALLERS = (False, True)        # the callers' settings here, PyTorch's opposite


def flags() -> tuple:
    return torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def callers_flags():
    """The callers' settings are the opposite of ``repeatable_steps``', so
    that both setting and restoring show; PyTorch's are back afterwards."""
    saved = flags()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = CALLERS
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


@pytest.mark.parametrize("raises", [False, True])
def test_repeatable_steps_sets_and_restores_the_flags(callers_flags, raises):
    inside = []
    try:
        with repeatable_steps():
            inside.append(flags())
            with repeatable_steps():              # nested: the outer caller's flags stay
                inside.append(flags())
            inside.append(flags())
            if raises:
                raise RuntimeError("a step failed")
    except RuntimeError:
        assert raises
    assert inside == [REPEATABLE] * 3
    assert flags() == CALLERS


def test_repeatable_steps_keeps_the_flags_until_the_last_thread_leaves(callers_flags):
    both_inside = threading.Barrier(2)
    first_left = threading.Event()
    seen = {}

    def first():
        with repeatable_steps():
            both_inside.wait(10)
            seen["first"] = flags()
        first_left.set()

    def second():
        with repeatable_steps():
            both_inside.wait(10)
            assert first_left.wait(10)
            seen["second, after the first left"] = flags()

    threads = [threading.Thread(target=f) for f in (first, second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert not any(t.is_alive() for t in threads)
    assert seen == {"first": REPEATABLE, "second, after the first left": REPEATABLE}
    assert flags() == CALLERS


def test_repeatable_steps_depth_count_under_many_threads(callers_flags):
    """Many threads entering and leaving at once: inside, the flags are
    always set; once all have left, the callers' settings are back."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    seen_off = []

    def worker():
        for _ in range(300):
            with repeatable_steps():
                time.sleep(0)
                if flags() != REPEATABLE:
                    seen_off.append(flags())

    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert seen_off == []
    assert flags() == CALLERS


def _wav(path, n, seed, sr=24000):
    rng = np.random.default_rng(seed)
    y = 0.3 * np.sin(2 * np.pi * (200 + 37 * seed) * np.arange(n) / sr) \
        + 0.02 * rng.normal(size=n)
    wavfile.write(path, sr, (y * 32767).astype(np.int16))
    return str(path)


def _trainer(tmp_path):
    files = [_wav(tmp_path / f"clip{i}.wav", 4800, i) for i in range(4)]
    (tmp_path / "files.txt").write_text("\n".join(files) + "\n")
    data = DataConfig(filelist_path=str(tmp_path / "files.txt"), num_samples=3840,
                      batch_size=2)
    return trainer_mod.Trainer(TINY, TrainConfig(max_steps=100, disc_channels_scale=0.0625),
                               data, data, out_dir=str(tmp_path / "run"), log_every=1,
                               val_every=1, limit_val_batches=1, log_media_every=10 ** 9,
                               seed=11, device="cpu")


@pytest.mark.parametrize("raise_at", [None, 1])
def test_fit_runs_every_step_and_validation_repeatable(tmp_path, monkeypatch, callers_flags,
                                                       raise_at):
    """``Trainer.fit`` (``tools.train`` and every ``torchrun`` rank): every
    training step and every validation runs under ``repeatable_steps``, and
    the callers' flags are back afterwards, also when a step raises."""
    seen = []

    def step(state, audio, *args, **kw):
        seen.append(("train_step", flags()))
        if sum(name == "train_step" for name, _ in seen) - 1 == raise_at:
            raise RuntimeError("a step failed")
        return state, {"gen_total": torch.tensor(1.0)}

    def validate(self, state, val_iter, step):
        seen.append(("validate", flags()))
        return 1.0

    monkeypatch.setattr(trainer_mod, "TBLogger", lambda logdir: TBLogger(None))
    monkeypatch.setattr(trainer_mod, "train_step", step)
    monkeypatch.setattr(trainer_mod.Trainer, "validate", validate)
    tr = _trainer(tmp_path)
    try:
        if raise_at is None:
            tr.fit(max_batches=3)
        else:
            with pytest.raises(RuntimeError, match="a step failed"):
                tr.fit(max_batches=3)
    finally:
        tr.close()
    want = ["train_step", "train_step", "validate", "train_step", "validate"]
    assert [name for name, _ in seen] == want[:len(seen)]
    assert len(seen) == (5 if raise_at is None else 2)
    assert all(f == REPEATABLE for _, f in seen)
    assert flags() == CALLERS


def test_enhance_train_runs_every_step_repeatable(tmp_path, monkeypatch, callers_flags):
    """``tools/enhance_train.py``: every ``enhance_step`` of its loop runs
    under ``repeatable_steps`` (a narrow base model, the step stood in)."""
    seen = []

    def step(opt, adapter_params, adapter_state, *args):
        seen.append(flags())
        return adapter_state, torch.tensor(1.0 / len(seen)), torch.tensor(0.0)

    monkeypatch.setattr(enhance_train, "load_base_model", lambda config, checkpoint, seed=0: (
        TINY, init_wavtokenizer(TINY, seed=seed, random_codebook=True)))
    monkeypatch.setattr(enhance, "enhance_step", step)
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("\n".join(_wav(tmp_path / f"n{i}.wav", 2400, i) + "|"
                               + _wav(tmp_path / f"c{i}.wav", 2400, 10 + i)
                               for i in range(2)) + "\n")
    assert enhance_train.main(["--pairs-file", str(pairs), "--steps", "3", "--batch-size", "1",
                               "--num-samples", "2400", "--out-dir", str(tmp_path / "run"),
                               "--device", "cpu"]) == 0
    assert seen == [REPEATABLE] * 3
    assert flags() == CALLERS


def test_byol_train_runs_every_step_repeatable(tmp_path, monkeypatch, callers_flags):
    """``tools/byol_train.py``: every ``byol_step`` of its loop runs under
    ``repeatable_steps`` (the step stood in)."""
    seen = []

    def step(params, opt, v1, v2, cfg, tau):
        seen.append(flags())
        return torch.tensor(1.0)

    monkeypatch.setattr(byol_train, "byol_step", step)
    feats = tmp_path / "feats"
    feats.mkdir()
    for i in range(2):
        np.save(feats / f"f{i}.npy", np.random.default_rng(i).normal(size=(16, 40))
                .astype(np.float32))
    assert byol_train.main(["--features-dir", str(feats), "--steps", "3", "--batch-size", "2",
                            "--crop-frames", "8", "--out-dir", str(tmp_path / "run"),
                            "--device", "cpu"]) == 0
    assert seen == [REPEATABLE] * 3
    rows = [json.loads(l) for l in open(tmp_path / "run" / "metrics.jsonl")]
    assert rows == [{"step": 0, "byol_loss": 1.0}]
    assert flags() == CALLERS
