"""The port's multi-card paths on the CPU: data parallelism (the trainer's
DDP over gloo, the replicated engine and extraction) and the ConvNeXt
tensor parallelism, against the one-process port and the JAX package.

One ``torch.multiprocessing.spawn`` of 4 gloo ranks (one torch thread each)
serves the whole file: the ranks build a DP-4 mesh, a (data 2 x model 2)
mesh, and two meshes of 2 ranks (ranks 0-1 data-parallel, ranks 2-3 tensor-
parallel), run their parts and write their results to a temp directory; the
tests assert on those.

* Steps: two float64 steps (the first runs k-means on the gathered samples,
  pos-net dropout 0.1, whose masks are drawn for the global batch) on DP-4
  and on (2 x 2) against the one-process port on the global batch of 8:
  losses, gradient norm, the last gradients, AdamW moments and VQ state
  within 1e-9 of their scale (only summation orders differ), the weights
  within 1e-4 of the learning rate: AdamW moves an element whose gradient
  lies below its eps (1e-8) by lr * g / eps, so it multiplies the rounding of
  such a gradient by 2e4.
* Trainers: 2 steps with validation over 2 ranks (DP-2, and TP-2 on the
  model axis) write a last.pt equal to the one-process trainer's within
  float32 rounding (JAX's ``test_tp_train_step_matches_dp`` limits), which
  resumes in one process and on the TP-2 ranks; rank 0 alone writes.
* Against JAX at TINY widths (``tests/test_parallel.py``): the batch rows of
  ``shard_batch`` and the TP slices (params and AdamW moments) equal JAX's
  shards over ``make_mesh(4)``; the DP engine on two CPU replicas and the
  TP-2 decode give JAX's codes, the waveform within JAX's own 1e-5 (DP) and
  1e-4 (TP) atol; DP extraction gives JAX's codes.

JAX is imported inside the tests only: the spawned ranks import this module
and must stay free of it.
"""

import json
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
from scipy.io import wavfile

from wavtokenizer_tpu_torch import (ISTFTHeadConfig, SEANetConfig, VQConfig,
                                    VocosBackboneConfig, WavTokenizer, WavTokenizerSpec,
                                    init_wavtokenizer)
from wavtokenizer_tpu_torch.models import wavtokenizer as twt
from wavtokenizer_tpu_torch.parallel import mesh as M
from wavtokenizer_tpu_torch.train import step as ts
from wavtokenizer_tpu_torch.train import trainer as trainer_mod
from wavtokenizer_tpu_torch.train.data import DataConfig
from wavtokenizer_tpu_torch.train.helpers import TBLogger

TINY = dict(seanet=dict(dimension=16, n_filters=2, ratios=(8, 5, 4, 2)),
            vq=dict(dimension=16, bins=32, kmeans_iters=2),
            backbone=dict(input_channels=16, dim=32, intermediate_dim=64, num_layers=2,
                          adanorm_num_embeddings=4),
            head=dict(dim=32, n_fft=1280, hop_length=320))
TSPEC = WavTokenizerSpec(seanet=SEANetConfig(**TINY["seanet"]), vq=VQConfig(**TINY["vq"]),
                         backbone=VocosBackboneConfig(**TINY["backbone"]),
                         head=ISTFTHeadConfig(**TINY["head"]))
TCFG = ts.TrainConfig(max_steps=100, disc_channels_scale=0.0625, pos_dropout=0.1)
# The trainers' config: validation with the evaluators off (STOI only).
TRAIN_CFG = ts.TrainConfig(max_steps=100, disc_channels_scale=0.0625, evaluate_utmos=False,
                           evaluate_pesq=False, evaluate_periodicity=False)
GLOBAL_B, STEP_T = 8, 3200
DECODE_T = 24000
WORLD = 4


def _step_audio() -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(3).normal(size=(GLOBAL_B, STEP_T)) * 0.3)


def _decode_audio() -> np.ndarray:
    return (np.random.default_rng(1).normal(size=(GLOBAL_B, DECODE_T)) * 0.1).astype(np.float32)


def _double_state():
    st = ts.create_train_state(TSPEC, TCFG, seed=0, device="cpu")
    d = lambda t: t.double()
    return ts.new_train_state(ts.tree_map(d, st["gen"]), ts.tree_map(d, st["disc"]),
                              ts.tree_map(d, st["vq"]), ts.tree_map(d, st["decoder"]), TCFG)


def _numpy_state(state: dict, grads: list) -> dict:
    np_ = lambda t: t.detach().numpy().copy()
    moments = {k: [np_(s[k]) for name in ("opt_gen", "opt_disc")
                   for s in state[name].state_dict()["state"].values()]
               for k in ("exp_avg", "exp_avg_sq")}
    return {"gen": [np_(t) for t in ts.tree_leaves(state["gen"])],
            "disc": [np_(t) for t in ts.tree_leaves(state["disc"])],
            "vq": {k: np_(v) for k, v in state["vq"].items()}, "grads": grads,
            **moments, "step": state["step"]}


def run_steps(mesh) -> dict:
    """Two float64 steps on the global batch, this rank's rows of it under a
    mesh; the whole state after them (gathered from the model ranks)."""
    state = _double_state()
    if mesh is not None:
        state = M.shard_train_state(mesh, M.replicate_train_state(mesh, state))
    audio, metrics = _step_audio(), []
    for step in range(2):
        shard = M.batch_shard(mesh, GLOBAL_B)
        state, m = ts.train_step(state, audio[shard.start:shard.stop], TSPEC, TCFG,
                                 torch.Generator().manual_seed(step), with_grad_norm=True,
                                 shard=shard)
        metrics.append({k: float(v) for k, v in m.items()})
    # The last backward's gradients (the generator's only where it is whole).
    grads = [p.grad.numpy().copy() for name in ("opt_disc", "opt_gen")
             for p in state[name].param_groups[0]["params"]
             if name == "opt_disc" or mesh is None or mesh.model == 1]
    whole = M.gather_train_state(mesh, state) if mesh is not None else state
    return {"metrics": metrics, **_numpy_state(whole, grads)}


def tp_decode(mesh) -> dict:
    """The round trip of this data rank's rows with the ConvNeXt MLPs split
    over the model axis (the plain block with the kernel's rounding on the
    CPU, per shard)."""
    wt = WavTokenizer.from_jax_params(init_wavtokenizer(TSPEC, seed=0, random_codebook=True),
                                      TSPEC, "cpu")
    params = M.shard_generator_params(mesh, wt.params)
    shard = M.batch_shard(mesh, GLOBAL_B)
    audio = torch.from_numpy(_decode_audio()[shard.start:shard.stop])
    feats, codes = twt.encode_infer(params, TSPEC, audio)
    wave = twt.decode(params, TSPEC, feats, 0)
    return {"start": shard.start, "codes": codes.numpy(), "wave": wave.numpy(),
            "w1_cols": params["backbone"]["convnext"][0]["w1"].shape[1]}


def make_trainer(out_dir: str, filelist: str, mesh=None) -> trainer_mod.Trainer:
    data = DataConfig(filelist_path=filelist, num_samples=3840, batch_size=4)
    return trainer_mod.Trainer(TSPEC, TRAIN_CFG, data, data, out_dir=out_dir, seed=11,
                               log_every=1, val_every=1, limit_val_batches=1,
                               log_media_every=10 ** 9, device="cpu", mesh=mesh)


def _rank_main(rank: int, port: int, out: str, filelist: str) -> None:
    torch.set_num_threads(1)
    # TensorBoard's import alone takes seconds; the ranks do not log there.
    trainer_mod.TBLogger = lambda logdir: TBLogger(None)
    M.init_distributed("gloo", "cpu", f"tcp://127.0.0.1:{port}", rank, WORLD)
    try:
        # Every rank makes every group, in one order.
        dp4 = M.make_mesh(1, "cpu")
        tp22 = M.make_mesh(2, "cpu")
        pairs = M.make_mesh(1, "cpu", ranks=(0, 1)), M.make_mesh(2, "cpu", ranks=(2, 3))
        pair = pairs[rank // 2]
        res = {"dp": run_steps(dp4), "tp": run_steps(tp22), "decode": tp_decode(tp22),
               "coords": (tp22.data_rank, tp22.model_rank)}
        name = "dp2" if rank < 2 else "tp2"
        tr = make_trainer(os.path.join(out, name), filelist, pair)
        tr.fit(max_batches=2)
        tr.close()
        res["trainer"] = (name, pair.data, pair.model)
        dist.barrier()
        if rank >= 2:   # the data-parallel pair's checkpoint, one more step on the model axis
            tr = make_trainer(os.path.join(out, "tp2_resumed"), filelist, pair)
            tr.fit(max_batches=3, resume_path=os.path.join(out, "dp2", "last.pt"))
            tr.close()
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Six 24 kHz clips and their file list."""
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        t = np.arange(4800) / 24000
        y = 0.3 * np.sin(2 * np.pi * (200 + 37 * i) * t) + 0.02 * rng.normal(size=t.size)
        paths.append(str(d / f"clip{i}.wav"))
        wavfile.write(paths[-1], 24000, (y * 32767).astype(np.int16))
    filelist = d / "files.txt"
    filelist.write_text("\n".join(paths) + "\n")
    return str(filelist)


def _one_process_trainer(out, files):
    mp = pytest.MonkeyPatch()
    mp.setattr(trainer_mod, "TBLogger", lambda logdir: TBLogger(None))
    try:
        tr = make_trainer(str(out / "one"), files)
        tr.fit(max_batches=2)
        tr.close()
    finally:
        mp.undo()
    return out / "one"


@pytest.fixture(scope="module")
def runs(tmp_path_factory, files):
    """The 4 ranks' results and directory, and, computed here while they
    run, the one-process steps and the one-process trainer's directory."""
    out = tmp_path_factory.mktemp("ranks")
    ctx = torch.multiprocessing.spawn(_rank_main, args=(_free_port(), str(out), files),
                                      nprocs=WORLD, join=False)
    try:
        one = run_steps(None), _one_process_trainer(tmp_path_factory.mktemp("trainer1"), files)
    finally:
        while not ctx.join():
            pass
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return (ranks, out), one


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def one_process(runs):
    return runs[1][0]


@pytest.fixture(scope="module")
def one_process_trainer(runs):
    return runs[1][1]


def _assert_states_close(got: dict, want: dict, rel: float = 1e-9) -> None:
    for a, b in zip(got["metrics"], want["metrics"], strict=True):
        assert a.keys() == b.keys()
        for k in b:
            assert abs(a[k] - b[k]) <= rel * max(abs(b[k]), 1.0), (k, a[k], b[k])
    for key, limit in (("gen", 1e-4 * TCFG.initial_learning_rate),
                       ("disc", 1e-4 * TCFG.initial_learning_rate),
                       ("grads", None), ("exp_avg", None), ("exp_avg_sq", None)):
        if limit is None:
            limit = rel * max(np.abs(b).max() for b in want[key][:len(got[key])])
        assert len(got[key]) <= len(want[key])
        for i, (a, b) in enumerate(zip(got[key], want[key])):
            assert a.shape == b.shape, (key, i)
            assert np.abs(a - b).max() <= limit, (key, i, np.abs(a - b).max(), limit)
    for k in want["vq"]:
        scale = np.abs(want["vq"][k]).max()
        assert np.abs(got["vq"][k] - want["vq"][k]).max() <= rel * scale, k
    assert got["step"] == want["step"] == 2


def test_dp4_steps_equal_one_process_on_the_global_batch(ranks, one_process):
    """Two DP-4 steps (k-means on the gathered rows, then the EMA update on
    summed statistics) equal the one-process steps on the global batch, on
    every rank."""
    results, _ = ranks
    for r in range(WORLD):
        _assert_states_close(results[r]["dp"], one_process)


def test_tp_steps_equal_dp4(ranks):
    """The (data 2 x model 2) steps, gathered, equal the DP-4 steps: tensor
    parallelism is a layout, not a semantics (JAX's
    ``test_tp_train_step_matches_dp``, here in float64)."""
    results, _ = ranks
    for r in range(WORLD):
        assert results[r]["coords"] == (r // 2, r % 2)
        _assert_states_close(results[r]["tp"], results[0]["dp"])


def _jax_mesh_shards(x):
    """{device index: rows} of x placed by JAX's shard_batch on make_mesh(4)."""
    from wavtokenizer_tpu.parallel import mesh as jm

    mesh = jm.make_mesh(4)
    placed = jm.shard_batch(mesh, x)
    order = {d.id: i for i, d in enumerate(mesh.devices.reshape(-1))}
    return {order[s.device.id]: np.asarray(s.data) for s in placed.addressable_shards}


@pytest.mark.parametrize("n", [8, 4])
def test_shard_batch_rows_equal_jax_shards(n):
    """A divisible batch: each rank's rows are the block JAX's P("data")
    places on its device of make_mesh(4)."""
    batch = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    want = _jax_mesh_shards(batch)
    for r in range(4):
        mesh = M.Mesh(r, 4, 1, torch.device("cpu"), data_group=object())
        np.testing.assert_array_equal(M.shard_batch(mesh, batch), want[r])


@pytest.mark.parametrize("n,rows", [(10, 8), (3, 3)])
def test_shard_batch_trims_or_replicates_as_jax_trainer(n, rows):
    """Indivisible: trimmed to a multiple of the data size (logged once)
    and then JAX's blocks; smaller than the data size: replicated."""
    batch = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    logged = []
    for r in range(4):
        mesh = M.Mesh(r, 4, 1, torch.device("cpu"), data_group=object())
        got = M.shard_batch(mesh, batch, logged.append)
        M.shard_batch(mesh, batch, logged.append)
        if rows < n:
            np.testing.assert_array_equal(got, _jax_mesh_shards(batch[:rows])[r])
        else:
            np.testing.assert_array_equal(got, batch)
            assert M.batch_shard(mesh, n).group is None
    assert logged == ([{"event": "batch_trimmed", "from": n, "to": rows, "data_parallel": 4}] * 4
                      if rows < n else [])


def test_tp_slices_of_params_and_moments_equal_jax_shards():
    """pwconv1 (C, I) by columns and its bias, pwconv2 (I, C) by rows, b2
    whole, and AdamW's moments of each alike, as JAX's shard_train_state
    places them over make_mesh(4, model_parallel=2)."""
    import jax
    from wavtokenizer_tpu import (ISTFTHeadConfig as JHead, SEANetConfig as JSEANet,
                                  VQConfig as JVQ, VocosBackboneConfig as JBackbone,
                                  WavTokenizerSpec as JSpec)
    from wavtokenizer_tpu.parallel import mesh as jm
    from wavtokenizer_tpu.train.step import TrainConfig as JTrainConfig
    from wavtokenizer_tpu.train.step import create_train_state as j_create
    from wavtokenizer_tpu_torch.api.pretrained import train_state_from_jax

    jspec = JSpec(seanet=JSEANet(**TINY["seanet"]), vq=JVQ(**TINY["vq"]),
                  backbone=JBackbone(**TINY["backbone"]), head=JHead(**TINY["head"]))
    jstate = jax.device_get(j_create(jspec, JTrainConfig(disc_channels_scale=0.0625), seed=0))
    # Moments with values of their own (numpy): mu = params + 1, nu = params ** 2.
    opt = list(jstate["opt_gen"])
    i = next(i for i, s in enumerate(opt) if hasattr(s, "mu"))
    opt[i] = opt[i]._replace(mu=jax.tree.map(lambda p: p + 1.0, jstate["gen"]),
                             nu=jax.tree.map(lambda p: p * p, jstate["gen"]))
    jstate = {**jstate, "opt_gen": tuple(opt)}
    jmesh = jm.make_mesh(4, model_parallel=2)
    placed = jm.shard_train_state(jmesh, jstate)
    order = {d.id: i for i, d in enumerate(jmesh.devices.reshape(-1))}

    def shards(x):
        return {order[s.device.id]: np.asarray(s.data) for s in x.addressable_shards}

    port = train_state_from_jax(jstate, TSPEC, TCFG, "cpu")
    axes = M.generator_shardings(port["gen"])["backbone"]["convnext"][0]
    assert (axes["w1"], axes["b1"], axes["w2"], axes["b2"], axes["dw"]) == (1, 0, 0, None, None)
    leaves = ts.tree_leaves(port["gen"])
    index = {id(t): i for i, t in enumerate(leaves)}
    jadam = placed["opt_gen"][i]
    for r in range(4):
        mesh = M.Mesh(r, 2, 2, torch.device("cpu"))
        st = M.shard_train_state(mesh, port)
        moments = st["opt_gen"].state_dict()["state"]
        for b, (blk, jblk) in enumerate(zip(st["gen"]["backbone"]["convnext"],
                                            placed["gen"]["backbone"]["convnext"])):
            assert blk["tp"].rank == r % 2 and blk["tp"].size == 2
            whole = port["gen"]["backbone"]["convnext"][b]
            for key, jkey in (("w1", ("pwconv1", "weight")), ("b1", ("pwconv1", "bias")),
                              ("w2", ("pwconv2", "weight")), ("b2", ("pwconv2", "bias"))):
                got = blk[key].detach().numpy()
                np.testing.assert_array_equal(got, shards(jblk[jkey[0]][jkey[1]])[r], key)
                k = index[id(whole[key])]
                for name, jtree in (("exp_avg", jadam.mu), ("exp_avg_sq", jadam.nu)):
                    jleaf = jtree["backbone"]["convnext"][b][jkey[0]][jkey[1]]
                    np.testing.assert_array_equal(moments[k][name].numpy(), shards(jleaf)[r],
                                                  (key, name))


def test_tp_width_the_kernel_cannot_take_is_refused():
    """A shard of the inference params narrower than the kernel takes (I =
    64 over 4 model ranks: 16, not a multiple of 32) raises; it does not run
    the plain block instead."""
    wt = WavTokenizer.from_jax_params(init_wavtokenizer(TSPEC, seed=0), TSPEC, "cpu")
    with pytest.raises(ValueError, match="multiples of 32"):
        M.shard_generator_params(M.Mesh(0, 1, 4, torch.device("cpu")), wt.params)
    with pytest.raises(ValueError, match="does not split"):
        M.shard_generator_params(M.Mesh(0, 1, 3, torch.device("cpu")), wt.params)


@pytest.fixture(scope="module")
def jax_round_trip():
    """JAX's jitted encode_infer -> decode of the decode batch (tests/
    test_parallel.py's ``_roundtrip``)."""
    import jax
    import jax.numpy as jnp
    from wavtokenizer_tpu import (ISTFTHeadConfig as JHead, SEANetConfig as JSEANet,
                                  VQConfig as JVQ, VocosBackboneConfig as JBackbone,
                                  WavTokenizerSpec as JSpec)
    from wavtokenizer_tpu.models import wavtokenizer as jwt
    from wavtokenizer_tpu.models.init import init_wavtokenizer as j_init

    jspec = JSpec(seanet=JSEANet(**TINY["seanet"]), vq=JVQ(**TINY["vq"]),
                  backbone=JBackbone(**TINY["backbone"]), head=JHead(**TINY["head"]))

    def round_trip(params, audio):
        feats, codes = jwt.encode_infer(params, jspec, audio)
        return codes, jwt.decode(params, jspec, feats, 0)

    params = j_init(jspec, seed=0, random_codebook=True)
    codes, wave = jax.jit(round_trip)(params, jnp.asarray(_decode_audio()))
    return np.asarray(codes), np.asarray(wave)


def test_tp2_decode_matches_jax(ranks, jax_round_trip):
    """The (2 x 2) round trip: each data rank's rows, the ConvNeXt MLPs split
    in two (32 of 64 columns a shard): JAX's codes, and JAX's waveform
    within its own TP tolerance; the two model ranks of a data rank agree."""
    results, _ = ranks
    codes, wave = jax_round_trip
    for r in range(WORLD):
        d = results[r]["decode"]
        rows = slice(d["start"], d["start"] + GLOBAL_B // 2)
        assert d["w1_cols"] == 32
        np.testing.assert_array_equal(d["codes"], codes[:, rows])
        np.testing.assert_allclose(d["wave"], wave[rows], atol=1e-4)
        np.testing.assert_array_equal(d["wave"], results[r ^ 1]["decode"]["wave"])


def test_dp_engine_on_two_replicas_matches_jax(jax_round_trip):
    """ServingEngine(devices=["cpu", "cpu"]): concurrent encode and
    detokenize requests split over two replicas give JAX's codes and its
    waveform within JAX's DP atol; a bucket that does not divide over the
    devices is refused."""
    from wavtokenizer_tpu_torch.api.engine import EngineConfig, ServingEngine

    codes, wave = jax_round_trip
    wt = WavTokenizer.from_jax_params(init_wavtokenizer(TSPEC, seed=0, random_codebook=True),
                                      TSPEC, "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        ServingEngine(wt, EngineConfig(batch_sizes=(1, 8)), devices=["cpu", "cpu"])
    eng = ServingEngine(wt, EngineConfig(batch_sizes=(2, 8), clip_seconds=(1.0,),
                                         max_wait_ms=50.0), devices=["cpu", "cpu"])
    try:
        assert len(eng.replicas) == 2 and eng.replicas.models[1] is not wt
        audio = _decode_audio()
        enc = [eng.submit("encode", a) for a in audio]
        got_codes = np.stack([f.result(timeout=120)[1] for f in enc])
        np.testing.assert_array_equal(got_codes, codes[0])
        det = [eng.submit("detokenize", c) for c in got_codes]
        got_wave = np.stack([f.result(timeout=120) for f in det])
        np.testing.assert_allclose(got_wave, wave, atol=1e-5)
    finally:
        eng.close()


def _last(path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_ckpt_close(got: dict, want: dict) -> None:
    """float32 trainers in other summation orders: JAX's TP-vs-DP limits
    (weights atol 5e-5, rtol 2e-3) on every leaf and on the AdamW moments
    (their atol scaled to the tree's largest moment).  An element whose
    gradient is ~0 (its first moment below 1e-4 of the tree's largest) may
    take AdamW's update of +-lr with either sign, so such an element of the
    weights is held to the steps' largest move, 2 lr a step."""
    assert got["step"] == want["step"]
    for k in ("vq", "decoder"):
        for a, b in zip(ts.tree_leaves(got[k]), ts.tree_leaves(want[k]), strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=5e-5, err_msg=k)
    for k in ("gen", "disc"):
        sa, sb = got[f"opt_{k}"]["state"], want[f"opt_{k}"]["state"]
        top = {name: max(float(s[name].abs().max()) for s in sb.values())
               for name in ("exp_avg", "exp_avg_sq")}
        leaves = zip(ts.tree_leaves(got[k]), ts.tree_leaves(want[k]), strict=True)
        for i, (a, b) in enumerate(leaves):
            assert a.shape == b.shape, (k, i)
            for name in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_allclose(sa[i][name].numpy(), sb[i][name].numpy(), rtol=2e-3,
                                           atol=1e-4 * top[name], err_msg=(k, i, name))
            free = np.abs(sb[i]["exp_avg"].numpy()) < 1e-4 * top["exp_avg"]
            diff = np.abs(a.numpy() - b.numpy())
            assert (diff[~free] <= 5e-5 + 2e-3 * np.abs(b.numpy()[~free])).all(), (k, i)
            assert (diff[free] <= 4 * TRAIN_CFG.initial_learning_rate * got["step"]).all(), (k, i)
    assert got["sched_gen"]["last_epoch"] == want["sched_gen"]["last_epoch"]


@pytest.mark.parametrize("name", ["dp2", "tp2"])
def test_two_rank_trainer_checkpoint_equals_one_process(ranks, one_process_trainer, name):
    """Trainer.fit over 2 ranks for 2 steps (validation after step 1) writes
    the one-process trainer's last.pt, whichever axis the ranks make; rank 0
    alone writes: one metrics row per step, no other file."""
    results, out = ranks
    run = out / name
    assert [r["trainer"] for r in results] == [("dp2", 2, 1)] * 2 + [("tp2", 1, 2)] * 2
    _assert_ckpt_close(_last(run / "last.pt"), _last(one_process_trainer / "last.pt"))
    rows = [json.loads(l) for l in open(run / "metrics.jsonl")]
    assert [r["step"] for r in rows if "gen_total" in r] == [0, 1]
    assert [r["step"] for r in rows if "val_loss" in r] == [1]
    assert sorted(os.listdir(run)) == sorted(os.listdir(one_process_trainer))
    one = [r for r in map(json.loads, open(one_process_trainer / "metrics.jsonl"))
           if "gen_total" in r]
    for a, b in zip((r for r in rows if "gen_total" in r), one, strict=True):
        for k in ("gen_total", "disc_total", "mel_loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= 2e-3 * abs(b[k]) + 1e-4, (k, a[k], b[k])


def test_two_rank_checkpoint_resumes_in_one_process(ranks, one_process_trainer, tmp_path,
                                                    files, monkeypatch):
    """The DP-2 trainer's last.pt resumes for a third step in one process,
    as the one-process trainer's own last.pt does, and so does it on the
    two ranks of the model axis (TP-2)."""
    _, out = ranks
    monkeypatch.setattr(trainer_mod, "TBLogger", lambda logdir: TBLogger(None))
    ends = {}
    for name, src in (("from_dp2", out / "dp2"), ("from_one", one_process_trainer)):
        tr = make_trainer(str(tmp_path / name), files)
        ends[name] = tr.fit(max_batches=3, resume_path=str(src / "last.pt"))
        tr.close()
    got, want = (_last(tmp_path / n / "last.pt") for n in ("from_dp2", "from_one"))
    assert got["step"] == 3
    _assert_ckpt_close(got, want)
    _assert_ckpt_close(_last(out / "tp2_resumed" / "last.pt"), want)


# The narrowest codec a config file can describe (tests/test_torch_trainer.py).
CODEC_YAML = """\
model:
  class_path: decoder.experiment.WavTokenizer
  init_args:
    sample_rate: 24000
    feature_extractor:
      class_path: decoder.feature_extractors.EncodecFeatures
      init_args: {bandwidths: [6.6, 6.6, 6.6, 6.6], dowmsamples: [4, 2, 2, 2], vq_bins: 64,
                  vq_kmeans: 2, num_quantizers: 1}
    backbone:
      class_path: decoder.models.VocosBackbone
      init_args: {input_channels: 512, dim: 64, intermediate_dim: 192, num_layers: 1,
                  adanorm_num_embeddings: 4}
    head:
      class_path: decoder.heads.ISTFTHead
      init_args: {dim: 64, n_fft: 128, hop_length: 32, padding: same}
"""


@pytest.fixture(scope="module")
def extraction(tmp_path_factory):
    """That codec as a Lightning checkpoint, and five WAVs (a ragged count
    for batches of 2)."""
    from wavtokenizer_tpu_torch.api.config import spec_from_config
    from wavtokenizer_tpu_torch.checkpoint.export import (save_torch_checkpoint,
                                                          wavtokenizer_state_dict)

    d = tmp_path_factory.mktemp("extract")
    (d / "codec.yaml").write_text(CODEC_YAML)
    spec = spec_from_config(str(d / "codec.yaml"))
    sd = wavtokenizer_state_dict(init_wavtokenizer(spec, seed=0, random_codebook=True),
                                 spec.seanet, spec.backbone, head_n_fft=spec.head.n_fft)
    save_torch_checkpoint(str(d / "m.ckpt"), sd)
    (d / "wavs").mkdir()
    rng = np.random.default_rng(5)
    for i in range(5):
        y = rng.normal(size=12000 + 700 * i) * 0.1
        wavfile.write(str(d / "wavs" / f"f{i}.wav"), 24000, (y * 32767).astype(np.int16))
    return d / "codec.yaml", d / "m.ckpt", d / "wavs"


def test_dp_extraction_matches_one_device_and_jax(extraction, tmp_path):
    """``extract_features --devices cpu,cpu`` (batches of 2 over two
    replicas, the last one padded) writes what ``--devices cpu`` writes, and
    the codes of JAX's jitted encode_infer of the same windows."""
    import jax
    import jax.numpy as jnp
    from wavtokenizer_tpu.api.pretrained import WavTokenizer as JWavTokenizer
    from wavtokenizer_tpu.models import wavtokenizer as jwt
    from wavtokenizer_tpu_torch.tools import extract_features as xf

    cfg, ckpt, wavs = extraction
    for name, devices in (("one", "cpu"), ("two", "cpu,cpu")):
        assert xf.main(["--config", str(cfg), "--ckpt", str(ckpt), "--input", str(wavs),
                        "--out-dir", str(tmp_path / name), "--device", "cpu",
                        "--devices", devices, "--batch-size", "3", "--seconds", "0.5",
                        "--codes"]) == 0
    stems = [f"f{i}" for i in range(5)]
    assert sorted(os.listdir(tmp_path / "two")) == sorted(os.listdir(tmp_path / "one")) \
        == sorted(f"{s}_{k}.npy" for s in stems for k in ("codes", "features"))
    for s in stems:
        np.testing.assert_array_equal(np.load(tmp_path / "two" / f"{s}_codes.npy"),
                                      np.load(tmp_path / "one" / f"{s}_codes.npy"))
        np.testing.assert_allclose(np.load(tmp_path / "two" / f"{s}_features.npy"),
                                   np.load(tmp_path / "one" / f"{s}_features.npy"),
                                   rtol=0, atol=1e-6)
    jm = JWavTokenizer.from_pretrained0802(str(cfg), str(ckpt))
    audio = np.stack([xf.load_window(wavs / f"{s}.wav", 24000, 12000) for s in stems])
    _, codes = jax.jit(lambda p, a: jwt.encode_infer(p, jm.spec, a))(jm.params,
                                                                     jnp.asarray(audio))
    got = np.stack([np.load(tmp_path / "two" / f"{s}_codes.npy")[0] for s in stems])
    np.testing.assert_array_equal(got, np.asarray(codes)[0])
