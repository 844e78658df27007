#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wavtokenizer_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's four CUDA kernels from csrc/ (one nvcc per source, started
together), holds each kernel against its plain PyTorch version at the main
path's shapes, gates the codes of the three golden configs against
tests/golden/bench_tokens.npz, drives the small-320 codec round trip
(encode_infer -> codes_to_features -> decode) through the WavTokenizer entry
points on the card and checks it against the same on the CPU, shows that the
round trip launched every kernel, and times the stages and the kernels at
batch 128 x 3 s (the VQ kernel also held against its plain version on that
batch's own encoder output, and on rows just beyond the near-tie tolerance,
where the kernel fed operands without their TF32 tails must fail).  Then it
serves the model through the port's engine and HTTP server (concurrent
requests, answers held against direct calls), and runs the long-audio path
over four long streams; each of those paths, too, must launch every kernel.
Then the residual-VQ path: the EnCodec 24 kHz model (32 chained VQ-kernel
launches per encode, each layer held against the plain search on the
chain's own residual; codes and waveform against the CPU; stage times at
batch 64 x 3 s; the near-tie rows on its codebook) and the 48 kHz stereo
model (four 1 s segments, the last ragged); small-320's training-style
encode, copy synthesis and SEANet-only decode through the facade; and
tools/compress.py as a subprocess, with the LM and fixed-rate, whose ids
must survive the round trip.  Weights are random, drawn from seed 0 by the
port's numpy init.

Then training ([12]): one step of small-320 at full generator width on
the card against the CPU from one state (losses, gradient norm, VQ state,
k-means' codes), the VQ kernel at k-means' shapes (means drawn with
replacement, the pack made per call), the step of the small-320 YAML at
batch 40 x 3 s timed (memory, phases, profile, 202 VQ launches on the first
step and 2 after), and tools/train.py as a subprocess at PyTorch's default
precision: its checkpoint reloads through from_train_checkpoint and,
exported to the Lightning layout, through from_pretrained0828, and a second
run from the same seed, and a 2-batch run resumed to 3, write the same
checkpoint bit for bit.

Then the plain-Vocos family ([13]): the vocos-mel-24khz config
(wavtokenizer_tpu_torch/configs/vocos_mel_24khz.yaml) at full width through
the Vocos facade, 8 ConvNeXt-kernel launches a decode at C = 512, I = 1536,
card against CPU and timed at batch 128 x 3 s, and the ResNet trunk with
both IMDCT heads card against CPU.  And the metrics ([14]): a small-320
round trip writes 4 clips, and tools/metrics_infer.py scores them as a
subprocess on the card and on the CPU, with CREPE and UTMOS read from
seeded random state dicts in the reference layouts.

Then the research layer ([15]) at small-320 width: enhanced_forward (frozen
encoder through the front kernel -> adapter -> SEANet decoder) at 8 x 72 000
card against CPU with one front launch each, the kernel against its plain
version on that batch and timed there; one enhance_step in each of the four
modes card against CPU (two front launches a step in feature and hybrid),
and each mode's step and a BYOL step twice from one state under
repeatable_steps, bit for bit; the waveform step, enhance_infer's forward
and a BYOL step timed; device
resampling against the host resampler at 16 x 10 s; and the enhancement,
BYOL and low-pass CLIs as subprocesses on the card.

Then the training options, the native loader and the profiling tools
([16]) at the small-320 YAML's full width: the trainer's native loader on
48 WAVs written here (thread count and resume leave its batches unchanged);
one state after its first step (k-means split out), one batch, one step in
each of fp32, fp32 with remat, bf16 discriminators, and bf16 discriminators
and decode side (ms, peak memory, VQ launches; remat against no remat phase
by phase, bf16 against fp32 at the JAX package's tolerances, the same codes
in every mode), and in each mode and at PyTorch's default precision the
cost of repeatable_steps (steps with and without it, in turns);
tools/mem_probe.py with and without remat, check_env.py, perf_profile.py
(its stage table with MFU; its stage sum against [6]'s round trip) and
train_profile.py as subprocesses; stage_flops with the kernels against the
plain versions; the MS-STFT discriminator card against CPU.
The card's peaks and the kernels' bounds come from
wavtokenizer_tpu_torch/utils/profiling.py.

Then the multi-card paths ([17]) on this one card: one step of the
small-320 YAML through an in-process NCCL group of one rank against the
plain step (collectives counted); two spawned ranks over gloo sharing the
card, 4 rows each of an 8 x 3 s batch from an un-inited codebook (k-means
on the gathered samples, the VQ kernel in both ranks) against the
one-process step; the data-parallel engine with two replicas on the card
and tools/extract_features.py with two against one; and the ConvNeXt
kernel on 2 and 4 tensor-parallel slices of its hidden width, summed
against the whole kernel and the plain block, and timed.

Last, determinism ([18]): the segment-sum kernels (the order, then the
sums), which sum the VQ's training statistics (k-means and the EMA) in a
fixed order without float atomics, at 9000 x 4096 x 512 with skewed, spread
and mixed ids and with two sets of ids that [12] (c) took from the training
path, equal bit for bit to index_add_ on the CPU and to their own second
launch, one launch of each in a call's trace and no sort, each kernel timed
alone beside the bound, the chain floor and index_add_ on the card, and the
wrapper's host time; and the YAML's step run twice
from one state under repeatable_steps (cuDNN's deterministic algorithms,
as every trainer runs its steps): every quantity equal.  The golden gate of
[4] is the library's (utils/golden.py::check_codes); [12], [16] and [17]
count the segment-sum launches too (202 on the first step, 2 a step after).

And the VQ's effective_expiry ([19]): one vq_train_forward with it at the
YAML's VQ (N = 9000, 4096 x 512, k-means 200 iterations) from an un-inited
layer on rows of exact integer points, card against CPU (ids equal, state
within 1e-5), the expired codes' EMA rows checked, and the same forward
without it giving the same ids, rows and loss.

Every phase prints a flushed line; any failure exits non-zero.  The line
before the last is one JSON object with a row per kernel; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

TIMING_BATCH = 128
TIMING_SECONDS = 3.0


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseFailed(msg)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if res.returncode != 0:
        raise PhaseFailed(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms of fn() on the card, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def default_precision():
    """PyTorch's default precision, the one the CLIs run at (cuDNN TF32 on,
    cuBLAS matmuls in fp32), inside; this process runs with TF32 off."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def launch_counts(K) -> dict:
    return {"vq_nearest": K.vq_nearest.launches,
            "convnext_block": K.convnext_block.launches,
            "encoder_front": K.encoder_front.launches}


# torch.profiler (Kineto over CUPTI) on the H100 loses device records once
# the process has run [12]'s training (a fresh process loses none, and a
# trace of 20 000 kernels alone does not cause it): mostly the first few
# kernels of a trace, at times all of them.  So each trace starts with
# TRACE_WARMUP short kernels of its own, waited for and left out of the
# result, which take the loss at the start; a trace that still lost records
# (none held, or ``complete`` says some are missing) is taken again, up to
# TRACE_ATTEMPTS times in all.  TRACES counts the traces taken and those that
# lost records; [18] measures the loss with and without the warm-up (PERF.md
# §6).
TRACE_WARMUP = 32
TRACE_ATTEMPTS = 3
TRACES = {"taken": 0, "lost": 0}


def _trace_once(fn, warmup: int) -> tuple:
    """One torch.profiler trace (CPU and CUDA activity) of fn() after
    ``warmup`` short kernels of its own: (every event, fn's device events,
    their ms and count by kernel name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(warmup):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        with record_function("traced fn"):
            fn()
            torch.cuda.synchronize()
    events = list(prof.events())
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and "spin_kernel" not in e.name and e.name != "traced fn"]
    by_name: dict = {}
    for e in dev:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return events, dev, by_name


def traced(fn, complete=None) -> tuple:
    """Run fn() once under torch.profiler after the warm-up; returns the
    device time in ms and the launch count of every CUDA kernel by name, and
    the device idle share of the window from fn's start to the last kernel's
    end.  ``complete(by_name)``, where given, says whether the trace holds
    every launch fn made.  Raises when no attempt traced device activity."""
    from torch.autograd import DeviceType

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        events, dev, by_name = _trace_once(fn, TRACE_WARMUP)
        TRACES["taken"] += 1
        if dev and (complete is None or complete(by_name)):
            break
        TRACES["lost"] += 1
        log(f"[profile] trace {attempt} of {TRACE_ATTEMPTS} "
            + ("held no device activity" if not dev else "lost device events"))
    check(bool(dev), "torch.profiler traced no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    start = min(e.time_range.start for e in events
                if e.device_type == DeviceType.CPU and e.name == "traced fn")
    window = max(e for _, e in spans) - start
    return by_name, 1.0 - busy / window


def kernel_lines(by_name: dict, top: int) -> str:
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return "; ".join(f"{name[:60]} {ms:.3f} ms x{n}" for name, (ms, n) in rows)


def vq_distance_gap(x, embed, a, b) -> float:
    """Largest |d(x, e_a) - d(x, e_b)| in float64 over rows where the codes
    differ (0.0 when they agree), and raise unless every such row is a
    near-tie (relative gap under 1e-5)."""
    bad = torch.nonzero(a != b).flatten()
    if bad.numel() == 0:
        return 0.0
    x64, e64 = x[bad].double(), embed.double()
    da = ((x64 - e64[a[bad].long()]) ** 2).sum(1)
    db = ((x64 - e64[b[bad].long()]) ** 2).sum(1)
    gap = (da - db).abs()
    check(bool((gap <= 1e-5 * db.abs()).all()), f"vq_nearest: non-tie flips {gap.tolist()}")
    return float(gap.max())


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def resolution_check(K, embed, esq, pack, n: int) -> dict:
    """Rows placed just beyond the near-tie tolerance over n code pairs
    (``utils/golden.py::near_tie_rows``): the kernel and the plain version
    must get every row right, and the same kernel fed operands without their
    TF32 tails (x rounded to TF32 before the call, the pack's tail zeroed)
    must not."""
    from wavtokenizer_tpu_torch.utils.golden import near_tie_rows, nearest_two

    rows = near_tie_rows(embed, n)
    near, d2 = nearest_two(rows, embed)
    truth = near[:, 0].int()
    tie_gap = float(((d2[:, 1] - d2[:, 0]) / d2[:, 0]).min())
    heads = K.pack_vq_codebook(rows)[0]
    no_tail = torch.stack([pack[0], torch.zeros_like(pack[1])])
    plain_rows = K.vq_nearest_reference(rows, embed, esq)
    runs = {"kernel": K.vq_nearest(rows, embed, esq, pack),
            "x tail dropped": K.vq_nearest(heads, embed, esq, pack),
            "codebook tail dropped": K.vq_nearest(rows, embed, esq, no_tail),
            "both tails dropped (1xTF32)": K.vq_nearest(heads, embed, esq, no_tail)}
    torch.cuda.synchronize()
    wrong = {k: int((v != truth).sum()) for k, v in runs.items()}
    plain_wrong = int((plain_rows != truth).sum())
    check(tie_gap > 1e-5, f"near-tie rows: smallest gap {tie_gap:.3g} is a near-tie")
    check(plain_wrong == 0 and wrong["kernel"] == 0,
          f"near-tie rows: plain {plain_wrong}, kernel {wrong['kernel']} rows wrong")
    check(all(v > 0 for k, v in wrong.items() if k != "kernel"),
          f"near-tie rows do not tell a dropped product term apart: {wrong}")
    return {"n": n, "C": embed.shape[0], "D": embed.shape[1], "gap": tie_gap,
            "codes": truth.unique().numel(), "plain": plain_wrong, "wrong": wrong}


def resolution_line(res: dict) -> str:
    return (f"N={res['n']} rows (C={res['C']}, D={res['D']}) whose two nearest codes lie "
            f"{res['gap']:.3g} relative apart or more, over {res['codes']} codes; rows not "
            f"given their nearest code: plain {res['plain']}, "
            + ", ".join(f"{k} {v}" for k, v in res["wrong"].items()))


# Served and chunked audio against the direct calls on the same card: the same
# kernels and the same fp32 cuDNN settings; only the batch a row rides in
# differs.  That can move cuDNN's fp32 sums (another algorithm for another
# batch) by ~1e-7 relative and at worst flip the bf16 rounding of single
# ConvNeXt operands (one step, 2^-9, averaged over 768- and 2304-term sums).
# The card against the CPU, which differs far more, measured a 9.5e-5
# waveform rel-max in phase 5; 2e-3 sits well above both.
SAME_CARD_WAVE_TOL = 2e-3


def serving_phase(model, spec, K, kind: str) -> dict:
    """Phase 7: the random small-320 model behind the port's HTTP server on
    127.0.0.1 (port 0, a thread), concurrent requests, every answer held
    against a direct call."""
    import concurrent.futures as cf
    import http.client
    import threading

    from wavtokenizer_tpu_torch.api.engine import EngineConfig, ServingEngine
    from wavtokenizer_tpu_torch.tools import serve
    from wavtokenizer_tpu_torch.utils.golden import max_flips

    sr = spec.sample_rate
    eng = ServingEngine(model, EngineConfig(batch_sizes=(1, 8, 32), clip_seconds=(3.0,)))
    httpd = serve.build_server("127.0.0.1", 0, eng, kind)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]

    def post(path, body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        t0 = time.perf_counter()
        conn.request("POST", path, body, {"Content-Type": "application/json"})
        r = conn.getresponse()
        out = r.status, json.loads(r.read()), time.perf_counter() - t0
        conn.close()
        return out

    try:
        eng.warmup()
        rng = np.random.default_rng(7)
        lengths = [3 * sr] * 64 + [3 * sr - 1, int(1.37 * sr), 2 * sr + 7, sr + 1]
        clips = [(rng.normal(size=n) * 0.1).astype(np.float32) for n in lengths]
        _, codes_full = model.encode_infer(np.stack(clips[:16]))
        detok = [codes_full[0, i].cpu().numpy() for i in range(16)]
        bodies = ([("/encode", json.dumps({"audio": serve.encode_tensor(c)})) for c in clips]
                  + [("/detokenize", json.dumps({"codes": serve.encode_tensor(c)}))
                     for c in detok])
        bad = [("/encode", json.dumps({"audio": serve.encode_tensor(
                   np.zeros(4 * sr, np.float32))})),
               ("/encode", "{\"audio\": [1, 2")]
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(max_workers=32) as pool:
            results = list(pool.map(lambda b: post(*b), bodies + bad))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = launch_counts(K)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
        # The same requests straight to the engine, without HTTP and JSON:
        # the engine layer's own rate.
        t0 = time.perf_counter()
        futs = ([eng.submit("encode", c) for c in clips]
                + [eng.submit("detokenize", c) for c in detok])
        for f in futs:
            f.result(600)
        engine_wall = time.perf_counter() - t0
        # An out-of-range code (>= bins) must fail only its own request, with
        # a 400, and leave the card serving: the requests after it succeed.
        bad_codes = detok[0].copy()
        bad_codes[5] = spec.vq.bins
        bad_code = post("/detokenize", json.dumps({"codes": serve.encode_tensor(bad_codes)}))
        after = [post("/detokenize", json.dumps({"codes": serve.encode_tensor(c)}))
                 for c in detok[:4]]
        after.append(post("/encode", json.dumps({"audio": serve.encode_tensor(clips[0])})))
        torch.cuda.synchronize()
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.close()

    check(all(v > 0 for v in launches.values()), f"serving launches {launches}")
    good, bad_res = results[:len(bodies)], results[len(bodies):]
    check([r[0] for r in bad_res] == [400, 400],
          f"bad requests answered {[r[0] for r in bad_res]}, expected 400 and 400")
    check(all(r[0] == 200 for r in good),
          f"failed requests: {[(r[0], r[1].get('error')) for r in good if r[0] != 200]}")
    check(bad_code[0] == 400, f"out-of-range code answered {bad_code[0]}, expected 400")
    check(all(r[0] == 200 for r in after),
          f"requests after the out-of-range code: {[r[0] for r in after]}")
    after_rel = max(rel_max(torch.as_tensor(serve.decode_tensor(a[1]["audio"])),
                            torch.as_tensor(serve.decode_tensor(g[1]["audio"])))
                    for a, g in zip(after[:4], good[len(clips):]))
    check(after_rel < SAME_CARD_WAVE_TOL,
          f"audio after the out-of-range code: rel-max err {after_rel:.3g} against before it")
    # Every served code row against a direct encode of that clip.
    flips = n_ids = 0
    for clip, (_, out, _) in zip(clips, good):
        served = serve.decode_tensor(out["codes"])
        want = model.encode_infer(clip[None])[1][0, 0].cpu().numpy()
        flips += int((served != want).sum())
        n_ids += want.size
    check(flips <= max_flips(n_ids), f"served codes: {flips} of {n_ids} differ")
    want_wav = model.decode(model.codes_to_features(codes_full), 0)
    wave_rel = 0.0
    for i, (_, out, _) in enumerate(good[len(clips):]):
        served = torch.as_tensor(serve.decode_tensor(out["audio"])).to(want_wav.device)
        wave_rel = max(wave_rel, rel_max(served, want_wav[i]))
    check(wave_rel < SAME_CARD_WAVE_TOL, f"served audio rel-max err {wave_rel:.3g}")
    lat = np.array([r[2] for r in good]) * 1e3
    audio_s = (sum(lengths) + sum(len(c) for c in detok) * spec.hop_length) / sr
    return {"requests": len(good), "wall_s": wall, "req_per_s": len(good) / wall,
            "audio_s_per_s": audio_s / wall, "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "occupancy": stats["mean_batch_occupancy"], "batches": stats["batches"],
            "engine_req_per_s": len(good) / engine_wall,
            "engine_audio_s_per_s": audio_s / engine_wall,
            "flips": flips, "n_ids": n_ids, "wave_rel": wave_rel, "launches": launches,
            "after_rel": after_rel}


def long_audio_phase(model, spec, K) -> dict:
    """Phase 8: reconstruct_long_batch over four long streams against
    reconstruct_long per stream."""
    from wavtokenizer_tpu_torch.api.streaming import reconstruct_long, reconstruct_long_batch

    sr = spec.sample_rate
    rng = np.random.default_rng(8)
    seconds = (10.0, 25.0, 37.3, 60.0)
    audios = [(rng.normal(size=int(s * sr)) * 0.1).astype(np.float32) for s in seconds]
    reconstruct_long_batch(model, audios[:1], batch_size=128)       # warm up
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = reconstruct_long_batch(model, audios, batch_size=128)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(K)
    check(all(v > 0 for v in launches.values()), f"long-audio launches {launches}")
    rels = []
    for y, out in zip(audios, outs):
        want = reconstruct_long(model, y)
        check(out.shape == want.shape == (len(y),) and bool(torch.isfinite(out).all()),
              f"long audio: shape {tuple(out.shape)} or non-finite values")
        rels.append(rel_max(out, want))
    check(max(rels) < SAME_CARD_WAVE_TOL, f"long audio rel-max errs {rels}")
    return {"seconds": seconds, "wall_s": wall, "rtf": sum(seconds) / wall, "rels": rels,
            "launches": launches}


def rvq_replay(K, quantizer, emb: torch.Tensor, codes: torch.Tensor) -> tuple:
    """The kernel's residual chain replayed with the plain version: layer q's
    plain search on the residual the kernel's own codes of layers < q left.
    Returns the flips per layer (each checked to be a near-tie) and the
    largest float64 gap among them."""
    residual = emb.reshape(-1, emb.shape[-1]).float()
    flips, gap = [], 0.0
    for q in range(codes.shape[0]):
        e = quantizer["embed"][q]
        got = codes[q].reshape(-1)
        want = K.vq_nearest_reference(residual, e, quantizer["esq"][q])
        flips.append(int((got != want).sum()))
        gap = max(gap, vq_distance_gap(residual, e, got, want))
        residual = residual - e[got.long()]
    return flips, gap


def encodec_phase(K) -> dict:
    """Phase 9: the EnCodec 24 kHz model (32 quantizers) and the 48 kHz
    stereo model (16 quantizers, 1 s segments) at full width through the
    port's encodec.encode/decode/forward, against the CPU."""
    from wavtokenizer_tpu_torch.api.pretrained import encodec_from_jax_params
    from wavtokenizer_tpu_torch.models import encodec as E
    from wavtokenizer_tpu_torch.models import quantize, seanet
    from wavtokenizer_tpu_torch.models.init import init_encodec
    from wavtokenizer_tpu_torch.models.wavtokenizer import full_fp32
    from wavtokenizer_tpu_torch.utils.golden import max_flips
    from wavtokenizer_tpu_torch.utils.profiling import vq_bound_of

    out = {}
    cfg = E.encodec_model_24khz_config()
    params_np = init_encodec(cfg, seed=0)
    gpu = encodec_from_jax_params(params_np, cfg, "cuda")
    cpu = encodec_from_jax_params(params_np, cfg, "cpu")
    sr, n_q = cfg.sample_rate, cfg.vq.n_q
    rng = np.random.default_rng(9)
    x = torch.as_tensor((rng.normal(size=(8, 1, 3 * sr)) * 0.1).astype(np.float32))
    xg = x.to("cuda")
    K.reset_launch_counts()
    frames = E.encode(gpu, cfg, xg)
    torch.cuda.synchronize()
    out["launches_per_encode"] = launches = launch_counts(K)
    check(launches == {"vq_nearest": n_q, "convnext_block": 0, "encoder_front": 0},
          f"encodec 24k encode launches {launches}, expected {n_q} vq_nearest only")
    codes = frames[0][0]                                  # (B, 32, T')
    check(len(frames) == 1 and tuple(codes.shape) == (8, n_q, 3 * cfg.frame_rate),
          f"encodec 24k codes shape {tuple(codes.shape)}")
    # Layer-conditioned: the plain search on the kernel chain's own residual.
    with torch.inference_mode(), full_fp32():
        emb = seanet.seanet_encode(gpu["encoder"], cfg.seanet, xg.transpose(1, 2))
        chain = quantize.vq_encode(gpu["quantizer"], cfg.vq, emb)
        flips, gap = rvq_replay(K, gpu["quantizer"], emb, chain)
    torch.cuda.synchronize()
    out["same_card"] = int((chain.transpose(0, 1) != codes).sum())
    out["flips"], out["gap"] = flips, gap
    frames_cpu = E.encode(cpu, cfg, x)
    codes_cpu = frames_cpu[0][0]
    per_layer = (codes.cpu() != codes_cpu).sum(dim=(0, 2)).tolist()
    n0 = codes[:, 0].numel()
    check(per_layer[0] <= max_flips(n0), f"encodec 24k layer-0 codes vs CPU: {per_layer[0]} differ")
    out["cpu_layers"] = per_layer
    wave = E.decode(gpu, cfg, frames)
    wave_cpu = E.decode(cpu, cfg, [(codes.cpu(), None)])
    torch.cuda.synchronize()
    check(tuple(wave.shape) == tuple(x.shape) and bool(torch.isfinite(wave).all()),
          f"encodec 24k waveform shape {tuple(wave.shape)} or non-finite values")
    out["wave_rel"] = rel_max(wave.cpu(), wave_cpu)
    check(out["wave_rel"] <= 1e-3, f"encodec 24k waveform card vs CPU rel-max {out['wave_rel']:.3g}")
    out["distinct"] = [int(codes[:, q].unique().numel()) for q in (0, n_q - 1)]

    # Timing at B=64 x 3 s.
    xt = torch.as_tensor((rng.normal(size=(64, 1, 3 * sr)) * 0.1).astype(np.float32)).cuda()
    q = gpu["quantizer"]
    with torch.inference_mode():
        with full_fp32():
            emb_t = seanet.seanet_encode(gpu["encoder"], cfg.seanet, xt.transpose(1, 2))
            codes_t = quantize.vq_encode(q, cfg.vq, emb_t)
        feats_t = quantize.vq_decode(q, codes_t)

        def enc():
            with full_fp32():
                seanet.seanet_encode(gpu["encoder"], cfg.seanet, xt.transpose(1, 2))

        def rvq():
            with full_fp32():
                quantize.vq_encode(q, cfg.vq, emb_t)

        stages = {"encoder": cuda_ms(enc, 3), "rvq (32 layers)": cuda_ms(rvq, 10),
                  "decoder": cuda_ms(lambda: seanet.seanet_decode(
                      gpu["decoder"], cfg.seanet, quantize.vq_decode(q, codes_t)), 3)}
        rt = cuda_ms(lambda: E.forward(gpu, cfg, xt), 3)
        flat = emb_t.reshape(-1, emb_t.shape[-1]).contiguous()
        N, D = flat.shape
        C = q["embed"].shape[1]
        got = K.vq_nearest(flat, q["embed"][0], q["esq"][0], q["pack"][0])
        want = K.vq_nearest_reference(flat, q["embed"][0], q["esq"][0])
        torch.cuda.synchronize()
        out["vq_err"] = vq_distance_gap(flat, q["embed"][0], got, want)
        out["vq_flips"] = int((got != want).sum())
        out["vq_ms"] = cuda_ms(lambda: K.vq_nearest(flat, q["embed"][0], q["esq"][0],
                                                    q["pack"][0]), 50)
        out["vq_plain_ms"] = cuda_ms(lambda: K.vq_nearest_reference(flat, q["embed"][0],
                                                                     q["esq"][0]), 50)
        split, idle = traced(lambda: E.forward(gpu, cfg, xt))
    del feats_t
    out["vq_bound_ms"], out["vq_bound_by"] = vq_bound_of(N, C, D)
    out["N"], out["C"], out["D"] = N, C, D
    out["stages"], out["rt_ms"], out["rtf"] = stages, rt, 64 * 3.0 / (rt / 1e3)
    out["idle"], out["profile"] = idle, kernel_lines(split, 8)
    out["resolution"] = resolution_check(K, q["embed"][0], q["esq"][0], q["pack"][0], N)

    # EnCodec 48 kHz, stereo, B=2 x 3.5 s: four 1 s segments, the last ragged.
    cfg48 = E.encodec_model_48khz_config()
    p48 = init_encodec(cfg48, seed=0)
    gpu48 = encodec_from_jax_params(p48, cfg48, "cuda")
    cpu48 = encodec_from_jax_params(p48, cfg48, "cpu")
    x48 = torch.as_tensor((rng.normal(size=(2, 2, int(3.5 * cfg48.sample_rate))) * 0.1)
                          .astype(np.float32))
    K.reset_launch_counts()
    fr48 = E.encode(gpu48, cfg48, x48.cuda())
    torch.cuda.synchronize()
    seg = [int(c.shape[-1]) for c, _ in fr48]
    v48 = K.vq_nearest.launches
    check(len(fr48) == 4 and v48 == 16 * len(fr48),
          f"encodec 48k: {len(fr48)} segments, {v48} vq_nearest launches")
    fr48_cpu = E.encode(cpu48, cfg48, x48)
    per_seg = []
    for (c, s_), (cc, sc) in zip(fr48, fr48_cpu):
        d = (c.cpu() != cc).sum(dim=(0, 2)).tolist()
        check(d[0] <= max_flips(c[:, 0].numel()), f"encodec 48k layer-0 codes vs CPU: {d}")
        check(rel_max(s_.cpu(), sc) <= 1e-5, "encodec 48k segment scales differ")
        per_seg.append(sum(d))
    w48 = E.decode(gpu48, cfg48, fr48)[:, :, :x48.shape[-1]]
    w48_cpu = E.decode(cpu48, cfg48, [(c.cpu(), s_.cpu()) for c, s_ in fr48])[:, :, :x48.shape[-1]]
    torch.cuda.synchronize()
    check(tuple(w48.shape) == tuple(x48.shape) and bool(torch.isfinite(w48).all()),
          f"encodec 48k waveform shape {tuple(w48.shape)} or non-finite values")
    out["w48_rel"] = rel_max(w48.cpu(), w48_cpu)
    check(out["w48_rel"] <= 1e-3, f"encodec 48k waveform card vs CPU rel-max {out['w48_rel']:.3g}")
    out["seg_frames"], out["seg_cpu_flips"], out["v48"] = seg, per_seg, v48
    with torch.inference_mode():
        out["rt48_ms"] = cuda_ms(lambda: E.forward(gpu48, cfg48, x48.cuda()), 3)
    return out


def facade_phase(model, cpu, spec, K) -> dict:
    """Phase 10: small-320's training-style encode, copy synthesis and
    SEANet-only decode through the WavTokenizer facade."""
    from wavtokenizer_tpu_torch.utils.golden import golden_clip

    out = {}
    clip = golden_clip(spec)
    feats_i, codes_i = model.encode_infer(clip)
    K.reset_launch_counts()
    feats_f, codes_f = model.encode(clip)
    torch.cuda.synchronize()
    out["encode_launches"] = launch_counts(K)
    check(out["encode_launches"] == {"vq_nearest": 1, "convnext_block": 0, "encoder_front": 1},
          f"encode launches {out['encode_launches']}")
    out["encode_diff"] = int((codes_f != codes_i).sum())
    check(out["encode_diff"] == 0 and bool(torch.equal(feats_f, feats_i)),
          f"encode vs encode_infer: {out['encode_diff']} codes differ")
    K.reset_launch_counts()
    wave = model(clip, 0)
    torch.cuda.synchronize()
    out["call_launches"] = launch_counts(K)
    n_blocks = spec.backbone.num_layers
    check(out["call_launches"] == {"vq_nearest": 1, "convnext_block": n_blocks,
                                   "encoder_front": 1},
          f"__call__ launches {out['call_launches']}")
    out["call_rel"] = rel_max(wave, model.decode(feats_i, 0))
    check(out["call_rel"] <= SAME_CARD_WAVE_TOL, f"__call__ rel-max {out['call_rel']:.3g}")
    sd = model.seanet_only_decode(feats_i)
    sd_cpu = cpu.seanet_only_decode(feats_i.cpu())
    torch.cuda.synchronize()
    check(tuple(sd.shape) == clip.shape and bool(torch.isfinite(sd).all()),
          f"seanet_only_decode shape {tuple(sd.shape)}")
    out["sod_rel"] = rel_max(sd.cpu(), sd_cpu)
    check(out["sod_rel"] <= 1e-3, f"seanet_only_decode card vs CPU rel-max {out['sod_rel']:.3g}")
    feats = torch.randn(TIMING_BATCH, spec.vq.dimension,
                        int(TIMING_SECONDS * spec.sample_rate) // spec.hop_length,
                        generator=torch.Generator().manual_seed(10)).cuda() * 0.05
    out["sod_ms"] = cuda_ms(lambda: model.seanet_only_decode(feats), 3)
    return out


def compress_phase(model, spec) -> dict:
    """Phase 11: tools/compress.py on the random small-320 model, run as a
    subprocess on the card, encode then decode, with the LM and --no-lm;
    the container's ids decoded again in this process against a direct
    encode of the same clip."""
    import os
    import struct
    import tempfile

    from scipy.io import wavfile

    from wavtokenizer_tpu_torch.models.lm import (LMConfig, StreamingTransformerConfig,
                                                  init_lm, lm_params_to)
    from wavtokenizer_tpu_torch.ops.entropy import compress_codes, decompress_codes
    from wavtokenizer_tpu_torch.tools import compress

    root = os.path.dirname(os.path.abspath(__file__))
    sr = spec.sample_rate
    y = (np.random.default_rng(11).normal(size=3 * sr) * 0.1).clip(-1, 1)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        wav = os.path.join(d, "in.wav")
        wavfile.write(wav, sr, (y * 32767).astype(np.int16))
        pcm = wavfile.read(wav)[1].astype(np.float32) / 32768.0
        want = model.encode_infer(pcm[None])[1][:, 0].cpu().numpy()       # (1, T)
        # The CLI's process decodes at PyTorch's default precision (cuDNN
        # TF32 on; this script turned it off): decode the same way here.
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            want_wav = model.decode(model.codes_to_features(torch.as_tensor(want)[:, None]), 0)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        want_wav = (np.clip(want_wav[0].cpu().numpy()[:len(pcm)], -1, 1) * 32767
                    ).astype(np.int16)
        for name, extra in (("lm", []), ("no-lm", ["--no-lm"])):
            wtc, rec = os.path.join(d, f"{name}.wtc"), os.path.join(d, f"{name}.wav")
            times = []
            for argv in (["encode", wav, wtc] + extra, ["decode", wtc, rec]):
                t0 = time.perf_counter()
                res = subprocess.run([sys.executable, "-m", "wavtokenizer_tpu_torch.tools.compress",
                                      *argv], cwd=root, capture_output=True, text=True,
                                     timeout=600)
                times.append(time.perf_counter() - t0)
                check(res.returncode == 0, f"compress {argv[0]} {name} failed:\n{res.stderr}")
            with open(wtc, "rb") as f:
                data = f.read()
            mode, k, t, n = struct.unpack("<BHII", data[4:15])
            check(data[:4] == b"WTC1" and (k, t, n) == (*want.shape, len(pcm)),
                  f"compress {name}: header {(mode, k, t, n)}")
            if mode == 0:
                ids = compress._unpack_fixed(data[15:], spec.vq.bins, k * t).reshape(k, t)
            else:
                lm_cfg = LMConfig(n_q=spec.vq.n_q, card=spec.vq.bins,
                                  transformer=StreamingTransformerConfig(dim=200))
                lm = lm_params_to(init_lm(lm_cfg, seed=0), "cuda")
                ids = decompress_codes(lm, lm_cfg, data[15:], k, t)
                t0 = time.perf_counter()
                compress_codes(lm, lm_cfg, want)
                out["lm_compress_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                decompress_codes(lm, lm_cfg, data[15:], k, t)
                out["lm_decompress_s"] = time.perf_counter() - t0
            diff = int((ids != want).sum())
            check(diff == 0, f"compress {name}: {diff} of {want.size} ids differ after the round trip")
            lsb = int(np.abs(wavfile.read(rec)[1].astype(np.int32) - want_wav).max())
            rel = lsb / max(1, int(np.abs(want_wav).max()))
            check(rel < SAME_CARD_WAVE_TOL,
                  f"compress {name}: decoded audio {lsb} LSB ({rel:.3g} of max) from a direct decode")
            out[name] = {"bytes": len(data) - 15, "bits_per_token": (len(data) - 15) * 8 / want.size,
                         "encode_s": times[0], "decode_s": times[1], "lsb": lsb, "rel": rel}
    out["tokens"] = int(want.size)
    return out


TRAIN_CONFIG = "configs/wavtokenizer_small_320_24k_4096.yaml"


def rel_err(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def train_card_vs_cpu(K) -> dict:
    """Phase 12 (a): one training step of small-320 at full generator width
    (discriminators at 1/8, 2 x 1 s, no dropout, bandwidth 1) on the card
    and on the CPU from one state, the first step's k-means drawing its
    sample indices from CPU generators of one seed.  TF32 is off for the
    whole process, so both sides run fp32."""
    from wavtokenizer_tpu_torch import WavTokenizerSpec
    from wavtokenizer_tpu_torch.models.seanet import seanet_encode
    from wavtokenizer_tpu_torch.train.step import TrainConfig, create_train_state, train_step
    from wavtokenizer_tpu_torch.train.vq_train import kmeans
    from wavtokenizer_tpu_torch.train.wnorm import fold_tree

    spec = WavTokenizerSpec()
    tcfg = TrainConfig(disc_channels_scale=0.125, pos_dropout=0.0)
    audio = torch.as_tensor((np.random.default_rng(12).normal(size=(2, 24000)) * 0.1)
                            .astype(np.float32))
    states = {dev: create_train_state(spec, tcfg, seed=0, device=dev) for dev in ("cpu", "cuda")}
    out = {}
    # k-means of the first step, replayed on both devices from one draw.
    with torch.no_grad():
        emb = {dev: seanet_encode(fold_tree(st["gen"]["encoder"]), spec.seanet,
                                  audio.to(dev)[:, :, None], front=False).reshape(-1, 512)
               for dev, st in states.items()}
        km = {dev: kmeans(x, spec.vq.bins, spec.vq.kmeans_iters, torch.Generator().manual_seed(5))
              for dev, x in emb.items()}
    torch.cuda.synchronize()
    codes_card, codes_cpu = km["cuda"][2].cpu().int(), km["cpu"][2].int()
    out["kmeans_rows"] = int(codes_cpu.numel())
    out["kmeans_flips"] = int((codes_card != codes_cpu).sum())
    out["kmeans_gap"] = vq_distance_gap(emb["cpu"], km["cpu"][0], codes_card, codes_cpu)
    out["kmeans_means_rel"] = rel_max(km["cuda"][0].cpu(), km["cpu"][0])
    metrics = {}
    for dev, st in states.items():
        K.reset_launch_counts()
        _, m = train_step(st, audio.to(dev), spec, tcfg, torch.Generator().manual_seed(0),
                          with_grad_norm=True, bandwidth_id=1)
        if dev == "cuda":
            torch.cuda.synchronize()
            out["launches"] = K.vq_nearest.launches
            out["seg_launches"] = K.segment_sum.launches
        metrics[dev] = {k: float(v) for k, v in m.items()}
    rels = {k: rel_err(metrics["cuda"][k], v) for k, v in metrics["cpu"].items()}
    out["loss_rel"] = max(v for k, v in rels.items() if k != "grad_norm")
    out["worst"] = max((k for k in rels if k != "grad_norm"), key=rels.get)
    out["grad_norm_rel"] = rels["grad_norm"]
    out["vq_rel"] = max(rel_max(states["cuda"]["vq"][k].cpu(), states["cpu"]["vq"][k])
                        for k in ("embed", "embed_avg", "cluster_size"))
    out["metrics"] = metrics["cuda"]
    out["kmeans_iters"] = spec.vq.kmeans_iters
    check(all(np.isfinite(v) for v in metrics["cuda"].values()), f"non-finite losses {metrics}")
    check(out["launches"] == spec.vq.kmeans_iters + 2,
          f"first training step launched vq_nearest {out['launches']} times, expected "
          f"{spec.vq.kmeans_iters + 2}")
    check(out["seg_launches"] == spec.vq.kmeans_iters + 2,
          f"first training step launched segment_sum {out['seg_launches']} times, expected "
          f"{spec.vq.kmeans_iters + 2}")
    check(out["loss_rel"] <= 1e-3,
          f"train step card vs CPU: {out['worst']} rel {out['loss_rel']:.3g}")
    check(out["grad_norm_rel"] <= 1e-3,
          f"train step card vs CPU grad norm rel {out['grad_norm_rel']:.3g}")
    check(out["vq_rel"] <= 1e-4, f"train step card vs CPU VQ state rel {out['vq_rel']:.3g}")
    return out


def off_float64_nearest(x: torch.Tensor, embed: torch.Tensor, picks: dict) -> dict:
    """For each version's ids (N,), the number of rows whose code lies
    farther than the float64 nearest one.  The float64 search runs on rows
    and codes centred by the rows' mean (the same distances, without the
    offset that fp32 cannot resolve); each chosen code's distance is then
    summed directly, so an exact copy of the nearest code ties it."""
    with torch.no_grad():
        mu = x.double().mean(0)
        xc, ec = x.double() - mu, embed.double() - mu
        d = (xc * xc).sum(1, keepdim=True) - 2.0 * xc @ ec.T + (ec * ec).sum(1)[None]
        best = d.argmin(1)
        dist = lambda ids: ((xc - ec[ids.long()]) ** 2).sum(1)
        nearest = dist(best)
        return {k: int((dist(v) > nearest).sum()) for k, v in picks.items()}


def _segment_ids_summary(first: list, later: list, iters: int) -> tuple:
    """The ids the training path gives ``segment_sum``, from the (ids,
    counts) of each call of the first step (``iters`` k-means iterations,
    then the EMA in both phases) and of a later step (the EMA twice): the
    largest count on one code and the codes in use, per call; and two of
    those ids for [18]: the k-means iteration of median largest count, and
    the later step's last EMA call."""
    check(all(c is not None for _, c in first + later), "segment_sum called without counts")
    counts = torch.stack([c for _, c in first + later]).cpu()
    mx, used = counts.max(1).values.tolist(), (counts > 0).sum(1).tolist()
    pairs = list(zip(mx, used))
    km = pairs[:iters]
    med = sorted(range(iters), key=lambda j: (mx[j], j))[iters // 2]
    spread = lambda v: (min(v), sorted(v)[len(v) // 2], max(v))
    summary = {"k-means": {"first": km[0], "last": km[-1], "median_iter": med + 1,
                           "median": km[med], "max_count": spread([a for a, _ in km]),
                           "codes_used": spread([b for _, b in km])},
               "EMA first step": pairs[iters:len(first)], "EMA later step": pairs[len(first):]}
    return summary, {"k-means": first[med][0].cpu(), "EMA": later[-1][0].cpu()}


def train_timing(K) -> dict:
    """Phase 12 (b) and (c): the spec and TrainConfig of the small-320 YAML
    (k-means 200 iterations), the discriminators at full width, batch 40 x
    3 s of seeded noise; the VQ kernel at k-means' shapes on this batch's
    encoder output; then the step timed."""
    import os

    import yaml

    from wavtokenizer_tpu_torch.models.seanet import seanet_encode
    from wavtokenizer_tpu_torch.train import vq_train
    from wavtokenizer_tpu_torch.train.step import (create_train_state, discriminator_phase,
                                                   generator_phase, train_step)
    from wavtokenizer_tpu_torch.train.trainer import step_generator, train_config_from_yaml
    from wavtokenizer_tpu_torch.train.wnorm import fold_tree
    from wavtokenizer_tpu_torch.utils.profiling import vq_bound_of

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, TRAIN_CONFIG)) as f:
        spec, tcfg, data, _ = train_config_from_yaml(yaml.safe_load(f))
    out = {"B": data.batch_size, "T": data.num_samples}
    state = create_train_state(spec, tcfg, seed=0, device="cuda")
    audio = torch.as_tensor((np.random.default_rng(14).normal(size=(out["B"], out["T"])) * 0.1)
                            .astype(np.float32)).cuda()

    # (b) k-means' search: this batch's encoder output against means drawn
    # with replacement (duplicates: exact ties), the pack made per call.
    # The random encoder's rows lie within ~1e-7 (squared) of each other on
    # a common offset whose |x|^2 is far larger, so no fp32 evaluation of
    # |x|^2 - 2 x.e + |e|^2 (the plain version's or the kernel's) can tell a
    # row's own copy from its neighbours': the rows are centred first (the
    # distances stay, the offset's rounding goes), as the port's tests do.
    # The uncentred rows, which the main path's k-means searches, are held
    # to float64 instead: the kernel may pick a code other than the float64
    # nearest on no more rows than the plain version does.
    with torch.no_grad():
        raw = seanet_encode(fold_tree(state["gen"]["encoder"]), spec.seanet, audio[:, :, None],
                            front=False).reshape(-1, spec.vq.dimension).contiguous()
        x = (raw - raw.mean(0)).contiguous()
    N, D, C = x.shape[0], x.shape[1], spec.vq.bins
    idx = torch.randint(0, N, (C,), generator=torch.Generator().manual_seed(13))
    raw_means = raw[idx.cuda()]
    wrong = off_float64_nearest(raw, raw_means, {
        "kernel": K.vq_nearest(raw, raw_means),
        "plain": K.vq_nearest_reference(raw, raw_means)})
    out["raw_wrong"] = wrong
    check(wrong["kernel"] <= wrong["plain"],
          f"vq_nearest on the uncentred k-means rows: {wrong['kernel']} rows off the float64 "
          f"nearest code, the plain version {wrong['plain']}")
    del raw, raw_means
    means = x[idx.cuda()]
    got = K.vq_nearest(x, means)
    want = K.vq_nearest_reference(x, means)
    torch.cuda.synchronize()
    out["vq_flips"] = int((got != want).sum())
    out["vq_gap"] = vq_distance_gap(x, means, got, want)
    first = {}
    for j, i in enumerate(idx.tolist()):
        first.setdefault(i, j)
    rows = torch.tensor(sorted(first))
    lowest = torch.tensor([first[i] for i in rows.tolist()], dtype=torch.int32)
    out["dup_rows"] = int(rows.numel())
    out["dup_not_lowest"] = int((got.cpu()[rows] != lowest).sum())
    check(torch.equal(got.cpu()[rows], want.cpu()[rows]),
          "vq_nearest: rows with exact copies among the means differ from the plain search")
    out["vq_ms"] = cuda_ms(lambda: K.vq_nearest(x, means), 20)
    out["vq_plain_ms"] = cuda_ms(lambda: K.vq_nearest_reference(x, means), 20)
    out["vq_bound_ms"], out["vq_bound_by"] = vq_bound_of(N, C, D)
    out["N"], out["C"], out["D"] = N, C, D
    del x, means, got, want

    # (c) the step.  The segment sums' ids and counts of the first step and
    # of the first timed later step are kept by reference (nothing is read
    # back or launched for them while the steps run) and summarised after.
    seg_calls, real_sum = [], vq_train.segment_sum

    def recorded_sum(rows, ids, num_segments, counts=None):
        seg_calls.append((ids, counts))
        return real_sum(rows, ids, num_segments, counts)

    vq_train.segment_sum = recorded_sum
    try:
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = train_step(state, audio, spec, tcfg, step_generator(0, 0))
        torch.cuda.synchronize()
        out["first_ms"] = (time.perf_counter() - t0) * 1e3
        out["launches_first"] = K.vq_nearest.launches
        out["seg_launches_first"] = K.segment_sum.launches
        out["first_metrics"] = {k: float(v) for k, v in m.items()}
        first_calls = len(seg_calls)
        train_step(state, audio, spec, tcfg, step_generator(0, 1))       # warm-up
        warm_calls = len(seg_calls)
        times, launches, seg = [], [], []
        for step in (2, 3, 4):
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = train_step(state, audio, spec, tcfg, step_generator(0, step))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches.append(K.vq_nearest.launches)
            seg.append(K.segment_sum.launches)
            check(all(bool(torch.isfinite(v)) for v in m.values()),
                  f"non-finite losses at step {step}")
            if step == 2:
                vq_train.segment_sum = real_sum
    finally:
        vq_train.segment_sum = real_sum
    out["step_ms"], out["launches_per_step"], out["seg_launches_per_step"] = times, launches, seg
    out["seg_ids"], out["seg_real_ids"] = _segment_ids_summary(
        seg_calls[:first_calls], seg_calls[warm_calls:], spec.vq.kmeans_iters)
    del seg_calls
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["metrics"] = {k: float(v) for k, v in m.items()}
    # The two phases of one more step, each timed alone (no dropout).
    g = step_generator(0, 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vq, _ = discriminator_phase(state, audio, spec, tcfg, 0, 1, g)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    generator_phase(state, vq, audio, spec, tcfg, 0, 1, g)
    torch.cuda.synchronize()
    out["disc_ms"], out["gen_ms"] = (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3
    split, out["idle"] = traced(lambda: train_step(state, audio, spec, tcfg, step_generator(0, 6)))
    out["busy_ms"] = sum(ms for ms, _ in split.values())
    out["ops"] = sum(n for _, n in split.values())
    out["profile"] = kernel_lines(split, 10)
    out["kmeans_iters"] = spec.vq.kmeans_iters
    check(out["launches_first"] == spec.vq.kmeans_iters + 2,
          f"first step launched vq_nearest {out['launches_first']} times, expected "
          f"{spec.vq.kmeans_iters + 2}")
    check(launches == [2, 2, 2], f"vq_nearest launches per later step {launches}, expected 2")
    # segment_sum: one per k-means iteration and one per EMA forward (both phases).
    check(out["seg_launches_first"] == spec.vq.kmeans_iters + 2,
          f"first step launched segment_sum {out['seg_launches_first']} times, expected "
          f"{spec.vq.kmeans_iters + 2}")
    check(seg == [2, 2, 2], f"segment_sum launches per later step {seg}, expected 2")
    check(all(np.isfinite(v) for v in out["first_metrics"].values()),
          "non-finite first-step losses")
    return out


def _state_leaves(tree, path: str = "") -> list:
    """(path, leaf) of every tensor and number of a tree, in key order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree, key=str) for kv in _state_leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _state_leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def _trees_equal(a, b) -> tuple:
    """(whether two trees of tensors and numbers are equal bit for bit, the
    number of leaves compared, the first paths of the leaves that differ)."""
    la, lb = _state_leaves(a), _state_leaves(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False, len(la), ["the trees' keys differ"]
    differ = [p for (p, x), (_, y) in zip(la, lb)
              if not (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)]
    return not differ, len(la), differ[:5]


def _checkpoints_equal(a: str, b: str) -> tuple:
    """``_trees_equal`` of two checkpoint files."""
    return _trees_equal(*(torch.load(p, map_location="cpu", weights_only=True) for p in (a, b)))


def train_cli_phase(spec) -> dict:
    """Phase 12 (d): ``tools.train fit`` as a subprocess on 8 WAVs of 3.5 s
    (batch 8) with the small-320 YAML, at PyTorch's default precision (cuDNN
    TF32 on): 3 batches, the same again from the same seed, and 2 batches
    resumed to 3 with ``--resume`` (the first three at once, then the
    resume).  The repeat's and the resumed run's ``last.pt`` must equal the
    first's bit for bit (every tensor of gen, disc, vq, decoder, both
    optimizers' moments, step).  The first run's checkpoint through
    ``from_train_checkpoint``, and its Lightning export through
    ``from_pretrained0828`` against the same model on the CPU."""
    import json as _json
    import os
    import tempfile

    import yaml
    from scipy.io import wavfile

    from wavtokenizer_tpu_torch import WavTokenizer
    from wavtokenizer_tpu_torch.checkpoint.export import (export_training_state_dict,
                                                          save_torch_checkpoint)
    from wavtokenizer_tpu_torch.utils.golden import golden_clip, max_flips

    root = os.path.dirname(os.path.abspath(__file__))
    sr = spec.sample_rate
    out = {}
    with tempfile.TemporaryDirectory() as d:
        rng = np.random.default_rng(15)
        files = []
        for i in range(8):
            t = np.arange(int(3.5 * sr)) / sr
            y = 0.3 * np.sin(2 * np.pi * (180 + 45 * i) * t) + 0.05 * rng.normal(size=t.size)
            files.append(os.path.join(d, f"clip{i}.wav"))
            wavfile.write(files[-1], sr, (np.clip(y, -1, 1) * 32767).astype(np.int16))
        filelist = os.path.join(d, "files.txt")
        with open(filelist, "w") as f:
            f.write("\n".join(files) + "\n")
        with open(os.path.join(root, TRAIN_CONFIG)) as f:
            cfg = yaml.safe_load(f)
        for part in ("train_params", "val_params"):
            cfg["data"]["init_args"][part].update(filelist_path=filelist, batch_size=8)
        cfg_path = os.path.join(d, "train.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)

        def fit(runs: dict) -> float:
            """{directory name: extra arguments}, all started together."""
            t0 = time.perf_counter()
            procs = {name: subprocess.Popen(
                [sys.executable, "-m", "wavtokenizer_tpu_torch.tools.train", "fit", "--config",
                 cfg_path, "--out-dir", os.path.join(d, name), *args], cwd=root,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for name, args in runs.items()}
            results = {}
            try:
                for name, proc in procs.items():
                    results[name] = proc.communicate(timeout=900)[1], proc.returncode
            finally:
                for proc in procs.values():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            for name, (err, rc) in results.items():
                check(rc == 0, f"tools.train fit ({name}) failed:\n{err[-3000:]}")
            return time.perf_counter() - t0

        out["cli_s"] = [fit({"run": ["--max-batches", "3"], "repeat": ["--max-batches", "3"],
                             "two": ["--max-batches", "2"]}),
                        fit({"resumed": ["--max-batches", "3", "--resume",
                                         os.path.join(d, "two", "last.pt")]})]
        run = os.path.join(d, "run")
        for name in ("repeat", "resumed"):
            same, n, differ = _checkpoints_equal(os.path.join(run, "last.pt"),
                                                 os.path.join(d, name, "last.pt"))
            out[name] = {"equal": same, "leaves": n, "differ": differ}
            check(same, f"tools.train fit: the {name} run's last.pt differs from the first run's "
                        f"in {differ}")
        with open(os.path.join(d, "resumed", "metrics.jsonl")) as f:
            events = [_json.loads(line) for line in f]
        out["loader"] = [e["event"] for e in events if e.get("event", "").startswith("native")]
        check(any(e.get("event") == "resume" and e.get("step") == 2 for e in events),
              f"the resumed run did not resume at step 2: {events[:3]}")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            rows = [_json.loads(line) for line in f]
        steps = [r for r in rows if "gen_total" in r]
        check(bool(steps) and steps[0]["step"] == 0
              and all(np.isfinite(v) for v in steps[0].values()), f"metrics.jsonl rows {rows}")
        out["rows"], out["row0"] = len(rows), steps[0]
        ckpt_path = os.path.join(run, "last.pt")
        out["ckpt_gb"] = os.path.getsize(ckpt_path) / 1e9
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        check(ckpt["step"] == 3, f"checkpoint at step {ckpt['step']}, expected 3")
        trained = WavTokenizer.from_train_checkpoint(cfg_path, ckpt_path)
        lightning = os.path.join(d, "export.ckpt")
        save_torch_checkpoint(lightning, export_training_state_dict(ckpt, spec))
        del ckpt
        card = WavTokenizer.from_pretrained0828(cfg_path, lightning)
        cpu = WavTokenizer.from_pretrained0828(cfg_path, lightning, device="cpu")
        clip = golden_clip(spec)
        feats, codes = card.encode_infer(clip)
        wave = card.decode(feats, 0)
        codes_trained = trained.encode_infer(clip)[1]
        codes_cpu = cpu.encode_infer(clip)[1]
        torch.cuda.synchronize()
        check(tuple(wave.shape) == clip.shape and bool(torch.isfinite(wave).all()),
              f"exported model's waveform shape {tuple(wave.shape)} or non-finite values")
        out["n_ids"] = codes.numel()
        out["distinct"] = int(codes.unique().numel())
        out["trained_vs_0828"] = int((codes_trained != codes).sum())
        out["card_vs_cpu"] = int((codes.cpu() != codes_cpu).sum())
        check(out["trained_vs_0828"] <= max_flips(out["n_ids"]),
              f"from_train_checkpoint vs from_pretrained0828: {out['trained_vs_0828']} ids differ")
        check(out["card_vs_cpu"] <= max_flips(out["n_ids"]),
              f"exported model card vs CPU codes: {out['card_vs_cpu']} differ")
        check(len(card.discriminators["dac_mrd"]) == 3, "exported discriminators missing")
    return out


VOCOS_CONFIG = "wavtokenizer_tpu_torch/configs/vocos_mel_24khz.yaml"
# Vocos waveform, card against CPU on the same features: the sound runs read
# 5.98e-05 (bf16 ConvNeXt operands summed in other orders); cuFFT's C2R fed
# the DC and Nyquist imaginary parts read 3.4e-2.
VOCOS_WAVE_TOL = 1e-3


def vocos_phase(K) -> dict:
    """Phase 13: the plain-Vocos family at the vocos-mel-24khz width through
    the ``Vocos`` facade: the ConvNeXt trunk (8 blocks, each one
    convnext_block launch at C = 512, I = 1536) card against CPU, then timed
    at B = 128 x 3 s; the ResNet trunk with both IMDCT heads card against
    CPU."""
    from wavtokenizer_tpu_torch import Vocos, init_vocos
    from wavtokenizer_tpu_torch.api.config import vocos_spec_from_config
    from wavtokenizer_tpu_torch.models import vocos, vocos_model
    from wavtokenizer_tpu_torch.models.alt_components import (IMDCTHeadConfig,
                                                              VocosResNetBackboneConfig)
    from wavtokenizer_tpu_torch.utils.profiling import convnext_bound

    spec = vocos_spec_from_config(VOCOS_CONFIG)
    params = init_vocos(spec, seed=0)
    card = Vocos.from_jax_params(params, spec, device="cuda")
    cpu = Vocos.from_jax_params(params, spec, device="cpu")
    sr, n_blocks = spec.sample_rate, spec.backbone.num_layers
    out = {}

    # (a) B = 8 x 3 s, the facade's forward with the counts read around it;
    # both devices then decode the card's features, so the waveform check
    # isolates the decoder (the same bf16-operand arithmetic in another
    # order, as in [5]).
    audio = (np.random.default_rng(13).normal(size=(8, int(3 * sr))) * 0.1).astype(np.float32)
    K.reset_launch_counts()
    wave = card(audio)
    torch.cuda.synchronize()
    out["launches"] = launch_counts(K)
    check(out["launches"] == {"vq_nearest": 0, "convnext_block": n_blocks, "encoder_front": 0},
          f"vocos forward launches {out['launches']}")
    feats = card.feature_extractor(audio)
    feats_cpu = cpu.feature_extractor(audio)
    out["feat_rel"] = rel_max(feats.cpu(), feats_cpu)
    check(out["feat_rel"] < 1e-4, f"vocos features card vs CPU rel-max {out['feat_rel']:.3g}")
    want = cpu.decode(feats.cpu())
    check(tuple(wave.shape) == tuple(want.shape) and bool(torch.isfinite(wave).all()),
          f"vocos waveform shape {tuple(wave.shape)} or non-finite values")
    out["wave_rel"] = rel_max(card.decode(feats).cpu(), want)
    check(out["wave_rel"] <= VOCOS_WAVE_TOL,
          f"vocos card vs CPU waveform rel-max {out['wave_rel']:.3g}")

    # The ConvNeXt kernel on this path's own block input, against its plain
    # version (scale/shift are the block's plain LayerNorm weight and bias).
    p = card.params["backbone"]
    with torch.inference_mode():
        x0 = feats.transpose(1, 2).contiguous()
        blk = p["convnext"][0]
        pre = vocos.backbone_stem(p, spec.backbone, x0).contiguous()
        bargs = (pre, blk["dw"], blk["dwb"], blk["norm"]["weight"], blk["norm"]["bias"],
                 blk["w1"], blk["b1"], blk["w2"], blk["b2"], blk["gamma"], blk["w1t"], blk["w2t"])

        def block_check(x: torch.Tensor, tag: str) -> tuple:
            """The block on ``x`` against its plain version: max abs err,
            that error over the largest update max |ref - x|, and the args."""
            args = (x,) + bargs[1:]
            got = K.convnext_block(*args)
            ref = K.convnext_block_reference(*args[:10])
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            rel = err / float((ref - x).abs().max())
            check(rel < 1e-2, f"convnext_block at vocos width, {tag}: rel err {rel:.3g}")
            return err, rel, args

        out["cnx_err"], out["cnx_rel_update"], _ = block_check(pre, "B=8")

        # (b) B = 128 x 3 s: the decode's first 8 clips against the CPU and
        # the kernel on this batch's own first-block input, then RTF, the
        # stages and the kernel against its bound.
        audio_t = torch.as_tensor(np.random.default_rng(14).normal(
            size=(TIMING_BATCH, int(TIMING_SECONDS * sr))).astype(np.float32) * 0.1).cuda()
        ft = card.feature_extractor(audio_t)
        K.reset_launch_counts()
        wave_t = card.decode(ft)
        torch.cuda.synchronize()
        check(K.convnext_block.launches == n_blocks,
              f"vocos decode at B={TIMING_BATCH}: {K.convnext_block.launches} launches")
        out["wave_rel_t"] = rel_max(wave_t[:8].cpu(), cpu.decode(ft[:8].cpu()))
        check(out["wave_rel_t"] <= VOCOS_WAVE_TOL,
              f"vocos B={TIMING_BATCH} decode, clips 0-7 card vs CPU waveform rel-max "
              f"{out['wave_rel_t']:.3g}")
        xt = ft.transpose(1, 2)
        out["cnx_err_t"], out["cnx_rel_update_t"], targs = block_check(
            vocos.backbone_stem(p, spec.backbone, xt.contiguous()).contiguous(),
            f"B={TIMING_BATCH}")
        ht = vocos.vocos_backbone(p, spec.backbone, xt)
        out["stages"] = {
            "features": cuda_ms(lambda: vocos_model.vocos_features(card.params, spec, audio_t), 10),
            "backbone": cuda_ms(lambda: vocos.vocos_backbone(p, spec.backbone, xt), 5),
            "head": cuda_ms(lambda: vocos.istft_head(card.params["head"], spec.head, ht), 10),
        }
        out["rt_ms"] = cuda_ms(lambda: card(audio_t), 5)
        out["rtf"] = TIMING_BATCH * TIMING_SECONDS / (out["rt_ms"] / 1e3)
        M, C, I = TIMING_BATCH * ft.shape[-1], blk["w1"].shape[0], blk["w1"].shape[1]
        out["ms"] = cuda_ms(lambda: K.convnext_block(*targs), 20)
        out["plain_ms"] = cuda_ms(lambda: K.convnext_block_reference(*targs[:10]), 20)
        out["bound_ms"], out["bound_by"] = convnext_bound(M, C, I)
        hb = torch.randn(M, C, generator=torch.Generator().manual_seed(16)).to("cuda",
                                                                                torch.bfloat16)
        gb = torch.randn(M, I, generator=torch.Generator().manual_seed(17)).to("cuda",
                                                                                torch.bfloat16)
        out["gemm_ms"] = cuda_ms(lambda: (hb @ blk["w1"], gb @ blk["w2"]), 20)
        out.update(M=M, C=C, I=I)
        split, out["idle"] = traced(lambda: card(audio_t))
        out["profile"] = kernel_lines(split, 8)
        out["busy_ms"] = sum(ms for ms, _ in split.values())

    # (c) the ResNet trunk with both IMDCT heads at dim 512, frame 512 (hop
    # 256, the features' hop): card against CPU, B = 2 x 3 s, fp32 on both.
    out["resnet"] = {}
    for head_kind in ("imdct_cos", "imdct_symexp"):
        rspec = vocos_model.VocosSpec(
            features=spec.features, backbone_kind="resnet",
            backbone=VocosResNetBackboneConfig(input_channels=100, dim=512, num_blocks=3),
            head_kind=head_kind, head=IMDCTHeadConfig(dim=512, mdct_frame_len=512))
        rp = init_vocos(rspec, seed=0)
        rc, rcpu = (Vocos.from_jax_params(rp, rspec, device=d) for d in ("cuda", "cpu"))
        K.reset_launch_counts()
        w = rc(audio[:2])
        torch.cuda.synchronize()
        check(launch_counts(K) == {"vq_nearest": 0, "convnext_block": 0, "encoder_front": 0},
              f"resnet vocos launched {launch_counts(K)}")
        rel = rel_max(w.cpu(), rcpu(audio[:2]))
        check(bool(torch.isfinite(w).all()) and rel <= 1e-3,
              f"resnet+{head_kind} card vs CPU rel-max {rel:.3g}")
        out["resnet"][head_kind] = rel
    return out


def _speech_like(sr: int, n: int, seed: int) -> np.ndarray:
    """A gliding harmonic series under a syllable-rate envelope, with a
    pause and a faint noise floor."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = 110.0 + 90.0 * (0.5 + 0.5 * np.sin(2 * np.pi * (0.5 + 0.1 * seed) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    y = sum((0.6 / k) * np.sin(k * phase) for k in range(1, 10))
    env = np.clip(np.sin(2 * np.pi * 3.0 * t), 0.0, None) ** 0.5
    env[(t > 0.55 * t[-1]) & (t < 0.7 * t[-1])] = 0.0
    return (0.3 * env * y + 0.003 * rng.normal(size=n)).astype(np.float32)


# [14]: CLI metrics on the card against the same CLI on the CPU.  The numpy
# metrics read the same files with the same code (equal); CREPE and UTMOS
# run in fp32 with TF32 off on both, in other summation orders.
METRICS_NUMPY = ("stoi", "pesq_wb", "snr_db", "mel_dist", "env_sim")
# A decoded CREPE bin that moves by one (20 cents) on one frame of a 2 s clip
# (~190 frames) moves the pitch RMSE by at most ~1.5 cents.
METRICS_LIMITS = {"utmos": ("rel", 1e-3), "periodicity_rmse": ("abs", 1e-4),
                  "voiced_f1": ("abs", 1e-3), "pitch_rmse_cents": ("abs", 2.0)}
# CREPE salience, card against CPU, over its input-dependent part: float32
# against float64 on the CPU reads ~2e-4 of it.
SALIENCE_TOL = 1e-2


def metrics_phase(model, spec, K) -> dict:
    """Phase 14: a small-320 round trip on the card writes 4 clips (2 s)
    and their references as WAVs; tools/metrics_infer.py runs on them as a
    subprocess with --device cuda and with --device cpu, CREPE full and
    UTMOS (12 layers) read from seeded random state dicts written here in
    the reference layouts; then, in this process, CREPE's salience card
    against CPU and the two nets' seconds per audio second on the card."""
    import os
    import tempfile

    from wavtokenizer_tpu_torch.metrics import crepe, utmos
    from wavtokenizer_tpu_torch.utils.audio import resample_np, save_pcm16

    root = os.path.dirname(os.path.abspath(__file__))
    sr, n = spec.sample_rate, 2 * spec.sample_rate
    audio = np.stack([_speech_like(sr, n, seed) for seed in range(4)])
    K.reset_launch_counts()
    wave = model.decode(model.codes_to_features(model.encode_infer(audio)[1]), 0)
    torch.cuda.synchronize()
    out = {"launches": launch_counts(K)}
    check(out["launches"] == {"vq_nearest": 1, "convnext_block": spec.backbone.num_layers,
                              "encoder_front": 1}, f"metrics round trip launches {out['launches']}")
    # Each decoded clip is written at its reference's RMS, so that the nets
    # score audio at a speaking level whatever the random decoder's gain.
    wave = wave.cpu().numpy().astype(np.float64)
    rms = lambda x: np.sqrt(np.mean(np.square(x), axis=-1))
    out["gain"] = rms(wave) / rms(audio)
    check(bool(np.isfinite(wave).all()) and bool((out["gain"] > 0).all()),
          f"metrics round trip: decoded RMS over the reference's {out['gain']}")
    wave = (wave / out["gain"][:, None]).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        for sub in ("gt", "pred"):
            os.makedirs(os.path.join(d, sub))
        for i in range(len(audio)):
            save_pcm16(os.path.join(d, "gt", f"clip{i}.wav"), audio[i], sr)
            save_pcm16(os.path.join(d, "pred", f"clip{i}.wav"), wave[i], sr)
        crepe_path, utmos_path = os.path.join(d, "crepe.pth"), os.path.join(d, "utmos.ckpt")
        torch.save({k: torch.from_numpy(v) for k, v in crepe.init_crepe_state_dict(0).items()},
                   crepe_path)
        usd = utmos.init_utmos_state_dict(0)
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in usd.items()}}, utmos_path)
        env = dict(os.environ, WT_CREPE_CKPT=crepe_path, WT_UTMOS_CKPT=utmos_path)
        results = {}
        for device in ("cuda", "cpu"):
            js = os.path.join(d, f"{device}.json")
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-m", "wavtokenizer_tpu_torch.tools.metrics_infer",
                                  "--gt-dir", os.path.join(d, "gt"), "--pred-dir",
                                  os.path.join(d, "pred"), "--out", js, "--device", device],
                                 cwd=root, env=env, capture_output=True, text=True, timeout=900)
            out[f"cli_{device}_s"] = time.perf_counter() - t0
            check(res.returncode == 0, f"metrics_infer --device {device} failed:\n{res.stderr}")
            with open(js) as f:
                results[device] = json.load(f)
        got, want = results["cuda"], results["cpu"]
        check(len(got["files"]) == len(want["files"]) == len(audio),
              f"metrics_infer: {len(got['files'])} / {len(want['files'])} files")
        worst = {}
        for g, w in zip(got["files"], want["files"]):
            for k in METRICS_NUMPY:
                check(g[k] == w[k] or (g[k] != g[k] and w[k] != w[k]),
                      f"metrics_infer {g['file']} {k}: card {g[k]} vs CPU {w[k]}")
            for k, (kind, lim) in METRICS_LIMITS.items():
                check(g[k] is not None and w[k] is not None and np.isfinite([g[k], w[k]]).all(),
                      f"metrics_infer {g['file']} {k}: card {g[k]}, CPU {w[k]}")
                err = abs(g[k] - w[k]) / (max(abs(w[k]), 1e-12) if kind == "rel" else 1.0)
                check(err <= lim,
                      f"metrics_infer {g['file']} {k}: card {g[k]} vs CPU {w[k]} ({kind} {lim})")
                worst[k] = max(worst.get(k, 0.0), err)
        out["summary"], out["worst"] = got["summary"], worst
        out["utmos_files"] = [(g["utmos"], w["utmos"]) for g, w in zip(got["files"],
                                                                      want["files"])]

        # Seconds per audio second of the two nets on the card, on the
        # predictions at 16 kHz (CREPE: framing, the net and the viterbi
        # decode; UTMOS: one batch of the 4 clips).
        deg16 = np.stack([resample_np(w, sr, 16000) for w in wave])
        audio_s = deg16.size / 16000
        cp = crepe.load_crepe(crepe_path, device="cuda")
        up = utmos.load_utmos(utmos_path, device="cuda")
        crepe.crepe_predict(cp, deg16[0])
        utmos.utmos_score_from_params(up, deg16)
        t0 = time.perf_counter()
        for x in deg16:
            crepe.crepe_predict(cp, x)
        out["crepe_s_per_s"] = (time.perf_counter() - t0) / audio_s
        frames = np.concatenate([crepe.frame_audio(x) for x in deg16])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sal = crepe.salience(cp, frames)
        out["crepe_net_s_per_s"] = (time.perf_counter() - t0) / audio_s
        # The random CREPE's salience is ~0.5 with a small input-dependent
        # part, and its decoded pitch and voicing barely move with the input:
        # the card's salience is held to the CPU's relative to that part
        # (the largest deviation from each bin's mean over the frames).
        want = crepe.salience(crepe.load_crepe(crepe_path, device="cpu"), frames)
        out["sal_err"] = float(np.abs(sal - want).max())
        out["sal_spread"] = float(np.abs(want - want.mean(axis=0)).max())
        check(out["sal_err"] <= SALIENCE_TOL * out["sal_spread"],
              f"CREPE salience card vs CPU max abs err {out['sal_err']:.3g} over the "
              f"input-dependent part {out['sal_spread']:.3g} (limit {SALIENCE_TOL})")
        t0 = time.perf_counter()
        utmos.utmos_score_from_params(up, deg16)
        out["utmos_s_per_s"] = (time.perf_counter() - t0) / audio_s
        out["audio_s"] = audio_s
    return out


# [15]: the research layer at small-320 width.  The enhancement batch of
# tools/enhance_train.py (8 x 3 s) and BYOL's (16 x 64 frames).
ENHANCE_B, ENHANCE_T = 8, 72000
ENHANCE_MODES = ("waveform", "feature", "hybrid", "byol")
# Card against CPU on enhanced_forward: fp32 on both sides (TF32 off).  The
# CPU's own enhanced features move by ~2e-5 of their max under a 1e-7
# relative change of the input when BatchNorm uses batch statistics (the
# random encoder's channels vary little around large offsets).
ENHANCE_FEATURE_TOL = 1e-4
ENHANCE_WAVE_TOL = 1e-3
RESAMPLE_RATES = (44100, 16000, 48000)


def _enhance_state(params_np, spec, mode: str, dev: str) -> dict:
    """A fresh enhancement state on ``dev`` from seed 0: the base model, the
    adapter and BN state, the in-path transformer in byol mode, and Adam."""
    from wavtokenizer_tpu_torch.checkpoint.convert import (adapter_from_jax,
                                                           inpath_transformer_from_jax)
    from wavtokenizer_tpu_torch.research import enhance as E
    from wavtokenizer_tpu_torch.research.adapter import (base_params_from_jax, init_adapter,
                                                         init_inpath_transformer)

    base = base_params_from_jax(params_np, spec.seanet, dev)
    ap, st = adapter_from_jax(*init_adapter(seed=0), dev)
    tr = (inpath_transformer_from_jax(init_inpath_transformer(seed=0), dev)
          if mode == "byol" else None)
    ecfg = E.EnhanceConfig(mode=mode)
    opt = E.make_enhance_optimizer(ap, base["decoder"], ecfg, tr)
    return {"base": base, "ap": ap, "st": st, "tr": tr, "ecfg": ecfg, "opt": opt}


def _enhance_step(s: dict, spec, noisy, clean) -> tuple:
    from wavtokenizer_tpu_torch.research import enhance as E
    s["st"], loss, g_norm = E.enhance_step(s["opt"], s["ap"], s["st"], s["base"]["decoder"],
                                           s["base"], noisy, clean, spec, s["ecfg"], s["tr"])
    return loss, g_norm


def research_phase(K) -> dict:
    """Phase 15: the research layer on the card at small-320 width, random
    weights from ``init_wavtokenizer(seed=0, random_codebook=True)`` and the
    research configs' defaults (adapter 512 -> 256 with two blocks; in-path
    transformer 512, 4 heads, 2 layers, FFN 2048; BYOL 512 -> 512, out 256,
    projection 128).

    (a) ``enhanced_forward`` at 8 x 72 000 (train False and True), card
    against CPU, one ``encoder_front`` launch each; the kernel against its
    plain version on this batch's audio, and timed at that shape.  (b) one
    ``enhance_step`` in each mode from one state (2 x 1 s), card against
    CPU; launches per step.  (c) the waveform-mode step at 8 x 3 s timed,
    with its profile, ``tools/enhance_infer.py``'s forward at that batch and
    one BYOL step at 16 x 64 frames.  (d) ``resample`` against the host
    ``resample_np`` at 16 x 10 s.  (e) the CLIs as subprocesses with
    ``--device cuda``: enhance_train -> enhance_infer, byol_train on encoder
    features -> enhance_train --mode byol --byol-ckpt, and lowpass.
    ``tools/speaker_cluster.py`` and ``tools/analyze_features.py`` need
    sklearn (k-means, t-SNE), which the card machine lacks: they are left
    out here; their device halves (``seanet_encode``, ``encode_infer`` and
    ``decode``) run in this phase and in [5]."""
    import os
    import tempfile

    from scipy.io import wavfile

    from wavtokenizer_tpu_torch import WavTokenizerSpec, init_wavtokenizer
    from wavtokenizer_tpu_torch.checkpoint.convert import adapter_from_jax, byol_from_jax
    from wavtokenizer_tpu_torch.models.seanet import encoder_layer_specs
    from wavtokenizer_tpu_torch.models.wavtokenizer import full_fp32, repeatable_steps
    from wavtokenizer_tpu_torch.ops.resample import resample
    from wavtokenizer_tpu_torch.research.adapter import (base_params_from_jax,
                                                         enhanced_forward, frozen_encode,
                                                         init_adapter)
    from wavtokenizer_tpu_torch.research.byol import BYOLConfig, init_byol
    from wavtokenizer_tpu_torch.tools.byol_train import byol_step
    from wavtokenizer_tpu_torch.tools.lowpass import energy_above
    from wavtokenizer_tpu_torch.train.step import tree_leaves
    from wavtokenizer_tpu_torch.utils.audio import read_audio, resample_np
    from wavtokenizer_tpu_torch.utils.profiling import front_bound_of

    spec = WavTokenizerSpec()
    sr = spec.sample_rate
    params_np = init_wavtokenizer(spec, seed=0, random_codebook=True)
    out = {"B": ENHANCE_B, "T": ENHANCE_T}
    rng = np.random.default_rng(20)
    speech = np.stack([_speech_like(sr, ENHANCE_T, 20 + i) for i in range(ENHANCE_B)])
    noisy_np = (speech + 0.05 * rng.normal(size=speech.shape)).astype(np.float32)
    clean_np = speech.astype(np.float32)

    # (a) the forward, card against CPU.
    devices = {"cpu": "cpu", "card": "cuda"}
    base = {k: base_params_from_jax(params_np, spec.seanet, dev) for k, dev in devices.items()}
    adapter_np = init_adapter(seed=0)
    out["fwd"] = {}
    for train in (False, True):
        res = {}
        for k, dev in devices.items():
            ap, st = adapter_from_jax(*adapter_np, dev)
            K.reset_launch_counts()
            with torch.no_grad():
                res[k] = enhanced_forward(base[k], spec.seanet, ap, st,
                                          torch.from_numpy(noisy_np).to(dev), train=train)
            if k == "card":
                torch.cuda.synchronize()
                launches = K.encoder_front.launches
        card, cpu = res["card"], res["cpu"]
        r = {"launches": launches, "wave": rel_max(card[0].cpu(), cpu[0]),
             "enhanced": rel_max(card[1].cpu(), cpu[1]), "features": rel_max(card[2].cpu(), cpu[2])}
        if train:
            r["state"] = max(rel_max(a.cpu(), b) for a, b in zip(
                tree_leaves(card[3]), tree_leaves(cpu[3]), strict=True))
        check(launches == 1, f"enhanced_forward train={train}: encoder_front launched {launches}")
        check(bool(torch.isfinite(card[0]).all()) and tuple(card[0].shape) == noisy_np.shape,
              f"enhanced_forward train={train}: waveform {tuple(card[0].shape)} or non-finite")
        check(max(r["enhanced"], r["features"], r.get("state", 0.0)) <= ENHANCE_FEATURE_TOL
              and r["wave"] <= ENHANCE_WAVE_TOL,
              f"enhanced_forward train={train} card vs CPU: {r}")
        out["fwd"][train] = r
    del res, card, cpu

    # The kernel on this batch's own audio, against its plain version, and
    # its time at this shape.
    enc_p, enc_specs = base["card"]["encoder"], encoder_layer_specs(spec.seanet)
    a3 = torch.from_numpy(noisy_np).cuda()[:, :, None]
    with torch.no_grad(), full_fp32():
        got = K.encoder_front(a3, enc_p, enc_specs)
        want = K.encoder_front_reference(a3, enc_p, enc_specs)
        torch.cuda.synchronize()
        out["front_err"] = float((got - want).abs().max())
        out["front_rel"] = out["front_err"] / float(want.abs().max())
        check(out["front_rel"] < 1e-5, f"encoder_front at 8 x 72000: rel err {out['front_rel']:.3g}")
        out["front_ms"] = cuda_ms(lambda: K.encoder_front(a3, enc_p, enc_specs), 10)
        out["front_plain_ms"] = cuda_ms(lambda: K.encoder_front_reference(a3, enc_p, enc_specs), 10)
    out["front_bound_ms"], out["front_bound_by"] = front_bound_of(a3.numel(), enc_p[0]["front"])
    del got, want, base

    # (b) one step of each mode, card against CPU from one state; the CPU's
    # own change under a 1e-7 relative change of the noisy input beside it.
    sn, sc = noisy_np[:2, :24000], clean_np[:2, :24000]
    bumped = (sn * (1 + 1e-7 * rng.normal(size=sn.shape))).astype(np.float32)
    out["steps"] = {}
    for mode in ENHANCE_MODES:
        m = {}
        for k, dev, x in (("cpu", "cpu", sn), ("card", "cuda", sn), ("cpu+1e-7", "cpu", bumped)):
            s = _enhance_state(params_np, spec, mode, dev)
            K.reset_launch_counts()
            loss, g_norm = _enhance_step(s, spec, torch.from_numpy(x).to(dev),
                                         torch.from_numpy(sc).to(dev))
            m[k] = (float(loss), float(g_norm))
            if k == "card":
                m["launches"] = K.encoder_front.launches
        r = {"launches": m["launches"], "loss": m["card"][0],
             "loss_rel": rel_err(m["card"][0], m["cpu"][0]),
             "grad_norm_rel": rel_err(m["card"][1], m["cpu"][1]),
             "cpu_self_grad_norm_rel": rel_err(m["cpu+1e-7"][1], m["cpu"][1])}
        want_launches = 2 if mode in ("feature", "hybrid") else 1
        check(r["launches"] == want_launches,
              f"enhance_step {mode}: encoder_front launched {r['launches']}, expected {want_launches}")
        check(np.isfinite(m["card"]).all(), f"enhance_step {mode}: non-finite {m['card']}")
        check(r["loss_rel"] <= 1e-3, f"enhance_step {mode} card vs CPU loss rel {r['loss_rel']:.3g}")
        # The gradient norm is held to 1e-3, or, where the CPU alone moves by
        # more than a quarter of that for a 1e-7 change of its input (the
        # phase term's 1/|X| weighting at the random decoder's near-null
        # bins), to 4 times the CPU's own change.
        r["grad_norm_limit"] = max(1e-3, 4 * r["cpu_self_grad_norm_rel"])
        check(r["grad_norm_rel"] <= r["grad_norm_limit"],
              f"enhance_step {mode} card vs CPU grad norm rel {r['grad_norm_rel']:.3g} (limit "
              f"{r['grad_norm_limit']:.3g})")
        out["steps"][mode] = r

    # (b) the steps repeat: one step of each mode twice from one state, as
    # tools/enhance_train.py runs them (repeatable_steps, PyTorch's default
    # precision): the trainable trees, BN state, Adam's state, loss and
    # gradient norm bit for bit; the waveform mode also at (c)'s batch.
    noisy, clean = torch.from_numpy(noisy_np).cuda(), torch.from_numpy(clean_np).cuda()
    out["repeat"] = {}
    with default_precision(), repeatable_steps():
        batches = [(m, torch.from_numpy(sn).cuda(), torch.from_numpy(sc).cuda())
                   for m in ENHANCE_MODES]
        for mode, a, b in batches + [(f"waveform {ENHANCE_B} x {ENHANCE_T}", noisy, clean)]:
            runs = []
            for _ in range(2):
                s = _enhance_state(params_np, spec, mode.split()[0], "cuda")
                loss, g_norm = _enhance_step(s, spec, a, b)
                runs.append({"adapter": s["ap"], "bn": s["st"], "decoder": s["base"]["decoder"],
                             "transformer": s["tr"] or {}, "adam": s["opt"].state_dict()["state"],
                             "loss": float(loss), "grad_norm": float(g_norm)})
            out["repeat"][mode] = _trees_equal(*runs)[:2]
            check(out["repeat"][mode][0], f"enhance_step {mode} against its repeat: "
                                          f"{_trees_equal(*runs)[2]} differ")
    del runs, s, batches

    # (c) timing: the waveform step at 8 x 3 s.
    s = _enhance_state(params_np, spec, "waveform", "cuda")
    for _ in range(2):
        _enhance_step(s, spec, noisy, clean)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    n_steps = 10
    t0 = time.perf_counter()
    for _ in range(n_steps):
        loss, _ = _enhance_step(s, spec, noisy, clean)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3 / n_steps
    out["step_launches"] = K.encoder_front.launches / n_steps
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["step_loss"] = float(loss)
    check(np.isfinite(out["step_loss"]), "timed enhancement steps: non-finite loss")
    split, out["idle"] = traced(lambda: _enhance_step(s, spec, noisy, clean))
    out["busy_ms"] = sum(ms for ms, _ in split.values())
    out["ops"] = sum(n for _, n in split.values())
    front = [(ms, n) for name, (ms, n) in split.items() if "front_kernel" in name]
    out["front_in_trace"] = (sum(ms for ms, _ in front), sum(n for _, n in front))
    out["profile"] = kernel_lines(split, 10)
    with torch.no_grad():
        out["infer_ms"] = cuda_ms(lambda: enhanced_forward(
            s["base"], spec.seanet, s["ap"], s["st"], noisy, train=False, feature_scale=1.5), 5)
    del s
    torch.cuda.empty_cache()
    bcfg = BYOLConfig()
    bp = byol_from_jax(init_byol(bcfg, seed=0), "cuda")
    online = tree_leaves(bp["online"])
    for t in online:
        t.requires_grad_(True)
    opt = torch.optim.Adam(online, lr=3e-4, betas=(0.9, 0.999), eps=1e-8)
    v1, v2 = (torch.from_numpy(rng.normal(size=(16, 64, 512)).astype(np.float32)).cuda()
              for _ in range(2))
    for _ in range(2):
        byol_step(bp, opt, v1, v2, bcfg, bcfg.tau)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        bl = byol_step(bp, opt, v1, v2, bcfg, bcfg.tau)
    torch.cuda.synchronize()
    out["byol_ms"] = (time.perf_counter() - t0) * 1e3 / n_steps
    out["byol_loss"] = float(bl)
    check(np.isfinite(out["byol_loss"]), "BYOL step: non-finite loss")
    del bp, opt, online
    # One BYOL step twice from one state, as tools/byol_train.py runs it.
    runs = []
    with default_precision(), repeatable_steps():
        for _ in range(2):
            bp = byol_from_jax(init_byol(bcfg, seed=0), "cuda")
            online = tree_leaves(bp["online"])
            for t in online:
                t.requires_grad_(True)
            opt = torch.optim.Adam(online, lr=3e-4, betas=(0.9, 0.999), eps=1e-8)
            bl = byol_step(bp, opt, v1, v2, bcfg, bcfg.tau)
            runs.append({"params": bp, "adam": opt.state_dict()["state"], "loss": float(bl)})
    out["repeat"]["byol_step"] = _trees_equal(*runs)[:2]
    check(out["repeat"]["byol_step"][0], f"byol_step against its repeat: "
                                         f"{_trees_equal(*runs)[2]} differ")
    del runs, bp, opt, online

    # (d) resampling to 24 kHz at 16 x 10 s.
    out["resample"] = {}
    for orig in RESAMPLE_RATES:
        x = rng.normal(size=(16, 10 * orig)).astype(np.float32) * 0.3
        xc = torch.from_numpy(x).cuda()
        got = resample(xc, orig, sr).cpu().numpy()
        want = np.stack([resample_np(row, orig, sr) for row in x])
        err = float(np.abs(got - want).max())
        check(got.shape == want.shape and err <= 1e-5,
              f"resample {orig} -> {sr}: shape {got.shape}, max abs err {err:.3g}")
        out["resample"][orig] = {"err": err, "ms": cuda_ms(lambda: resample(xc, orig, sr), 10)}
    del xc

    # (e) the CLIs as subprocesses on the card, in two waves of concurrent
    # processes (the second needs the first's checkpoints).
    root = os.path.dirname(os.path.abspath(__file__))

    def clis(runs: dict) -> dict:
        """{name: (tool, args)} -> {name: stdout}, all started together."""
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", f"wavtokenizer_tpu_torch.tools.{tool}", *args,
             "--device", "cuda"], cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for name, (tool, args) in runs.items()}
        results = {}
        try:
            for name, proc in procs.items():
                results[name] = proc.communicate(timeout=600) + (proc.returncode,)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        out.setdefault("cli_waves_s", []).append(time.perf_counter() - t0)
        for name, (_, stderr, rc) in results.items():
            check(rc == 0, f"{name} failed:\n{stderr[-3000:]}")
        return {name: r[0] for name, r in results.items()}

    with tempfile.TemporaryDirectory() as d:
        w = lambda path, y: wavfile.write(path, sr, (np.clip(y, -1, 1) * 32767).astype(np.int16))
        pairs = []
        for i in range(2):
            paths = (os.path.join(d, f"noisy{i}.wav"), os.path.join(d, f"clean{i}.wav"))
            w(paths[0], noisy_np[i])
            w(paths[1], clean_np[i])
            pairs.append("|".join(paths))
        pairs_file = os.path.join(d, "pairs.txt")
        with open(pairs_file, "w") as f:
            f.write("\n".join(pairs) + "\n")
        long_in, long_out = os.path.join(d, "long"), os.path.join(d, "long_out")
        os.makedirs(long_in)
        for i in range(2):
            w(os.path.join(long_in, f"l{i}.wav"), 0.5 * _speech_like(sr, 7 * sr, 30 + i)
              + 0.02 * rng.normal(size=7 * sr))
        feats = os.path.join(d, "feats")
        os.makedirs(feats)
        enc = base_params_from_jax(params_np, spec.seanet, "cuda")["encoder"]
        f = frozen_encode(enc, spec.seanet, noisy)
        for i in range(ENHANCE_B):
            np.save(os.path.join(feats, f"f{i}.npy"), f[i].T.cpu().numpy())   # (D, T)
        del enc, f
        run, byol_dir, lp_out = (os.path.join(d, n) for n in ("enhance", "byol", "lowpassed"))
        clis({"enhance_train": ("enhance_train", ["--pairs-file", pairs_file, "--steps", "3",
                                                  "--batch-size", "2", "--out-dir", run]),
              "byol_train": ("byol_train", ["--features-dir", feats, "--steps", "5",
                                            "--out-dir", byol_dir]),
              "lowpass": ("lowpass", ["--input-dir", long_in, "--output-dir", lp_out,
                                      "--cutoff", "4000"])})
        stdout = clis({
            "enhance_infer": ("enhance_infer", ["--input-dir", long_in, "--output-dir", long_out,
                                                "--adapter-ckpt", os.path.join(run, "last.pt")]),
            "enhance_train --mode byol": ("enhance_train", [
                "--pairs-file", pairs_file, "--mode", "byol", "--byol-ckpt",
                os.path.join(byol_dir, "byol_model.pt"), "--steps", "1", "--batch-size", "2",
                "--out-dir", os.path.join(d, "eb")])})["enhance_train --mode byol"]
        for i in range(2):
            y = read_audio(os.path.join(long_out, f"l{i}.wav"))[0]
            check(y.shape == (7 * sr,) and np.isfinite(y).all() and np.abs(y).max() > 0,
                  f"enhance_infer output {i}: shape {y.shape}")
        out["byol_leaves"] = stdout.split("byol ckpt: ")[1].split()[0] if "byol ckpt: " in stdout \
            else None
        check(out["byol_leaves"] == "32", f"--byol-ckpt loaded {out['byol_leaves']} leaves")
        out["lowpass"] = []
        for i in range(2):
            x = read_audio(os.path.join(long_in, f"l{i}.wav"))[0]
            y = read_audio(os.path.join(lp_out, f"l{i}.wav"))[0]
            out["lowpass"].append(energy_above(y, x, sr, 4000.0))
        check(max(out["lowpass"]) < 1e-3,
              f"lowpass: energy above the cutoff over the input's {out['lowpass']}")
    return out


# [16]: the training options, the native loader and the profiling tools.
# The bf16 steps are held to fp32 at tests/test_mixed_precision.py's
# tolerances (rtol, atol) per loss; the sums at the loosest of them.
BF16_TOLS = {"disc_mp": (0.03, 0.02), "disc_mrd": (0.03, 0.02), "disc_dac": (0.03, 0.05),
             "gen_mp": (0.03, 0.02), "gen_mrd": (0.03, 0.02), "fm_mp": (0.05, 0.02),
             "fm_mrd": (0.05, 0.02), "dac_gen": (0.05, 0.05), "dac_feat": (0.05, 0.05),
             "mel_loss": (0.05, 0.05), "commit_loss": (0.05, 0.05), "disc_total": (0.05, 0.05),
             "gen_total": (0.05, 0.05)}
# Remat against no remat: JAX's tests/test_mixed_precision.py holds its
# remat_disc modes' metrics to this relative tolerance; it holds the losses
# and the gradient norm here.  The whole gradient vectors are held to
# REMAT_GRAD_TOL: the recompute's fp32 rounding moves the few terms that sit
# on a kink (the feature losses' |a - b|, hinges, leaky ReLUs); a recompute
# that drew a fresh dropout mask moves them by 0.57 (float64, CPU).
REMAT_TOL = 2e-4
REMAT_GRAD_TOL = 1e-2
LOADER_FILES = 48
OPTION_MODES = {"fp32": {}, "fp32 remat": {"remat": True},
                "bf16 disc": {"disc_compute_dtype": "bfloat16"},
                "bf16 disc+decode": {"disc_compute_dtype": "bfloat16",
                                     "gen_compute_dtype": "bfloat16"}}
# The CLIs of [16] (c), as subprocesses: (name, arguments).
OPTION_CLIS = {
    "mem_probe remat": ["wavtokenizer_tpu_torch.tools.mem_probe", "--batch", "40",
                        "--seconds", "3"],
    "mem_probe no remat": ["wavtokenizer_tpu_torch.tools.mem_probe", "--batch", "40",
                           "--seconds", "3", "--no-remat"],
    "check_env": ["wavtokenizer_tpu_torch.tools.check_env"],
    "perf_profile": ["wavtokenizer_tpu_torch.tools.perf_profile", "--batch", "128",
                     "--seconds", "3", "--iters", "10"],
    "train_profile": ["wavtokenizer_tpu_torch.tools.train_profile", "--config", TRAIN_CONFIG,
                      "--batch", "8", "--iters", "1", "--passes", "1"],
}


def _write_loader_wavs(d: str, n: int) -> list:
    """n files of 4-8 s at 16, 24 and 44.1 kHz, every third stereo."""
    from scipy.io import wavfile

    paths = []
    for i in range(n):
        sr = (16000, 24000, 44100)[i % 3]
        y = _speech_like(sr, int(sr * (4 + 4 * ((i * 7) % 11) / 10)), seed=i)
        if i % 3 == 2:
            y = np.stack([y, 0.7 * y], axis=1)
        paths.append(os.path.join(d, f"clip{i:02d}.wav"))
        wavfile.write(paths[-1], sr, (np.clip(y, -1, 1) * 32767).astype(np.int16))
    return paths


def _copy_state(S, state: dict, tcfg) -> dict:
    """A copy of a train state: its trees, optimizers and schedules.  The
    optimizers' state dicts are deep-copied: ``load_state_dict`` keeps the
    given moment tensors when their type and device already fit, so a step
    of the copy would otherwise move the original's moments too."""
    import copy

    st = S.new_train_state(state["gen"], state["disc"], state["vq"], state["decoder"], tcfg,
                           state["step"])
    for k in ("opt_gen", "opt_disc", "sched_gen", "sched_disc"):
        st[k].load_state_dict(copy.deepcopy(state[k].state_dict()))
    return st


def _flat_grads(opt) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1) for p in opt.param_groups[0]["params"]])


def _remat_by_phase(S, base: dict, audio, spec, tcfg, generator) -> dict:
    """Remat against no remat, phase by phase from copies of one state, with
    the same draws (bandwidth, dropout masks, k-means): the discriminator
    phase's losses and gradients, then the generator phase's losses,
    gradient norm and gradients over the SAME discriminators (the no-remat
    copy's, updated).  A whole step cannot show remat's effect alone: AdamW's
    first moments over their root second moments turn rounding-level
    differences of near-zero gradients into updates of up to the learning
    rate.  Returns each quantity's relative difference."""
    rcfg = dataclasses.replace(tcfg, remat=True)
    runs = []
    for cfg in (tcfg, rcfg, tcfg):
        st = _copy_state(S, base, cfg)
        g = torch.Generator().manual_seed(generator.initial_seed())
        bw = int(torch.randint(0, cfg.num_bandwidths, (), generator=g))
        drop_d, drop_g = S._dropout_generators(g, audio.device)
        vq, m = S.discriminator_phase(st, audio, spec, cfg, bw, 1, g, drop_d)
        runs.append({"st": st, "cfg": cfg, "g": g, "bw": bw, "drop_g": drop_g, "vq": vq,
                     "disc": {k: float(v.detach()) for k, v in m.items()},
                     "disc_grads": _flat_grads(st["opt_disc"])})
    with torch.no_grad():
        for r in runs[1:]:
            for a, b in zip(S.tree_leaves(runs[0]["st"]["disc"]), S.tree_leaves(r["st"]["disc"])):
                b.copy_(a)
    for r in runs:
        m = S.generator_phase(r["st"], r["vq"], audio, spec, r["cfg"], r["bw"], 1, r["g"],
                              r["drop_g"], with_grad_norm=True)
        r["gen"] = {k: float(v.detach()) for k, v in m.items()}
        r["gen_grads"] = _flat_grads(r["st"]["opt_gen"])
        del r["st"]

    def diff(a, b):
        rel = {k: rel_err(b["disc"][k], v) for k, v in a["disc"].items()}
        rel.update({k: rel_err(b["gen"][k], v) for k, v in a["gen"].items()})
        for k in ("disc_grads", "gen_grads"):
            rel[k] = float((b[k] - a[k]).norm() / a[k].norm())
        return rel

    # The third run repeats the first: the card's own run-to-run difference.
    return diff(runs[0], runs[1]), diff(runs[0], runs[2])


COST_PAIRS = 5              # (b): steps with and without repeatable_steps, in turns


def _flag_cost(step) -> dict:
    """The cost of ``repeatable_steps``: ``step(i)`` timed in turns with the
    flags and without (PyTorch's default: cuDNN may pick nondeterministic
    algorithms), one warm-up pair, then COST_PAIRS pairs; the median ms of
    each side and their difference."""
    from wavtokenizer_tpu_torch.models.wavtokenizer import repeatable_steps

    ms = {"with": [], "without": []}
    for i in range(COST_PAIRS + 1):
        for side in ("with", "without"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with repeatable_steps() if side == "with" else contextlib.nullcontext():
                step(2 * i + (side == "without"))
            torch.cuda.synchronize()
            if i:
                ms[side].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    return {"ms": ms, "with_ms": med["with"], "without_ms": med["without"],
            "cost_ms": med["with"] - med["without"],
            "cost_pct": 100.0 * (med["with"] - med["without"]) / med["without"]}


def _run_cli(name: str, root: str) -> tuple:
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *OPTION_CLIS[name]], cwd=root,
                         capture_output=True, text=True, timeout=900)
    return res, time.perf_counter() - t0


def options_phase(K, rt_ms: float) -> dict:
    """Phase 16 at the small-320 YAML's full width (40 x 3 s, k-means 200,
    dropout 0.1, discriminators at full width).

    (a) The native loader on LOADER_FILES WAVs written here: the trainer
    takes it (its ``native_loader`` event; the card machine has g++), 2 and
    4 threads yield equal batches, ``start_seq`` resumes the stream, and its
    rate at 40 x 72 000.  (b) One state after its first step (k-means, split
    into k-means alone and the rest), one batch of that loader, one step in
    each mode of OPTION_MODES from a copy of the state, then one more: ms,
    peak memory, VQ launches; remat against no remat within REMAT_TOL, bf16
    within BF16_TOLS and gradient cosine > 0.9, codes equal in every mode.
    (c) The CLIs of OPTION_CLIS as subprocesses: perf_profile's stage sum
    against [6]'s round trip ``rt_ms`` (10%), and ``stage_flops`` with the
    kernels against it with the plain versions, here, at 8 x 3 s.  (d) The
    MS-STFT discriminator at 32 filters, 2 x 1 s, card against CPU."""
    import tempfile

    import yaml

    import wavtokenizer_tpu_torch.train.step as S
    from wavtokenizer_tpu_torch import WavTokenizer, init_wavtokenizer
    from wavtokenizer_tpu_torch.models import vocos as vocos_mod
    from wavtokenizer_tpu_torch.models.seanet import seanet_encode
    from wavtokenizer_tpu_torch.native import NativeDataLoader
    from wavtokenizer_tpu_torch.ops import vq as vq_mod
    from wavtokenizer_tpu_torch.train.discriminators import (init_msstft_discriminator,
                                                             msstft_discriminator)
    from wavtokenizer_tpu_torch.train.trainer import (Trainer, step_generator,
                                                      train_config_from_yaml)
    from wavtokenizer_tpu_torch.train.vq_train import kmeans
    from wavtokenizer_tpu_torch.train.wnorm import fold_tree
    from wavtokenizer_tpu_torch.utils.profiling import pipeline_stages, stage_flops

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, TRAIN_CONFIG)) as f:
        spec, tcfg, data, _ = train_config_from_yaml(yaml.safe_load(f))
    out = {"B": data.batch_size, "T": data.num_samples}
    dev = "cuda"

    # (a) the native loader.
    with tempfile.TemporaryDirectory() as d:
        paths = _write_loader_wavs(d, LOADER_FILES)
        filelist = os.path.join(d, "files.txt")
        with open(filelist, "w") as f:
            f.write("\n".join(paths) + "\n")
        data.filelist_path = filelist
        tr = Trainer(spec, tcfg, data, out_dir=os.path.join(d, "run"), device=dev)
        stream = tr._make_train_iter(0)
        tr.close()
        with open(os.path.join(d, "run", "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        check(events == [{"event": "native_loader", "files": LOADER_FILES}],
              f"the trainer did not take the native loader: {events}")
        kw = dict(sample_rate=data.sampling_rate, num_samples=data.num_samples,
                  batch_size=data.batch_size, seed=3407, drop_last=False)
        first = [next(stream) for _ in range(3)]
        four = NativeDataLoader(paths, num_threads=4, **kw)
        for i, b in enumerate(first):
            check(np.array_equal(four.next_batch(), b), f"loader batch {i}: 4 threads != 2")
        four.close()
        resumed = NativeDataLoader(paths, num_threads=2, start_seq=2, **kw)
        check(np.array_equal(resumed.next_batch(), first[2]),
              "loader start_seq=2 differs from the stream's batch 2")
        resumed.close()
        rate = NativeDataLoader(paths, num_threads=8, **kw)
        rate.next_batch()
        t0 = time.perf_counter()
        n_rate = 6
        for _ in range(n_rate):
            rate.next_batch()
        out["batches_per_s"] = n_rate / (time.perf_counter() - t0)
        check(rate.errors == 0, f"loader errors {rate.errors}")
        rate.close()
    audio = torch.as_tensor(first[0]).to(dev)

    # (b) the four modes from one state.
    base = S.create_train_state(spec, tcfg, seed=0, device=dev)
    with torch.no_grad():
        emb = seanet_encode(fold_tree(base["gen"]["encoder"]), spec.seanet, audio[:, :, None],
                            front=False).reshape(-1, spec.vq.dimension)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kmeans(emb, spec.vq.bins, spec.vq.kmeans_iters, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        out["kmeans_ms"] = (time.perf_counter() - t0) * 1e3
    del emb
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    S.train_step(base, audio, spec, tcfg, step_generator(0, 0))
    torch.cuda.synchronize()
    out["first_ms"] = (time.perf_counter() - t0) * 1e3
    out["first_launches"] = K.vq_nearest.launches
    out["first_seg_launches"] = K.segment_sum.launches
    check(out["first_seg_launches"] == spec.vq.kmeans_iters + 2,
          f"first step: segment_sum launches {out['first_seg_launches']}")
    codes_seen = []
    real_forward = S.vq_train_forward

    def recording_forward(*args, **kw):
        res = real_forward(*args, **kw)
        codes_seen.append(res[1].detach().clone())
        return res

    modes, grads, codes = {}, {}, {}
    S.vq_train_forward = recording_forward
    try:
        for name, over in OPTION_MODES.items():
            cfg = dataclasses.replace(tcfg, **over)
            st = _copy_state(S, base, cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            r = {"ms": [], "launches": [], "seg_launches": []}
            for step in (1, 2):
                codes_seen.clear()
                K.reset_launch_counts()
                t0 = time.perf_counter()
                _, m = S.train_step(st, audio, spec, cfg, step_generator(0, step),
                                    with_grad_norm=True)
                torch.cuda.synchronize()
                r["ms"].append((time.perf_counter() - t0) * 1e3)
                r["launches"].append(K.vq_nearest.launches)
                r["seg_launches"].append(K.segment_sum.launches)
                if step == 1:
                    r["metrics"] = {k: float(v) for k, v in m.items()}
                    grads[name] = _flat_grads(st["opt_gen"])
                    codes[name] = [c.cpu() for c in codes_seen]
            r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            r["flag"] = _flag_cost(lambda i: S.train_step(st, audio, spec, cfg,
                                                          step_generator(0, 3 + i)))
            codes_seen.clear()
            modes[name] = r
            del st
            torch.cuda.empty_cache()
    finally:
        S.vq_train_forward = real_forward
    # The same at PyTorch's default precision (cuDNN TF32 on), the CLIs'.
    st = _copy_state(S, base, tcfg)
    with default_precision():
        out["default_flag"] = _flag_cost(lambda i: S.train_step(st, audio, spec, tcfg,
                                                                step_generator(0, 3 + i)))
    del st
    torch.cuda.empty_cache()
    out["remat"], out["remat_floor"] = _remat_by_phase(S, base, audio, spec, tcfg,
                                                       step_generator(0, 1))
    del base
    torch.cuda.empty_cache()
    ref = modes["fp32"]["metrics"]
    for name, r in modes.items():
        check(all(np.isfinite(v) for v in r["metrics"].values()), f"{name}: non-finite {r}")
        check(r["launches"] == [2, 2], f"{name}: vq_nearest launches per step {r['launches']}")
        check(r["seg_launches"] == [2, 2],
              f"{name}: segment_sum launches per step {r['seg_launches']}")
        check(len(codes[name]) == 2 and all(torch.equal(a, b) for a, b in
                                            zip(codes[name], codes["fp32"])),
              f"{name}: the step's codes differ from the fp32 step's")
        g, g0 = grads[name], grads["fp32"]
        r["grad_cos"] = float(g @ g0 / (g.norm() * g0.norm()))
        r["rel"] = {k: rel_err(v, ref[k]) for k, v in r["metrics"].items()}
    out["modes"] = modes
    del grads
    for k, v in out["remat"].items():
        limit = REMAT_GRAD_TOL if k.endswith("_grads") else REMAT_TOL
        check(v <= limit, f"remat vs no remat: {k} rel {v:.3g} (limit {limit})")
    for name in ("bf16 disc", "bf16 disc+decode"):
        r = modes[name]
        for k, (rtol, atol) in BF16_TOLS.items():
            got, want = r["metrics"][k], ref[k]
            check(abs(got - want) <= atol + rtol * abs(want),
                  f"{name}: {k} {got:.5g} vs fp32 {want:.5g} (rtol {rtol}, atol {atol})")
        check(r["grad_cos"] > 0.9, f"{name}: gradient cosine with fp32 {r['grad_cos']:.4f}")

    # (c) the CLIs.
    clis = {}
    with subprocess.Popen([sys.executable, "-m", *OPTION_CLIS["check_env"]], cwd=root,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) as env:
        for name in ("mem_probe remat", "mem_probe no remat"):
            clis[name] = _run_cli(name, root)
        env_out, env_err = env.communicate(timeout=900)
    check(env.returncode == 0 and env_out.strip().endswith("OK"),
          f"check_env failed ({env.returncode}):\n{env_out[-3000:]}\n{env_err[-2000:]}")
    out["check_env"] = [l for l in env_out.splitlines() if l.startswith(("kernel", "native"))]
    for name in ("perf_profile", "train_profile"):
        clis[name] = _run_cli(name, root)
    results = {}
    for name, (res, secs) in clis.items():
        check(res.returncode == 0, f"{name} failed ({res.returncode}):\n{res.stdout[-2000:]}\n"
                                   f"{res.stderr[-3000:]}")
        results[name] = json.loads(res.stdout.strip().splitlines()[-1])
        results[name]["cli_s"] = secs
    out["clis"] = results
    out["perf_table"] = [l for l in clis["perf_profile"][0].stdout.splitlines()
                         if l.startswith("  ")]
    st = results["perf_profile"]["stages"]
    out["stage_sum_ms"] = sum(st[k]["ms"] for k in ("encoder", "vq", "backbone", "head"))
    check(abs(out["stage_sum_ms"] - rt_ms) <= 0.1 * rt_ms,
          f"perf_profile stage sum {out['stage_sum_ms']:.3f} ms vs [6] round trip {rt_ms:.3f} ms")
    for name in ("mem_probe remat", "mem_probe no remat"):
        check(results[name]["fits"] and results[name]["peak_bytes"] > 0,
              f"{name}: {results[name]}")

    small320 = spec
    model = WavTokenizer.from_jax_params(init_wavtokenizer(small320, seed=0,
                                                           random_codebook=True),
                                         small320, device=dev)
    a8 = torch.as_tensor((np.random.default_rng(16).normal(size=(8, 72000)) * 0.1)
                         .astype(np.float32)).to(dev)
    stages = pipeline_stages(model.params, small320, a8)
    out["flops_kernels"] = stage_flops(stages)
    out["flops_launched"] = {"vq": K.vq_nearest.flops, "convnext": K.convnext_block.flops,
                             "front": K.encoder_front.flops}
    plain = {"vq": (vq_mod, "vq_nearest", lambda *a: K.vq_nearest_reference(*a[:3])),
             "cnx": (vocos_mod, "convnext_block_kernel",
                     lambda *a: K.convnext_block_reference(*a[:10])),
             "front": (K, "encoder_front", K.encoder_front_reference)}
    saved = {k: getattr(mod, attr) for k, (mod, attr, _) in plain.items()}
    try:
        for mod, attr, fn in plain.values():
            setattr(mod, attr, fn)
        out["flops_plain"] = stage_flops(stages)
    finally:
        for k, (mod, attr, _) in plain.items():
            setattr(mod, attr, saved[k])
    check(out["flops_kernels"] == out["flops_plain"],
          f"stage_flops with the kernels {out['flops_kernels']} != with the plain versions "
          f"{out['flops_plain']}")
    del model, stages

    # (d) the MS-STFT discriminator.
    params = init_msstft_discriminator(seed=0, filters=32)
    x = torch.as_tensor((np.random.default_rng(17).normal(size=(2, 24000)) * 0.1)
                        .astype(np.float32))
    with torch.no_grad():
        want = msstft_discriminator(params, x)
        got = msstft_discriminator(S.tree_map(lambda t: t.to(dev), params), x.to(dev))
    pairs = list(zip(got[0] + sum(got[1], []), want[0] + sum(want[1], [])))
    out["msstft_rel"] = max(rel_max(g.cpu(), w) for g, w in pairs)
    out["msstft_maps"] = len(pairs)
    check(out["msstft_rel"] <= 1e-4, f"msstft card vs CPU rel-max {out['msstft_rel']:.3g}")
    return out


# [17]: the multi-card paths, on the one card of this machine.  (a) NCCL in
# a group of one rank; (b) two ranks over gloo, both on this card (NCCL
# refuses two ranks on one device); (c) the data-parallel engine and
# extraction with two replicas on this card; (d) the ConvNeXt kernel on
# tensor-parallel slices of its hidden width.
# (a): the step of a group of one against the plain step from one state,
# under repeatable_steps (the VQ statistics, which the
# generator phase reads, go through the segment-sum kernel, in a fixed
# order); each quantity is held to 1e-6 relative or to 4x the plain step's
# difference from its own repeat, whichever is larger.
NCCL_STEP_TOL = 1e-6
MULTI_B = 8                 # (b): the global batch, 4 rows a rank
TP_SHARDS = (2, 4)          # (d): I = 2304 in slices of 1152 and 576
EXTRACT_FILES = 5


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_yaml():
    import yaml

    from wavtokenizer_tpu_torch.train.trainer import train_config_from_yaml

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, TRAIN_CONFIG)) as f:
        return train_config_from_yaml(yaml.safe_load(f))


def _leaves_rel(a: dict, b: dict) -> float:
    """Largest |a - b| over each leaf's largest |b|, across the trees."""
    from wavtokenizer_tpu_torch.train.step import tree_leaves
    with torch.no_grad():
        return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                   for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


def _step_diff(a: tuple, b: tuple) -> dict:
    """Relative differences of two (state, metrics) step results: the
    metrics (largest), the gradient vectors of both optimizers (over their
    norm), the weights and the VQ state (``_leaves_rel``)."""
    (sa, ma), (sb, mb) = a, b
    out = {"metrics": max(rel_err(float(ma[k]), float(v)) for k, v in mb.items())}
    out["grads"] = max(float((_flat_grads(sa[k]) - _flat_grads(sb[k])).norm()
                             / _flat_grads(sb[k]).norm()) for k in ("opt_gen", "opt_disc"))
    out["weights"] = max(_leaves_rel(sa[k], sb[k]) for k in ("gen", "disc"))
    out["vq"] = _leaves_rel(sa["vq"], sb["vq"])
    return out


def nccl_world_one(K, dev: str = "cuda", backend: str = "nccl") -> dict:
    """(a) One step of the small-320 YAML (40 x 3 s, discriminators at full
    width) through an in-process group of one rank (TCP rendezvous on a free
    port) against the plain step, all from one state past its first step
    (k-means done), and the plain step against its own repeat (the card's
    floor); the collectives counted."""
    import torch.distributed as dist

    import wavtokenizer_tpu_torch.train.step as S
    from wavtokenizer_tpu_torch.models.wavtokenizer import repeatable_steps
    from wavtokenizer_tpu_torch.parallel import mesh as M
    from wavtokenizer_tpu_torch.train.trainer import step_generator

    spec, tcfg, data, _ = _train_yaml()
    B, T = data.batch_size, data.num_samples
    audio = torch.as_tensor((np.random.default_rng(17).normal(size=(B, T)) * 0.1)
                            .astype(np.float32)).to(dev)
    base = S.create_train_state(spec, tcfg, seed=0, device=dev)
    S.train_step(base, audio, spec, tcfg, step_generator(0, 0))
    out = {"B": B, "T": T}
    with repeatable_steps():
        plain = [S.train_step(_copy_state(S, base, tcfg), audio, spec, tcfg,
                              step_generator(0, 1), with_grad_norm=True) for _ in range(2)]
        M.init_distributed(backend, dev, f"tcp://127.0.0.1:{_free_port()}", 0, 1)
        try:
            mesh = M.make_mesh(1, dev)
            out["backend"] = dist.get_backend(mesh.data_group)
            M.COLLECTIVES.clear()
            K.reset_launch_counts()
            state = M.shard_train_state(mesh, M.replicate_train_state(
                mesh, _copy_state(S, base, tcfg)))
            shard = M.batch_shard(mesh, B)
            dist_step = S.train_step(state, audio[shard.start:shard.stop], spec, tcfg,
                                     step_generator(0, 1), with_grad_norm=True, shard=shard)
            if dev == "cuda":
                torch.cuda.synchronize()
            out["collectives"] = dict(M.COLLECTIVES)
            out["launches"] = K.vq_nearest.launches
            out["seg_launches"] = K.segment_sum.launches
            dist.barrier()
        finally:
            dist.destroy_process_group()
    out["rel"] = _step_diff(dist_step, plain[0])
    out["floor"] = _step_diff(plain[1], plain[0])
    out["grad_norm"] = (float(dist_step[1]["grad_norm"]), float(plain[0][1]["grad_norm"]))
    out["metrics"] = {k: float(v) for k, v in dist_step[1].items()}
    check(out["backend"] == backend, f"the group's backend is {out['backend']}")
    check(out["collectives"].get("all_reduce", 0) >= 5 and out["collectives"].get("broadcast"),
          f"collectives of the distributed step: {out['collectives']}")
    check(out["launches"] == 2, f"vq_nearest launches {out['launches']}, expected 2")
    check(out["seg_launches"] == 2, f"segment_sum launches {out['seg_launches']}, expected 2")
    for k, v in out["rel"].items():
        limit = max(NCCL_STEP_TOL, 4 * out["floor"][k])
        check(v <= limit, f"NCCL step vs plain step: {k} {v:.3g} (limit {limit:.3g})")
    return out


def multi_step(mesh, dev: str = "cuda") -> dict:
    """One step of the small-320 YAML's spec and config at full width on
    the global batch of MULTI_B x 3 s, from an un-inited codebook (k-means
    on the gathered samples): this rank's rows of it under ``mesh``, all of
    it without.  Records k-means' samples and result."""
    import wavtokenizer_tpu_torch.train.step as S
    from wavtokenizer_tpu_torch.ops import kernels as K
    from wavtokenizer_tpu_torch.parallel import mesh as M
    from wavtokenizer_tpu_torch.train import vq_train
    from wavtokenizer_tpu_torch.train.trainer import step_generator

    spec, tcfg, data, _ = _train_yaml()
    audio = torch.as_tensor((np.random.default_rng(18).normal(size=(MULTI_B, data.num_samples))
                             * 0.1).astype(np.float32)).to(dev)
    state = S.create_train_state(spec, tcfg, seed=0, device=dev)
    real, km = vq_train.kmeans, {}

    def recorded(samples, *a, **k):
        means, bins, buckets = real(samples, *a, **k)
        km.update(samples=samples.cpu(), means=means.cpu(), buckets=buckets.cpu())
        return means, bins, buckets

    vq_train.kmeans = recorded
    try:
        K.reset_launch_counts()
        M.COLLECTIVES.clear()
        shard = M.batch_shard(mesh, MULTI_B)
        t0 = time.perf_counter()
        _, m = S.train_step(state, audio[shard.start:shard.stop], spec, tcfg,
                            step_generator(0, 0), with_grad_norm=True, shard=shard)
        if dev == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        vq_train.kmeans = real
    return {"metrics": {k: float(v) for k, v in m.items()}, "launches": K.vq_nearest.launches,
            "kmeans": km, "rows": (shard.start, shard.stop), "ms": ms,
            "collectives": dict(M.COLLECTIVES),
            "embed": state["vq"]["embed"].cpu()}


def _gloo_rank(rank: int, port: int, out_dir: str, dev: str) -> None:
    """(b) One of two ranks over gloo, both on this card."""
    from wavtokenizer_tpu_torch.parallel import mesh as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    M.init_distributed("gloo", f"{dev}:0" if dev == "cuda" else dev,
                       f"tcp://127.0.0.1:{port}", rank, 2)
    try:
        res = multi_step(M.make_mesh(1, f"{dev}:0" if dev == "cuda" else dev), dev)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def gloo_two_ranks(dev: str = "cuda") -> dict:
    """(b) Two spawned processes, 4 rows each, over gloo with CUDA tensors
    (staged through host memory by ``parallel/mesh.py``), against the
    one-process step on the global batch on the same card."""
    import tempfile

    spec = _train_yaml()[0]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(_gloo_rank, args=(_free_port(), d, dev), nprocs=2)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    one = multi_step(None, dev)
    out = {"spawn_s": spawn_s, "launches": [r["launches"] for r in ranks],
           "rows": [r["rows"] for r in ranks], "ms": [r["ms"] for r in ranks],
           "one_ms": one["ms"], "collectives": ranks[0]["collectives"]}
    km = [r["kmeans"] for r in ranks]
    out["samples_rel"] = rel_max(km[0]["samples"], one["kmeans"]["samples"])
    check(torch.equal(km[0]["samples"], km[1]["samples"])
          and torch.equal(km[0]["buckets"], km[1]["buckets"]),
          "the two ranks' k-means saw other samples or found other codes")
    out["n_rows"] = int(one["kmeans"]["buckets"].numel())
    out["flips"] = int((km[0]["buckets"] != one["kmeans"]["buckets"]).sum())
    out["gap"] = vq_distance_gap(one["kmeans"]["samples"], one["kmeans"]["means"],
                                 km[0]["buckets"], one["kmeans"]["buckets"])
    rels = {k: max(rel_err(r["metrics"][k], v) for r in ranks)
            for k, v in one["metrics"].items()}
    out["worst"] = max(rels, key=rels.get)
    out["loss_rel"] = max(v for k, v in rels.items() if k != "grad_norm")
    out["grad_norm_rel"] = rels["grad_norm"]
    out["embed_rel"] = rel_max(ranks[0]["embed"], one["embed"])
    out["metrics"] = ranks[0]["metrics"]
    want = spec.vq.kmeans_iters + 2
    check(out["launches"] == [want, want], f"vq_nearest launches per rank {out['launches']}, "
          f"expected {want} each")
    check(out["rows"] == [(0, MULTI_B // 2), (MULTI_B // 2, MULTI_B)], f"rows {out['rows']}")
    check(out["loss_rel"] <= 1e-3, f"gloo step vs one process: {out['worst']} rel "
          f"{out['loss_rel']:.3g}")
    check(out["grad_norm_rel"] <= 1e-3, f"gloo step grad norm rel {out['grad_norm_rel']:.3g}")
    return out


def dp_engine_phase(model, params_np, spec, K, dev: str = "cuda") -> dict:
    """(c) ServingEngine with two replicas on one card: 16 concurrent encode
    requests, then 16 detokenize requests of their codes, against direct
    calls, the launches counted per batch; then tools/extract_features.py as
    subprocesses with one device and with two replicas of it on a ragged
    file count."""
    import tempfile
    import threading

    from scipy.io import wavfile

    from wavtokenizer_tpu_torch.api.engine import EngineConfig, ServingEngine
    from wavtokenizer_tpu_torch.checkpoint.export import (save_torch_checkpoint,
                                                          wavtokenizer_state_dict)
    from wavtokenizer_tpu_torch.utils.golden import max_flips

    devices = [f"{dev}:0", f"{dev}:0"] if dev == "cuda" else [dev, dev]
    T = int(TIMING_SECONDS * spec.sample_rate)
    audio = (np.random.default_rng(19).normal(size=(16, T)) * 0.1).astype(np.float32)
    feats_d, codes_d = model.encode_infer(audio)
    wave_d = model.decode(model.codes_to_features(codes_d), 0).cpu().numpy()
    codes_d = codes_d.cpu().numpy()[0]
    out = {}
    eng = ServingEngine(model, EngineConfig(batch_sizes=(2, 8), clip_seconds=(TIMING_SECONDS,),
                                            max_wait_ms=20.0), devices=devices)
    try:
        check(len(eng.replicas) == 2 and eng.replicas.models[1] is not model,
              "the engine does not hold two replicas")
        K.reset_launch_counts()

        def submit_all(op, payloads):
            futs = [None] * len(payloads)

            def one(i):
                futs[i] = eng.submit(op, payloads[i])
            threads = [threading.Thread(target=one, args=(i,)) for i in range(len(payloads))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return [f.result(timeout=300) for f in futs]

        t0 = time.perf_counter()
        enc = submit_all("encode", list(audio))
        b_enc = eng.stats.snapshot()["batches"]
        got_codes = np.stack([c for _, c in enc])
        wave = np.stack(submit_all("detokenize", list(got_codes)))
        out["wall_s"] = time.perf_counter() - t0
        if dev == "cuda":
            torch.cuda.synchronize()
        b_det = eng.stats.snapshot()["batches"] - b_enc
        out["launches"] = launch_counts(K)
        out["batches"] = (b_enc, b_det)
    finally:
        eng.close()
    n_blocks = spec.backbone.num_layers
    front = int("front" in model.params["encoder"][0])   # the front kernel serves it
    want = {"vq_nearest": 2 * b_enc, "encoder_front": 2 * front * b_enc,
            "convnext_block": 2 * n_blocks * b_det}
    out["flips"] = int((got_codes != codes_d).sum())
    out["n_ids"] = int(codes_d.size)
    out["wave_rel"] = float(np.abs(wave - wave_d).max() / np.abs(wave_d).max())
    check(out["launches"] == want, f"engine launches {out['launches']}, expected {want} "
          f"(two replicas, {b_enc} encode and {b_det} detokenize batches)")
    check(out["flips"] <= max_flips(out["n_ids"]), f"engine codes: {out['flips']} flips")
    check(out["wave_rel"] <= SAME_CARD_WAVE_TOL, f"engine waveform rel {out['wave_rel']:.3g}")

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "model.ckpt")
        save_torch_checkpoint(ckpt, wavtokenizer_state_dict(
            params_np, spec.seanet, spec.backbone, head_n_fft=spec.head.n_fft))
        wavs = os.path.join(d, "wavs")
        os.makedirs(wavs)
        for i in range(EXTRACT_FILES):
            y = _speech_like(spec.sample_rate, T + 2400 * i, seed=40 + i)
            wavfile.write(os.path.join(wavs, f"f{i}.wav"), spec.sample_rate,
                          (np.clip(y, -1, 1) * 32767).astype(np.int16))
        runs = {}
        t0 = time.perf_counter()
        for name, devs in (("one", devices[:1]), ("two", devices)):
            runs[name] = subprocess.Popen(
                [sys.executable, "-m", "wavtokenizer_tpu_torch.tools.extract_features",
                 "--config", os.path.join(root, TRAIN_CONFIG), "--ckpt", ckpt, "--input", wavs,
                 "--out-dir", os.path.join(d, name), "--device", dev, "--devices",
                 ",".join(devs), "--batch-size", "4", "--codes"],
                cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, p in runs.items():
            so, se = p.communicate(timeout=600)
            check(p.returncode == 0, f"extract_features --devices ({name}) failed:\n{se[-3000:]}")
            runs[name] = so
        out["extract_s"] = time.perf_counter() - t0
        out["extract_head"] = runs["two"].splitlines()[0]
        feat_rel, code_flips = 0.0, 0
        for i in range(EXTRACT_FILES):
            a, b = (np.load(os.path.join(d, n, f"f{i}_features.npy")) for n in ("two", "one"))
            feat_rel = max(feat_rel, float(np.abs(a - b).max() / np.abs(b).max()))
            a, b = (np.load(os.path.join(d, n, f"f{i}_codes.npy")) for n in ("two", "one"))
            code_flips += int((a != b).sum())
        out["extract_feat_rel"], out["extract_flips"] = feat_rel, code_flips
        out["extract_ids"] = EXTRACT_FILES * int(T // spec.hop_length)
    check(out["extract_feat_rel"] <= 1e-4, f"extraction two replicas vs one: features rel "
          f"{out['extract_feat_rel']:.3g}")
    check(out["extract_flips"] <= max_flips(out["extract_ids"]),
          f"extraction two replicas vs one: {out['extract_flips']} code flips")
    return out


def tp_shards_phase(K, block: dict, T_frames: int, dev: str = "cuda") -> dict:
    """(d) The ConvNeXt kernel on tensor-parallel slices of the hidden
    width, at the timing batch's shape: the slices' outputs summed against
    the whole kernel and the plain block, and the slices' launch chains
    timed against the whole kernel."""
    from wavtokenizer_tpu_torch.utils.profiling import convnext_bound

    C, I = block["w1"].shape
    gen = torch.Generator().manual_seed(20)
    x = torch.randn(TIMING_BATCH, T_frames, C, generator=gen).to(dev)
    scale, shift = block["adanorm"]["scale"][0], block["adanorm"]["shift"][0]
    common = (x, block["dw"], block["dwb"], scale, shift)
    whole_args = common + (block["w1"], block["b1"], block["w2"], block["b2"], block["gamma"],
                           block["w1t"], block["w2t"])
    zeros_x, zeros_b2 = torch.zeros_like(x), torch.zeros_like(block["b2"])
    M = TIMING_BATCH * T_frames
    with torch.inference_mode():
        whole = K.convnext_block(*whole_args)
        plain = K.convnext_block_reference(*whole_args[:10])
        update = float((plain - x).abs().max())
        out = {"M": M, "C": C, "I": I, "whole_ms": cuda_ms(lambda: K.convnext_block(*whole_args),
                                                           20)}
        out["whole_bound_ms"] = convnext_bound(M, C, I)[0]
        rows = []
        for n in TP_SHARDS:
            w = I // n
            shards = []
            for r in range(n):
                s = slice(r * w, (r + 1) * w)
                shards.append(common + (
                    block["w1"][:, s].contiguous(), block["b1"][s].contiguous(),
                    block["w2"][s].contiguous(), block["b2"] if r == 0 else zeros_b2,
                    block["gamma"], block["w1t"][s].contiguous(), block["w2t"][:, s].contiguous(),
                    None if r == 0 else zeros_x))
            chains = lambda: [K.convnext_block(*a) for a in shards]
            K.reset_launch_counts()
            got = sum(chains())
            if dev == "cuda":
                torch.cuda.synchronize()
            launches = K.convnext_block.launches
            err_whole = float((got - whole).abs().max())
            err_plain = float((got - plain).abs().max())
            rows.append({"shards": n, "I_shard": w, "launches": launches,
                         "ms": cuda_ms(chains, 20),
                         "bound_ms": n * convnext_bound(M, C, w)[0],
                         "max_abs_err": max(err_whole, err_plain),
                         "rel_whole": err_whole / update, "rel_plain": err_plain / update})
            check(launches == n, f"TP {n} shards launched {launches} chains")
            check(rows[-1]["rel_whole"] < 1e-2 and rows[-1]["rel_plain"] < 1e-2,
                  f"TP {n} shards: rel err {rows[-1]['rel_whole']:.3g} (whole kernel), "
                  f"{rows[-1]['rel_plain']:.3g} (plain)")
    out["rows"] = rows
    return out


# [18]: the VQ's training statistics without float atomics.  (a) The
# segment-sum kernels at the training shape (9000 rows = 40 x 3 s of
# small-320 frames, 4096 codes of 512) with skewed ids (every row to code
# 573), spread ids (uniform), mixed ids (60% to one code, the rest spread
# over every third code) and the training path's own (from [12] (c): the
# k-means iteration of median fullest code, and a later step's EMA): equal
# to index_add_ on the CPU and to their own second launch, bit for bit;
# timed beside the bound, the chain floor, the plain version on the card
# (zeros + index_add_, float atomics) and index_add_ alone, each kernel
# alone from one trace of SEGMENT_REPS calls (which must hold one event of
# each a call and no sort), and the wrapper's host time.  (b) The YAML's step from
# one state past its first step, twice, under repeatable_steps (cuDNN's
# deterministic algorithms): metrics, gradients, weights and VQ state equal (0).
SEGMENT_SHAPE = (9000, 4096, 512)
SEGMENT_REPS = 10


def _sm_max_mhz() -> float:
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return float(res.stdout.strip().splitlines()[0])


SEGMENT_KERNELS = ("segment_order_kernel", "segment_sum_kernel")
TRACE_PROBES = 10           # (a): traces taken bare and after the warm-up


def _segment_events(by_name: dict, key: str) -> list:
    return [v for name, v in by_name.items() if key in name]


def _segment_complete(by_name: dict) -> bool:
    """Whether a trace of SEGMENT_REPS calls holds every launch of both
    kernels."""
    return all(sum(n for _, n in _segment_events(by_name, key)) == SEGMENT_REPS
               for key in SEGMENT_KERNELS)


def _segment_kernels_traced(K, fn) -> tuple:
    """(order kernel ms, sum kernel ms, profile line) a call, from one trace
    of SEGMENT_REPS calls of fn, which must launch each kernel exactly once a
    call and no sort."""
    split, _ = traced(lambda: [fn() for _ in range(SEGMENT_REPS)], _segment_complete)
    got = {}
    for key in SEGMENT_KERNELS:
        ev = _segment_events(split, key)
        check(len(ev) == 1 and ev[0][1] == SEGMENT_REPS,
              f"{SEGMENT_REPS} segment_sum calls: {key} events {ev}, expected one a call")
        got[key] = ev[0][0] / SEGMENT_REPS
    sorts = [name for name in split if "sort" in name.lower()]
    check(not sorts, f"segment_sum: the trace holds sort kernels {sorts}")
    return got["segment_order_kernel"], got["segment_sum_kernel"], kernel_lines(split, 8)


def _host_ms(fn, n: int = 20) -> float:
    """Host time of one call of fn: n calls queued back to back, the clock
    stopped before the card is waited on."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def determinism_phase(K, dev: str = "cuda", real_ids: dict | None = None) -> dict:
    import wavtokenizer_tpu_torch.train.step as S
    from wavtokenizer_tpu_torch.models.wavtokenizer import repeatable_steps
    from wavtokenizer_tpu_torch.train.trainer import step_generator
    from wavtokenizer_tpu_torch.utils.profiling import segment_chain_ms, segment_sum_bound

    N, C, D = SEGMENT_SHAPE
    rng = np.random.default_rng(18)
    # Rows of very different scales, so that any other order of the adds
    # shows in the rounding.
    rows = torch.as_tensor((rng.normal(size=(N, D)) * 10.0 ** rng.uniform(-3, 3, size=(N, 1)))
                           .astype(np.float32))
    mixed = rng.choice(np.arange(0, C, 3), N)
    mixed[rng.random(N) < 0.6] = C // 2
    out = {"N": N, "C": C, "D": D, "ids": {}}
    out["bound_ms"], out["bound_by"] = segment_sum_bound(N, C, D)
    out["sm_mhz"] = _sm_max_mhz() if dev == "cuda" else 1980.0
    out["codes_per_block"] = K.segment_launch_plan(C, D, torch.device(dev))
    kinds = [("skewed", torch.full((N,), 573)),
             ("spread", torch.as_tensor(rng.integers(0, C, N))),
             ("mixed", torch.as_tensor(mixed))]
    for kind, ids in (real_ids or {}).items():
        check(ids.shape == (N,), f"{kind} ids of the training path: {tuple(ids.shape)}")
        kinds.append((kind, ids))
    for kind, ids in kinds:
        want = K.segment_sum_reference(rows, ids, C)
        x, i = rows.to(dev), ids.to(dev)
        a, b = K.segment_sum(x, i, C), K.segment_sum(x, i, C)
        atomics = K.segment_sum_reference(x, i, C)
        if dev == "cuda":
            torch.cuda.synchronize()
        r = {"cpu_equal": torch.equal(a.cpu(), want), "repeat_equal": torch.equal(a, b),
             "max_abs_err": float((a.cpu() - want).abs().max()),
             "plain_card_err": float((atomics.cpu() - want).abs().max()),
             "chain_ms": segment_chain_ms(int(torch.bincount(ids).max()), out["sm_mhz"])}
        check(r["cpu_equal"], f"segment_sum {kind}: differs from index_add_ on the CPU by "
                              f"{r['max_abs_err']:.3g}")
        check(r["repeat_equal"], f"segment_sum {kind}: two launches differ")
        # Timed as the training path calls it, with the ids' counts at hand
        # (k-means and the EMA compute them anyway): the order kernel and the
        # sum kernel, nothing read back.
        zeros, counts = torch.zeros(C, D, device=dev), torch.bincount(i, minlength=C)
        r["ms"] = cuda_ms(lambda: K.segment_sum(x, i, C, counts), 20)
        r["host_ms"] = _host_ms(lambda: K.segment_sum(x, i, C, counts))
        r["max_count"], r["codes_used"] = int(counts.max()), int((counts > 0).sum())
        r["plain_ms"] = cuda_ms(lambda: K.segment_sum_reference(x, i, C), 20)
        r["library_ms"] = cuda_ms(lambda: zeros.index_add_(0, i, x), 20)
        if kind == "skewed":
            reps = lambda: [K.segment_sum(x, i, C, counts) for _ in range(SEGMENT_REPS)]
            out["trace_loss"] = {w: sum(not _segment_complete(_trace_once(reps, w)[2])
                                        for _ in range(TRACE_PROBES))
                                 for w in (0, TRACE_WARMUP)}
        r["order_kernel_ms"], r["kernel_ms"], r["profile"] = _segment_kernels_traced(
            K, lambda: K.segment_sum(x, i, C, counts))
        out["ids"][kind] = r
    del rows, x, i, a, b, atomics, zeros, counts

    spec, tcfg, data, _ = _train_yaml()
    B, T = data.batch_size, data.num_samples
    audio = torch.as_tensor((np.random.default_rng(19).normal(size=(B, T)) * 0.1)
                            .astype(np.float32)).to(dev)
    base = S.create_train_state(spec, tcfg, seed=0, device=dev)
    S.train_step(base, audio, spec, tcfg, step_generator(0, 0))
    with repeatable_steps():
        check(not torch.are_deterministic_algorithms_enabled(),
              "torch.use_deterministic_algorithms is on")
        runs, out["step_launches"] = [], []
        for _ in range(2):
            K.reset_launch_counts()
            runs.append(S.train_step(_copy_state(S, base, tcfg), audio, spec, tcfg,
                                     step_generator(0, 1), with_grad_norm=True))
            out["step_launches"].append(K.segment_sum.launches)
    out["B"], out["T"] = B, T
    out["repeat"] = _step_diff(runs[1], runs[0])
    check(out["step_launches"] == [2, 2], f"segment_sum launches {out['step_launches']}")
    check(all(v == 0 for v in out["repeat"].values()),
          f"the step against its repeat: {out['repeat']} (expected 0)")
    return out


# [19]: the VQ's effective_expiry at the training shape.  The rows are
# EXPIRY_POINTS integer points in [-8, 8]^512, each repeated: every product,
# sum and distance of k-means is then an exact integer in fp32 (and in the
# kernel's 3xTF32), so equal codes are exact ties on both devices (the lowest
# index wins) and no other distance comes near a tie; the random encoder's
# rows cannot hold the card's ids to the CPU's ([12] (b)).
EXPIRY_POINTS = 2048
EXPIRY_SEED = 23


def expiry_phase(K) -> dict:
    """Phase 19: one ``vq_train_forward(effective_expiry=True)`` of the
    small-320 YAML's VQ (4096 x 512, k-means 200 iterations, threshold 2,
    decay 0.99) from an un-inited layer at 40 x 225 frames (N = 9000), on the
    card and on the CPU from generators of one seed; on the card also
    without the option.  The ids equal the CPU's, the state within 1e-5 of
    each tensor's largest magnitude; the expired codes' ``embed_avg`` rows
    are ``decay * replacement + (1 - decay) * embed_sum`` (the replacement
    the generator's second draw, after k-means'); without the option the
    ids, quantized rows and commitment loss are the same bit for bit."""
    from wavtokenizer_tpu_torch.train.vq_train import sample_indices, vq_train_forward

    spec, _, data, _ = _train_yaml()
    cfg = spec.vq
    B, T = data.batch_size, data.num_samples // spec.hop_length
    N, C, D = B * T, cfg.bins, cfg.dimension
    rng = np.random.default_rng(19)
    points = rng.integers(-8, 9, size=(EXPIRY_POINTS, D)).astype(np.float32)
    x = torch.from_numpy(points[rng.integers(0, EXPIRY_POINTS, N)].reshape(B, T, D))
    params = {"embed": torch.zeros(1, C, D), "embed_avg": torch.zeros(1, C, D),
              "cluster_size": torch.zeros(1, C), "inited": torch.zeros(1, 1)}
    out = {"N": N, "C": C, "D": D, "threshold": cfg.threshold_ema_dead_code,
           "decay": cfg.decay, "kmeans_iters": cfg.kmeans_iters}
    runs = {}
    for name, dev, flag in (("card", "cuda", True), ("card, off", "cuda", False),
                            ("cpu", "cpu", True)):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        q, codes, commit, new = vq_train_forward(
            {k: v.to(dev) for k, v in params.items()}, cfg, x.to(dev),
            generator=torch.Generator().manual_seed(EXPIRY_SEED), effective_expiry=flag)
        if dev == "cuda":
            torch.cuda.synchronize()
            out.setdefault("launches", {})[name] = {"vq_nearest": K.vq_nearest.launches,
                                                    "segment_sum": K.segment_sum.launches}
        out.setdefault("s", {})[name] = time.perf_counter() - t0
        runs[name] = (q.cpu(), codes.cpu(), commit.cpu(), {k: v.cpu() for k, v in new.items()})
    (q, codes, commit, new), cpu = runs["card"], runs["cpu"]
    ids = codes.reshape(-1).long()
    # An un-inited layer's ids are k-means' last assignment, so its counts
    # are the ones the expiry reads.
    expired = torch.bincount(ids, minlength=C) < cfg.threshold_ema_dead_code
    g = torch.Generator().manual_seed(EXPIRY_SEED)
    sample_indices(N, C, g)                                # k-means' draw
    x_flat = x.reshape(N, D)
    rows = x_flat[sample_indices(N, C, g)]
    embed_sum = torch.zeros(C, D).index_add_(0, ids, x_flat)
    want = rows * cfg.decay + embed_sum * (1 - cfg.decay)
    got = new["embed_avg"][0]
    out["expired"] = int(expired.sum())
    out["codes_used"] = int((torch.bincount(ids, minlength=C) > 0).sum())
    out["expired_rows_err"] = float((got[expired] - want[expired]).abs().max())
    out["id_flips"] = int((codes != cpu[1]).sum())
    out["state_rel"] = {k: float((v - cpu[3][k]).abs().max())
                        / max(float(cpu[3][k].abs().max()), 1e-30) for k, v in new.items()}
    off = runs["card, off"]
    out["off_equal"] = {"ids": torch.equal(codes, off[1]), "quantized": torch.equal(q, off[0]),
                        "commit": torch.equal(commit, off[2])}
    out["off_state_differs"] = not torch.equal(new["embed_avg"], off[3]["embed_avg"])
    check(out["expired"] > 0, "effective_expiry: no code expired")
    check(out["id_flips"] == 0, f"effective_expiry: {out['id_flips']} ids differ from the CPU's")
    check(max(out["state_rel"].values()) <= 1e-5,
          f"effective_expiry: state card vs CPU {out['state_rel']} (limit 1e-5)")
    check(out["expired_rows_err"] == 0.0,
          f"effective_expiry: expired embed_avg rows off decay * replacement + (1 - decay) * "
          f"embed_sum by {out['expired_rows_err']:.3g}")
    check(all(out["off_equal"].values()) and out["off_state_differs"],
          f"effective_expiry against the forward without it: {out['off_equal']}, state differs "
          f"{out['off_state_differs']}")
    for name in ("card", "card, off"):
        want_launches = {"vq_nearest": cfg.kmeans_iters + 1, "segment_sum": cfg.kmeans_iters + 1}
        check(out["launches"][name] == want_launches,
              f"{name}: launches {out['launches'][name]}, expected {want_launches}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing to run")
        return 1
    try:
        from wavtokenizer_tpu_torch import WavTokenizer, init_wavtokenizer
        from wavtokenizer_tpu_torch.models import quantize, seanet, vocos
        from wavtokenizer_tpu_torch.models.seanet import encoder_layer_specs
        from wavtokenizer_tpu_torch.models.wavtokenizer import full_fp32
        from wavtokenizer_tpu_torch.ops import kernels as K
        from wavtokenizer_tpu_torch.utils.golden import (check_codes, golden_clip,
                                                         golden_specs, load_golden,
                                                         max_flips, nearest_two)
        from wavtokenizer_tpu_torch.utils.profiling import (FRONT_FP32_MACS_PER_SAMPLE,
                                                            FRONT_TF32_MACS_PER_SAMPLE, H100,
                                                            convnext_bound, front_bound_of,
                                                            vq_bound_of)
    except ImportError as e:
        log(f"chip_smoke: the wavtokenizer_tpu_torch package is not importable ({e})")
        return 1

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # -- 1. environment ---------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 env] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}; TF32 off for matmul and cuDNN")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    K.load_library()
    log(f"[2 build] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {K.build_seconds if K.build_seconds is not None else 'cached'} s)")

    # -- 3. kernel parity at the main path's shapes -----------------------
    small320 = golden_specs()["small320"]
    params_np = init_wavtokenizer(small320, seed=0, random_codebook=True)
    model = WavTokenizer.from_jax_params(params_np, small320, device="cuda")
    embed = model.params["quantizer"]["embed"][0]
    esq = model.params["quantizer"]["esq"][0]
    pack = model.params["quantizer"]["pack"][0]
    gen = torch.Generator(device="cpu").manual_seed(0)
    vq_err = 0.0
    T_frames = int(TIMING_SECONDS * small320.sample_rate) // small320.hop_length
    for n in (TIMING_BATCH * T_frames, 1801):
        x = (torch.randn(n, embed.shape[1], generator=gen) * 0.1).to(dev)
        got = K.vq_nearest(x, embed, esq, pack)
        want = K.vq_nearest_reference(x, embed, esq)
        torch.cuda.synchronize()
        flips = int((got != want).sum())
        vq_err = max(vq_err, vq_distance_gap(x, embed, got, want))
        check(flips <= max_flips(n), f"vq_nearest N={n}: {flips} flips")
        log(f"[3 parity] vq_nearest N={n}: {flips} flips vs plain (limit {max_flips(n)})")

    block = model.params["backbone"]["convnext"][0]
    C, I = block["w1"].shape
    cnx_err = 0.0
    for adanorm in (True, False):
        g = lambda *s, sc=0.1: (torch.randn(*s, generator=gen) * sc).to(dev)
        x = g(8, T_frames, C, sc=1.0)
        scale, shift = (1 + g(4, C))[2], g(4, C)[2]
        if not adanorm:
            scale, shift = 1 + g(C), g(C)
        args = (x, g(7, C), g(C), scale.contiguous(), shift.contiguous(),
                g(C, I, sc=0.02).to(torch.bfloat16), g(I), g(I, C, sc=0.02).to(torch.bfloat16),
                g(C), g(C, sc=0.3))
        got = K.convnext_block(*args)
        want = K.convnext_block_reference(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel_out = err / float(want.abs().max())
        rel_update = err / float((want - x).abs().max())
        cnx_err = max(cnx_err, err)
        check(rel_out < 1e-2 and rel_update < 1e-2,
              f"convnext_block adanorm={adanorm}: rel err {rel_out:.3g} / {rel_update:.3g}")
        log(f"[3 parity] convnext_block B=8 T={T_frames} C={C} I={I} adanorm={adanorm}: "
            f"max abs err {err:.3g}, over max |out| {rel_out:.3g}, "
            f"over max |out - x| {rel_update:.3g}")

    # Kernel 3 at the main path's lengths (the golden small-320 and music-16k
    # clips), the shortest length the gate admits (a last tile of 4 of the
    # 62 frames a block owns), and a length that leaves a partial last tile
    # (T/8 = 1028 = 16*62 + 36).
    enc_p, enc_specs = model.params["encoder"], encoder_layer_specs(small320.seanet)
    front_err = 0.0
    clips = [torch.as_tensor(golden_clip(s))[:, :, None]
             for s in (small320, golden_specs()["music16k"])]
    clips += [torch.randn(2, T, 1, generator=gen) * 0.1 for T in (1024, 8224)]
    for a in clips:
        a = a.to(dev)
        B, T, _ = a.shape
        with full_fp32():
            got = K.encoder_front(a, enc_p, enc_specs)
            want = K.encoder_front_reference(a, enc_p, enc_specs)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        front_err = max(front_err, err)
        check(rel < 1e-5, f"encoder_front B={B} T={T}: rel err {rel:.3g}")
        log(f"[3 parity] encoder_front B={B} T={T}: max abs err {err:.3g}, "
            f"over max |out| {rel:.3g} (limit 1e-5)")
    before = K.encoder_front.launches
    with torch.inference_mode(), full_fp32():
        seanet.seanet_encode(enc_p, small320.seanet, torch.zeros(2, 72004, 1, device=dev))
    check(K.encoder_front.launches == before, "encoder_front launched for T % 8 != 0")
    log("[3 parity] encoder_front: not launched for T=72004 (T % 8 != 0)")

    # -- 4. golden gate on the card ---------------------------------------
    # The library's gate (utils/golden.py::check_codes): each config's model
    # built on the card from seed 0, the golden clip encoded, its codes held
    # to the committed ones (shape, and at most max_flips(n) differing ids).
    golden = load_golden()
    for label in golden_specs():
        n = golden[label].size
        before = K.encoder_front.launches
        try:
            flips = check_codes(label, max_flips=max_flips(n), device="cuda")
        except RuntimeError as e:
            raise PhaseFailed(str(e)) from e
        front = K.encoder_front.launches - before
        check(front == (0 if label == "small600" else 1),
              f"{label}: encoder_front launched {front} times")
        log(f"[4 golden] {label}: check_codes on the card: {flips} of {n} ids differ from "
            f"tests/golden/bench_tokens.npz (limit {max_flips(n)}); "
            f"front kernel {'launched' if front else 'not launched (geometry)'}")

    # -- 5. the main path on the card, against the CPU --------------------
    clip = golden_clip(small320)
    K.reset_launch_counts()
    feats, codes = model.encode_infer(clip)
    wave = model.decode(model.codes_to_features(codes), bandwidth_id=0)
    torch.cuda.synchronize()
    launches = launch_counts(K)
    n_blocks = small320.backbone.num_layers
    check(launches == {"vq_nearest": 1, "convnext_block": n_blocks, "encoder_front": 1},
          f"kernel launches on the main path: {launches}")
    check(tuple(wave.shape) == clip.shape and bool(torch.isfinite(wave).all()),
          f"waveform shape {tuple(wave.shape)} or non-finite values")
    log(f"[5 round trip] small320 B=8 on the card: launches {launches}")

    cpu = WavTokenizer.from_jax_params(params_np, small320, device="cpu")
    _, codes_cpu = cpu.encode_infer(clip)
    flips = int((codes.cpu() != codes_cpu).sum())
    check(flips <= max_flips(codes.numel()), f"card vs CPU codes: {flips} flips")
    # Both sides decode the card's codes, so the waveform check isolates the
    # decoder: the same bf16-operand arithmetic, summed in another order.  A
    # new order moves an fp32 sum by ~1e-6 relative and at most moves the
    # bf16 rounding of single operands by one step (2^-9), which averages
    # out over 768- and 2304-term sums; 2e-2 sits far above both.
    wave_cpu = cpu.decode(cpu.codes_to_features(codes.cpu()), bandwidth_id=0)
    rel = float((wave.cpu() - wave_cpu).abs().max() / wave_cpu.abs().max())
    check(rel < 2e-2, f"card vs CPU waveform rel-max err {rel:.3g}")
    log(f"[5 round trip] card vs CPU: {flips} code flips (limit "
        f"{max_flips(codes.numel())}); waveform rel-max err {rel:.3g} (limit 2e-2)")

    # -- 6. timing at B=128 x 3 s -----------------------------------------
    audio = torch.as_tensor(np.random.default_rng(1).normal(
        size=(TIMING_BATCH, int(TIMING_SECONDS * small320.sample_rate))).astype(np.float32)
        * 0.1).to(dev)
    p = model.params
    with torch.inference_mode():
        with full_fp32():
            emb = seanet.seanet_encode(p["encoder"], small320.seanet, audio[:, :, None])
            q, c = quantize.vq_infer(p["quantizer"], emb)
        hidden = vocos.vocos_backbone(p["backbone"], small320.backbone, q, bandwidth_id=0)

        def enc():
            with full_fp32():
                seanet.seanet_encode(p["encoder"], small320.seanet, audio[:, :, None])

        def enc_plain_front():
            with full_fp32():
                seanet.seanet_encode(p["encoder"], small320.seanet, audio[:, :, None],
                                     front=False)

        def vq():
            with full_fp32():
                quantize.vq_infer(p["quantizer"], emb)

        stages = {
            "encoder": cuda_ms(enc, 3),
            "encoder (front=False)": cuda_ms(enc_plain_front, 3),
            "vq": cuda_ms(vq, 10),
            "backbone": cuda_ms(lambda: vocos.vocos_backbone(
                p["backbone"], small320.backbone, q, bandwidth_id=0), 5),
            "head": cuda_ms(lambda: vocos.istft_head(p["head"], small320.head, hidden), 10),
        }
        rt_ms = cuda_ms(lambda: model.decode(model.codes_to_features(
            model.encode_infer(audio)[1]), 0), 3)
        rtf = TIMING_BATCH * TIMING_SECONDS / (rt_ms / 1e3)
        log(f"[6 timing] B={TIMING_BATCH} x {TIMING_SECONDS:.0f} s on {card}: stages ms "
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
            + f"; round trip {rt_ms:.3f} ms = {rtf:.1f}x real time")

        # Kernels alone, at the timing batch's shapes, beside their plain versions.
        flat = emb.reshape(-1, emb.shape[-1]).contiguous()
        N, D = flat.shape
        Cb = embed.shape[0]
        # The VQ kernel on the main path's own input (the encoder output of
        # this batch), against its plain version: near-ties only.
        got = K.vq_nearest(flat, embed, esq, pack)
        want = K.vq_nearest_reference(flat, embed, esq)
        torch.cuda.synchronize()
        real_flips = int((got != want).sum())
        real_gap = vq_distance_gap(flat, embed, got, want)
        vq_err = max(vq_err, real_gap)
        check(real_flips <= max_flips(N), f"vq_nearest on the encoder output: {real_flips} flips")
        near, d2 = nearest_two(flat, embed)
        log(f"[6 parity] vq_nearest on the encoder output N={N}: {real_flips} flips vs plain "
            f"(limit {max_flips(N)}; goal 0), largest near-tie gap {real_gap:.3g}; the rows "
            f"take {near[:, 0].unique().numel()} distinct codes, smallest gap between a row's "
            f"two nearest codes {float(((d2[:, 1] - d2[:, 0]) / d2[:, 0]).min()):.3g} relative")
        # Random weights send the encoder output to a few codes, too few to
        # show the kernel's precision; rows just beyond the near-tie
        # tolerance do.
        res = resolution_check(K, embed, esq, pack, N)
        log(f"[6 resolution] {resolution_line(res)}")
        vq_ms = cuda_ms(lambda: K.vq_nearest(flat, embed, esq, pack), 20)
        vq_plain = cuda_ms(lambda: K.vq_nearest_reference(flat, embed, esq), 20)
        vq_bound, vq_by = vq_bound_of(N, Cb, D)
        # Beside it the same work as fp32 FMAs on the CUDA cores.
        vq_fp32_only = 2 * N * Cb * D / H100["fp32"] * 1e3

        xb = (torch.randn(TIMING_BATCH, T_frames, C, generator=gen)).to(dev)
        bargs = (xb, block["dw"], block["dwb"], block["adanorm"]["scale"][0],
                 block["adanorm"]["shift"][0], block["w1"], block["b1"], block["w2"],
                 block["b2"], block["gamma"], block["w1t"], block["w2t"])
        cnx_ms = cuda_ms(lambda: K.convnext_block(*bargs), 20)
        cnx_plain = cuda_ms(lambda: K.convnext_block_reference(*bargs[:10]), 20)
        M = TIMING_BATCH * T_frames
        cnx_bound, cnx_by = convnext_bound(M, C, I)
        # Yardstick only, never called by the port: the two bf16 GEMMs alone
        # through cuBLAS.
        hb = torch.randn(M, C, generator=gen).to(dev, torch.bfloat16)
        gb = torch.randn(M, I, generator=gen).to(dev, torch.bfloat16)
        gemm_ms = cuda_ms(lambda: (hb @ block["w1"], gb @ block["w2"]), 20)
        # Kernel 3 at B=128 x 3 s, against its plain version (cuDNN fp32).
        a3 = audio[:, :, None]
        with full_fp32():
            front_ms = cuda_ms(lambda: K.encoder_front(a3, enc_p, enc_specs), 5)
            front_plain = cuda_ms(lambda: K.encoder_front_reference(a3, enc_p, enc_specs), 5)
        S = audio.numel()
        front_fp32_only = 2 * (FRONT_FP32_MACS_PER_SAMPLE + FRONT_TF32_MACS_PER_SAMPLE) \
            * S / H100["fp32"] * 1e3
        front_bound, front_by = front_bound_of(S, enc_p[0]["front"])
    log(f"[6 timing] encoder_front B={TIMING_BATCH} x {audio.shape[1]}: kernel "
        f"{front_ms:.3f} ms, plain {front_plain:.3f} ms, bound {front_bound:.3f} ms "
        f"({front_by}; {front_fp32_only:.3f} ms were every product an fp32 FMA); "
        f"library: none (no single PyTorch call); card {card}")
    log(f"[6 timing] vq_nearest N={N}: kernel {vq_ms:.3f} ms, plain {vq_plain:.3f} ms, "
        f"bound {vq_bound:.3f} ms ({vq_by}, 3xTF32; {vq_fp32_only:.3f} ms were every product "
        f"an fp32 FMA); convnext_block M={M}: kernel {cnx_ms:.3f} ms, "
        f"plain {cnx_plain:.3f} ms, bound {cnx_bound:.3f} ms; cuBLAS bf16 GEMM pair "
        f"alone {gemm_ms:.3f} ms; card {card}")

    # Per-launch split from a torch.profiler trace: one vq_nearest, one
    # convnext_block and one encoder_front call at the timing shapes, then
    # one round trip.
    with torch.inference_mode():
        split, _ = traced(lambda: K.vq_nearest(flat, embed, esq, pack))
        log(f"[6 profile] vq_nearest N={N}, device time by kernel: "
            f"{kernel_lines(split, 4)}; card {card}")
        split, _ = traced(lambda: K.convnext_block(*bargs))
        log(f"[6 profile] convnext_block M={M}, device time by kernel: "
            f"{kernel_lines(split, 8)}; card {card}")
        with full_fp32():
            split, _ = traced(lambda: K.encoder_front(a3, enc_p, enc_specs))
        log(f"[6 profile] encoder_front B={TIMING_BATCH} x {audio.shape[1]}, device time "
            f"by kernel: {kernel_lines(split, 8)}; card {card}")
        split, idle = traced(lambda: model.decode(model.codes_to_features(
            model.encode_infer(audio)[1]), 0))
    total = sum(ms for ms, _ in split.values())
    log(f"[6 profile] round trip B={TIMING_BATCH} x {TIMING_SECONDS:.0f} s: device busy "
        f"{total:.3f} ms in {sum(n for _, n in split.values())} device ops, idle share "
        f"{idle:.4f}; top: {kernel_lines(split, 12)}; card {card}")

    # -- 7. serving ------------------------------------------------------
    sv = serving_phase(model, small320, K, kind)
    log(f"[7 serving] {sv['requests']} requests (68 encode, 16 detokenize) in "
        f"{sv['wall_s']:.3f} s: {sv['req_per_s']:.1f} requests/s, "
        f"{sv['audio_s_per_s']:.1f} audio-s/s, latency p50 {sv['p50_ms']:.1f} ms "
        f"p99 {sv['p99_ms']:.1f} ms, mean batch occupancy {sv['occupancy']} over "
        f"{sv['batches']} batches (client threads in this process); the same requests "
        f"straight to the engine: {sv['engine_req_per_s']:.1f} requests/s, "
        f"{sv['engine_audio_s_per_s']:.1f} audio-s/s; card {card}")
    log(f"[7 serving] codes: {sv['flips']} of {sv['n_ids']} ids differ from direct "
        f"encode_infer (limit {max_flips(sv['n_ids'])}); detokenized audio rel-max err "
        f"{sv['wave_rel']:.3g} against direct decode (limit {SAME_CARD_WAVE_TOL}); "
        f"4 s clip and malformed body answered 400; launches {sv['launches']}")
    log(f"[7 serving] /detokenize with code {small320.vq.bins} (>= bins) answered 400; "
        f"the 5 requests after it answered 200, detokenized audio rel-max err "
        f"{sv['after_rel']:.3g} against the same codes before it")

    # -- 8. long audio ----------------------------------------------------
    la = long_audio_phase(model, small320, K)
    log(f"[8 long audio] reconstruct_long_batch of {la['seconds']} s in "
        f"{la['wall_s']:.3f} s = {la['rtf']:.1f}x real time; rel-max err against "
        f"reconstruct_long per stream {max(la['rels']):.3g} (limit {SAME_CARD_WAVE_TOL}); "
        f"launches {la['launches']}; card {card}")

    # -- 9. EnCodec 24 kHz and 48 kHz ------------------------------------
    ec = encodec_phase(K)
    log(f"[9 encodec] 24 kHz B=8 x 3 s: launches per encode {ec['launches_per_encode']}; "
        f"kernel chain vs plain on the chain's own residual, flips per layer {ec['flips']} "
        f"(each a near-tie; largest gap {ec['gap']:.3g}); encode vs the same chain replayed "
        f"{ec['same_card']} ids differ; distinct codes layer 0 / 31: {ec['distinct']}")
    log(f"[9 encodec] 24 kHz card vs CPU: codes differing per layer {ec['cpu_layers']} "
        f"(layer 0 limit {max_flips(8 * 225)}, goal 0; later layers reported, not gated); "
        f"waveform from the card's codes rel-max {ec['wave_rel']:.3g} (limit 1e-3)")
    log(f"[9 encodec] 24 kHz B=64 x 3 s on {card}: stages ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in ec["stages"].items())
        + f"; round trip (forward) {ec['rt_ms']:.3f} ms = {ec['rtf']:.1f}x real time; "
        f"idle share {ec['idle']:.4f}; top: {ec['profile']}")
    log(f"[9 encodec] vq_nearest N={ec['N']} C={ec['C']} D={ec['D']} (layer 0): kernel "
        f"{ec['vq_ms']:.4f} ms, plain {ec['vq_plain_ms']:.4f} ms, bound {ec['vq_bound_ms']:.4f} ms "
        f"({ec['vq_bound_by']}, 3xTF32); {ec['vq_flips']} flips vs plain (largest near-tie "
        f"gap {ec['vq_err']:.3g}); 32-layer chain {ec['stages']['rvq (32 layers)'] / 32:.4f} ms "
        f"a layer; card {card}")
    log(f"[9 resolution] {resolution_line(ec['resolution'])}")
    log(f"[9 encodec] 48 kHz stereo B=2 x 3.5 s: {len(ec['seg_frames'])} segments of "
        f"{ec['seg_frames']} frames, {ec['v48']} vq_nearest launches; codes differing from "
        f"the CPU per segment (all layers) {ec['seg_cpu_flips']}; waveform rel-max "
        f"{ec['w48_rel']:.3g} (limit 1e-3); forward {ec['rt48_ms']:.3f} ms; card {card}")

    # -- 10. facade: training-style encode, copy synthesis, SEANet decode --
    fc = facade_phase(model, cpu, small320, K)
    log(f"[10 facade] encode (n_q=1): {fc['encode_diff']} ids differ from encode_infer, "
        f"launches {fc['encode_launches']}; __call__ launches {fc['call_launches']}, "
        f"rel-max {fc['call_rel']:.3g} against decode(encode_infer) (limit {SAME_CARD_WAVE_TOL})")
    log(f"[10 facade] seanet_only_decode card vs CPU rel-max {fc['sod_rel']:.3g} (limit 1e-3); "
        f"B={TIMING_BATCH} x {TIMING_SECONDS:.0f} s {fc['sod_ms']:.3f} ms = "
        f"{TIMING_BATCH * TIMING_SECONDS / (fc['sod_ms'] / 1e3):.1f}x real time; card {card}")

    # -- 11. compress CLI ---------------------------------------------------
    cp = compress_phase(model, small320)
    for name in ("lm", "no-lm"):
        r = cp[name]
        log(f"[11 compress] {name}: {cp['tokens']} tokens -> {r['bytes']} bytes = "
            f"{r['bits_per_token']:.3f} bits/token, ids equal after the round trip, decoded "
            f"audio {r['lsb']} LSB ({r['rel']:.3g} of max; limit {SAME_CARD_WAVE_TOL}) from a "
            f"direct decode at the CLI's precision; subprocess encode {r['encode_s']:.2f} s, "
            f"decode {r['decode_s']:.2f} s")
    log(f"[11 compress] LM coding in this process: compress {cp['lm_compress_s']:.3f} s, "
        f"decompress {cp['lm_decompress_s']:.3f} s for {cp['tokens']} tokens (per-step, "
        f"host-bound); card {card}")

    # -- 12. training -----------------------------------------------------
    tr = train_card_vs_cpu(K)
    log(f"[12 train] (a) small-320 full generator width, discriminators 1/8, B=2 x 1 s, "
        f"bandwidth 1, no dropout, card vs CPU (TF32 off, fp32 on both): first-step k-means "
        f"({tr['kmeans_iters']} iterations) codes {tr['kmeans_flips']} of {tr['kmeans_rows']} "
        f"differ (near-ties only; largest gap {tr['kmeans_gap']:.3g}), means rel-max "
        f"{tr['kmeans_means_rel']:.3g}; losses rel-max {tr['loss_rel']:.3g} ({tr['worst']}; "
        f"limit 1e-3), grad norm rel {tr['grad_norm_rel']:.3g} (limit 1e-3), VQ state rel-max "
        f"{tr['vq_rel']:.3g} (limit 1e-4); vq_nearest launches {tr['launches']}, segment_sum "
        f"{tr['seg_launches']}; card {card}")
    tt = train_timing(K)
    log(f"[12 train] (b) vq_nearest at k-means' shape N={tt['N']} (encoder output of "
        f"{tt['B']} x {tt['T']}) C={tt['C']} D={tt['D']}, means drawn with replacement: "
        f"{tt['vq_flips']} ids differ from plain (near-ties only; largest gap "
        f"{tt['vq_gap']:.3g}); {tt['dup_rows']} rows with exact copies among the means, "
        f"{tt['dup_not_lowest']} not given the lowest copy (same as plain), on rows centred by "
        f"their mean; on the uncentred rows, rows off the float64 nearest code: kernel "
        f"{tt['raw_wrong']['kernel']}, plain {tt['raw_wrong']['plain']} (kernel no worse); "
        f"kernel with the "
        f"per-call pack {tt['vq_ms']:.4f} ms, plain {tt['vq_plain_ms']:.4f} ms, bound "
        f"{tt['vq_bound_ms']:.4f} ms ({tt['vq_bound_by']}, 3xTF32); card {card}")
    audio_s = tt["B"] * tt["T"] / small320.sample_rate
    mean_ms = float(np.mean(tt["step_ms"]))
    log(f"[12 train] (c) {TRAIN_CONFIG}, B={tt['B']} x {tt['T']} samples, discriminators at "
        f"full width, TF32 off: first step (k-means {tt['kmeans_iters']} iterations) "
        f"{tt['first_ms']:.1f} ms; steps " + ", ".join(f"{t:.1f}" for t in tt["step_ms"])
        + f" ms (mean {mean_ms:.1f} ms = {audio_s / (mean_ms / 1e3):.2f} audio-s/s); phases "
        f"alone: discriminator {tt['disc_ms']:.1f} ms, generator {tt['gen_ms']:.1f} ms "
        f"({tt['disc_ms'] / (tt['disc_ms'] + tt['gen_ms']):.3f} / "
        f"{tt['gen_ms'] / (tt['disc_ms'] + tt['gen_ms']):.3f}); peak memory "
        f"{tt['peak_gb']:.2f} GB (max_memory_allocated); vq_nearest launches first step "
        f"{tt['launches_first']}, later steps {tt['launches_per_step']}; segment_sum first step "
        f"{tt['seg_launches_first']}, later steps {tt['seg_launches_per_step']}; card {card}")
    log(f"[12 train] (c) losses: first step " + ", ".join(
        f"{k} {v:.4g}" for k, v in tt["first_metrics"].items()) + "; last timed step "
        + ", ".join(f"{k} {v:.4g}" for k, v in tt["metrics"].items()))
    si, iters = tt["seg_ids"], tt["kmeans_iters"]
    km = si["k-means"]
    log(f"[12 train] (c) segment_sum ids, (rows on the fullest code, codes in use) of "
        f"{tt['N']} rows over {tt['C']} codes: first step, k-means iteration 1 {km['first']}, "
        f"{iters} {km['last']}, {km['median_iter']} (the median fullest code) {km['median']}, "
        f"over the {iters} iterations the fullest code min/median/max {km['max_count']} and "
        f"codes in use {km['codes_used']}; the EMA (discriminator, generator phase) on the "
        f"first step {si['EMA first step']}, on a later step {si['EMA later step']}")
    log(f"[12 profile] one training step B={tt['B']}: device busy {tt['busy_ms']:.1f} ms in "
        f"{tt['ops']} device ops, idle share {tt['idle']:.4f}; top: {tt['profile']}; card {card}")
    torch.cuda.empty_cache()
    tc = train_cli_phase(small320)
    log(f"[12 train] (d) tools.train fit --max-batches 3 on 8 WAVs x 3.5 s, batch 8 "
        f"(subprocesses, PyTorch's default precision; the run, its repeat from the same seed "
        f"and a 2-batch run at once in {tc['cli_s'][0]:.1f} s, then the 2-batch run resumed to "
        f"3 in {tc['cli_s'][1]:.1f} s; loader {tc['loader']}): last.pt of the repeat equal to "
        f"the run's bit for bit ({tc['repeat']['equal']}, {tc['repeat']['leaves']} leaves), of "
        f"the resumed run ({tc['resumed']['equal']}, {tc['resumed']['leaves']} leaves); "
        f"{tc['rows']} metrics row(s), step 0 gen_total {tc['row0']['gen_total']:.4g}, checkpoint "
        f"{tc['ckpt_gb']:.2f} GB; from_train_checkpoint vs its Lightning export through "
        f"from_pretrained0828: {tc['trained_vs_0828']} of {tc['n_ids']} ids differ; the export "
        f"on the card vs the CPU: {tc['card_vs_cpu']} differ (limit {max_flips(tc['n_ids'])}; "
        f"{tc['distinct']} distinct codes); card {card}")

    # -- 13. plain Vocos at the vocos-mel-24khz width ----------------------
    vc = vocos_phase(K)
    log(f"[13 vocos] {VOCOS_CONFIG} from init_vocos(seed=0), B=8 x 3 s: launches "
        f"{vc['launches']}; features card vs CPU rel-max {vc['feat_rel']:.3g} (limit 1e-4); "
        f"waveform card vs CPU rel-max {vc['wave_rel']:.3g} (limit {VOCOS_WAVE_TOL}); "
        f"convnext_block on the trunk's own input vs plain: max abs err {vc['cnx_err']:.3g}, "
        f"over max |out - x| {vc['cnx_rel_update']:.3g} (limit 1e-2)")
    log(f"[13 vocos] B={TIMING_BATCH} x {TIMING_SECONDS:.0f} s: clips 0-7 of the decode card vs "
        f"CPU rel-max {vc['wave_rel_t']:.3g} (limit {VOCOS_WAVE_TOL}); convnext_block on this "
        f"batch's first-block input vs plain: max abs err {vc['cnx_err_t']:.3g}, over max "
        f"|out - x| {vc['cnx_rel_update_t']:.3g} (limit 1e-2)")
    log(f"[13 vocos] B={TIMING_BATCH} x {TIMING_SECONDS:.0f} s on {card}: stages ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in vc["stages"].items())
        + f"; forward {vc['rt_ms']:.3f} ms = {vc['rtf']:.1f}x real time; "
        f"{vc['launches']['convnext_block']} convnext_block launches a decode; device busy {vc['busy_ms']:.3f} ms, idle share "
        f"{vc['idle']:.4f}; top: {vc['profile']}")
    log(f"[13 vocos] convnext_block M={vc['M']} C={vc['C']} I={vc['I']}: kernel "
        f"{vc['ms']:.4f} ms, plain {vc['plain_ms']:.4f} ms, bound {vc['bound_ms']:.4f} ms "
        f"({vc['bound_by']}); cuBLAS bf16 GEMM pair alone {vc['gemm_ms']:.4f} ms; card {card}")
    log("[13 vocos] resnet trunk dim 512, frame 512, B=2 x 3 s, card vs CPU rel-max: "
        + ", ".join(f"{k} {v:.3g}" for k, v in vc["resnet"].items()) + " (limit 1e-3)")

    # -- 14. metrics CLI on the card against the CPU ----------------------
    mt = metrics_phase(model, small320, K)
    log(f"[14 metrics] small-320 round trip of 4 clips x 2 s on the card (launches "
        f"{mt['launches']}); tools/metrics_infer.py with CREPE full and UTMOS (12 layers) "
        f"from seeded random state dicts: --device cuda {mt['cli_cuda_s']:.1f} s, --device cpu "
        f"{mt['cli_cpu_s']:.1f} s (subprocesses); numpy metrics equal; card vs CPU worst "
        + ", ".join(f"{k} {v:.3g} ({METRICS_LIMITS[k][0]} limit {METRICS_LIMITS[k][1]})"
                    for k, v in mt["worst"].items()))
    log(f"[14 metrics] decoded RMS over the reference's (before level matching): "
        + ", ".join(f"{g:.3g}" for g in mt["gain"]) + "; UTMOS per file card / CPU: "
        + ", ".join(f"{g:.6g} / {w:.6g}" for g, w in mt["utmos_files"])
        + f"; CREPE salience card vs CPU max abs err {mt['sal_err']:.3g} over its "
        f"input-dependent part {mt['sal_spread']:.3g} = {mt['sal_err'] / mt['sal_spread']:.3g} "
        f"(limit {SALIENCE_TOL})")
    log(f"[14 metrics] summary (card): " + ", ".join(
        f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}" for k, v in mt["summary"].items()))
    log(f"[14 metrics] on {card}, {mt['audio_s']:.1f} audio s at 16 kHz: CREPE "
        f"{mt['crepe_s_per_s']:.4f} s per audio s (net alone {mt['crepe_net_s_per_s']:.4f}), "
        f"UTMOS {mt['utmos_s_per_s']:.4f} s per audio s")

    # -- 15. the research layer -------------------------------------------
    rs = research_phase(K)
    audio_s = rs["B"] * rs["T"] / small320.sample_rate
    for train, r in rs["fwd"].items():
        log(f"[15 research] (a) enhanced_forward B={rs['B']} x {rs['T']} train={train}: "
            f"encoder_front launches {r['launches']}; card vs CPU rel-max: enhanced features "
            f"{r['enhanced']:.3g}, input features {r['features']:.3g}"
            + (f", BN running state {r['state']:.3g}" if "state" in r else "")
            + f" (limit {ENHANCE_FEATURE_TOL}), waveform {r['wave']:.3g} (limit {ENHANCE_WAVE_TOL})")
    log(f"[15 research] (a) encoder_front on this batch's audio vs plain: max abs err "
        f"{rs['front_err']:.3g}, over max |out| {rs['front_rel']:.3g} (limit 1e-5); kernel "
        f"{rs['front_ms']:.3f} ms, plain {rs['front_plain_ms']:.3f} ms, bound "
        f"{rs['front_bound_ms']:.3f} ms ({rs['front_bound_by']}); card {card}")
    for mode, r in rs["steps"].items():
        log(f"[15 research] (b) enhance_step {mode} B=2 x 24000, card vs CPU from one state: "
            f"encoder_front launches {r['launches']}; loss {r['loss']:.5g}, rel {r['loss_rel']:.3g} "
            f"(limit 1e-3); grad norm rel {r['grad_norm_rel']:.3g} (limit "
            f"{r['grad_norm_limit']:.3g}; the CPU against itself for a 1e-7 relative input "
            f"change {r['cpu_self_grad_norm_rel']:.3g})")
    log("[15 research] (b) each step twice from one state under repeatable_steps at PyTorch's "
        "default precision (the CLIs'), against its repeat bit for bit (equal, leaves "
        "compared: trainable trees, BN state, Adam's state, loss, grad norm): " + ", ".join(
            f"{mode} {r[0]} ({r[1]})" for mode, r in rs["repeat"].items())
        + f" (B=2 x 24000 unless stated; byol_step 16 x 64 frames); card {card}")
    log(f"[15 research] (c) waveform-mode enhance_step B={rs['B']} x {rs['T']}: "
        f"{rs['step_ms']:.1f} ms a step over 10 steps after 2 warm-up = "
        f"{audio_s / (rs['step_ms'] / 1e3):.2f} audio-s/s, peak memory {rs['peak_gb']:.2f} GB "
        f"(max_memory_allocated), encoder_front launches a step {rs['step_launches']:.0f}; "
        f"enhance_infer forward (train=False, tanh 1.5) {rs['infer_ms']:.1f} ms = "
        f"{audio_s / (rs['infer_ms'] / 1e3):.1f}x real time; BYOL step 16 x 64 frames x 512 "
        f"{rs['byol_ms']:.2f} ms; card {card}")
    log(f"[15 profile] one waveform-mode enhance_step B={rs['B']}: device busy "
        f"{rs['busy_ms']:.1f} ms in {rs['ops']} device ops, idle share {rs['idle']:.4f}; "
        f"front_kernel in the trace {rs['front_in_trace'][0]:.3f} ms in "
        f"{rs['front_in_trace'][1]} event(s) (the wrapper counts {rs['step_launches']:.0f} "
        f"launch a step); top: {rs['profile']}; card {card}")
    log("[15 research] (d) resample to 24 kHz, B=16 x 10 s, card vs host resample_np: "
        + ", ".join(f"{o} Hz max abs err {r['err']:.3g} in {r['ms']:.3f} ms"
                    for o, r in rs["resample"].items()) + f" (limit 1e-5); card {card}")
    log("[15 research] (e) CLIs as subprocesses with --device cuda, all exit 0, in two "
        "concurrent waves (enhance_train waveform 3 steps, byol_train --features-dir 5 steps, "
        "lowpass; then enhance_infer on two 7 s files and enhance_train --mode byol) of "
        + " and ".join(f"{v:.1f} s" for v in rs["cli_waves_s"])
        + f"; enhance_train --mode byol --byol-ckpt loaded {rs['byol_leaves']} leaves; lowpass "
        f"energy above 4 kHz over the input's " + ", ".join(f"{v:.3g}" for v in rs["lowpass"])
        + " (limit 1e-3); speaker_cluster and analyze_features need sklearn: not run here")

    # -- 16. training options, native loader, profiling tools ------------
    t16 = time.perf_counter()
    op = options_phase(K, rt_ms)
    fp32 = op["modes"]["fp32"]
    log(f"[16 options] (a) native loader: the trainer took it ({LOADER_FILES} WAVs of 4-8 s at "
        f"16/24/44.1 kHz, every third stereo); 2 and 4 threads gave equal batches, start_seq=2 "
        f"gave the stream's batch 2; {op['batches_per_s']:.2f} batches/s of {op['B']} x "
        f"{op['T']} with 8 threads = {op['batches_per_s'] * fp32['ms'][1] / 1e3:.2f} batches "
        f"per fp32 step of {fp32['ms'][1]:.1f} ms")
    log(f"[16 options] (b) first step of {TRAIN_CONFIG} at {op['B']} x {op['T']}: "
        f"{op['first_ms']:.1f} ms = k-means alone ({op['first_launches'] - 2} iterations) "
        f"{op['kmeans_ms']:.1f} ms + the rest {op['first_ms'] - op['kmeans_ms']:.1f} ms; "
        f"vq_nearest launches {op['first_launches']}, segment_sum {op['first_seg_launches']}; "
        f"card {card}")
    for name, r in op["modes"].items():
        worst = max(r["rel"], key=r["rel"].get)
        log(f"[16 options] (b) {name}: steps {r['ms'][0]:.1f}, {r['ms'][1]:.1f} ms "
            f"({op['B'] * op['T'] / small320.sample_rate / (r['ms'][1] / 1e3):.2f} audio-s/s), "
            f"peak {r['peak_gb']:.2f} GB (max_memory_allocated, a copy of the state beside "
            f"it), vq_nearest launches {r['launches']}, segment_sum {r['seg_launches']}; the whole "
            f"step against fp32: gradient cosine "
            f"{r['grad_cos']:.6f}, worst {worst} rel {r['rel'][worst]:.3g}; card {card}")
    costs = {**{name: r["flag"] for name, r in op["modes"].items()},
             "default precision (cuDNN TF32)": op["default_flag"]}
    for name, c in costs.items():
        log(f"[16 options] (b) repeatable_steps' cost, {name}: median of {COST_PAIRS} steps with "
            f"it {c['with_ms']:.1f} ms, without {c['without_ms']:.1f} ms (in turns, after a "
            f"warm-up pair): {c['cost_ms']:+.1f} ms = {c['cost_pct']:+.2f}%; with "
            + ", ".join(f"{t:.1f}" for t in c["ms"]["with"]) + "; without "
            + ", ".join(f"{t:.1f}" for t in c["ms"]["without"]) + f" ms; card {card}")
    log(f"[16 options] (b) losses, fp32 step: " + ", ".join(
        f"{k} {v:.5g}" for k, v in fp32["metrics"].items()) + f"; codes equal in all "
        f"{len(op['modes'])} modes (limits: bf16 BF16_TOLS, cosine > 0.9)")
    log(f"[16 options] (b) remat vs no remat phase by phase (pos-net dropout on, the "
        f"generator phase over the same discriminators), relative: " + ", ".join(
            f"{k} {v:.3g}" for k, v in op["remat"].items()) + f" (limits {REMAT_TOL}, the "
        f"gradient vectors {REMAT_GRAD_TOL}); no remat against itself: " + ", ".join(
            f"{k} {v:.3g}" for k, v in op["remat_floor"].items() if v))
    cl = op["clis"]
    for name in ("mem_probe remat", "mem_probe no remat"):
        r = cl[name]
        log(f"[16 options] (c) {name} (subprocess, {r['cli_s']:.1f} s): batch {r['batch']} x "
            f"{r['T']}, remat {r['remat']}: peak {r['peak_bytes'] / 1e9:.2f} GB over two steps "
            f"({', '.join(f'{t:.1f}' for t in r['step_ms'])} ms); card {card}")
    log("[16 options] (c) check_env (subprocess): " + "; ".join(op["check_env"]))
    log(f"[16 options] (c) perf_profile B=128 x 3 s (subprocess, {cl['perf_profile']['cli_s']:.1f}"
        f" s): stage sum {op['stage_sum_ms']:.3f} ms against [6]'s round trip {rt_ms:.3f} ms "
        f"(limit 10%); card {card}")
    for line in op["perf_table"]:
        log(f"[16 perf_profile] {line.strip()}")
    log(f"[16 options] (c) stage_flops at 8 x 3 s, kernels and plain versions equal: "
        + ", ".join(f"{k} {v:.6g}" for k, v in op["flops_kernels"].items()))
    tp = cl["train_profile"]
    log(f"[16 options] (c) train_profile --batch 8 --passes 1 (subprocess, {tp['cli_s']:.1f} s): "
        f"first step {tp['first_step']['first_ms']:.1f} ms = k-means "
        f"{tp['first_step']['kmeans_ms']:.1f} + rest {tp['first_step']['rest_ms']:.1f}, steady "
        f"{tp['first_step']['steady_ms']:.1f}; " + ", ".join(
            f"{r['stage']} {r['ms']:.1f}" for r in tp["table"]) + f" ms; card {card}")
    log(f"[16 options] (d) msstft_discriminator filters 32, 2 x 24000, card vs CPU over "
        f"{op['msstft_maps']} outputs and maps: rel-max {op['msstft_rel']:.3g} (limit 1e-4)")
    log(f"[16 options] phase time {time.perf_counter() - t16:.1f} s")

    # -- 17. multi-card paths, on this one card ---------------------------
    t17 = time.perf_counter()
    torch.cuda.empty_cache()
    nc = nccl_world_one(K)
    log(f"[17 multicard] (a) NCCL group of one rank (in process, TCP on localhost): one step of "
        f"{TRAIN_CONFIG} at {nc['B']} x {nc['T']} from a state past its first step, against the "
        f"plain step (both under repeatable_steps: cuDNN's deterministic algorithms), relative: "
        + ", ".join(
            f"{k} {v:.3g}" for k, v in nc["rel"].items()) + "; the plain step against its "
        f"repeat: " + ", ".join(f"{k} {v:.3g}" for k, v in nc["floor"].items())
        + f" (limits: {NCCL_STEP_TOL} or 4x that); grad norm {nc['grad_norm'][0]:.8g} / "
        f"{nc['grad_norm'][1]:.8g}; collectives {nc['collectives']} over {nc['backend']}; "
        f"vq_nearest launches {nc['launches']}, segment_sum {nc['seg_launches']}; card {card}")
    torch.cuda.empty_cache()
    gl = gloo_two_ranks()
    log(f"[17 multicard] (b) two spawned ranks over gloo on this card (CUDA tensors staged "
        f"through host memory), {MULTI_B} x {TIMING_SECONDS:.0f} s, rows {gl['rows']}, from an "
        f"un-inited codebook: vq_nearest launches per rank {gl['launches']} (k-means on the "
        f"{gl['n_rows']} gathered rows in each); collectives of rank 0 {gl['collectives']}; "
        f"against the one-process step on the global batch: losses rel-max {gl['loss_rel']:.3g} "
        f"({gl['worst']}), grad norm rel {gl['grad_norm_rel']:.3g} (limits 1e-3), k-means "
        f"codes {gl['flips']} of {gl['n_rows']} differ (near-ties only; largest gap "
        f"{gl['gap']:.3g}; gathered samples rel-max {gl['samples_rel']:.3g}), codebook rel-max "
        f"{gl['embed_rel']:.3g}; step {gl['ms'][0]:.1f} / {gl['ms'][1]:.1f} ms a rank, "
        f"{gl['one_ms']:.1f} ms in one process; spawn to exit {gl['spawn_s']:.1f} s; card {card}")
    de = dp_engine_phase(model, params_np, small320, K)
    log(f"[17 multicard] (c) ServingEngine(devices=['cuda:0', 'cuda:0']): 16 concurrent "
        f"encode then 16 detokenize requests in {de['wall_s']:.3f} s over {de['batches']} "
        f"(encode, detokenize) batches, launches {de['launches']} (each kernel once per "
        f"replica and batch); codes {de['flips']} of {de['n_ids']} differ from direct "
        f"encode_infer, detokenized audio rel-max {de['wave_rel']:.3g} against direct decode "
        f"(limit {SAME_CARD_WAVE_TOL}); card {card}")
    log(f"[17 multicard] (c) tools/extract_features.py --devices cuda:0,cuda:0 against "
        f"--devices cuda:0 on {EXTRACT_FILES} files, batch 4 (subprocesses, at once, "
        f"{de['extract_s']:.1f} s; '{de['extract_head']}'): features rel-max "
        f"{de['extract_feat_rel']:.3g} (limit 1e-4), codes {de['extract_flips']} of "
        f"{de['extract_ids']} differ")
    tps = tp_shards_phase(K, block, T_frames)
    for r in tps["rows"]:
        log(f"[17 multicard] (d) convnext_block M={tps['M']} C={tps['C']} I={tps['I']} in "
            f"{r['shards']} tensor-parallel slices of {r['I_shard']} ({r['launches']} launch "
            f"chains; the slices after the first given zero residual and b2): summed against "
            f"the whole kernel rel {r['rel_whole']:.3g}, against plain rel {r['rel_plain']:.3g} "
            f"(over max |out - x|; limit 1e-2); the {r['shards']} chains {r['ms']:.4f} ms "
            f"(bound {r['bound_ms']:.4f} ms) against the whole kernel {tps['whole_ms']:.4f} ms "
            f"(bound {tps['whole_bound_ms']:.4f} ms); card {card}")
    log(f"[17 multicard] phase time {time.perf_counter() - t17:.1f} s")

    # -- 18. determinism: the VQ's training statistics without atomics ----
    t18 = time.perf_counter()
    torch.cuda.empty_cache()
    dt = determinism_phase(K, real_ids=tt["seg_real_ids"])
    log(f"[18 determinism] (a) segment_sum plan at N={dt['N']} C={dt['C']} D={dt['D']}: column "
        f"slice {K.SEGMENT_SLICE}, {dt['codes_per_block']} codes a block, {K.SEGMENT_STAGES} "
        f"stages of 32 rows; chain floors at {dt['sm_mhz']:.0f} MHz (4 cycles an add); card "
        f"{card}")
    for ids_kind, r in dt["ids"].items():
        log(f"[18 determinism] (a) segment_sum N={dt['N']} C={dt['C']} D={dt['D']}, {ids_kind} ids "
            f"({r['max_count']} rows on the fullest code, {r['codes_used']} codes in use): equal to index_add_ on the CPU bit for bit ({r['cpu_equal']}; max abs err "
            f"{r['max_abs_err']:.3g}), two launches equal ({r['repeat_equal']}); index_add_ on "
            f"the card (float atomics) against the CPU max abs err {r['plain_card_err']:.3g}; "
            f"wrapper with the counts given (order kernel, sum kernel) {r['ms']:.4f} ms (its "
            f"host time {r['host_ms']:.4f} ms), the "
            f"order kernel alone (trace) {r['order_kernel_ms']:.4f} ms, the sum kernel alone "
            f"{r['kernel_ms']:.4f} ms, bound {dt['bound_ms']:.4f} ms ({dt['bound_by']}), chain "
            f"floor {r['chain_ms']:.4f} ms, plain (zeros + index_add_) {r['plain_ms']:.4f} ms, "
            f"index_add_ alone {r['library_ms']:.4f} ms; card {card}")
        log(f"[18 profile] segment_sum {ids_kind}: {r['profile']}")
    log(f"[18 determinism] (b) {TRAIN_CONFIG} at {dt['B']} x {dt['T']}, one state past its first "
        f"step, the step twice under repeatable_steps (cuDNN's deterministic algorithms; no "
        f"use_deterministic_algorithms): " + ", ".join(
            f"{k} {v:.3g}" for k, v in dt["repeat"].items())
        + f" (limit 0); segment_sum launches {dt['step_launches']}; card {card}")
    log(f"[18 determinism] torch.profiler at this point of the run: of {TRACE_PROBES} traces of "
        f"{SEGMENT_REPS} segment_sum calls, {dt['trace_loss'][0]} lost device records taken "
        f"bare, {dt['trace_loss'][TRACE_WARMUP]} after {TRACE_WARMUP} short kernels of their "
        f"own; in the whole run {TRACES['taken']} traces were taken (with the warm-up), "
        f"{TRACES['lost']} of them lost records and were taken again")
    log(f"[18 determinism] phase time {time.perf_counter() - t18:.1f} s")

    # -- 19. the VQ's effective_expiry at the training shape --------------
    t19 = time.perf_counter()
    torch.cuda.empty_cache()
    ex = expiry_phase(K)
    log(f"[19 expiry] vq_train_forward(effective_expiry=True), {TRAIN_CONFIG}'s VQ (k-means "
        f"{ex['kmeans_iters']} iterations, threshold {ex['threshold']}, decay {ex['decay']}) from "
        f"an un-inited layer at N={ex['N']} C={ex['C']} D={ex['D']} ({EXPIRY_POINTS} integer "
        f"points, repeated): {ex['expired']} codes expired ({ex['codes_used']} in use after "
        f"k-means); ids card vs CPU {ex['id_flips']} differ; state card vs CPU rel-max "
        + ", ".join(f"{k} {v:.3g}" for k, v in ex["state_rel"].items()) + " (limit 1e-5); "
        f"expired embed_avg rows against decay * replacement + (1 - decay) * embed_sum: max abs "
        f"err {ex['expired_rows_err']:.3g}; against the forward without it: {ex['off_equal']} "
        f"(equal), state differs {ex['off_state_differs']}; launches {ex['launches']}; "
        f"forward s " + ", ".join(f"{k} {v:.2f}" for k, v in ex["s"].items()) + f"; card {card}")
    log(f"[19 expiry] phase time {time.perf_counter() - t19:.1f} s")

    rows = [
        {"name": "vq_nearest", "route": "cuda",
         "source": "wavtokenizer_tpu_torch/csrc/vq_nearest.cu",
         "replaces": "wavtokenizer_tpu/ops/kernels.py:151",
         "launches": launches["vq_nearest"],
         "max_abs_err": max(vq_err, ec["vq_err"], tt["vq_gap"], tr["kmeans_gap"]),
         "ms": vq_ms, "plain_ms": vq_plain, "bound_ms": vq_bound, "bound_by": vq_by,
         "library_ms": None,
         "encodec": {"N": ec["N"], "C": ec["C"], "D": ec["D"], "ms": ec["vq_ms"],
                     "plain_ms": ec["vq_plain_ms"], "bound_ms": ec["vq_bound_ms"],
                     "bound_by": ec["vq_bound_by"],
                     "launches_per_encode": ec["launches_per_encode"]["vq_nearest"]},
         "train": {"N": tt["N"], "C": tt["C"], "D": tt["D"], "ms": tt["vq_ms"],
                   "plain_ms": tt["vq_plain_ms"], "bound_ms": tt["vq_bound_ms"],
                   "bound_by": tt["vq_bound_by"],
                   "off_float64_uncentred": tt["raw_wrong"],
                   "launches_first_step": tt["launches_first"],
                   "launches_per_step": tt["launches_per_step"][-1],
                   "launches_per_step_by_option": {
                       name: r["launches"][-1] for name, r in op["modes"].items()},
                   "launches_expiry_forward": ex["launches"]["card"]["vq_nearest"]}},
        {"name": "convnext_block", "route": "cuda",
         "source": "wavtokenizer_tpu_torch/csrc/convnext.cu",
         "replaces": "wavtokenizer_tpu/ops/kernels.py:100",
         "launches": launches["convnext_block"], "max_abs_err": cnx_err, "ms": cnx_ms,
         "plain_ms": cnx_plain, "bound_ms": cnx_bound,
         "bound_by": cnx_by, "library_ms": None,
         "vocos": {"M": vc["M"], "C": vc["C"], "I": vc["I"], "ms": vc["ms"],
                   "plain_ms": vc["plain_ms"], "bound_ms": vc["bound_ms"],
                   "bound_by": vc["bound_by"], "cublas_pair_ms": vc["gemm_ms"],
                   "max_abs_err": max(vc["cnx_err"], vc["cnx_err_t"]),
                   "launches_per_decode": vc["launches"]["convnext_block"]},
         "tp_shards": [{"M": tps["M"], "C": tps["C"], "shards": r["shards"],
                        "I_shard": r["I_shard"], "ms": r["ms"], "whole_ms": tps["whole_ms"],
                        "bound_ms": r["bound_ms"], "max_abs_err": r["max_abs_err"]}
                       for r in tps["rows"]]},
        {"name": "encoder_front", "route": "cuda",
         "source": "wavtokenizer_tpu_torch/csrc/encoder_front.cu",
         "replaces": "wavtokenizer_tpu/ops/encoder_front.py:371",
         "launches": launches["encoder_front"], "max_abs_err": front_err, "ms": front_ms,
         "plain_ms": front_plain, "bound_ms": front_bound, "bound_by": front_by,
         "library_ms": None,
         "enhance": {"B": rs["B"], "T": rs["T"], "ms": rs["front_ms"],
                     "plain_ms": rs["front_plain_ms"], "bound_ms": rs["front_bound_ms"],
                     "bound_by": rs["front_bound_by"], "max_abs_err": rs["front_err"],
                     "launches_per_forward": rs["fwd"][True]["launches"],
                     "launches_per_step": {m: r["launches"] for m, r in rs["steps"].items()}}},
        {"name": "segment_sum", "route": "cuda",
         "source": "wavtokenizer_tpu_torch/csrc/segment_sum.cu",
         "replaces": "wavtokenizer_tpu/train/vq_train.py:54,111 (jax.ops.segment_sum: not a "
                     "Pallas kernel)",
         "launches": tt["seg_launches_first"],
         "max_abs_err": max(r["max_abs_err"] for r in dt["ids"].values()),
         "ms": dt["ids"]["skewed"]["ms"], "plain_ms": dt["ids"]["skewed"]["plain_ms"],
         "bound_ms": dt["bound_ms"], "bound_by": dt["bound_by"],
         "library_ms": dt["ids"]["skewed"]["library_ms"],
         "N": dt["N"], "C": dt["C"], "D": dt["D"], "ids": "skewed",
         "kernel_ms": dt["ids"]["skewed"]["kernel_ms"],
         "order_kernel_ms": dt["ids"]["skewed"]["order_kernel_ms"],
         "chain_ms": dt["ids"]["skewed"]["chain_ms"], "sm_mhz": dt["sm_mhz"],
         "host_ms": dt["ids"]["skewed"]["host_ms"],
         "slice_cols": K.SEGMENT_SLICE, "codes_per_block": dt["codes_per_block"],
         "launches_per_step": tt["seg_launches_per_step"][-1],
         "launches_expiry_forward": ex["launches"]["card"]["segment_sum"],
         **{kind: {k: dt["ids"][kind][k]
                   for k in ("ms", "kernel_ms", "order_kernel_ms", "host_ms", "plain_ms",
                             "library_ms", "max_abs_err", "chain_ms", "max_count", "codes_used")}
            for kind in dt["ids"] if kind != "skewed"}},
    ]
    log(f"card: {card}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        log(f"chip_smoke FAILED: {e}")
        sys.exit(1)
