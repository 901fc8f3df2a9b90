#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main path on one GPU.

    python3 chip_smoke.py

Phases, in order (each prints as it goes; any failure exits non-zero):

1. build   — compile the four csrc/*.cu sources with nvcc for sm_90a, one
             process per source, all at once.
2. kernels — each kernel against its plain PyTorch version on the card, at
             the main path's shapes (S=1024, the full rnnoise_synth_v1 model;
             the whole-chunk kernel over T=20 frames from a warm state),
             timed beside the plain version and, where one exists, one
             PyTorch library call (gpu_time: the calls back to back on the
             card), and the kernel's wrapper again as the host issues it
             (``host_ms``, its time to enqueue included); the forward
             and inverse spectra, the lag table, the analysis, the
             post-filter and the whole-chunk kernel also log the f64 floor
             of their own design's arithmetic (the analysis and the
             whole-chunk kernel beside their earlier design's, before the
             lag table and energies went to the f64 tensor cores); the
             analysis' lag table and energies alone against their plain
             versions.
3. main    — for each kernel configuration of process_frames_tm_i16
             (config.CONFIGURATIONS: scan, xcorr, fused, mono): S=1024, two
             chained calls of T=100 frames (T=50 for scan and xcorr, the slow
             ones) with the launch counters zeroed before and read after;
             then 150 stateful frames at S=64 through the kernels and through
             the plain versions, held to the parity budget.
4. serve   — StreamingEngine with 16 slots on the default configuration:
             ticks, a detach and re-attach, pipelined mode and flush.
5. timing  — for each configuration the median of chained S=1024, T=100
             chunks, taken in turns: realtime streams per card.
6. train   — the training path: a synthetic corpus made with numpy from the
             seed; tools.dump_features on the card (128 sequences of 2000
             frames in one device batch), its launches of the forward
             spectra counted and its records checked; 3 sparse train steps
             from step 6000 at full width (cond 128, GRU 384, batch 128,
             2000 frames): ms a step, frames a second, peak device memory;
             one step on the card against one on the CPU from the same
             params and batch (B=4, T=200), the gradients held to 1e-4 of
             each leaf's largest value; the trained params exported as an
             int8 blob, loaded and served by process_frames_tm_i16 on the
             default configuration (S=64, T=20): one monokernel launch,
             held to the parity budget against its plain version.
7. serving rest — (a) FanoutEngine (2 workers) against StreamingEngine on
             phase 4's audio, plain and pipelined, a detach and re-attach
             included, bit for bit; then the tick at S=1024, T=8 on the
             registered model: StreamingEngine and FanoutEngine with K = 1,
             2 and 4 workers, plain and pipelined, the median of 20 ticks
             after 3 of warm-up, and each engine's tick split into its
             stages (assemble, host to device, device, device to host,
             commit; plain, the card synchronised after each), with the
             realtime streams a tick sustains and the host's cores; (b) the
             registry's model equals the file's; (c) the demo command line
             in a subprocess on 2 s of PCM equals StreamDenoiser on the
             card; (d) the C ABI (the port's shim and native/capi_demo.c)
             on 20 frames equals StreamDenoiser on the card up to the
             client's int16 rounding (left out, and logged so, only where
             this interpreter's headers or libpython are missing); (e) the
             sharded processors over every card and over [cuda:0, cuda:0]
             at S=1024, T=20: int16 bit for bit against the unsharded
             monokernel with one launch a shard, float within the parity
             budget; (f) the data-parallel train step at world size 1 on
             NCCL against the step without a group; (g) a saved and loaded
             state continues bit for bit, and checked_process_frames passes
             clean input and raises on a planted NaN.

The line before the last is the kernels' JSON record; the last line is the
device record.  Without a CUDA device it exits 1 and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(REPO, "models", "rnnoise_synth_v1.blob")
MEM_BW = 3.35e12          # H100 SXM device memory, bytes/s
F32_PEAK = 67e12          # f32 outside the tensor cores, flop/s
INT8_PEAK = 1979e12       # int8 tensor cores, op/s
FFT_OPS = 2.5 * 960 * np.log2(960)     # flops of one real 960-point FFT
FFT1024_OPS = 2.5 * 1024 * 10          # flops of one real 1024-point FFT
# f64 instructions (add, multiply or fused multiply-add) per second: 64 per
# clock on each of the 132 SMs at the 1.98 GHz boost clock; the floor of a
# design's own f64 arithmetic, printed beside (not instead of) its bound
F64_RATE = 64 * 132 * 1.98e9
# f64 tensor-core multiply-adds per second: 128 a clock on each SM, the rate
# of the mma.sync m16n8kN f64 shapes (67 TFLOP/s at the boost clock;
# scripts/torch_f64_mma_rate.py measures it)
F64_TC_RATE = 128 * 132 * 1.98e9
# the lag table's f64 multiply-adds per stream (385 x 480) and the fixed-order
# sums of its 4 tap slices
LAG_F64_OPS = 385 * 480 + 385 * 3
# the compact band tables' nonzeros: a band sum's f64 multiply-adds per stream
BAND_NNZ = 723


def mono_f64_ops():
    """(f64 pipe operations, f64 tensor-core multiply-adds) of the
    whole-chunk kernel's design per stream and frame: on the pipe the
    biquad's Toeplitz term and state sums, the 5 autocorrelations, the coarse
    search's 147 lags and energies over 240 taps, both forward FFTs, the 3
    band sums and 2 DCTs, the post-filter (its band energies and inverse
    FFT) and the lag table's squares and lag 384; on the tensor cores the
    lag table and energies (cuda_xcorr.lag_mma_ops)."""
    from rnnoise_tpu_torch.dsp import cuda_xcorr, fft_plan
    mma, vec = cuda_xcorr.lag_mma_ops()
    return (480 * 479 // 2 + 2 * 480 + 5 * 864 + 2 * 147 * 240
            + fft_plan.f64_ops_per_stream() + 3 * BAND_NNZ + 2 * 32 * 32
            + BAND_NNZ + fft_plan.inverse_f64_ops_per_stream() + vec), mma


def design_floor_ms(S, vec_ops, mma_ops=0):
    """The f64 floor of a design's own arithmetic for S streams, in ms: its
    f64 pipe operations at F64_RATE, then its tensor-core multiply-adds at
    F64_TC_RATE (one after the other, as a block runs them)."""
    return 1e3 * S * (vec_ops / F64_RATE + mma_ops / F64_TC_RATE)


SLEEP_CYCLES_PER_S = 1.98e9  # torch.cuda._sleep counts SM clocks (boost 1.98 GHz)
S_MAIN, T_MAIN = 1024, 100
T_SLOW = 50               # phase 3's chunks for the scan and xcorr configurations
T_MONO = 20               # phase 2's chunk for the whole-chunk kernel
S_PARITY, T_PARITY = 64, 150
TIMING_ROUNDS = 5
SEED = 1234
TRAIN_SEQS, TRAIN_T = 128, 2000      # phase 6: the reference's batch and length
TRAIN_STEPS, TRAIN_FROM = 3, 6000    # sparse steps, from the sparsifier's start
CHECK_B, CHECK_T = 4, 200            # phase 6's card-against-CPU step
FANOUT_S, FANOUT_T = 1024, 8         # phase 7's tick: the engine's default T
FANOUT_K = (1, 2, 4)                 # fan-out worker processes
FANOUT_TICKS, FANOUT_WARMUP = 20, 3
FANOUT_RING = 32                     # ring frames a slot (4 ticks)
TICK_STAGES = ("assemble", "to_device", "device", "to_host", "commit")
CAPI_FRAMES = 20
SUBPROCESS_TIMEOUT_S = 300


def log(*a):
    print(*a, flush=True)


class Failure(Exception):
    pass


def check(ok, what):
    if not ok:
        raise Failure(what)


def gpu_time(fn, reps=20, hold=True):
    """Milliseconds per call by CUDA events, after two warm-up calls.  With
    ``hold`` the card is held busy (``torch.cuda._sleep``, twice the host's
    time to enqueue the calls, at most a second) while the host enqueues
    them, so that the events time the calls back to back on the device, not
    the host's launch overhead; a call that waits on the device itself is
    timed with its waits.  Without it the events time the calls as the host
    issues them, its time to enqueue each call included where that is the
    longer (a record's ``host_ms``)."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    if hold:
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(min(2 * reps * host, 1.0) * SLEEP_CYCLES_PER_S))
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def signals(S, T, dev, seed, quiet=()):
    """int16 PCM [T, S, 480]: harmonic speech-like tones with AM and noise,
    made on the device; streams in ``quiet`` get a near-silent stretch."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    n = T * 480
    t = torch.arange(n, device=dev, dtype=torch.float64) / 48000.0
    f0 = 80.0 + 170.0 * torch.rand(S, 1, generator=g, device=dev, dtype=torch.float64)
    sig = torch.zeros(S, n, device=dev, dtype=torch.float64)
    for k in range(1, 12):
        ph = 6.28 * torch.rand(S, 1, generator=g, device=dev, dtype=torch.float64)
        sig += torch.sin(2 * np.pi * f0 * k * t + ph) / k
    sig *= 0.6 + 0.4 * torch.sin(2 * np.pi * 3.0 * t)
    sig += 0.1 * torch.randn(S, n, generator=g, device=dev, dtype=torch.float64)
    sig *= 3000.0
    for s in quiet:
        sig[s, n // 3: n // 3 + 10 * 480] *= 1e-4
    pcm = torch.clamp(torch.round(sig), -32768, 32767).to(torch.int16)
    return pcm.reshape(S, T, 480).transpose(0, 1).contiguous()


def rel_row_err(a, b):
    """max over rows of max|a - b| / max|b|."""
    den = b.abs().amax(dim=1).clamp(min=1e-30)
    return float(((a - b).abs().amax(dim=1) / den).max())


def bound(n_bytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    f32 operations over the f32 peak."""
    t_b, t_o = n_bytes / MEM_BW, flops / F32_PEAK
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def write_corpus(d, seed, seconds=60):
    """speech.pcm, noise.pcm and fg.pcm (int16, 48 kHz) in ``d``: harmonic
    speech-like tones at three pitches, gated every other half second so
    that the VAD sees pauses; white noise; sparse clicks (the recipe of
    tests/test_workflow_e2e.py)."""
    rng = np.random.default_rng(seed)
    n = 48000 * seconds
    parts = []
    for f0 in (100.0, 150.0, 220.0):
        t = np.arange(n // 3) / 48000.0
        sig = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6.28)) / k
                  for k in range(1, 12))
        sig = sig * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
        parts.append(3000.0 * (sig + 0.02 * rng.standard_normal(n // 3)))
    speech = np.concatenate(parts)
    for i in range(0, len(speech), 48000):
        speech[i + 24000:i + 48000] *= 0.001
    fg = np.zeros(n)
    fg[rng.integers(0, n, 4000)] = 20000.0
    for name, sig in (("speech", speech), ("noise", 2000 * rng.standard_normal(n)),
                      ("fg", fg)):
        np.clip(sig, -32767, 32767).astype("<i2").tofile(os.path.join(d, f"{name}.pcm"))


def phase_train(dev, smi, counted):
    """Phase 6, the training path; returns its figures."""
    import tempfile

    import torch
    from rnnoise_tpu_torch.api import RNNoise
    from rnnoise_tpu_torch.denoise import init_state, process_frames_tm_i16
    from rnnoise_tpu_torch.dsp import cuda_frame
    from rnnoise_tpu_torch.tools import dump_features as dump_tool
    from rnnoise_tpu_torch.training import model as tmodel
    from rnnoise_tpu_torch.training.data import RNNoiseDataset
    from rnnoise_tpu_torch.training.export import export_blob
    from rnnoise_tpu_torch.training.train import make_optimizer, make_train_step

    def count_launches(path):
        for rec, fn in counted:
            rec["launches_by_path"][path] = fn.launches
            rec["launches"] += fn.launches
        return {rec["name"]: fn.launches for rec, fn in counted}

    figures = {}
    with tempfile.TemporaryDirectory() as d:
        write_corpus(d, SEED + 6)
        # the feature extraction alone, timed inside the tool's loop
        extract, spans = dump_tool._sequence_features, []

        def timed_extract(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = extract(*args)
            torch.cuda.synchronize()
            spans.append(time.perf_counter() - t0)
            return out
        dump_tool._sequence_features = timed_extract
        feats_path = os.path.join(d, "features.f32")
        for _, fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        try:
            dump_tool.dump_features(*(os.path.join(d, f"{n}.pcm") for n in ("speech", "noise", "fg")),
                                    feats_path, TRAIN_SEQS, batch=TRAIN_SEQS, seed=SEED,
                                    seq_len=TRAIN_T, device=dev)
        finally:
            dump_tool._sequence_features = extract
        dump_s = time.perf_counter() - t0
        launches = count_launches("train_features")
        check(launches["forward_spectral"] >= TRAIN_T,
              f"feature extraction launched forward_spectral {launches['forward_spectral']} times")
        check(all(v == 0 for k, v in launches.items() if k != "forward_spectral"),
              f"feature extraction launched another kernel: {launches}")
        data = np.fromfile(feats_path, dtype=np.float32).reshape(-1, 98)
        check(data.shape[0] == TRAIN_SEQS * TRAIN_T, "feature records")
        g_, v_ = data[:, 65:97], data[:, 97]
        check(bool(np.isfinite(data[:, :65]).all()), "features not finite")
        check(bool(((g_ == -1) | ((g_ >= 0) & (g_ <= 1 + 1e-6))).all()), "gain targets")
        check(set(np.unique(v_)).issubset({0.0, 1.0}) and 0.05 < v_.mean() < 0.95,
              "VAD targets")
        check((g_ == -1).mean() < 0.9, "no real gain targets")
        figures["features_s_per_100_frames"] = 100 * spans[0] / TRAIN_T
        log(f"[train] dump_features {TRAIN_SEQS} x {TRAIN_T} frames (S={TRAIN_SEQS}): "
            f"{dump_s:.2f} s in all, feature extraction {spans[0]:.2f} s = "
            f"{figures['features_s_per_100_frames']:.4f} s per 100 frames; forward_spectral "
            f"launched {launches['forward_spectral']} times; VAD share {v_.mean():.3f}, "
            f"don't-care share {(g_ == -1).mean():.3f}")

        ds = RNNoiseDataset(feats_path, TRAIN_T)
        batch = tuple(torch.from_numpy(a).to(dev) for a in ds.batch(np.arange(TRAIN_SEQS)))
    # full width: the reference's defaults (cond 128, GRU 384)
    params = tmodel.init_params(torch.Generator().manual_seed(SEED), device=dev)
    opt, sched = make_optimizer(params)
    step_fn = make_train_step(opt, sched, sparse=True)
    N = params["gru1"]["w_rec"].shape[0]
    states = tuple(torch.zeros(TRAIN_SEQS, N, device=dev) for _ in range(3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    for step in range(TRAIN_FROM, TRAIN_FROM + TRAIN_STEPS):
        t0 = time.perf_counter()
        states, metrics = step_fn(params, states, batch, step)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"train losses {losses}")
    med = float(np.median(step_s))
    figures.update(train_step_ms=1e3 * med, train_frames_per_s=TRAIN_SEQS * TRAIN_T / med,
                   train_peak_bytes=peak)
    log(f"[train] {TRAIN_STEPS} sparse steps from {TRAIN_FROM}, B={TRAIN_SEQS} T={TRAIN_T} "
        f"cond {params['conv1']['b'].shape[0]} GRU {N}: "
        + ", ".join(f"{1e3 * t:.1f}" for t in step_s)
        + f" ms (median {1e3 * med:.1f} ms, {figures['train_frames_per_s']:.1f} frames/s), "
        f"losses {', '.join(f'{v:.5f}' for v in losses)}, peak device memory "
        f"{peak / 2**30:.3f} GiB on {smi}")

    # one step on the card and one on the CPU, same params and batch
    step_losses, grads = [], []
    host = tmodel.params_to_numpy(params)
    for where in (dev, torch.device("cpu")):
        p = tmodel.params_from_numpy(host, where)
        o, sc = make_optimizer(p)
        b = tuple(t[:CHECK_B, :CHECK_T].to(where) for t in batch)
        st = tuple(torch.zeros(CHECK_B, N, device=where) for _ in range(3))
        _, m = make_train_step(o, sc)(p, st, b, 0)
        step_losses.append(float(m["loss"]))
        grads.append([t.grad.cpu() for t in tmodel.param_leaves(p)])
    worst = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(*grads))
    log(f"[train] one step B={CHECK_B} T={CHECK_T}, card against CPU: loss "
        f"{step_losses[0]:.7f} / {step_losses[1]:.7f}, largest gradient "
        f"error / the leaf's max {worst:.3e} (tolerance 1e-4)")
    check(worst <= 1e-4, "the card's gradients disagree with the CPU's")
    figures["grad_err_vs_cpu"] = worst

    # the trained model, exported and served on the default configuration
    model = RNNoise.from_buffer(export_blob(params, quantize=True), device=dev)
    check(model.config.gru_size == N, "exported topology")
    pcm = signals(64, 20, dev, SEED + 7, quiet=range(0, 64, 8))
    st0 = init_state(64, model.config, dev)
    torch.cuda.synchronize()
    for _, fn in counted:
        fn.launches = 0
    st, out, vad = process_frames_tm_i16(model.params, st0, pcm)
    torch.cuda.synchronize()
    launches = count_launches("train_serve")
    check(launches["process_chunk_monokernel"] == 1
          and sum(launches.values()) == 1, f"serving the trained model launched {launches}")
    check(tuple(out.shape) == (20, 64, 480) and out.dtype == torch.int16
          and bool(torch.isfinite(vad).all()), "served output")
    check(all(bool(torch.isfinite(u.float()).all()) for t in st
              for u in (t if isinstance(t, tuple) else (t,))), "served state not finite")
    _, p_out, p_vad = cuda_frame.process_chunk_monokernel_plain(model.params, st0, pcm)
    pcm_err = int((out.int() - p_out.int()).abs().max())
    vad_err = float((vad - p_vad).abs().max())
    log(f"[train] the trained model served (S=64, T=20, default configuration): one "
        f"monokernel launch, PCM {pcm_err} LSB (<= 4) and VAD {vad_err:.2e} (<= 2e-3) "
        f"against its plain version, VAD mean {float(vad.mean()):.3f}")
    check(pcm_err <= 4 and vad_err <= 2e-3, "the served trained model leaves the parity budget")
    return figures


def same_tensors(a, b):
    """Two tensors, or tuples of them (nested, with Nones), equal bit for
    bit."""
    import torch
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_tensors(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return bool(torch.equal(a, b))


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def drive_bulk(eng, sigs, T, n_chunks):
    """Attach every slot, tick n_chunks chunks, detach and re-attach slot 5,
    tick one more; returns (streams advanced per tick, every slot's
    output)."""
    S = sigs.shape[0]
    attach = getattr(eng, "attach_all", None) or (
        lambda: sum(eng.attach() >= 0 for _ in range(S)))
    check(attach() == S, "attach")
    eng.pool.push_all(sigs[:, :n_chunks * T * 480])
    adv = [eng.tick() for _ in range(n_chunks)] + [eng.flush()]
    eng.detach(5)
    check(attach() == 1, "re-attach")
    eng.pool.push_all(sigs[:, n_chunks * T * 480:(n_chunks + 1) * T * 480])
    adv += [eng.tick(), eng.flush()]
    out, _ = eng.pool.pull_all((n_chunks + 1) * T * 480)
    return adv, out


def time_ticks(eng, block, n, stages=False):
    """Seconds of each of ``n`` ticks after FANOUT_WARMUP, the pool fed one
    chunk of ``block`` [S, T*480] before each tick and its output rings
    drained after (neither timed; in pipelined mode the card works on
    meanwhile).  With ``stages`` the tick runs stage by stage (plain mode),
    the card synchronised after each, and each stage's seconds are returned
    too."""
    T = eng.chunk_frames
    dev = eng.device
    drain = np.empty((eng.n_slots, T * 480), np.int16)
    ticks, parts = [], {k: [] for k in TICK_STAGES}
    for i in range(FANOUT_WARMUP + n):
        eng.pool.push_all(block)
        t0 = time.perf_counter()
        if not stages:
            eng.tick()
            t = [time.perf_counter()]
        else:
            batch, counts, reset = eng._assemble(T)
            t = [time.perf_counter()]
            args = eng._to_device(batch, counts, reset)
            sync(dev)
            t.append(time.perf_counter())
            out = eng._compute(*args)
            sync(dev)
            t.append(time.perf_counter())
            host = eng._to_host(out)
            t.append(time.perf_counter())
            eng._commit(T, host, counts)
            t.append(time.perf_counter())
        eng.pool.pull_all(T * 480, out=drain)
        if i >= FANOUT_WARMUP:
            ticks.append(t[-1] - t0)
            for k, a, b in zip(TICK_STAGES, [t0] + t[:-1], t):
                parts[k].append(b - a)
    eng.flush()
    eng.pool.pull_all(T * 480, out=drain)
    return ticks, (parts if stages else None)


def phase_serving_rest(dev, smi, counted, model, audio):
    """Phase 7: the fan-out engine (checked, then timed), the registry, the
    demo, the C ABI, the sharded processors, the data-parallel train step
    and the utils, on the card; returns the tick figures."""
    import io
    import shutil
    import uuid

    import torch
    import torch.distributed as dist
    from rnnoise_tpu_torch import capi, kernels
    from rnnoise_tpu_torch.api import RNNoise, StreamDenoiser
    from rnnoise_tpu_torch.config import ModelConfig
    from rnnoise_tpu_torch.denoise import (init_state, process_frames,
                                           process_frames_tm_i16)
    from rnnoise_tpu_torch.parallel import multihost, sharding
    from rnnoise_tpu_torch.runtime.engine import StreamingEngine
    from rnnoise_tpu_torch.runtime.fanout import FanoutEngine
    from rnnoise_tpu_torch.training.model import init_params, param_leaves
    from rnnoise_tpu_torch.training.train import make_optimizer, make_train_step
    from rnnoise_tpu_torch.utils import debug, state_io
    from rnnoise_tpu_torch.weights.registry import load_registered

    def count_launches(path):
        for rec, fn in counted:
            rec["launches_by_path"][path] = fn.launches
            rec["launches"] += fn.launches
        return {rec["name"]: fn.launches for rec, fn in counted}

    def zero_counts():
        for _, fn in counted:
            fn.launches = 0

    figures = {}
    procs = []
    tmp = os.path.join(kernels.BUILD_DIR, f"phase7-{os.getpid()}-{uuid.uuid4().hex}")
    os.makedirs(tmp)
    try:
        # (a) the fan-out engine against the single-process engine
        sigs = audio.astype(np.int16)
        for pipelined in (False, True):
            ref = StreamingEngine(16, model, chunk_frames=8, pipelined=pipelined)
            ref_adv, ref_out = drive_bulk(ref, sigs, 8, 3)
            zero_counts()
            eng = FanoutEngine(16, model, chunk_frames=8, n_workers=2,
                               pipelined=pipelined)
            try:
                adv, out = drive_bulk(eng, sigs, 8, 3)
            finally:
                eng.close()
            launches = count_launches("fanout" if not pipelined else "fanout_pipelined")
            check(launches["process_chunk_monokernel"] == 4
                  and sum(launches.values()) == 4,
                  f"the fan-out engine launched {launches}")
            check(adv == ref_adv and sum(adv) == 3 * 16 + 16,
                  f"fan-out advanced {adv}, the engine {ref_adv}")
            check(np.array_equal(out, ref_out) and np.abs(out).max() > 0,
                  "the fan-out engine's output differs from the engine's")
            log(f"[fanout] pipelined={pipelined}: 2 workers, advanced {adv}, "
                f"output equal to StreamingEngine's bit for bit, monokernel launches "
                f"{launches['process_chunk_monokernel']}")

        # (a) the tick at full width on the registered model
        full = RNNoise(load_registered(device=dev), device=dev)
        block = signals(FANOUT_S, FANOUT_T, dev, SEED + 9, quiet=range(0, FANOUT_S, 16))
        block = block.transpose(0, 1).reshape(FANOUT_S, -1).cpu().numpy()
        cores = os.cpu_count()
        usable = len(os.sched_getaffinity(0))
        rows = {}
        for name, K in (("engine", 0),) + tuple((f"fanout K={k}", k) for k in FANOUT_K):
            for pipelined in (False, True):
                if K == 0:
                    eng = StreamingEngine(FANOUT_S, full, chunk_frames=FANOUT_T,
                                          ring_frames=FANOUT_RING, pipelined=pipelined)
                    for _ in range(FANOUT_S):
                        eng.attach()
                else:
                    eng = FanoutEngine(FANOUT_S, full, chunk_frames=FANOUT_T, n_workers=K,
                                       ring_frames=FANOUT_RING, pipelined=pipelined)
                    eng.attach_all()
                try:
                    ticks, _ = time_ticks(eng, block, FANOUT_TICKS)
                    if not pipelined:
                        _, parts = time_ticks(eng, block, FANOUT_TICKS, stages=True)
                finally:
                    if K:
                        eng.close()
                med = float(np.median(ticks))
                row = dict(tick_ms=1e3 * med, streams=FANOUT_S * FANOUT_T * 0.01 / med,
                           min_ms=1e3 * min(ticks), max_ms=1e3 * max(ticks))
                if not pipelined:
                    row["stages_ms"] = {k: 1e3 * float(np.median(v)) for k, v in parts.items()}
                rows[f"{name} {'pipelined' if pipelined else 'plain'}"] = row
                log(f"[fanout] S={FANOUT_S} T={FANOUT_T} {name}, "
                    f"{'pipelined' if pipelined else 'plain'}: median tick {1e3 * med:.3f} ms "
                    f"of {len(ticks)} (min {row['min_ms']:.3f}, max {row['max_ms']:.3f}): "
                    f"{row['streams']:.1f} realtime streams"
                    + ("" if pipelined else "; stages (median ms) " + ", ".join(
                        f"{k} {v:.3f}" for k, v in row["stages_ms"].items()))
                    + f"; host {cores} cores ({usable} usable) on {smi}")
        figures["tick"] = dict(S=FANOUT_S, T=FANOUT_T, cores=cores, usable_cores=usable,
                               rows=rows)

        # (c, d) the demo and the C ABI run in processes of their own while
        # (b), (e), (f) and (g) go on here; they are read at the end
        rng = np.random.default_rng(SEED + 8)
        demo_pcm = signals(1, 200, torch.device("cpu"), SEED + 8).reshape(-1).numpy()
        demo_pcm.tofile(os.path.join(tmp, "in.pcm"))
        procs.append(("demo", subprocess.Popen(
            [sys.executable, "-m", "rnnoise_tpu_torch.tools.demo",
             os.path.join(tmp, "in.pcm"), os.path.join(tmp, "out.pcm")],
            cwd=REPO, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
        capi_pcm = (2500 * rng.standard_normal(480 * CAPI_FRAMES)).astype(np.int16)
        try:
            capi.python_embedding()
        except RuntimeError as e:
            capi_missing = str(e)
        else:
            capi_missing = None
            demo_exe = capi.build_demo(capi.build_capi(os.path.join(tmp, "capi")))
            capi_pcm.tofile(os.path.join(tmp, "capi_in.pcm"))
            env = {k: v for k, v in os.environ.items()
                   if k not in ("PYTHONPATH", "RNNOISE_TPU_DEVICE")}
            with open(os.path.join(tmp, "capi_in.pcm"), "rb") as stdin:
                procs.append(("capi", subprocess.Popen(
                    [demo_exe, MODEL], stdin=stdin, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, env=env)))

        # (b) the registry
        registered = load_registered("rnnoise_synth_v1.blob", device=dev)
        check(same_tensors(registered, RNNoise.from_filename(MODEL, device=dev).params),
              "the registered model differs from the file's")
        log("[registry] load_registered('rnnoise_synth_v1.blob') equals "
            "RNNoise.from_filename(MODEL): sha256 pin accepted")

        # (e) the sharded processors, over every card and over [cuda:0, cuda:0]
        pcm = signals(S_MAIN, T_MONO, dev, SEED + 10, quiet=range(0, S_MAIN, 16))
        st0 = init_state(S_MAIN, model.config, dev)
        _, u_out, u_vad = process_frames_tm_i16(model.params, st0, pcm)
        _, uf_out, uf_vad = process_frames(model.params, st0,
                                           pcm.transpose(0, 1).float())
        for label, mesh in (("every card", sharding.make_mesh()),
                            ("cuda:0 twice", sharding.make_mesh(devices=[dev, dev]))):
            run = sharding.make_sharded_processor_tm_i16(model.params, mesh)
            sync(dev)
            zero_counts()
            _, s_out, s_vad = run(st0, pcm)
            sync(dev)
            launches = count_launches(f"shard_i16 ({label})")
            check(launches["process_chunk_monokernel"] == len(mesh)
                  and sum(launches.values()) == len(mesh),
                  f"the sharded int16 processor launched {launches} over {len(mesh)} shards")
            check(torch.equal(s_out, u_out) and torch.equal(s_vad, u_vad),
                  f"sharded ({label}) int16 output differs from the unsharded monokernel's")
            runf = sharding.make_sharded_processor(model.params, mesh)
            zero_counts()
            _, sf_out, sf_vad = runf(st0, pcm.transpose(0, 1).float())
            sync(dev)
            launches_f = count_launches(f"shard_float ({label})")
            pcm_err = float((sf_out - uf_out).abs().max())
            vad_err = float((sf_vad - uf_vad).abs().max())
            check(pcm_err <= 4 and vad_err <= 2e-3,
                  f"sharded ({label}) float output leaves the parity budget")
            log(f"[shard] {label} ({len(mesh)} shards), S={S_MAIN} T={T_MONO}: int16 equal to "
                f"the unsharded monokernel bit for bit, {launches['process_chunk_monokernel']} "
                f"monokernel launches; float: PCM {pcm_err:.3g} (<= 4), VAD {vad_err:.3g} "
                f"(<= 2e-3), launches {launches_f}")

        # (f) the data-parallel train step, world size 1 on NCCL
        cfg = ModelConfig(cond_size=32, gru_size=64)
        brng = np.random.default_rng(SEED + 11)
        batch = tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            brng.normal(0, 1.5, (8, 24, 65)), brng.uniform(0, 1, (8, 24, 32)),
            brng.uniform(0, 1, (8, 24, 1))))
        rdv = os.path.join(tmp, "nccl-rendezvous")
        multihost.init_distributed(f"file://{rdv}", 1, 0, "nccl")
        results = []
        try:
            for group in (None, dist.group.WORLD):
                tp = init_params(torch.Generator().manual_seed(SEED), cfg, dev)
                opt, sched = make_optimizer(tp)
                states = tuple(torch.zeros(8, 64, device=dev) for _ in range(3))
                _, m = make_train_step(opt, sched, process_group=group)(tp, states, batch, 0)
                results.append((float(m["loss"]), [t.detach() for t in param_leaves(tp)]))
        finally:
            dist.destroy_process_group()
        dp_err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                     for a, b in zip(results[0][1], results[1][1]))
        log(f"[dp] train step cond 32 GRU 64 B=8 T=24 with an NCCL group of 1 against "
            f"none: loss {results[1][0]:.7f} / {results[0][0]:.7f}, largest param "
            f"difference / the leaf's max {dp_err:.3e} (<= 1e-6)")
        check(dp_err <= 1e-6, "the data-parallel step differs from the plain step")

        # (g) utils: a state file continues bit for bit; the NaN check
        st1, _, _ = process_frames_tm_i16(model.params, st0, pcm[:10])
        buf = io.BytesIO()
        state_io.save_state(st1, buf)
        buf.seek(0)
        loaded = state_io.load_state(buf, dev)
        a = process_frames_tm_i16(model.params, st1, pcm[10:])
        b = process_frames_tm_i16(model.params, loaded, pcm[10:])
        check(same_tensors(st1, loaded) and same_tensors(a, b),
              "a loaded state does not continue bit for bit")
        small = pcm[:4, :64].transpose(0, 1).float().contiguous()
        clean0 = init_state(small.shape[0], model.config, dev)
        got = debug.checked_process_frames(model.params, clean0, small)
        want = process_frames(model.params, clean0, small)
        check(same_tensors(got, want), "checked_process_frames differs from process_frames")
        bad = clean0._replace(analysis_mem=clean0.analysis_mem.clone())
        bad.analysis_mem[small.shape[0] // 2, 100] = float("nan")
        try:
            debug.checked_process_frames(model.params, bad, small)
        except FloatingPointError as e:
            nan_msg = str(e)
        else:
            raise Failure("checked_process_frames passed a planted NaN")
        log(f"[utils] save_state/load_state: continued bit for bit; checked_process_frames: "
            f"clean input equal to process_frames, planted NaN raised '{nan_msg}'")

        # (c) the demo's output, against the port's API on the card
        name, proc = procs[0]
        log_demo, _ = proc.communicate(timeout=SUBPROCESS_TIMEOUT_S)
        check(proc.returncode == 0, f"the demo exited with {proc.returncode}:\n{log_demo[-3000:]}")
        got = np.fromfile(os.path.join(tmp, "out.pcm"), dtype="<i2")
        den = StreamDenoiser(1, RNNoise.from_filename(MODEL, device=dev))
        frames = demo_pcm.astype(np.float32).reshape(-1, 480)
        want = np.concatenate([den.process_chunk(frames[None, i:i + 16])[0].ravel()
                               for i in range(0, len(frames), 16)])
        want = np.clip(np.round(want[480:]), -32768, 32767).astype("<i2")
        check(len(got) == len(demo_pcm) - 480 and np.array_equal(got, want),
              "the demo's output differs from StreamDenoiser's on the card")
        log(f"[demo] python -m rnnoise_tpu_torch.tools.demo on {len(demo_pcm)} samples "
            f"(device cuda): {len(got)} out, equal to StreamDenoiser on the card bit for "
            f"bit ({log_demo.strip().splitlines()[-1]})")

        # (d) the C ABI on the card
        if capi_missing is not None:
            log(f"[capi] left out: {capi_missing}")
            figures["capi"] = f"left out: {capi_missing}"
        else:
            _, proc = procs[1]
            out_c, err_c = proc.communicate(timeout=SUBPROCESS_TIMEOUT_S)
            err_c = err_c.decode()
            check(proc.returncode == 0, f"capi_demo exited with {proc.returncode}:\n"
                                        f"{err_c[-3000:]}")
            out_c = np.frombuffer(out_c, np.int16)
            vads_c = [float(x.split()[1]) for x in err_c.splitlines() if x.startswith("vad ")]
            den = StreamDenoiser(1, RNNoise.from_filename(MODEL, device=dev))
            outs, vads = [], []
            for f in range(CAPI_FRAMES):
                o, v = den.process_frame(capi_pcm[f * 480:(f + 1) * 480].astype(np.float32)[None])
                outs.append(o[0])
                vads.append(float(v[0]))
            out_py = np.clip(np.round(np.concatenate(outs)), -32768, 32767)
            check(len(out_c) == 480 * CAPI_FRAMES and len(vads_c) == CAPI_FRAMES,
                  "capi_demo's output length")
            pcm_err = float(np.abs(out_c - out_py).max())
            vad_err = float(np.abs(np.asarray(vads_c) - np.asarray(vads)).max())
            log(f"[capi] the port's shim and native/capi_demo.c, {CAPI_FRAMES} frames on the "
                f"card (RNNOISE_TPU_DEVICE unset): PCM {pcm_err:.0f} LSB (<= 1, the client's "
                f"rounding), VAD {vad_err:.2e} (<= 1e-5)")
            check(pcm_err <= 1 and vad_err <= 1e-5, "the C ABI differs from StreamDenoiser")
            figures["capi"] = dict(pcm_err=pcm_err, vad_err=vad_err)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return figures


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from rnnoise_tpu_torch import config as rt_config
    from rnnoise_tpu_torch import kernels
    from rnnoise_tpu_torch.api import RNNoise
    from rnnoise_tpu_torch.config import CONFIGURATIONS, resolve_device
    from rnnoise_tpu_torch.denoise import init_state, process_frames_tm_i16
    from rnnoise_tpu_torch.dsp import cuda_analysis, cuda_frame, cuda_xcorr, pitch
    from rnnoise_tpu_torch.dsp import cuda_spectral as spec
    from rnnoise_tpu_torch.dsp import fft_plan
    from rnnoise_tpu_torch.dsp.transform import (compute_band_corr,
                                                 compute_band_energy)
    from rnnoise_tpu_torch.models.rnn import RNNState
    from rnnoise_tpu_torch.nn import cuda_rnn
    from rnnoise_tpu_torch.runtime.engine import StreamingEngine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log("torch", torch.__version__, "cuda", torch.version.cuda)
    dev = resolve_device("cuda")

    # 1. build -------------------------------------------------------------
    report = kernels.build_kernels()
    for name, (sec, out) in report.items():
        log(f"[build] {name}: {sec:.1f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("   ", line.strip())

    # 2. kernels against their plain versions ------------------------------
    model = RNNoise.from_filename(MODEL, device=dev)
    params, cfg = model.params, model.config
    F, C, N, NB = cfg.input_dim, cfg.cond_size, cfg.gru_size, cfg.output_dim
    S = S_MAIN
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=dev)

    feats = rnd(S, F)
    st = RNNState(rnd(S, 2 * F), torch.tanh(rnd(S, 2 * C)), torch.tanh(rnd(S, N)),
                  torch.tanh(rnd(S, N)), torch.tanh(rnd(S, N)))
    sil = torch.rand(S, generator=g, device=dev) < 0.125
    k_st, k_g, k_v = cuda_rnn.compute_rnn_step(params, st, feats, sil)
    p_st, p_g, p_v = cuda_rnn.compute_rnn_plain(params, st, feats, sil)
    torch.cuda.synchronize()
    rnn_err = max(float((a - b).abs().max()) for a, b in
                  zip((*k_st, k_g, k_v), (*p_st, p_g, p_v)))
    log(f"[kernels] rnn_step max abs err {rnn_err:.3e} (tolerance 1e-5)")
    check(rnn_err <= 1e-5, "rnn_step disagrees with its plain version")
    # The bound counts what these inputs need: the nonzero weights (the GRU
    # matrices are 8x4-block sparse, about a third nonzero), read once and
    # multiplied once for each stream that is not silent (silent rows keep
    # their state), plus every state read and written once.
    layers = params._asdict()
    q_nnz = sum(int((layers[k].weights_q != 0).sum()) for k in
                ["conv2"] + [f"gru{i}_{j}" for i in (1, 2, 3)
                             for j in ("input", "recurrent")])
    f_nnz = sum(int((layers[k].weights_f32 != 0).sum())
                for k in ("conv1", "dense_out", "vad_dense"))
    vec_bytes = sum(4 * t.numel() for lp in layers.values()
                    for t in (lp.bias, lp.scale, lp.diag) if t is not None)
    active = int((~sil).sum())
    st_bytes = S * 4 * (2 * F + 2 * C + 3 * N)
    rnn_bytes = (q_nnz + 4 * f_nnz + vec_bytes + S * (4 * F + 1)
                 + 2 * st_bytes + S * 4 * (NB + 1))
    rnn_t_ops = 2 * active * (q_nnz / INT8_PEAK + f_nnz / F32_PEAK)
    rnn_rec = dict(
        name="rnn_step", route="cuda", source="rnnoise_tpu_torch/csrc/rnn_step.cu",
        replaces="rnnoise_tpu/nn/pallas_rnn.py:162",
        max_abs_err=rnn_err,
        ms=gpu_time(lambda: cuda_rnn.compute_rnn_step(params, st, feats, sil)),
        host_ms=gpu_time(lambda: cuda_rnn.compute_rnn_step(params, st, feats, sil), hold=False),
        plain_ms=gpu_time(lambda: cuda_rnn.compute_rnn_plain(params, st, feats, sil)),
        bound_ms=1e3 * max(rnn_bytes / MEM_BW, rnn_t_ops),
        bound_by="bytes" if rnn_bytes / MEM_BW >= rnn_t_ops else "operations",
        library_ms=None)

    mem, x = rnd(S, 480, scale=3000.0), rnd(S, 480, scale=3000.0)
    pbuf = rnd(S, 1728, scale=3000.0)
    start = torch.randint(0, 709, (S,), generator=g, device=dev, dtype=torch.int32)
    kX, kP = spec.forward_spectral(mem, x, pbuf, start)
    pX, pP = spec.forward_spectral_plain(mem, x, pbuf, start)
    torch.cuda.synchronize()
    fwd_err = max(rel_row_err(kX, pX), rel_row_err(kP, pP))
    log(f"[kernels] forward_spectral max err / row max {fwd_err:.3e} (tolerance 1e-4)")
    check(fwd_err <= 1e-4, "forward_spectral disagrees with its plain version")
    win = spec.kernel_tables(str(dev))[0]
    both = torch.cat([torch.cat([mem, x], 1), spec.take_window(pbuf, start)]) * win
    # inputs read once (mem, x, the 960-sample pitch window, start, the
    # window table), X and P written once; operations as two real 960-point
    # FFTs (5/2 N log2 N each) plus the windowing and the 1/960 scaling
    fwd_bound = bound(4 * (S * (480 + 480 + 960 + 1 + 2 * 962) + 960),
                      S * 2 * (FFT_OPS + 960 + 962))
    fwd_rec = dict(
        name="forward_spectral", route="cuda", source="rnnoise_tpu_torch/csrc/spectral.cu",
        replaces="rnnoise_tpu/dsp/pallas_spectral.py:388",
        max_abs_err=float(max((kX - pX).abs().max(), (kP - pP).abs().max())),
        ms=gpu_time(lambda: spec.forward_spectral(mem, x, pbuf, start)),
        host_ms=gpu_time(lambda: spec.forward_spectral(mem, x, pbuf, start), hold=False),
        plain_ms=gpu_time(lambda: spec.forward_spectral_plain(mem, x, pbuf, start)),
        bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
        library_ms=gpu_time(lambda: torch.fft.rfft(both, dim=-1)))

    Y = kX
    k_out = spec.inverse_spectral(Y)
    p_out = spec.inverse_spectral_plain(Y)
    torch.cuda.synchronize()
    inv_err = rel_row_err(k_out, p_out)
    log(f"[kernels] inverse_spectral max err / row max {inv_err:.3e} (tolerance 1e-4)")
    check(inv_err <= 1e-4, "inverse_spectral disagrees with its plain version")
    Yc = torch.complex(Y[:, :481], Y[:, 481:])
    inv_bound = bound(4 * (S * (962 + 960) + 960), S * (FFT_OPS + 960))
    inv_rec = dict(
        name="inverse_spectral", route="cuda", source="rnnoise_tpu_torch/csrc/spectral.cu",
        replaces="rnnoise_tpu/dsp/pallas_spectral.py:538",
        max_abs_err=float((k_out - p_out).abs().max()),
        ms=gpu_time(lambda: spec.inverse_spectral(Y)),
        host_ms=gpu_time(lambda: spec.inverse_spectral(Y), hold=False),
        plain_ms=gpu_time(lambda: spec.inverse_spectral_plain(Y)),
        bound_ms=inv_bound[0], bound_by=inv_bound[1],
        library_ms=gpu_time(lambda: torch.fft.irfft(Yc, n=960, dim=-1)))

    # the pitch analysis' inputs come from a real decimation and coarse
    # search of generated PCM, and the previous period and gain from the
    # frame before, so the ladder takes real branches
    seq = signals(S, 5, dev, SEED + 3, quiet=range(0, S, 16)).float()
    seq = seq.transpose(0, 1).reshape(S, -1)                 # [S, 2400]

    def frame_inputs(end):
        buf = seq[:, end - 1728:end].contiguous()
        ds = pitch.pitch_downsample(buf)
        return (buf[:, -960:-480].contiguous(), buf[:, -480:].contiguous(), buf,
                ds, *pitch.coarse_search(ds))
    zero_i = torch.zeros(S, dtype=torch.int32, device=dev)
    _, _, prev_p, prev_g = cuda_analysis.analysis_spectral_plain(
        *frame_inputs(1920), zero_i, zero_i.float())
    a_args = (*frame_inputs(2400), prev_p, prev_g)
    ds = a_args[3]

    # the analysis' lag table and energies alone (its f64 tensor-core tiles)
    lt_k = cuda_analysis.lag_energy_table(ds)
    lt_p = cuda_analysis.lag_energy_table_plain(ds)
    torch.cuda.synchronize()
    lt_err = max(rel_row_err(a, b) for a, b in zip(lt_k, lt_p))
    lt_diff = [int((a != b).sum()) for a, b in zip(lt_k, lt_p)]
    log(f"[kernels] analysis lag table and energies max err / row max {lt_err:.3e} "
        f"(tolerance 1e-6); values differing from the plain versions: bx "
        f"{lt_diff[0]}, yy {lt_diff[1]} of {S * 385} each")
    check(lt_err <= 1e-6, "the analysis' lag table disagrees with its plain version")
    lag_mma, lag_vec = cuda_xcorr.lag_mma_ops()
    log(f"[kernels] analysis lag table and energies alone "
        f"{gpu_time(lambda: cuda_analysis.lag_energy_table(ds)):.4f} ms, its products at "
        f"the tensor cores' rate {design_floor_ms(S, 0, lag_mma):.4f} ms")

    bx_k = cuda_xcorr.lag_corr_table_kernel(ds)
    bx_p = cuda_xcorr.lag_corr_table_plain(ds)
    torch.cuda.synchronize()
    xc_err = rel_row_err(bx_k, bx_p)
    log(f"[kernels] lag_corr_table max err / row max {xc_err:.3e} (tolerance 1e-6)")
    check(xc_err <= 1e-6, "lag_corr_table disagrees with its plain version")
    # ds read once, bx written once; operations as three real 1024-point
    # FFTs (the correlation theorem) and the 513-bin product
    xc_bound = bound(4 * S * (864 + 385), S * (3 * FFT1024_OPS + 6 * 513))
    x_win = ds[:, 384:864].contiguous()
    xc_rec = dict(
        name="lag_corr_table", route="cuda", source="rnnoise_tpu_torch/csrc/analysis.cu",
        replaces="rnnoise_tpu/dsp/pallas_xcorr.py:150",
        max_abs_err=float((bx_k - bx_p).abs().max()),
        ms=gpu_time(lambda: cuda_xcorr.lag_corr_table_kernel(ds)),
        host_ms=gpu_time(lambda: cuda_xcorr.lag_corr_table_kernel(ds), hold=False),
        plain_ms=gpu_time(lambda: cuda_xcorr.lag_corr_table_plain(ds)),
        bound_ms=xc_bound[0], bound_by=xc_bound[1],
        library_ms=gpu_time(lambda: pitch.batched_xcorr(x_win, ds, 385)))

    kX, kP, kT, kg = cuda_analysis.analysis_spectral(*a_args)
    pX, pP, pT, pg = cuda_analysis.analysis_spectral_plain(*a_args)
    fX, fP = spec.forward_spectral(*a_args[:3], 1728 - 960 - kT)
    torch.cuda.synchronize()
    same = kT == pT
    t0_diff = int((~same).sum())
    an_gain_err = float((kg - pg)[same].abs().max())
    an_err = max(rel_row_err(kX[same], pX[same]), rel_row_err(kP[same], pP[same]))
    bitwise = bool(torch.equal(kX, fX) and torch.equal(kP, fP))
    log(f"[kernels] analysis_spectral: T0 differs in {t0_diff} of {S} streams "
        f"(<= 2), gain err {an_gain_err:.3e} (<= 1e-6), X/P err / row max "
        f"{an_err:.3e} (<= 1e-4), X and P equal forward_spectral's: {bitwise}; "
        f"{int((kT != prev_p).sum())} periods moved since the frame before")
    check(t0_diff <= 2 and an_gain_err <= 1e-6 and an_err <= 1e-4,
          "analysis_spectral disagrees with its plain version")
    check(bitwise, "analysis_spectral's spectra differ from forward_spectral's")
    # inputs read once (mem, x, the 960-sample pitch window at the resolved
    # period, ds, bp0, bp1, the previous period and gain), X, P, T0 and gain
    # written once; operations as the correlation's three real 1024-point
    # FFTs, the 864 squares and sliding sums of the energies, and two real
    # 960-point FFTs with their windowing and scaling
    an_bound = bound(4 * S * (480 + 480 + 960 + 864 + 4 + 2 * 962 + 2),
                     S * (3 * FFT1024_OPS + 6 * 513 + 3 * 864
                          + 2 * (FFT_OPS + 960 + 962)))
    an_rec = dict(
        name="analysis_spectral", route="cuda", source="rnnoise_tpu_torch/csrc/analysis.cu",
        replaces="rnnoise_tpu/dsp/pallas_analysis.py:388",
        max_abs_err=float(max((kX - pX)[same].abs().max(), (kP - pP)[same].abs().max(),
                              an_gain_err)),
        ms=gpu_time(lambda: cuda_analysis.analysis_spectral(*a_args)),
        host_ms=gpu_time(lambda: cuda_analysis.analysis_spectral(*a_args), hold=False),
        plain_ms=gpu_time(lambda: cuda_analysis.analysis_spectral_plain(*a_args)),
        bound_ms=an_bound[0], bound_by=an_bound[1],
        library_ms=None)

    # the post-filter's inputs: the analysed spectrum, that of a noisier
    # pitch window, random gains, every 8th stream silent
    Xd = kX
    Pd = spec.forward_spectral(*a_args[:2], a_args[2] + rnd(S, 1728, scale=500.0),
                               1728 - 960 - kT)[1]
    Ex_d, Ep_d = compute_band_energy(Xd), compute_band_energy(Pd)
    Exp_d = compute_band_corr(Xd, Pd) / torch.sqrt(0.001 + Ex_d * Ep_d)
    p_args = (Xd, Pd, Ex_d, Ep_d, Exp_d,
              0.05 + 0.95 * torch.rand(S, 32, generator=g, device=dev),
              torch.rand(S, 32, generator=g, device=dev),
              Ex_d * (0.5 + 1.5 * torch.rand(S, 1, generator=g, device=dev)),
              torch.arange(S, device=dev) % 8 == 0, rnd(S, 480, scale=3000.0))
    k_post = spec.postfilter_synthesis(*p_args)
    p_post = spec.postfilter_synthesis_plain(*p_args)
    torch.cuda.synchronize()
    # out against its row maximum; synthesis_mem, the synthesised frame's
    # second half, against the row maximum of the whole frame (a near-silent
    # stream's second half can lie below the f32 rounding of its spectrum)
    frame_max = torch.maximum((p_post[0] - p_args[9]).abs().amax(1),
                              p_post[1].abs().amax(1)).clamp(min=1e-30)
    post_err = max(rel_row_err(k_post[0], p_post[0]),
                   float(((k_post[1] - p_post[1]).abs().amax(1) / frame_max).max()))
    lastg_err = float((k_post[2] - p_post[2]).abs().max())
    log(f"[kernels] postfilter_synthesis max err / row max {post_err:.3e} (<= 1e-4), "
        f"lastg err {lastg_err:.3e} (<= 2e-5)")
    check(post_err <= 1e-4 and lastg_err <= 2e-5,
          "postfilter_synthesis disagrees with its plain version")
    # inputs read once (dX, dP, six [S, 32] band arrays, the silence bytes,
    # synthesis_mem, the band and interpolation tables), out, synthesis_mem
    # and lastg written once; operations as one real 960-point FFT with the
    # window and overlap-add, and per bin the comb, renormalisation and gain
    # (three 2-term interpolations and six products)
    post_bound = bound(4 * S * (2 * 962 + 6 * 32 + 480 + 480 + 480 + 32) + S
                       + 4 * 2 * 32 * 481,
                       S * (FFT_OPS + 2 * 960 + 481 * 18))
    post_rec = dict(
        name="postfilter_synthesis", route="cuda", source="rnnoise_tpu_torch/csrc/spectral.cu",
        replaces="rnnoise_tpu/dsp/pallas_spectral.py:489",
        max_abs_err=float(max((a - b).abs().max() for a, b in zip(k_post, p_post))),
        ms=gpu_time(lambda: spec.postfilter_synthesis(*p_args)),
        host_ms=gpu_time(lambda: spec.postfilter_synthesis(*p_args), hold=False),
        plain_ms=gpu_time(lambda: spec.postfilter_synthesis_plain(*p_args)),
        bound_ms=post_bound[0], bound_by=post_bound[1],
        library_ms=None)

    # the whole-chunk kernel: T_MONO frames at S=1024 from the state the
    # fused configuration leaves after 10 frames of generated PCM
    mono_pcm = signals(S, 10 + T_MONO, dev, SEED + 4, quiet=range(0, S, 16))
    warm, _, _ = process_frames_tm_i16(params, init_state(S, cfg, dev), mono_pcm[:10],
                                       CONFIGURATIONS["fused"])
    chunk20 = mono_pcm[10:].contiguous()
    warm_pbuf = warm.pitch_buf.clone()
    k_st, k_out, k_vad = cuda_frame.process_chunk_monokernel(params, warm, chunk20)
    p_st, p_out, p_vad = cuda_frame.process_chunk_monokernel_plain(params, warm, chunk20)
    torch.cuda.synchronize()
    check(torch.equal(warm.pitch_buf, warm_pbuf), "the monokernel wrote its input state")
    mono_pcm_err = int((k_out.int() - p_out.int()).abs().max())
    mono_vad_err = float((k_vad - p_vad).abs().max())
    mono_g_err = float((k_st.lastg - p_st.lastg).abs().max())
    mono_t0 = int((k_st.last_period != p_st.last_period).sum())
    log(f"[kernels] process_chunk_monokernel S={S} T={T_MONO}: PCM {mono_pcm_err} LSB "
        f"(<= 4), VAD {mono_vad_err:.3e} (<= 2e-3), lastg {mono_g_err:.3e} (<= 1e-3), "
        f"final T0 differs in {mono_t0} of {S} streams (<= 2)")
    check(mono_pcm_err <= 4 and mono_vad_err <= 2e-3 and mono_g_err <= 1e-3
          and mono_t0 <= 2, "process_chunk_monokernel disagrees with its plain version")
    # bytes: the state read once and written once, the int16 PCM in and out,
    # the VAD out; operations per stream and frame at FFT-level counts: the
    # analysis row's and the post-filter row's, the coarse correlation as
    # three real 512-point FFTs, the decimation, autocorrelations and FIR5,
    # the biquad's recurrence (4 multiply-adds a sample), the band sums (two
    # bands a bin), both DCTs and the int16 conversions; and the network's
    # nonzero weights once for each stream-frame that is not silent (VAD 0)
    st_leaves = [u for t in warm for u in (t if isinstance(t, tuple) else (t,))]
    mono_bytes = (2 * sum(u.numel() * u.element_size() for u in st_leaves)
                  + 2 * 2 * chunk20.numel() + 4 * k_vad.numel())
    frame_ops = (3 * FFT1024_OPS + 6 * 513 + 3 * 864 + 2 * (FFT_OPS + 960 + 962)
                 + FFT_OPS + 2 * 960 + 481 * 18
                 + 3 * 2.5 * 512 * 9 + 6 * 257 + 864 * 23
                 + 480 * 8 + 3 * 481 * 3 + 3 * 2 * 2 * 481 + 2 * 2 * 32 * 32
                 + 2 * 480)
    mono_active = int((k_vad != 0).sum())
    mono_t_ops = (S * T_MONO * frame_ops / F32_PEAK
                  + 2 * mono_active * (q_nnz / INT8_PEAK + f_nnz / F32_PEAK))
    mono_ms = gpu_time(lambda: cuda_frame.process_chunk_monokernel(params, warm, chunk20),
                       reps=5)
    mono_rec = dict(
        name="process_chunk_monokernel", route="cuda",
        source="rnnoise_tpu_torch/csrc/frame.cu",
        replaces="rnnoise_tpu/dsp/pallas_frame.py:865",
        max_abs_err=float(max(mono_pcm_err, mono_vad_err, mono_g_err)),
        ms=mono_ms, ms_per_frame=mono_ms / T_MONO,
        host_ms=gpu_time(lambda: cuda_frame.process_chunk_monokernel(
            params, warm, chunk20), reps=5, hold=False),
        plain_ms=gpu_time(lambda: cuda_frame.process_chunk_monokernel_plain(
            params, warm, chunk20), reps=2),
        bound_ms=1e3 * max(mono_bytes / MEM_BW, mono_t_ops),
        bound_by="bytes" if mono_bytes / MEM_BW >= mono_t_ops else "operations",
        library_ms=None)
    log(f"[kernels] process_chunk_monokernel {mono_ms:.3f} ms per chunk of {T_MONO} "
        f"frames ({mono_ms / T_MONO:.4f} ms per frame), plain {mono_rec['plain_ms']:.1f} ms, "
        f"bound {mono_rec['bound_ms']:.4f} ms ({mono_rec['bound_by']})")

    # the f64 floor of each redesigned span's own arithmetic, a figure of its
    # design (fft_plan's and the lag tiles' operation counts at F64_RATE and
    # F64_TC_RATE), logged beside the measured times and not part of the
    # kernels line; the analysis' and the monokernel's earlier design ran the
    # lag table and energies on the f64 pipe (2 x LAG_F64_OPS a stream)
    mono_vec, mono_mma = mono_f64_ops()
    f64_floor_ms = {
        "forward_spectral": design_floor_ms(S, fft_plan.f64_ops_per_stream()),
        "inverse_spectral": design_floor_ms(S, fft_plan.inverse_f64_ops_per_stream()),
        "lag_corr_table": design_floor_ms(S, LAG_F64_OPS),
        "analysis_spectral": design_floor_ms(
            S, lag_vec + fft_plan.f64_ops_per_stream(), lag_mma),
        "postfilter_synthesis": design_floor_ms(
            S, BAND_NNZ + fft_plan.inverse_f64_ops_per_stream()),
        "process_chunk_monokernel": design_floor_ms(
            S, T_MONO * mono_vec, T_MONO * mono_mma)}
    old_floor_ms = {
        "analysis_spectral": design_floor_ms(
            S, 2 * LAG_F64_OPS + fft_plan.f64_ops_per_stream()),
        "process_chunk_monokernel": design_floor_ms(
            S, T_MONO * (mono_vec - lag_vec + 2 * 385 * 480))}
    for rec in (fwd_rec, inv_rec, xc_rec, an_rec, post_rec, mono_rec):
        old = old_floor_ms.get(rec["name"])
        log(f"[kernels] {rec['name']} {rec['ms']:.4f} ms (host-inclusive "
            f"{rec['host_ms']:.4f} ms), library "
            f"{rec['library_ms'] if rec['library_ms'] is None else round(rec['library_ms'], 4)}"
            f" ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), f64 floor of "
            f"its design {f64_floor_ms[rec['name']]:.4f} ms"
            + ("" if old is None else f" (the f64-pipe design's {old:.4f} ms)"))
    counted = ((rnn_rec, cuda_rnn.compute_rnn_step),
               (fwd_rec, spec.forward_spectral), (inv_rec, spec.inverse_spectral),
               (xc_rec, cuda_xcorr.lag_corr_table_kernel),
               (an_rec, cuda_analysis.analysis_spectral),
               (post_rec, spec.postfilter_synthesis),
               (mono_rec, cuda_frame.process_chunk_monokernel))
    path_kernels = {
        "scan": ("rnn_step", "forward_spectral", "inverse_spectral"),
        "xcorr": ("rnn_step", "forward_spectral", "inverse_spectral", "lag_corr_table"),
        "fused": ("analysis_spectral", "rnn_step", "postfilter_synthesis"),
        "mono": ("process_chunk_monokernel",)}
    for rec, _ in counted:
        rec["launches"] = 0
        rec["launches_by_path"] = {}

    def zero_counts():
        for _, fn in counted:
            fn.launches = 0

    # 3. the main path, in each configuration -------------------------------
    pcm = signals(S_MAIN, 2 * T_MAIN, dev, SEED, quiet=range(0, S_MAIN, 16))
    pcm64 = signals(S_PARITY, T_PARITY, dev, SEED + 1, quiet=range(0, S_PARITY, 8))
    states = {}
    for path, rt in CONFIGURATIONS.items():
        T_path = T_SLOW if path in ("scan", "xcorr") else T_MAIN
        state = init_state(S_MAIN, cfg, dev)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        for c in range(2):
            state, out, vad = process_frames_tm_i16(
                params, state, pcm[c * T_path:(c + 1) * T_path], rt)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        states[path] = state
        for rec, fn in counted:
            rec["launches_by_path"][path] = fn.launches
            rec["launches"] += fn.launches
        log(f"[main:{path}] S={S_MAIN} T={T_path} x2 chained: {main_s:.2f} s, launches "
            + ", ".join(f"{r['name']}={fn.launches}" for r, fn in counted))
        for rec, fn in counted:
            check((fn.launches > 0) == (rec["name"] in path_kernels[path]),
                  f"{path} path launched {rec['name']} {fn.launches} times")
        if path == "mono":
            check(cuda_frame.process_chunk_monokernel.launches == 2,
                  "the mono path did not launch its kernel once per chunk")
            mono_rec["launches_per_frame"] = 2 / (2 * T_path)
        check(tuple(out.shape) == (T_path, S_MAIN, 480) and out.dtype == torch.int16,
              "main path output shape")
        check(bool(torch.isfinite(vad).all()) and tuple(vad.shape) == (T_path, S_MAIN),
              "main path VAD")
        for name, t in zip(state._fields, state):
            for u in (t if isinstance(t, tuple) else (t,)):
                check(bool(torch.isfinite(u.float()).all()), f"state {name} not finite")

        st_k, out_k, vad_k = process_frames_tm_i16(
            params, init_state(S_PARITY, cfg, dev), pcm64, rt)
        st_p, out_p, vad_p = process_frames_tm_i16(
            params, init_state(S_PARITY, cfg, dev), pcm64, rt, plain=True)
        pcm_err = int((out_k.int() - out_p.int()).abs().max())
        vad_err = float((vad_k - vad_p).abs().max())
        g_err = float((st_k.lastg - st_p.lastg).abs().max())
        per_flips = int((st_k.last_period != st_p.last_period).sum())
        log(f"[main:{path}] {T_PARITY} frames S={S_PARITY}, kernels vs plain: PCM "
            f"{pcm_err} LSB (<= 4), VAD {vad_err:.2e} (<= 2e-3), lastg {g_err:.2e} "
            f"(<= 1e-3), final periods differing {per_flips}")
        check(pcm_err <= 4 and vad_err <= 2e-3 and g_err <= 1e-3,
              f"{path}: kernel path leaves the parity budget of the plain path")

    # 4. serving, on the default configuration ---------------------------------
    default = next(p for p, rt in CONFIGURATIONS.items() if rt == rt_config.DEFAULT_RUNTIME)
    zero_counts()
    T_CH = 8
    audio = signals(16, 4 * T_CH, dev, SEED + 2).transpose(0, 1).reshape(16, -1).cpu().numpy()
    for pipelined in (False, True):
        eng = StreamingEngine(16, model, chunk_frames=T_CH, pipelined=pipelined)
        slots = [eng.attach() for _ in range(16)]
        check(sorted(slots) == list(range(16)) and eng.attach() == -1, "attach")
        n = 3 * T_CH * 480
        for s in slots:
            eng.push(s, audio[s, :n])
        advanced = [eng.tick() for _ in range(3)] + [eng.flush()]
        eng.detach(5)
        check(eng.attach() == 5, "re-attach")
        eng.push(5, audio[5, n:])
        advanced.append(eng.tick())
        advanced.append(eng.flush())
        check(sum(advanced) == 3 * 16 + 1, f"advanced {advanced}")
        got = [eng.pull(s, 4 * n) for s in slots]
        check(all(len(o) == n for i, o in enumerate(got) if i != 5), "output length")
        check(len(got[5]) == T_CH * 480 and bool(np.isfinite(got[5]).all()), "re-attached output")
        for name, t in zip(eng.state._fields, eng.state):
            for u in (t if isinstance(t, tuple) else (t,)):
                check(bool(torch.isfinite(u.float()).all()), f"engine state {name}")
        log(f"[serve] pipelined={pipelined}: advanced {advanced}, outputs ok")
    serve_counts = {r["name"]: fn.launches for r, fn in counted}
    log(f"[serve] configuration {default}, launches", serve_counts)
    check(all((v > 0) == (k in path_kernels[default]) for k, v in serve_counts.items()),
          "serving path skipped a kernel of its configuration")

    # 5. timing: chained chunks, the configurations in turns ------------------
    chunk = pcm[:T_MAIN]
    times = {path: [] for path in CONFIGURATIONS}
    for _ in range(TIMING_ROUNDS):
        for path, rt in CONFIGURATIONS.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[path], out, vad = process_frames_tm_i16(params, states[path], chunk, rt)
            torch.cuda.synchronize()
            times[path].append(time.perf_counter() - t0)
    streams = {}
    for path, ts in times.items():
        med = float(np.median(ts))
        streams[path] = S_MAIN * T_MAIN * 0.01 / med
        log(f"[timing:{path}] S={S_MAIN} T={T_MAIN}, median of {len(ts)} chained chunks "
            f"{med * 1e3:.1f} ms (" + ", ".join(f"{t * 1e3:.1f}" for t in ts)
            + f"): {streams[path]:.1f} realtime streams on {smi}")
    log(f"[timing] most realtime streams: {max(streams, key=streams.get)}; "
        f"default configuration: {default}")

    # 6. the training path -----------------------------------------------------
    t0 = time.perf_counter()
    train = phase_train(dev, smi, counted)
    log(f"[train] phase 6 took {time.perf_counter() - t0:.1f} s: "
        + json.dumps(train))

    # 7. the rest of serving, sharding, the data-parallel step, utils -------
    t0 = time.perf_counter()
    serving = phase_serving_rest(dev, smi, counted, model, audio)
    log(f"[serving] phase 7 took {time.perf_counter() - t0:.1f} s: "
        + json.dumps(serving))

    print(json.dumps({"kernels": [rec for rec, _ in counted]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(2)
