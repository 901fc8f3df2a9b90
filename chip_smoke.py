#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main path on one GPU.

    python3 chip_smoke.py

Phases, in order (each prints as it goes; any failure exits non-zero):

1. build   — compile csrc/*.cu with nvcc for sm_90a, one process per source.
2. kernels — each kernel against its plain PyTorch version on the card, at
             the main path's shapes (S=1024, the full rnnoise_synth_v1 model),
             timed beside the plain version and one PyTorch library call.
3. main    — process_frames_tm_i16 at S=1024, T=100, two chained calls with
             the launch counters zeroed before and read after; then 150
             stateful frames at S=64 through the kernels and through the
             plain versions, held to the parity budget.
4. serve   — StreamingEngine with 16 slots: ticks, a detach and re-attach,
             pipelined mode and flush.
5. timing  — one chained chunk at S=1024, T=100: realtime streams per card.

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
FFT_OPS = 2.5 * 960 * np.log2(960)   # flops of one real 960-point FFT
S_MAIN, T_MAIN = 1024, 100
S_PARITY, T_PARITY = 64, 150
SEED = 1234


def log(*a):
    print(*a, flush=True)


class Failure(Exception):
    pass


def check(ok, what):
    if not ok:
        raise Failure(what)


def gpu_time(fn, reps=20):
    """Milliseconds per call by CUDA events, after two warm-up calls."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from rnnoise_tpu_torch import kernels
    from rnnoise_tpu_torch.api import RNNoise
    from rnnoise_tpu_torch.config import resolve_device
    from rnnoise_tpu_torch.denoise import init_state, process_frames_tm_i16
    from rnnoise_tpu_torch.dsp import cuda_spectral as spec
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
    fwd_bytes = 4 * (S * (480 + 480 + 960 + 1 + 2 * 962) + 960)
    fwd_ops = S * 2 * (FFT_OPS + 960 + 962)
    fwd_rec = dict(
        name="forward_spectral", route="cuda", source="rnnoise_tpu_torch/csrc/spectral.cu",
        replaces="rnnoise_tpu/dsp/pallas_spectral.py:388",
        max_abs_err=float(max((kX - pX).abs().max(), (kP - pP).abs().max())),
        ms=gpu_time(lambda: spec.forward_spectral(mem, x, pbuf, start)),
        plain_ms=gpu_time(lambda: spec.forward_spectral_plain(mem, x, pbuf, start)),
        bound_ms=1e3 * max(fwd_bytes / MEM_BW, fwd_ops / F32_PEAK),
        bound_by="bytes" if fwd_bytes / MEM_BW >= fwd_ops / F32_PEAK else "operations",
        library_ms=gpu_time(lambda: torch.fft.rfft(both, dim=-1)))

    Y = kX
    k_out = spec.inverse_spectral(Y)
    p_out = spec.inverse_spectral_plain(Y)
    torch.cuda.synchronize()
    inv_err = rel_row_err(k_out, p_out)
    log(f"[kernels] inverse_spectral max err / row max {inv_err:.3e} (tolerance 1e-4)")
    check(inv_err <= 1e-4, "inverse_spectral disagrees with its plain version")
    Yc = torch.complex(Y[:, :481], Y[:, 481:])
    inv_bytes = 4 * (S * (962 + 960) + 960)
    inv_ops = S * (FFT_OPS + 960)                 # one real FFT, the window
    inv_rec = dict(
        name="inverse_spectral", route="cuda", source="rnnoise_tpu_torch/csrc/spectral.cu",
        replaces="rnnoise_tpu/dsp/pallas_spectral.py:538",
        max_abs_err=float((k_out - p_out).abs().max()),
        ms=gpu_time(lambda: spec.inverse_spectral(Y)),
        plain_ms=gpu_time(lambda: spec.inverse_spectral_plain(Y)),
        bound_ms=1e3 * max(inv_bytes / MEM_BW, inv_ops / F32_PEAK),
        bound_by="bytes" if inv_bytes / MEM_BW >= inv_ops / F32_PEAK else "operations",
        library_ms=gpu_time(lambda: torch.fft.irfft(Yc, n=960, dim=-1)))

    counted = ((rnn_rec, cuda_rnn.compute_rnn_step),
               (fwd_rec, spec.forward_spectral), (inv_rec, spec.inverse_spectral))

    def zero_counts():
        for _, fn in counted:
            fn.launches = 0

    # 3. the main path -----------------------------------------------------
    pcm = signals(S_MAIN, 2 * T_MAIN, dev, SEED, quiet=range(0, S_MAIN, 16))
    state = init_state(S_MAIN, cfg, dev)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for c in range(2):
        state, out, vad = process_frames_tm_i16(
            params, state, pcm[c * T_MAIN:(c + 1) * T_MAIN])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    for rec, fn in counted:
        rec["launches"] = fn.launches
    log(f"[main] S={S_MAIN} T={T_MAIN} x2 chained: {main_s:.2f} s, launches "
        + ", ".join(f"{r['name']}={r['launches']}" for r, _ in counted))
    for rec, _ in counted:
        check(rec["launches"] > 0, f"main path never launched {rec['name']}")
    check(tuple(out.shape) == (T_MAIN, S_MAIN, 480) and out.dtype == torch.int16,
          "main path output shape")
    check(bool(torch.isfinite(vad).all()) and tuple(vad.shape) == (T_MAIN, S_MAIN),
          "main path VAD")
    for name, t in zip(state._fields, state):
        for u in (t if isinstance(t, tuple) else (t,)):
            check(bool(torch.isfinite(u.float()).all()), f"state {name} not finite")

    pcm64 = signals(S_PARITY, T_PARITY, dev, SEED + 1, quiet=range(0, S_PARITY, 8))
    st_k, out_k, vad_k = process_frames_tm_i16(params, init_state(S_PARITY, cfg, dev), pcm64)
    st_p, out_p, vad_p = process_frames_tm_i16(params, init_state(S_PARITY, cfg, dev), pcm64,
                                               plain=True)
    pcm_err = int((out_k.int() - out_p.int()).abs().max())
    vad_err = float((vad_k - vad_p).abs().max())
    g_err = float((st_k.lastg - st_p.lastg).abs().max())
    per_flips = int((st_k.last_period != st_p.last_period).sum())
    log(f"[main] {T_PARITY} frames S={S_PARITY}, kernels vs plain: PCM {pcm_err} LSB "
        f"(<= 4), VAD {vad_err:.2e} (<= 2e-3), lastg {g_err:.2e} (<= 1e-3), "
        f"final periods differing {per_flips}")
    check(pcm_err <= 4 and vad_err <= 2e-3 and g_err <= 1e-3,
          "kernel path leaves the parity budget of the plain path")

    # 4. serving -------------------------------------------------------------
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
    log("[serve] launches", serve_counts)
    check(all(v > 0 for v in serve_counts.values()), "serving path skipped a kernel")

    # 5. timing --------------------------------------------------------------
    chunk = pcm[:T_MAIN]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, out, vad = process_frames_tm_i16(params, state, chunk)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    streams = S_MAIN * T_MAIN * 0.01 / dt
    log(f"[timing] one chained chunk S={S_MAIN} T={T_MAIN}: {dt * 1e3:.1f} ms, "
        f"{streams:.1f} realtime streams on {smi}")

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
