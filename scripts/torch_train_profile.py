#!/usr/bin/env python3
"""Where the time of the port's training path goes on the GPU.

    python3 scripts/torch_train_profile.py [--seqs 128] [--feature-frames 20] \
        [--train-frames 200] [--trace PATH]

Two profiles with torch.profiler (CPU and CUDA activities), each after a
warm-up: the feature extraction of training (training.features.
_sequence_features: the clean path's analysis and the noisy path's
features, S=--seqs streams of generated PCM over --feature-frames frames),
then one sparse train step at full width (cond 128, GRU 384, batch --seqs,
--train-frames frames, from step 6000).  For each it prints the wall time
(unprofiled and profiled), the device-busy time (sum of kernel times) and
its share of the profiled wall, kernel launches per frame or per GRU step,
and the operators that take the most device time; with --trace, writes the
train step's Chrome trace there.  Needs a CUDA device.
"""

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profiled(fn, torch):
    """(unprofiled wall s, profiled wall s, device busy us, launches, events)
    of fn() after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    return (wall, pwall, sum(e.self_device_time_total for e in kernels),
            sum(e.count for e in kernels), events, prof)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seqs", type=int, default=128)
    ap.add_argument("--feature-frames", type=int, default=20)
    ap.add_argument("--train-frames", type=int, default=200)
    ap.add_argument("--trace", help="write the train step's Chrome trace here")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from rnnoise_tpu_torch.config import resolve_device
    from rnnoise_tpu_torch.training import features, model
    from rnnoise_tpu_torch.training.train import make_optimizer, make_train_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = resolve_device("cuda")
    B, F, T = a.seqs, a.feature_frames, a.train_frames
    g = torch.Generator(device=dev).manual_seed(7)
    clean = 3000 * torch.randn(B, F * 480, generator=g, device=dev)
    noisy = clean + 300 * torch.randn(B, F * 480, generator=g, device=dev)
    lowpass = torch.randint(200, 482, (B,), generator=g, device=dev, dtype=torch.int32)
    wall, pwall, busy, launches, events, _ = profiled(
        lambda: features._sequence_features(clean, noisy, lowpass), torch)
    print(f"{smi}; feature extraction, S={B} over {F} frames: wall {wall * 1e3:.1f} ms "
          f"({100 * wall / F:.4f} s per 100 frames), profiled {pwall * 1e3:.1f} ms, "
          f"device busy {busy / 1e3:.1f} ms ({100 * busy / 1e6 / pwall:.1f}% of the "
          f"profiled wall), {launches / F:.1f} kernel launches a frame")
    print(events.table(sort_by="self_device_time_total", row_limit=12,
                       max_name_column_width=60))

    params = model.init_params(torch.Generator().manual_seed(0), device=dev)
    opt, sched = make_optimizer(params)
    step_fn = make_train_step(opt, sched, sparse=True)
    N = params["gru1"]["w_rec"].shape[0]
    batch = (torch.randn(B, T, 65, generator=g, device=dev),
             torch.rand(B, T, 32, generator=g, device=dev),
             (torch.rand(B, T, 1, generator=g, device=dev) < 0.5).float())
    states = tuple(torch.zeros(B, N, device=dev) for _ in range(3))
    wall, pwall, busy, launches, events, prof = profiled(
        lambda: step_fn(params, states, batch, 6000), torch)
    gru_steps = 3 * (T - 4)
    print(f"{smi}; one sparse train step, B={B} T={T} cond "
          f"{params['conv1']['b'].shape[0]} GRU {N}: wall {wall * 1e3:.1f} ms, profiled "
          f"{pwall * 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / 1e6 / pwall:.1f}% of the profiled wall), "
          f"{launches / gru_steps:.1f} kernel launches per GRU step "
          f"({launches} in all)")
    print(events.table(sort_by="self_device_time_total", row_limit=15,
                       max_name_column_width=60))
    if a.trace:
        prof.export_chrome_trace(a.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
