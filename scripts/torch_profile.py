#!/usr/bin/env python3
"""Where the time of the port's main path goes on the GPU.

    python3 scripts/torch_profile.py [--config fused] [--streams 1024] \
        [--frames 20] [--trace PATH]

Warms up, then profiles one chained process_frames_tm_i16 chunk in the
kernel configuration named (config.CONFIGURATIONS: scan, xcorr, fused or mono;
the default configuration when none is named) with torch.profiler (CPU and
CUDA activities).  Prints the wall time, the
device-busy time (sum of kernel times) and its share of the wall, launches
per frame, and the operators that take the most device time; with
--trace, writes the Chrome trace there.  Needs a CUDA device.
"""

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=("scan", "xcorr", "fused", "mono"))
    ap.add_argument("--streams", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--trace", help="write the Chrome trace to this path")
    a = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from rnnoise_tpu_torch.api import RNNoise
    from rnnoise_tpu_torch.config import CONFIGURATIONS, DEFAULT_RUNTIME
    from rnnoise_tpu_torch.denoise import init_state, process_frames_tm_i16

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    model = RNNoise.from_filename(os.path.join(REPO, "models",
                                               "rnnoise_synth_v1.blob"))
    S, T = a.streams, a.frames
    rt = CONFIGURATIONS[a.config] if a.config else DEFAULT_RUNTIME
    name = next(p for p, c in CONFIGURATIONS.items() if c == rt)
    g = torch.Generator(device="cuda").manual_seed(7)
    pcm = (3000 * torch.randn(3, T, S, 480, generator=g, device="cuda")).to(torch.int16)
    state = init_state(S, model.config, "cuda")
    for c in range(2):                                   # warm-up
        state, out, vad = process_frames_tm_i16(model.params, state, pcm[c], rt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, out, vad = process_frames_tm_i16(model.params, state, pcm[2], rt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side events only: operator rows repeat their kernels' time
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"{smi}; {name} configuration, S={S} T={T}: wall {wall * 1e3:.1f} ms "
          f"({wall * 1e3 / T:.2f} ms/frame), device busy {dev_us / 1e3:.1f} ms "
          f"({100 * dev_us / 1e6 / wall:.1f}% of wall), "
          f"{launches / T:.3g} kernel launches per frame")
    print(events.table(sort_by="self_device_time_total", row_limit=25,
                       max_name_column_width=60))
    if a.trace:
        prof.export_chrome_trace(a.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
