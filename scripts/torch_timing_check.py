#!/usr/bin/env python3
"""Check chip_smoke.py's timing against the profiler's kernel time, for the
forward and inverse spectra, the lag table and the RNN step, and the
PyTorch calls they are held against (``torch.fft.rfft``,
``torch.fft.irfft``, the grouped ``conv1d`` of pitch.batched_xcorr), at
S=1024 on one GPU.

    python3 scripts/torch_timing_check.py [--streams 1024]

For each call it prints four times in microseconds per call:

- ``held``: chip_smoke.gpu_time, the card held busy while the host enqueues
  (a record's ``ms``, ``plain_ms`` and ``library_ms``);
- ``issued``: gpu_time without holding the card, so the events see the host's
  time to enqueue where that is the longer (a record's ``host_ms``);
- ``enqueue``: the host's wall time per call over 200 calls, not synchronised;
- ``profiler``: the device time of the kernels the call launches, from
  torch.profiler's key_averages over 50 calls.

``held`` should sit within a few microseconds above ``profiler``: the gap is
the time between kernels back to back.
"""

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import gpu_time  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=1024)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import MODEL
    from rnnoise_tpu_torch.dsp import cuda_spectral as spec
    from rnnoise_tpu_torch.dsp import cuda_xcorr, pitch
    from rnnoise_tpu_torch.models.rnn import RNNState
    from rnnoise_tpu_torch.nn import cuda_rnn
    from rnnoise_tpu_torch.weights.loader import load_model_file
    if not torch.cuda.is_available():
        print("torch_timing_check: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0], flush=True)
    dev, S = torch.device("cuda"), args.streams
    g = torch.Generator(device=dev).manual_seed(1)
    mem, x = (3000 * torch.randn(S, 480, generator=g, device=dev) for _ in range(2))
    pbuf = 3000 * torch.randn(S, 1728, generator=g, device=dev)
    start = torch.randint(0, 709, (S,), generator=g, device=dev, dtype=torch.int32)
    ds = 300 * torch.randn(S, 864, generator=g, device=dev)
    win = spec.kernel_tables(str(dev))[0]
    both = torch.cat([torch.cat([mem, x], 1), spec.take_window(pbuf, start)]) * win
    x_win = ds[:, 384:].contiguous()
    Y = spec.forward_spectral(mem, x, pbuf, start)[0]
    Yc = torch.complex(Y[:, :481], Y[:, 481:])
    params = load_model_file(MODEL, device=dev)
    feats = torch.randn(S, 65, generator=g, device=dev)
    st = RNNState(*(torch.tanh(torch.randn(S, w, generator=g, device=dev))
                    for w in (130, 256, 384, 384, 384)))
    sil = torch.rand(S, generator=g, device=dev) < 0.125
    cases = {"forward_spectral": lambda: spec.forward_spectral(mem, x, pbuf, start),
             "rfft": lambda: torch.fft.rfft(both, dim=-1),
             "inverse_spectral": lambda: spec.inverse_spectral(Y),
             "irfft": lambda: torch.fft.irfft(Yc, n=960, dim=-1),
             "rnn_step": lambda: cuda_rnn.compute_rnn_step(params, st, feats, sil),
             "lag_corr_table": lambda: cuda_xcorr.lag_corr_table_kernel(ds),
             "grouped conv1d": lambda: pitch.batched_xcorr(x_win, ds, 385)}
    for name, fn in cases.items():
        held = 1e3 * gpu_time(fn)
        issued = 1e3 * gpu_time(fn, hold=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        enqueue = 1e6 * (time.perf_counter() - t0) / 200
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
        device = [(e.key, e.device_time_total / 50) for e in prof.key_averages()
                  if e.device_time_total > 0]
        total = sum(t for _, t in device)
        print(f"{name}: held {held:.2f} us, issued {issued:.2f} us, enqueue "
              f"{enqueue:.2f} us, profiler {total:.2f} us "
              f"({', '.join(f'{k[:48]} {t:.2f}' for k, t in device)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
