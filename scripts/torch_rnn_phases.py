#!/usr/bin/env python3
"""Where the RNN-step kernel's time goes, phase by phase, on one GPU.

    python3 scripts/torch_rnn_phases.py [--streams 1024]

Run from the repo root on a CUDA machine.  Builds csrc/rnn_step.cu with
-DRNNT_PHASES, so that rnn_body.cuh's phase marks record clock64() at the
end of each phase (lane 0 of every warp of the first 256 blocks), launches
the step once at S streams of the full model, and prints for each phase the
median over blocks of the slowest warp's cycle count at the phase's end, the
phase's own cycles, and those cycles in microseconds at the clock the run
implies (the kernel's time per call by chip_smoke.gpu_time over its median
block's cycles).  The marks cost a few stores; the kernel's time is printed
beside them.  With --cold, each step follows a launch of the analysis
kernel (other code and data, as inside the whole-chunk kernel, where each
frame's spans run between two steps): the step's time is then the median
of the steps timed one at a time by CUDA events, and the phases are the
last such step's.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import MODEL, SLEEP_CYCLES_PER_S, gpu_time  # noqa: E402

PHASES = (["start", "staged (inputs, conv1 weights, schedule)", "conv1",
           "conv2 input packed", "conv2 products", "conv2 barrier"]
          + [f"GRU {l + 1} {p}" for l in range(3)
             for p in ("input and state packed", "products and gates", "barrier")]
          + ["heads"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=1024)
    ap.add_argument("--cold", action="store_true",
                    help="launch the analysis kernel before each timed step")
    args = ap.parse_args()
    import torch

    from rnnoise_tpu_torch import kernels
    from rnnoise_tpu_torch.models.rnn import RNNState
    from rnnoise_tpu_torch.nn import cuda_rnn
    from rnnoise_tpu_torch.weights.loader import load_model_file
    if not torch.cuda.is_available():
        print("torch_rnn_phases: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0], flush=True)
    kernels.compile_libraries({"rnn_step": [
        kernels.nvcc(), *kernels.NVCC_FLAGS, "-DRNNT_PHASES",
        os.path.join(kernels.CSRC_DIR, "rnn_step.cu")]})
    lib = kernels.library("rnn_step")
    dev, S = torch.device("cuda"), args.streams
    params = load_model_file(MODEL, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    feats = torch.randn(S, 65, generator=g, device=dev)
    st = RNNState(*(torch.tanh(torch.randn(S, w, generator=g, device=dev))
                    for w in (130, 256, 384, 384, 384)))
    sil = torch.rand(S, generator=g, device=dev) < 0.125
    def step():
        return cuda_rnn.compute_rnn_step(params, st, feats, sil)
    if args.cold:
        from rnnoise_tpu_torch.dsp import cuda_analysis
        pbuf = 3000 * torch.randn(S, 1728, generator=g, device=dev)
        ds = 300 * torch.randn(S, 864, generator=g, device=dev)
        bp = torch.randint(0, 147, (2, S), generator=g, device=dev, dtype=torch.int32)
        prev = torch.randint(60, 700, (S,), generator=g, device=dev, dtype=torch.int32)
        an = (pbuf[:, -960:-480].contiguous(), pbuf[:, -480:].contiguous(), pbuf, ds,
              bp[0], bp[1], prev, torch.rand(S, generator=g, device=dev))
        times = []
        for _ in range(21):
            # the card held busy while the host enqueues, so the step starts
            # as the analysis ends (chip_smoke.gpu_time's way)
            torch.cuda._sleep(int(1e-3 * SLEEP_CYCLES_PER_S))
            cuda_analysis.analysis_spectral(*an)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            step()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        ms = float(np.median(times[1:]))
    else:
        ms = gpu_time(step)
        step()
    torch.cuda.synchronize()
    n_blocks = min(256, -(-S // 8))
    buf = (ctypes.c_longlong * (256 * cuda_rnn.RNN_WARPS * len(PHASES)))()
    kernels.check(lib.rnnt_rnn_phases(buf), "rnnt_rnn_phases")
    clk = np.frombuffer(buf, dtype=np.int64).reshape(256, cuda_rnn.RNN_WARPS, len(PHASES))
    clk = clk[:n_blocks].astype(np.float64)
    ends = clk - clk[:, :, :1].min(axis=1, keepdims=True)    # since the block began
    ends = np.median(ends.max(axis=1), axis=0)               # slowest warp, median block
    us_per_cycle = 1e3 * ms / ends[-1]
    print(f"S={S}{' after the analysis kernel' if args.cold else ''}: "
          f"{ms * 1e3:.2f} us per call, {ends[-1]:.0f} cycles in the median "
          f"block ({1 / us_per_cycle / 1e3:.3f} GHz implied)", flush=True)
    for k, name in enumerate(PHASES):
        own = ends[k] - (ends[k - 1] if k else 0.0)
        print(f"{name:42s} ends at {ends[k]:9.0f} cycles; its own {own:8.0f} "
              f"cycles, {own * us_per_cycle:6.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
