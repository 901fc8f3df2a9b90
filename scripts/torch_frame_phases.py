#!/usr/bin/env python3
"""Where the whole-chunk kernel's time goes, span by span, on one GPU.

    python3 scripts/torch_frame_phases.py [--against OTHER/rnnoise_tpu_torch/csrc]

Run from the repo root on a CUDA machine.  Builds csrc/frame.cu with
-DRNNT_FRAME_PHASES, so that its phase marks record clock64() and the span's
kind at the end of each span of a frame (lane 0 of every warp of the first
132 blocks; the last frame's marks remain), runs the kernel over T=20 frames
at S=1024 streams of the full model from the state the fused configuration
leaves after 10 frames (chip_smoke.py phase 2's chunk), and prints for each
kind of span the median over blocks of its cycles (per mark, the slowest
warp's end minus the previous mark's; a kind's cycles summed over its marks
in the frame), those cycles in microseconds at the clock the run implies (the
median block's cycles from start to end over the kernel's time per call by
chip_smoke.gpu_time), and the kernel's time per frame.  With --against, the
other checkout's package (the directory above its csrc/) is imported under
another name and measured the same way in the same run, through its own
wrappers.  With --rnn, this checkout's build also records the network
step's own phases (rnn_body.cuh's marks, -DRNNT_PHASES) in the last frame and
prints them as scripts/torch_rnn_phases.py does.  The marks cost a few
stores a span; the marked kernel's time is printed beside them.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import MODEL, SEED, T_MONO, gpu_time, signals  # noqa: E402


def measure(label, mods, params, warm, chunk, rnn=False):
    """Builds mods' frame.cu with the marks, runs its kernel and prints the
    split (and, with rnn, the network step's phases)."""
    import torch
    kernels, cuda_frame = mods["kernels"], mods["cuda_frame"]
    log = kernels.compile_libraries({"frame": [
        kernels.nvcc(), *kernels.NVCC_FLAGS, "-DRNNT_FRAME_PHASES",
        *(["-DRNNT_PHASES"] if rnn else []),
        os.path.join(kernels.CSRC_DIR, "frame.cu")]})["frame"][1].splitlines()
    for i, line in enumerate(log[:-1]):               # ptxas: stack and spills
        if "Function properties for" in line:
            fn = re.search(r"(chunk_kernel|span_\w+?)E", line)
            print(f"[{label}] {fn.group(1) if fn else line.split()[-1]}: "
                  f"{log[i + 1].strip()}", flush=True)
    lib = kernels.library("frame")
    dims = (ctypes.c_int * 3)()
    names = ctypes.c_char_p()
    lib.rnnt_frame_phase_layout(dims, ctypes.byref(names))
    B, W, M = dims
    kinds = names.value.decode().split(";")
    T = chunk.shape[0]

    def run():
        return cuda_frame.process_chunk_monokernel(params, warm, chunk)
    ms = gpu_time(run, reps=5)
    run()
    torch.cuda.synchronize()
    clk = (ctypes.c_longlong * (B * W * M))()
    kind = (ctypes.c_int * (B * W * M))()
    count = (ctypes.c_int * (B * W))()
    span = (ctypes.c_longlong * (B * 3))()
    kernels.check(lib.rnnt_frame_phases(clk, kind, count, span), "rnnt_frame_phases")
    clk = np.frombuffer(clk, np.int64).reshape(B, W, M).astype(np.float64)
    kind = np.frombuffer(kind, np.int32).reshape(B, W, M)
    count = np.frombuffer(count, np.int32).reshape(B, W)
    span = np.frombuffer(span, np.int64).reshape(B, 3).astype(np.float64)
    nb = min(B, -(-chunk.shape[1] // 8))
    n = int(count[0, 0])
    if not (count[:nb] == n).all() or n > M or not (kind[:nb, :, :n] == kind[0, 0, :n]).all():
        raise SystemExit(f"{label}: the warps' marks differ in number or kind")
    seq = kind[0, 0, :n]
    ends = clk[:nb, :, :n] - clk[:nb, :, :1].min(axis=1, keepdims=True)
    ends = ends.max(axis=1)                                     # slowest warp
    own = np.diff(ends, axis=1, prepend=0.0)                    # [blocks, marks]
    per_kind = np.stack([own[:, seq == k].sum(axis=1) for k in range(len(kinds))], 1)
    med = np.median(per_kind, axis=0)
    frame = float(np.median(ends[:, -1]))
    whole = float(np.median(span[:nb, 2] - span[:nb, 0]))
    copy_in = float(np.median(span[:nb, 1] - span[:nb, 0]))
    us_per_cycle = 1e3 * ms / whole
    print(f"[{label}] S={chunk.shape[1]} T={T}: {ms:.4f} ms per call with the marks, "
          f"{ms / T:.4f} ms per frame; {whole:.0f} cycles in the median block "
          f"({1 / us_per_cycle / 1e3:.3f} GHz implied); the last frame {frame:.0f} "
          f"cycles, {frame * us_per_cycle:.2f} us, {n} marks", flush=True)
    print(f"[{label}] {'state copy-in (once a chunk)':36s} {copy_in:9.0f} cycles "
          f"{copy_in * us_per_cycle:8.2f} us", flush=True)
    for k, name in enumerate(kinds):
        if (seq == k).any() and k > 0:
            print(f"[{label}] {name:36s} {med[k]:9.0f} cycles {med[k] * us_per_cycle:8.2f} us"
                  f" ({100 * med[k] / frame:5.1f} % of the frame, {int((seq == k).sum())} "
                  f"marks)", flush=True)
    if rnn:
        from torch_rnn_phases import PHASES
        buf = (ctypes.c_longlong * (256 * 16 * len(PHASES)))()
        kernels.check(lib.rnnt_rnn_phases(buf), "rnnt_rnn_phases")
        clk = np.frombuffer(buf, np.int64).reshape(256, 16, len(PHASES))[:nb]
        clk = clk.astype(np.float64)
        ends = np.median((clk - clk[:, :, :1].min(axis=1, keepdims=True)).max(axis=1), axis=0)
        for k, name in enumerate(PHASES[1:], 1):
            own = ends[k] - ends[k - 1]
            print(f"[{label}] network: {name:42s} {own:8.0f} cycles "
                  f"{own * us_per_cycle:6.2f} us", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another checkout's rnnoise_tpu_torch/csrc")
    ap.add_argument("--streams", type=int, default=1024)
    ap.add_argument("--rnn", action="store_true",
                    help="also the network step's phases in this checkout's kernel")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_frame_phases: no CUDA device", file=sys.stderr)
        return 1
    import rnnoise_tpu_torch
    from rnnoise_tpu_torch.config import CONFIGURATIONS
    from rnnoise_tpu_torch.denoise import init_state, process_frames_tm_i16
    from rnnoise_tpu_torch.weights.loader import load_model_file
    from torch_kernel_bitwise import import_other, package_modules
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0], flush=True)
    dev, S = torch.device("cuda"), args.streams
    params = load_model_file(MODEL, device=dev)
    pcm = signals(S, 10 + T_MONO, dev, SEED + 4, quiet=range(0, S, 16))
    warm, _, _ = process_frames_tm_i16(params, init_state(S, device=dev), pcm[:10],
                                       CONFIGURATIONS["fused"])
    chunk = pcm[10:].contiguous()
    trees = [("this", package_modules(rnnoise_tpu_torch.__name__))]
    if args.against:
        trees.insert(0, ("other", import_other(args.against)))
    for label, mods in trees:
        measure(label, mods, params, warm, chunk, rnn=args.rnn and label == "this")
    return 0


if __name__ == "__main__":
    sys.exit(main())
