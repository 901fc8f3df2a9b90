#!/usr/bin/env python3
"""Count the machine instructions of the port's kernels by kind, from the
SASS that nvcc compiles for sm_90a, for this checkout's sources and,
optionally, another checkout's.

    python3 scripts/torch_sass_census.py [--against OTHER/rnnoise_tpu_torch/csrc]

Run on a machine with the CUDA toolkit (nvcc and cuobjdump).  Compiles each
csrc/*.cu to a cubin, disassembles it with cuobjdump -sass and prints, per
kernel, the static count of the f64 arithmetic (DFMA, DADD, DMUL), the f64
tensor-core products (DMMA), the int8 dot products (IDP, the IDP.4A of __dp4a) and int8 tensor-core
products (IMMA), the conversions to and from f64 (F2F), the shared and
device memory accesses (LDS, STS, LDG, STG), the shuffles and the
barriers, and all instructions (SASS, the code's size); and, from ptxas (-Xptxas -v), each kernel's registers, stack frame
and spill stores and loads in bytes.  Static counts say
what a loop body holds, not how often it runs: read them beside the
kernel's own loop structure.
"""

import argparse
import collections
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from rnnoise_tpu_torch import kernels  # noqa: E402

KINDS = ("DFMA", "DADD", "DMUL", "DMMA", "IDP", "IMMA", "F2F", "LDS", "STS", "LDG", "STG",
         "SHFL", "BAR")
KERNELS = ("rnn_step_kernel", "forward_kernel", "inverse_kernel", "postfilter_kernel",
           "xcorr_kernel", "analysis_kernel", "lag_energy_kernel", "chunk_kernel")


def kernel_name(symbol):
    """A kernel's short name, or a device function's (frame.cu's spans)."""
    span = re.search(r"(span_[a-z]+)E", symbol)
    return span.group(1) if span else next((k for k in KERNELS if k in symbol), symbol)


def resources(ptxas_log):
    """{kernel name: (registers, stack bytes, spill stores, spill loads)}
    from ptxas' -v report."""
    out, name = {}, None
    for line in ptxas_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            out[name] = [0, 0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name is not None:
            out[name][1:] = [int(v) for v in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name][0] = int(m.group(1))
    return out


def census(cu_path, workdir):
    """({kernel name: Counter of instruction kinds}, resources()) of one
    source."""
    cubin = os.path.join(workdir, os.path.basename(cu_path) + ".cubin")
    log = subprocess.run([kernels.nvcc(), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
                          "-std=c++17", "-O3", "-Xptxas", "-v", "-o", cubin, cu_path],
                         check=True, capture_output=True, text=True)
    exe = os.path.join(os.path.dirname(kernels.nvcc()), "cuobjdump")
    sass = subprocess.run([exe, "-sass", cubin], check=True, capture_output=True,
                          text=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            out[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if m and name is not None:
            op = m.group(1)
            out[name]["SASS"] += 1
            for kind in KINDS:
                if op.startswith(kind):
                    out[name][kind] += 1
    return out, resources(log.stdout + log.stderr)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", help="another checkout's rnnoise_tpu_torch/csrc")
    a = ap.parse_args()
    trees = [("this", kernels.CSRC_DIR)] + ([("other", a.against)] if a.against else [])
    with tempfile.TemporaryDirectory() as work:
        for label, tree in trees:
            for src in kernels.KERNEL_SOURCES:
                d = os.path.join(work, label)
                os.makedirs(d, exist_ok=True)
                counts, res = census(os.path.join(tree, src + ".cu"), d)
                for name, c in counts.items():
                    reg, stack, st, ld = res.get(name, ("?",) * 4)
                    print(f"{label} {src}.cu {name}: "
                          + " ".join(f"{k}={c[k]}" for k in ("SASS",) + KINDS)
                          + f" registers={reg} stack={stack} spill_stores={st} "
                          f"spill_loads={ld}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
