"""Build and load the hand-written kernels in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain ``extern "C"`` interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Sources build at first use in a
process, into ``_build/`` under a name of their own, and the file is removed
once loaded: a build never reuses an output or a lock found there.  Several
sources build in parallel, one compiler process each.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
import uuid

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
KERNEL_SOURCES = ("rnn_step", "spectral", "analysis", "frame")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def compile_libraries(commands: dict) -> dict:
    """Run one compiler process per library, all at once.

    ``commands`` maps a name to ``argv`` without the output path; each
    output goes to a fresh file in BUILD_DIR, is loaded and then unlinked.
    Returns ``{name: (seconds, compiler output)}``; raises on a failed
    build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, argv in commands.items():
        out = os.path.join(BUILD_DIR,
                           f"lib{name}-{os.getpid()}-{uuid.uuid4().hex}.so")
        procs[name] = (out, subprocess.Popen(
            list(argv) + ["-o", out], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        report[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        try:
            _LIBS[name] = ctypes.CDLL(out)
        finally:
            os.unlink(out)
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))
    return report


def build_kernels(names=KERNEL_SOURCES) -> dict:
    """Compile the named ``csrc/*.cu`` sources for sm_90a in parallel."""
    exe = nvcc()
    return compile_libraries({
        name: [exe, *NVCC_FLAGS, os.path.join(CSRC_DIR, f"{name}.cu")]
        for name in names})


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built at first use."""
    if name not in _LIBS:
        build_kernels((name,))
    return _LIBS[name]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc: int, what: str) -> None:
    """Raise on the CUDA error code a launch function returned."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def launch(fn, what: str, device: torch.device, *args) -> None:
    """Call the launch function ``fn`` with ``args`` and the current stream
    of ``device``, with ``device`` made the current one: the launch and the
    kernel's ``cudaFuncSetAttribute`` apply to the current device, which
    need not be the tensors'.  Raises on the error code it returns."""
    with torch.cuda.device(device):
        check(fn(*args, stream(device)), what)


def require(t: torch.Tensor, name: str, shape: tuple, dtype,
            device: torch.device) -> None:
    """Validate a kernel argument before its pointer is passed on."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")
