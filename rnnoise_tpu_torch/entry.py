"""The port's entry points, modelled on the repo's ``__graft_entry__.py``:
one batched denoise step, and a dry run of the multi-device paths.

    from rnnoise_tpu_torch import entry
    fn, args = entry.entry()              # 64 streams x 4 frames, on CUDA
    state, out, vad = fn(*args)
    entry.dryrun_multigpu(2)              # 2 processes, NCCL, cuda:0 and :1
    entry.dryrun_multigpu(2, device="cpu")    # 2 processes, gloo, CPUs

Both run on the card unless the caller names the CPU; nothing here runs on
import.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .config import DEFAULT_RUNTIME, FRAME_SIZE, NB_BANDS, NB_FEATURES

DRYRUN_TIMEOUT_S = 600


def entry(device="cuda"):
    """-> (fn, example_args): one batched denoise step of the registered
    model (models/rnnoise_synth_v1.blob) over 64 streams x 4 frames,
    ``fn(state, pcm) -> (state, out, vad)``."""
    from .denoise import init_state, process_frames
    from .weights.registry import load_registered

    params = load_registered(device=device)
    S, T = 64, 4
    state = init_state(S, device=device)
    rng = np.random.default_rng(0)
    pcm = torch.from_numpy((3000 * rng.standard_normal((S, T, FRAME_SIZE)))
                           .astype(np.float32)).to(state.mem_hp.device)

    def fn(state, pcm):
        return process_frames(params, state, pcm, DEFAULT_RUNTIME)

    return fn, (state, pcm)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dry run: wrong {what}")


def _dryrun_rank(rank: int, n: int, init_method: str, device_type: str) -> None:
    """One process of the dry run: its stream shard of one int16 inference
    step, then one data-parallel sparse train step; the ranks' params must
    agree afterwards."""
    import torch.distributed as dist

    from .denoise import init_state, process_frames_tm_i16
    from .parallel import multihost
    from .training.model import init_params, param_leaves
    from .training.train import make_optimizer, make_train_step
    from .weights.registry import load_registered

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    multihost.init_distributed(init_method, n, rank,
                               "nccl" if device_type == "cuda" else "gloo")
    try:
        rng = np.random.default_rng(0)
        # inference: this rank's rows of a global batch of 2n streams
        S, T = 2 * n, 2
        pcm = np.round(3000 * rng.standard_normal((T, S, FRAME_SIZE))).astype(
            np.int16)
        rows = multihost.process_stream_slice(S)
        params = load_registered(device=device)
        local = multihost.streams_from_host_local(pcm[:, rows], device)
        _, out, vad = process_frames_tm_i16(
            params, init_state(rows.stop - rows.start, device=device), local)
        mine = multihost.host_local_output(out)
        _require(mine.shape == (T, S // n, FRAME_SIZE)
                 and bool(torch.isfinite(vad).all()), "inference output")

        # training: this rank's rows of a global batch of 2n sequences
        tparams = init_params(torch.Generator().manual_seed(0), device=device)
        opt, sched = make_optimizer(tparams)
        step_fn = make_train_step(opt, sched, sparse=True,
                                  process_group=dist.group.WORLD)
        B, TT = 2 * n, 16
        batch = (rng.normal(0, 1.5, (B, TT, NB_FEATURES)),
                 rng.uniform(0, 1, (B, TT, NB_BANDS)),
                 rng.uniform(0, 1, (B, TT, 1)))
        batch = tuple(multihost.streams_from_host_local(
            a[multihost.process_stream_slice(B)].astype(np.float32), device)
            for a in batch)
        N = tparams["gru1"]["w_rec"].shape[0]
        states = tuple(torch.zeros(B // n, N, device=device) for _ in range(3))
        _, metrics = step_fn(tparams, states, batch, 0)
        _require(np.isfinite(float(metrics["loss"])), "train loss")
        # every rank took the same step
        check = torch.stack([t.detach().double().sum()
                             for t in param_leaves(tparams)])
        gathered = [torch.empty_like(check) for _ in range(n)]
        dist.all_gather(gathered, check)
        _require(all(torch.equal(g, check) for g in gathered),
                 "the ranks' params after the step")
    finally:
        dist.destroy_process_group()


def dryrun_multigpu(n: int, device: str = "cuda") -> None:
    """Start ``n`` processes that each run one sharded inference step and
    one data-parallel train step: on ``cuda:0 .. cuda:n-1`` with NCCL, or
    with ``device="cpu"`` on CPUs with gloo.  Raises if a process fails, or
    kills them all and raises if the run takes longer than
    DRYRUN_TIMEOUT_S."""
    device_type = torch.device(device).type
    if device_type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} processes need {n} CUDA devices, found "
                           f"{torch.cuda.device_count()}")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rdv = tempfile.mkdtemp(prefix="rnnt_dryrun_")
    init = f"file://{os.path.join(rdv, 'init')}"
    procs = []
    try:
        for rank in range(n):
            code = (f"import sys; sys.path.insert(0, {repo!r})\n"
                    "from rnnoise_tpu_torch.entry import _dryrun_rank\n"
                    f"_dryrun_rank({rank}, {n}, {init!r}, {device_type!r})\n")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], stdin=subprocess.DEVNULL,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        for rank, p in enumerate(procs):
            try:
                log, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"dry run took over {DRYRUN_TIMEOUT_S} s") \
                    from None
            if p.returncode != 0:
                raise RuntimeError(f"dry run rank {rank} exited with "
                                   f"{p.returncode}:\n{log[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(rdv, ignore_errors=True)
