"""Several processes, one or more per host — the counterpart of
``rnnoise_tpu/parallel/multihost.py`` over ``torch.distributed``.

Steady-state denoising needs no collective (streams are independent); only
training's gradient all-reduce crosses processes.  Every process

  1. calls ``init_distributed(...)`` (NCCL between cards, gloo on CPUs),
  2. takes its own rows of the global stream batch,
     ``process_stream_slice(S)``: rank r owns ``[r*per, (r+1)*per)``,
  3. moves its host-local audio and state onto its device
     (``streams_from_host_local``, ``tree_from_host_local``), runs the
     denoiser there, and reads its rows back (``host_local_output``).

Nothing here runs on import; nothing picks the CPU by itself.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..denoise import map_state

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join the process group: ``backend`` NCCL (the cards) unless the
    caller names another (``"gloo"`` for CPUs).  A no-op when a group
    exists already, or when called without arguments and the
    ``torch.distributed`` environment variables (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK) are absent: one process, nothing to join.  With no
    arguments and those variables set, they configure the group."""
    if dist.is_initialized():
        return
    if init_method is None and world_size is None and rank is None:
        if not all(k in os.environ for k in _ENV):
            return
        init_method = "env://"
    dist.init_process_group(backend or "nccl", init_method=init_method,
                            world_size=world_size, rank=rank)


def _rank_world() -> tuple:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_stream_slice(n_streams: int) -> slice:
    """The rows of the global [S, ...] batch that this process owns."""
    rank, world = _rank_world()
    if n_streams % world:
        raise ValueError(f"{n_streams} streams do not split over {world} "
                         "processes")
    per = n_streams // world
    return slice(rank * per, (rank + 1) * per)


def streams_from_host_local(local, device="cuda") -> torch.Tensor:
    """This process's rows (numpy or a tensor) on its device: the process
    holds no other rows of the global batch."""
    if isinstance(local, np.ndarray):
        local = torch.from_numpy(np.ascontiguousarray(local))
    return local.to(device)


def tree_from_host_local(tree, device="cuda"):
    """``streams_from_host_local`` over a DenoiseState (e.g. one made with
    ``init_state(local_n_streams)``)."""
    return map_state(lambda t: streams_from_host_local(t, device), tree)


def host_local_output(x: torch.Tensor) -> np.ndarray:
    """This process's rows of a result, on the host."""
    return x.detach().cpu().numpy()
