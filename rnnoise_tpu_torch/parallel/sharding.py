"""Streams split across devices — the counterpart of
``rnnoise_tpu/parallel/sharding.py``.

The parallel axis is the streams: the weights (1-3 MB) are copied to every
device, the ``[S, ...]`` state and PCM are split into contiguous shards,
one per device of the mesh, and inference needs no collective (streams are
independent).  Training's gradient all-reduce is in ``training/train.py``
(``process_group``), across processes.

A mesh is a list of ``torch.device``s.  It may name one device twice: two
shards on one card then show that the composition is right.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from ..config import DEFAULT_MODEL, DEFAULT_RUNTIME, ModelConfig, RuntimeConfig
from ..denoise import (DenoiseState, init_state, map_state, process_frames,
                       process_frames_tm_i16)
from ..models.rnn import ModelParams

Mesh = List[torch.device]


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """The devices that take the stream shards: ``devices`` as given, else
    every CUDA device (the first ``n_devices`` of them).  Raises when there
    is no CUDA device and none was named."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device: name the mesh's devices")
        devices = [f"cuda:{i}" for i in range(count)]
        if n_devices is not None:
            devices = devices[:n_devices]
    return [torch.device(d) for d in devices]


def _bounds(n_streams: int, mesh: Mesh) -> list:
    if n_streams % len(mesh):
        raise ValueError(f"{n_streams} streams do not split evenly over "
                         f"{len(mesh)} devices")
    per = n_streams // len(mesh)
    return [(i * per, (i + 1) * per) for i in range(len(mesh))]


def shard_state(state: DenoiseState, mesh: Mesh) -> List[DenoiseState]:
    """Contiguous stream shards of ``state``, each on its device."""
    return [map_state(lambda t: t[a:b].to(dev), state)
            for dev, (a, b) in zip(mesh, _bounds(state.last_period.shape[0],
                                                  mesh))]


def shard_params(params: Optional[ModelParams], mesh: Mesh) -> list:
    """The weights copied to each device of the mesh (one copy a device)."""
    if params is None:
        return [None] * len(mesh)
    copies = {}
    for dev in mesh:
        if dev not in copies:
            copies[dev] = ModelParams(*(type(lp)(*(
                None if t is None else t.to(dev) for t in lp))
                for lp in params))
    return [copies[dev] for dev in mesh]


def sharded_init_state(n_streams: int, mesh: Mesh,
                       config: ModelConfig = DEFAULT_MODEL) -> List[DenoiseState]:
    per = n_streams // len(_bounds(n_streams, mesh))
    return [init_state(per, config, dev) for dev in mesh]


def _sharded(fn, params, mesh: Mesh, pcm_axis: int):
    per_device = shard_params(params, mesh)

    def run(state: Union[DenoiseState, Sequence[DenoiseState]],
            pcm: torch.Tensor):
        if isinstance(state, DenoiseState):
            state = shard_state(state, mesh)
        bounds = _bounds(pcm.shape[pcm_axis], mesh)
        results = []
        # every shard's work is enqueued before any result is gathered, so
        # the devices run at once
        for p, st, dev, (a, b) in zip(per_device, state, mesh, bounds):
            x = pcm.narrow(pcm_axis, a, b - a).to(dev).contiguous()
            results.append(fn(p, st, x))
        states, outs, vads = zip(*results)

        def gather(*parts, dim=0):
            return torch.cat([t.to(mesh[0]) for t in parts], dim=dim)
        return (map_state(gather, *states), gather(*outs, dim=pcm_axis),
                gather(*vads, dim=pcm_axis))

    return run


def make_sharded_processor(params: Optional[ModelParams], mesh: Mesh,
                           rt: RuntimeConfig = DEFAULT_RUNTIME):
    """(state, pcm [S, T, 480] float) -> (state, out [S, T, 480],
    vad [S, T]) with the streams split into contiguous shards, one a device
    of ``mesh``, each run by ``process_frames``.  ``state`` is a whole
    DenoiseState (split here) or the per-device list of
    ``sharded_init_state``/``shard_state``; the results come back
    concatenated on the mesh's first device.  S must split evenly."""
    return _sharded(lambda p, st, x: process_frames(p, st, x, rt), params,
                    mesh, 0)


def make_sharded_processor_tm_i16(params: Optional[ModelParams], mesh: Mesh,
                                  rt: RuntimeConfig = DEFAULT_RUNTIME):
    """The int16 time-major form that serving runs: (state,
    pcm [T, S, 480] int16) -> (state, out [T, S, 480] int16, vad [T, S]),
    the streams (axis 1) split over the mesh, each shard one
    ``process_frames_tm_i16`` call (one monokernel launch on the default
    configuration)."""
    return _sharded(lambda p, st, x: process_frames_tm_i16(p, st, x, rt),
                    params, mesh, 1)
