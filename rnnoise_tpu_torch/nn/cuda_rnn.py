"""The RNN step as one CUDA kernel (``csrc/rnn_step.cu``) — the port of
``rnnoise_tpu/nn/pallas_rnn.py:compute_rnn_pallas``.

``compute_rnn_step`` launches the kernel for CUDA tensors and uses the plain
version, :func:`compute_rnn_plain` (the layer graph of ``models/rnn.py`` on
the int8 / approx-activation numerics), for CPU tensors.  The kernel reads
the weights in its own layout (:class:`PackedRNN`), packed once per model:
the int8 matrices (conv2 and the six GRU matrices) as lists of their nonzero
8-output x 4-input blocks (:func:`block_lists`), split over the block's
warps.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..models.rnn import ModelParams, RNNState, compute_rnn_layers

# Warps of a block that runs the step (RNN_WARPS in csrc/rnn_body.cuh): the
# int8 layers' work is split over this many.
RNN_WARPS = 16
# The sparse blocks: BLOCK_OUT outputs (a unit group) x BLOCK_IN inputs (one
# packed word).  A unit group's task has one list of blocks per matrix and
# gate: conv2 1, a GRU layer 6 (input and recurrent, gates z, r, n).
BLOCK_IN, BLOCK_OUT = 4, 8
# Blocks of one tensor-core product (m16n8k32: 32 inputs).
MMA_BLOCKS = 32 // BLOCK_IN


class PackedRNN(NamedTuple):
    """Kernel weight layout.  The int8 matrices keep only their nonzero
    blocks (:func:`block_lists`)."""

    conv1_w: torch.Tensor        # [3F, C] f32
    conv1_b: torch.Tensor        # [C]
    q_w: torch.Tensor            # [blocks, 8] int32: a block's 8 column words
    q_k: torch.Tensor            # [blocks] int32: its input word (pair_words)
    q_sched: torch.Tensor        # [sched_size(N/8)] int32: the warps' tasks
    conv2_scale: torch.Tensor    # [N]
    conv2_b: torch.Tensor        # [N]
    gru_in_scale: torch.Tensor   # [3, 3N]
    gru_in_b: torch.Tensor       # [3, 3N]
    gru_rec_scale: torch.Tensor  # [3, 3N]
    gru_rec_b: torch.Tensor      # [3, 3N]
    gru_diag: torch.Tensor       # [3, 3N]
    heads_w: torch.Tensor        # [NB+1, 4N] f32: gains rows, then VAD
    heads_b: torch.Tensor        # [NB+1]


class BlockSparse(NamedTuple):
    """The int8 matrices' nonzero blocks and their split over warps (numpy
    int32 arrays; PackedRNN holds w and k as q_w and q_k, and the rest as
    the schedule q_sched).

    Block b is 8 output columns x 4 input rows of one matrix: w[b, c] holds
    rows 4 k[b] .. 4 k[b] + 3 of its column c, byte t = row 4 k[b] + t (the
    operand layout of __dp4a and of an int8 mma's B fragment).  The blocks
    run in lists, one per (stage, unit group u, matrix m, gate q), stage 0
    being conv2 (one matrix, one gate) and stages 1-3 the GRU layers
    (matrices input and recurrent, gates z, r, n): list i holds the nonzero
    blocks of matrix m of its stage in the columns q N + 8 u ..
    q N + 8 u + 7, by ascending k, at ptr[i] .. ptr[i + 1] - 1, and the
    lists run by stage, then u, then m, then q (list_index).  A warp takes
    whole unit groups, so it finishes each unit itself: in stage s, warp w
    takes the groups task[s, split[s, w] : split[s, w + 1]]."""

    w: np.ndarray
    k: np.ndarray
    ptr: np.ndarray
    task: np.ndarray
    split: np.ndarray


def list_index(stage: int, u: int, m: int, q: int, G: int) -> int:
    """The index of the list of (stage, unit group u, matrix m, gate q) for
    G unit groups: conv2's G lists, then 6 per unit group and layer."""
    return u if stage == 0 else G + ((stage - 1) * G + u) * 6 + 3 * m + q


def block_words(wq: np.ndarray):
    """[in, out] int8 -> (nonzero [in/4, out/8] bool, words [in/4, out/8, 8]
    int32): whether each 4 x 8 block holds a nonzero weight, and its column
    words (byte t of word c = row 4 k + t of column 8 j + c)."""
    n_in, n_out = wq.shape
    if n_in % BLOCK_IN or n_out % BLOCK_OUT:
        raise ValueError(f"int8 matrix {wq.shape} does not split into "
                         f"{BLOCK_IN} x {BLOCK_OUT} blocks")
    b = np.ascontiguousarray(wq, np.int8).reshape(
        n_in // BLOCK_IN, BLOCK_IN, n_out // BLOCK_OUT, BLOCK_OUT)
    words = np.ascontiguousarray(b.transpose(0, 2, 3, 1)).view(np.int32)[..., 0]
    return (b != 0).any(axis=(1, 3)), words


def split_over_warps(cost, n_warps: int = RNN_WARPS):
    """(task [n] int32, split [n_warps + 1] int32) for tasks of the given
    costs: the longest first, each to the warp with the least so far (the
    lowest of equals), so the warps' totals differ by at most one task."""
    load = np.zeros(n_warps, np.int64)
    owner = np.zeros(len(cost), np.int64)
    for t in sorted(range(len(cost)), key=lambda t: (-cost[t], t)):
        w = int(np.argmin(load))
        owner[t] = w
        load[w] += cost[t]
    task = np.argsort(owner, kind="stable").astype(np.int32)
    split = np.concatenate([[0], np.cumsum(np.bincount(owner, minlength=n_warps))])
    return task, split.astype(np.int32)


def block_lists(stages, n_warps: int = RNN_WARPS) -> BlockSparse:
    """The nonzero blocks of the int8 layers in BlockSparse's layout, for
    ``stages`` = [[conv2 [3C, N]], [input, recurrent] of each GRU layer
    ([N, 3N] each)] as int8 arrays.  A unit group's cost is what its warp
    steps through: per list, its blocks MMA_BLOCKS at a time."""
    N = stages[0][0].shape[1]
    if N % BLOCK_OUT:
        raise ValueError(f"GRU width {N} is not a multiple of {BLOCK_OUT}")
    G = N // BLOCK_OUT
    w, k, ptr, tasks, splits = [], [], [0], [], []
    for mats in stages:
        parts = [block_words(m.numpy() if torch.is_tensor(m) else m) for m in mats]
        cost = np.zeros(G, np.int64)
        for u in range(G):
            for nz, words in parts:
                for q in range(nz.shape[1] // G):
                    rows = np.flatnonzero(nz[:, q * G + u])
                    w.append(words[rows, q * G + u])
                    k.append(rows)
                    ptr.append(ptr[-1] + len(rows))
                    cost[u] += -(-len(rows) // MMA_BLOCKS)
        task, split = split_over_warps(cost, n_warps)
        tasks.append(task)
        splits.append(split)
    assert len(ptr) == G * (1 + 6 * (len(stages) - 1)) + 1
    return BlockSparse(np.concatenate(w).astype(np.int32).reshape(-1, BLOCK_OUT),
                       np.concatenate(k).astype(np.int32),
                       np.asarray(ptr, np.int32), np.stack(tasks), np.stack(splits))


# The schedule's records (task's unit group, then its lists' bounds): conv2's
# of 3 ints, a GRU layer's of 8 (SCHED_REC0, SCHED_REC in csrc/rnn_body.cuh).
SCHED_REC0, SCHED_REC = 3, 8


def sched_size(G: int) -> int:
    """Ints of the schedule of G unit groups."""
    return 4 * (RNN_WARPS + 1) + G * (SCHED_REC0 + 3 * SCHED_REC)


def schedule(sp: BlockSparse) -> np.ndarray:
    """The warps' schedule the kernel copies to shared memory: the stages'
    split [4, RNN_WARPS + 1], then each stage's tasks in split order, a
    record each: its unit group u and the bounds of its lists, ptr[i] for
    its lists i and the end of its last one (conv2: 2 bounds, a GRU layer's
    unit group: 7, its 6 lists being adjacent)."""
    G = sp.task.shape[1]
    recs = []
    for st in range(4):
        n = 1 if st == 0 else 6
        for u in sp.task[st]:
            i = list_index(st, int(u), 0, 0, G)
            recs.append(np.concatenate([[u], sp.ptr[i:i + n + 1]]))
    out = np.concatenate([sp.split.ravel(), *recs]).astype(np.int32)
    assert out.shape == (sched_size(G),)
    return out


def pair_words(sp: BlockSparse) -> np.ndarray:
    """The blocks' input words as the kernel loads them: the low 16 bits of
    entry i are k[i]; for the first 4 blocks of each product (blocks
    8 s + t, t < 4, of a list), the high 16 bits are the input word of block
    8 s + t + 4 of the same list (0 where the list ends before it), so that
    one load gives a lane both of its blocks' words."""
    if len(sp.k) and sp.k.max() >= 1 << 15:
        raise ValueError("layer inputs of more than 2^17 values")
    out = sp.k.astype(np.int64)
    for b, e in zip(sp.ptr[:-1], sp.ptr[1:]):
        i = np.arange(b, e)
        first = i[(i - b) % MMA_BLOCKS < 4]
        has = first + 4 < e
        out[first[has]] |= sp.k[first[has] + 4].astype(np.int64) << 16
    return out.astype(np.uint32).view(np.int32)


def int8_stages(p: ModelParams):
    """The int8 matrices of ``p`` by stage, as block_lists takes them."""
    return [[p.conv2.weights_q.cpu()]] + [
        [getattr(p, f"gru{i}_input").weights_q.cpu(),
         getattr(p, f"gru{i}_recurrent").weights_q.cpu()] for i in (1, 2, 3)]


def pack_params(p: ModelParams) -> PackedRNN:
    gi = (p.gru1_input, p.gru2_input, p.gru3_input)
    gr = (p.gru1_recurrent, p.gru2_recurrent, p.gru3_recurrent)
    dev = p.conv2.weights_q.device
    sp = block_lists(int8_stages(p))
    return PackedRNN(
        conv1_w=p.conv1.weights_f32.contiguous(),
        conv1_b=p.conv1.bias.contiguous(),
        q_w=torch.from_numpy(sp.w).to(dev),
        q_k=torch.from_numpy(pair_words(sp)).to(dev),
        q_sched=torch.from_numpy(schedule(sp)).to(dev),
        conv2_scale=p.conv2.scale.contiguous(),
        conv2_b=p.conv2.bias.contiguous(),
        gru_in_scale=torch.stack([x.scale for x in gi]),
        gru_in_b=torch.stack([x.bias for x in gi]),
        gru_rec_scale=torch.stack([x.scale for x in gr]),
        gru_rec_b=torch.stack([x.bias for x in gr]),
        gru_diag=torch.stack([x.diag for x in gr]),
        heads_w=torch.cat([p.dense_out.weights_f32,
                           p.vad_dense.weights_f32], dim=1).t().contiguous(),
        heads_b=torch.cat([p.dense_out.bias, p.vad_dense.bias]),
    )


# pack_params memoised by identity; holds the params so ids stay valid
# (models are few and long-lived).
_PACKED: dict = {}


def packed_params(params: ModelParams) -> PackedRNN:
    """pack_params(params), memoised, its layout validated once
    (require_packed) when it is packed."""
    hit = _PACKED.get(id(params))
    if hit is None or hit[0] is not params:
        pk = pack_params(params)
        C, N = pk.conv1_b.shape[0], pk.conv2_b.shape[0]
        require_packed(pk, pk.conv1_w.shape[0] // 3, C, N,
                       pk.heads_b.shape[0] - 1, pk.conv1_w.device)
        hit = _PACKED[id(params)] = (params, pk)
    return hit[1]


def compute_rnn_plain(params: ModelParams, state: RNNState,
                      feats: torch.Tensor,
                      silence: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the kernel: (new_state, gains, vad)."""
    return compute_rnn_layers(params, state, feats, True, True, silence)


def require_packed(pk: PackedRNN, F: int, C: int, N: int, NB: int,
                   device: torch.device) -> None:
    """Validate the packed weights of a network of F features, C conv and
    N GRU units and NB bands before their pointers reach a kernel (the
    block lists' contents are block_lists's, checked as it builds
    them)."""
    f32, i32 = torch.float32, torch.int32
    G, n_blocks = N // BLOCK_OUT, pk.q_k.shape[0]
    for name, shape, dt in (
            ("conv1_w", (3 * F, C), f32), ("conv1_b", (C,), f32),
            ("q_w", (n_blocks, BLOCK_OUT), i32), ("q_k", (n_blocks,), i32),
            ("q_sched", (sched_size(G),), i32),
            ("conv2_scale", (N,), f32), ("conv2_b", (N,), f32),
            ("gru_in_scale", (3, 3 * N), f32), ("gru_in_b", (3, 3 * N), f32),
            ("gru_rec_scale", (3, 3 * N), f32), ("gru_rec_b", (3, 3 * N), f32),
            ("gru_diag", (3, 3 * N), f32), ("heads_w", (NB + 1, 4 * N), f32),
            ("heads_b", (NB + 1,), f32)):
        kernels.require(getattr(pk, name), name, shape, dt, device)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = kernels.library("rnn_step")
        lib.rnnt_rnn_step.restype = ctypes.c_int
        lib.rnnt_rnn_step.argtypes = (
            [ctypes.c_void_p] * (14 + len(PackedRNN._fields))
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        _LIB = lib
    return _LIB


def compute_rnn_step(params: ModelParams, state: RNNState,
                     feats: torch.Tensor,
                     silence: Optional[torch.Tensor] = None):
    """One RNN step: feats [S, 65] -> (new_state, gains [S, 32], vad [S]).
    ``silence`` [S] bool rows keep their state and get VAD 0.  CUDA tensors
    launch the kernel; CPU tensors take :func:`compute_rnn_plain`."""
    if not feats.is_cuda:
        return compute_rnn_plain(params, state, feats, silence)
    pk = packed_params(params)
    dev = feats.device
    S, F = feats.shape
    C, N = pk.conv1_b.shape[0], pk.conv2_b.shape[0]
    NB = pk.heads_b.shape[0] - 1
    if (3 * C) % 4 or N % BLOCK_OUT:
        raise ValueError(f"kernel needs 3*cond ({3 * C}) a multiple of 4 and "
                         f"gru ({N}) a multiple of {BLOCK_OUT}")
    if silence is None:
        silence = torch.zeros(S, dtype=torch.bool, device=dev)
    feats, silence = feats.contiguous(), silence.contiguous()
    st = RNNState(*(t.contiguous() for t in state))
    f32 = torch.float32
    for name, t, shape, dt in (
            ("feats", feats, (S, F), f32), ("silence", silence, (S,), torch.bool),
            ("conv1_mem", st.conv1_mem, (S, 2 * F), f32),
            ("conv2_mem", st.conv2_mem, (S, 2 * C), f32),
            ("gru1", st.gru1, (S, N), f32), ("gru2", st.gru2, (S, N), f32),
            ("gru3", st.gru3, (S, N), f32)):
        kernels.require(t, name, shape, dt, dev)
    # the weights were validated when packed, on one device: the input width
    # and the device remain
    kernels.require(pk.conv1_w, "conv1_w", (3 * F, C), f32, dev)
    out = RNNState(*(torch.empty_like(t) for t in st))
    gains = torch.empty((S, NB), dtype=f32, device=dev)
    vad = torch.empty((S,), dtype=f32, device=dev)
    p = kernels.ptr
    kernels.launch(
        _lib().rnnt_rnn_step, "rnn_step", dev,
        p(feats), p(silence), *(p(t) for t in st), *(p(t) for t in pk),
        *(p(t) for t in out), p(gains), p(vad), S, F, C, N, NB)
    compute_rnn_step.launches += 1
    return out, gains, vad


compute_rnn_step.launches = 0
