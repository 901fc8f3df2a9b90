"""The RNN step: the port's layers and compute_rnn (the plain version of the
RNN-step kernel) against rnnoise_tpu on CPU, in both numerics modes."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnoise_tpu.config import RuntimeConfig as JRuntime
from rnnoise_tpu.models.rnn import RNNState as JState
from rnnoise_tpu.models.rnn import compute_rnn as jrnn
from rnnoise_tpu.nn import layers as jl
from rnnoise_tpu_torch import kernels
from rnnoise_tpu_torch.config import RuntimeConfig
from rnnoise_tpu_torch.models.rnn import RNNState, compute_rnn, compute_rnn_layers
from rnnoise_tpu_torch.nn import cuda_rnn
from rnnoise_tpu_torch.nn import layers as tl
from rnnoise_tpu_torch.weights.loader import load_model_file
from tests.torch_helpers import (MODEL_BLOB, OnCuda, jax_params,  # noqa: F401
                                 no_jax_compile_cache, random_model_arrays,
                                 torch_params)


def test_activations_match_reference():
    x = np.linspace(-12, 12, 20001, dtype=np.float32)
    xt = torch.from_numpy(x)
    for jf, tf in ((jl.tanh_approx, tl.tanh_approx),
                   (jl.sigmoid_approx, tl.sigmoid_approx)):
        ref = np.asarray(jax.jit(jf)(x))
        # XLA contracts the rational's multiply-adds into FMAs; the port
        # rounds each step: a few ulps of 1.0 apart at most
        np.testing.assert_allclose(tf(xt).numpy(), ref, rtol=0, atol=4e-7)
    q = tl.quantize_activations(xt / 8).numpy()
    ref = np.asarray(jl.quantize_activations(jnp.asarray(x / 8)))
    assert q.dtype == np.int8
    # floor(.5 + 127 x): the two may round the product differently only at
    # exact half-steps
    assert (q != ref).mean() < 1e-3 and np.abs(q.astype(int) - ref).max() <= 1


def _inputs(rng, S, F, C, N):
    feats = rng.standard_normal((S, F)).astype(np.float32)
    st = [rng.standard_normal((S, 2 * F)).astype(np.float32),
          np.tanh(rng.standard_normal((S, 2 * C))).astype(np.float32)] + \
         [np.tanh(rng.standard_normal((S, N))).astype(np.float32)
          for _ in range(3)]
    sil = rng.random(S) < 0.25
    return feats, st, sil


@pytest.mark.parametrize("quantized,atol", [(True, 1e-5), (False, 1e-3)])
def test_compute_rnn_matches_reference(quantized, atol):
    """Five chained steps of a small random model, with silent rows."""
    rng = np.random.default_rng(7)
    arrays = random_model_arrays(rng)
    jp, tp = jax_params(arrays), torch_params(arrays)
    S, F, C, N = 16, 65, 16, 32
    feats, st, sil = _inputs(rng, S, F, C, N)
    jst, tst = JState(*map(jnp.asarray, st)), RNNState(*map(torch.from_numpy, st))
    jstep = jax.jit(lambda s, f, m: jrnn(jp, s, f, JRuntime(quantized=quantized),
                                         silence=m))
    rt = RuntimeConfig(quantized=quantized)
    for step in range(5):
        f = feats * (1.0 + 0.3 * step)
        jst, jg, jv = jstep(jst, jnp.asarray(f), jnp.asarray(sil))
        tst, tg, tv = compute_rnn(tp, tst, torch.from_numpy(f), rt,
                                  silence=torch.from_numpy(sil))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=atol, rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=atol, rtol=0)
        for a, b in zip(jst, tst):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol, rtol=0)
    # silent rows kept their state and report VAD 0
    np.testing.assert_array_equal(tst.gru3.numpy()[sil], st[4][sil])
    np.testing.assert_array_equal(tv.numpy()[sil], 0.0)


def test_full_model_step_matches_reference():
    """The kernel's plain version on the full rnnoise_synth_v1 model."""
    from rnnoise_tpu.weights.loader import load_model_file as jload
    jp = jload(MODEL_BLOB)
    tp = load_model_file(MODEL_BLOB, device="cpu")
    rng = np.random.default_rng(11)
    feats, st, sil = _inputs(rng, 8, 65, 128, 384)
    jst, jg, jv = jax.jit(lambda s, f, m: jrnn(jp, s, f, silence=m))(
        JState(*map(jnp.asarray, st)), jnp.asarray(feats), jnp.asarray(sil))
    tst, tg, tv = cuda_rnn.compute_rnn_plain(
        tp, RNNState(*map(torch.from_numpy, st)), torch.from_numpy(feats),
        torch.from_numpy(sil))
    for a, b in zip((*jst, jg, jv), (*tst, tg, tv)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=0)


def test_step_wrapper_uses_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    tp = torch_params(random_model_arrays(rng))
    feats, st, sil = _inputs(rng, 6, 65, 16, 32)
    args = (tp, RNNState(*map(torch.from_numpy, st)), torch.from_numpy(feats),
            torch.from_numpy(sil))
    before = cuda_rnn.compute_rnn_step.launches
    a = cuda_rnn.compute_rnn_step(*args)
    b = cuda_rnn.compute_rnn_plain(*args)
    assert cuda_rnn.compute_rnn_step.launches == before
    for x, y in zip((*a[0], a[1], a[2]), (*b[0], b[1], b[2])):
        assert torch.equal(x, y)


def test_packed_weights_layout():
    """Kernel layout: a block's word c holds rows 4k..4k+3 of its column c,
    byte t = row 4k+t (conv2's first list, then the first GRU layer's);
    heads are transposed with the VAD row last."""
    rng = np.random.default_rng(2)
    arrays = random_model_arrays(rng)
    tp = torch_params(arrays)
    pk = cuda_rnn.pack_params(tp)
    G = 32 // cuda_rnn.BLOCK_OUT
    sp = cuda_rnn.block_lists(cuda_rnn.int8_stages(tp))
    assert np.array_equal(pk.q_w.numpy(), sp.w)
    assert np.array_equal(pk.q_k.numpy() & 0xFFFF, sp.k)
    for stage, name in ((0, "conv2"), (1, "gru1_input")):
        wq = arrays[name]["weights_q"]
        i = cuda_rnn.list_index(stage, 0, 0, 0, G)
        blocks = slice(int(sp.ptr[i]), int(sp.ptr[i + 1]))
        assert blocks.stop > blocks.start
        for w8, k in zip(pk.q_w[blocks].numpy(), sp.k[blocks]):
            np.testing.assert_array_equal(w8.view(np.int8).reshape(8, 4).T,
                                          wq[4 * k:4 * k + 4, :8])
    np.testing.assert_array_equal(pk.heads_w.numpy()[-1],
                                  arrays["vad_dense"]["weights_f32"][:, 0])
    np.testing.assert_array_equal(pk.heads_w.numpy()[:-1],
                                  arrays["dense_out"]["weights_f32"].T)
    with pytest.raises(ValueError):
        cuda_rnn.block_words(np.zeros((8, 12), np.int8))


def _int8_stages(kind):
    """The int8 matrices by stage ([conv2 [3C, N]], then [input, recurrent]
    [N, 3N] of each GRU layer): the reference blob's, a random dense set (no
    zero weight) or an all-zero one."""
    if kind == "blob":
        return [[m.numpy() for m in ms] for ms in
                cuda_rnn.int8_stages(load_model_file(MODEL_BLOB, device="cpu"))]
    rng = np.random.default_rng(21)
    C, N = 16, 40

    def mat(n_in, n_out):
        if kind == "all_zero":
            return np.zeros((n_in, n_out), np.int8)
        return (rng.integers(1, 128, (n_in, n_out))
                * rng.choice([-1, 1], (n_in, n_out))).astype(np.int8)
    return [[mat(3 * C, N)]] + [[mat(N, 3 * N), mat(N, 3 * N)] for _ in range(3)]


def _warp_lists(sp, stage, G):
    """The kernel's walk of one stage: for each warp, its unit groups' lists
    as (unit group, matrix, gate, block range)."""
    out = []
    for w in range(cuda_rnn.RNN_WARPS):
        mine = []
        for t in range(sp.split[stage, w], sp.split[stage, w + 1]):
            u = int(sp.task[stage, t])
            for m, q in ([(0, 0)] if stage == 0 else
                         [(m, q) for m in range(2) for q in range(3)]):
                i = cuda_rnn.list_index(stage, u, m, q, G)
                mine.append((u, m, q, range(sp.ptr[i], sp.ptr[i + 1])))
        out.append(mine)
    return out


def _mma(lanes_a0, lanes_a2, lanes_b0, lanes_b1):
    """An m16n8k32 int8 product from its lanes' fragments, as the PTX ISA
    lays them out (lane = 4 g + t): A[g][4t + i] is byte i of a0, A[g][16 +
    4t + i] of a2 (rows 8-15 zero); B[4t + i][g] is byte i of b0, B[16 + 4t
    + i][g] of b1.  Returns each lane's (d0, d1) = D[g][2t], D[g][2t + 1]."""
    def bytes4(v):
        return np.array([v], np.int32).view(np.int8).astype(np.int64)
    A = np.zeros((8, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        A[g, 4 * t:4 * t + 4] = bytes4(lanes_a0[lane])
        A[g, 16 + 4 * t:20 + 4 * t] = bytes4(lanes_a2[lane])
        B[4 * t:4 * t + 4, g] = bytes4(lanes_b0[lane])
        B[16 + 4 * t:20 + 4 * t, g] = bytes4(lanes_b1[lane])
    D = A @ B
    return [(D[lane // 4, 2 * (lane % 4)], D[lane // 4, 2 * (lane % 4) + 1])
            for lane in range(32)]


@pytest.mark.parametrize("kind", ["blob", "dense", "all_zero"])
def test_block_lists_reproduce_dense_product(kind):
    """The kernel's sums from the packed lists, as its warps take them (8
    blocks a product, lane (g, t) loading blocks t and t + 4, their input
    words from block t's pair word, and stream g's input words of both,
    zero weights past a list's end), equal the dense s32 products x W
    exactly, for every int8 matrix of every stage."""
    stages = _int8_stages(kind)
    N = stages[0][0].shape[1]
    G = N // cuda_rnn.BLOCK_OUT
    sp = cuda_rnn.block_lists(stages)
    pairs = cuda_rnn.pair_words(sp)
    rng = np.random.default_rng(23)
    for stage, mats in enumerate(stages):
        acts = [rng.integers(-127, 128, (8, W.shape[0])) for W in mats]
        words = [np.ascontiguousarray(x.astype(np.int8).reshape(8, -1, 4)
                                      .transpose(1, 0, 2)).view(np.int32)[..., 0]
                 for x in acts]                        # [input word, stream]
        got = [np.zeros((8, W.shape[1]), np.int64) for W in mats]
        for lists in _warp_lists(sp, stage, G):
            for u, m, q, blocks in lists:
                d = np.zeros((32, 2), np.int64)
                for i0 in range(blocks.start, blocks.stop, cuda_rnn.MMA_BLOCKS):
                    frag = {n: [] for n in ("a0", "a2", "b0", "b1")}
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        i = i0 + t
                        kk = int(pairs[i]) & 0xFFFFFFFF if i < blocks.stop else 0
                        for (a_, b_), j, k in ((("a0", "b0"), i, kk & 0xFFFF),
                                               (("a2", "b1"), i + 4, kk >> 16)):
                            frag[b_].append(sp.w[j, g] if j < blocks.stop else 0)
                            frag[a_].append(words[m][k, g])
                    d += np.array(_mma(frag["a0"], frag["a2"], frag["b0"], frag["b1"]))
                cols = q * N + cuda_rnn.BLOCK_OUT * u
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    got[m][g, cols + 2 * t:cols + 2 * t + 2] = d[lane]
        for x, W, g in zip(acts, mats, got):
            np.testing.assert_array_equal(g, x @ W.astype(np.int64))
    n_blocks = sum(W.size // 32 for ms in stages for W in ms)
    assert len(sp.k) == {"all_zero": 0, "dense": n_blocks}.get(kind, len(sp.k))


@pytest.mark.parametrize("kind", ["blob", "dense"])
def test_warp_split_covers_each_block_once(kind):
    """Every nonzero 4 x 8 block of every int8 matrix lies in exactly one
    list that exactly one warp walks, no zero block is read, and the warps'
    products differ by no more than one unit group's."""
    stages = _int8_stages(kind)
    N = stages[0][0].shape[1]
    G = N // cuda_rnn.BLOCK_OUT
    sp = cuda_rnn.block_lists(stages)

    def steps(r):
        return -(-len(r) // cuda_rnn.MMA_BLOCKS)
    for stage, mats in enumerate(stages):
        nz = [cuda_rnn.block_words(W)[0] for W in mats]
        seen = [np.zeros_like(z, np.int64) for z in nz]
        load, group = [], {}
        for lists in _warp_lists(sp, stage, G):
            load.append(sum(steps(r) for *_, r in lists))
            for u, m, q, blocks in lists:
                group[u] = group.get(u, 0) + steps(blocks)
                assert list(sp.k[blocks]) == sorted(sp.k[blocks])
                for i in blocks:
                    seen[m][sp.k[i], q * G + u] += 1
        for z, s in zip(nz, seen):
            assert (s == z).all()
        assert sorted(group) == list(range(G))
        assert max(load) - min(load) <= max(group.values())
    if kind == "blob":
        # the GRU matrices keep a third of their blocks: 0.88 MB of 2.65 MB
        gru = sum(W.nbytes for ms in stages[1:] for W in ms)
        conv2 = int(cuda_rnn.block_words(stages[0][0])[0].sum()) * 32
        assert (sp.w.nbytes - conv2) * 3 == gru


@pytest.mark.parametrize("kind", ["blob", "dense"])
def test_schedule_records_each_task_once(kind):
    """The schedule the kernel reads: the split, then per stage each task
    in the split's order with its unit group and its lists' bounds, as
    block_lists made them."""
    sp = cuda_rnn.block_lists(_int8_stages(kind))
    G = sp.task.shape[1]
    sched = cuda_rnn.schedule(sp)
    W1 = cuda_rnn.RNN_WARPS + 1
    assert np.array_equal(sched[:4 * W1].reshape(4, W1), sp.split)
    pos = 4 * W1
    for st in range(4):
        n = 1 if st == 0 else 6
        for t in range(G):
            rec = sched[pos:pos + n + 2]
            u = int(sp.task[st, t])
            assert rec[0] == u
            for L in range(n):
                i = cuda_rnn.list_index(st, u, L // 3, L % 3, G)
                assert (rec[1 + L], rec[2 + L]) == (sp.ptr[i], sp.ptr[i + 1])
            pos += cuda_rnn.SCHED_REC0 if st == 0 else cuda_rnn.SCHED_REC
    assert pos == len(sched) == cuda_rnn.sched_size(G)


def test_rnn_warps_match_kernel_source():
    """The split is made for the warps the kernels run the step with."""
    src = open(os.path.join(kernels.CSRC_DIR, "rnn_body.cuh")).read()
    assert int(re.search(r"RNN_WARPS = (\d+);", src).group(1)) == cuda_rnn.RNN_WARPS
    assert int(re.search(r"BLOCK_OUT = (\d+),", src).group(1)) == cuda_rnn.BLOCK_OUT
    assert int(re.search(r"MMA_BLOCKS = (\d+);", src).group(1)) == cuda_rnn.MMA_BLOCKS
    assert re.search(r"SCHED_REC0 = (\d+), SCHED_REC = (\d+);", src).groups() == (
        str(cuda_rnn.SCHED_REC0), str(cuda_rnn.SCHED_REC))
    assert "constexpr int THREADS = 32 * RNN_WARPS;" in open(
        os.path.join(kernels.CSRC_DIR, "rnn_step.cu")).read()


def test_float_path_has_no_cuda_kernel():
    """Only the default numerics have a CUDA kernel; the float-weight and
    exact-activation numerics run the plain layer graph on any device, CUDA
    tensors included, as the reference runs them."""
    tp = torch_params(random_model_arrays(np.random.default_rng(1)))
    st = RNNState(*(torch.zeros(2, w) for w in (130, 32, 32, 32, 32)))
    feats = torch.randn(2, 65, generator=torch.Generator().manual_seed(0))
    for rt in (RuntimeConfig(quantized=False), RuntimeConfig(approx_act=False),
               RuntimeConfig(quantized=False, approx_act=False)):
        want = compute_rnn_layers(tp, st, feats, rt.quantized, rt.approx_act)
        got = compute_rnn(tp, st, feats.as_subclass(OnCuda), rt)
        for a, b in zip((*want[0], want[1], want[2]), (*got[0], got[1], got[2])):
            assert torch.equal(a, b.as_subclass(torch.Tensor))
