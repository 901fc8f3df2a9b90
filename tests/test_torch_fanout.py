"""The port's serving remainder on CPU: the pool calls the fan-out needs
(f32, time-major and strided) against the JAX package's StreamPool over the
same native/streamio.cc, the multi-process FanoutPool against one pool, and
FanoutEngine against the port's StreamingEngine (bit for bit) and the JAX
package's FanoutEngine (the engine budget of test_torch_runtime.py)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from rnnoise_tpu.api import RNNoise as JModel
from rnnoise_tpu.runtime import native as jnative
from rnnoise_tpu.runtime.fanout import FanoutEngine as JFanoutEngine
from rnnoise_tpu.weights.loader import load_model_file as jload
from rnnoise_tpu_torch.api import RNNoise
from rnnoise_tpu_torch.runtime import fanout_worker
from rnnoise_tpu_torch.runtime.engine import StreamingEngine
from rnnoise_tpu_torch.runtime.fanout import FanoutEngine, FanoutPool
from rnnoise_tpu_torch.runtime.native import StreamPool
from rnnoise_tpu_torch.weights.loader import params_from_numpy
from tests.torch_helpers import (MODEL_BLOB, REPO, make_signal,  # noqa: F401
                                 no_jax_compile_cache)

F = 480


def _ramps(n_slots, n, seed=3):
    """Per-slot int16 ramps, distinct per slot (tests/test_fanout.py)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-2000, 2000, size=(n_slots, 1)).astype(np.int32)
    return ((base + np.arange(n, dtype=np.int32)) % 4000 - 2000).astype(np.int16)


@pytest.fixture(scope="module")
def models():
    jp = jload(MODEL_BLOB)
    return JModel(jp), RNNoise(params_from_numpy(jax.tree.map(np.asarray, jp),
                                                 "cpu"), device="cpu")


def _both_pools(S, pcm, ring=16):
    """A JAX pool and a port pool with every slot attached and fed the same
    PCM; slot 1 is left one frame short of pcm's length."""
    pools = (jnative.StreamPool(S, ring_frames=ring), StreamPool(S, ring))
    for p in pools:
        assert [p.attach() for _ in range(S)] == list(range(S))
        assert p.push_all(pcm[:, :-F]) == S
        tails = pcm[:, -F:].copy()
        tails[1] = 0
        for s in range(S):
            if s != 1:
                p.push(s, tails[s])
    return pools


@pytest.mark.parametrize("form", ["f32", "f32_tm", "i16_tm"])
def test_pool_calls_match_reference(form):
    """push_all, assemble and commit in each layout: the port's pool gives
    the JAX pool's batches, counts, reset flags and output rings exactly."""
    S, T = 4, 3
    pcm = _ramps(S, T * F)
    jp, tp = _both_pools(S, pcm)
    assemble, commit = {"f32": ("assemble", "commit"),
                        "f32_tm": ("assemble_tm", "commit_tm"),
                        "i16_tm": ("assemble_tm_i16", "commit_tm_i16")}[form]
    got = [getattr(p, assemble)(T) for p in (jp, tp)]
    for a, b in zip(*got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    batch, counts, _ = got[1]
    assert counts.tolist() == [T, 0, T, T]
    # a commit with fractions that the f32 path rounds half away from zero
    out = batch * 0.5 + 0.25 if form != "i16_tm" else batch // 3
    for p in (jp, tp):
        getattr(p, commit)(T, out, counts)
    pulled = [p.pull_all(T * F) for p in (jp, tp)]
    np.testing.assert_array_equal(pulled[0][0], pulled[1][0])
    assert pulled[0][1] == pulled[1][1] == S - 1


def test_strided_pool_calls_match_reference():
    """The fan-out's strided calls: a pool of slots [2, 5) of shared
    [T, 7, 480] and [7, n] tensors writes its rows and no other."""
    T, total, off, n = 2, 7, 2, 3
    pcm_all = _ramps(total, T * F, seed=5)
    lib = jnative.get_lib()
    results = []
    for which in ("jax", "port"):
        pool = jnative.StreamPool(n, 8) if which == "jax" else StreamPool(n, 8)
        for _ in range(n):
            pool.attach()
        io = pcm_all.copy()
        batch = np.full((T + 1, total, F), 7, np.int16)
        counts = np.full(total, -1, np.int32)
        reset = np.full(total, 9, np.uint8)
        c, r = counts[off:off + n], reset[off:off + n]
        if which == "jax":
            fed = lib.rnnt_pool_push_all_strided(pool._p, io, T * F, off)
            lib.rnnt_pool_assemble_tm_i16_strided(pool._p, T, batch, total,
                                                  off, c, r)
            batch[:T, off:off + n] //= 2
            lib.rnnt_pool_commit_tm_i16_strided(pool._p, T, batch, total, off, c)
            io[:] = 5
            full = lib.rnnt_pool_pull_all_strided(pool._p, io, T * F, off)
        else:
            fed = pool.push_all_strided(io, off)
            pool.assemble_tm_i16_strided(T, batch, off, c, r)
            batch[:T, off:off + n] //= 2
            pool.commit_tm_i16_strided(T, batch, off, c)
            io[:] = 5
            full = pool.pull_all_strided(io, off)
        assert fed == full == n
        results.append((batch, counts, reset, io))
    for a, b in zip(*results):
        np.testing.assert_array_equal(a, b)
    batch, counts, reset, io = results[1]
    assert (batch[:, :off] == 7).all() and (batch[:, off + n:] == 7).all()
    assert counts.tolist() == [-1, -1, T, T, T, -1, -1]
    assert (io[:off] == 5).all() and (io[off + n:] == 5).all()
    np.testing.assert_array_equal(
        io[off:off + n], np.moveaxis(batch[:T, off:off + n], 1, 0).reshape(n, -1))
    with pytest.raises(ValueError):
        StreamPool(n, 8).push_all_strided(io, total - 1)


@pytest.mark.parametrize("n_workers", [1, 2, 4])
def test_fanout_pool_matches_single_pool(n_workers):
    """tests/test_fanout.py's check on the port: K workers' assembly,
    counts, reset flags and commit/pull round trip equal one pool's."""
    S, T = 8, 4
    pcm = _ramps(S, T * F)
    ref = StreamPool(S, ring_frames=16)
    for _ in range(S):
        ref.attach()
    ref.push_all(pcm)
    ref_batch, ref_counts, ref_reset = ref.assemble_tm_i16(T)

    fan = FanoutPool(S, n_workers, ring_frames=16, t_max=T)
    try:
        assert fan.attach_all() == S
        assert fan.push_all(pcm) == S
        batch, counts, reset = fan.assemble_tm_i16(T)
        np.testing.assert_array_equal(batch, ref_batch)
        np.testing.assert_array_equal(counts, ref_counts)
        np.testing.assert_array_equal(reset, ref_reset)
        out = (batch.astype(np.int32) // 2).astype(np.int16)
        fan.commit_tm_i16(T, out)
        got, full = fan.pull_all(T * F)
        assert full == S
        np.testing.assert_array_equal(got, np.moveaxis(out, 1, 0).reshape(S, -1))
        _, counts2, reset2 = fan.assemble_tm_i16(T)
        assert counts2.sum() == 0 and reset2.sum() == 0
        # a detached slot is the one that attach_all gives back, reset
        fan.detach(S - 1)
        assert fan.attach_all() == 1
        _, _, reset3 = fan.assemble_tm_i16(T)
        assert reset3.tolist() == [0] * (S - 1) + [1]
    finally:
        fan.close()
    assert not fan._procs and not fan._shms


def test_fanout_pool_starved_slot_zero_filled():
    """A slot with a partial chunk contributes zeros and count 0, as the
    single pool's all-or-nothing assembly does."""
    S, T = 4, 4
    fan = FanoutPool(S, 2, ring_frames=16, t_max=T)
    try:
        fan.attach_all()
        pcm = _ramps(S, T * F)
        fan.push_all(pcm[:, :2 * F])
        batch, counts, _ = fan.assemble_tm_i16(T)
        assert counts.sum() == 0
        np.testing.assert_array_equal(batch, 0)
        fan.push_all(pcm[:, 2 * F:])
        batch, counts, _ = fan.assemble_tm_i16(T)
        assert (counts == T).all()
        np.testing.assert_array_equal(np.moveaxis(batch, 1, 0).reshape(S, -1), pcm)
        with pytest.raises(ValueError):
            fan.assemble_tm_i16(T + 1)
    finally:
        fan.close()


def _signals(S, n_frames, seed=5):
    rng = np.random.default_rng(seed)
    return np.stack([np.round(make_signal(rng, n_frames)).astype(np.int16)
                     if i % 2 == 0 else
                     (300 * rng.standard_normal(n_frames * F)).astype(np.int16)
                     for i in range(S)])


def _drive_bulk(eng, sigs, T, n_chunks):
    """Attach all, tick n_chunks chunks, detach and re-attach slot 1, tick
    one more chunk; returns (advanced per tick, every slot's output)."""
    S = sigs.shape[0]
    attach = eng.attach_all if hasattr(eng, "attach_all") else \
        (lambda: sum(eng.attach() >= 0 for _ in range(S)))
    assert attach() == S
    eng.pool.push_all(sigs[:, :n_chunks * T * F])
    adv = [eng.tick() for _ in range(n_chunks)] + [eng.flush()]
    eng.detach(1)
    assert attach() == 1
    eng.pool.push_all(sigs[:, n_chunks * T * F:])
    adv += [eng.tick(), eng.flush()]
    out, _ = eng.pool.pull_all((n_chunks + 1) * T * F)
    return adv, out


@pytest.mark.parametrize("pipelined", [False, True])
def test_fanout_engine_matches_streaming_engine(models, pipelined):
    """FanoutEngine (2 worker processes) gives the port's StreamingEngine's
    output bit for bit, a detached and re-attached slot included."""
    _, tm = models
    S, T, n_chunks = 4, 2, 2
    sigs = _signals(S, (n_chunks + 1) * T)
    ref = StreamingEngine(S, tm, chunk_frames=T, pipelined=pipelined)
    ref_adv, ref_out = _drive_bulk(ref, sigs, T, n_chunks)
    assert sum(ref_adv) == n_chunks * S + S
    eng = FanoutEngine(S, tm, chunk_frames=T, n_workers=2, pipelined=pipelined)
    try:
        adv, out = _drive_bulk(eng, sigs, T, n_chunks)
    finally:
        eng.close()
    assert adv == ref_adv
    np.testing.assert_array_equal(out, ref_out)
    for a, b in zip(eng.state, ref.state):
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert bool((u == v).all())


def test_fanout_engine_matches_reference_fanout_engine(models):
    """Three chunks of 2 frames on 4 streams against the JAX package's
    FanoutEngine: PCM within 4 LSB (the engine budget)."""
    jm, tm = models
    S, T, n_chunks = 4, 2, 3
    sigs = _signals(S, n_chunks * T)
    outs = []
    for make in (lambda: JFanoutEngine(S, jm, chunk_frames=T, n_workers=2),
                 lambda: FanoutEngine(S, tm, chunk_frames=T, n_workers=2)):
        eng = make()
        try:
            assert eng.attach_all() == S
            eng.push_all(sigs)
            assert [eng.tick() for _ in range(n_chunks)] == [S] * n_chunks
            out, full = eng.pull_all(n_chunks * T * F)
        finally:
            eng.close()
        assert full == S
        outs.append(out.astype(np.int64))
    assert np.abs(outs[0] - outs[1]).max() <= 4


def test_fanout_worker_imports_neither_torch_nor_package():
    """The worker's module and its loader of streamio_abi.py pull in no
    torch and nothing of either package."""
    code = ("import runpy, sys\n"
            f"mod = runpy.run_path({fanout_worker.__file__!r}, run_name='probe')\n"
            "abi = mod['load_abi']()\n"
            "assert hasattr(abi, 'Pool') and hasattr(abi, 'bind')\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('torch', 'jax', 'rnnoise_tpu',\n"
            "                                    'rnnoise_tpu_torch')))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": ""})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
