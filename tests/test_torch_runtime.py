"""The port's serving runtime on CPU: the native stream pool over the
unchanged native/streamio.cc, and the StreamingEngine against the JAX
package's engine."""

import jax
import numpy as np
import pytest

from rnnoise_tpu.api import RNNoise as JModel
from rnnoise_tpu.runtime.engine import StreamingEngine as JEngine
from rnnoise_tpu.weights.loader import load_model_file as jload
from rnnoise_tpu_torch import kernels
from rnnoise_tpu_torch.api import RNNoise
from rnnoise_tpu_torch.runtime.engine import StreamingEngine
from rnnoise_tpu_torch.runtime.native import StreamPool, blob_validate
from rnnoise_tpu_torch.weights.loader import params_from_numpy
from tests.torch_helpers import (MODEL_BLOB, make_signal,  # noqa: F401
                                 no_jax_compile_cache)

F = 480


@pytest.fixture(scope="module")
def models():
    jp = jload(MODEL_BLOB)
    return JModel(jp), RNNoise(params_from_numpy(jax.tree.map(np.asarray, jp),
                                                 "cpu"), device="cpu")


def test_pool_builds_outside_native_and_round_trips():
    pool = StreamPool(3, ring_frames=8)
    assert "streamio" in kernels._LIBS
    assert [pool.attach() for _ in range(4)] == [0, 1, 2, -1]
    pcm = (np.arange(3 * F) % 2000 - 1000).astype(np.int16)
    assert pool.push(1, pcm) == 3 * F
    batch, counts, reset = pool.assemble_tm_i16(2)
    assert counts.tolist() == [0, 2, 0] and reset.tolist() == [1, 1, 1]
    np.testing.assert_array_equal(batch[:, 1].reshape(-1), pcm[:2 * F])
    pool.commit_tm_i16(2, batch, counts)
    np.testing.assert_array_equal(pool.pull(1, 4 * F), pcm[:2 * F])
    assert pool.available(1) == 0
    pool.detach(1)
    assert pool.attach() == 1
    out, full = pool.pull_all(F)
    assert out.shape == (3, F) and full == 0
    pool.close()


def test_blob_validate(models):
    with open(MODEL_BLOB, "rb") as f:
        blob = f.read()
    names = blob_validate(blob)
    assert "conv1_bias" in names and "gru3_recurrent_weights_diag" in names
    with pytest.raises(ValueError):
        blob_validate(b"JUNK" + blob[4:])


def _drive(eng, sigs, T, n_chunks):
    slots = [eng.attach() for _ in sigs]
    adv = []
    for c in range(n_chunks):
        for s, sig in zip(slots, sigs):
            if sig is not None:
                eng.push(s, sig[c * T * F:(c + 1) * T * F])
        adv.append(eng.tick())
    adv.append(eng.flush())
    return slots, adv


def test_engine_matches_reference_engine(models):
    """Three ticks of 4 frames on 3 active slots of 4, one starved slot."""
    jm, tm = models
    rng = np.random.default_rng(0)
    T, n = 4, 3
    sigs = [np.round(make_signal(rng, T * n)).astype(np.int16) for _ in range(3)]
    sigs.append(None)                                  # attached, never fed
    je = JEngine(4, jm, chunk_frames=T)
    te = StreamingEngine(4, tm, chunk_frames=T)
    js, jadv = _drive(je, sigs, T, n)
    ts, tadv = _drive(te, sigs, T, n)
    assert js == ts and jadv == tadv == [3, 3, 3, 0]
    for s in ts[:3]:
        a, b = je.pull(s, n * T * F), te.pull(s, n * T * F)
        assert len(a) == len(b) == n * T * F
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 4
    # the starved slot's state never advanced
    assert (te.state.pitch_buf[3] == 0).all() and (te.state.rnn.gru1[3] == 0).all()
    np.testing.assert_array_equal(te.state.last_period.numpy(),
                                  np.asarray(je.state.last_period))


def test_pipelined_engine_and_reattach(models):
    """pipelined=True gives the direct engine's output one tick later; a
    detached and re-attached slot starts from a fresh state."""
    _, tm = models
    rng = np.random.default_rng(4)
    T, n = 2, 3
    sig = np.round(make_signal(rng, T * n)).astype(np.int16)

    def run(pipelined):
        eng = StreamingEngine(2, tm, chunk_frames=T, pipelined=pipelined)
        s = eng.attach()
        adv = []
        for c in range(n):
            eng.push(s, sig[c * T * F:(c + 1) * T * F])
            adv.append(eng.tick())
        adv.append(eng.flush())
        return eng, s, adv, eng.pull(s, n * T * F)

    _, _, adv_d, out_d = run(False)
    eng, s, adv_p, out_p = run(True)
    assert adv_d == [1, 1, 1, 0] and adv_p == [0, 1, 1, 1]
    np.testing.assert_array_equal(out_p, out_d)
    eng.detach(s)
    assert eng.attach() == s
    eng.push(s, sig[:T * F])
    eng.tick()
    eng.flush()
    # same first chunk from a fresh state -> same output as the first run
    np.testing.assert_array_equal(eng.pull(s, T * F), out_d[:T * F])
