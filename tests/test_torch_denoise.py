"""The slice as a whole: the port's process_frames_tm_i16 against
rnnoise_tpu.denoise.process_frames (the scan path on CPU) over 150 stateful
frames with models/rnnoise_synth_v1.blob, plus the denoiser's entry points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnoise_tpu import denoise as jd
from rnnoise_tpu.weights.loader import load_model_file as jload
from rnnoise_tpu_torch import denoise as td
from rnnoise_tpu_torch.weights.loader import params_from_numpy
from tests.torch_helpers import (MODEL_BLOB, make_signal,  # noqa: F401
                                 no_jax_compile_cache, state_to_torch,
                                 xla_cpu_hp_state)


@pytest.fixture(scope="module")
def models():
    jp = jload(MODEL_BLOB)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _round_i16(out):
    out = np.asarray(out)
    r = np.trunc(np.where(out > 0, out + 0.5, out - 0.5))
    return np.clip(r, -32768, 32767).astype(np.int16)


def test_slice_matches_reference_150_frames(models, xla_cpu_hp_state):
    """PCM within 4 LSB, VAD within 2e-3, gains (lastg) within 1e-3, final
    pitch periods exact (the reference's parity rules, docs/PARITY.md).
    The HP state is rounded as the JAX package rounds it, so the two
    pipelines start every frame from the same filter state."""
    jp, tp = models
    S, T = 4, 150
    rng = np.random.default_rng(42)
    pcm = np.stack([make_signal(rng, T) for _ in range(S)])
    pcm = np.clip(np.round(pcm), -32768, 32767).astype(np.int16)
    pcm = pcm.reshape(S, T, 480)
    jst, jout, jvad = jax.jit(lambda s, x: jd.process_frames(jp, s, x))(
        jd.init_state(S), jnp.asarray(pcm.astype(np.float32)))
    tst, tout, tvad = td.process_frames_tm_i16(
        tp, td.init_state(S, device="cpu"),
        torch.from_numpy(pcm.transpose(1, 0, 2).copy()))
    assert tout.dtype == torch.int16 and tout.shape == (T, S, 480)
    pcm_err = np.abs(_round_i16(jout).astype(int)
                     - tout.numpy().transpose(1, 0, 2).astype(int)).max()
    vad_err = np.abs(np.asarray(jvad) - tvad.numpy().T).max()
    g_err = np.abs(np.asarray(jst.lastg) - tst.lastg.numpy()).max()
    assert pcm_err <= 4, f"PCM diverged: {pcm_err} LSB"
    assert vad_err <= 2e-3, f"VAD diverged: {vad_err}"
    assert g_err <= 1e-3, f"gains diverged: {g_err}"
    np.testing.assert_array_equal(tst.last_period.numpy(),
                                  np.asarray(jst.last_period))
    np.testing.assert_array_equal(tst.mem_hp.numpy(), np.asarray(jst.mem_hp))


def test_frame_and_chunk_entry_points_agree(models):
    """process_frame T times == process_frames_tm == process_frames."""
    _, tp = models
    S, T = 2, 6
    rng = np.random.default_rng(3)
    pcm = np.round(np.stack([make_signal(rng, T) for _ in range(S)]))
    pcm = torch.from_numpy(pcm.reshape(S, T, 480).astype(np.float32))
    st = td.init_state(S, device="cpu")
    outs = []
    for t in range(T):
        st, o, _ = td.process_frame(tp, st, pcm[:, t])
        outs.append(o)
    s1, o1, v1 = td.process_frames_tm(tp, td.init_state(S, device="cpu"),
                                      pcm.transpose(0, 1))
    s2, o2, v2 = td.process_frames(tp, td.init_state(S, device="cpu"), pcm)
    # the chunk filters all frames' inputs in one matmul: sub-LSB only
    np.testing.assert_allclose(torch.stack(outs).numpy(), o1.numpy(), atol=0.5)
    assert torch.equal(o1.transpose(0, 1), o2) and torch.equal(v1.T, v2)
    assert torch.equal(st.mem_hp, s1.mem_hp)


def test_no_model_path_matches_reference():
    """params=None: the DSP path with unity gains."""
    S, T = 2, 12
    rng = np.random.default_rng(9)
    pcm = np.round(np.stack([make_signal(rng, T) for _ in range(S)]))
    pcm = pcm.reshape(S, T, 480).astype(np.float32)
    _, jout, jvad = jax.jit(lambda s, x: jd.process_frames(None, s, x))(
        jd.init_state(S), jnp.asarray(pcm))
    _, tout, tvad = td.process_frames(None, td.init_state(S, device="cpu"),
                                      torch.from_numpy(pcm))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=4.0)  # PCM budget
    assert (tvad.numpy() == 0).all()


def test_init_and_reset_streams():
    st = td.init_state(3, device="cpu")
    ref = jd.init_state(3)
    for f, a, b in zip(ref._fields, ref, st):
        for x, y in zip(a if f == "rnn" else (a,), b if f == "rnn" else (b,)):
            assert tuple(x.shape) == tuple(y.shape), f
            assert str(np.asarray(x).dtype) == str(y.numpy().dtype), f
    full = td.map_state(lambda a: torch.ones_like(a), st)
    out = td.reset_streams(full, torch.tensor([False, True, False]))
    for a in (out.pitch_buf, out.rnn.gru2, out.last_period):
        assert (a[1] == 0).all() and (a[0] == 1).all() and (a[2] == 1).all()


def test_one_frame_from_a_reference_state(models):
    """Start the port from a mid-stream JAX state: one frame agrees to a
    fraction of an LSB (the state layouts are the same)."""
    jp, tp = models
    S = 2
    rng = np.random.default_rng(12)
    pcm = np.round(np.stack([make_signal(rng, 9) for _ in range(S)]))
    pcm = pcm.reshape(S, 9, 480).astype(np.float32)
    step = jax.jit(lambda s, x: jd.process_frame(jp, s, x))
    jst = jd.init_state(S)
    for t in range(8):
        jst, _, _ = step(jst, jnp.asarray(pcm[:, t]))
    _, jo, jv = step(jst, jnp.asarray(pcm[:, 8]))
    _, to, tv = td.process_frame(tp, state_to_torch(jst),
                                 torch.from_numpy(pcm[:, 8].copy()))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=0.05)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
