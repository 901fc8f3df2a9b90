"""The slice as a whole: the port's process_frames_tm_i16 against
rnnoise_tpu.denoise.process_frames (the scan path on CPU) over 150 stateful
frames with models/rnnoise_synth_v1.blob, plus the denoiser's entry points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnoise_tpu import denoise as jd
from rnnoise_tpu.config import RuntimeConfig as JRuntime
from rnnoise_tpu import tables as jtab
from rnnoise_tpu.dsp import biquad as jbq
from rnnoise_tpu.weights.loader import load_model_file as jload
from rnnoise_tpu_torch import denoise as td
from rnnoise_tpu_torch.config import CONFIGURATIONS, DEFAULT_RUNTIME, RuntimeConfig
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


def _pcm(seed, S=4, T=150):
    """int16 [S, T, 480] of the parity tests' signal recipe."""
    rng = np.random.default_rng(seed)
    pcm = np.stack([make_signal(rng, T) for _ in range(S)])
    return np.clip(np.round(pcm), -32768, 32767).astype(np.int16).reshape(S, T, 480)


@pytest.fixture(scope="module")
def reference(models):
    """rnnoise_tpu.denoise.process_frames over 150 frames of a seed's
    signal, memoised per (seed, stream): stream None runs all 4 streams at
    S=4, an index runs that stream alone at S=1.  Returns (state, int16 PCM
    [S, T, 480], VAD [S, T]) as numpy."""
    jp, _ = models
    run = jax.jit(lambda s, x: jd.process_frames(jp, s, x))
    memo = {}

    def get(seed, stream=None):
        if (seed, stream) not in memo:
            pcm = _pcm(seed)
            if stream is not None:
                pcm = pcm[stream:stream + 1]
            st, out, vad = run(jd.init_state(pcm.shape[0]),
                               jnp.asarray(pcm.astype(np.float32)))
            memo[seed, stream] = (st, _round_i16(out), np.asarray(vad))
        return memo[seed, stream]
    return get


def _port(tp, seed, rt):
    pcm = _pcm(seed)
    st, out, vad = td.process_frames_tm_i16(
        tp, td.init_state(pcm.shape[0], device="cpu"),
        torch.from_numpy(pcm.transpose(1, 0, 2).copy()), rt)
    assert out.dtype == torch.int16 and out.shape == (150, 4, 480)
    return st, out.numpy().transpose(1, 0, 2), vad.numpy().T


@pytest.mark.parametrize("config", sorted(CONFIGURATIONS))
def test_slice_matches_reference_150_frames(models, reference, config):
    """PCM within 4 LSB, VAD within 2e-3, gains (lastg) within 1e-3, final
    pitch periods exact (the reference's parity rules, docs/PARITY.md), for
    each kernel configuration of the main path (their plain versions here).
    The HP state is rounded as the JAX package rounds it, so the two
    pipelines start every frame from the same filter state.  The reference
    is the JAX package's scan path: its fused kernels run on a TPU only."""
    _, tp = models
    jst, jout, jvad = reference(42)
    tst, tout, tvad = _port(tp, 42, xla_cpu_hp_state(CONFIGURATIONS[config]))
    pcm_err = np.abs(jout.astype(int) - tout.astype(int)).max()
    vad_err = np.abs(jvad - tvad).max()
    g_err = np.abs(np.asarray(jst.lastg) - tst.lastg.numpy()).max()
    assert pcm_err <= 4, f"PCM diverged: {pcm_err} LSB"
    assert vad_err <= 2e-3, f"VAD diverged: {vad_err}"
    assert g_err <= 1e-3, f"gains diverged: {g_err}"
    np.testing.assert_array_equal(tst.last_period.numpy(),
                                  np.asarray(jst.last_period))
    np.testing.assert_array_equal(tst.mem_hp.numpy(), np.asarray(jst.mem_hp))


def test_serving_rounding_within_reference_batch_spread(models, reference):
    """The serving configuration with its HP-state rounding ("f64", closer
    to the exact filter than the JAX package's f32 update) against the JAX
    package over 150 frames at S=4, seeds 42 and 0-3: its largest PCM and
    VAD deviation is no larger than the JAX package's own between batch
    sizes (S=4 against each stream run alone at S=1) on the same signals."""
    _, tp = models
    port_pcm = port_vad = ref_pcm = ref_vad = 0
    for seed in (42, 0, 1, 2, 3):
        _, jout, jvad = reference(seed)
        _, tout, tvad = _port(tp, seed, DEFAULT_RUNTIME)
        port_pcm = max(port_pcm, np.abs(jout.astype(int) - tout.astype(int)).max())
        port_vad = max(port_vad, np.abs(jvad - tvad).max())
        one = [reference(seed, s) for s in range(4)]
        o1 = np.concatenate([o for _, o, _ in one]).astype(int)
        v1 = np.concatenate([v for _, _, v in one])
        ref_pcm = max(ref_pcm, np.abs(jout.astype(int) - o1).max())
        ref_vad = max(ref_vad, np.abs(jvad - v1).max())
    assert port_pcm <= ref_pcm, (port_pcm, ref_pcm)
    assert port_vad <= ref_vad, (port_vad, ref_vad)


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


def _frames_state(S, T, seed):
    """The JAX package's state after T frames of the signal recipe, as both
    packages' states, and the next frame HP-filtered."""
    jp = jload(MODEL_BLOB)
    rng = np.random.default_rng(seed)
    pcm = np.round(np.stack([make_signal(rng, T + 1) for _ in range(S)]))
    pcm = pcm.reshape(S, T + 1, 480).astype(np.float32)
    jst, _, _ = jax.jit(lambda s, x: jd.process_frames(jp, s, x))(
        jd.init_state(S), jnp.asarray(pcm[:, :T]))
    x, _ = jbq.biquad(jnp.asarray(pcm[:, T]), jst.mem_hp, jtab.BIQUAD_HP_B,
                      jtab.BIQUAD_HP_A)
    return jst, state_to_torch(jst), np.array(x)


def test_training_and_lowpass_features_match_reference():
    """compute_frame_features with ``training`` (the silence gate at E < 0.1,
    features kept) and ``lowpass_bin`` (X zeroed from that bin up) against
    the JAX package's from the same state and frame, in each configuration
    (both options take the pitch chain in PyTorch)."""
    S = 4
    jst, tst, x = _frames_state(S, 12, 31)
    lp = np.array([481, 120, 37, 300], np.int32)
    jf = {}
    for training, lowpass in ((True, None), (False, lp), (True, lp)):
        _, ff = jd.compute_frame_features(
            jst, jnp.asarray(x), training=training,
            lowpass_bin=None if lowpass is None else jnp.asarray(lowpass))
        jf[training, lowpass is None] = ff
    for config, rt in CONFIGURATIONS.items():
        for (training, no_lp), jff in jf.items():
            lowpass = None if no_lp else torch.from_numpy(lp)
            st, tff = td.compute_frame_features(tst, torch.from_numpy(x), rt,
                                                training=training,
                                                lowpass_bin=lowpass)
            X = np.asarray(jff.X)
            np.testing.assert_allclose(
                tff.X.numpy(), np.concatenate([X.real, X.imag], -1),
                atol=1e-4 * np.abs(X).max(), rtol=0)
            np.testing.assert_array_equal(tff.silence.numpy(),
                                          np.asarray(jff.silence))
            np.testing.assert_allclose(tff.features.numpy(),
                                       np.asarray(jff.features), atol=2e-4,
                                       rtol=0, err_msg=config)
            assert (tff.features.abs().sum(-1) > 0).all() or not training
    # bins at and above the lowpass bin are zero in both halves
    _, tff = td.compute_frame_features(tst, torch.from_numpy(x),
                                       lowpass_bin=torch.from_numpy(lp))
    for s, b in enumerate(lp):
        assert not tff.X[s, b:481].any() and not tff.X[s, 481 + b:].any()


def test_exact_pitch_rank_configuration_matches_reference(models):
    """RuntimeConfig(exact_pitch_rank=True) runs (it raised TypeError
    before) and tracks the JAX package's exact ranking: 10 frames at S=2,
    periods exact, PCM within 4 LSB."""
    jp, tp = models
    S, T = 2, 10
    pcm = _pcm(7, S=S, T=T)
    jst, jout, _ = jax.jit(lambda s, x: jd.process_frames(
        jp, s, x, JRuntime(exact_pitch_rank=True)))(
        jd.init_state(S), jnp.asarray(pcm.astype(np.float32)))
    rt = xla_cpu_hp_state(RuntimeConfig(exact_pitch_rank=True))
    tst, tout, _ = td.process_frames_tm_i16(
        tp, td.init_state(S, device="cpu"),
        torch.from_numpy(pcm.transpose(1, 0, 2).copy()), rt)
    np.testing.assert_array_equal(tst.last_period.numpy(),
                                  np.asarray(jst.last_period))
    assert np.abs(_round_i16(jout).astype(int)
                  - tout.numpy().transpose(1, 0, 2).astype(int)).max() <= 4
