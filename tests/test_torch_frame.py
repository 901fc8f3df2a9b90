"""The whole-chunk kernel's plain version (dsp/cuda_frame.py) against
rnnoise_tpu.denoise.process_frames (the scan path on CPU) over 150 stateful
frames, its dispatch from process_frames_tm_i16, the fused route it takes
without an int8 model, and the configurations the kernel refuses on CUDA
tensors."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnoise_tpu import denoise as jd
from rnnoise_tpu.weights.loader import load_model_file as jload
from rnnoise_tpu_torch import denoise as td
from rnnoise_tpu_torch.config import CONFIGURATIONS
from rnnoise_tpu_torch.dsp import cuda_analysis, cuda_frame, cuda_spectral
from rnnoise_tpu_torch.weights.loader import params_from_numpy
from tests.torch_helpers import (MODEL_BLOB, OnCuda, make_signal,  # noqa: F401
                                 no_jax_compile_cache, xla_cpu_hp_state)

MONO = CONFIGURATIONS["mono"]


@pytest.fixture(scope="module")
def models():
    jp = jload(MODEL_BLOB)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _pcm(seed, S, T):
    """int16 [S, T, 480] of the parity tests' signal recipe (a near-silent
    and a noise-only stretch in every stream)."""
    rng = np.random.default_rng(seed)
    pcm = np.stack([make_signal(rng, T) for _ in range(S)])
    return np.clip(np.round(pcm), -32768, 32767).astype(np.int16).reshape(S, T, 480)


def _round_i16(out):
    out = np.asarray(out)
    r = np.trunc(np.where(out > 0, out + 0.5, out - 0.5))
    return np.clip(r, -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("S", [4, 5])
def test_monokernel_plain_matches_reference_150_frames(models, S):
    """PCM within 4 LSB, VAD within 2e-3, gains (lastg) within 1e-3, final
    pitch periods exact but for 2 flips per 120 frames, and the HP state
    bitwise (with the "xla_cpu" rounding), at S=4 and at S=5 (a block of 8
    streams with its tail masked, on the card)."""
    jp, tp = models
    T = 150
    pcm = _pcm(42, S, T)
    jst, jout, jvad = jax.jit(lambda s, x: jd.process_frames(jp, s, x))(
        jd.init_state(S), jnp.asarray(pcm.astype(np.float32)))
    tst, tout, tvad = cuda_frame.process_chunk_monokernel_plain(
        tp, td.init_state(S, device="cpu"),
        torch.from_numpy(pcm.transpose(1, 0, 2).copy()), xla_cpu_hp_state(MONO))
    assert tout.dtype == torch.int16 and tout.shape == (T, S, 480)
    pcm_err = np.abs(_round_i16(jout).astype(int)
                     - tout.numpy().transpose(1, 0, 2).astype(int)).max()
    vad_err = np.abs(np.asarray(jvad) - tvad.numpy().T).max()
    g_err = np.abs(np.asarray(jst.lastg) - tst.lastg.numpy()).max()
    flips = int((tst.last_period.numpy() != np.asarray(jst.last_period)).sum())
    assert pcm_err <= 4, f"PCM diverged: {pcm_err} LSB"
    assert vad_err <= 2e-3, f"VAD diverged: {vad_err}"
    assert g_err <= 1e-3, f"gains diverged: {g_err}"
    assert flips <= 2 * T // 120, f"{flips} final periods differ"
    np.testing.assert_array_equal(tst.mem_hp.numpy(), np.asarray(jst.mem_hp))


def test_mono_configuration_dispatches_to_the_monokernel(models):
    """process_frames_tm_i16 with the mono configuration takes the wrapper,
    which on CPU tensors runs the plain version and launches nothing; the
    caller's state is left as it was."""
    _, tp = models
    pcm = torch.from_numpy(_pcm(3, 2, 6).transpose(1, 0, 2).copy())
    st = td.init_state(2, device="cpu")
    before = cuda_frame.process_chunk_monokernel.launches
    a = td.process_frames_tm_i16(tp, st, pcm, MONO)
    b = cuda_frame.process_chunk_monokernel_plain(tp, st, pcm, MONO)
    c = td.process_frames_tm_i16(tp, st, pcm, CONFIGURATIONS["fused"], plain=True)
    assert cuda_frame.process_chunk_monokernel.launches == before
    for x, y, z in zip(a[0], b[0], c[0]):
        for u, v, w in zip(*((t if isinstance(t, tuple) else (t,))
                             for t in (x, y, z))):
            assert torch.equal(u, v) and torch.equal(u, w)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert not st.pitch_buf.any()


@pytest.mark.parametrize("change,what", [
    (dict(exact_pitch_rank=True), "exact_pitch_rank"),
    (dict(hp_rounding="xla_cpu"), "hp_rounding"),
    (dict(quantized=False), "numerics"),
    (dict(approx_act=False), "numerics"),
])
def test_monokernel_refuses_what_it_does_not_compute(models, change, what):
    """On a CUDA tensor the monokernel raises ValueError for a configuration
    it does not compute, naming the conflict, instead of falling back."""
    _, tp = models
    pcm = torch.zeros((2, 3, 480), dtype=torch.int16).as_subclass(OnCuda)
    rt = dataclasses.replace(MONO, **change)
    with pytest.raises(ValueError, match=what):
        td.process_frames_tm_i16(tp, td.init_state(3, device="cpu"), pcm, rt)
    with pytest.raises(ValueError, match="params"):
        cuda_frame.process_chunk_monokernel(None, td.init_state(3, device="cpu"),
                                            pcm, MONO)


@pytest.mark.parametrize("model", ["none", "float-only"])
def test_default_runtime_without_int8_model_runs_fused_kernels(models, model,
                                                               monkeypatch):
    """Under the default (mono) runtime a chunk on a CUDA tensor without a
    model, or with a float-only one (no int8 weights, which the monokernel
    needs), runs the fused configuration's frame loop with its kernels, as
    the JAX package falls back from its monokernel: no ValueError, no
    monokernel launch, the analysis and post-filter kernel wrappers called
    once a frame (stand-ins here that record the call and run the plain
    version), and the result equal to the fused configuration's plain
    path."""
    _, tp = models
    params = None if model == "none" else type(tp)(
        *(lp._replace(weights_q=None, scale=None) for lp in tp))
    calls = collections.Counter()

    def recording(name, plain):
        def wrapper(*args):
            calls[name] += 1
            return plain(*args)
        return wrapper
    monkeypatch.setattr(cuda_analysis, "analysis_spectral", recording(
        "analysis", cuda_analysis.analysis_spectral_plain))
    monkeypatch.setattr(cuda_spectral, "postfilter_synthesis", recording(
        "postfilter", cuda_spectral.postfilter_synthesis_plain))
    T, S = 6, 3
    pcm = torch.from_numpy(_pcm(5, S, T).transpose(1, 0, 2).copy())
    before = cuda_frame.process_chunk_monokernel.launches
    got = td.process_frames_tm_i16(params, td.init_state(S, device="cpu"),
                                   pcm.as_subclass(OnCuda))
    assert cuda_frame.process_chunk_monokernel.launches == before
    assert calls == {"analysis": T, "postfilter": T}
    want = td.process_frames_tm_i16(params, td.init_state(S, device="cpu"), pcm,
                                    CONFIGURATIONS["fused"], plain=True)
    for a, b in zip(cuda_frame._leaves(got[0]), cuda_frame._leaves(want[0])):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert got[1].abs().max() > 0
