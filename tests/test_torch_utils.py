"""The port's utils against the JAX package's on CPU: state files that
either package loads, the throughput meter and gain MSE, the profiler
trace, the NaN-checked frame loop and the int8-vs-float A/B.  Inputs come
from the pinned models/rnnoise_synth_v1.blob (the JAX package's own
tests/test_utils.py needs the absent C oracle)."""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnoise_tpu.denoise import init_state as jinit, process_frame as jframe
from rnnoise_tpu.utils import debug as jdebug
from rnnoise_tpu.utils import metrics as jmetrics
from rnnoise_tpu.utils import state_io as jstate_io
from rnnoise_tpu.weights.loader import load_model_file as jload
from rnnoise_tpu_torch.denoise import init_state, process_frame, process_frames
from rnnoise_tpu_torch.utils import debug, metrics, state_io
from rnnoise_tpu_torch.weights.loader import params_from_numpy
from tests.torch_helpers import (CPU, MODEL_BLOB, make_signal,  # noqa: F401
                                 no_jax_compile_cache, state_to_torch,
                                 xla_cpu_hp_state)

F = 480


@pytest.fixture(scope="module")
def params():
    jp = jload(MODEL_BLOB)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def _pcm(S, T, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([make_signal(rng, T).reshape(T, F)
                     for _ in range(S)]).astype(np.float32)


def _equal_states(a, b):
    la, lb = state_io.state_leaves(a), state_io.state_leaves(b)
    assert len(la) == len(lb) == state_io.N_LEAVES
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_jax_state_file_loads_in_the_port(params):
    jp, _ = params
    pcm = _pcm(2, 2)
    st = jinit(2)
    step = jax.jit(lambda s, x: jframe(jp, s, x))
    for t in range(2):
        st, _, _ = step(st, jnp.asarray(pcm[:, t]))
    buf = io.BytesIO()
    jstate_io.save_state(st, buf)
    buf.seek(0)
    _equal_states(state_io.load_state(buf, CPU), state_to_torch(st))


def test_port_state_file_loads_in_jax_and_continues(params):
    """A port state saved after two frames: JAX loads the same leaves, and
    the port continues from the loaded copy bit for bit."""
    _, tp = params
    pcm = torch.from_numpy(_pcm(2, 3, seed=1))
    rt = xla_cpu_hp_state()
    st = init_state(2, device=CPU)
    for t in range(2):
        st, _, _ = process_frame(tp, st, pcm[:, t], rt)
    buf = io.BytesIO()
    state_io.save_state(st, buf)
    buf.seek(0)
    loaded_jax = jstate_io.load_state(buf)
    _equal_states(state_to_torch(loaded_jax), st)
    buf.seek(0)
    loaded = state_io.load_state(buf, CPU)
    s1, o1, v1 = process_frame(tp, st, pcm[:, 2], rt)
    s2, o2, v2 = process_frame(tp, loaded, pcm[:, 2], rt)
    assert torch.equal(o1, o2) and torch.equal(v1, v2)
    _equal_states(s1, s2)


def test_meter_and_gain_mse_match_reference():
    rng = np.random.default_rng(4)
    g, g_ref = rng.uniform(0, 1, (5, 32)), rng.uniform(0, 1, (5, 32))
    assert metrics.gain_mse(g, g_ref) == pytest.approx(
        jmetrics.gain_mse(g, g_ref), rel=1e-12)
    meters = [metrics.ThroughputMeter(), jmetrics.ThroughputMeter()]
    for m in meters:
        m.start()
        m.stop(64, 100)
        m.seconds = 0.25              # the same wall time for both
        m.start()
        m.stop(64, 100)
        m.seconds += 0.5 - m.seconds  # ... and again
    a, b = (m.summary() for m in meters)
    assert a == pytest.approx(b, rel=1e-12)
    assert a["realtime_streams"] == pytest.approx(2 * 64 * 100 * 0.01 / 0.5)


def test_profile_trace_writes_a_trace(tmp_path, params):
    _, tp = params
    with metrics.profile_trace(str(tmp_path)) as prof:
        process_frames(tp, init_state(2, device=CPU),
                       torch.from_numpy(_pcm(2, 1)))
    traces = list(tmp_path.glob("trace-*.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 1000
    assert len(prof.key_averages()) > 10


def test_checked_process_frames(params):
    """Clean input: process_frames' results bit for bit.  A NaN planted in
    one stream's analysis_mem raises, naming the leaf and frame."""
    _, tp = params
    pcm = torch.from_numpy(_pcm(2, 3, seed=2))
    st0 = init_state(2, device=CPU)
    want = process_frames(tp, st0, pcm)
    got = debug.checked_process_frames(tp, st0, pcm)
    for a, b in zip(want[1:], got[1:]):
        assert torch.equal(a, b)
    _equal_states(want[0], got[0])
    bad = st0._replace(analysis_mem=st0.analysis_mem.clone())
    bad.analysis_mem[1, 7] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite .+ at frame 0"):
        debug.checked_process_frames(tp, bad, pcm)
    with debug.debug_nans():
        assert torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()


def test_numerics_ab_against_reference(params):
    """The int8-vs-float A/B on 2 streams x 3 frames.  Each package's two
    runs differ from the other package's by the float paths' rounding (the
    port's spectra are f64 rounded once), so the A/B figures are held to
    the parity budget: VAD 2e-3, PCM 4 LSB."""
    jp, tp = params
    pcm = _pcm(2, 3)
    vad_j, pcm_j = jdebug.numerics_ab(jp, jnp.asarray(pcm))
    vad_t, pcm_t = debug.numerics_ab(tp, torch.from_numpy(pcm))
    assert abs(vad_t - vad_j) <= 2e-3 and abs(pcm_t - pcm_j) <= 4
    assert 0 < vad_t < 0.05 and 0 < pcm_t < 50.0      # tests/test_utils.py's
