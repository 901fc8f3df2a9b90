"""Pitch analysis of the port against rnnoise_tpu on CPU: the building
blocks on one buffer, then periods over a 120-frame stateful chain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnoise_tpu.config import PITCH_MAX_PERIOD
from rnnoise_tpu.dsp import pitch as jpitch
from rnnoise_tpu_torch.dsp import pitch as tpitch
from tests.conftest import speechlike
from tests.torch_helpers import no_jax_compile_cache  # noqa: F401


@pytest.fixture(scope="module")
def bufs():
    rng = np.random.default_rng(21)
    S = 6
    sig = np.stack([speechlike(rng, 1728, f0=f) for f in
                    (85.0, 110.0, 140.0, 180.0, 230.0, 300.0)])
    sig[5] = 400 * rng.standard_normal(1728)          # unvoiced
    return sig.astype(np.float32)


def test_downsample_and_lag_table(bufs):
    jds = np.asarray(jax.jit(jpitch.pitch_downsample)(jnp.asarray(bufs)))
    tds = tpitch.pitch_downsample(torch.from_numpy(bufs)).numpy()
    # the order-4 Levinson on a tonal buffer's autocorrelation is
    # ill-conditioned: f32 summation order moves the whitened output by
    # ~1e-4 of its peak (the period chain below is the real criterion)
    err = np.abs(tds - jds).max(axis=1) / np.abs(jds).max(axis=1)
    assert err.max() < 5e-4, err
    bx_j = np.asarray(jpitch.lag_corr_table(jnp.asarray(jds)))
    bx_t = tpitch.lag_corr_table(torch.from_numpy(jds.copy())).numpy()
    assert bx_t.shape == (6, 385)
    np.testing.assert_allclose(bx_t, bx_j, atol=1e-5 * np.abs(bx_j).max())


def test_search_and_doubling(bufs):
    ds = np.asarray(jax.jit(jpitch.pitch_downsample)(jnp.asarray(bufs)))
    jd, td = jnp.asarray(ds), torch.from_numpy(ds.copy())
    bx_j = jpitch.lag_corr_table(jd)
    bx_t = torch.from_numpy(np.array(bx_j))
    jb = [np.asarray(v) for v in jpitch.coarse_search(jd)]
    tb = [v.numpy() for v in tpitch.coarse_search(td)]
    np.testing.assert_array_equal(tb[0], jb[0])
    np.testing.assert_array_equal(tb[1], jb[1])
    jp = np.asarray(jpitch.pitch_search(jd, bx_j))
    tp = tpitch.pitch_search(td, bx_t).numpy()
    np.testing.assert_array_equal(tp, jp)
    prev_p = np.array([200, 0, 300, 400, 120, 60], np.int32)
    prev_g = np.array([0.5, 0.0, 0.9, 0.2, 0.7, 0.1], np.float32)
    jT, jg = jpitch.remove_doubling(jd, jnp.asarray(PITCH_MAX_PERIOD - jp),
                                    jnp.asarray(prev_p), jnp.asarray(prev_g), bx_j)
    tT, tg = tpitch.remove_doubling(td, torch.from_numpy(PITCH_MAX_PERIOD - tp),
                                    torch.from_numpy(prev_p),
                                    torch.from_numpy(prev_g), bx_t)
    np.testing.assert_array_equal(tT.numpy(), np.asarray(jT))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5)


def test_find_best_pitch_initial_candidates():
    """Fewer than two positive correlations: the reference's (0, 1) start."""
    xc = np.array([[-1, -2, -3, -4], [-1, 5, -1, -1], [1, 3, 2, -1]], np.float32)
    syy = np.ones_like(xc)
    ji = [np.asarray(v) for v in jpitch.find_best_pitch(jnp.asarray(xc), jnp.asarray(syy))]
    ti = [v.numpy() for v in tpitch.find_best_pitch(torch.from_numpy(xc),
                                                    torch.from_numpy(syy))]
    np.testing.assert_array_equal(ti[0], ji[0])
    np.testing.assert_array_equal(ti[1], ji[1])


def test_periods_over_stateful_chain():
    """120 frames of the pitch tracker's own state (last period and gain)
    on the same buffers: periods exact but for at most 2 ranking flips."""
    rng = np.random.default_rng(5)
    S, T = 4, 120
    sig = np.stack([speechlike(rng, (T + 3) * 480, f0=f, noise=0.1)
                    for f in (95.0, 125.0, 160.0, 210.0)]).astype(np.float32)

    def jstep(buf, per, gain):
        ds = jpitch.pitch_downsample(buf)
        bx = jpitch.lag_corr_table(ds)
        p = jpitch.pitch_search(ds, bx)
        return jpitch.remove_doubling(ds, PITCH_MAX_PERIOD - p, per, gain, bx)
    jstep = jax.jit(jstep)

    jper = jnp.zeros(S, jnp.int32)
    jgain = jnp.zeros(S, jnp.float32)
    tper = torch.zeros(S, dtype=torch.int32)
    tgain = torch.zeros(S)
    flips = 0
    for t in range(T):
        buf = sig[:, t * 480: t * 480 + 1728]
        jper, jgain = jstep(jnp.asarray(buf), jper, jgain)
        tb = torch.from_numpy(buf.copy())
        ds = tpitch.pitch_downsample(tb)
        bx = tpitch.lag_corr_table(ds)
        p = tpitch.pitch_search(ds, bx)
        tper, tgain = tpitch.remove_doubling(ds, PITCH_MAX_PERIOD - p, tper,
                                             tgain, bx)
        flips += int((tper.numpy() != np.asarray(jper)).sum())
    assert flips <= 2, f"{flips} period mismatches over {T} frames x {S} streams"
