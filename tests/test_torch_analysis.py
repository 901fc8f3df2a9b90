"""The plain versions of the port's pitch-analysis kernels against the JAX
package's Pallas kernels, run in interpret mode on CPU: the lag-correlation
table (pallas_xcorr.lag_corr_table_pallas) and the fused analysis
(pallas_analysis.analysis_spectral) over a stateful chain of frames."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rnnoise_tpu.config import PITCH_BUF_SIZE
from rnnoise_tpu.dsp import pallas_spectral as ps
from rnnoise_tpu.dsp import pitch as jpitch
from rnnoise_tpu.dsp.pallas_analysis import analysis_spectral as janalysis
from rnnoise_tpu.dsp.pallas_xcorr import lag_corr_table_pallas
from rnnoise_tpu_torch.dsp import cuda_analysis, cuda_xcorr
from rnnoise_tpu_torch.dsp import pitch as tpitch
from tests.conftest import speechlike
from tests.torch_helpers import no_jax_compile_cache  # noqa: F401


def _permuted(X):
    """The port's natural [S, 962] re|im spectrum in the TPU kernels'
    permuted layout."""
    X = X.numpy()
    return np.asarray(ps.permute_spectrum(jnp.asarray(X[:, :481] + 1j * X[:, 481:])))


def test_lag_corr_table_matches_pallas_kernel():
    """The buffers of tests/test_pallas.py's xcorr test: speech-like,
    noise and silence."""
    rng = np.random.default_rng(42)
    ds = np.stack([
        speechlike(rng, 1728, f0=130.0, noise=0.1)[::2],
        speechlike(rng, 1728, f0=70.0, noise=0.3)[::2],
        (300 * rng.standard_normal(864)).astype(np.float32),
        np.zeros(864, np.float32),
    ])
    ref = np.asarray(lag_corr_table_pallas(jnp.asarray(ds), interpret=True))
    before = cuda_xcorr.lag_corr_table_kernel.launches
    got = cuda_xcorr.lag_corr_table_kernel(torch.from_numpy(ds)).numpy()
    assert cuda_xcorr.lag_corr_table_kernel.launches == before   # CPU: plain
    assert got.shape == (4, 385) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=3e-6 * max(np.abs(ref).max(), 1.0))
    # the dispatch of the pitch chain's table
    t = torch.from_numpy(ds)
    assert torch.equal(tpitch.lag_corr_table(t, xcorr=True), torch.from_numpy(got))
    assert torch.equal(tpitch.lag_corr_table(t, xcorr=True, plain=True),
                       torch.from_numpy(got))


def test_lag_energy_table_matches_reference():
    """The analysis' lag table and energies (on the CPU, their plain
    version) against the JAX package's: the Pallas lag table in interpret
    mode, and find_best_pitch's sliding energies, which JAX sums as an f32
    running sum (so within 1e-4 of a row's largest)."""
    rng = np.random.default_rng(43)
    n = np.arange(864)
    ds = np.stack([
        speechlike(rng, 1728, f0=130.0, noise=0.1)[::2],
        (300 * rng.standard_normal(864) * 10.0 ** (-3.0 * n / 863)).astype(np.float32),
        np.where(n < 300, 3000.0, 0.3).astype(np.float32) * speechlike(rng, 1728, f0=90.0)[::2],
        np.zeros(864, np.float32),
    ])
    before = cuda_analysis.lag_energy_table.launches
    bx, yy = (t.numpy() for t in cuda_analysis.lag_energy_table(torch.from_numpy(ds)))
    assert cuda_analysis.lag_energy_table.launches == before      # CPU: plain
    assert bx.shape == yy.shape == (4, 385) and bx.dtype == yy.dtype == np.float32
    ref = np.asarray(lag_corr_table_pallas(jnp.asarray(ds), interpret=True))
    np.testing.assert_allclose(bx, ref, atol=3e-6 * max(np.abs(ref).max(), 1.0))
    syy_ref = np.asarray(jpitch._sliding_syy(jnp.asarray(ds), 480, 385))
    syy = np.maximum(1.0 + yy, 1.0)
    assert (np.abs(syy - syy_ref) <= 1e-4 * syy_ref.max(1, keepdims=True)).all()
    assert (yy >= 0).all() and not yy[3].any()


def test_analysis_matches_pallas_kernel_over_a_chain():
    """The signals of tests/test_pallas.py's analysis test, over six chained
    frames: each frame's period and gain are the next one's continuity
    inputs (the fourth stream halves its pitch half-way, so a doubling
    candidate meets the previous period).  T0 exact, gain within 2e-5, X and
    P within 3e-5 of their largest magnitude."""
    rng = np.random.default_rng(42)
    S, F = 4, 6
    n = PITCH_BUF_SIZE + (F - 1) * 480
    sig = np.stack([speechlike(rng, n, f0=f0, noise=nz) * amp
                    for f0, nz, amp in [(130, .1, 3000), (70, .4, 8000),
                                        (221, .05, 600), (100, .9, 2000)]])
    sig[3, n // 2:] = 0.7 * speechlike(rng, n - n // 2, f0=100.0, noise=.05)
    sig[3, :n // 2] = 0.7 * speechlike(rng, n // 2, f0=200.0, noise=.05)
    jrun = jax.jit(lambda *a: janalysis(*a, interpret=True))
    jprep = jax.jit(lambda b: (lambda d: (d, *jpitch.coarse_search(d)))(
        jpitch.pitch_downsample(b)))
    jp = jnp.asarray(rng.integers(60, 700, S), jnp.int32)
    jg = jnp.asarray(rng.uniform(0, 1, S), jnp.float32)
    tp, tg = torch.from_numpy(np.array(jp)), torch.from_numpy(np.array(jg))
    for f in range(F):
        buf = sig[:, f * 480: f * 480 + PITCH_BUF_SIZE].astype(np.float32)
        mem, x = buf[:, -960:-480], buf[:, -480:]
        ds, bp0, bp1 = jprep(jnp.asarray(buf))
        Xp, Pp, jp, jg = jrun(jnp.asarray(mem), jnp.asarray(x), jnp.asarray(buf),
                              ds, bp0, bp1, jp, jg)
        tX, tP, tp, tg = cuda_analysis.analysis_spectral(
            *(torch.from_numpy(np.array(a)) for a in (mem, x, buf, ds, bp0, bp1)),
            tp, tg)
        assert tp.dtype == torch.int32 and tX.shape == (S, 962)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp), err_msg=f"frame {f}")
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=2e-5)
        for got, ref in ((tX, Xp), (tP, Pp)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(_permuted(got), ref,
                                       atol=3e-5 * max(np.abs(ref).max(), 1.0))
