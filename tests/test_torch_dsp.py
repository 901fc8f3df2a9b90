"""DSP modules of the port against rnnoise_tpu on CPU: the HP biquad, the
transforms and band helpers, and the plain versions of the forward- and
inverse-spectrum kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnoise_tpu import tables as jtab
from rnnoise_tpu.dsp import biquad as jbq
from rnnoise_tpu.dsp import transform as jtr
from rnnoise_tpu.dsp.gather import take_window as jtake
from rnnoise_tpu_torch import tables
from rnnoise_tpu_torch.dsp import biquad as tbq
from rnnoise_tpu_torch.dsp import cuda_spectral as spec
from rnnoise_tpu_torch.dsp import transform as ttr
from tests.conftest import speechlike
from tests.torch_helpers import no_jax_compile_cache  # noqa: F401


def _ri(X):
    X = np.asarray(X)
    return np.concatenate([X.real, X.imag], axis=-1).astype(np.float32)


def _rel(a, b):
    """max over rows of max|a - b| / max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b).max(-1) / np.abs(b).max(-1)).max())


def test_biquad_state_tracks_reference_bitwise():
    """20 chained frames in the "xla_cpu" state rounding: the filter state
    is bit-identical to the JAX package's (its 1-ulp errors would grow ~290x
    per frame), the output within a fraction of an LSB."""
    rng = np.random.default_rng(0)
    S, T = 4, 20
    x = np.stack([speechlike(rng, T * 480, f0=90 + 40 * i) for i in range(S)])
    x = np.round(x).reshape(S, T, 480).astype(np.float32)
    f = jax.jit(lambda v, m: jbq.biquad(v, m, jtab.BIQUAD_HP_B, jtab.BIQUAD_HP_A))
    jm = jnp.zeros((S, 2), jnp.float32)
    ys = []
    for t in range(T):
        y, jm = f(jnp.asarray(x[:, t]), jm)
        ys.append(np.asarray(y))
    ty, tm = tbq.biquad_frames(torch.from_numpy(x.transpose(1, 0, 2).copy()),
                               torch.zeros(S, 2), tables.BIQUAD_HP_B,
                               tables.BIQUAD_HP_A, "xla_cpu")
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(ty.numpy(), np.stack(ys), atol=5e-3, rtol=0)
    # one frame at a time gives the same as the chunk
    m = torch.zeros(S, 2)
    for t in range(T):
        y1, m = tbq.biquad(torch.from_numpy(x[:, t].copy()), m,
                           tables.BIQUAD_HP_B, tables.BIQUAD_HP_A, "xla_cpu")
        np.testing.assert_allclose(y1.numpy(), ty[t].numpy(), atol=5e-3, rtol=0)
    assert torch.equal(m, tm)


def test_biquad_f64_state_tracks_exact_filter():
    """20 chained frames in the default "f64" state rounding against the
    filter run sample by sample in float64 (the reference's loop,
    src/denoise.c:409-419, with a double state): output within 0.05 (the f32
    [N, N] matmul's rounding at |y| ~ 3e4; measured <= 0.015, where the JAX
    package's f32 state update is off by 1.4-3.4), state within 0.02 (one
    0.5-ulp rounding per frame at |s| ~ 300, amplified up to ~290x)."""
    b = np.asarray(tables.BIQUAD_HP_B, np.float64)
    a = np.asarray(tables.BIQUAD_HP_A, np.float64)
    rng = np.random.default_rng(0)
    S, T = 4, 20
    x = np.stack([speechlike(rng, T * 480, f0=90 + 40 * i) for i in range(S)])
    x = np.round(x).reshape(S, T, 480).astype(np.float32)
    xs = x.reshape(S, -1).astype(np.float64)
    m = np.zeros((S, 2))
    y = np.empty_like(xs)
    for i in range(T * 480):
        y[:, i] = xs[:, i] + m[:, 0]
        m = np.stack([m[:, 1] + b[0] * xs[:, i] - a[0] * y[:, i],
                      b[1] * xs[:, i] - a[1] * y[:, i]], 1)
    ty, tm = tbq.biquad_frames(torch.from_numpy(x.transpose(1, 0, 2).copy()),
                               torch.zeros(S, 2), tables.BIQUAD_HP_B,
                               tables.BIQUAD_HP_A)
    assert tm.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy().transpose(1, 0, 2).reshape(S, -1),
                               y, atol=0.05, rtol=0)
    np.testing.assert_allclose(tm.numpy(), m, atol=0.02, rtol=0)


def test_hp_rounding_is_a_configuration():
    """No module global decides the HP-state rounding: each call names its
    own (RuntimeConfig.hp_rounding through the denoiser), calls with the two
    roundings interleave without touching each other, and an unknown one is
    refused."""
    from rnnoise_tpu_torch import denoise as td
    from rnnoise_tpu_torch.config import RuntimeConfig
    assert not hasattr(tbq, "set_state_rounding")
    assert not hasattr(tbq, "_STATE_ROUNDING")
    rng = np.random.default_rng(3)
    S, T = 2, 6
    x = np.stack([speechlike(rng, T * 480, f0=100 + 50 * i) for i in range(S)])
    x = torch.from_numpy(np.round(x).reshape(S, T, 480).transpose(1, 0, 2)
                         .astype(np.float32).copy())
    mem = {}
    for mode in ("xla_cpu", "f64", "xla_cpu", "f64"):
        _, m = tbq.biquad_frames(x, torch.zeros(S, 2), tables.BIQUAD_HP_B,
                                 tables.BIQUAD_HP_A, mode)
        assert mode not in mem or torch.equal(mem[mode], m)
        mem[mode] = m
        st, _, _ = td.process_frames_tm(None, td.init_state(S, device="cpu"),
                                        x, RuntimeConfig(hp_rounding=mode))
        assert torch.equal(st.mem_hp, m)
    assert not torch.equal(mem["xla_cpu"], mem["f64"])
    with pytest.raises(ValueError, match="hp_rounding"):
        RuntimeConfig(hp_rounding="f32")


@pytest.fixture(scope="module")
def spectra():
    rng = np.random.default_rng(4)
    x = (3000 * rng.standard_normal((6, 960))).astype(np.float32)
    X = jtr.forward_transform(jnp.asarray(x))
    return x, X


def test_forward_and_inverse_transforms(spectra):
    x, X = spectra
    TX = ttr.forward_transform(torch.from_numpy(x))
    assert _rel(TX.numpy(), _ri(X)) < 1e-5
    TW = ttr.windowed_forward_transform(torch.from_numpy(x))
    assert _rel(TW.numpy(), _ri(jtr.windowed_forward_transform(jnp.asarray(x)))) < 1e-5
    inv = ttr.inverse_transform(torch.from_numpy(_ri(X)))
    assert _rel(inv.numpy(), np.asarray(jtr.inverse_transform(X))) < 1e-5
    np.testing.assert_allclose(inv.numpy(), x, atol=2e-2, rtol=0)   # round trip
    winv = ttr.windowed_inverse_transform(torch.from_numpy(_ri(X)))
    assert _rel(winv.numpy(),
                np.asarray(jtr.windowed_inverse_transform(X))) < 1e-5
    np.testing.assert_allclose(ttr.apply_window(torch.from_numpy(x)).numpy(),
                               np.asarray(jtr.apply_window(jnp.asarray(x))),
                               rtol=1e-6)


def test_band_helpers(spectra):
    x, X = spectra
    P = jtr.forward_transform(jnp.asarray(x[::-1].copy()))
    TX, TP = torch.from_numpy(_ri(X)), torch.from_numpy(_ri(P))
    for got, ref in (
            (ttr.compute_band_energy(TX), jtr.compute_band_energy(X)),
            (ttr.compute_band_corr(TX, TP), jtr.compute_band_corr(X, P))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6 * float(np.abs(ref).max()))
    g = np.random.default_rng(1).random((6, 32)).astype(np.float32)
    gi = ttr.interp_band_gain(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(gi, np.asarray(jtr.interp_band_gain(jnp.asarray(g))),
                               atol=1e-6)
    assert (gi[:, 401:] == 0).all()
    np.testing.assert_allclose(ttr.dct(torch.from_numpy(g)).numpy(),
                               np.asarray(jtr.dct(jnp.asarray(g))), atol=1e-5)


def test_frame_synthesis(spectra):
    x, X = spectra
    mem = np.random.default_rng(2).standard_normal((6, 480)).astype(np.float32)
    jm, jo = jtr.frame_synthesis(jnp.asarray(mem), X)
    tm, to = ttr.frame_synthesis(torch.from_numpy(mem), torch.from_numpy(_ri(X)))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=2e-2)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-2)


def test_forward_spectral_plain_matches_reference():
    """The forward-spectrum kernel's plain version: window [mem | x] and the
    pitch window at a random start in [0, 708], both DFTs scaled 1/960."""
    rng = np.random.default_rng(8)
    S = 8
    mem = (3000 * rng.standard_normal((S, 480))).astype(np.float32)
    x = (3000 * rng.standard_normal((S, 480))).astype(np.float32)
    pbuf = (3000 * rng.standard_normal((S, 1728))).astype(np.float32)
    start = rng.integers(0, 709, S).astype(np.int32)
    start[:2] = (0, 708)
    jX = jtr.windowed_forward_transform(jnp.asarray(np.concatenate([mem, x], 1)))
    p = jtake(jnp.asarray(pbuf), jnp.asarray(start), 960, max_start=708)
    jP = jtr.windowed_forward_transform(p)
    before = spec.forward_spectral.launches
    tX, tP = spec.forward_spectral(torch.from_numpy(mem), torch.from_numpy(x),
                                   torch.from_numpy(pbuf),
                                   torch.from_numpy(start))
    assert spec.forward_spectral.launches == before
    assert tX.shape == (S, 962) and tP.shape == (S, 962)
    assert _rel(tX.numpy(), _ri(jX)) < 1e-5
    assert _rel(tP.numpy(), _ri(jP)) < 1e-5


def test_inverse_spectral_plain_matches_reference(spectra):
    _, X = spectra
    Y = _ri(X)
    Y[:, 481] = 5.0            # imaginary parts of bins 0 and 480 are
    Y[:, -1] = -7.0            # ignored by a real inverse
    before = spec.inverse_spectral.launches
    out = spec.inverse_spectral(torch.from_numpy(Y))
    assert spec.inverse_spectral.launches == before
    assert _rel(out.numpy(), np.asarray(jtr.windowed_inverse_transform(X))) < 1e-5


def test_kernel_tables():
    win, tw = spec.kernel_tables("cpu")
    np.testing.assert_array_equal(win.numpy(), tables.full_window())
    m = np.arange(960)
    np.testing.assert_allclose(tw.numpy()[:, 0], np.cos(2 * np.pi * m / 960), atol=1e-7)
    np.testing.assert_allclose(tw.numpy()[:, 1], np.sin(2 * np.pi * m / 960), atol=1e-7)
    assert tw[480, 1] == 0 and tw[0, 1] == 0 and tw[240, 0] == 0


def test_postfilter_synthesis_plain_matches_pallas_kernel():
    """The post-filter kernel's plain version against the JAX package's
    postfilter_synthesis in interpret mode, on the inputs of
    tests/test_pallas.py's post-filter test (spectra of random signals, one
    silent stream): out and synthesis_mem within 1e-4 of the largest output,
    lastg within 2e-5."""
    from rnnoise_tpu.dsp import pallas_spectral as ps
    rng = np.random.default_rng(42)
    S = 8
    x_t = rng.standard_normal((S, 960)).astype(np.float32) * 3000
    p_t = 0.7 * x_t + 500 * rng.standard_normal((S, 960)).astype(np.float32)
    X = jtr.windowed_forward_transform(jnp.asarray(x_t))
    P = jtr.windowed_forward_transform(jnp.asarray(p_t))
    Ex, Ep = jtr.compute_band_energy(X), jtr.compute_band_energy(P)
    Exp = jtr.compute_band_corr(X, P) / jnp.sqrt(0.001 + Ex * Ep)
    g = rng.uniform(0.05, 1.0, (S, 32)).astype(np.float32)
    lastg = rng.uniform(0, 1, (S, 32)).astype(np.float32)
    Ex_cur = np.asarray(Ex) * rng.uniform(0.5, 2.0, (S, 1)).astype(np.float32)
    silence = np.array([False] * (S - 1) + [True])
    smem = rng.standard_normal((S, 480)).astype(np.float32)
    ref = ps.postfilter_synthesis(
        ps.permute_spectrum(X), ps.permute_spectrum(P), Ex, Ep, Exp,
        jnp.asarray(g), jnp.asarray(lastg), jnp.asarray(Ex_cur),
        jnp.asarray(silence), jnp.asarray(smem), interpret=True)
    before = spec.postfilter_synthesis.launches
    got = spec.postfilter_synthesis(
        *(torch.from_numpy(np.array(a)) for a in (
            _ri(X), _ri(P), Ex, Ep, Exp, g, lastg, Ex_cur, silence, smem)))
    assert spec.postfilter_synthesis.launches == before
    out_ref, smem_ref, lastg_ref = (np.asarray(a) for a in ref)
    scale = np.abs(out_ref).max()
    np.testing.assert_allclose(got[0].numpy(), out_ref, atol=1e-4 * scale)
    np.testing.assert_allclose(got[1].numpy(), smem_ref, atol=1e-4 * scale)
    np.testing.assert_allclose(got[2].numpy(), lastg_ref, atol=2e-5, rtol=0)
    # the silent stream keeps its lastg and synthesises its unfiltered X
    np.testing.assert_array_equal(got[2][-1].numpy(), lastg[-1])
