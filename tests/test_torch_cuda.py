"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test decides inside itself whether a card and nvcc
are present and skips otherwise.  ``python3 chip_smoke.py`` runs the same
comparisons at the main path's full shapes.  This file imports neither JAX
nor the shared helpers, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import os
import shutil

import numpy as np
import pytest
import torch

from rnnoise_tpu_torch import kernels
from rnnoise_tpu_torch.api import RNNoise
from rnnoise_tpu_torch.config import CONFIGURATIONS, DEFAULT_RUNTIME, resolve_device
from rnnoise_tpu_torch.denoise import init_state, process_frames_tm_i16
from rnnoise_tpu_torch.dsp import cuda_analysis, cuda_frame, cuda_xcorr
from rnnoise_tpu_torch.dsp import cuda_spectral as spec
from rnnoise_tpu_torch.dsp import pitch
from rnnoise_tpu_torch.dsp.transform import compute_band_corr, compute_band_energy
from rnnoise_tpu_torch.models.rnn import ModelParams, RNNState
from rnnoise_tpu_torch.nn import cuda_rnn
from rnnoise_tpu_torch.runtime.engine import StreamingEngine
from rnnoise_tpu_torch.weights.loader import load_model_file

pytestmark = pytest.mark.cuda
MODEL_BLOB = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models", "rnnoise_synth_v1.blob")


def _signal(rng, S, T):
    """int16 [T, S, 480]: harmonic tones with noise and a near-silent
    stretch in stream 0."""
    t = np.arange(T * 480) / 48000.0
    sig = np.zeros((S, T * 480))
    for s in range(S):
        f0 = rng.uniform(90, 240)
        for k in range(1, 10):
            sig[s] += np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6.28)) / k
    sig = 3000 * (sig + 0.1 * rng.standard_normal(sig.shape))
    sig[0, T * 160:T * 160 + 4800] *= 1e-4
    pcm = np.clip(np.round(sig), -32768, 32767).astype(np.int16)
    return pcm.reshape(S, T, 480).transpose(1, 0, 2).copy()


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    try:
        kernels.nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return resolve_device("cuda")


def _rel(a, b):
    """max over rows of max|a - b| / max|b| (a row of zeros against itself
    gives 0)."""
    return float(((a - b).abs().amax(1) / b.abs().amax(1).clamp(min=1e-30)).max())


def test_rnn_step_kernel(dev):
    params = load_model_file(MODEL_BLOB, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    S = 37                                    # a ragged last block
    feats = torch.randn(S, 65, generator=g, device=dev)
    st = RNNState(*(torch.tanh(torch.randn(S, w, generator=g, device=dev))
                    for w in (130, 256, 384, 384, 384)))
    sil = torch.arange(S, device=dev) % 5 == 0
    before = cuda_rnn.compute_rnn_step.launches
    a = cuda_rnn.compute_rnn_step(params, st, feats, sil)
    b = cuda_rnn.compute_rnn_plain(params, st, feats, sil)
    assert cuda_rnn.compute_rnn_step.launches == before + 1
    for x, y in zip((*a[0], a[1], a[2]), (*b[0], b[1], b[2])):
        assert float((x - y).abs().max()) <= 1e-5


def test_spectral_kernels(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    S = 13
    mem, x = (3000 * torch.randn(S, 480, generator=g, device=dev) for _ in range(2))
    pbuf = 3000 * torch.randn(S, 1728, generator=g, device=dev)
    start = torch.randint(0, 709, (S,), generator=g, device=dev, dtype=torch.int32)
    kX, kP = spec.forward_spectral(mem, x, pbuf, start)
    pX, pP = spec.forward_spectral_plain(mem, x, pbuf, start)
    assert _rel(kX, pX) <= 1e-4 and _rel(kP, pP) <= 1e-4
    assert _rel(spec.inverse_spectral(kX), spec.inverse_spectral_plain(kX)) <= 1e-4


def test_lag_corr_table_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    ds = 300 * torch.randn(13, 864, generator=g, device=dev)
    before = cuda_xcorr.lag_corr_table_kernel.launches
    got = cuda_xcorr.lag_corr_table_kernel(ds)
    assert cuda_xcorr.lag_corr_table_kernel.launches == before + 1
    assert _rel(got, cuda_xcorr.lag_corr_table_plain(ds)) <= 1e-6


@pytest.mark.parametrize("S", [1, 13, 37])
def test_forward_spectral_kernel_ragged(dev, S):
    """The FFT kernel at ragged S (a block of 2 streams with its tail
    masked), stream 0 near-silent, the window starts at both ends; bins 0,
    240 and 480 on their own."""
    g = torch.Generator(device=dev).manual_seed(20 + S)
    mem, x = (3000 * torch.randn(S, 480, generator=g, device=dev) for _ in range(2))
    pbuf = 3000 * torch.randn(S, 1728, generator=g, device=dev)
    mem[0], x[0], pbuf[0] = 1e-4 * mem[0], 1e-4 * x[0], 1e-4 * pbuf[0]
    start = torch.randint(0, 769, (S,), generator=g, device=dev, dtype=torch.int32)
    start[0] = 768
    start[-1] = 0
    before = spec.forward_spectral.launches
    kX, kP = spec.forward_spectral(mem, x, pbuf, start)
    assert spec.forward_spectral.launches == before + 1
    pX, pP = spec.forward_spectral_plain(mem, x, pbuf, start)
    for k, p in ((kX, pX), (kP, pP)):
        assert _rel(k, p) <= 1e-4
        top = p.abs().amax(1)
        for b in (0, 240, 480):
            cols = [b, 481 + b]
            assert float(((k[:, cols] - p[:, cols]).abs().amax(1) / top).max()) <= 1e-4


@pytest.mark.parametrize("S", [1, 13, 37])
def test_lag_corr_table_kernel_ragged(dev, S):
    """The tiled lag table at ragged S (blocks of 2 streams), stream 0
    near-silent."""
    g = torch.Generator(device=dev).manual_seed(30 + S)
    ds = 300 * torch.randn(S, 864, generator=g, device=dev)
    ds[0] *= 1e-4
    got = cuda_xcorr.lag_corr_table_kernel(ds)
    assert _rel(got, cuda_xcorr.lag_corr_table_plain(ds)) <= 1e-6


@pytest.mark.parametrize("S", [1, 13, 37])
def test_analysis_spectra_equal_forward_spectral(dev, S):
    """At odd S, with a near-silent stream: the analysis' X and P are the
    forward-spectrum kernel's bit for bit at the resolved period."""
    pcm = torch.from_numpy(_signal(np.random.default_rng(40 + S), S, 8)).to(dev).float()
    pbuf = pcm[-4:].transpose(0, 1).reshape(S, -1)[:, -1728:].contiguous()
    mem, x = pbuf[:, -960:-480], pbuf[:, -480:]
    ds = pitch.pitch_downsample(pbuf)
    bp0, bp1 = pitch.coarse_search(ds)
    prev_p = torch.full((S,), 200, device=dev, dtype=torch.int32)
    kX, kP, kT, _ = cuda_analysis.analysis_spectral(
        mem, x, pbuf, ds, bp0, bp1, prev_p, torch.full((S,), 0.5, device=dev))
    fX, fP = spec.forward_spectral(mem, x, pbuf, 1728 - 960 - kT)
    assert torch.equal(kX, fX) and torch.equal(kP, fP)


def test_analysis_kernel(dev):
    """Inputs from a real decimation and coarse search, so the ladder takes
    real branches; X and P equal the forward-spectrum kernel's at the
    resolved period."""
    S = 16
    pcm = torch.from_numpy(_signal(np.random.default_rng(3), S, 8)).to(dev).float()
    pbuf = pcm[-4:].transpose(0, 1).reshape(S, -1)[:, -1728:].contiguous()
    mem, x = pbuf[:, -960:-480], pbuf[:, -480:]
    ds = pitch.pitch_downsample(pbuf)
    bp0, bp1 = pitch.coarse_search(ds)
    prev_p = torch.randint(60, 700, (S,), device=dev, dtype=torch.int32)
    prev_g = torch.rand(S, device=dev)
    args = (mem, x, pbuf, ds, bp0, bp1, prev_p, prev_g)
    before = cuda_analysis.analysis_spectral.launches
    kX, kP, kT, kg = cuda_analysis.analysis_spectral(*args)
    assert cuda_analysis.analysis_spectral.launches == before + 1
    pX, pP, pT, pg = cuda_analysis.analysis_spectral_plain(*args)
    same = kT == pT
    assert int((~same).sum()) <= 2
    assert float((kg - pg)[same].abs().max()) <= 1e-6
    assert _rel(kX[same], pX[same]) <= 1e-4 and _rel(kP[same], pP[same]) <= 1e-4
    fX, fP = spec.forward_spectral(mem, x, pbuf, 1728 - 960 - kT)
    assert torch.equal(kX, fX) and torch.equal(kP, fP)


def _analysis_args(dev, S, seed, fade=False):
    """The analysis' inputs from a real decimation and coarse search of
    generated PCM; with ``fade``, every stream is loud over the pitch
    buffer's first 600 samples and near-silent after (ds loud at its start,
    its last 480 values, x, near-silent)."""
    rng = np.random.default_rng(seed)
    pcm = torch.from_numpy(_signal(rng, S, 8)).to(dev).float()
    pbuf = pcm[-4:].transpose(0, 1).reshape(S, -1)[:, -1728:].contiguous()
    if fade:
        pbuf[:, 600:] *= 1e-4
    mem, x = pbuf[:, -960:-480], pbuf[:, -480:]
    ds = pitch.pitch_downsample(pbuf)
    bp0, bp1 = pitch.coarse_search(ds)
    prev_p = torch.from_numpy(rng.integers(60, 700, S).astype(np.int32)).to(dev)
    prev_g = torch.from_numpy(rng.random(S).astype(np.float32)).to(dev)
    return mem, x, pbuf, ds, bp0, bp1, prev_p, prev_g


@pytest.mark.parametrize("S,fade", [(1, False), (7, False), (37, False), (1024, False),
                                    (37, True)])
def test_analysis_kernel_ragged(dev, S, fade):
    """At ragged S (blocks of 2 streams, the last one short) and at the main
    path's S=1024, and with a loud start and a near-silent end: the
    tolerances of test_analysis_kernel, X and P the forward kernel's bit for
    bit."""
    args = _analysis_args(dev, S, 60 + S, fade)
    kX, kP, kT, kg = cuda_analysis.analysis_spectral(*args)
    pX, pP, pT, pg = cuda_analysis.analysis_spectral_plain(*args)
    same = kT == pT
    assert int((~same).sum()) <= 2
    assert float((kg - pg)[same].abs().max()) <= 1e-6
    assert _rel(kX[same], pX[same]) <= 1e-4 and _rel(kP[same], pP[same]) <= 1e-4
    fX, fP = spec.forward_spectral(*args[:3], 1728 - 960 - kT)
    assert torch.equal(kX, fX) and torch.equal(kP, fP)


def _ulps(a, b):
    def key(v):
        i = v.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (key(a) - key(b)).abs()


@pytest.mark.parametrize("S,fade", [(1, False), (7, False), (37, False), (37, True)])
def test_lag_energy_table_kernel(dev, S, fade):
    """The analysis' lag table and energies on the f64 tensor cores against
    their plain versions (f64 convolutions rounded once): the lag table's
    tolerance; each energy, a sum of squares, within an ulp."""
    ds = _analysis_args(dev, S, 80 + S, fade)[3]
    before = cuda_analysis.lag_energy_table.launches
    bx, yy = cuda_analysis.lag_energy_table(ds)
    assert cuda_analysis.lag_energy_table.launches == before + 1
    pbx, pyy = cuda_analysis.lag_energy_table_plain(ds)
    assert _rel(bx, pbx) <= 1e-6 and _rel(yy, pyy) <= 1e-6
    assert int(_ulps(yy, pyy).max()) <= 1


def test_postfilter_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    S = 9
    x = 3000 * torch.randn(S, 960, generator=g, device=dev)
    p = 0.7 * x + 500 * torch.randn(S, 960, generator=g, device=dev)
    X, P = spec.forward_spectral(x[:, :480], x[:, 480:], torch.cat(
        [p, p[:, :768]], 1), torch.zeros(S, dtype=torch.int32, device=dev))
    Ex, Ep = compute_band_energy(X), compute_band_energy(P)
    Exp = compute_band_corr(X, P) / torch.sqrt(0.001 + Ex * Ep)
    args = (X, P, Ex, Ep, Exp,
            0.05 + 0.95 * torch.rand(S, 32, generator=g, device=dev),
            torch.rand(S, 32, generator=g, device=dev),
            Ex * (0.5 + 1.5 * torch.rand(S, 1, generator=g, device=dev)),
            torch.arange(S, device=dev) % 4 == 0,
            torch.randn(S, 480, generator=g, device=dev))
    before = spec.postfilter_synthesis.launches
    k = spec.postfilter_synthesis(*args)
    assert spec.postfilter_synthesis.launches == before + 1
    pl = spec.postfilter_synthesis_plain(*args)
    assert _rel(k[0], pl[0]) <= 1e-4 and _rel(k[1], pl[1]) <= 1e-4
    assert float((k[2] - pl[2]).abs().max()) <= 2e-5


def test_monokernel(dev):
    """The whole-chunk kernel against its plain version from a warm state,
    at S=13 (a block of 8 with its tail masked): one launch, the caller's
    state untouched, PCM within 4 LSB, VAD 2e-3, lastg 1e-3, T0 in all but 2
    streams."""
    params = load_model_file(MODEL_BLOB, device=dev)
    S, T = 13, 12
    pcm = torch.from_numpy(_signal(np.random.default_rng(6), S, 4 + T)).to(dev)
    st, _, _ = process_frames_tm_i16(params, init_state(S, device=dev), pcm[:4],
                                     CONFIGURATIONS["fused"])
    before = cuda_frame.process_chunk_monokernel.launches
    saved = st.pitch_buf.clone()
    kst, ko, kv = cuda_frame.process_chunk_monokernel(params, st, pcm[4:])
    assert cuda_frame.process_chunk_monokernel.launches == before + 1
    assert torch.equal(st.pitch_buf, saved)
    pst, po, pv = cuda_frame.process_chunk_monokernel_plain(params, st, pcm[4:])
    assert int((ko.int() - po.int()).abs().max()) <= 4
    assert float((kv - pv).abs().max()) <= 2e-3
    assert float((kst.lastg - pst.lastg).abs().max()) <= 1e-3
    assert int((kst.last_period != pst.last_period).sum()) <= 2


@pytest.mark.parametrize("T", [1, 2, 3])
@pytest.mark.parametrize("S", [1, 7, 9, 37])
def test_monokernel_ragged(dev, S, T):
    """The whole-chunk kernel at ragged S (the last block has fewer than 8
    streams, every span masks its empty slots) and T of both parities (the
    network's state alternates between the output and a scratch copy),
    against its plain version from a warm state: the tolerances of
    chip_smoke.py phase 2, the caller's state untouched."""
    params = load_model_file(MODEL_BLOB, device=dev)
    pcm = torch.from_numpy(_signal(np.random.default_rng(80 + S), S, 4 + T)).to(dev)
    st, _, _ = process_frames_tm_i16(params, init_state(S, device=dev), pcm[:4],
                                     CONFIGURATIONS["fused"])
    saved = [t.clone() for t in (st.pitch_buf, st.synthesis_mem, st.lastg, *st.rnn)]
    kst, ko, kv = cuda_frame.process_chunk_monokernel(params, st, pcm[4:])
    assert all(torch.equal(a, b) for a, b in
               zip(saved, (st.pitch_buf, st.synthesis_mem, st.lastg, *st.rnn)))
    pst, po, pv = cuda_frame.process_chunk_monokernel_plain(params, st, pcm[4:])
    assert int((ko.int() - po.int()).abs().max()) <= 4
    assert float((kv - pv).abs().max()) <= 2e-3
    assert float((kst.lastg - pst.lastg).abs().max()) <= 1e-3
    assert int((kst.last_period != pst.last_period).sum()) <= 2


@pytest.mark.parametrize("config", sorted(CONFIGURATIONS))
def test_main_path_kernels_vs_plain(dev, config):
    params = load_model_file(MODEL_BLOB, device=dev)
    rt = CONFIGURATIONS[config]
    S, T = 4, 150
    pcm = torch.from_numpy(_signal(np.random.default_rng(42), S, T)).to(dev)
    _, ok, vk = process_frames_tm_i16(params, init_state(S, device=dev), pcm, rt)
    _, op, vp = process_frames_tm_i16(params, init_state(S, device=dev), pcm, rt,
                                      plain=True)
    assert int((ok.int() - op.int()).abs().max()) <= 4
    assert float((vk - vp).abs().max()) <= 2e-3


RAGGED = [1, 7, 9, 1023]


@pytest.mark.parametrize("S", RAGGED)
def test_inverse_spectral_kernel_ragged(dev, S):
    """The inverse FFT at ragged S (blocks of 4 streams, the tail masked)
    against its plain version within 1e-4 of each row's maximum; a silent
    spectrum gives exact zeros, and the imaginary parts of bins 0 and 480
    are not read."""
    g = torch.Generator(device=dev).manual_seed(50 + S)
    x = 3000 * torch.randn(S, 960, generator=g, device=dev)
    Y, _ = spec.forward_spectral(x[:, :480], x[:, 480:], torch.cat(
        [x, x[:, :768]], 1), torch.zeros(S, dtype=torch.int32, device=dev))
    Y[0] = 0.0
    before = spec.inverse_spectral.launches
    out = spec.inverse_spectral(Y)
    assert spec.inverse_spectral.launches == before + 1
    assert not out[0].any()
    if S > 1:
        assert _rel(out[1:], spec.inverse_spectral_plain(Y)[1:]) <= 1e-4
        Y2 = Y.clone()
        Y2[:, 481], Y2[:, -1] = 5.0, -7.0
        assert torch.equal(spec.inverse_spectral(Y2)[1:], out[1:])


@pytest.mark.parametrize("S", RAGGED)
def test_postfilter_kernel_ragged(dev, S):
    """The post-filter (4 streams a block, the inverse a butterfly a thread)
    at ragged S, every 3rd stream silent, against its plain version (the
    tolerances of chip_smoke.py phase 2)."""
    g = torch.Generator(device=dev).manual_seed(60 + S)
    x = 3000 * torch.randn(S, 960, generator=g, device=dev)
    p = 0.7 * x + 500 * torch.randn(S, 960, generator=g, device=dev)
    X, P = spec.forward_spectral(x[:, :480], x[:, 480:], torch.cat(
        [p, p[:, :768]], 1), torch.zeros(S, dtype=torch.int32, device=dev))
    Ex, Ep = compute_band_energy(X), compute_band_energy(P)
    Exp = compute_band_corr(X, P) / torch.sqrt(0.001 + Ex * Ep)
    args = (X, P, Ex, Ep, Exp,
            0.05 + 0.95 * torch.rand(S, 32, generator=g, device=dev),
            torch.rand(S, 32, generator=g, device=dev),
            Ex * (0.5 + 1.5 * torch.rand(S, 1, generator=g, device=dev)),
            torch.arange(S, device=dev) % 3 == 0,
            torch.randn(S, 480, generator=g, device=dev))
    k = spec.postfilter_synthesis(*args)
    pl = spec.postfilter_synthesis_plain(*args)
    assert _rel(k[0], pl[0]) <= 1e-4 and _rel(k[1], pl[1]) <= 1e-4
    assert float((k[2] - pl[2]).abs().max()) <= 2e-5


@pytest.mark.parametrize("S", RAGGED)
def test_rnn_step_kernel_bitwise_ragged(dev, S):
    """The block-sparse RNN step at ragged S (blocks of 8 streams), every
    5th stream silent: bit for bit its plain version."""
    params = load_model_file(MODEL_BLOB, device=dev)
    g = torch.Generator(device=dev).manual_seed(70 + S)
    feats = torch.randn(S, 65, generator=g, device=dev)
    st = RNNState(*(torch.tanh(torch.randn(S, w, generator=g, device=dev))
                    for w in (130, 256, 384, 384, 384)))
    sil = torch.arange(S, device=dev) % 5 == 0
    a = cuda_rnn.compute_rnn_step(params, st, feats, sil)
    b = cuda_rnn.compute_rnn_plain(params, st, feats, sil)
    for x, y in zip((*a[0], a[1], a[2]), (*b[0], b[1], b[2])):
        assert torch.equal(x, y)


def test_wrappers_reject_bad_arguments(dev):
    with pytest.raises(ValueError):
        spec.inverse_spectral(torch.zeros(3, 900, device=dev))
    assert shutil.which("nvidia-smi") is not None


@pytest.mark.parametrize("model", ["none", "float-only"])
def test_engine_without_int8_model_ticks_on_the_default_runtime(dev, model):
    """StreamingEngine on the default (mono) runtime without a model, or
    with a float-only one, ticks on the card through the fused
    configuration's kernels (the monokernel runs an int8 network), and its
    output equals an engine's on the fused configuration bit for bit."""
    rn = None
    if model == "float-only":
        params = load_model_file(MODEL_BLOB, device=dev)
        rn = RNNoise(ModelParams(*(lp._replace(weights_q=None, scale=None)
                                   for lp in params)), device=dev)
    S, T = 16, 8
    pcm = _signal(np.random.default_rng(2), S, 3 * T)
    outs = {}
    for name, rt in (("default", DEFAULT_RUNTIME), ("fused", CONFIGURATIONS["fused"])):
        eng = StreamingEngine(S, rn, chunk_frames=T, runtime=rt, device=dev)
        slots = [eng.attach() for _ in range(S)]
        for s in slots:
            eng.push(s, pcm[:, s].reshape(-1))
        mono, analysis = (cuda_frame.process_chunk_monokernel.launches,
                          cuda_analysis.analysis_spectral.launches)
        assert [eng.tick() for _ in range(3)] == [S] * 3
        assert cuda_frame.process_chunk_monokernel.launches == mono
        assert cuda_analysis.analysis_spectral.launches == analysis + 3 * T
        outs[name] = np.stack([eng.pull(s, 3 * T * 480) for s in slots])
    assert outs["default"].shape == (S, 3 * T * 480)
    assert np.abs(outs["default"]).max() > 0
    np.testing.assert_array_equal(outs["default"], outs["fused"])
