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
from rnnoise_tpu_torch.config import resolve_device
from rnnoise_tpu_torch.denoise import init_state, process_frames_tm_i16
from rnnoise_tpu_torch.dsp import cuda_spectral as spec
from rnnoise_tpu_torch.models.rnn import RNNState
from rnnoise_tpu_torch.nn import cuda_rnn
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
    return float(((a - b).abs().amax(1) / b.abs().amax(1)).max())


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


def test_main_path_kernels_vs_plain(dev):
    params = load_model_file(MODEL_BLOB, device=dev)
    S, T = 4, 150
    pcm = torch.from_numpy(_signal(np.random.default_rng(42), S, T)).to(dev)
    _, ok, vk = process_frames_tm_i16(params, init_state(S, device=dev), pcm)
    _, op, vp = process_frames_tm_i16(params, init_state(S, device=dev), pcm,
                                      plain=True)
    assert int((ok.int() - op.int()).abs().max()) <= 4
    assert float((vk - vp).abs().max()) <= 2e-3


def test_wrappers_reject_bad_arguments(dev):
    with pytest.raises(ValueError):
        spec.inverse_spectral(torch.zeros(3, 900, device=dev))
    assert shutil.which("nvidia-smi") is not None
