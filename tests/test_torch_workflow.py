"""The port's whole training workflow on CPU: synthetic corpora ->
tools.dump_features -> training (a small model) -> quantised export ->
the port's loader and int16 entry point, held to the checks of
tests/test_workflow_e2e.py (the JAX package's workflow test)."""

import numpy as np
import pytest
import torch

from rnnoise_tpu_torch.api import RNNoise
from rnnoise_tpu_torch.config import CONFIGURATIONS, ModelConfig, RuntimeConfig
from rnnoise_tpu_torch.denoise import init_state, process_frames_tm_i16
from rnnoise_tpu_torch.dsp import cuda_frame
from rnnoise_tpu_torch.models.rnn import compute_rnn, init_rnn_state
from tests.conftest import speechlike
from tests.torch_helpers import no_jax_compile_cache  # noqa: F401

SEQ_LEN = 200
SMALL = ModelConfig(cond_size=32, gru_size=64)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The corpora of tests/test_workflow_e2e.py: gated harmonic speech,
    white noise and clicks, 30 s each."""
    d = tmp_path_factory.mktemp("corpora")
    rng = np.random.default_rng(0)
    n = 48000 * 30
    speech = np.concatenate([
        speechlike(rng, n // 3, f0=f0, noise=0.02) for f0 in (100, 150, 220)])
    for i in range(0, len(speech), 48000):
        speech[i + 24000:i + 48000] *= 0.001
    noise = 2000 * rng.standard_normal(n)
    fg = np.zeros(n)
    fg[rng.integers(0, n, 2000)] = 20000.0
    for name, sig in (("speech", speech), ("noise", noise), ("fg", fg)):
        np.clip(sig, -32767, 32767).astype("<i2").tofile(d / f"{name}.pcm")
    return d


@pytest.fixture(scope="module")
def features_file(corpora, tmp_path_factory):
    from rnnoise_tpu_torch.tools.dump_features import dump_features
    out = tmp_path_factory.mktemp("feat") / "features.f32"
    dump_features(str(corpora / "speech.pcm"), str(corpora / "noise.pcm"),
                  str(corpora / "fg.pcm"), str(out), count=24, batch=8,
                  seed=1, seq_len=SEQ_LEN, device="cpu")
    return str(out)


def test_features_file_sane(features_file):
    data = np.fromfile(features_file, dtype=np.float32).reshape(-1, 98)
    assert data.shape[0] == 24 * SEQ_LEN
    feats, gains, vad = data[:, :65], data[:, 65:97], data[:, 97]
    assert np.isfinite(feats).all()
    ok = (gains == -1) | ((gains >= 0) & (gains <= 1 + 1e-6))
    assert ok.all()
    assert set(np.unique(vad)).issubset({0.0, 1.0})
    assert 0.05 < vad.mean() < 0.95
    assert (gains == -1).mean() < 0.9


def test_train_export_infer_roundtrip(features_file):
    """Training lowers the held-out loss below 0.7x its start; the exported
    int8 model's gains are within 0.05 of its float weights' over the same
    features; streaming inference correlates > 0.95 with the training
    forward once the cold start has washed out; and the int16 entry point
    serves the exported model."""
    from rnnoise_tpu_torch.training.data import RNNoiseDataset
    from rnnoise_tpu_torch.training.export import export_blob
    from rnnoise_tpu_torch.training.loss import rnnoise_loss
    from rnnoise_tpu_torch.training.model import forward, init_params
    from rnnoise_tpu_torch.training.train import make_optimizer, make_train_step

    ds = RNNoiseDataset(features_file, SEQ_LEN)
    assert len(ds) == 24
    batch = tuple(map(torch.from_numpy, ds.batch(np.arange(16))))
    ef, eg, ev = map(torch.from_numpy, ds.batch(np.arange(16, 24)))  # held out

    params = init_params(torch.Generator().manual_seed(0), SMALL, "cpu")
    opt, sched = make_optimizer(params, lr=3e-3)
    # without the recompute (a memory option, held to the JAX package's
    # forward and gradients in test_torch_training.py), to keep the CPU time
    step_fn = make_train_step(opt, sched, sparse=False, remat=False)

    @torch.no_grad()
    def eval_loss():
        pg, pv, _ = forward(params, ef)
        return float(rnnoise_loss(pg, pv, eg[:, 3:-1], ev[:, 3:-1])[0])

    loss0 = eval_loss()
    states = tuple(torch.zeros(16, SMALL.gru_size) for _ in range(3))
    for i in range(150):
        states, metrics = step_fn(params, states, batch, i)
    trained = eval_loss()
    assert trained < 0.7 * loss0, (loss0, trained)

    blob = export_blob(params, quantize=True)
    model = RNNoise.from_buffer(blob, device="cpu")
    assert model.config == SMALL
    with torch.no_grad():
        tg, _, _ = forward(params, ef)

    outs = {}
    for qmode in (False, True):
        rt = RuntimeConfig(quantized=qmode, approx_act=False)
        st = init_rnn_state(8, SMALL, "cpu")
        gs = []
        for t in range(SEQ_LEN):
            st, g, _ = compute_rnn(model.params, st, ef[:, t], rt)
            gs.append(g.numpy())
        outs[qmode] = np.stack(gs, axis=1)        # [B, T, 32]
    qerr = np.abs(outs[True] - outs[False]).max()
    assert qerr < 0.05, qerr

    half = SEQ_LEN // 2
    a = outs[False][:, half + 4:, :].reshape(-1)
    b = tg.numpy()[:, half:, :].reshape(-1)
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.95, corr
    assert np.abs(a - b).mean() < 0.05

    # the int16 entry point on the default runtime: the whole-chunk
    # kernel's plain version on CPU tensors
    rng = np.random.default_rng(3)
    pcm = np.stack([speechlike(rng, 20 * 480) + 500 * rng.standard_normal(20 * 480)
                    for _ in range(4)])
    pcm = torch.from_numpy(np.clip(np.round(pcm), -32768, 32767).astype(np.int16)
                           .reshape(4, 20, 480).transpose(1, 0, 2).copy())
    st, out, vad = process_frames_tm_i16(model.params, init_state(4, SMALL, "cpu"),
                                         pcm)
    want = cuda_frame.process_chunk_monokernel_plain(
        model.params, init_state(4, SMALL, "cpu"), pcm, CONFIGURATIONS["mono"])
    assert out.dtype == torch.int16 and out.shape == (20, 4, 480)
    assert torch.equal(out, want[1]) and torch.equal(vad, want[2])
    assert bool(torch.isfinite(vad).all()) and 0 < int(out.abs().max())
