"""The port's public API on CPU: model loading and StreamDenoiser."""

import numpy as np
import pytest
import torch

from rnnoise_tpu_torch import FRAME_SIZE, RNNoise, StreamDenoiser
from rnnoise_tpu_torch.api import get_frame_size
from rnnoise_tpu_torch.denoise import init_state, process_frames
from tests.torch_helpers import (MODEL_BLOB, make_signal,  # noqa: F401
                                 no_jax_compile_cache)


@pytest.fixture(scope="module")
def model():
    return RNNoise.from_filename(MODEL_BLOB, device="cpu")


def test_loaders_agree(model):
    with open(MODEL_BLOB, "rb") as f:
        blob = f.read()
    a = RNNoise.from_buffer(blob, device="cpu")
    with open(MODEL_BLOB, "rb") as f:
        b = RNNoise.from_file(f, device="cpu")
    assert model.config == a.config == b.config
    assert model.config.gru_size == 384 and model.device.type == "cpu"
    for x, y in zip(a.params, b.params):
        assert torch.equal(x.weights_f32, y.weights_f32)
    assert get_frame_size() == FRAME_SIZE == StreamDenoiser.frame_size


def test_stream_denoiser_frame_and_chunk(model):
    S, T = 2, 5
    rng = np.random.default_rng(1)
    pcm = np.round(np.stack([make_signal(rng, T) for _ in range(S)]))
    pcm = pcm.reshape(S, T, FRAME_SIZE).astype(np.float32)
    d = StreamDenoiser(S, model)
    assert d.device.type == "cpu"
    outs = [d.process_frame(pcm[:, t])[0] for t in range(T)]
    d.reset()
    out_c, vad_c = d.process_chunk(pcm)
    assert out_c.shape == (S, T, FRAME_SIZE) and vad_c.shape == (S, T)
    np.testing.assert_allclose(np.stack(outs, axis=1), out_c, atol=0.5)
    _, ref, _ = process_frames(model.params, init_state(S, device="cpu"),
                               torch.from_numpy(pcm))
    np.testing.assert_array_equal(out_c, ref.numpy())
    one = StreamDenoiser(1, model)
    out1, vad1 = one.process_frame(pcm[0, 0])
    assert out1.shape == (1, FRAME_SIZE) and vad1.shape == (1,)
