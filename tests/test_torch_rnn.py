"""The RNN step: the port's layers and compute_rnn (the plain version of the
RNN-step kernel) against rnnoise_tpu on CPU, in both numerics modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnoise_tpu.config import RuntimeConfig as JRuntime
from rnnoise_tpu.models.rnn import RNNState as JState
from rnnoise_tpu.models.rnn import compute_rnn as jrnn
from rnnoise_tpu.nn import layers as jl
from rnnoise_tpu_torch.config import RuntimeConfig
from rnnoise_tpu_torch.models.rnn import RNNState, compute_rnn
from rnnoise_tpu_torch.nn import cuda_rnn
from rnnoise_tpu_torch.nn import layers as tl
from rnnoise_tpu_torch.weights.loader import load_model_file
from tests.torch_helpers import (MODEL_BLOB, jax_params,  # noqa: F401
                                 no_jax_compile_cache, random_model_arrays,
                                 torch_params)


def test_activations_match_reference():
    x = np.linspace(-12, 12, 20001, dtype=np.float32)
    xt = torch.from_numpy(x)
    for jf, tf in ((jl.tanh_approx, tl.tanh_approx),
                   (jl.sigmoid_approx, tl.sigmoid_approx)):
        ref = np.asarray(jax.jit(jf)(x))
        # XLA contracts the rational's multiply-adds into FMAs; the port
        # rounds each step: a few ulps of 1.0 apart at most
        np.testing.assert_allclose(tf(xt).numpy(), ref, rtol=0, atol=4e-7)
    q = tl.quantize_activations(xt / 8).numpy()
    ref = np.asarray(jl.quantize_activations(jnp.asarray(x / 8)))
    assert q.dtype == np.int8
    # floor(.5 + 127 x): the two may round the product differently only at
    # exact half-steps
    assert (q != ref).mean() < 1e-3 and np.abs(q.astype(int) - ref).max() <= 1


def _inputs(rng, S, F, C, N):
    feats = rng.standard_normal((S, F)).astype(np.float32)
    st = [rng.standard_normal((S, 2 * F)).astype(np.float32),
          np.tanh(rng.standard_normal((S, 2 * C))).astype(np.float32)] + \
         [np.tanh(rng.standard_normal((S, N))).astype(np.float32)
          for _ in range(3)]
    sil = rng.random(S) < 0.25
    return feats, st, sil


@pytest.mark.parametrize("quantized,atol", [(True, 1e-5), (False, 1e-3)])
def test_compute_rnn_matches_reference(quantized, atol):
    """Five chained steps of a small random model, with silent rows."""
    rng = np.random.default_rng(7)
    arrays = random_model_arrays(rng)
    jp, tp = jax_params(arrays), torch_params(arrays)
    S, F, C, N = 16, 65, 16, 32
    feats, st, sil = _inputs(rng, S, F, C, N)
    jst, tst = JState(*map(jnp.asarray, st)), RNNState(*map(torch.from_numpy, st))
    jstep = jax.jit(lambda s, f, m: jrnn(jp, s, f, JRuntime(quantized=quantized),
                                         silence=m))
    rt = RuntimeConfig(quantized=quantized)
    for step in range(5):
        f = feats * (1.0 + 0.3 * step)
        jst, jg, jv = jstep(jst, jnp.asarray(f), jnp.asarray(sil))
        tst, tg, tv = compute_rnn(tp, tst, torch.from_numpy(f), rt,
                                  silence=torch.from_numpy(sil))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=atol, rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=atol, rtol=0)
        for a, b in zip(jst, tst):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol, rtol=0)
    # silent rows kept their state and report VAD 0
    np.testing.assert_array_equal(tst.gru3.numpy()[sil], st[4][sil])
    np.testing.assert_array_equal(tv.numpy()[sil], 0.0)


def test_full_model_step_matches_reference():
    """The kernel's plain version on the full rnnoise_synth_v1 model."""
    from rnnoise_tpu.weights.loader import load_model_file as jload
    jp = jload(MODEL_BLOB)
    tp = load_model_file(MODEL_BLOB, device="cpu")
    rng = np.random.default_rng(11)
    feats, st, sil = _inputs(rng, 8, 65, 128, 384)
    jst, jg, jv = jax.jit(lambda s, f, m: jrnn(jp, s, f, silence=m))(
        JState(*map(jnp.asarray, st)), jnp.asarray(feats), jnp.asarray(sil))
    tst, tg, tv = cuda_rnn.compute_rnn_plain(
        tp, RNNState(*map(torch.from_numpy, st)), torch.from_numpy(feats),
        torch.from_numpy(sil))
    for a, b in zip((*jst, jg, jv), (*tst, tg, tv)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=0)


def test_step_wrapper_uses_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    tp = torch_params(random_model_arrays(rng))
    feats, st, sil = _inputs(rng, 6, 65, 16, 32)
    args = (tp, RNNState(*map(torch.from_numpy, st)), torch.from_numpy(feats),
            torch.from_numpy(sil))
    before = cuda_rnn.compute_rnn_step.launches
    a = cuda_rnn.compute_rnn_step(*args)
    b = cuda_rnn.compute_rnn_plain(*args)
    assert cuda_rnn.compute_rnn_step.launches == before
    for x, y in zip((*a[0], a[1], a[2]), (*b[0], b[1], b[2])):
        assert torch.equal(x, y)


def test_packed_weights_layout():
    """Kernel layout: word [w, j] holds rows 4w..4w+3 of column j, byte t =
    row 4w+t; heads are transposed with the VAD row last."""
    rng = np.random.default_rng(2)
    arrays = random_model_arrays(rng)
    tp = torch_params(arrays)
    pk = cuda_rnn.pack_params(tp)
    wq = arrays["gru2_recurrent"]["weights_q"]
    words = pk.gru_rec_w[1].numpy()
    unpacked = words.view(np.int8).reshape(words.shape[0], words.shape[1], 4)
    np.testing.assert_array_equal(
        unpacked.transpose(0, 2, 1).reshape(wq.shape), wq)
    np.testing.assert_array_equal(pk.heads_w.numpy()[-1],
                                  arrays["vad_dense"]["weights_f32"][:, 0])
    np.testing.assert_array_equal(pk.heads_w.numpy()[:-1],
                                  arrays["dense_out"]["weights_f32"].T)
    with pytest.raises(ValueError):
        cuda_rnn.pack_int8(torch.zeros((6, 8), dtype=torch.int8))


def test_float_path_has_no_cuda_kernel():
    """Only the default numerics have a CUDA kernel; the others run on CPU
    tensors only and say so for CUDA ones instead of falling back."""
    class OnCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    tp = torch_params(random_model_arrays(np.random.default_rng(1)))
    st = RNNState(*(torch.zeros(2, w) for w in (130, 32, 32, 32, 32)))
    feats = torch.zeros(2, 65).as_subclass(OnCuda)
    with pytest.raises(NotImplementedError):
        compute_rnn(tp, st, feats, RuntimeConfig(quantized=False))
