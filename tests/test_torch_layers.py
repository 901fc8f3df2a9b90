"""The NN runtime's remaining layers (rnnoise_tpu/nn/layers.py:71-113,
188-226) in the port against the JAX package on CPU, from the same
numpy-seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnoise_tpu.nn import layers as jl
from rnnoise_tpu_torch.nn import layers as tl


def _exp_inputs():
    """[-60, 30]: random values, every integer and its neighbours, and the
    < -50 branch's edge."""
    rng = np.random.default_rng(0)
    ints = np.arange(-60, 31, dtype=np.float32)
    x = np.concatenate([rng.uniform(-60, 30, 20000).astype(np.float32), ints,
                        np.nextafter(ints, np.float32(-np.inf)),
                        np.nextafter(ints, np.float32(np.inf)),
                        np.float32([-50.5, -50.0, -49.999, -51.0, 0.0, -0.0])])
    return x.astype(np.float32)


def _exp2_numpy(x):
    """lpcnet_exp2 in numpy f32, which keeps subnormals as C does."""
    f32 = np.float32
    integer = np.floor(x)
    frac = x - integer
    poly = f32(0.99992522) + frac * (f32(0.69583354) + frac * (
        f32(0.22606716) + f32(0.078024523) * frac))
    bits = (poly.view(np.int32) + (integer.astype(np.int32) << 23)) & 0x7FFFFFFF
    return np.where(integer < -50, f32(0), bits.view(np.float32))


@pytest.mark.parametrize("name", ["lpcnet_exp2", "lpcnet_exp"])
def test_lpcnet_exp_bit_for_bit(name):
    """Bit for bit against JAX on every normal input.  XLA's CPU code
    flushes subnormals to zero (floor(-1e-45) = -0 there, -1 in C), so the
    two subnormal neighbours of 0 are held to the same arithmetic in numpy,
    which keeps them as the C reference does."""
    x = _exp_inputs()
    want = np.asarray(getattr(jl, name)(jnp.asarray(x)))
    got = getattr(tl, name)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    normal = (np.abs(x) >= np.finfo(np.float32).tiny) | (x == 0)
    assert (~normal).sum() == 2
    np.testing.assert_array_equal(got[normal].view(np.int32),
                                  want[normal].view(np.int32))
    if name == "lpcnet_exp2":
        np.testing.assert_array_equal(got.view(np.int32),
                                      _exp2_numpy(x).view(np.int32))
        assert (got[x < -51] == 0).all() and (got[x >= -50] > 0).all()


@pytest.mark.parametrize("name", ["relu", "swish", "softmax"])
def test_activations(name):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 4, (7, 33)).astype(np.float32)
    want = np.asarray(getattr(jl, name)(jnp.asarray(x)))
    got = getattr(tl, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("quantized", [False, True])
def test_glu(quantized):
    """The shapes of tests/test_utils.py:28-34; the int8 form with a
    quantised copy of the weights."""
    rng = np.random.default_rng(2)
    W = rng.normal(0, .1, (16, 16)).astype(np.float32)
    fields = dict(weights_f32=W, bias=rng.normal(0, .1, 16).astype(np.float32))
    if quantized:
        scale = (np.abs(W).max(0) / 127).astype(np.float32)
        fields["weights_q"] = np.round(W / scale).astype(np.int8)
        fields["scale"] = scale
    x = rng.normal(0, 1, (3, 16)).astype(np.float32)
    want = np.asarray(jl.glu(
        jl.LinearParams(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jnp.asarray(x), quantized))
    got = tl.glu(tl.LinearParams(**{k: torch.from_numpy(v)
                                    for k, v in fields.items()}),
                 torch.from_numpy(x), quantized).numpy()
    assert got.shape == x.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("activation", ["tanh", "sigmoid", "linear"])
def test_conv2d_step(activation):
    """tests/test_utils.py:36-42's shapes, two steps with the memory
    carried."""
    rng = np.random.default_rng(3)
    w = rng.normal(0, .1, (4, 2, 3, 3)).astype(np.float32)
    b = rng.normal(0, .1, 4).astype(np.float32)
    xs = [rng.normal(0, 1, (3, 2, 10)).astype(np.float32) for _ in range(2)]
    jmem, tmem = jnp.zeros((3, 2, 2, 10)), torch.zeros(3, 2, 2, 10)
    for x in xs:
        jmem, want = jl.conv2d_step(jnp.asarray(w), jnp.asarray(b), jmem,
                                    jnp.asarray(x), activation)
        tmem, got = tl.conv2d_step(torch.from_numpy(w), torch.from_numpy(b),
                                   tmem, torch.from_numpy(x), activation)
        assert tuple(got.shape) == (3, 4, 8) and tmem.shape == (3, 2, 2, 10)
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
        np.testing.assert_array_equal(tmem.numpy(), np.asarray(jmem))


ACTIVATIONS = ["tanh", "sigmoid", "relu", "swish", "softmax", "linear"]


def _dyadic(rng, shape):
    """Multiples of 1/64 in [-1, 1]: every product and sum of a short dot
    is exact in f32, so both packages' linear parts agree exactly whatever
    their summation order (the port sums in f64, XLA in f32) and the test
    holds the activations."""
    return (rng.integers(-64, 65, shape) / 64.0).astype(np.float32)


def _linear_params(rng, n_in, n_out, quantized):
    W = _dyadic(rng, (n_in, n_out))
    fields = dict(weights_f32=W, bias=_dyadic(rng, n_out))
    if quantized:
        scale = (np.abs(W).max(0) / 127).astype(np.float32)
        fields["weights_q"] = np.round(W / scale).astype(np.int8)
        fields["scale"] = scale
    return (jl.LinearParams(**{k: jnp.asarray(v) for k, v in fields.items()}),
            tl.LinearParams(**{k: torch.from_numpy(v)
                               for k, v in fields.items()}))


def _assert_close(got, want):
    """rtol 1e-6 where the port's value is normal or zero.  XLA's CPU code
    flushes subnormals to zero (softmax's lpcnet_exp of a large negative
    input); the port keeps them as C does, so there JAX must hold 0."""
    sub = (got != 0) & (np.abs(got) < np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(want[sub], 0)
    np.testing.assert_allclose(got[~sub], want[~sub], rtol=1e-6, atol=0)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_dense_full_activation_set(activation, quantized):
    """dense through apply_activation (rnnoise_tpu/nn/layers.py:144-167),
    with and without the approximate tanh and sigmoid."""
    rng = np.random.default_rng(4)
    jp, tp = _linear_params(rng, 16, 24, quantized)
    x = _dyadic(rng, (5, 16))
    for approx in (True, False):
        want = np.asarray(jl.dense(jp, jnp.asarray(x), activation, quantized,
                                   approx))
        got = tl.dense(tp, torch.from_numpy(x), activation, quantized,
                       approx).numpy()
        assert got.shape == (5, 24) and got.dtype == np.float32
        _assert_close(got, want)
        np.testing.assert_array_equal(
            got, tl.apply_activation(tl.linear(tp, torch.from_numpy(x),
                                               quantized),
                                     activation, approx).numpy())


@pytest.mark.parametrize("activation", ["relu", "swish", "softmax", "linear"])
def test_conv1d_step_activations(activation):
    """conv1d_step (k=3) through dense with the memory carried over two
    steps, in both numerics."""
    rng = np.random.default_rng(5)
    for quantized in (False, True):
        jp, tp = _linear_params(rng, 3 * 8, 12, quantized)
        jmem, tmem = jnp.zeros((4, 16)), torch.zeros(4, 16)
        for _ in range(2):
            x = _dyadic(rng, (4, 8))
            jmem, want = jl.conv1d_step(jp, jmem, jnp.asarray(x), activation,
                                        quantized, True)
            tmem, got = tl.conv1d_step(tp, tmem, torch.from_numpy(x),
                                       activation, quantized, True)
            _assert_close(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(tmem.numpy(), np.asarray(jmem))


def test_unknown_activation_raises():
    rng = np.random.default_rng(6)
    jp, tp = _linear_params(rng, 8, 8, False)
    x = _dyadic(rng, (2, 8))
    with pytest.raises(ValueError, match="gelu"):
        jl.dense(jp, jnp.asarray(x), "gelu", False, True)
    with pytest.raises(ValueError, match="gelu"):
        tl.dense(tp, torch.from_numpy(x), "gelu", False, True)
    with pytest.raises(ValueError, match="gelu"):
        tl.conv1d_step(tp, torch.zeros(2, 0), torch.from_numpy(x), "gelu",
                       False, True)
