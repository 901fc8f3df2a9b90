"""Shared pieces of the tests that hold rnnoise_tpu_torch (the PyTorch port)
against rnnoise_tpu (the JAX reference) on CPU.

Inputs are made with numpy from a seed and handed to both packages.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import speechlike

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_BLOB = os.path.join(REPO, "models", "rnnoise_synth_v1.blob")
CPU = torch.device("cpu")
# the port's tests run many small ops: one intra-op thread per pytest worker
# is faster than several workers' thread pools fighting over the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def no_jax_compile_cache():
    """Keep this module's JAX compiles out of the repo's persistent cache."""
    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", old)


def xla_cpu_hp_state(rt=None):
    """``rt`` (the default configuration when None) with the port's
    HP-biquad state rounded as the JAX package's CPU graph rounds it
    (RuntimeConfig.hp_rounding="xla_cpu"): its state map amplifies a 1-ulp
    difference ~290x per frame, past the parity budget."""
    from rnnoise_tpu_torch.config import DEFAULT_RUNTIME
    return dataclasses.replace(rt or DEFAULT_RUNTIME, hp_rounding="xla_cpu")


class OnCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, to drive a wrapper's
    CUDA branch on a machine without a card."""

    @property
    def is_cuda(self):
        return True


def random_model_arrays(rng, F=65, C=16, N=32, NB=32):
    """A small random model as {layer: {LinearParams field: numpy array}}."""
    def layer(n_in, n_out, quantized, diag=False):
        d = dict(bias=(0.1 * rng.standard_normal(n_out)).astype(np.float32),
                 weights_q=None, scale=None, diag=None)
        if quantized:
            wq = rng.integers(-127, 128, (n_in, n_out)).astype(np.int8)
            wq[rng.random((n_in, n_out)) < 0.3] = 0
            scale = (rng.uniform(0.5, 1.5, n_out)
                     / (127.0 * np.sqrt(n_in))).astype(np.float32)
            d.update(weights_q=wq, scale=scale,
                     weights_f32=wq.astype(np.float32) * scale[None, :])
        else:
            d["weights_f32"] = (rng.standard_normal((n_in, n_out))
                                / np.sqrt(n_in)).astype(np.float32)
        if diag:
            d["diag"] = (0.1 * rng.standard_normal(n_out)).astype(np.float32)
        return d
    out = {"conv1": layer(3 * F, C, False), "conv2": layer(3 * C, N, True)}
    for i in (1, 2, 3):
        out[f"gru{i}_input"] = layer(N, 3 * N, True)
        out[f"gru{i}_recurrent"] = layer(N, 3 * N, True, diag=True)
    out["dense_out"] = layer(4 * N, NB, False)
    out["vad_dense"] = layer(4 * N, 1, False)
    return out


def jax_params(arrays):
    from rnnoise_tpu.models.rnn import ModelParams
    from rnnoise_tpu.nn.layers import LinearParams
    return ModelParams(**{
        name: LinearParams(**{k: None if v is None else jnp.asarray(v)
                              for k, v in fields.items()})
        for name, fields in arrays.items()})


def torch_params(arrays):
    from rnnoise_tpu_torch.weights.loader import params_from_numpy
    tree = types.SimpleNamespace(**{
        name: types.SimpleNamespace(**fields) for name, fields in arrays.items()})
    return params_from_numpy(tree, CPU)


def make_signal(rng, n_frames):
    """Speech-like signal with a near-silent and a noise-only stretch (the
    recipe of tests/test_e2e_parity.py)."""
    n = n_frames * 480
    sig = speechlike(rng, n, f0=120.0, noise=0.08)
    third = n // 3
    span = min(10 * 480, third)
    sig[third:third + span] *= 0.0001
    sig[2 * third:2 * third + span] = \
        (500 * rng.standard_normal(span)).astype(np.float32)
    return sig


def to_torch(a):
    return torch.from_numpy(np.array(a))


def state_to_torch(js):
    """A JAX DenoiseState (natural spectrum layout) as the port's."""
    from rnnoise_tpu_torch.denoise import DenoiseState
    from rnnoise_tpu_torch.models.rnn import RNNState
    return DenoiseState(**{
        f: RNNState(*map(to_torch, v)) if f == "rnn" else to_torch(v)
        for f, v in zip(js._fields, js)})
