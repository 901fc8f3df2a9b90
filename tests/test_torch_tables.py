"""Constants and tables of the port equal the JAX package's."""

import numpy as np
import pytest

import rnnoise_tpu.config as jcfg
import rnnoise_tpu.tables as jtab
import rnnoise_tpu_torch.config as tcfg
import rnnoise_tpu_torch.tables as ttab
from tests.torch_helpers import no_jax_compile_cache  # noqa: F401

CONSTANTS = ("FRAME_SIZE", "WINDOW_SIZE", "FREQ_SIZE", "NB_BANDS",
             "NB_FEATURES", "PITCH_MIN_PERIOD", "PITCH_MAX_PERIOD",
             "PITCH_FRAME_SIZE", "PITCH_BUF_SIZE", "SILENCE_THRESHOLD")


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant(name):
    assert getattr(tcfg, name) == getattr(jcfg, name)


def test_model_config():
    a, b = jcfg.ModelConfig(), tcfg.ModelConfig()
    for f in ("input_dim", "output_dim", "cond_size", "gru_size",
              "conv_kernel", "cat_size"):
        assert getattr(a, f) == getattr(b, f)
    assert tcfg.RuntimeConfig().quantized and tcfg.RuntimeConfig().approx_act


@pytest.mark.parametrize("name", ["band_matrix", "interp_matrix",
                                  "half_window", "full_window", "dct_matrix"])
def test_table(name):
    a, b = getattr(jtab, name)(), getattr(ttab, name)()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["EBAND20MS", "BIQUAD_HP_B", "BIQUAD_HP_A"])
def test_array(name):
    np.testing.assert_array_equal(getattr(jtab, name), getattr(ttab, name))
