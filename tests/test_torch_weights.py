"""DNNw blobs: the port's parser, writer, densification and loader agree
with the JAX package's; JAX params carry across unchanged."""

import jax
import numpy as np
import pytest
import torch

from rnnoise_tpu.weights import blob as jblob
from rnnoise_tpu.weights.loader import load_model_file as jload
from rnnoise_tpu_torch.weights import blob as tblob
from rnnoise_tpu_torch.weights.loader import (infer_model_config,
                                              load_model_file, params_from_numpy)
from tests.torch_helpers import MODEL_BLOB, no_jax_compile_cache  # noqa: F401


@pytest.fixture(scope="module")
def blob():
    with open(MODEL_BLOB, "rb") as f:
        return f.read()


def test_parse_matches_reference(blob):
    a, b = jblob.parse_weights(blob), tblob.parse_weights(blob)
    assert list(a) == list(b)
    for k in a:
        assert a[k].type == b[k].type
        np.testing.assert_array_equal(a[k].data, b[k].data)


def test_blob_round_trip_is_byte_identical(blob):
    arrays = tblob.parse_weights(blob)
    out = tblob.write_weights(list(arrays.values()))
    assert out == blob


def test_malformed_blob_raises(blob):
    with pytest.raises(ValueError):
        tblob.parse_weights(b"JUNK" + blob[4:])


def test_densify_matches_reference():
    rng = np.random.default_rng(3)
    nb_in, nb_out = 16, 24
    idx, w8, wf = [], [], []
    for _ in range(nb_out // 8):
        cols = sorted(rng.choice(nb_in // 4, 2, replace=False) * 4)
        idx += [len(cols)] + cols
        w8.append(rng.integers(-127, 128, 32 * len(cols)).astype(np.int8))
        wf.append(rng.standard_normal(32 * len(cols)).astype(np.float32))
    idx = np.array(idx, np.int32)
    w8, wf = np.concatenate(w8), np.concatenate(wf)
    np.testing.assert_array_equal(
        tblob.densify_sparse_int8(w8, idx, nb_in, nb_out),
        jblob.densify_sparse_int8(w8, idx, nb_in, nb_out))
    np.testing.assert_array_equal(
        tblob.densify_sparse_float(wf, idx, nb_in, nb_out),
        jblob.densify_sparse_float(wf, idx, nb_in, nb_out))
    W = rng.integers(-127, 128, (nb_in, nb_out)).astype(np.int8)
    np.testing.assert_array_equal(
        tblob.unshuffle_dense_int8(tblob.shuffle_dense_int8(W), nb_in, nb_out), W)


def test_loader_matches_reference_and_carry_across(blob):
    jp = jload(MODEL_BLOB)
    tp = load_model_file(MODEL_BLOB, device="cpu")
    carried = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cfg = infer_model_config(tblob.parse_weights(blob))
    assert (cfg.cond_size, cfg.gru_size) == (128, 384)
    for name in tp._fields:
        for f in tp.conv1._fields:
            ref = getattr(getattr(jp, name), f)
            for got in (getattr(getattr(tp, name), f),
                        getattr(getattr(carried, name), f)):
                if ref is None:
                    assert got is None, (name, f)
                    continue
                assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
                np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                              err_msg=f"{name}.{f}")
