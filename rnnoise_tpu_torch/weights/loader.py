"""Assemble torch model parameters from parsed weight arrays — the
counterpart of ``rnnoise_tpu/weights/loader.py``.

Mirrors the generated ``init_rnnoise()`` (wexchange/c_export/c_writer.py:
158-166, linear_init in src/parse_lpcnet_weights.c:123-176): each layer
resolves arrays by the naming convention ``<layer>_{bias,subias,
weights_int8,weights_float,weights_idx,weights_diag,scale}``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import DEFAULT_MODEL, ModelConfig
from ..models.rnn import ModelParams
from ..nn.layers import LinearParams
from .blob import (WeightArray, densify_sparse_float, densify_sparse_int8,
                   parse_weights, unshuffle_dense_int8)


def _get(arrays: Dict[str, WeightArray], name: str,
         expect_len: Optional[int] = None) -> np.ndarray:
    if name not in arrays:
        raise KeyError(f"missing weight array {name!r}")
    a = arrays[name].data
    if expect_len is not None and a.size != expect_len:
        raise ValueError(f"{name}: expected {expect_len} elements, got {a.size}")
    return a


def _linear_from_arrays(arrays, name, nb_in, nb_out, *, quantized, sparse,
                        diagonal=False) -> dict:
    """numpy fields of one LinearParams."""
    bias = _get(arrays, f"{name}_bias", nb_out).astype(np.float32)
    diag = None
    if diagonal:
        diag = _get(arrays, f"{name}_weights_diag", nb_out).astype(np.float32)
    Wq = scale = Wf = None
    wf_name = f"{name}_weights_float"
    if sparse:
        idx = _get(arrays, f"{name}_weights_idx")
        if wf_name in arrays:
            Wf = densify_sparse_float(arrays[wf_name].data, idx, nb_in, nb_out)
        if quantized:
            Wq = densify_sparse_int8(
                _get(arrays, f"{name}_weights_int8"), idx, nb_in, nb_out)
            scale = _get(arrays, f"{name}_scale", nb_out).astype(np.float32)
    elif quantized:
        Wq = unshuffle_dense_int8(
            _get(arrays, f"{name}_weights_int8", nb_in * nb_out), nb_in, nb_out)
        scale = _get(arrays, f"{name}_scale", nb_out).astype(np.float32)
        if wf_name in arrays:
            Wf = arrays[wf_name].data.astype(np.float32).reshape(nb_in, nb_out)
    else:
        Wf = _get(arrays, wf_name, nb_in * nb_out).astype(
            np.float32).reshape(nb_in, nb_out)
    if Wf is None:
        Wf = Wq.astype(np.float32) * scale[None, :]
    return dict(weights_f32=Wf, bias=bias, weights_q=Wq, scale=scale,
                diag=diag)


def infer_model_config(arrays: Dict[str, WeightArray]) -> ModelConfig:
    """Topology from the blob itself: cond = |conv1 bias|, gru = |conv2 bias|."""
    return ModelConfig(cond_size=int(_get(arrays, "conv1_bias").size),
                       gru_size=int(_get(arrays, "conv2_bias").size))


def _to_torch(fields: dict, device) -> LinearParams:
    def t(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(device)
    return LinearParams(**{k: t(v) for k, v in fields.items()})


def model_params_from_arrays(arrays: Dict[str, WeightArray],
                             config: Optional[ModelConfig] = DEFAULT_MODEL,
                             device="cuda") -> ModelParams:
    if config is None:
        config = infer_model_config(arrays)
    c, g, k = config.cond_size, config.gru_size, config.conv_kernel
    f, nb = config.input_dim, config.output_dim
    layers = {
        "conv1": _linear_from_arrays(arrays, "conv1", k * f, c,
                                     quantized=False, sparse=False),
        "conv2": _linear_from_arrays(arrays, "conv2", k * c, g,
                                     quantized=True, sparse=False),
    }
    for i in (1, 2, 3):
        layers[f"gru{i}_input"] = _linear_from_arrays(
            arrays, f"gru{i}_input", g, 3 * g, quantized=True, sparse=True)
        layers[f"gru{i}_recurrent"] = _linear_from_arrays(
            arrays, f"gru{i}_recurrent", g, 3 * g, quantized=True, sparse=True,
            diagonal=True)
    layers["dense_out"] = _linear_from_arrays(
        arrays, "dense_out", 4 * g, nb, quantized=False, sparse=False)
    layers["vad_dense"] = _linear_from_arrays(
        arrays, "vad_dense", 4 * g, 1, quantized=False, sparse=False)
    return ModelParams(**{k: _to_torch(v, device) for k, v in layers.items()})


def params_from_numpy(tree, device="cuda") -> ModelParams:
    """Carry the JAX package's ModelParams across: ``tree`` has its layer
    fields (``conv1``, ..., ``vad_dense``), each with the LinearParams
    fields as numpy arrays or None — e.g. ``jax.tree.map(np.asarray,
    params)``.  Returns the port's params on ``device``."""
    return ModelParams(**{
        name: _to_torch({f: getattr(getattr(tree, name), f)
                         for f in LinearParams._fields}, device)
        for name in ModelParams._fields})


def load_model_bytes(blob: bytes, config: Optional[ModelConfig] = DEFAULT_MODEL,
                     device="cuda") -> ModelParams:
    """rnnoise_model_from_buffer equivalent (include/rnnoise.h:98-105)."""
    return model_params_from_arrays(parse_weights(blob), config, device)


def load_model_file(path: str, config: Optional[ModelConfig] = DEFAULT_MODEL,
                    device="cuda") -> ModelParams:
    """rnnoise_model_from_filename equivalent (include/rnnoise.h:113-117)."""
    with open(path, "rb") as f:
        return load_model_bytes(f.read(), config, device)
