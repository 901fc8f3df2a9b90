"""Quantised weight export — produces ``weights_blob.bin`` byte-compatible
with the reference toolchain (and loadable by the reference C runtime).

Ports the exporter semantics of torch/weight-exchange/wexchange/c_export/
common.py:
  * per-output-column scale  max(|w|/127, |w_2i + w_2i+1|max/129)  (:175-188)
  * int8 quantisation  round(w/scale), bounds-checked                (:126-132)
  * subias = bias - sum(w_q * scale, axis=0)                         (:244-246)
  * stored runtime scale = scale / 127                               (:248)
  * sparse storage: per 8-output stripe [nb_blocks, in_pos...], int8 blocks
    (8 out x 4 in) row-major, float blocks (4 in x 8 out), diagonal extracted
    from recurrent matrices before blocking                          (:108-171)
  * dense int8 8x4 interleave                                        (:59-62)

Layer set and quantisation choices follow torch/rnnoise/
dump_rnnoise_weights.py:15 (conv1/dense_out/vad_dense stay float).

The PyTorch counterpart of ``rnnoise_tpu/training/export.py``: the same
numpy exporter over this package's params (tensors on any device, copied
to the host), so that the same params give the same bytes in both
packages.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..weights.blob import (WEIGHT_TYPE_FLOAT, WEIGHT_TYPE_INT,
                            WEIGHT_TYPE_INT8, WeightArray, shuffle_dense_int8,
                            write_weights)
from .model import params_to_numpy


def _compute_scaling(weight: np.ndarray) -> np.ndarray:
    n_in, n_out = weight.shape
    assert n_in % 4 == 0 and n_out % 8 == 0
    weight_max_abs = np.max(np.abs(weight), axis=0)
    weight_max_sum = np.max(np.abs(weight[0:n_in:2] + weight[1:n_in:2]), axis=0)
    return np.maximum(weight_max_abs / 127.0, weight_max_sum / 129.0)


def _quantize(weight: np.ndarray, scale: np.ndarray) -> np.ndarray:
    scale = scale + 1e-30
    q = np.round(weight / scale).astype(np.int64)
    if q.max() > 127 or q.min() <= -128:
        raise ValueError("value out of bounds in quantize")
    return np.clip(q, -128, 127).astype(np.int64)


def _extract_diagonal(A: np.ndarray):
    N, M = A.shape
    assert M % N == 0
    B = A.copy()
    diags = []
    for l in range(M // N):
        d = np.diag(B[:, l * N:(l + 1) * N]).copy()
        B[:, l * N:(l + 1) * N] -= np.diag(d)
        diags.append(d)
    return np.concatenate(diags), B


def _f32(name, v):
    return WeightArray(name, WEIGHT_TYPE_FLOAT,
                       np.asarray(v, np.float32).reshape(-1))


def _sparse_arrays(name: str, A: np.ndarray, scale, quantize: bool,
                   out: List[WeightArray]):
    """print_sparse_weight port.  A: [in, out] (diag already extracted by the
    caller when applicable)."""
    Aq = _quantize(A, scale) if quantize else A
    N, M = A.shape
    idx: List[int] = []
    Wi8: List[np.ndarray] = []
    Wf: List[np.ndarray] = []
    for i in range(M // 8):
        pos = len(idx)
        idx.append(-1)
        nb = 0
        for j in range(N // 4):
            block = A[j * 4:(j + 1) * 4, i * 8:(i + 1) * 8]
            qblock = Aq[j * 4:(j + 1) * 4, i * 8:(i + 1) * 8]
            if np.sum(np.abs(block)) > 1e-10:
                nb += 1
                idx.append(j * 4)
                Wi8.append(qblock.T.reshape(-1))        # (8 out, 4 in)
                Wf.append(block.reshape(-1))            # (4 in, 8 out)
        idx[pos] = nb
    if quantize:
        out.append(WeightArray(name + "_int8", WEIGHT_TYPE_INT8,
                               np.concatenate(Wi8).astype(np.int8)))
    out.append(_f32(name + "_float", np.concatenate(Wf)))
    out.append(WeightArray(name + "_idx", WEIGHT_TYPE_INT,
                           np.asarray(idx, np.int32)))
    return Aq


def _linear_arrays(name: str, weight: np.ndarray, bias: np.ndarray,
                   out: List[WeightArray], *, quantize: bool,
                   sparse: bool = False, diagonal: bool = False):
    """print_linear_layer port.  weight: [in, out]."""
    # f32 throughout to mirror the reference exporter's numpy dtypes exactly
    # (weights arrive as float32 from the checkpoint; scale stays f32, subias
    # promotes to f64 in the sum — replicated for byte-exact blobs).
    weight = np.asarray(weight, np.float32)
    n_in, n_out = weight.shape
    scale = _compute_scaling(weight) if quantize else None
    if diagonal:
        diag, body = _extract_diagonal(weight)
        out.append(_f32(name + "_weights_diag", diag))
    else:
        body = weight
    if sparse:
        wq = _sparse_arrays(name + "_weights", body, scale, quantize, out)
    elif quantize:
        wq = _quantize(body, scale)
        out.append(WeightArray(name + "_weights_int8", WEIGHT_TYPE_INT8,
                               shuffle_dense_int8(wq.astype(np.int8))))
        out.append(_f32(name + "_weights_float", body))
    else:
        out.append(_f32(name + "_weights_float", body))
    if quantize:
        subias = (np.zeros(n_out) if bias is None else np.asarray(bias)) \
            - np.sum(wq * scale, axis=0)
        out.append(_f32(name + "_subias", subias))
        out.append(_f32(name + "_scale", scale / 127.0 * np.ones(n_out)))
    if bias is not None:
        out.append(_f32(name + "_bias", bias))


def params_to_weight_arrays(params: Dict,
                            quantize: bool = True) -> List[WeightArray]:
    """Training params -> reference-format WeightArray list."""
    params = params_to_numpy(params)
    out: List[WeightArray] = []
    _linear_arrays("conv1", np.asarray(params["conv1"]["w"]),
                   np.asarray(params["conv1"]["b"]), out, quantize=False)
    _linear_arrays("conv2", np.asarray(params["conv2"]["w"]),
                   np.asarray(params["conv2"]["b"]), out, quantize=quantize)
    for g in ("gru1", "gru2", "gru3"):
        gp = params[g]
        _linear_arrays(f"{g}_input", np.asarray(gp["w_in"]),
                       np.asarray(gp["b_in"]), out,
                       quantize=quantize, sparse=True, diagonal=False)
        _linear_arrays(f"{g}_recurrent", np.asarray(gp["w_rec"]),
                       np.asarray(gp["b_rec"]), out,
                       quantize=quantize, sparse=True, diagonal=True)
    _linear_arrays("dense_out", np.asarray(params["dense_out"]["w"]),
                   np.asarray(params["dense_out"]["b"]), out, quantize=False)
    _linear_arrays("vad_dense", np.asarray(params["vad_dense"]["w"]),
                   np.asarray(params["vad_dense"]["b"]), out, quantize=False)
    return out


def export_blob(params: Dict, quantize: bool = True) -> bytes:
    """-> weights_blob.bin bytes (dump_weights_blob equivalent,
    src/write_weights.c:71-77)."""
    return write_weights(params_to_weight_arrays(params, quantize))


def export_blob_file(params: Dict, path: str, quantize: bool = True) -> None:
    with open(path, "wb") as f:
        f.write(export_blob(params, quantize))
