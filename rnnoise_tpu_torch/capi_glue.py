"""Python side of the port's C ABI shim (``native/rnnoise_capi.cc`` in this
package) — the counterpart of ``rnnoise_tpu/capi_glue.py``.

One CStream owns a single-stream StreamDenoiser; ``process`` moves 480
floats in and out through the caller's buffers as memoryviews.  As in the
reference contract (include/rnnoise.h), a NULL model selects the default
one and the output is raw floats: rounding is the caller's business.

The denoiser runs on the card unless the environment variable
``RNNOISE_TPU_DEVICE`` names another device (e.g. ``cpu``): a C caller has
no other way to choose, as ``RNNOISE_TPU_REPO`` and ``RNNOISE_TPU_PYTHON``
choose the repo and the interpreter.
"""

from __future__ import annotations

import os

import numpy as np

from .api import RNNoise, StreamDenoiser
from .weights.registry import load_registered

DEVICE_ENV = "RNNOISE_TPU_DEVICE"


class CStream:
    __slots__ = ("den",)

    def __init__(self, den: StreamDenoiser):
        self.den = den


def create(blob) -> CStream:
    """blob: bytes (a model blob) or None for the default model (the C
    contract: a NULL model selects the built-in one, rnnoise.h:66-69)."""
    device = os.environ.get(DEVICE_ENV) or "cuda"
    if blob is not None:
        model = RNNoise.from_buffer(bytes(blob), device=device)
    else:
        model = RNNoise(load_registered(device=device), device=device)
    return CStream(StreamDenoiser(1, model))


def process(st: CStream, in_mv, out_mv) -> float:
    x = np.frombuffer(in_mv, dtype=np.float32)
    out, vad = st.den.process_frame(x[None])
    np.frombuffer(out_mv, dtype=np.float32)[:] = out[0]
    return float(vad[0])
