"""Convert a Keras/TensorFlow RNNoise checkpoint (HDF5 weights) into this
package's training-params tree — the TF side of the reference's weight
exchange (reference torch/weight-exchange/wexchange/tf/tf.py:37-178, which
reads live tf.keras layers; the saved .h5 weights are read directly through
h5py so TensorFlow itself is never required).  The counterpart of
``rnnoise_tpu/tools/import_tf.py``; h5py is imported only when a file is
opened.

Layout mapping (vs the torch importer, tools/import_torch.py):
  * Keras GRU gate order is already z, r, h — the C export order
    (wexchange/c_export/common.py:342-353) — so no r/z swap is needed
    (the reference's tf.py does the OPPOSITE swap, zrn -> rzn, only when
    dumping to the torch-layout .npy exchange directory).
  * Keras kernels are [in, out] / [in, 3N] — our convention, no transpose
    (torch needs .T).
  * Keras Conv1D kernels are [k, in, out] -> reshape(k*in, out), already
    time-major (torch needs the (2, 1, 0) transpose first).
  * GRU bias with reset_after=True is [2, 3N]: row 0 input bias, row 1
    recurrent bias (tf.py:46-47).

Usage: python -m rnnoise_tpu_torch.tools.import_tf model.h5 blob.bin \\
           [--float] [--device cuda]
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..training.model import params_from_numpy

# Keras layer names in the reference training stack's conventions -> ours.
# Override via the `names` argument for checkpoints with custom names.
DEFAULT_NAMES = {
    "conv1": "conv1", "conv2": "conv2",
    "gru1": "gru1", "gru2": "gru2", "gru3": "gru3",
    "dense_out": "dense_out", "vad_dense": "vad_dense",
}


def _layer_weights(h5, layer: str):
    """All weight arrays of one layer from a Keras .h5 weights file, in the
    layer's stored order (kernel, recurrent_kernel, bias ...)."""
    root = h5["model_weights"] if "model_weights" in h5 else h5
    if layer not in root:
        raise KeyError(
            f"layer {layer!r} not in checkpoint (has: {sorted(root)})")
    grp = root[layer]
    # Keras nests the variables one level deeper under the layer name (or,
    # for nested cells, under e.g. 'gru_cell'); descend to the group that
    # actually holds datasets.
    while hasattr(grp, "keys") and not any(
            hasattr(grp[k], "shape") for k in grp.keys()):
        inner = list(grp.keys())
        if len(inner) != 1:
            raise KeyError(f"ambiguous weight group for {layer!r}: {inner}")
        grp = grp[inner[0]]
    names = (list(grp.attrs["weight_names"])
             if "weight_names" in grp.attrs else sorted(grp.keys()))

    def order(n):
        n = n.decode() if isinstance(n, bytes) else n
        key = n.rsplit("/", 1)[-1].split(":")[0]
        return {"kernel": 0, "recurrent_kernel": 1, "bias": 2}.get(key, 3)

    keys = sorted(grp.keys(), key=order)
    return [np.asarray(grp[k], np.float32) for k in keys]


def params_from_keras_h5(h5, names: Dict[str, str] = None,
                         device="cuda") -> Dict:
    """Open h5py.File (or group) of Keras weights -> training-params tree
    (same structure as training.model.init_params / import_torch), f32
    tensors on ``device`` that take gradients."""
    names = dict(DEFAULT_NAMES, **(names or {}))

    def conv(layer):
        w, b = _layer_weights(h5, names[layer])[:2]
        if w.ndim != 3:
            raise ValueError(f"{layer}: expected Conv1D [k, in, out] kernel, "
                             f"got {w.shape}")
        return dict(w=w.reshape(-1, w.shape[-1]), b=b)

    def gru(layer):
        w_in, w_rec, bias = _layer_weights(h5, names[layer])[:3]
        if bias.ndim != 2 or bias.shape[0] != 2:
            raise ValueError(
                f"{layer}: expected reset_after GRU bias [2, 3N], got "
                f"{bias.shape} (reset_after=False checkpoints are not the "
                "reference architecture, tf.py:41-43)")
        return dict(w_in=w_in, b_in=bias[0], w_rec=w_rec, b_rec=bias[1])

    def dense(layer):
        w, b = _layer_weights(h5, names[layer])[:2]
        return dict(w=w, b=b)

    return params_from_numpy(dict(
        conv1=conv("conv1"), conv2=conv("conv2"),
        gru1=gru("gru1"), gru2=gru("gru2"), gru3=gru("gru3"),
        dense_out=dense("dense_out"), vad_dense=dense("vad_dense"),
    ), device)


def load_keras_checkpoint(path: str, names: Dict[str, str] = None,
                          device="cuda") -> Dict:
    import h5py
    with h5py.File(path, "r") as f:
        return params_from_keras_h5(f, names, device)


def main(argv=None) -> None:
    """CLI: Keras .h5 weights -> RNNoise weight blob (DNNw format)."""
    import argparse

    from ..training.export import export_blob_file

    ap = argparse.ArgumentParser(
        description="convert a Keras RNNoise checkpoint to a weight blob")
    ap.add_argument("h5_in", help="Keras .h5 weights/model file")
    ap.add_argument("blob_out", help="output DNNw blob path")
    ap.add_argument("--float", action="store_true",
                    help="export float weights (no int8 quantization)")
    ap.add_argument("--device", default="cuda",
                    help="device the params are loaded on (default cuda)")
    args = ap.parse_args(argv)
    params = load_keras_checkpoint(args.h5_in, device=args.device)
    export_blob_file(params, args.blob_out, quantize=not args.float)
    print(f"wrote {args.blob_out}")


if __name__ == "__main__":
    main()
