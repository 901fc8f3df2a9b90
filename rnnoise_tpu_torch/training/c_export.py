"""Emit ``rnnoise_data.c`` / ``rnnoise_data.h`` from trained parameters — the
equivalent of the reference's CWriter pipeline (wexchange/c_export/
c_writer.py:120-166 + dump_rnnoise_weights.py), so models trained with this
framework can be compiled directly into the reference C library.

Functional compatibility is verified in tests by compiling the emitted
sources against the reference tree and checking that its dump_weights_blob
output equals our own blob export byte-for-byte.

The PyTorch counterpart of ``rnnoise_tpu/training/c_export.py``: for the
same params it writes the same two files, the first line included, so
that sources emitted by either package are interchangeable.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..config import ModelConfig, DEFAULT_MODEL
from ..weights.blob import (WEIGHT_TYPE_FLOAT, WEIGHT_TYPE_INT,
                            WEIGHT_TYPE_INT8, WeightArray)
from .export import params_to_weight_arrays

_DTYPE = {WEIGHT_TYPE_FLOAT: ("float", "float"),
          WEIGHT_TYPE_INT: ("int", "int"),
          WEIGHT_TYPE_INT8: ("opus_int8", "int8")}


def _fmt(v) -> str:
    if isinstance(v, (np.floating,)):
        return repr(float(np.float32(v))) if np.isfinite(v) else "0"
    return str(int(v))


def _print_vector(out: List[str], arr: WeightArray, debug_float: bool):
    ctype, suffix = _DTYPE[arr.type]
    out.append("\n#ifndef USE_WEIGHTS_FILE\n")
    if debug_float:
        out.append("#ifndef DISABLE_DEBUG_FLOAT\n")
    out.append(f"#define WEIGHTS_{arr.name}_DEFINED\n")
    out.append(f"#define WEIGHTS_{arr.name}_TYPE WEIGHT_TYPE_{suffix}\n")
    vals = arr.data
    body = []
    for i, v in enumerate(vals):
        body.append(_fmt(v))
        if i != len(vals) - 1:
            body.append(",\n    " if i % 8 == 7 else ", ")
    out.append(f"static const {ctype} {arr.name}[{len(vals)}] = {{\n    "
               + "".join(body) + "\n};\n")
    if debug_float:
        out.append("#endif /*DISABLE_DEBUG_FLOAT*/\n")
    out.append("#endif /* USE_WEIGHTS_FILE */\n")


def _qn(s):
    return "NULL" if s is None else f'"{s}"'


def emit_c(params: Dict, out_dir: str,
           config: ModelConfig = DEFAULT_MODEL,
           filename: str = "rnnoise_data",
           struct_name: str = "RNNoise",
           quantize: bool = True) -> None:
    arrays = params_to_weight_arrays(params, quantize=quantize)
    by_name = {a.name: a for a in arrays}
    c, g, k, f, nb = (config.cond_size, config.gru_size, config.conv_kernel,
                      config.input_dim, config.output_dim)

    # (layer, nb_in, nb_out, quantized, sparse, diagonal)
    layers = [("conv1", k * f, c, False, False, False),
              ("conv2", k * c, g, quantize, False, False)]
    for i in (1, 2, 3):
        layers.append((f"gru{i}_input", g, 3 * g, quantize, True, False))
        layers.append((f"gru{i}_recurrent", g, 3 * g, quantize, True, True))
    layers += [("dense_out", 4 * g, nb, False, False, False),
               ("vad_dense", 4 * g, 1, False, False, False)]

    src: List[str] = []
    # the JAX package's header line, kept so that both emit the same files
    src.append("/* Generated by rnnoise_tpu.training.c_export */\n\n")
    src.append("#ifdef HAVE_CONFIG_H\n#include \"config.h\"\n#endif\n\n")
    src.append(f'#include "{filename}.h"\n')
    registry: List[str] = []
    init_calls: List[str] = []

    for name, nb_in, nb_out, q, sparse, diag in layers:
        order = []
        if diag:
            order.append((f"{name}_weights_diag", False))
        if sparse:
            if q:
                order.append((f"{name}_weights_int8", False))
            order.append((f"{name}_weights_float", q))
            order.append((f"{name}_weights_idx", False))
        elif q:
            order.append((f"{name}_weights_int8", False))
            order.append((f"{name}_weights_float", True))
        else:
            order.append((f"{name}_weights_float", False))
        if q:
            order.append((f"{name}_subias", False))
            order.append((f"{name}_scale", False))
        order.append((f"{name}_bias", False))
        for aname, dbg in order:
            _print_vector(src, by_name[aname], dbg)
            registry.append(aname)
        init_calls.append(
            f'linear_init(&model->{name}, arrays, {_qn(name + "_bias")}, '
            f'{_qn(name + "_subias") if q else "NULL"}, '
            f'{_qn(name + "_weights_int8") if q else "NULL"},'
            f'{_qn(name + "_weights_float")}, '
            f'{_qn(name + "_weights_idx") if sparse else "NULL"}, '
            f'{_qn(name + "_weights_diag") if diag else "NULL"}, '
            f'{_qn(name + "_scale") if q else "NULL"}, {nb_in}, {nb_out})')

    src.append("\n#ifndef USE_WEIGHTS_FILE\n")
    src.append(f"const WeightArray {struct_name.lower()}_arrays[] = {{\n")
    for aname in registry:
        src.append(f"#ifdef WEIGHTS_{aname}_DEFINED\n")
        src.append(f'    {{"{aname}",  WEIGHTS_{aname}_TYPE, '
                   f"sizeof({aname}), {aname}}},\n")
        src.append("#endif\n")
    src.append("    {NULL, 0, 0, NULL}\n};\n#endif /* USE_WEIGHTS_FILE */\n")
    src.append("\n#ifndef DUMP_BINARY_WEIGHTS\n")
    src.append(f"int init_{struct_name.lower()}({struct_name} *model, "
               "const WeightArray *arrays) {\n")
    for call in init_calls:
        src.append(f"    if ({call}) return 1;\n")
    src.append("    return 0;\n}\n#endif /* DUMP_BINARY_WEIGHTS */\n")

    guard = filename.upper() + "_H"
    hdr: List[str] = []
    hdr.append(f"\n#ifndef {guard}\n#define {guard}\n\n#include \"nnet.h\"\n\n")
    hdr.append(f"\n#define CONV1_OUT_SIZE {c}\n")
    hdr.append(f"\n#define CONV1_IN_SIZE {f}\n")
    hdr.append(f"\n#define CONV1_STATE_SIZE ({f} * ({k - 1}))\n")
    hdr.append(f"\n#define CONV1_DELAY {(k - 1) // 2}\n")
    hdr.append(f"\n#define CONV2_OUT_SIZE {g}\n")
    hdr.append(f"\n#define CONV2_IN_SIZE {c}\n")
    hdr.append(f"\n#define CONV2_STATE_SIZE ({c} * ({k - 1}))\n")
    hdr.append(f"\n#define CONV2_DELAY {(k - 1) // 2}\n")
    for i in (1, 2, 3):
        hdr.append(f"\n#define GRU{i}_OUT_SIZE {g}\n")
        hdr.append(f"\n#define GRU{i}_STATE_SIZE {g}\n")
    hdr.append(f"\n#define DENSE_OUT_OUT_SIZE {nb}\n")
    hdr.append(f"\n#define VAD_DENSE_OUT_SIZE 1\n")
    hdr.append(f"\ntypedef struct {{")
    for name, *_ in layers:
        hdr.append(f"\n    LinearLayer {name};")
    hdr.append(f"\n}} {struct_name};\n")
    hdr.append(f"\nint init_{struct_name.lower()}({struct_name} *model, "
               "const WeightArray *arrays);\n")
    hdr.append(f"\n#endif /* {guard} */\n")

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, filename + ".c"), "w") as fo:
        fo.write("".join(src))
    with open(os.path.join(out_dir, filename + ".h"), "w") as fo:
        fo.write("".join(hdr))
