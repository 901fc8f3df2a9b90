"""Reader/writer for the reference's ``DNNw`` binary weight-blob format, plus
densification of its block-sparse int8 storage (numpy only; a copy of
``rnnoise_tpu/weights/blob.py``).

Format (reference src/nnet.h:41-62, src/write_weights.c:46-69,
src/parse_lpcnet_weights.c:37-78): a sequence of 64-byte little-endian headers

    char head[4] = "DNNw" | i32 version=0 | i32 type | i32 size
    | i32 block_size | char name[44] (NUL-terminated)

each followed by ``size`` payload bytes padded to ``block_size`` (a multiple
of 64).

Sparse layout (produced by wexchange/c_export/common.py:135-171): per 8-output
stripe the idx stream holds ``[nb_blocks, in_pos...]``; each int8 block stores
an (8 out x 4 in) tile row-major, each float block a (4 in x 8 out) tile
row-major — matching sparse_cgemv8x4 / sparse_sgemv8x4 (src/vec.h:123-180,
248-281).
"""

from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple

import numpy as np

WEIGHT_BLOCK_SIZE = 64
WEIGHT_TYPE_FLOAT = 0
WEIGHT_TYPE_INT = 1
WEIGHT_TYPE_QWEIGHT = 2
WEIGHT_TYPE_INT8 = 3

_DTYPES = {
    WEIGHT_TYPE_FLOAT: np.dtype("<f4"),
    WEIGHT_TYPE_INT: np.dtype("<i4"),
    WEIGHT_TYPE_QWEIGHT: np.dtype("<i1"),
    WEIGHT_TYPE_INT8: np.dtype("<i1"),
}
_HEAD = struct.Struct("<4siiii44s")


class WeightArray(NamedTuple):
    name: str
    type: int
    data: np.ndarray     # 1-D, dtype per type


def parse_weights(blob: bytes) -> Dict[str, WeightArray]:
    """Parse a weights blob into {name: WeightArray}.  Validation mirrors
    parse_record (src/parse_lpcnet_weights.c:37-52)."""
    out: Dict[str, WeightArray] = {}
    off, n = 0, len(blob)
    while n - off > 0:
        if n - off < WEIGHT_BLOCK_SIZE:
            raise ValueError("truncated weight header")
        head, version, wtype, size, block_size, name = _HEAD.unpack_from(blob, off)
        if head != b"DNNw" or version != 0:
            raise ValueError(f"bad weight header at offset {off}")
        if size < 0 or block_size < size or block_size > n - off - WEIGHT_BLOCK_SIZE:
            raise ValueError(f"bad sizes in weight header at offset {off}")
        if name[-1:] != b"\x00":
            raise ValueError("weight name not NUL-terminated")
        sname = name.split(b"\x00", 1)[0].decode("ascii")
        dt = _DTYPES.get(wtype, np.dtype("<u1"))
        payload = np.frombuffer(blob, dtype=dt,
                                count=size // dt.itemsize,
                                offset=off + WEIGHT_BLOCK_SIZE).copy()
        out[sname] = WeightArray(sname, wtype, payload)
        off += WEIGHT_BLOCK_SIZE + block_size
    return out


def write_weights(arrays: List[WeightArray]) -> bytes:
    """Serialise arrays into a blob bit-compatible with write_weights
    (src/write_weights.c:46-69)."""
    chunks = []
    for a in arrays:
        data = np.ascontiguousarray(a.data)
        raw = data.tobytes()
        size = len(raw)
        block_size = (size + WEIGHT_BLOCK_SIZE - 1) // WEIGHT_BLOCK_SIZE * WEIGHT_BLOCK_SIZE
        name = a.name.encode("ascii")
        if len(name) > 43:
            raise ValueError(f"weight name too long: {a.name}")
        chunks.append(_HEAD.pack(b"DNNw", 0, a.type, size, block_size, name))
        chunks.append(raw)
        chunks.append(b"\x00" * (block_size - size))
    return b"".join(chunks)


# ---------------------------------------------------------------------------
# densification — sparse/interleaved storage -> plain [in, out] matrices
# ---------------------------------------------------------------------------

def _iter_sparse_blocks(idx: np.ndarray, nb_out: int):
    pos = 0
    for stripe in range(nb_out // 8):
        nb = int(idx[pos]); pos += 1
        for _ in range(nb):
            yield stripe, int(idx[pos]); pos += 1


def densify_sparse_int8(w: np.ndarray, idx: np.ndarray,
                        nb_in: int, nb_out: int) -> np.ndarray:
    """Block-sparse int8 -> dense [nb_in, nb_out] int8 (missing blocks = 0)."""
    W = np.zeros((nb_in, nb_out), dtype=np.int8)
    wpos = 0
    for stripe, colpos in _iter_sparse_blocks(idx, nb_out):
        block = w[wpos:wpos + 32].reshape(8, 4)     # (out, in) row-major
        W[colpos:colpos + 4, stripe * 8:(stripe + 1) * 8] = block.T
        wpos += 32
    return W


def densify_sparse_float(w: np.ndarray, idx: np.ndarray,
                         nb_in: int, nb_out: int) -> np.ndarray:
    """Block-sparse float -> dense [nb_in, nb_out] float32."""
    W = np.zeros((nb_in, nb_out), dtype=np.float32)
    wpos = 0
    for stripe, colpos in _iter_sparse_blocks(idx, nb_out):
        block = w[wpos:wpos + 32].reshape(4, 8)     # (in, out) row-major
        W[colpos:colpos + 4, stripe * 8:(stripe + 1) * 8] = block
        wpos += 32
    return W


def unshuffle_dense_int8(w: np.ndarray, nb_in: int, nb_out: int) -> np.ndarray:
    """Invert the exporter's dense 8x4 interleave (common.py:59-62) back to
    [nb_in, nb_out]."""
    return (w.reshape(nb_out // 8, nb_in // 4, 8, 4)
             .transpose(1, 3, 0, 2)
             .reshape(nb_in, nb_out))


def shuffle_dense_int8(W: np.ndarray) -> np.ndarray:
    """[nb_in, nb_out] -> exporter's interleaved dense int8 stream."""
    nb_in, nb_out = W.shape
    return (W.reshape(nb_in // 4, 4, nb_out // 8, 8)
             .transpose(2, 0, 3, 1)
             .reshape(-1))
