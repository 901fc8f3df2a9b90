"""Strip debug float weights from a weights blob — the blob-level equivalent
of the reference's scripts/shrink_model.sh (which perl-strips the float arrays
out of rnnoise_data.c).  Quantised layers keep their int8 arrays; float-only
layers are untouched.  A copy of ``rnnoise_tpu/tools/shrink_model.py`` on the
port's own blob reader.

Usage: python -m rnnoise_tpu_torch.tools.shrink_model in_blob.bin out_blob.bin
"""

from __future__ import annotations

import sys

from ..weights.blob import parse_weights, write_weights


def shrink(blob: bytes) -> bytes:
    arrays = parse_weights(blob)
    out = []
    for name, arr in arrays.items():
        if name.endswith("_weights_float") and \
                name[:-len("_float")] + "_int8" in arrays:
            continue    # debug float copy of a quantised matrix
        out.append(arr)
    return write_weights(out)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        return 1
    with open(argv[0], "rb") as f:
        blob = f.read()
    small = shrink(blob)
    with open(argv[1], "wb") as f:
        f.write(small)
    print(f"{len(blob)} -> {len(small)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
