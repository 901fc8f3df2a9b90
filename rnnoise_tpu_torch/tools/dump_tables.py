"""Dump the precomputed DSP constant tables (reference
src/dump_rnnoise_tables.c generates rnnoise_tables.c; here the tables are
computed in tables.py and this tool materialises them to .npz for inspection
or for non-Python consumers).  The same eight arrays under the same keys as
``rnnoise_tpu/tools/dump_tables.py``, from the port's own ``tables``.

Usage: python -m rnnoise_tpu_torch.tools.dump_tables out_tables.npz
"""

from __future__ import annotations

import sys

import numpy as np

from .. import tables


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__)
        return 1
    np.savez(
        argv[0],
        eband20ms=tables.EBAND20MS,
        band_matrix=tables.band_matrix(),
        interp_matrix=tables.interp_matrix(),
        half_window=tables.half_window(),
        full_window=tables.full_window(),
        dct_matrix=tables.dct_matrix(),
        biquad_hp_b=tables.BIQUAD_HP_B,
        biquad_hp_a=tables.BIQUAD_HP_A,
    )
    print(f"wrote {argv[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
