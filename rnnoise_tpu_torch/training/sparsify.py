"""Block sparsifier — the PyTorch counterpart of
``rnnoise_tpu/training/sparsify.py`` (reference torch/sparsification/
common.py:32-89, gru_sparsifier.py:35-167).

Zeroes 4(in) x 8(out) weight blocks by block energy to per-gate target
densities with the reference's cubic ramp schedule.  Our matrices are stored
[in, out] (transposed vs torch), so the reference's [8, 4] (out, in) blocks
become [4, 8] here — the exported storage layout is identical.

The schedule is host arithmetic on the step count in float32, as the JAX
package computes it, so that ``round(nblocks * density)`` (half to even in
both) sees the same operand and keeps the same number of blocks.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# (density, keep_diagonal) per gate, z/r/n order — reference
# torch/rnnoise/rnnoise.py:43-50.
SPARSE_DENSITIES = dict(z=0.2, r=0.3, n=0.5)
SPARSIFY_START = 6000
SPARSIFY_STOP = 20000
SPARSIFY_INTERVAL = 100
SPARSIFY_EXPONENT = 3


def schedule(step: int):
    """(whether ``step`` sparsifies, alpha as float32): every
    SPARSIFY_INTERVAL steps in [START, STOP), then at every step; alpha ramps
    from 1 to 0 as ((STOP - step) / (STOP - START))^3 and is 0 from STOP."""
    if step >= SPARSIFY_STOP:
        return True, np.float32(0.0)
    do_it = step >= SPARSIFY_START and step % SPARSIFY_INTERVAL == 0
    ramp = (np.float32(SPARSIFY_STOP - step)
            / np.float32(SPARSIFY_STOP - SPARSIFY_START))
    # x ** 3 as x * (x * x), the order of JAX's integer power
    ramp = ramp * (ramp * ramp)
    return do_it, np.float32(np.clip(ramp, np.float32(0.0), np.float32(1.0)))


def _sparsify_matrix(w: torch.Tensor, density: np.float32,
                     keep_diagonal: bool) -> torch.Tensor:
    """w: [in, out] (square when keep_diagonal).  Block size (4 in, 8 out)."""
    m, n = w.shape
    if keep_diagonal:
        diag = torch.diag(torch.diagonal(w))
        body = w - diag
    else:
        diag = torch.zeros_like(w)
        body = w
    energies = body.reshape(m // 4, 4, n // 8, 8).square().sum(dim=(1, 3))
    nblocks = energies.numel()
    survivors = int(np.round(np.float32(nblocks) * density))
    # threshold = the k-th largest block energy; 0 (every block kept) when
    # no block survives, as the JAX package has it
    flat = torch.sort(energies.reshape(-1)).values
    thr = 0.0 if survivors == 0 else flat[max(nblocks - survivors, 0)]
    keep = (energies >= thr).to(w.dtype)
    keep = keep.repeat_interleave(4, dim=0).repeat_interleave(8, dim=1)
    return keep * body + diag


@torch.no_grad()
def sparsify_step(params: Dict, step: int) -> bool:
    """Apply one sparsifier step, in place, to all three GRUs (both input and
    recurrent weights) of the param dict; ``step`` is the optimizer step
    count.  Off-schedule steps leave the params as they are.  Returns
    whether this step sparsified."""
    do_it, alpha = schedule(step)
    if not do_it:
        return False
    for name in ("gru1", "gru2", "gru3"):
        gp = params[name]
        n = gp["w_rec"].shape[0]
        for wkey, keep_diag in (("w_in", False), ("w_rec", True)):
            w = gp[wkey]
            for i, gate in enumerate("zrn"):
                target = np.float32(SPARSE_DENSITIES[gate])
                density = alpha + (np.float32(1.0) - alpha) * target
                cols = slice(i * n, (i + 1) * n)
                w[:, cols] = _sparsify_matrix(w[:, cols], density, keep_diag)
    return True
