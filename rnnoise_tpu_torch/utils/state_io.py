"""DenoiseState checkpoints — the counterpart of
``rnnoise_tpu/utils/state_io.py``, in its file format, so that a state saved
by either package loads in the other.

The reference's streaming state is a POD blob a caller can memcpy
(rnnoise_get_size, include/rnnoise.h:57-63); here it is one ``np.savez``
file of the 17 leaves ``leaf_0 ... leaf_16`` in DenoiseState order, with
RNNState's five nested at 7-11 (the JAX package's pytree order).  Useful for
moving streams between hosts and for recovery.
"""

from __future__ import annotations

from typing import BinaryIO, Union

import numpy as np
import torch

from ..config import resolve_device
from ..denoise import DenoiseState
from ..models.rnn import RNNState

N_LEAVES = len(DenoiseState._fields) - 1 + len(RNNState._fields)   # 17
RNN_AT = DenoiseState._fields.index("rnn")                         # 7


def state_leaves(state: DenoiseState) -> list:
    """The state's tensors in file order (RNNState's nested at 7-11)."""
    return [u for t in state for u in (t if isinstance(t, RNNState) else (t,))]


def save_state(state: DenoiseState, f: Union[str, BinaryIO]) -> None:
    np.savez(f, **{f"leaf_{i}": t.detach().cpu().numpy()
                   for i, t in enumerate(state_leaves(state))})


def load_state(f: Union[str, BinaryIO], device="cuda") -> DenoiseState:
    """A saved state on ``device``: ``last_period`` as int32, every other
    leaf as float32 (the port's dtypes, whichever package saved it)."""
    device = resolve_device(device)
    data = np.load(f)
    if len(data.files) != N_LEAVES:
        raise ValueError(f"{len(data.files)} leaves, want {N_LEAVES}")
    period_at = DenoiseState._fields.index("last_period")
    leaves = [torch.from_numpy(np.ascontiguousarray(data[f"leaf_{i}"])).to(
        device, torch.int32 if i == period_at else torch.float32)
        for i in range(N_LEAVES)]
    rnn = RNNState(*leaves[RNN_AT:RNN_AT + len(RNNState._fields)])
    return DenoiseState(*leaves[:RNN_AT], rnn,
                        *leaves[RNN_AT + len(RNNState._fields):])
