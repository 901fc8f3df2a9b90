"""Convert a reference torch checkpoint (train_rnnoise.py .pth format) into
this package's training-params tree — the counterpart of
``rnnoise_tpu/tools/import_torch.py``, with the mapping done in torch.

Gate reordering: torch GRUs store gates r, z, n; the C/export order is
z, r, n (wexchange/c_export/common.py:342-353).  Matrices transpose from
torch's [out, in] to our [in, out]; conv weights go [out, in, k] ->
[k*in, out] time-major (common.py:289-294).

The result is the tree ``training.model.init_params`` returns: f32 tensors
on ``device``, leaves that take gradients, so the exporter and the trainer
take it unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import resolve_device
from ..training.model import map_params


def _swap_rz(x: torch.Tensor, N: int) -> torch.Tensor:
    """Exchange the first two N-row blocks of the 3N axis (r, z -> z, r)."""
    return torch.cat([x[N:2 * N], x[0:N], x[2 * N:]])


def params_from_torch_state_dict(sd: Dict, device="cuda") -> Dict:
    def arr(name):
        v = sd[name]
        if torch.is_tensor(v):
            return v.detach().to("cpu", torch.float32)
        return torch.from_numpy(np.asarray(v, np.float32))

    def conv(name):
        w = arr(f"{name}.weight")                      # [out, in, k]
        w = w.permute(2, 1, 0).reshape(-1, w.shape[0])
        return dict(w=w, b=arr(f"{name}.bias"))

    def gru(name):
        w_ih = arr(f"{name}.weight_ih_l0")             # [3N, in], r/z/n
        w_hh = arr(f"{name}.weight_hh_l0")
        b_ih = arr(f"{name}.bias_ih_l0")
        b_hh = arr(f"{name}.bias_hh_l0")
        N = w_ih.shape[0] // 3
        return dict(
            w_in=_swap_rz(w_ih, N).T,
            b_in=_swap_rz(b_ih, N),
            w_rec=_swap_rz(w_hh, N).T,
            b_rec=_swap_rz(b_hh, N),
        )

    def dense(name):
        return dict(w=arr(f"{name}.weight").T, b=arr(f"{name}.bias"))

    tree = dict(
        conv1=conv("conv1"), conv2=conv("conv2"),
        gru1=gru("gru1"), gru2=gru("gru2"), gru3=gru("gru3"),
        dense_out=dense("dense_out"), vad_dense=dense("vad_dense"),
    )
    device = resolve_device(device)
    # a fresh contiguous copy of every leaf: the caller's tensors are never
    # aliased, nor marked to take gradients
    return map_params(lambda t: t.contiguous().to(device, copy=True)
                      .requires_grad_(), tree)


def load_torch_checkpoint(path: str, device="cuda") -> Dict:
    # The reference's .pth holds non-tensor entries (model_kwargs and the
    # like), which torch.load's default weights_only=True (PyTorch >= 2.6)
    # refuses.
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    return params_from_torch_state_dict(sd, device)
