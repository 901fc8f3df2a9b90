"""Training pipeline — the PyTorch counterpart of
``rnnoise_tpu/training/train.py`` (reference torch/rnnoise/train_rnnoise.py).

Defaults mirror the reference exactly: AdamW(lr 1e-3, betas (.8, .98),
eps 1e-8, weight decay 0.01), LambdaLR 1/(1 + 5e-5 * step), batch 128,
2000-frame sequences, gamma 0.25, GRU states carried (detached) across
batches, optional block sparsification after each optimizer step.  The
backward pass is autograd's; it runs on the GPU unless the caller names
another device.

    python -m rnnoise_tpu_torch.training.train features.f32 outdir \\
        [--device cuda|cpu] [--sparse] ...
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

from ..config import ModelConfig, resolve_device
from .data import RNNoiseDataset
from .loss import rnnoise_loss
from .model import forward, init_params, map_params, param_leaves
from .sparsify import sparsify_step

ADAM_BETAS = (0.8, 0.98)
ADAM_EPS = 1e-8
WEIGHT_DECAY = 0.01


def make_optimizer(params: Dict, lr: float = 1e-3, lr_decay: float = 5e-5):
    """(AdamW over every leaf, its LambdaLR schedule lr / (1 + lr_decay *
    updates so far)): the update of ``optax.adamw`` with that schedule, as
    the JAX package builds it.  Step the schedule after each optimizer
    step."""
    opt = torch.optim.AdamW(param_leaves(params), lr=lr, betas=ADAM_BETAS,
                            eps=ADAM_EPS, weight_decay=WEIGHT_DECAY)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda n: 1.0 / (1.0 + lr_decay * n))
    return opt, sched


def make_train_step(optimizer, scheduler, gamma: float = 0.25,
                    sparse: bool = False, remat: bool = True):
    """Returns (params, states, batch, step) -> (states, metrics): one
    optimizer step on ``params`` in place.  ``batch`` is (features, gain,
    vad) on the params' device; ``states`` the three GRU states (detached in
    the result); ``step`` the step count the sparsifier's schedule reads;
    ``metrics`` the loss and its two parts as tensors."""

    def step_fn(params, states, batch, step):
        features, gain, vad = batch
        pred_gain, pred_vad, new_states = forward(params, features, states,
                                                  remat=remat)
        loss, (gl, vl) = rnnoise_loss(pred_gain, pred_vad,
                                      gain[:, 3:-1], vad[:, 3:-1], gamma)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        scheduler.step()
        if sparse:
            sparsify_step(params, step)
        metrics = dict(loss=loss.detach(), gain_loss=gl.detach(),
                       vad_loss=vl.detach())
        return tuple(h.detach() for h in new_states), metrics

    return step_fn


def save_checkpoint(path: str, params: Dict, optimizer, step: int,
                    config: ModelConfig, loss: float = float("nan")):
    """Epoch checkpoints (the .pth analogue, train_rnnoise.py:173-178):
    params as CPU tensors, the optimizer's state, the step and the
    topology."""
    blob = dict(
        params=map_params(lambda t: t.detach().cpu(), params),
        opt_state=optimizer.state_dict(),
        step=step,
        model_kwargs=dict(cond_size=config.cond_size,
                          gru_size=config.gru_size),
        loss=loss,
    )
    torch.save(blob, path)


def load_checkpoint(path: str, device="cuda"):
    """-> (the checkpoint's dict, its params on ``device`` as leaves that
    take gradients)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    device = resolve_device(device)
    params = map_params(lambda t: t.to(device).requires_grad_(),
                        blob["params"])
    return blob, params


def train(args):
    device = resolve_device(args.device)
    config = ModelConfig(cond_size=args.cond_size, gru_size=args.gru_size)
    dataset = RNNoiseDataset(args.features, args.sequence_length)
    print(f"{len(dataset)} sequences")

    params = init_params(torch.Generator().manual_seed(args.seed), config,
                         device)
    nb_params = sum(t.numel() for t in param_leaves(params))
    print(f"model: {nb_params} weights")

    step = 0
    if args.initial_checkpoint:
        # as the JAX package resumes: the params and the step count, with a
        # fresh optimizer state and schedule
        blob, params = load_checkpoint(args.initial_checkpoint, device)
        step = blob.get("step", 0)
    optimizer, scheduler = make_optimizer(params, args.lr, args.lr_decay)
    train_step = make_train_step(optimizer, scheduler, args.gamma, args.sparse)

    os.makedirs(os.path.join(args.output, "checkpoints"), exist_ok=True)
    rng = np.random.default_rng(args.seed)
    states = None
    B = args.batch_size
    for epoch in range(1, args.epochs + 1):
        order = rng.permutation(len(dataset))
        n_batches = len(dataset) // B
        running = dict(loss=0.0, gain_loss=0.0, vad_loss=0.0)
        for i in range(n_batches):
            idx = order[i * B:(i + 1) * B]
            batch = tuple(torch.from_numpy(a).to(device)
                          for a in dataset.batch(idx))
            if states is None:
                states = tuple(torch.zeros((B, config.gru_size),
                                           dtype=torch.float32, device=device)
                               for _ in range(3))
            states, metrics = train_step(params, states, batch, step)
            step += 1
            for k in running:
                running[k] += float(metrics[k])
            if (i + 1) % 10 == 0 or i + 1 == n_batches:
                msg = " ".join(f"{k}={running[k] / (i + 1):8.5f}"
                               for k in running)
                print(f"epoch {epoch} [{i + 1}/{n_batches}] {msg}")
        ckpt = os.path.join(args.output, "checkpoints",
                            f"rnnoise{args.suffix}_{epoch}.ckpt")
        save_checkpoint(ckpt, params, optimizer, step, config,
                        running["loss"] / max(1, n_batches))
    return params


def build_argparser():
    p = argparse.ArgumentParser(description="Train RNNoise on a GPU or CPU "
                                            "(PyTorch)")
    p.add_argument("features", type=str)
    p.add_argument("output", type=str)
    p.add_argument("--suffix", type=str, default="")
    p.add_argument("--cond-size", type=int, default=128)
    p.add_argument("--gru-size", type=int, default=384)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--sequence-length", type=int, default=2000)
    p.add_argument("--lr-decay", type=float, default=5e-5)
    p.add_argument("--initial-checkpoint", type=str, default=None)
    p.add_argument("--gamma", type=float, default=0.25)
    p.add_argument("--sparse", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


if __name__ == "__main__":
    train(build_argparser().parse_args())
