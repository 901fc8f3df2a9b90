"""Training losses — the PyTorch counterpart of
``rnnoise_tpu/training/loss.py`` (reference torch/rnnoise/
train_rnnoise.py:139-156)."""

from __future__ import annotations

import torch


def mask(g: torch.Tensor) -> torch.Tensor:
    """-1 gain targets mean "don't care" (train_rnnoise.py:86-87)."""
    return torch.clamp(g + 1.0, max=1.0)


def rnnoise_loss(pred_gain, pred_vad, gain, vad, gamma: float = 0.25):
    """gain/vad are the *already time-aligned* targets ([:, 3:-1] slices).

    Returns (loss, (gain_loss, vad_loss))."""
    target_gain = torch.clamp(gain, min=0.0)
    target_gain = target_gain * torch.tanh(8.0 * target_gain) ** 2

    e = pred_gain ** gamma - target_gain ** gamma
    gain_loss = torch.mean((1.0 + 5.0 * vad) * mask(gain) * (e ** 2))

    vad_loss = torch.mean(
        torch.abs(2.0 * vad - 1.0) *
        (-vad * torch.log(0.01 + pred_vad)
         - (1.0 - vad) * torch.log(1.01 - pred_vad)))

    return gain_loss + 0.001 * vad_loss, (gain_loss, vad_loss)
