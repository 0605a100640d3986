"""Training losses (port of gsvc_tpu/metrics/losses.py; reference:
utils/loss_utils.py:20-72)."""

from __future__ import annotations

import torch

from gsvc_tpu_torch.metrics.image import ssim


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def ssim_loss(pred, target):
    """1 - SSIM."""
    return 1.0 - ssim(pred, target)
