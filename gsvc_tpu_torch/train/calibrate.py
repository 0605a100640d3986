"""Densify-threshold calibration for NDC gradient units (a copy of
``gsvc_tpu/train/calibrate.py``: host numpy, no JAX).

The reference's ``densify_grad_threshold`` (0.0002,
arguments/__init__.py) is calibrated to its CUDA rasterizer's
screen-space gradient scale.  Our accumulated statistic is
|dL/d(mean2d_px)| * scale — NDC units (train/trainer.py:accumulate_stats)
— so the same numeric value selects a different candidate fraction.
Rather than hand-porting a unit conversion that depends on resolution
and loss weights, calibrate empirically: choose the threshold whose
CANDIDATE FRACTION (share of qualified offsets above threshold at a
densify event) matches a target — the quantity that actually controls
anchor growth dynamics.
"""

from __future__ import annotations

import numpy as np


def candidate_fraction(stats: dict, opt, threshold: float) -> float:
    """Fraction of qualified offsets whose mean screen-grad magnitude
    exceeds ``threshold`` (the depth-0 growing criterion,
    train/densify.py)."""
    denom = stats["offset_denom"][:, 0]
    grads = stats["offset_gradient_accum"][:, 0] / np.maximum(denom, 1e-12)
    grads = np.nan_to_num(grads, nan=0.0, posinf=0.0, neginf=0.0)
    qualified = denom > opt.update_interval * opt.success_threshold * 0.5
    if not qualified.any():
        return 0.0
    return float(np.mean(np.abs(grads[qualified]) >= threshold))


def calibrate_densify_threshold(stats: dict, opt,
                                target_fraction: float = 0.04) -> float:
    """Threshold whose depth-0 candidate fraction equals
    ``target_fraction`` (default ~4%, the reference's typical share of
    growing candidates per event at its published operating point).

    Returns the configured threshold unchanged when no offsets qualify
    yet (too early in the fit to calibrate)."""
    denom = stats["offset_denom"][:, 0]
    grads = stats["offset_gradient_accum"][:, 0] / np.maximum(denom, 1e-12)
    grads = np.nan_to_num(grads, nan=0.0, posinf=0.0, neginf=0.0)
    qualified = denom > opt.update_interval * opt.success_threshold * 0.5
    vals = np.abs(grads[qualified])
    if vals.size == 0:
        return float(opt.densify_grad_threshold)
    return float(np.quantile(vals, 1.0 - target_fraction))
