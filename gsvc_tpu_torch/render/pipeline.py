"""Raster settings for a model and frame size, and the per-render record
(port of ``make_raster_settings`` and ``RenderResults``,
gsvc_tpu/render/pipeline.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsvc_tpu_torch.models.gaussians import (
    GaussianConfig, GeneratedGaussians, RatePack,
)
from gsvc_tpu_torch.render.splat import RasterSettings


class RenderResults(NamedTuple):
    """Per-render record (reference: common/base.py:9-27)."""

    image: torch.Tensor              # [3, H, W] channel-first
    transmittance: torch.Tensor      # [H, W]
    window_start: int                # anchor index of window row 0
    in_window: torch.Tensor          # [V] anchor-level visibility
    radii: torch.Tensor              # [V*K]
    visibility_filter: torch.Tensor  # [V*K] radii > 0
    selection_mask: torch.Tensor     # [V*K] neural_opacity > 0 & in window
    neural_opacity: torch.Tensor     # [V*K, 1]
    scaling: torch.Tensor            # [V*K, 3] generated gaussian scales
    num_rendered: torch.Tensor
    overflow: torch.Tensor
    rate: RatePack                   # the window's rate (entropy modes)
    gaussians: GeneratedGaussians
    # dropped copies at tiles whose final T >= 1/255 (visible loss); the
    # capacity-growth policy reacts to this, raw overflow is telemetry
    harmful_overflow: torch.Tensor


def make_raster_settings(cfg: GaussianConfig, image_height: int,
                         image_width: int, *, tile_h=16, tile_w=128,
                         gaussian_cap=1024, chunk=128, tiles_per_gaussian=32,
                         copy_budget_factor=0, bg=0.0,
                         matmul_dtype="float32") -> RasterSettings:
    """The decoder's settings: 16x128 tiles, cap 1024, chunk 128 — the
    JAX package's defaults, so both packages bin and composite alike."""
    return RasterSettings(
        image_height=image_height, image_width=image_width,
        threshold=cfg.threshold, kernel_size=cfg.kernel_size,
        tile_h=tile_h, tile_w=tile_w, gaussian_cap=gaussian_cap,
        chunk=chunk, tiles_per_gaussian=tiles_per_gaussian,
        copy_budget_factor=copy_budget_factor, bg=bg,
        matmul_dtype=matmul_dtype)
