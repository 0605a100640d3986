"""Raster settings for a model and frame size (port of
``make_raster_settings``, gsvc_tpu/render/pipeline.py)."""

from __future__ import annotations

from gsvc_tpu_torch.models.gaussians import GaussianConfig
from gsvc_tpu_torch.render.splat import RasterSettings


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
