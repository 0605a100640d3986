"""Raster settings for a model and frame size, the per-render record, and
single-view frame rendering (port of gsvc_tpu/render/pipeline.py:
``make_raster_settings``, ``RenderResults``, ``render_frame``,
``render_frame_averaged``; and of the single-view drop-ins
``rasterize_pallas_train`` / ``rasterize_pallas``,
gsvc_tpu/render/pallas_splat.py:1195, :1223).

One view of one frame: projection and binning, then the single-view
composite (kernels B5f/B5b on CUDA tensors, their plain versions on CPU
tensors).  The training step and the decoder use the batched paths of
``render/batched.py``; these serve tests and evaluation.

``RASTERIZERS`` are the ``pipeline.rasterizer`` names the port serves;
any other name raises where a rasterizer is chosen.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gsvc_tpu_torch.models.gaussians import (
    GaussianConfig, GeneratedGaussians, GenerateMode, ModelState, RatePack,
    generate_neural_gaussians, window_for_frame,
)
from gsvc_tpu_torch.render.splat import (
    RasterOutput, RasterSettings, _bin_gaussians, assemble_views,
    gather_tile_planes, project_gaussians, tile_harmful_overflow,
)
from gsvc_tpu_torch.render.tile import (
    composite_tiles_inference, tile_composite,
)

# "", "jnp", "pallas" and "pallas_train" composite through the mirror
# kernels B1/B2 (B4 to decode) at tile-aligned widths; "pallas_stream"
# through the stream kernels B6f/B6b; every name through B5f/B5b at
# other widths
RASTERIZERS = ("", "jnp", "pallas", "pallas_train", "pallas_stream")


def check_rasterizer(name: str) -> str:
    """``name`` if the port serves it, else ValueError."""
    if name not in RASTERIZERS:
        raise ValueError(f"unknown rasterizer {name!r}; the port serves "
                         f"{RASTERIZERS}")
    return name


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


def _rasterize(composite, xyz, color, opacity, scaling, rot, valid,
               frame_z, x_min, y_min, scale, settings, flip, means2d):
    proj = project_gaussians(xyz, scaling, rot, valid, frame_z, x_min,
                             y_min, scale, settings, flip=flip,
                             means2d=means2d)
    opacity = torch.where(proj.valid[:, None], opacity,
                          torch.zeros_like(opacity))
    tile_lists, counts, dropped, overflow, n_rendered = _bin_gaussians(
        proj, settings)
    planes = gather_tile_planes(proj, opacity, color, tile_lists)
    imgs, ts = assemble_views(settings, composite(settings, planes, counts))
    return RasterOutput(
        image=imgs[0], transmittance=ts[0], radii=proj.radius,
        num_rendered=n_rendered, overflow=overflow,
        harmful_overflow=tile_harmful_overflow(settings, ts[0].detach(),
                                               dropped))


def rasterize_pallas_train(xyz, color, opacity, scaling, rot, valid,
                           frame_z: float, x_min: float, y_min: float,
                           scale: float, settings: RasterSettings,
                           flip: bool = False, means2d=None) -> RasterOutput:
    """Differentiable single-view rasterization: projection and binning,
    then ``tile_composite`` (B5f/B5b); the plane gradients reach the
    gaussians (and ``means2d``) through the gather's autograd."""
    return _rasterize(tile_composite, xyz, color, opacity, scaling, rot,
                      valid, frame_z, x_min, y_min, scale, settings, flip,
                      means2d)


def rasterize_pallas(xyz, color, opacity, scaling, rot, valid,
                     frame_z: float, x_min: float, y_min: float,
                     scale: float, settings: RasterSettings,
                     flip: bool = False) -> RasterOutput:
    """Forward-only single-view rasterization (B5f, no checkpoints)."""
    return _rasterize(composite_tiles_inference, xyz, color, opacity,
                      scaling, rot, valid, frame_z, x_min, y_min, scale,
                      settings, flip, None)


def render_frame(state: ModelState, cfg: GaussianConfig, frame_z: float,
                 x_min: float, y_min: float, scale: float,
                 settings: RasterSettings, window_cap: int,
                 mode: GenerateMode = GenerateMode.FULL_PRECISION,
                 generator: Optional[torch.Generator] = None,
                 flip: bool = False, decoded: bool = False, means2d=None,
                 rasterizer: str = "pallas_train") -> RenderResults:
    """Render one frame plane in one view direction (``flip=True``: the
    reversed view, whose image the caller x-flips before averaging).

    ``rasterizer`` "pallas" composites forward-only (B5f); every other
    name the port serves ("", "jnp", "pallas_train", "pallas_stream")
    differentiably (B5f/B5b): the JAX package sends "pallas_stream" to its
    non-Pallas compositor here, where "jnp" goes."""
    check_rasterizer(rasterizer)
    start, in_window = window_for_frame(state, cfg, frame_z, window_cap)
    gss = generate_neural_gaussians(
        state, cfg, frame_z=frame_z, cam_z=frame_z, window_start=start,
        in_window=in_window, cap=window_cap, mode=mode, decoded=decoded,
        generator=generator)
    args = (gss.xyz, gss.color, gss.opacity, gss.scaling, gss.rot,
            gss.valid, frame_z, x_min, y_min, scale, settings)
    if rasterizer == "pallas":
        out = rasterize_pallas(*args, flip=flip)
    else:
        out = rasterize_pallas_train(*args, flip=flip, means2d=means2d)
    return RenderResults(
        image=out.image, transmittance=out.transmittance,
        window_start=start, in_window=in_window, radii=out.radii,
        visibility_filter=out.radii > 0, selection_mask=gss.valid,
        neural_opacity=gss.neural_opacity, scaling=gss.scaling,
        num_rendered=out.num_rendered, overflow=out.overflow,
        rate=gss.rate, gaussians=gss,
        harmful_overflow=out.harmful_overflow)


def render_frame_averaged(state: ModelState, cfg: GaussianConfig,
                          frame_z: float, x_min: float, y_min: float,
                          scale: float, settings: RasterSettings,
                          window_cap: int,
                          mode: GenerateMode = GenerateMode.FULL_PRECISION,
                          generator: Optional[torch.Generator] = None,
                          decoded: bool = False):
    """Forward and x-flipped reversed view, averaged (two generations and
    two composites).  Returns (image [3, H, W], forward RenderResults,
    flip RenderResults)."""
    rf = render_frame(state, cfg, frame_z, x_min, y_min, scale, settings,
                      window_cap, mode, generator, flip=False,
                      decoded=decoded)
    rb = render_frame(state, cfg, frame_z, x_min, y_min, scale, settings,
                      window_cap, mode, generator, flip=True,
                      decoded=decoded)
    return (rf.image + rb.image.flip(-1)) / 2.0, rf, rb
