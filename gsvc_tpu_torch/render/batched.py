"""Decode-frame rendering (port of ``can_mirror`` and ``render_frame_bidir``,
gsvc_tpu/render/batched.py:57, :230-275).

One frame: TSW window -> neural gaussians -> projection -> binning ->
the bidirectional composite (kernel B4 on CUDA tensors, its plain
version on CPU tensors).  There is no fallback to a two-view render: the
bidirectional composite needs the screen mirror to map tile columns onto
tile columns, and ``render_frame_bidir`` refuses a frame width for which
it does not.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsvc_tpu_torch.models.gaussians import (
    GaussianConfig, GenerateMode, ModelState,
    generate_neural_gaussians, window_for_frame,
)
from gsvc_tpu_torch.render.bidir import bidir_composite_attrs
from gsvc_tpu_torch.render.splat import (
    RasterSettings, _bin_gaussians, attr_rows_from_proj, project_gaussians,
)


def can_mirror(settings: RasterSettings) -> bool:
    """The plane-level mirror is exact only when the tiled span equals the
    image width (px' = (W-1) - px maps tile columns onto tile columns)."""
    return settings.image_width == settings.n_tiles_x * settings.tile_w


class FrameSplats(NamedTuple):
    """What the composite of one frame consumes."""

    attrs: torch.Tensor        # [1, M, 9] attribute rows
    tile_lists: torch.Tensor   # [1, T, cap] int32
    counts: torch.Tensor       # [1, T] int32
    num_rendered: torch.Tensor  # composited copies (sum of counts)


def frame_splats(state: ModelState, cfg: GaussianConfig, frame_z: float,
                 x_min: float, y_min: float, scale: float,
                 settings: RasterSettings, window_cap: int,
                 mode: GenerateMode = GenerateMode.DECODED,
                 decoded: bool = True) -> FrameSplats:
    """Everything of ``render_frame_bidir`` before the composite."""
    start, in_window = window_for_frame(state, cfg, frame_z, window_cap)
    gss = generate_neural_gaussians(
        state, cfg, frame_z=frame_z, cam_z=frame_z, window_start=start,
        in_window=in_window, cap=window_cap, mode=mode, decoded=decoded)
    proj = project_gaussians(gss.xyz, gss.scaling, gss.rot, gss.valid,
                             frame_z, x_min, y_min, scale, settings)
    opacity = torch.where(proj.valid[:, None], gss.opacity,
                          torch.zeros_like(gss.opacity))
    tile_lists, counts, _, _, nrend = _bin_gaussians(proj, settings)
    attrs = attr_rows_from_proj(proj, opacity, gss.color)
    return FrameSplats(attrs=attrs[None].contiguous(),
                       tile_lists=tile_lists[None], counts=counts[None],
                       num_rendered=nrend)


def render_frame_bidir(state: ModelState, cfg: GaussianConfig,
                       frame_z: float, x_min: float, y_min: float,
                       scale: float, settings: RasterSettings,
                       window_cap: int,
                       mode: GenerateMode = GenerateMode.DECODED,
                       decoded: bool = True):
    """The fwd/flip-averaged frame in one composite pass.

    Returns (image [3, H, W], total transmittance [H, W], FrameSplats)."""
    if not can_mirror(settings):
        raise ValueError(
            f"the bidirectional composite needs a tile-aligned width: "
            f"{settings.image_width} is not a multiple of tile_w "
            f"{settings.tile_w}")
    fs = frame_splats(state, cfg, frame_z, x_min, y_min, scale, settings,
                      window_cap, mode=mode, decoded=decoded)
    imgs, ts = bidir_composite_attrs(settings, fs.attrs, fs.tile_lists,
                                     fs.counts)
    return imgs[0], ts[0], fs
