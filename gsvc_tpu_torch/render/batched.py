"""Frame rendering for decode and training (port of ``can_mirror``,
``_mirror_tile_perm``, ``render_frame_bidir``, ``_pair_entropy_contexts``
and the mirror-kernel branch of ``render_pair``,
gsvc_tpu/render/batched.py:49-57, :230-328, :330-511).

Decode, one frame: TSW window -> neural gaussians -> projection ->
binning -> the bidirectional composite (kernel B4).  Training, a frame
pair: one generation, projection and binning per frame, then both frames'
forward and x-mirrored views in one mirror composite (kernels B1 and B2).
CUDA tensors launch the kernels, CPU tensors take their plain versions.
There is no fallback to a two-view render: both composites need the
screen mirror to map tile columns onto tile columns, and refuse a frame
width for which it does not (the single-view kernel pair B5 serves that
case in the JAX package and is not ported yet).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gsvc_tpu_torch.models.gaussians import (
    EntropyContext, GaussianConfig, GenerateMode, ModelState,
    calc_entropy_context, generate_neural_gaussians, get_anchor,
    window_for_frame,
)
from gsvc_tpu_torch.render.bidir import bidir_composite_attrs
from gsvc_tpu_torch.render.mirror import mirror_composite_attrs
from gsvc_tpu_torch.render.pipeline import RenderResults
from gsvc_tpu_torch.render.splat import (
    RasterSettings, _bin_gaussians, assemble_views, attr_rows_from_proj,
    project_gaussians, tile_harmful_overflow,
)


def _mirror_tile_perm(settings: RasterSettings) -> np.ndarray:
    """Static [n_tiles] permutation mapping tile t to its x-mirror."""
    ty = np.arange(settings.n_tiles) // settings.n_tiles_x
    tx = np.arange(settings.n_tiles) % settings.n_tiles_x
    return (ty * settings.n_tiles_x
            + (settings.n_tiles_x - 1 - tx)).astype(np.int32)


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


def _pair_entropy_contexts(state: ModelState, cfg: GaussianConfig, s1: int,
                           s2: int, cap: int, decoded: bool, timer=None):
    """Entropy contexts of two overlapping TSW windows from one query.

    The context is pointwise per anchor (hash features and MLPs), so
    slices of a query over the union window equal the per-window
    contexts.  The union is ``cap + slack`` rows, ``slack = min(max(cap //
    8, 64), capacity - cap)``; when the starts differ by more than the
    slack, the two windows are queried on their own (the starts are host
    integers here, so this is an ``if``, where the JAX package has a
    ``lax.cond``)."""
    capacity = state.anchors.anchor.shape[0]
    slack = min(max(cap // 8, 64), capacity - cap)
    anchor_q = get_anchor(state, decoded)
    if slack <= 0:
        # the window spans the whole buffer: both starts are 0
        ec = calc_entropy_context(state, cfg, anchor_q[s1:s1 + cap],
                                  decoded, timer=timer)
        return [ec, ec]
    s_min = min(max(min(s1, s2), 0), capacity - cap - slack)
    if max(s1, s2) - s_min <= slack:
        ecu = calc_entropy_context(
            state, cfg, anchor_q[s_min:s_min + cap + slack], decoded,
            timer=timer)

        def cut(off):
            return EntropyContext(*(v[off:off + cap] for v in ecu))

        return [cut(s1 - s_min), cut(s2 - s_min)]
    return [calc_entropy_context(state, cfg, anchor_q[s:s + cap], decoded,
                                 timer=timer) for s in (s1, s2)]


class PairRender(NamedTuple):
    """All four views of a frame pair, composited in one launch."""

    images: torch.Tensor          # [4, 3, H, W]: f1 fwd/flip, f2 fwd/flip
    transmittances: torch.Tensor  # [4, H, W]
    renders: tuple                # 4 x RenderResults (the views of a frame
                                  # share generation, radii and window)


def render_pair(state: ModelState, cfg: GaussianConfig, z1: float,
                z2: float, x_min: float, y_min: float, scale: float,
                settings: RasterSettings, window_cap: int,
                mode: GenerateMode,
                generator: Optional[torch.Generator] = None,
                means2d: Optional[torch.Tensor] = None,
                decoded: bool = False, noise=None,
                timer=None) -> PairRender:
    """Render both frames of a training pair in both view directions,
    differentiably, through the mirror composite.

    ``means2d``: optional [4, V*K, 2] zeros whose gradients carry the
    per-view screen gradients (densification statistics).  ``noise``:
    optional per-frame QUANTIZED_NOISE / ENTROPY draws (see
    ``generate_neural_gaussians``); otherwise ``generator`` draws them.
    In the entropy modes both frames' contexts come from one union-window
    query (``_pair_entropy_contexts``).  ``timer`` (optional, with
    ``mark(name)``) is passed to the composite and the hash-grid
    kernels."""
    if not can_mirror(settings):
        raise ValueError(
            f"render_pair composites through the mirror kernels, which "
            f"need a tile-aligned width: {settings.image_width} is not a "
            f"multiple of tile_w {settings.tile_w}")
    mperm = torch.from_numpy(_mirror_tile_perm(settings)).long()
    wins = [window_for_frame(state, cfg, z, window_cap) for z in (z1, z2)]
    ecs = [None, None]
    if mode in (GenerateMode.ENTROPY, GenerateMode.STE_ENTROPY):
        ecs = _pair_entropy_contexts(state, cfg, wins[0][0], wins[1][0],
                                     window_cap, decoded, timer=timer)
    frames, attrs_l, lists_l, counts_l = [], [], [], []
    for fi, z in enumerate((z1, z2)):
        start, in_window = wins[fi]
        gss = generate_neural_gaussians(
            state, cfg, frame_z=z, cam_z=z, window_start=start,
            in_window=in_window, cap=window_cap, mode=mode, decoded=decoded,
            generator=generator,
            noise=None if noise is None else noise[fi],
            entropy_ctx=ecs[fi])
        proj = project_gaussians(gss.xyz, gss.scaling, gss.rot, gss.valid,
                                 z, x_min, y_min, scale, settings)
        tile_lists, counts, dropped, ovf, nrend = _bin_gaussians(proj,
                                                                 settings)
        opacity = torch.where(proj.valid[:, None], gss.opacity,
                              torch.zeros_like(gss.opacity))
        attrs_l.append(attr_rows_from_proj(proj, opacity, gss.color))
        lists_l.append(tile_lists)
        counts_l.append(counts)
        frames.append((gss, start, in_window, proj, ovf, nrend, dropped,
                       dropped[mperm.to(dropped.device)]))
    out4 = mirror_composite_attrs(
        settings, torch.stack(attrs_l), torch.stack(lists_l),
        torch.stack(counts_l), means2d, timer=timer)
    images, ts = assemble_views(settings, out4)

    renders = []
    for fi, vi in ((0, 0), (0, 1), (1, 2), (1, 3)):
        gss, start, in_window, proj, ovf, nrend, dr_f, dr_b = frames[fi]
        renders.append(RenderResults(
            image=images[vi], transmittance=ts[vi], window_start=start,
            in_window=in_window, radii=proj.radius,
            visibility_filter=proj.radius > 0, selection_mask=gss.valid,
            neural_opacity=gss.neural_opacity, scaling=gss.scaling,
            num_rendered=nrend, overflow=ovf, rate=gss.rate, gaussians=gss,
            harmful_overflow=tile_harmful_overflow(
                settings, ts[vi].detach(), dr_f if vi % 2 == 0 else dr_b)))
    return PairRender(images=images, transmittances=ts,
                      renders=tuple(renders))
