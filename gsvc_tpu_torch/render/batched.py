"""Frame rendering for decode and training (port of
gsvc_tpu/render/batched.py: ``can_mirror``, ``_mirror_tile_perm``,
``flip_tile_lists``, ``flip_attr_rows``, ``_frame_views``,
``_composite_concat``, ``render_frame_views``, ``render_frame_bidir``,
``_pair_entropy_contexts`` and ``render_pair``).

Decode, one frame: TSW window -> neural gaussians -> projection ->
binning -> the bidirectional composite (kernel B4).  Training, a frame
pair: one generation per frame, then all four views (both frames, forward
and x-mirrored) in one composite launch.  When the frame width is a
multiple of ``tile_w`` the screen mirror maps tile columns onto tile
columns, and the flip views are composited from the forward views' lists
(kernels B1 and B2; decode: B4) or, with ``rasterizer="pallas_stream"``,
from the forward views' chunk-aligned copy stream (kernels B6f and B6b;
``render_frame_views``: B6f).  Otherwise the flip view of each frame is
projected and binned on its own and the views' planes go through the
single-view composite (kernels B5f and B5b; decode: ``render_frame_views``,
B5f), whatever the rasterizer.  CUDA tensors launch the kernels, CPU
tensors take their plain versions.
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
from gsvc_tpu_torch.render.pipeline import RenderResults, check_rasterizer
from gsvc_tpu_torch.render.splat import (
    RasterSettings, _bin_gaussians, assemble_views, attr_rows_from_proj,
    bin_gaussians_stream, gather_tile_planes_rows, project_gaussians,
    tile_harmful_overflow,
)
from gsvc_tpu_torch.render.stream import (
    concat_stream_bins, stream_composite_attrs, stream_composite_inference,
)
from gsvc_tpu_torch.render.tile import (
    composite_tiles_inference, tile_composite,
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


def flip_tile_lists(tile_lists, tile_counts, settings: RasterSettings):
    """The flip view's [T, cap] id lists from the forward ones (integer
    work only): mirror the tile axis and reverse each tile's depth order
    within its count."""
    perm = torch.from_numpy(_mirror_tile_perm(settings)).long().to(
        tile_lists.device)
    counts_f = tile_counts[perm]
    lists_m = tile_lists[perm]
    j = torch.arange(settings.gaussian_cap, dtype=torch.int32,
                     device=tile_lists.device)[None, :]
    rev = torch.where(j < counts_f[:, None], counts_f[:, None] - 1 - j, j)
    return torch.gather(lists_m, 1, rev.long()), counts_f


def flip_attr_rows(attr_fwd, settings: RasterSettings, means2d_flip=None):
    """Per-gaussian attribute rows of the x-flipped view from the forward
    ones: mirror the x mean, negate the conic cross term.  ``means2d_flip``
    ([M, 2], normally zeros) is added in the flip view's own screen
    coordinates, so its gradient is that view's screen gradient."""
    w_span = settings.n_tiles_x * settings.tile_w
    mux = (w_span - 1) - attr_fwd[:, 0]
    muy = attr_fwd[:, 1]
    if means2d_flip is not None:
        mux = mux + means2d_flip[:, 0]
        muy = muy + means2d_flip[:, 1]
    return torch.cat([mux[:, None], muy[:, None], attr_fwd[:, 2:3],
                      -attr_fwd[:, 3:4], attr_fwd[:, 4:9]], dim=1)


def _frame_views(gss, frame_z: float, x_min: float, y_min: float,
                 scale: float, settings: RasterSettings, m2d_fwd, m2d_flip):
    """Planes and counts of the forward and flip views of one frame, plus
    the forward projection (radii are mirror-invariant).  Returns (planes_f,
    counts_f, planes_b, counts_b, proj, overflow, n_rendered, dropped_f,
    dropped_b).

    The forward projection takes no ``means2d``: each view's zero tensor is
    added to its own attribute rows (``m2d_fwd`` to the forward rows,
    ``m2d_flip`` to the flip projection), so neither view's screen gradient
    leaks into the other's."""
    proj = project_gaussians(gss.xyz, gss.scaling, gss.rot, gss.valid,
                             frame_z, x_min, y_min, scale, settings)
    opacity = torch.where(proj.valid[:, None], gss.opacity,
                          torch.zeros_like(gss.opacity))
    tile_lists, counts, dropped, overflow, n_rendered = _bin_gaussians(
        proj, settings)
    attr_base = attr_rows_from_proj(proj, opacity, gss.color)
    attr_fwd = attr_base
    if m2d_fwd is not None:
        attr_fwd = torch.cat([attr_base[:, :2] + m2d_fwd, attr_base[:, 2:]],
                             dim=1)
    planes_f = gather_tile_planes_rows(attr_fwd, tile_lists)
    if can_mirror(settings):
        lists_b, counts_b = flip_tile_lists(tile_lists, counts, settings)
        planes_b = gather_tile_planes_rows(
            flip_attr_rows(attr_base, settings, m2d_flip), lists_b)
        # the flip view drops the same copies, in mirrored tile order
        dropped_b = dropped[torch.from_numpy(
            _mirror_tile_perm(settings)).long().to(dropped.device)]
    else:
        # the mirror is inexact: project and bin the flip view on its own
        proj_b = project_gaussians(gss.xyz, gss.scaling, gss.rot, gss.valid,
                                   frame_z, x_min, y_min, scale, settings,
                                   flip=True, means2d=m2d_flip)
        opacity_b = torch.where(proj_b.valid[:, None], gss.opacity,
                                torch.zeros_like(gss.opacity))
        lists_b, counts_b, dropped_b, ovf_b, _ = _bin_gaussians(proj_b,
                                                                settings)
        planes_b = gather_tile_planes_rows(
            attr_rows_from_proj(proj_b, opacity_b, gss.color), lists_b)
        overflow = overflow + ovf_b
    return (planes_f, counts, planes_b, counts_b, proj, overflow,
            n_rendered, dropped, dropped_b)


def _composite_concat(settings: RasterSettings, planes_all, counts_all,
                      inference: bool, timer=None):
    """Composite concatenated-view planes through B5f (and, in training,
    B5b); returns ([V, 3, H, W] images, [V, H, W] transmittances)."""
    if inference:
        out4 = composite_tiles_inference(settings, planes_all, counts_all)
    else:
        out4 = tile_composite(settings, planes_all, counts_all, timer=timer)
    return assemble_views(settings, out4)


def render_frame_views(state: ModelState, cfg: GaussianConfig,
                       frame_z: float, x_min: float, y_min: float,
                       scale: float, settings: RasterSettings,
                       window_cap: int,
                       mode: GenerateMode = GenerateMode.FULL_PRECISION,
                       decoded: bool = False, inference: bool = False,
                       generator: Optional[torch.Generator] = None,
                       rasterizer: str = ""):
    """The forward and flipped views of one frame from one generation, in
    one composite launch: at tile-aligned widths the mirror composite (B1)
    or, with ``rasterizer="pallas_stream"``, the stream composite (B6f;
    its training form with ``inference=False``), else both views' planes
    through B5f.

    Returns (averaged image [3, H, W], images [2, 3, H, W], ts [2, H, W],
    aux = (gaussians, window start, in_window, radii, overflow,
    n_rendered))."""
    check_rasterizer(rasterizer)
    start, in_window = window_for_frame(state, cfg, frame_z, window_cap)
    gss = generate_neural_gaussians(
        state, cfg, frame_z=frame_z, cam_z=frame_z, window_start=start,
        in_window=in_window, cap=window_cap, mode=mode, decoded=decoded,
        generator=generator)
    if can_mirror(settings):
        proj = project_gaussians(gss.xyz, gss.scaling, gss.rot, gss.valid,
                                 frame_z, x_min, y_min, scale, settings)
        opacity = torch.where(proj.valid[:, None], gss.opacity,
                              torch.zeros_like(gss.opacity))
        attrs = attr_rows_from_proj(proj, opacity, gss.color)[None]
        if rasterizer == "pallas_stream":
            sb = bin_gaussians_stream(proj, settings)
            ovf, nrend = sb.overflow, sb.n_rendered
            compose = (stream_composite_inference if inference
                       else stream_composite_attrs)
            out4 = compose(settings, attrs,
                           *concat_stream_bins([sb], settings))
        else:
            tile_lists, counts, _, ovf, nrend = _bin_gaussians(proj,
                                                               settings)
            out4 = mirror_composite_attrs(settings, attrs, tile_lists[None],
                                          counts[None])
        images, ts = assemble_views(settings, out4)
    else:
        pf, cf, pb, cb, proj, ovf, nrend, _, _ = _frame_views(
            gss, frame_z, x_min, y_min, scale, settings, None, None)
        images, ts = _composite_concat(
            settings, tuple(torch.cat([pf[i], pb[i]]) for i in range(9)),
            torch.cat([cf, cb]), inference)
    avg = (images[0] + images[1].flip(-1)) / 2.0
    return avg, images, ts, (gss, start, in_window, proj.radius, ovf,
                             nrend)


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
    """The fwd/flip-averaged frame in one composite pass (kernel B4).

    Returns (image [3, H, W], total transmittance [H, W], FrameSplats).
    At a width that is not a multiple of ``tile_w`` it falls back to
    ``render_frame_views`` (both views through B5f) and returns (its
    averaged image, the forward view's transmittance, its aux)."""
    if not can_mirror(settings):
        avg, _, ts, aux = render_frame_views(
            state, cfg, frame_z, x_min, y_min, scale, settings, window_cap,
            mode=mode, decoded=decoded, inference=True)
        return avg, ts[0], aux
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
                timer=None, rasterizer: str = "") -> PairRender:
    """Render both frames of a training pair in both view directions,
    differentiably, in one composite launch: at tile-aligned widths the
    mirror composite (B1/B2) or, with ``rasterizer="pallas_stream"``, the
    stream composite (B6f/B6b) over both frames' chunk-aligned copy
    streams; else the single-view composite (B5f/B5b) over the four views'
    planes, each flip view projected and binned on its own.

    ``means2d``: optional [4, V*K, 2] zeros whose gradients carry the
    per-view screen gradients (densification statistics).  ``noise``:
    optional per-frame QUANTIZED_NOISE / ENTROPY draws (see
    ``generate_neural_gaussians``); otherwise ``generator`` draws them.
    In the entropy modes both frames' contexts come from one union-window
    query (``_pair_entropy_contexts``).  ``timer`` (optional, with
    ``mark(name)``) is passed to the composite and the hash-grid
    kernels."""
    check_rasterizer(rasterizer)
    wins = [window_for_frame(state, cfg, z, window_cap) for z in (z1, z2)]
    ecs = [None, None]
    if mode in (GenerateMode.ENTROPY, GenerateMode.STE_ENTROPY):
        ecs = _pair_entropy_contexts(state, cfg, wins[0][0], wins[1][0],
                                     window_cap, decoded, timer=timer)
    gens = []
    for fi, z in enumerate((z1, z2)):
        start, in_window = wins[fi]
        gens.append((generate_neural_gaussians(
            state, cfg, frame_z=z, cam_z=z, window_start=start,
            in_window=in_window, cap=window_cap, mode=mode, decoded=decoded,
            generator=generator,
            noise=None if noise is None else noise[fi],
            entropy_ctx=ecs[fi]), start, in_window))

    if can_mirror(settings):
        use_stream = rasterizer == "pallas_stream"
        mperm = torch.from_numpy(_mirror_tile_perm(settings)).long()
        frames, attrs_l, bins = [], [], []
        for (gss, start, in_window), z in zip(gens, (z1, z2)):
            proj = project_gaussians(gss.xyz, gss.scaling, gss.rot,
                                     gss.valid, z, x_min, y_min, scale,
                                     settings)
            opacity = torch.where(proj.valid[:, None], gss.opacity,
                                  torch.zeros_like(gss.opacity))
            attrs_l.append(attr_rows_from_proj(proj, opacity, gss.color))
            if use_stream:
                sb = bin_gaussians_stream(proj, settings)
                bins.append(sb)
                dropped, ovf, nrend = sb.dropped, sb.overflow, sb.n_rendered
            else:
                tile_lists, counts, dropped, ovf, nrend = _bin_gaussians(
                    proj, settings)
                bins.append((tile_lists, counts))
            frames.append((gss, start, in_window, proj, ovf, nrend, dropped,
                           dropped[mperm.to(dropped.device)]))
        attrs = torch.stack(attrs_l)
        if use_stream:
            out4 = stream_composite_attrs(
                settings, attrs, *concat_stream_bins(bins, settings),
                means2d, timer=timer)
        else:
            out4 = mirror_composite_attrs(
                settings, attrs, torch.stack([b[0] for b in bins]),
                torch.stack([b[1] for b in bins]), means2d, timer=timer)
        images, ts = assemble_views(settings, out4)
    else:
        m2 = (lambda i: None) if means2d is None else (lambda i: means2d[i])
        frames, planes_l, counts_l = [], [], []
        for fi, ((gss, start, in_window), z) in enumerate(zip(gens,
                                                              (z1, z2))):
            pf, cf, pb, cb, proj, ovf, nrend, dr_f, dr_b = _frame_views(
                gss, z, x_min, y_min, scale, settings, m2(2 * fi),
                m2(2 * fi + 1))
            planes_l += [pf, pb]
            counts_l += [cf, cb]
            frames.append((gss, start, in_window, proj, ovf, nrend, dr_f,
                           dr_b))
        images, ts = _composite_concat(
            settings, tuple(torch.cat([p[i] for p in planes_l])
                            for i in range(9)),
            torch.cat(counts_l), inference=False, timer=timer)

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
