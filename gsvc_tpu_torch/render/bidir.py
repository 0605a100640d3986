"""Bidirectional decode composite — kernel B4 of the port.

The decoded frame is the AVERAGE of the forward and x-flipped views
(reference: report_utils.py:412-447).  After un-mirroring, pixel p of
that average is

    out(p) = 1/2 [ sum_i a_i c_i T_i  +  sum_i a_i c_i S_i ]

over the SAME alphas a_i(p) of the forward tile list, with T_i the front
prefix product of (1 - a) and S_i the back suffix product — one alpha
evaluation per (copy, pixel).  A front loop composites the forward view
and accumulates the back view's suffix sum by Horner's rule
(W <- W (1 - a) + a c); it stops at the first chunk boundary where no
pixel of the tile keeps T >= T_EPS.  A back loop then walks from the last
used chunk down to that stop, compositing the flip view until its
transmittance saturates.  Dropped terms carry weight < T_EPS.

``bidir_composite_attrs`` launches the CUDA kernel
(``gsvc_tpu_torch/csrc/bidir.cu``: one thread-block cluster of
``B4_CLUSTER`` CTAs per tile, each CTA a band of the tile's rows, the
tile's chunk stops voted through distributed shared memory, the tiles
launched heaviest first) on CUDA tensors and runs
``bidir_composite_plain`` — the same function in plain PyTorch, tiles
vectorised, chunk by chunk, with the same per-tile loop stops as masks —
on CPU tensors.  Port of ``bidir_composite_attrs`` /
``_fwd_kernel_bidir`` (gsvc_tpu/render/pallas_splat.py:1178, :1074).
Both take the settings' precision modes (``check_precision``; the table
in ``render/mirror.py``): the alpha, and each copy's factor of the front
prefix and back suffix products inside a chunk, with the chunks' totals
float32.
"""

from __future__ import annotations

import ctypes

import torch

from gsvc_tpu_torch.build import load
from gsvc_tpu_torch.render.splat import (
    ALPHA_MAX, ALPHA_MIN, T_EPS, RasterSettings, assemble_views,
)

# kernel limits (csrc/composite.cuh, shared by the compositing kernels):
# a chunk fits the shared-memory stage and every thread of a block owns
# the same number of a tile's pixels
MAX_CHUNK = 128
MAX_PIXELS_PER_THREAD = 16
BLOCK_THREADS = 256
# blocks of one thread a pixel column (every compositing kernel): at least
# COLUMN_THREADS threads, more where the tile is wider or holds more than
# COLUMN_PPT pixels a thread (B2 spills registers at 16)
COLUMN_THREADS = 128
COLUMN_PPT = 8
# kernel B4's launch plan: a cluster of B4_CLUSTER CTAs per tile (halved
# until it divides tile_h), each CTA tile_h / B4_CLUSTER rows of every
# column.  With the tiles launched heaviest first, 2, 4 and 8 CTAs a
# tile ran a decoded 1080p frame equally fast and 2 ran the synthetic
# tiles fastest; one CTA a tile was 1.4x slower on the frame (PERF.md §6).
B4_CLUSTER = 2


def _check_inputs(settings: RasterSettings, attrs, tile_lists, counts):
    # both composites that read the flip view from the forward lists (B4
    # here, B1/B2 in render/mirror.py) need the screen mirror to map tile
    # columns onto tile columns; other widths take render/tile.py (B5)
    if settings.image_width != settings.n_tiles_x * settings.tile_w:
        raise ValueError(
            f"the mirror and bidirectional composites need a tile-aligned "
            f"width: {settings.image_width} is not a multiple of tile_w "
            f"{settings.tile_w}")
    if attrs.dim() != 3 or attrs.shape[2] != 9:
        raise ValueError(f"attrs: expected [F, M, 9], got "
                         f"{tuple(attrs.shape)}")
    f_n = attrs.shape[0]
    for name, t, dtype, shape in (
            ("attrs", attrs, torch.float32, tuple(attrs.shape)),
            ("tile_lists", tile_lists, torch.int32,
             (f_n, settings.n_tiles, settings.gaussian_cap)),
            ("counts", counts, torch.int32, (f_n, settings.n_tiles))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != attrs.device:
            raise ValueError(f"{name} is on {t.device}, attrs on "
                             f"{attrs.device}")
    if settings.gaussian_cap % settings.chunk:
        raise ValueError("gaussian_cap must be a multiple of chunk")


# the precision modes (``RasterSettings.compute_dtype`` / ``matmul_dtype``;
# gsvc_tpu/render/pallas_splat.py ``_chunk_alpha``, ``_matmul_fns``) as
# the bits of the kernels' ``mode`` argument: the alpha in bf16, the
# in-chunk transmittance from bf16 logs, the backward's products on
# bf16-rounded operands (render/mirror.py's docstring has the table)
COMPUTE_DTYPES = ("float32", "bfloat16")
MATMUL_DTYPES = ("float32", "bf16x2", "bfloat16")
ALPHA_BF16, TRANS_BF16, GRAD_BF16 = 1, 2, 4


def check_precision(settings: RasterSettings) -> int:
    """The mode bits of ``settings``.  Every known combination runs
    through every composite (B1/B2, B4, B5f/B5b, B6f/B6b); an unknown
    value raises."""
    cd, md = settings.compute_dtype, settings.matmul_dtype
    if cd not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {cd!r}; expected one of "
                         f"{COMPUTE_DTYPES}")
    if md not in MATMUL_DTYPES:
        raise ValueError(f"unknown matmul_dtype {md!r}; expected one of "
                         f"{MATMUL_DTYPES}")
    mode = ((ALPHA_BF16 if cd == "bfloat16" else 0)
            | (TRANS_BF16 if md == "bfloat16" else 0))
    if mode or md != "float32":
        mode |= GRAD_BF16
    return mode


def forward_precision(settings: RasterSettings) -> int:
    """The mode bits a forward composite takes (B1, B4, B5f, B6f): the
    alpha and in-chunk transmittance bits of ``check_precision`` (a
    forward under bf16x2 is the float32 one)."""
    return check_precision(settings) & (ALPHA_BF16 | TRANS_BF16)


def alpha_raw(r, d0, d1, mode: int):
    """The unclamped alpha [..., C, P] of attribute rows ``r`` [..., C, 9]
    at pixel offsets ``d0``, ``d1`` (pixel minus mean; float32), in
    float32 (FMA-free, the kernels' order) or, with ``ALPHA_BF16`` in
    ``mode``, in JAX's bf16 expression: the deltas and a, b, c, opacity
    rounded to bf16, ``op * exp(-q/2)`` with ``q = a d0 d0 + 2b d0 d1 +
    c d1 d1`` evaluated left to right in bf16, the result widened."""
    if mode & ALPHA_BF16:
        bf = torch.bfloat16
        d0, d1 = d0.to(bf), d1.to(bf)
        a, b, c, op = (r[..., k:k + 1].to(bf) for k in (2, 3, 4, 5))
        q = a * d0 * d0 + 2.0 * b * d0 * d1 + c * d1 * d1
        return (op * torch.exp(-0.5 * q)).float()
    ha, hb, hc = (-0.5 * r[..., 2:3], -0.5 * r[..., 3:4],
                  -0.5 * r[..., 4:5])
    uu = ha * d0 + hb * d1
    vv = hb * d0 + hc * d1
    return r[..., 5:6] * torch.exp(d0 * uu + d1 * vv)


def trans_factor(alpha, one_m, mode: int):
    """Each copy's factor of the in-chunk transmittance: ``1 - alpha``, or
    with ``TRANS_BF16`` in ``mode`` ``exp(bf16(log1p(-alpha)))`` (JAX's
    bf16 log-space cumsum with float32 accumulation, taken as a product
    of the exponentials; the chunk's total stays the float32 product)."""
    if mode & TRANS_BF16:
        return torch.exp(torch.log1p(-alpha).to(torch.bfloat16).float())
    return one_m


def _shape_error(kernels, settings, what):
    return ValueError(
        f"kernels {kernels} take chunk <= {MAX_CHUNK} and {what}, at most "
        f"{BLOCK_THREADS} threads x 2^k pixels (k <= 4); got chunk "
        f"{settings.chunk}, tile {settings.tile_h}x{settings.tile_w}")


def _pixels_ok(settings, p_pix, threads):
    ppt = p_pix // threads
    return (settings.chunk <= MAX_CHUNK and not p_pix % threads
            and ppt <= MAX_PIXELS_PER_THREAD and not ppt & (ppt - 1))


def column_shape(settings: RasterSettings, kernels: str, rows=None,
                 whole_warps: bool = True):
    """(threads a block, pixels a thread) of a block over ``rows`` rows
    of a tile (all of them by default) with one thread a pixel column,
    so a thread's pixels share x (kernels B1/B2, B4's CTAs, B5f/B5b,
    B6f/B6b): a multiple of tile_w, whole warps where the kernel reduces
    over warps (``whole_warps``; B4 does not), at least COLUMN_THREADS, at most
    COLUMN_PPT pixels a thread while BLOCK_THREADS allows; 128 x 8 at
    8x128 tiles, 256 x 8 at 16x128.  ``kernels`` names them in the
    error."""
    tw = settings.tile_w
    p_pix = (settings.tile_h if rows is None else rows) * tw
    threads = min(p_pix, BLOCK_THREADS,
                  max(COLUMN_THREADS, tw, p_pix // COLUMN_PPT))
    if (whole_warps and threads % 32 or threads % tw
            or not _pixels_ok(settings, p_pix, threads)):
        raise _shape_error(kernels, settings, "blocks of whole "
                           + ("warps of columns" if whole_warps
                              else "columns"))
    return threads, p_pix // threads


def bidir_launch_plan(settings: RasterSettings, cluster=None):
    """(CTAs a tile, threads a CTA, pixels a thread) of kernel B4.
    ``cluster`` None takes B4_CLUSTER, halved until it divides tile_h;
    a given size must divide it.  Each CTA is a ``column_shape`` block
    over its band of rows: 2 x 128 x 8 at 16x128 tiles, 2 x 128 x 4 at
    8x128."""
    th = settings.tile_h
    if cluster is None:
        cluster = B4_CLUSTER
        while th % cluster:
            cluster //= 2
    if cluster < 1 or th % cluster:
        raise ValueError(f"kernel B4 splits a tile's {th} rows over its "
                         f"cluster: {cluster} CTAs do not divide them")
    return (cluster, *column_shape(settings, "B4", rows=th // cluster,
                                   whole_warps=False))


def _lib():
    lib = load("bidir")
    fn = lib.bidir_composite
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.restype = ci
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                       ci, ci, ci, ci, ctypes.c_float, vp]
    return lib


def bidir_out4_cuda(settings: RasterSettings, attrs, tile_lists, counts,
                    cluster=None):
    """Launch the kernel once, ``cluster`` CTAs a tile (None: the launch
    plan's; every size gives the same bits), the tiles' clusters in
    falling order of their copies (one sort of the counts on the card).
    Returns [F*T, 4, P] tiles: rows 0:3 the fwd/flip-averaged colour
    (+ bg), row 3 the total transmittance.  A launch the card refuses
    raises, as does a mode the kernel does not take: it never falls back
    to float32."""
    mode = forward_precision(settings)
    _check_inputs(settings, attrs, tile_lists, counts)
    for name, t in (("attrs", attrs), ("tile_lists", tile_lists),
                    ("counts", counts)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    cluster, threads, ppt = bidir_launch_plan(settings, cluster)
    f_n, m, _ = attrs.shape
    p_pix = settings.tile_h * settings.tile_w
    out4 = torch.empty((f_n * settings.n_tiles, 4, p_pix),
                       dtype=torch.float32, device=attrs.device)
    order = torch.argsort(counts.reshape(-1), descending=True,
                          stable=True).to(torch.int32)
    with torch.cuda.device(attrs.device):
        stream = torch.cuda.current_stream(attrs.device).cuda_stream
        err = _lib().bidir_composite(
            attrs.data_ptr(), tile_lists.data_ptr(), counts.data_ptr(),
            order.data_ptr(), out4.data_ptr(), f_n, m, settings.n_tiles,
            settings.n_tiles_x, settings.tile_w, settings.gaussian_cap,
            settings.chunk, cluster, threads, ppt, mode,
            float(settings.bg), stream)
    if err != 0:
        raise RuntimeError(f"bidir_composite launch of {cluster} CTAs a "
                           f"tile failed: CUDA error {err}")
    return out4


def bidir_composite_attrs(settings: RasterSettings, attrs, tile_lists,
                          counts):
    """Fwd/flip-averaged decode composite straight from attribute rows.

    attrs [F, M, 9] float32 (``attr_rows_from_proj`` packing),
    tile_lists [F, T, cap] int32 (-1 padded), counts [F, T] int32.
    Returns ([F, 3, H, W] averaged images, [F, H, W] total
    transmittance).  CUDA tensors launch kernel B4 (and add one to
    ``bidir_composite_attrs.launches``); CPU tensors take the plain
    version; any other device raises.  Both take the settings' precision
    modes (``check_precision``)."""
    check_precision(settings)
    if attrs.is_cuda:
        out4 = bidir_out4_cuda(settings, attrs, tile_lists, counts)
        bidir_composite_attrs.launches += 1
        return assemble_views(settings, out4)
    if attrs.device.type == "cpu":
        return bidir_composite_plain(settings, attrs, tile_lists, counts)
    raise ValueError(f"bidir_composite_attrs: unsupported device "
                     f"{attrs.device}")


bidir_composite_attrs.launches = 0


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _excl_cumprod(x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Exclusive product along dim 1 (prefix, or suffix if ``reverse``)."""
    if reverse:
        return _excl_cumprod(x.flip(1), False).flip(1)
    incl = torch.cumprod(x, dim=1)
    return torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)


def bidir_out4_plain(settings: RasterSettings, attrs, tile_lists, counts):
    """The kernel's function in plain PyTorch.  Returns ([F*T, 4, P]
    tiles, number of (copy, pixel) pairs the loops evaluated — real
    copies only).  The precision modes as in ``render/mirror.py``'s table:
    the alpha (``alpha_raw``) and each copy's in-chunk factor
    (``trans_factor``) of the front product and the back suffix product;
    the chunk totals stay float32."""
    mode = check_precision(settings)
    _check_inputs(settings, attrs, tile_lists, counts)
    f_n, m, _ = attrs.shape
    t_n, cap, chunk = settings.n_tiles, settings.gaussian_cap, settings.chunk
    th, tw = settings.tile_h, settings.tile_w
    n_chunks, p_pix, ft = cap // chunk, th * tw, f_n * t_n
    dev = attrs.device

    lists = tile_lists.reshape(ft, cap).long()
    cnt = counts.reshape(ft).long()
    g = torch.arange(ft, device=dev)
    u = g % t_n
    cx = ((u % settings.n_tiles_x) * tw).float() + (tw - 1) / 2.0
    cy = ((u // settings.n_tiles_x) * th).float() + (th - 1) / 2.0
    lin = torch.arange(p_pix, device=dev)
    xs = (lin % tw).float() - (tw - 1) / 2.0
    ys = (lin // tw).float() - (th - 1) / 2.0
    n_used = torch.clamp((cnt + chunk - 1) // chunk, max=n_chunks)

    # padding ids read row 0 with opacity forced to 0 (alpha 0)
    rows = attrs.reshape(f_n * m, 9)[(g // t_n)[:, None] * m
                                     + lists.clamp_min(0)]   # [FT, cap, 9]
    rows[..., 5] = torch.where(lists >= 0, rows[..., 5],
                               torch.zeros_like(rows[..., 5]))

    def chunk_alpha(c, sel):
        """alpha [S, C, P] and colours [S, C, 3] of chunk c, tiles sel."""
        r = rows[sel, c * chunk:(c + 1) * chunk]
        mu_x = r[..., 0] - cx[sel, None]
        mu_y = r[..., 1] - cy[sel, None]
        d0 = xs - mu_x[..., None]
        d1 = ys - mu_y[..., None]
        alpha = torch.clamp(alpha_raw(r, d0, d1, mode), max=ALPHA_MAX)
        alpha = torch.where(alpha >= ALPHA_MIN, alpha,
                            torch.zeros_like(alpha))
        return alpha, r[..., 6:9]

    def real_copies(c, sel):
        return torch.clamp(cnt[sel] - c * chunk, 0, chunk)

    ones = torch.ones(ft, p_pix, device=dev)
    t_f, t_b = ones.clone(), ones.clone()
    acc_f = torch.zeros(ft, 3, p_pix, device=dev)
    acc_h, acc_b = acc_f.clone(), acc_f.clone()
    p_stop = torch.zeros(ft, dtype=torch.long, device=dev)
    pairs = torch.zeros((), dtype=torch.long, device=dev)

    # front loop: a tile runs chunk c while c < n_used and some pixel
    # keeps T >= T_EPS (checked at chunk boundaries, like the kernel)
    alive = torch.ones(ft, dtype=torch.bool, device=dev)
    for c in range(n_chunks):
        alive &= (c < n_used) & (t_f.amax(dim=1) >= T_EPS)
        sel = alive.nonzero().squeeze(1)
        if sel.numel() == 0:
            break
        alpha, cols = chunk_alpha(c, sel)
        one_m = 1.0 - alpha
        fac = trans_factor(alpha, one_m, mode)
        colst = cols.transpose(1, 2)                     # [S, 3, C]
        t_before = t_f[sel, None, :] * _excl_cumprod(fac, False)
        w_f = torch.where(t_before >= T_EPS, alpha * t_before,
                          torch.zeros_like(alpha))
        chunk_t = torch.prod(one_m, dim=1)               # [S, P]
        acc_f[sel] += torch.bmm(colst, w_f)
        acc_h[sel] = acc_h[sel] * chunk_t[:, None] + torch.bmm(
            colst, alpha * _excl_cumprod(fac, True))
        t_f[sel] *= chunk_t
        p_stop[sel] += 1
        pairs += real_copies(c, sel).sum()

    # back loop: from n_used - 1 down while c >= p_stop and some pixel
    # keeps S >= T_EPS
    alive = torch.ones(ft, dtype=torch.bool, device=dev)
    for c in range(n_chunks - 1, -1, -1):
        started = c < n_used
        alive &= ~started | ((c >= p_stop) & (t_b.amax(dim=1) >= T_EPS))
        sel = (alive & started).nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        alpha, cols = chunk_alpha(c, sel)
        one_m = 1.0 - alpha
        s_before = t_b[sel, None, :] * _excl_cumprod(
            trans_factor(alpha, one_m, mode), True)
        w_b = torch.where(s_before >= T_EPS, alpha * s_before,
                          torch.zeros_like(alpha))
        acc_b[sel] += torch.bmm(cols.transpose(1, 2), w_b)
        t_b[sel] *= torch.prod(one_m, dim=1)
        pairs += real_copies(c, sel).sum()

    tau = t_f * t_b
    avg = 0.5 * (acc_f + acc_b + acc_h * t_b[:, None])
    out4 = torch.cat([avg + tau[:, None] * settings.bg, tau[:, None]], dim=1)
    return out4, int(pairs) * p_pix


def bidir_composite_plain(settings: RasterSettings, attrs, tile_lists,
                          counts):
    """Plain PyTorch ``bidir_composite_attrs`` (any device)."""
    out4, _ = bidir_out4_plain(settings, attrs, tile_lists, counts)
    return assemble_views(settings, out4)
