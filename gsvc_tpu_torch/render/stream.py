"""Stream compositing — kernels B6f (forward) and B6b (backward) of the
port, their plain PyTorch versions, and the autograd function
``stream_composite_attrs`` around them.

Port of ``gsvc_tpu/render/pallas_stream.py`` (``_fwd_kernel_stream``
:103, ``_bwd_kernel_stream`` :172, ``stream_composite_attrs`` /
``_sca_bwd`` :411-472, ``stream_composite_inference`` :475,
``concat_stream_bins`` :485).

Both views of F frames are composited straight from the chunk-aligned,
depth-sorted copy stream of ``render/splat.py:bin_gaussians_stream``:
every (frame, tile) owns ``nblk`` consecutive blocks of ``chunk`` slots,
so the work and memory follow the copies actually binned instead of
``tiles x gaussian_cap``.  The stream rows are ``[9, F*S_MAX]`` (mean
x/y, conic a/b/c, opacity, rgb; dead slots all zero, so their alpha is
exactly 0): the TPU kernel's 16-row padding is a sublane layout.

One step per (data tile, view), in the mirror composite's order
(``render/mirror.py:grid_rows``): the forward view walks the tile's
blocks front to back; the flip view walks them back to front, each
block's copies bottom-up, at negated tile-centred x, and writes the
mirrored output tile ``u + (ntx-1) - 2(u % ntx)``.  Output rows are in
view order (f0 fwd, f0 flip, f1 fwd, f1 flip).  Training saves the
transmittance at the start of every block, per view: ``t_chk [2,
F*B_MAX, P]`` (blocks after a tile's early stop hold its final T; JAX's
extra trash row is TPU plumbing).  The backward gives every (view,
slot) its 9 attribute gradients in ``[2, 9, F*S_MAX]``; the kernel
replays each view's blocks forward from the checkpoints with the suffix
taken from the forward's ``out4`` (B2's replay), the plain version
walks them in reverse from the final T.  The two views'
sum, the per-view mean columns of ``m2d`` and the scatter to ``[F, M,
9]`` rows are one ``index_add_`` after the kernel, dead slots going to
scratch rows.

The plain versions run ``render/mirror.py``'s ``composite_rows`` /
``backward_rows`` over a stream view of the tiles, locating each tile's
blocks from ``blk_tile`` / ``blk_cc`` where the kernels take the
exclusive cumsum of ``nblk``: both stop on the same blocks.  The kernels
walk a block only up to its live slots (``block_live``), which are a
prefix of it; the padding after them has opacity 0.  Both kernels and
both plain versions take the settings' precision modes
(``compute_dtype`` / ``matmul_dtype``; ``check_precision``, the table in
``render/mirror.py``), as B1/B2 do: the forward the alpha and the
in-chunk transmittance bits (a block's factors; the checkpoints and the
carry between blocks stay the float32 product), the backward every bit.
A mode the kernel does not take fails its launch, which raises.
"""

from __future__ import annotations

import ctypes

import torch

from gsvc_tpu_torch.build import load
from gsvc_tpu_torch.render import mirror
from gsvc_tpu_torch.render.bidir import (
    check_precision, column_shape, forward_precision,
)
from gsvc_tpu_torch.render.splat import RasterSettings

N_ATTR = 9
# scratch rows per frame that the dead slots' gradients land in (one per
# slot position modulo this, so their zero adds do not pile onto one row)
SCRATCH_ROWS = 1024


def concat_stream_bins(sbs, settings: RasterSettings):
    """Frame-concatenate ``StreamBins``: (sids [F, S_MAX], blk_tile [F*B],
    blk_cc [F*B], nblk [F*T]), tiles offset by ``f * n_tiles``."""
    t_n = settings.n_tiles
    sids = torch.stack([sb.ids for sb in sbs])
    blk_tile = torch.cat([
        torch.where(sb.blk_tile >= 0, sb.blk_tile + f * t_n, sb.blk_tile)
        for f, sb in enumerate(sbs)])
    blk_cc = torch.cat([sb.blk_cc for sb in sbs])
    nblk = torch.cat([sb.nblk for sb in sbs])
    return sids, blk_tile, blk_cc, nblk


def stream_from_tile_lists(settings: RasterSettings, tile_lists, counts,
                           b_max: int):
    """The chunk-aligned stream of given per-tile lists, laid out as
    ``concat_stream_bins`` of ``bin_gaussians_stream`` lays out the same
    lists: tile_lists [F, T, cap] int32 (-1 padded), counts [F, T] int32
    and the per-frame block bound ``b_max`` -> (sids [F, b_max * chunk],
    blk_tile [F*b_max], blk_cc [F*b_max], nblk [F*T]).  (The kernels'
    card tests and the smoke build streams from synthetic lists.)"""
    f_n, t_n, cap = tile_lists.shape
    chunk, dev = settings.chunk, tile_lists.device
    i32 = torch.int32
    nblk = torch.clamp((counts + chunk - 1) // chunk, min=1)
    blk_end = torch.cumsum(nblk, 1, dtype=i32)
    if int(blk_end[:, -1].max()) > b_max:
        raise ValueError(f"the lists need {int(blk_end[:, -1].max())} "
                         f"blocks per frame, more than b_max {b_max}")
    b = torch.arange(b_max, dtype=i32, device=dev).expand(f_n, b_max)
    d = torch.clamp(torch.searchsorted(blk_end, b.contiguous(), right=True),
                    max=t_n - 1)
    live = b < blk_end[:, -1:]
    cc = b - torch.gather(blk_end - nblk, 1, d)
    frame = torch.arange(f_n, device=dev)[:, None]
    blk_tile = torch.where(live, (d + frame * t_n).to(i32),
                           torch.full_like(b, -1))
    blk_cc = torch.where(live, cc, torch.zeros_like(cc))
    j = blk_cc[..., None].long() * chunk + torch.arange(chunk, device=dev)
    dd = d[..., None].expand_as(j)
    ok = live[..., None] & (j < counts[frame[..., None], dd])
    ids = tile_lists[frame[..., None], dd, torch.clamp(j, max=cap - 1)]
    sids = torch.where(ok, ids, torch.full_like(ids, -1))
    return (sids.reshape(f_n, b_max * chunk), blk_tile.reshape(-1),
            blk_cc.reshape(-1), nblk.reshape(-1).to(i32))


def check_stream(settings: RasterSettings, rows, sids, blk_tile, blk_cc,
                 nblk):
    """Validate the stream composite's inputs (the precision modes among
    them); returns (F, B_MAX)."""
    check_precision(settings)
    if settings.image_width != settings.n_tiles_x * settings.tile_w:
        raise ValueError(
            f"the stream composite mirrors the tile columns: width "
            f"{settings.image_width} is not a multiple of tile_w "
            f"{settings.tile_w}")
    if settings.gaussian_cap % settings.chunk:
        raise ValueError("gaussian_cap must be a multiple of chunk")
    if sids.dim() != 2 or sids.shape[1] % settings.chunk:
        raise ValueError(f"sids: expected [F, B_MAX * chunk], got "
                         f"{tuple(sids.shape)}")
    f_n, b_max = sids.shape[0], sids.shape[1] // settings.chunk
    for name, t, dtype, shape in (
            ("rows", rows, torch.float32, (N_ATTR, f_n * sids.shape[1])),
            ("sids", sids, torch.int32, tuple(sids.shape)),
            ("blk_tile", blk_tile, torch.int32, (f_n * b_max,)),
            ("blk_cc", blk_cc, torch.int32, (f_n * b_max,)),
            ("nblk", nblk, torch.int32, (f_n * settings.n_tiles,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != rows.device:
            raise ValueError(f"{name} is on {t.device}, rows on "
                             f"{rows.device}")
    return f_n, b_max


def stream_rows(attrs, sids, m2d=None):
    """attrs [F, M, 9] + sids [F, S_MAX] -> stream rows [9, F*S_MAX]: each
    slot's gaussian row, zeros on dead slots.  ``m2d`` [2F, M, 2]: the
    forward views' ``m2d[2f]`` is added to frame f's mean columns."""
    f_n, m, _ = attrs.shape
    a = attrs
    if m2d is not None:
        a = torch.cat([a[..., :2] + m2d[0::2], a[..., 2:]], dim=-1)
    frame = torch.arange(f_n, device=sids.device)[:, None] * m
    idx = (sids.clamp_min(0).long() + frame).reshape(-1)
    rows = a.reshape(f_n * m, N_ATTR)[idx]
    rows = torch.where((sids >= 0).reshape(-1, 1), rows,
                       torch.zeros_like(rows))
    return rows.T.contiguous()


def block_starts(settings: RasterSettings, nblk, b_max: int):
    """First stream block of every (frame, tile): the exclusive cumsum of
    ``nblk`` within each frame plus ``f * B_MAX``."""
    nb = nblk.reshape(-1, settings.n_tiles)
    frame = torch.arange(nb.shape[0], dtype=torch.int32,
                         device=nblk.device)[:, None] * b_max
    return (torch.cumsum(nb, 1, dtype=torch.int32) - nb + frame).reshape(-1)


def block_live(settings: RasterSettings, sids):
    """Live slots of every stream block [F*B_MAX] int32.  A tile's copies
    fill its span from its first slot on, so a block's live slots are a
    prefix of it, and the kernels walk a block only that far."""
    return (sids.reshape(-1, settings.chunk) >= 0).sum(dim=1,
                                                       dtype=torch.int32)


def launch_shape(settings: RasterSettings):
    """(threads a block, pixels a thread) of kernels B6f/B6b: one thread a
    pixel column, whole warps (``column_shape``, B1/B2's)."""
    return column_shape(settings, "B6f/B6b")


# ---------------------------------------------------------------------------
# Kernel launchers (CUDA tensors)
# ---------------------------------------------------------------------------

def _fn(lib: str, name: str, n_ptrs: int):
    fn = getattr(load(lib), name)
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.restype = ci
        fn.argtypes = [vp] * n_ptrs + [ci] * 9 + [ctypes.c_float, vp]
    return fn


def _launch(fn, settings, f_n, b_max, ptrs, device, mode):
    """One launch of ``fn`` in precision ``mode`` (``check_precision``'s
    bits); a mode the kernel does not take fails the launch, which raises:
    no wrapper falls back to float32."""
    threads, ppt = launch_shape(settings)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, f_n, settings.n_tiles, settings.n_tiles_x,
                 settings.tile_w, settings.chunk, b_max, threads, ppt, mode,
                 float(settings.bg), stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch in mode {mode} failed: "
                           f"CUDA error {err}")


def stream_fwd_cuda(settings: RasterSettings, rows, sids, blk_tile, blk_cc,
                    nblk, save_tchk: bool = True):
    """Launch kernel B6f once.  Returns (out4 [2F*T, 4, P], t_chk [2,
    F*B_MAX, P] or None)."""
    f_n, b_max = check_stream(settings, rows, sids, blk_tile, blk_cc, nblk)
    first = block_starts(settings, nblk, b_max)
    nlive = block_live(settings, sids)
    mirror._require_contiguous(rows=rows, nblk=nblk)
    dev = rows.device
    p_pix = settings.tile_h * settings.tile_w
    out4 = torch.empty((2 * f_n * settings.n_tiles, 4, p_pix),
                       dtype=torch.float32, device=dev)
    t_chk = torch.zeros((2, f_n * b_max, p_pix), dtype=torch.float32,
                        device=dev) if save_tchk else None
    _launch(_fn("stream_fwd", "stream_forward", 6), settings, f_n, b_max,
            (rows.data_ptr(), nblk.data_ptr(), first.data_ptr(),
             nlive.data_ptr(), out4.data_ptr(),
             t_chk.data_ptr() if save_tchk else None), dev,
            forward_precision(settings))
    return out4, t_chk


def stream_bwd_cuda(settings: RasterSettings, rows, sids, blk_tile, blk_cc,
                    nblk, out4, t_chk, g_out):
    """Launch kernel B6b once.  Returns per-slot gradients [2, 9,
    F*S_MAX] (view 0 forward, view 1 flip; zeros on dead, padding and
    saturated slots, which the kernel does not write)."""
    f_n, b_max = check_stream(settings, rows, sids, blk_tile, blk_cc, nblk)
    first = block_starts(settings, nblk, b_max)
    nlive = block_live(settings, sids)
    p_pix = settings.tile_h * settings.tile_w
    n_out = 2 * f_n * settings.n_tiles
    for name, t, shape in (("out4", out4, (n_out, 4, p_pix)),
                           ("t_chk", t_chk, (2, f_n * b_max, p_pix)),
                           ("g_out", g_out, (n_out, 4, p_pix))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    mirror._require_contiguous(rows=rows, nblk=nblk, out4=out4,
                               t_chk=t_chk, g_out=g_out)
    grads = torch.zeros((2, N_ATTR, rows.shape[1]), dtype=torch.float32,
                        device=rows.device)
    _launch(_fn("stream_bwd", "stream_backward", 8), settings, f_n, b_max,
            (rows.data_ptr(), nblk.data_ptr(), first.data_ptr(),
             nlive.data_ptr(), out4.data_ptr(), t_chk.data_ptr(),
             g_out.data_ptr(), grads.data_ptr()),
            rows.device, check_precision(settings))
    return grads


# ---------------------------------------------------------------------------
# Wrappers: kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------

def stream_forward(settings: RasterSettings, rows, sids, blk_tile, blk_cc,
                   nblk, save_tchk: bool = True):
    """(out4, t_chk or None) of the stream composite.  CUDA tensors launch
    kernel B6f (and add one to ``stream_forward.launches``); CPU tensors
    take the plain version; any other device raises."""
    if rows.is_cuda:
        res = stream_fwd_cuda(settings, rows, sids, blk_tile, blk_cc, nblk,
                              save_tchk)
        stream_forward.launches += 1
        return res
    if rows.device.type == "cpu":
        out4, t_chk, _ = stream_fwd_plain(settings, rows, sids, blk_tile,
                                          blk_cc, nblk)
        return out4, (t_chk if save_tchk else None)
    raise ValueError(f"stream_forward: unsupported device {rows.device}")


stream_forward.launches = 0


def stream_backward(settings: RasterSettings, rows, sids, blk_tile, blk_cc,
                    nblk, out4, t_chk, g_out):
    """Per-slot gradients [2, 9, F*S_MAX].  CUDA tensors launch kernel B6b
    (and add one to ``stream_backward.launches``); CPU tensors take the
    plain version; any other device raises."""
    if rows.is_cuda:
        res = stream_bwd_cuda(settings, rows, sids, blk_tile, blk_cc, nblk,
                              out4, t_chk, g_out)
        stream_backward.launches += 1
        return res
    if rows.device.type == "cpu":
        grads, _ = stream_bwd_plain(settings, rows, sids, blk_tile, blk_cc,
                                    nblk, out4, t_chk, g_out)
        return grads
    raise ValueError(f"stream_backward: unsupported device {rows.device}")


stream_backward.launches = 0


def scatter_stream_grads(grads, sids, m: int, per_view: bool):
    """Per-slot gradients [2, 9, F*S_MAX] -> (d_attrs [F, M, 9], d_m2d
    [2F, M, 2] or None) by one ``index_add_``.

    The two views of a slot add into its gaussian's 9 attribute columns;
    with ``per_view`` each view's mean columns also go to its own m2d
    rows — the flip view's screen x is mirrored, so its x gradient is
    negated.  Dead slots go to scratch rows that are dropped."""
    f_n, s_max = sids.shape
    g0, g1 = grads[0], grads[1]
    cols = [g0 + g1]
    if per_view:
        cols.append(torch.stack([g0[0], g0[1], -g1[0], g1[1]]))
    src = torch.cat(cols).T.contiguous()                  # [F*S, C]
    n_scr = min(s_max, SCRATCH_ROWS)
    q = torch.arange(s_max, device=sids.device)
    dest = torch.where(sids >= 0, sids.long(), m + q % n_scr) \
        + torch.arange(f_n, device=sids.device)[:, None] * (m + n_scr)
    out = torch.zeros((f_n * (m + n_scr), src.shape[1]), dtype=src.dtype,
                      device=src.device)
    out.index_add_(0, dest.reshape(-1), src)
    out = out.reshape(f_n, m + n_scr, -1)[:, :m]
    d_attrs = out[..., :N_ATTR]
    if not per_view:
        return d_attrs, None
    d_m2d = out[..., 9:13].reshape(f_n, m, 2, 2).permute(0, 2, 1, 3)
    return d_attrs, d_m2d.reshape(2 * f_n, m, 2)


class _StreamComposite(torch.autograd.Function):

    @staticmethod
    def forward(ctx, settings, attrs, sids, blk_tile, blk_cc, nblk, m2d,
                timer):
        rows = stream_rows(attrs, sids, m2d)
        if timer is not None:
            timer.mark("b6f_start")
        out4, t_chk = stream_forward(settings, rows, sids, blk_tile, blk_cc,
                                     nblk)
        if timer is not None:
            timer.mark("b6f_end")
        ctx.settings, ctx.timer = settings, timer
        ctx.m, ctx.per_view = attrs.shape[1], m2d is not None
        ctx.save_for_backward(rows, sids, blk_tile, blk_cc, nblk, out4,
                              t_chk)
        return out4

    @staticmethod
    def backward(ctx, g_out):
        rows, sids, blk_tile, blk_cc, nblk, out4, t_chk = ctx.saved_tensors
        timer = ctx.timer
        if timer is not None:
            timer.mark("b6b_start")
        grads = stream_backward(ctx.settings, rows, sids, blk_tile, blk_cc,
                                nblk, out4, t_chk, g_out.contiguous())
        d_attrs, d_m2d = scatter_stream_grads(grads, sids, ctx.m,
                                              ctx.per_view)
        if timer is not None:
            timer.mark("b6b_end")
        return None, d_attrs, None, None, None, None, d_m2d, None


def stream_composite_attrs(settings: RasterSettings, attrs, sids, blk_tile,
                           blk_cc, nblk, m2d=None, timer=None):
    """Composite 2F views (forward + x-mirror per frame) from the aligned
    copy stream, differentiably.

    attrs [F, M, 9] float32 (``attr_rows_from_proj`` packing); sids, the
    block maps and nblk from ``concat_stream_bins``; m2d [2F, M, 2]
    (normally zeros; its gradient is each view's screen gradient of the
    means) or None.  Returns out4 [2F*T, 4, P] in view order.  ``timer``
    (optional, with ``mark(name)``) is marked around each kernel:
    b6f_start/b6f_end, b6b_start/b6b_end (B6b with the scatter)."""
    return _StreamComposite.apply(settings, attrs, sids, blk_tile, blk_cc,
                                  nblk, m2d, timer)


def stream_composite_inference(settings: RasterSettings, attrs, sids,
                               blk_tile, blk_cc, nblk):
    """Forward-only stream compositing: no checkpoints, no autograd."""
    with torch.no_grad():
        rows = stream_rows(attrs, sids)
        out4, _ = stream_forward(settings, rows, sids, blk_tile, blk_cc,
                                 nblk, save_tchk=False)
    return out4


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _block_map(settings, sids, blk_tile, blk_cc, nblk):
    """(first block of every (frame, tile) from the block maps, live
    slots per (frame, tile)): the tiles' spans as ``bin_gaussians_stream``
    laid them out, found without ``nblk``'s cumsum."""
    chunk = settings.chunk
    b = torch.arange(blk_tile.numel(), device=blk_tile.device)
    head = (blk_tile >= 0) & (blk_cc == 0)
    first = torch.zeros_like(nblk)
    first[blk_tile[head].long()] = b[head].to(torch.int32)
    live = (sids.reshape(-1, chunk) >= 0).sum(dim=1)      # per block
    owner = torch.where(blk_tile >= 0, blk_tile.long(),
                        torch.full_like(b, nblk.numel()))
    per_tile = torch.zeros(nblk.numel() + 1, dtype=live.dtype,
                           device=live.device)
    per_tile.index_add_(0, owner, live)
    return first, per_tile[:-1]


def _stream_tiles(settings, rows, first, live, nblk, sel):
    """mirror._Tiles of the mirror grid's steps ``sel`` over the stream:
    each step's [n_chunks * chunk] slot window starting at its tile's
    first block (slots past its ``nblk`` blocks zero), ``cnt`` its live
    copies.  Returns (tiles, slot index [S, cap], in-span mask)."""
    f_n = nblk.numel() // settings.n_tiles
    cap, chunk = settings.gaussian_cap, settings.chunk
    d_all, v_all, out_all = mirror.grid_rows(settings, f_n, rows.device)
    d = d_all[sel]
    j = torch.arange(cap, device=rows.device)
    in_span = j[None, :] < nblk[d].long()[:, None] * chunk
    slot = torch.where(in_span, first[d].long()[:, None] * chunk + j, 0)
    r = rows.T[slot]                                      # [S, cap, 9]
    r = torch.where(in_span[..., None], r, torch.zeros_like(r))
    tl = mirror._Tiles(settings, r, d % settings.n_tiles, v_all[sel],
                       live[d].long(), out_all[sel], check_precision(settings))
    return tl, slot, in_span


def _block_of_position(settings, tl, first_d, nb):
    """[S, n_chunks] stream block at each composite position, and the
    positions inside the tile's span."""
    n_chunks = settings.gaussian_cap // settings.chunk
    p = torch.arange(n_chunks, device=nb.device)[None, :]
    blk = first_d[:, None] + torch.where(tl.v[:, None] == 1,
                                         nb[:, None] - 1 - p, p)
    return blk, p < nb[:, None]


def stream_fwd_plain(settings: RasterSettings, rows, sids, blk_tile, blk_cc,
                     nblk):
    """Kernel B6f's function in plain PyTorch.  Returns (out4, t_chk,
    evaluated (copy, pixel) pairs of live copies)."""
    f_n, b_max = check_stream(settings, rows, sids, blk_tile, blk_cc, nblk)
    first, live = _block_map(settings, sids, blk_tile, blk_cc, nblk)
    dev = rows.device
    p_pix = settings.tile_h * settings.tile_w
    n_grid = 2 * f_n * settings.n_tiles
    n_chunks = settings.gaussian_cap // settings.chunk
    out4 = torch.empty((n_grid, 4, p_pix), dtype=torch.float32, device=dev)
    t_chk = torch.zeros((2, f_n * b_max, p_pix), dtype=torch.float32,
                        device=dev)
    d_all = mirror.grid_rows(settings, f_n, dev)[0]
    pairs = 0
    for b0 in range(0, n_grid, mirror.PLAIN_BATCH):
        sel = torch.arange(b0, min(b0 + mirror.PLAIN_BATCH, n_grid),
                           device=dev)
        tl, _, _ = _stream_tiles(settings, rows, first, live, nblk, sel)
        acc, t, chk, n = mirror.composite_rows(settings, tl)
        out4[tl.out_row, 0:3] = acc + t[:, None] * settings.bg
        out4[tl.out_row, 3] = t
        d = d_all[sel]
        blk, in_span = _block_of_position(settings, tl, first[d].long(),
                                          nblk[d].long())
        view = tl.v[:, None].expand(-1, n_chunks)
        t_chk[view[in_span], blk[in_span]] = chk[:, :n_chunks][in_span]
        pairs += n
    return out4, t_chk, pairs


def stream_bwd_plain(settings: RasterSettings, rows, sids, blk_tile, blk_cc,
                     nblk, out4, t_chk, g_out):
    """Kernel B6b's function in plain PyTorch.  Returns (per-slot
    gradients [2, 9, F*S_MAX], evaluated (copy, pixel) pairs of live
    copies)."""
    f_n, b_max = check_stream(settings, rows, sids, blk_tile, blk_cc, nblk)
    first, live = _block_map(settings, sids, blk_tile, blk_cc, nblk)
    dev = rows.device
    p_pix = settings.tile_h * settings.tile_w
    n_grid = 2 * f_n * settings.n_tiles
    n_chunks = settings.gaussian_cap // settings.chunk
    grads = torch.zeros((2, N_ATTR, rows.shape[1]), dtype=torch.float32,
                        device=dev)
    d_all = mirror.grid_rows(settings, f_n, dev)[0]
    pairs = 0
    for b0 in range(0, n_grid, mirror.PLAIN_BATCH):
        sel = torch.arange(b0, min(b0 + mirror.PLAIN_BATCH, n_grid),
                           device=dev)
        tl, slot, in_slot = _stream_tiles(settings, rows, first, live, nblk,
                                          sel)
        d = d_all[sel]
        blk, in_span = _block_of_position(settings, tl, first[d].long(),
                                          nblk[d].long())
        view = tl.v[:, None].expand(-1, n_chunks)
        chk = torch.zeros((sel.numel(), n_chunks + 1, p_pix),
                          dtype=torch.float32, device=dev)
        chk[:, :n_chunks][in_span] = t_chk[view[in_span], blk[in_span]]
        chk[:, n_chunks] = out4[tl.out_row, 3]
        gb = torch.zeros((sel.numel(), N_ATTR, settings.gaussian_cap),
                         dtype=torch.float32, device=dev)
        pairs += mirror.backward_rows(settings, tl, chk, g_out[tl.out_row],
                                      gb)
        sview = tl.v[:, None].expand_as(slot)
        grads[sview[in_slot], :, slot[in_slot]] = \
            gb.permute(0, 2, 1)[in_slot]
    return grads, pairs
