"""Single-view tile compositing — kernels B5f (forward) and B5b (backward)
of the port, their plain PyTorch versions, and the autograd function
``tile_composite`` around them.

Port of the single-view half of ``gsvc_tpu/render/pallas_splat.py``
(``_fwd_kernel`` :277, ``_bwd_kernel`` / ``_bwd_one_tile`` :349/:373,
``pallas_tile_composite`` :571, ``composite_tiles_inference`` :594).

The planes are the nine per-copy attribute rows of depth-sorted tile
lists, ``9 x [V*T, cap]`` (mean x/y, conic a/b/c, opacity — 0 on padding
slots — and rgb), for V views concatenated along the rows; row r
composites tile ``r % n_tiles``'s pixels.  Each row runs its chunks front
to back and stops at the first chunk boundary where its list is used up
or no pixel of the tile (the pixels past the image's right and bottom
edges included) keeps T >= T_EPS.  Training saves ``t_chk [V*T,
n_chunks + 1, P]``: the T before every chunk, the chunks after the stop
filled with the final T, the last row the exact final T.  The backward
replays the chunks up to ``c_hot`` (the last used chunk with a live
pixel), each copy's suffix being everything composited after it plus
``t_final * (bg * sum(g_rgb) + g_T)``, and gives every (row, slot) its 9
attribute gradients in ``[V*T, 9, cap]``: the plain version walks back
from ``c_hot`` with a suffix accumulator, kernel B5b walks forward from
chunk 0 with one alpha evaluation a pair and takes each suffix from the
forward's ``out4`` minus a running sum (B2's replay, ``csrc/replay.cuh``),
so the backward takes ``out4`` too.  The gradients reach the
per-gaussian rows (and ``means2d``) through the autograd of the plane
gather.

Both kernels and both plain versions take the settings' precision modes
(``compute_dtype`` / ``matmul_dtype``; ``check_precision``, the table in
``render/mirror.py``), as B1/B2 do: the forward the alpha and the
in-chunk transmittance bits, the backward every bit.  A mode the kernel
does not take fails its launch, which raises.
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

def check_planes(settings: RasterSettings, planes, counts) -> int:
    """Validate the composite's inputs (the precision modes among them);
    returns the row count V*T."""
    check_precision(settings)
    if len(planes) != 9:
        raise ValueError(f"expected 9 planes, got {len(planes)}")
    n_rows = planes[0].shape[0]
    shape = (n_rows, settings.gaussian_cap)
    if n_rows % settings.n_tiles:
        raise ValueError(f"{n_rows} plane rows are not a multiple of the "
                         f"{settings.n_tiles} tiles of a view")
    for i, p in enumerate(planes):
        if p.dtype != torch.float32 or tuple(p.shape) != shape:
            raise ValueError(f"plane {i}: expected float32 {shape}, got "
                             f"{p.dtype} {tuple(p.shape)}")
        if p.device != planes[0].device:
            raise ValueError(f"plane {i} is on {p.device}, plane 0 on "
                             f"{planes[0].device}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != (n_rows,) \
            or counts.device != planes[0].device:
        raise ValueError(f"counts: expected int32 ({n_rows},) on "
                         f"{planes[0].device}, got {counts.dtype} "
                         f"{tuple(counts.shape)} on {counts.device}")
    if settings.gaussian_cap % settings.chunk:
        raise ValueError("gaussian_cap must be a multiple of chunk")
    return n_rows


# ---------------------------------------------------------------------------
# Kernel launchers (CUDA tensors)
# ---------------------------------------------------------------------------

def _fn(lib: str, name: str, n_ptrs: int):
    fn = getattr(load(lib), name)
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.restype = ci
        fn.argtypes = [ctypes.c_void_p * 9] + [vp] * n_ptrs + [ci] * 9 \
            + [ctypes.c_float, vp]
    return fn


def _plane_ptrs(planes):
    for i, p in enumerate(planes):
        if not p.is_cuda or not p.is_contiguous():
            raise ValueError(f"plane {i} must be a contiguous CUDA tensor")
    return (ctypes.c_void_p * 9)(*(p.data_ptr() for p in planes))


def launch_shape(settings: RasterSettings):
    """(threads a block, pixels a thread) of B5f and B5b: one thread a
    pixel column, whole warps (``column_shape``, B1/B2's): 128 x 8 at
    8x128 tiles, 256 x 8 at 16x128."""
    return column_shape(settings, "B5f/B5b")


def _launch(fn, settings, n_rows, ptrs, device, mode):
    """One launch of ``fn`` in precision ``mode`` (``check_precision``'s
    bits); a mode the kernel does not take fails the launch, which raises:
    no wrapper falls back to float32."""
    threads, ppt = launch_shape(settings)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, n_rows, settings.n_tiles, settings.n_tiles_x,
                 settings.tile_w, settings.gaussian_cap, settings.chunk,
                 threads, ppt, mode, float(settings.bg), stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch in mode {mode} failed: "
                           f"CUDA error {err}")


def tile_fwd_cuda(settings: RasterSettings, planes, counts,
                  save_tchk: bool = True):
    """Launch kernel B5f once.  Returns (out4 [V*T, 4, P], t_chk
    [V*T, n_chunks + 1, P] or None)."""
    n_rows = check_planes(settings, planes, counts)
    ptrs = _plane_ptrs(planes)
    if not counts.is_cuda or not counts.is_contiguous():
        raise ValueError("counts must be a contiguous CUDA tensor")
    dev = planes[0].device
    p_pix = settings.tile_h * settings.tile_w
    n_chunks = settings.gaussian_cap // settings.chunk
    out4 = torch.empty((n_rows, 4, p_pix), dtype=torch.float32, device=dev)
    t_chk = torch.empty((n_rows, n_chunks + 1, p_pix), dtype=torch.float32,
                        device=dev) if save_tchk else None
    _launch(_fn("tile_fwd", "tile_forward", 3), settings, n_rows,
            (ptrs, counts.data_ptr(), out4.data_ptr(),
             t_chk.data_ptr() if save_tchk else None), dev,
            forward_precision(settings))
    return out4, t_chk


def check_backward_inputs(settings: RasterSettings, planes, counts, out4,
                          t_chk, g_out) -> int:
    """Validate the backward's inputs: B5f's outputs ``out4`` and
    ``t_chk`` and the cotangent ``g_out``, float32 on the planes' device.
    Returns the row count V*T."""
    n_rows = check_planes(settings, planes, counts)
    p_pix = settings.tile_h * settings.tile_w
    n_chunks = settings.gaussian_cap // settings.chunk
    for name, t, shape in (("out4", out4, (n_rows, 4, p_pix)),
                           ("t_chk", t_chk, (n_rows, n_chunks + 1, p_pix)),
                           ("g_out", g_out, (n_rows, 4, p_pix))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device != planes[0].device:
            raise ValueError(f"{name}: expected float32 {shape} on "
                             f"{planes[0].device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return n_rows


def tile_bwd_cuda(settings: RasterSettings, planes, counts, out4, t_chk,
                  g_out):
    """Launch kernel B5b once on B5f's outputs ``out4`` and ``t_chk``.
    Returns the per-slot gradients [V*T, 9, cap]."""
    n_rows = check_backward_inputs(settings, planes, counts, out4, t_chk,
                                   g_out)
    ptrs = _plane_ptrs(planes)
    for name, t in (("counts", counts), ("out4", out4), ("t_chk", t_chk),
                    ("g_out", g_out)):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    dev = planes[0].device
    grads = torch.empty((n_rows, 9, settings.gaussian_cap),
                        dtype=torch.float32, device=dev)
    _launch(_fn("tile_bwd", "tile_backward", 5), settings, n_rows,
            (ptrs, counts.data_ptr(), out4.data_ptr(), t_chk.data_ptr(),
             g_out.data_ptr(), grads.data_ptr()), dev,
            check_precision(settings))
    return grads


# ---------------------------------------------------------------------------
# Wrappers: kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------

def tile_forward(settings: RasterSettings, planes, counts,
                 save_tchk: bool = True):
    """(out4, t_chk or None) of the single-view composite.  CUDA tensors
    launch kernel B5f (and add one to ``tile_forward.launches``); CPU
    tensors take the plain version; any other device raises."""
    dev = planes[0].device
    if dev.type == "cuda":
        res = tile_fwd_cuda(settings, planes, counts, save_tchk)
        tile_forward.launches += 1
        return res
    if dev.type == "cpu":
        out4, t_chk, _ = tile_fwd_plain(settings, planes, counts)
        return out4, (t_chk if save_tchk else None)
    raise ValueError(f"tile_forward: unsupported device {dev}")


tile_forward.launches = 0


def tile_backward(settings: RasterSettings, planes, counts, out4, t_chk,
                  g_out):
    """Per-slot gradients [V*T, 9, cap] from the forward's ``out4`` and
    ``t_chk``.  CUDA tensors launch kernel B5b (and add one to
    ``tile_backward.launches``); CPU tensors take the plain version,
    which needs no ``out4``; any other device raises."""
    dev = planes[0].device
    if dev.type == "cuda":
        res = tile_bwd_cuda(settings, planes, counts, out4, t_chk, g_out)
        tile_backward.launches += 1
        return res
    if dev.type == "cpu":
        check_backward_inputs(settings, planes, counts, out4, t_chk, g_out)
        grads, _ = tile_bwd_plain(settings, planes, counts, t_chk, g_out)
        return grads
    raise ValueError(f"tile_backward: unsupported device {dev}")


tile_backward.launches = 0


class _TileComposite(torch.autograd.Function):

    @staticmethod
    def forward(ctx, settings, counts, timer, *planes):
        planes = tuple(p.contiguous() for p in planes)
        if timer is not None:
            timer.mark("b5f_start")
        out4, t_chk = tile_forward(settings, planes, counts)
        if timer is not None:
            timer.mark("b5f_end")
        ctx.settings, ctx.timer = settings, timer
        ctx.save_for_backward(counts, out4, t_chk, *planes)
        return out4

    @staticmethod
    def backward(ctx, g_out):
        counts, out4, t_chk, *planes = ctx.saved_tensors
        if ctx.timer is not None:
            ctx.timer.mark("b5b_start")
        grads = tile_backward(ctx.settings, planes, counts, out4, t_chk,
                              g_out.contiguous())
        if ctx.timer is not None:
            ctx.timer.mark("b5b_end")
        return (None, None, None) + tuple(grads.unbind(1))


def tile_composite(settings: RasterSettings, planes, counts, timer=None):
    """Differentiable tile compositing: planes 9 x [V*T, cap] float32,
    counts [V*T] int32 -> [V*T, 4, P] (premultiplied rgb + bg * T, and T).
    ``timer`` (optional, with ``mark(name)``) is marked around each kernel:
    b5f_start/b5f_end, b5b_start/b5b_end."""
    check_planes(settings, planes, counts)
    return _TileComposite.apply(settings, counts, timer, *planes)


def composite_tiles_inference(settings: RasterSettings, planes, counts):
    """Forward-only compositing: no checkpoints, no autograd."""
    check_planes(settings, planes, counts)
    with torch.no_grad():
        out4, _ = tile_forward(settings, tuple(p.contiguous()
                                               for p in planes),
                               counts, save_tchk=False)
    return out4


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _plane_tiles(settings, planes, counts, sel):
    """mirror._Tiles of the rows ``sel`` (single view: no flip steps)."""
    rows = torch.stack([p[sel] for p in planes], dim=-1)   # [S, cap, 9]
    return mirror._Tiles(settings, rows, sel % settings.n_tiles,
                         torch.zeros_like(sel), counts[sel].long(), sel,
                         check_precision(settings))


def tile_fwd_plain(settings: RasterSettings, planes, counts):
    """Kernel B5f's function in plain PyTorch: rows batched, chunk by
    chunk, with the kernel's per-row loop stops as masks.  Returns
    (out4, t_chk, evaluated (copy, pixel) pairs of real copies)."""
    n_rows = check_planes(settings, planes, counts)
    p_pix = settings.tile_h * settings.tile_w
    n_chunks = settings.gaussian_cap // settings.chunk
    dev = planes[0].device
    out4 = torch.empty((n_rows, 4, p_pix), dtype=torch.float32, device=dev)
    t_chk = torch.empty((n_rows, n_chunks + 1, p_pix), dtype=torch.float32,
                        device=dev)
    pairs = 0
    for b0 in range(0, n_rows, mirror.PLAIN_BATCH):
        sel = torch.arange(b0, min(b0 + mirror.PLAIN_BATCH, n_rows),
                           device=dev)
        tl = _plane_tiles(settings, planes, counts, sel)
        acc, t, chk, n = mirror.composite_rows(settings, tl)
        out4[sel, 0:3] = acc + t[:, None] * settings.bg
        out4[sel, 3] = t
        t_chk[sel] = chk
        pairs += n
    return out4, t_chk, pairs


def tile_bwd_plain(settings: RasterSettings, planes, counts, t_chk, g_out):
    """Kernel B5b's function in plain PyTorch.  Returns (per-slot
    gradients [V*T, 9, cap], evaluated (copy, pixel) pairs of real
    copies)."""
    n_rows = check_planes(settings, planes, counts)
    dev = planes[0].device
    grads = torch.zeros((n_rows, 9, settings.gaussian_cap),
                        dtype=torch.float32, device=dev)
    pairs = 0
    for b0 in range(0, n_rows, mirror.PLAIN_BATCH):
        sel = torch.arange(b0, min(b0 + mirror.PLAIN_BATCH, n_rows),
                           device=dev)
        tl = _plane_tiles(settings, planes, counts, sel)
        pairs += mirror.backward_rows(settings, tl, t_chk[sel], g_out[sel],
                                      grads[b0:b0 + sel.numel()])
    return grads, pairs
