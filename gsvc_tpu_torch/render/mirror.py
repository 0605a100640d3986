"""Mirror-view compositing for training — kernels B1 (forward) and B2
(backward) of the port, their plain PyTorch versions, and the autograd
function ``mirror_composite_attrs`` around them.

Port of the mirror half of ``gsvc_tpu/render/pallas_splat.py``
(``_fwd_kernel_mirror`` :636, ``_bwd_kernel_mirror`` :699,
``mirror_composite_attrs`` / ``_mca_bwd`` :936-1037).

The x-flipped view of a frame is composited straight from the FORWARD
view's tile lists: its lists are the mirror tiles with the depth order
reversed, and its attribute transform (mux' = (W-1) - mux, conic b' = -b)
cancels against the mirrored pixel coordinate, so a flip view reads the
data tile u, evaluates alpha at negated tile-centred x and walks the
chunks (and the copies inside each chunk) back to front, writing the
output tile mirror(u).  One step per (data tile, view):
``g = (f*T + u)*2 + v``; output rows are in view order (f0 fwd, f0 flip,
f1 fwd, f1 flip), ``row = (2f + v)*T + (mirror(u) if v else u)``.

The forward saves ``t_chk [2F*T, n_chunks + 1, P]``: the transmittance
before every COMPOSITE position (view-direction agnostic), positions after
the early stop filled with the final T, slot ``n_chunks`` the exact final
T.  The backward replays the positions up to ``p_hot`` (the last position
with a live pixel), each copy's suffix being everything composited after
it plus ``t_final * (bg * sum(g_rgb) + g_T)``, and gives each (view, copy)
its 9 attribute gradients — mean x/y, conic a/b/c, opacity, rgb — in the
[2F*T, 9, cap] layout of the grid.  The mean and conic gradients come
from six pixel sums of dL/dq times (1, d0, d1, d0^2, d0 d1, d1^2), with
d = pixel - mean: the TPU kernel's pixel-basis moments taken about the
gaussian's mean instead of the tile centre, so the fp32 cancellation of
the moment algebra never happens.

The scatter of per-copy gradients into ``[F, M, 9]`` rows (and the four
per-view mean columns when ``m2d`` is given) is one ``index_add_`` after
the kernel, as the JAX package leaves it to XLA: the kernel's output
stays deterministic and comparable copy by copy with the plain version,
and the scatter moves 4.7 bytes per copy-column, far below the kernel's
arithmetic.  (``_chunked_row_scatter`` is a TPU memory workaround and is
not carried over.)

Precision modes (``RasterSettings.compute_dtype`` / ``matmul_dtype``; the
JAX package's ``_chunk_alpha`` and ``_matmul_fns``), in every composite —
B1/B2 here, B4 (``render/bidir.py``), B5f/B5b (``render/tile.py``) and
B6f/B6b (``render/stream.py``) — kernels and plain versions alike
(``check_precision``; B4 has no backward):

| setting | alpha | in-chunk transmittance before a copy | backward products (gc, suffix terms, moments, dcol) |
|---|---|---|---|
| ``float32`` / ``float32`` | float32, FMA-free in the kernels' order | ``t0 * prod(1 - a_j)`` over the earlier copies j of the chunk | float32 |
| ``compute_dtype="bfloat16"`` | bf16: d0, d1 = bf16(float32 tile-local delta); a, b, c, op cast to bf16; ``q = a d0 d0 + 2b d0 d1 + c d1 d1`` and ``op * exp(-q/2)`` in bf16, left to right as in JAX; widened to float32; ALPHA_MIN, ALPHA_MAX and the ``act`` gate in float32 | per ``matmul_dtype`` | bf16-rounded operands, float32 accumulation |
| ``matmul_dtype="bf16x2"`` | per ``compute_dtype`` | float32 (JAX's hi + lo split is float32 to ~2^-18 a term) | bf16-rounded operands, float32 accumulation |
| ``matmul_dtype="bfloat16"`` | per ``compute_dtype`` | ``t0 * prod exp(bf16(log1p(-a_j)))`` (JAX: exp of the float32-accumulated sum of the bf16 logs; the same to float32 rounding); the chunk's carried total and ``t_chk`` keep the float32 product of (1 - a) | bf16-rounded operands, float32 accumulation |

"bf16-rounded operands" are the factors that JAX's ``_mm_bf16`` /
``_mm_rhs_t_bf16`` round, where the port's algebra forms them: the
cotangent g (once, so the suffix total ``t_final g_T + g . out_rgb`` is
formed from it too), the colours c before dL/dalpha's ``gc = c . g``, w
before ``dcol = sum w g``, and dq, d0, d1 before the six moment sums
(``dq (1, d0, d1, d0^2, d0 d1, d1^2)``: products of bf16 values, exact in
float32).  The port takes its moments about the gaussian's mean where JAX
takes them in the tile basis ``[1, x, y, x^2, xy, y^2]``, so their rounding
error differs from JAX's in pattern but not in order.  The suffix terms
``w (c . g)`` keep the float32 colours and w: kernels B2, B5b and B6b form
each suffix as the total above minus a running sum of them, and with
rounded terms that difference would carry the rounding of every term
walked so far, past their tolerance of the plain version
(tests/test_torch_precision.py ``test_b2_suffix_terms_keep_float32``);
with them, the port's gradients stay within JAX's bands of JAX's same
mode (the same file, and tests/test_torch_precision_tile_stream.py).
``compute_dtype="bfloat16"`` with ``bf16x2`` is the same function as with
``float32``.  The MXU triangular matmul and the hi/lo split are TPU
workarounds and are not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from gsvc_tpu_torch.build import load
from gsvc_tpu_torch.render.bidir import (
    GRAD_BF16, TRANS_BF16, _check_inputs, alpha_raw, check_precision,
    column_shape, forward_precision, trans_factor,
)
from gsvc_tpu_torch.render.splat import (
    ALPHA_MAX, ALPHA_MIN, T_EPS, RasterSettings,
)

# grid rows per batch of the plain versions (bounds their [rows, chunk, P]
# temporaries: ~0.5 GB each at P = 1024)
PLAIN_BATCH = 1024


def check_inputs(settings: RasterSettings, attrs, tile_lists, counts):
    """Validate the composite's inputs (B4's checks: the precision modes
    and a tile-aligned width); returns F (frames)."""
    check_precision(settings)
    _check_inputs(settings, attrs, tile_lists, counts)
    return attrs.shape[0]


def grid_rows(settings: RasterSettings, f_n: int, device):
    """Per grid step g of 2F*T: (data row f*T + u, view v, output row)."""
    t_n, ntx = settings.n_tiles, settings.n_tiles_x
    g = torch.arange(2 * f_n * t_n, device=device)
    d, v = g // 2, g % 2
    f, u = d // t_n, d % t_n
    mirror_u = u + (ntx - 1) - 2 * (u % ntx)
    out_row = (2 * f + v) * t_n + torch.where(v == 1, mirror_u, u)
    return d, v, out_row


# ---------------------------------------------------------------------------
# Kernel launchers (CUDA tensors)
# ---------------------------------------------------------------------------

def _lib(name: str, fn_name: str, n_ptrs: int):
    fn = getattr(load(name), fn_name)
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.restype = ci
        fn.argtypes = [vp] * n_ptrs + [ci] * 10 + [ctypes.c_float, vp]
    return fn


def _require_contiguous(**tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")


def _launch(fn, settings, f_n, m, ptrs, device, mode):
    """One launch of ``fn`` in precision ``mode`` (``check_precision``'s
    bits); a mode the kernel does not take fails the launch, which raises:
    no wrapper falls back to float32."""
    threads, ppt = column_shape(settings, "B1/B2")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, f_n, m, settings.n_tiles, settings.n_tiles_x,
                 settings.tile_w, settings.gaussian_cap, settings.chunk,
                 threads, ppt, mode, float(settings.bg), stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch in mode {mode} failed: "
                           f"CUDA error {err}")


def mirror_fwd_cuda(settings: RasterSettings, attrs, tile_lists, counts):
    """Launch kernel B1 once.  Returns (out4 [2F*T, 4, P], t_chk
    [2F*T, n_chunks + 1, P]), rows in output (view) order."""
    f_n = check_inputs(settings, attrs, tile_lists, counts)
    _require_contiguous(attrs=attrs, tile_lists=tile_lists, counts=counts)
    p_pix = settings.tile_h * settings.tile_w
    n_grid = 2 * f_n * settings.n_tiles
    n_chunks = settings.gaussian_cap // settings.chunk
    out4 = torch.empty((n_grid, 4, p_pix), dtype=torch.float32,
                       device=attrs.device)
    t_chk = torch.empty((n_grid, n_chunks + 1, p_pix), dtype=torch.float32,
                        device=attrs.device)
    _launch(_lib("mirror_fwd", "mirror_forward", 5), settings, f_n,
            attrs.shape[1],
            (attrs.data_ptr(), tile_lists.data_ptr(), counts.data_ptr(),
             out4.data_ptr(), t_chk.data_ptr()), attrs.device,
            forward_precision(settings))
    return out4, t_chk


def check_backward_inputs(settings: RasterSettings, attrs, tile_lists,
                          counts, out4, t_chk, g_out):
    """Validate kernel B2's inputs: B1's outputs ``out4`` and ``t_chk``
    and the cotangent ``g_out``, float32 in output (view) row order."""
    f_n = check_inputs(settings, attrs, tile_lists, counts)
    p_pix = settings.tile_h * settings.tile_w
    n_grid = 2 * f_n * settings.n_tiles
    n_chunks = settings.gaussian_cap // settings.chunk
    for name, t, shape in (("out4", out4, (n_grid, 4, p_pix)),
                           ("t_chk", t_chk, (n_grid, n_chunks + 1, p_pix)),
                           ("g_out", g_out, (n_grid, 4, p_pix))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return f_n


def mirror_bwd_cuda(settings: RasterSettings, attrs, tile_lists, counts,
                    out4, t_chk, g_out):
    """Launch kernel B2 once on B1's outputs ``out4`` and ``t_chk``.
    Returns per-copy gradients [2F*T, 9, cap] in grid order (rows
    g = (f*T + u)*2 + v)."""
    f_n = check_backward_inputs(settings, attrs, tile_lists, counts, out4,
                                t_chk, g_out)
    _require_contiguous(attrs=attrs, tile_lists=tile_lists, counts=counts,
                        out4=out4, t_chk=t_chk, g_out=g_out)
    grads = torch.empty((2 * f_n * settings.n_tiles, 9,
                         settings.gaussian_cap),
                        dtype=torch.float32, device=attrs.device)
    _launch(_lib("mirror_bwd", "mirror_backward", 7), settings, f_n,
            attrs.shape[1],
            (attrs.data_ptr(), tile_lists.data_ptr(), counts.data_ptr(),
             out4.data_ptr(), t_chk.data_ptr(), g_out.data_ptr(),
             grads.data_ptr()), attrs.device,
            check_precision(settings))
    return grads


# ---------------------------------------------------------------------------
# Wrappers: kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------

def mirror_forward(settings: RasterSettings, attrs, tile_lists, counts):
    """(out4, t_chk) of the mirror composite.  CUDA tensors launch kernel
    B1 (and add one to ``mirror_forward.launches``); CPU tensors take the
    plain version; any other device raises."""
    if attrs.is_cuda:
        res = mirror_fwd_cuda(settings, attrs, tile_lists, counts)
        mirror_forward.launches += 1
        return res
    if attrs.device.type == "cpu":
        out4, t_chk, _ = mirror_fwd_plain(settings, attrs, tile_lists,
                                          counts)
        return out4, t_chk
    raise ValueError(f"mirror_forward: unsupported device {attrs.device}")


mirror_forward.launches = 0


def mirror_backward(settings: RasterSettings, attrs, tile_lists, counts,
                    out4, t_chk, g_out):
    """Per-copy gradients [2F*T, 9, cap] (grid order) from the forward's
    ``out4`` and ``t_chk``.  CUDA tensors launch kernel B2 (and add one
    to ``mirror_backward.launches``); CPU tensors take the plain version,
    which needs no ``out4``; any other device raises."""
    if attrs.is_cuda:
        res = mirror_bwd_cuda(settings, attrs, tile_lists, counts, out4,
                              t_chk, g_out)
        mirror_backward.launches += 1
        return res
    if attrs.device.type == "cpu":
        check_backward_inputs(settings, attrs, tile_lists, counts, out4,
                              t_chk, g_out)
        grads, _ = mirror_bwd_plain(settings, attrs, tile_lists, counts,
                                    t_chk, g_out)
        return grads
    raise ValueError(f"mirror_backward: unsupported device {attrs.device}")


mirror_backward.launches = 0


def scatter_grads(settings: RasterSettings, grads, tile_lists, m: int,
                  per_view: bool):
    """Per-copy gradients [2F*T, 9, cap] (grid order) -> (d_attrs
    [F, M, 9], d_m2d [2F, M, 2] or None) by one ``index_add_``.

    The two views of a copy add into its 9 attribute columns; with
    ``per_view`` each view's mean columns also go to its own m2d rows —
    the flip view's screen x is mirrored, so its x gradient is negated."""
    f_n, t_n, cap = tile_lists.shape
    g5 = grads.reshape(f_n, t_n, 2, 9, cap)
    v0, v1 = g5[:, :, 0], g5[:, :, 1]                    # [F, T, 9, cap]
    cols = [v0 + v1]
    if per_view:
        cols.append(torch.stack([v0[:, :, 0], v0[:, :, 1], -v1[:, :, 0],
                                 v1[:, :, 1]], dim=2))
    src = torch.cat(cols, dim=2).permute(0, 1, 3, 2)     # [F, T, cap, C]
    n_cols = src.shape[-1]
    frame = torch.arange(f_n, device=grads.device)[:, None, None] * m
    ids = (tile_lists.clamp_min(0).long() + frame).reshape(-1)
    # padding slots carry zero gradients (zero opacity), so they may land
    # on row 0 of their frame
    out = torch.zeros((f_n * m, n_cols), dtype=grads.dtype,
                      device=grads.device)
    out.index_add_(0, ids, src.reshape(-1, n_cols))
    out = out.reshape(f_n, m, n_cols)
    d_attrs = out[..., :9]
    if not per_view:
        return d_attrs, None
    d_m2d = out[..., 9:13].reshape(f_n, m, 2, 2).permute(0, 2, 1, 3)
    return d_attrs, d_m2d.reshape(2 * f_n, m, 2)


class _MirrorComposite(torch.autograd.Function):

    @staticmethod
    def forward(ctx, settings, attrs, tile_lists, counts, m2d, timer):
        if m2d is not None:
            # the forward views' zero tensors join the mean columns; their
            # cotangents (and the flip views') come out of the backward
            attrs = torch.cat([attrs[..., :2] + m2d[0::2], attrs[..., 2:]],
                              dim=-1)
        attrs = attrs.contiguous()
        if timer is not None:
            timer.mark("b1_start")
        out4, t_chk = mirror_forward(settings, attrs, tile_lists, counts)
        if timer is not None:
            timer.mark("b1_end")
        ctx.settings, ctx.timer = settings, timer
        ctx.per_view = m2d is not None
        ctx.save_for_backward(attrs, tile_lists, counts, out4, t_chk)
        return out4

    @staticmethod
    def backward(ctx, g_out):
        attrs, tile_lists, counts, out4, t_chk = ctx.saved_tensors
        timer = ctx.timer
        if timer is not None:
            timer.mark("b2_start")
        grads = mirror_backward(ctx.settings, attrs, tile_lists, counts,
                                out4, t_chk, g_out.contiguous())
        d_attrs, d_m2d = scatter_grads(ctx.settings, grads, tile_lists,
                                       attrs.shape[1], ctx.per_view)
        if timer is not None:
            timer.mark("b2_end")
        return None, d_attrs, None, None, d_m2d, None


def mirror_composite_attrs(settings: RasterSettings, attrs, tile_lists,
                           counts, m2d=None, timer=None):
    """Composite 2F views (forward + x-mirror per frame) straight from the
    per-gaussian attribute rows, differentiably.

    attrs [F, M, 9] float32 (``attr_rows_from_proj`` packing),
    tile_lists [F, T, cap] int32 (-1 padded), counts [F, T] int32,
    m2d [2F, M, 2] (normally zeros; its gradient is each view's screen
    gradient of the means) or None.  Returns out4 [2F*T, 4, P] in view
    order.  ``timer`` (optional, with ``mark(name)``) is marked around
    each kernel: b1_start/b1_end, b2_start/b2_end (B2 with the scatter)."""
    check_inputs(settings, attrs, tile_lists, counts)
    return _MirrorComposite.apply(settings, attrs, tile_lists, counts, m2d,
                                  timer)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

class _Tiles:
    """Per-step geometry and attribute rows of a batch of composite steps
    (one tile of one view each).  Shared by the plain versions of the
    mirror composite (B1/B2), the single-view composite (B5f/B5b,
    ``render/tile.py``) and the stream composite (B6f/B6b,
    ``render/stream.py``)."""

    def __init__(self, settings, rows, u, v, cnt, out_row, mode):
        """rows [S, cap, 9] (opacity 0 on padding slots), u [S] the tile
        whose pixels a step composites from, v [S] 1 for a flip step of
        the mirror composite, cnt [S] list lengths, out_row [S] the output
        row of each step, ``mode`` the precision bits
        (``check_precision``)."""
        self.mode = mode
        th, tw = settings.tile_h, settings.tile_w
        dev = rows.device
        self.rows, self.v, self.cnt, self.out_row = rows, v, cnt, out_row
        self.cx = ((u % settings.n_tiles_x) * tw).float() + (tw - 1) / 2.0
        self.cy = ((u // settings.n_tiles_x) * th).float() + (th - 1) / 2.0
        lin = torch.arange(th * tw, device=dev)
        xs = (lin % tw).float() - (tw - 1) / 2.0
        self.ys = (lin // tw).float() - (th - 1) / 2.0
        self.xs = torch.where(v[:, None] == 1, -xs, xs)        # [S, P]
        self.chunk = settings.chunk
        self.n_chunks = settings.gaussian_cap // settings.chunk
        self.n_used = torch.clamp((cnt + self.chunk - 1) // self.chunk,
                                  max=self.n_chunks)

    def chunk_of(self, p, idx):
        """Data chunk at composite position p for rows ``idx`` (batch
        indices); flip views walk the chunks from the last used one."""
        rev = self.v[idx] == 1
        return torch.where(rev, self.n_used[idx] - 1 - p,
                           torch.full_like(rev, p, dtype=torch.long))

    def load(self, p, idx):
        """Chunk at position p for rows ``idx``, in COMPOSITE order:
        (slot index [S, C], alpha, act, d0, d1 [S, C, P], attribute
        rows [S, C, 9])."""
        c = self.chunk_of(p, idx)
        j = torch.arange(self.chunk, device=c.device)
        rev = (self.v[idx] == 1)[:, None]
        order = torch.where(rev, self.chunk - 1 - j, j)
        slot = c[:, None] * self.chunk + order                 # [S, C]
        r = torch.gather(self.rows[idx], 1,
                         slot[..., None].expand(-1, -1, 9))
        mu_x = r[..., 0] - self.cx[idx, None]
        mu_y = r[..., 1] - self.cy[idx, None]
        d0 = self.xs[idx, None, :] - mu_x[..., None]
        d1 = self.ys[None, None, :] - mu_y[..., None]
        raw = alpha_raw(r, d0, d1, self.mode)
        alpha = torch.clamp(raw, max=ALPHA_MAX)
        ge_min = alpha >= ALPHA_MIN
        alpha = torch.where(ge_min, alpha, torch.zeros_like(alpha))
        act = ge_min & (raw < ALPHA_MAX)
        return slot, alpha, act, d0, d1, r

    def real_copies(self, p, idx):
        c = self.chunk_of(p, idx)
        return torch.clamp(self.cnt[idx] - c * self.chunk, 0, self.chunk)


def _mirror_tiles(settings, attrs, tile_lists, counts, sel):
    """_Tiles of the mirror grid's steps ``sel``."""
    f_n, m, _ = attrs.shape
    t_n, cap = settings.n_tiles, settings.gaussian_cap
    d_all, v_all, out_all = grid_rows(settings, f_n, attrs.device)
    d = d_all[sel]
    lists = tile_lists.reshape(f_n * t_n, cap)[d].long()
    rows = attrs.reshape(f_n * m, 9)[
        (d // t_n)[:, None] * m + lists.clamp_min(0)]       # [S, cap, 9]
    rows[..., 5] = torch.where(lists >= 0, rows[..., 5],
                               torch.zeros_like(rows[..., 5]))
    return _Tiles(settings, rows, d % t_n, v_all[sel],
                  counts.reshape(-1)[d].long(), out_all[sel],
                  check_precision(settings))


def _excl_cumprod(x: torch.Tensor):
    """(exclusive product along dim 1, total product): the in-chunk
    running product the kernels keep per pixel."""
    incl = torch.cumprod(x, dim=1)
    return (torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1),
            incl[:, -1])


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def composite_rows(settings: RasterSettings, tl: _Tiles):
    """Forward composite of a batch of steps, chunk by chunk, with the
    kernels' per-step loop stops as masks.  Returns (colour sums [S, 3, P],
    final T [S, P], checkpoints [S, n_chunks + 1, P], evaluated (copy,
    pixel) pairs of real copies)."""
    s_n, p_pix = tl.xs.shape
    n_chunks = tl.n_chunks
    dev = tl.rows.device
    t = torch.ones(s_n, p_pix, device=dev)
    acc = torch.zeros(s_n, 3, p_pix, device=dev)
    chk = torch.empty(s_n, n_chunks + 1, p_pix, device=dev)
    alive = torch.ones(s_n, dtype=torch.bool, device=dev)
    pairs = 0
    for p in range(n_chunks):
        # position p runs while p < n_used and some pixel keeps
        # T >= T_EPS; stopped rows keep their final T
        chk[:, p] = t
        alive &= (p < tl.n_used) & (t.amax(dim=1) >= T_EPS)
        idx = alive.nonzero().squeeze(1)
        if idx.numel() == 0:
            chk[:, p + 1:n_chunks] = t[:, None]
            break
        _, alpha, _, _, _, r = tl.load(p, idx)
        one_m = 1.0 - alpha
        excl, chunk_t = _excl_cumprod(one_m)
        if tl.mode & TRANS_BF16:
            excl = _excl_cumprod(trans_factor(alpha, one_m, tl.mode))[0]
        t_before = t[idx, None, :] * excl
        w = torch.where(t_before >= T_EPS, alpha * t_before,
                        torch.zeros_like(alpha))
        acc[idx] += torch.bmm(r[..., 6:9].transpose(1, 2), w)
        t[idx] = t[idx] * chunk_t
        pairs += int(tl.real_copies(p, idx).sum())
    chk[:, n_chunks] = t
    return acc, t, chk, pairs * p_pix


def backward_rows(settings: RasterSettings, tl: _Tiles, chk, g_out4,
                  grads):
    """Reverse replay of a batch of steps from p_hot, the last used
    position with a live pixel; writes each step's [9, cap] gradients
    into ``grads`` (rows in batch order, zeros where the replay never
    reaches).  ``chk`` [S, n_chunks + 1, P] and ``g_out4`` [S, 4, P] are
    the steps' checkpoints and output cotangents.  Returns the evaluated
    (copy, pixel) pairs of real copies."""
    n_chunks = tl.n_chunks
    dev = tl.rows.device
    # the products' operands, bf16-rounded under any precision mode
    rb = (_bf16_round if tl.mode & GRAD_BF16 else lambda x: x)
    g3 = rb(g_out4[:, 0:3])                                  # [S, 3, P]
    a_acc = chk[:, n_chunks] * (settings.bg * g3.sum(dim=1) + g_out4[:, 3])
    pos = torch.arange(n_chunks, device=dev)
    live_pos = (chk[:, :n_chunks].amax(dim=2) >= T_EPS) \
        & (pos[None] < tl.n_used[:, None])
    p_hot = torch.where(live_pos, pos[None], -1).amax(dim=1)
    pairs = 0
    for p in range(n_chunks - 1, -1, -1):
        idx = (p <= p_hot).nonzero().squeeze(1)
        if idx.numel() == 0:
            continue
        slot, alpha, act, d0, d1, r = tl.load(p, idx)
        one_m = 1.0 - alpha
        t_before = chk[idx, p, None, :] * _excl_cumprod(
            trans_factor(alpha, one_m, tl.mode))[0]
        live = t_before >= T_EPS
        w = torch.where(live, alpha * t_before, torch.zeros_like(alpha))
        # the suffix's terms keep the colours float32: the kernel forms the
        # suffix as the colour total minus a running sum (docstring)
        gc = torch.einsum("sck,skp->scp", r[..., 6:9], g3[idx])
        wgc = w * gc
        if tl.mode & GRAD_BF16:
            gc = torch.einsum("sck,skp->scp", rb(r[..., 6:9]), g3[idx])
        # suffix in composite order, exclusive of the copy itself
        suffix = torch.flip(torch.cumsum(torch.flip(wgc, [1]), 1), [1])
        a_i = a_acc[idx, None, :] + torch.cat(
            [suffix[:, 1:], torch.zeros_like(suffix[:, :1])], dim=1)
        d_alpha = torch.where(
            live & act, gc * t_before - a_i / torch.clamp(one_m, min=1e-6),
            torch.zeros_like(alpha))
        dq = d_alpha * alpha * (-0.5)
        dq, d0, d1 = rb(dq), rb(d0), rb(d1)
        s0 = dq.sum(dim=2)
        s1 = (dq * d0).sum(dim=2)
        s2 = (dq * d1).sum(dim=2)
        s3 = (dq * d0 * d0).sum(dim=2)
        s4 = (dq * d0 * d1).sum(dim=2)
        s5 = (dq * d1 * d1).sum(dim=2)
        dcol = torch.einsum("scp,skp->sck", rb(w), g3[idx])
        con_a, con_b, con_c, op = (r[..., 2], r[..., 3], r[..., 4],
                                   r[..., 5])
        vals = torch.stack([
            -(2.0 * con_a * s1 + 2.0 * con_b * s2),
            -(2.0 * con_c * s2 + 2.0 * con_b * s1),
            s3, 2.0 * s4, s5,
            -2.0 * s0 / torch.clamp(op, min=1e-12),
            dcol[..., 0], dcol[..., 1], dcol[..., 2]], dim=1)  # [S, 9, C]
        grads[idx[:, None, None], torch.arange(9, device=dev)[None, :, None],
              slot[:, None, :]] = vals
        a_acc[idx] = a_acc[idx] + wgc.sum(dim=1)
        pairs += int(tl.real_copies(p, idx).sum())
    return pairs * tl.xs.shape[1]


def mirror_fwd_plain(settings: RasterSettings, attrs, tile_lists, counts):
    """Kernel B1's function in plain PyTorch: grid rows batched, chunk by
    chunk, with the kernel's per-row loop stops as masks.  Returns
    (out4, t_chk, evaluated (copy, pixel) pairs of real copies)."""
    f_n = check_inputs(settings, attrs, tile_lists, counts)
    p_pix = settings.tile_h * settings.tile_w
    n_grid = 2 * f_n * settings.n_tiles
    n_chunks = settings.gaussian_cap // settings.chunk
    dev = attrs.device
    out4 = torch.empty((n_grid, 4, p_pix), dtype=torch.float32, device=dev)
    t_chk = torch.empty((n_grid, n_chunks + 1, p_pix), dtype=torch.float32,
                        device=dev)
    pairs = 0
    for b0 in range(0, n_grid, PLAIN_BATCH):
        sel = torch.arange(b0, min(b0 + PLAIN_BATCH, n_grid), device=dev)
        tl = _mirror_tiles(settings, attrs, tile_lists, counts, sel)
        acc, t, chk, n = composite_rows(settings, tl)
        out4[tl.out_row, 0:3] = acc + t[:, None] * settings.bg
        out4[tl.out_row, 3] = t
        t_chk[tl.out_row] = chk
        pairs += n
    return out4, t_chk, pairs


def mirror_bwd_plain(settings: RasterSettings, attrs, tile_lists, counts,
                     t_chk, g_out):
    """Kernel B2's function in plain PyTorch.  Returns (per-copy gradients
    [2F*T, 9, cap] in grid order, evaluated (copy, pixel) pairs of real
    copies)."""
    f_n = check_inputs(settings, attrs, tile_lists, counts)
    n_grid = 2 * f_n * settings.n_tiles
    dev = attrs.device
    grads = torch.zeros((n_grid, 9, settings.gaussian_cap),
                        dtype=torch.float32, device=dev)
    pairs = 0
    for b0 in range(0, n_grid, PLAIN_BATCH):
        sel = torch.arange(b0, min(b0 + PLAIN_BATCH, n_grid), device=dev)
        tl = _mirror_tiles(settings, attrs, tile_lists, counts, sel)
        pairs += backward_rows(settings, tl, t_chk[tl.out_row],
                               g_out[tl.out_row], grads[b0:b0 + sel.numel()])
    return grads, pairs
