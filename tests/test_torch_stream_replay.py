"""Kernel B6b's replay of the stream composite (gsvc_tpu_torch/csrc/
stream_bwd.cu, replay.cuh ``replay_chunk``), emulated in float32 on the
CPU and held against the plain version ``stream_bwd_plain``; and the
property that lets B6f/B6b end a block's walk at its live slots.

The kernel walks each (data tile, view)'s blocks of the copy stream
FORWARD in composite order (the flip view from the tile's last block
down, each block's copies bottom-up), evaluates each copy's alpha once
per pixel with t_before = t_chk[v, block] times the running product
(B6f's product), and takes each copy's suffix from the colour total that
the forward wrote (``out4``, which holds bg * t_final) minus a running
sum of w (c . g); the plain version replays in reverse and forms the
suffix by a reverse cumsum from t_final * (bg * sum(g_rgb) + g_T).  The
emulation below runs the kernel's per-pixel loop for every grid step at
once: the block stop at the first block without a live pixel, the
per-warp skip (a warp, 32 threads of the kernel's block shape, with no
pixel at T >= T_EPS skips the block; inside a block it stops after the
first pair of copies without a live pixel), the walk's end at the
block's live slots (the padding of a tile's partly filled last block is
not walked, in either view), the column form of the moments (d0 is a
thread's) and the zero rows of unreached slots.  It asserts that every
term a skip or the walk's end leaves out is exactly zero.

Tolerance: 2e-3 of each attribute's largest gradient magnitude, B2's card
tolerance (chip_smoke.py BWD_REL_ERR): the suffix is a difference of the
colour total and a running sum where the plain version sums the later
terms, 1/(1 - alpha) amplifies that rounding up to 100x, and the pixel
sums run in other orders.

Cases: the seeded tiles of tests/test_torch_mirror_replay.py (8x16
tiles, cap 64, chunk 16, two frames, both views of every tile; empty
tiles and counts that are not a multiple of the chunk) laid out as the
chunk-aligned stream with dead tail blocks; a tile whose column 3
saturates in every row, so that T underflows to 0 inside a replayed
block while other columns of the same warps stay live; a tile whose
first warp's pixels all die inside the first block (dead from the
second block on); and 8x128 tiles (128 threads of 8 pixels, a warp 32
columns of 8 rows).  The background is 0.3 in every case.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsvc_tpu_torch.render import mirror, stream
from gsvc_tpu_torch.render.splat import (
    T_EPS, ALPHA_MAX, ALPHA_MIN, RasterSettings, bin_gaussians_stream,
    project_gaussians,
)
from test_torch_mirror_replay import (
    DEAD_WARP_TILE, SATURATED_TILE, _case as mirror_case,
)

BWD_REL_ERR = 2e-3
BG = 0.3


def stream_case(kind, seed=3):
    """(settings, stream rows [9, F*S_MAX], bins) of the mirror replay
    case ``kind``, with two dead blocks at each frame's tail."""
    settings, attrs, lists, counts = mirror_case(kind, seed)
    settings = dataclasses.replace(settings, bg=BG)
    nblk = torch.clamp((counts + settings.chunk - 1) // settings.chunk,
                       min=1)
    bins = stream.stream_from_tile_lists(settings, lists, counts,
                                         int(nblk.sum(dim=1).max()) + 2)
    return settings, stream.stream_rows(attrs, bins[0]), bins


def replay_emulation(settings, rows, bins, out4, t_chk, g_out, skip=True):
    """Kernel B6b's loop in float32, all grid steps at once.  Returns
    (per-slot gradients [2, 9, F*S_MAX], diagnostics)."""
    sids, _, _, nblk = bins
    chunk, t_n = settings.chunk, settings.n_tiles
    th, tw, ntx = settings.tile_h, settings.tile_w, settings.n_tiles_x
    f_n, b_max = sids.shape[0], sids.shape[1] // chunk
    d, v, out_row = mirror.grid_rows(settings, f_n, "cpu")
    n_grid = d.numel()
    first = stream.block_starts(settings, nblk, b_max)[d].long()
    nb = nblk[d].long()
    nlive = stream.block_live(settings, sids).long()
    threads, _ = stream.launch_shape(settings)
    p_pix = th * tw
    warp_of = (torch.arange(p_pix) % threads) // 32            # [P]
    n_warps = threads // 32
    # geometry of each step: tile-local pixel coordinates, x negated in
    # the flip view
    u = d % t_n
    cx = ((u % ntx) * tw).float() + (tw - 1) / 2.0
    cy = ((u // ntx) * th).float() + (th - 1) / 2.0
    lin = torch.arange(p_pix)
    xs = (lin % tw).float() - (tw - 1) / 2.0
    xs = torch.where(v[:, None] == 1, -xs, xs)                 # [S, P]
    ys = (lin // tw).float() - (th - 1) / 2.0
    o4, g4 = out4[out_row], g_out[out_row]
    g3 = g4[:, 0:3]
    # the suffix total: t_final g_T + g . out_rgb (out_rgb holds bg T)
    total = o4[:, 3] * g4[:, 3] + (g3 * o4[:, 0:3]).sum(dim=1)
    pre = torch.zeros(n_grid, p_pix)
    grads = torch.zeros(2, 9, rows.shape[1])
    alive = torch.ones(n_grid, dtype=torch.bool)
    diag = dict(skipped_warp_blocks=0, early_stops=0, zero_t_live_rows=0,
                dead_at_1=set(), padding_slots=0, walked_blocks=0)

    def per_warp_any(x):                                       # [S, P]
        return torch.stack([x[:, warp_of == w].any(dim=1)
                            for w in range(n_warps)], dim=1)   # [S, W]

    j_all = torch.arange(chunk)
    for p in range(int(nb.max())):
        in_span = p < nb
        blk = torch.where(in_span, first + torch.where(v == 1, nb - 1 - p,
                                                       p), 0)
        t0 = t_chk[v, blk]                                     # [S, P]
        alive &= in_span & (t0.amax(dim=1) >= T_EPS)
        idx = alive.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        diag["walked_blocks"] += idx.numel()
        t0 = t0[idx]
        # the block's live slots in walk order: slot j, or n - 1 - j in
        # the flip view; the walk ends at n
        n = nlive[blk[idx]]                                    # [S']
        real = j_all[None, :] < n[:, None]                     # [S', C]
        diag["padding_slots"] += int((~real).sum())
        order = torch.where(v[idx, None] == 1, n[:, None] - 1 - j_all,
                            j_all).clamp_min(0)
        slot = blk[idx, None] * chunk + order                  # [S', C]
        r = torch.where(real[..., None], rows.T[slot],
                        torch.zeros(()))                       # [S', C, 9]
        d0 = xs[idx, None, :] - (r[..., 0:1] - cx[idx, None, None])
        d1 = ys[None, None, :] - (r[..., 1:2] - cy[idx, None, None])
        ha, hb, hc = -0.5 * r[..., 2:3], -0.5 * r[..., 3:4], \
            -0.5 * r[..., 4:5]
        raw = r[..., 5:6] * torch.exp(d0 * (ha * d0 + hb * d1)
                                      + d1 * (hb * d0 + hc * d1))
        alpha = torch.clamp(raw, max=ALPHA_MAX)
        ge_min = alpha >= ALPHA_MIN
        alpha = torch.where(ge_min, alpha, torch.zeros_like(alpha))
        act = ge_min & (raw < ALPHA_MAX)
        walking = per_warp_any(t0 >= T_EPS) if skip \
            else torch.ones(len(idx), n_warps, dtype=torch.bool)
        diag["skipped_warp_blocks"] += int((~walking).sum())
        if p == 1:
            diag["dead_at_1"] |= {int(s) for s in idx[~walking[:, 0]]}
        e = torch.ones(len(idx), p_pix)
        sums = torch.zeros(len(idx), 9, chunk)
        for j in range(chunk):
            a, ac = alpha[:, j], act[:, j]
            tb = t0 * e
            live = tb >= T_EPS
            w = torch.where(live, a * tb, torch.zeros_like(a))
            gc = (r[:, j, 6:9, None] * g3[idx]).sum(dim=1)
            pre[idx] = pre[idx] + w * gc
            a_i = total[idx] - pre[idx]
            d_alpha = torch.where(live & ac,
                                  gc * tb - a_i / torch.clamp(1.0 - a,
                                                              min=1e-6),
                                  torch.zeros_like(a))
            dq = d_alpha * a * (-0.5)
            terms = torch.stack([dq, dq * d0[:, j], dq * d1[:, j],
                                 dq * d0[:, j] * d0[:, j],
                                 dq * d0[:, j] * d1[:, j],
                                 dq * d1[:, j] * d1[:, j],
                                 w * g3[idx, 0], w * g3[idx, 1],
                                 w * g3[idx, 2]], dim=1)       # [S', 9, P]
            mask = walking[:, warp_of] & real[:, j, None]      # [S', P]
            # the terms a skip or the walk's end leaves out are exactly 0
            assert (terms.permute(0, 2, 1)[~mask] == 0).all()
            diag["zero_t_live_rows"] += int(((tb == 0) & mask).any(dim=1)
                                            .sum())
            sums[:, :, j] = (terms * mask[:, None, :]).sum(dim=2)
            e = e * (1.0 - a)
            if skip and j % 2 == 1:
                # after each pair of copies: a warp without a live pixel
                # in the pair stops walking the block
                pair_live = per_warp_any(live | prev_live)
                diag["early_stops"] += int((walking & ~pair_live).sum())
                walking &= pair_live
            prev_live = live
        con_a, con_b, con_c = r[..., 2], r[..., 3], r[..., 4]
        vals = torch.stack([
            -(2.0 * con_a * sums[:, 1] + 2.0 * con_b * sums[:, 2]),
            -(2.0 * con_c * sums[:, 2] + 2.0 * con_b * sums[:, 1]),
            sums[:, 3], 2.0 * sums[:, 4], sums[:, 5],
            -2.0 * sums[:, 0] / torch.clamp(r[..., 5], min=1e-12),
            sums[:, 6], sums[:, 7], sums[:, 8]], dim=1)        # [S', 9, C]
        view = v[idx, None].expand_as(slot)
        grads[view[real], :, slot[real]] = vals.permute(0, 2, 1)[real]
    return grads, diag


def _forward_and_cotangent(settings, rows, bins, seed=11):
    out4, t_chk, _ = stream.stream_fwd_plain(settings, rows, *bins)
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.normal(size=out4.shape).astype(np.float32))
    return out4, t_chk, g


def _rel_err(got, want):
    worst = 0.0
    for k in range(9):
        scale = max(float(want[:, k].abs().max()), 1e-30)
        worst = max(worst, float((got[:, k] - want[:, k]).abs().max())
                    / scale)
    return worst


@pytest.mark.parametrize("kind", ["random", "saturated", "dead_warp",
                                  "wide"])
def test_replay_matches_plain(kind):
    settings, rows, bins = stream_case(kind)
    out4, t_chk, g = _forward_and_cotangent(settings, rows, bins)
    want, _ = stream.stream_bwd_plain(settings, rows, *bins, out4, t_chk, g)
    got, diag = replay_emulation(settings, rows, bins, out4, t_chk, g)
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= BWD_REL_ERR
    # the skips change nothing: the walk without them gives the same bits
    full, _ = replay_emulation(settings, rows, bins, out4, t_chk, g,
                               skip=False)
    assert torch.equal(got, full)
    if kind in ("saturated", "dead_warp"):
        assert diag["skipped_warp_blocks"] > 0 and diag["early_stops"] > 0
    assert diag["padding_slots"] > 0


def test_cases_reach_their_corner():
    """Each case holds what it is named for: tiles of no copy and counts
    that end inside a block (both views of each), dead tail blocks, a
    background that the colour total carries; a replayed block in which a
    walking warp's pixel has T = 0 while the block is still live; a warp
    dead from the second block on in the forward view of its tile."""
    settings, rows, bins = stream_case("random")
    nlive = stream.block_live(settings, bins[0])
    live_blocks = bins[1] >= 0
    assert (nlive[live_blocks] == 0).any()
    assert ((nlive[live_blocks] > 0) & (nlive[live_blocks]
                                        < settings.chunk)).any()
    assert (~live_blocks).any()
    out4, t_chk, _ = _forward_and_cotangent(settings, rows, bins)
    assert settings.bg != 0 and (out4[:, 0:3] >= settings.bg
                                 * out4[:, 3:4]).all()
    _, _, out_all = mirror.grid_rows(settings, 2, "cpu")
    for kind, tile in (("saturated", SATURATED_TILE),
                       ("dead_warp", DEAD_WARP_TILE)):
        settings, rows, bins = stream_case(kind)
        out4, t_chk, g = _forward_and_cotangent(settings, rows, bins)
        _, diag = replay_emulation(settings, rows, bins, out4, t_chk, g)
        if kind == "saturated":
            assert diag["zero_t_live_rows"] > 0
            # column 3 underflows to exactly 0, columns 8-15 stay live
            final = out4[out_all[2 * tile], 3].reshape(settings.tile_h,
                                                       settings.tile_w)
            assert (final[:, 3] == 0).all()
            assert (final[:, 8:] >= T_EPS).all()
        else:
            assert 2 * tile in diag["dead_at_1"]               # f0, fwd


def test_unreached_slots_are_zero():
    """Slots past the block's stop, the padding after a block's live
    slots and the dead blocks are zero rows, as in the plain version."""
    settings, rows, bins = stream_case("dead_warp")
    out4, t_chk, g = _forward_and_cotangent(settings, rows, bins)
    want, _ = stream.stream_bwd_plain(settings, rows, *bins, out4, t_chk, g)
    got, diag = replay_emulation(settings, rows, bins, out4, t_chk, g)
    unreached = (want == 0).all(dim=1)                         # [2, S]
    assert unreached.any() and (bins[0] < 0).any()
    assert (got.permute(0, 2, 1)[unreached] == 0).all()
    # the stop leaves blocks of some tile unwalked
    assert diag["walked_blocks"] < 2 * int((bins[1] >= 0).sum())


def _scene(m, seed, grow):
    """A numpy-seeded scene for ``project_gaussians`` (the scenes of
    tests/test_splat.py, footprints scaled by ``grow``)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.8, 0.8, (m, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-0.2, 0.2, m)
    scaling = (rng.uniform(0.02, 0.1, (m, 3)) * grow).astype(np.float32)
    rot = rng.normal(size=(m, 4)).astype(np.float32)
    rot[:, 0] += 2.0
    return [torch.from_numpy(a) for a in (xyz, scaling, rot)] \
        + [torch.ones(m, dtype=torch.bool)]


@pytest.mark.parametrize("m, seed, grow, factor", [
    (40, 0, 1.0, 0), (40, 0, 1.0, 8), (300, 2, 4.0, 1), (300, 4, 1.5, 8)],
    ids=["padded", "budget8", "over_budget", "budget8_wide"])
def test_live_slots_are_a_prefix_of_each_span(m, seed, grow, factor):
    """``bin_gaussians_stream`` lays every tile's copies from the first
    slot of its span on: slot j of a tile's span is live exactly when
    j < its count, so each block's live slots (``block_live``) are a
    prefix of the block and the kernels' walk may end there.  With and
    without a copy budget, and with one that drops copies."""
    settings = RasterSettings(image_height=40, image_width=48,
                              threshold=0.15, tile_h=8, tile_w=16,
                              gaussian_cap=64, chunk=16,
                              tiles_per_gaussian=32,
                              copy_budget_factor=factor)
    proj = project_gaussians(*_scene(m, seed, grow), 0.0, -1.0, -0.75,
                             24.0, settings)
    sb = bin_gaussians_stream(proj, settings)
    chunk = settings.chunk
    first = torch.cumsum(sb.nblk, 0) - sb.nblk
    live = sb.ids >= 0
    for t in range(settings.n_tiles):
        span = live[int(first[t]) * chunk:
                    int(first[t] + sb.nblk[t]) * chunk]
        want = torch.arange(span.numel()) < int(sb.counts[t])
        assert torch.equal(span, want), t
    # outside every span, no slot is live
    assert int(live.sum()) == int(sb.counts.sum()) > 0
    nlive = stream.block_live(settings, sb.ids[None])
    blocks = live.reshape(-1, chunk)
    prefix = torch.arange(chunk)[None, :] < nlive[:, None].long()
    assert torch.equal(blocks, prefix)
    assert ((nlive > 0) & (nlive < chunk)).any()
