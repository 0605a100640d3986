"""Kernel B5b's replay of the single-view composite (gsvc_tpu_torch/csrc/
tile_bwd.cu, replay.cuh ``replay_chunk``), emulated in float32 on the CPU
and held against the plain version ``tile_bwd_plain``.

The kernel walks each plane row's chunks FORWARD from chunk 0, evaluates
each copy's alpha once per pixel with t_before = t_chk[c] times the
running product (B5f's product), and takes each copy's suffix from the
colour total that the forward wrote (``out4``, which holds bg * t_final)
minus a running sum of w (c . g); the plain version replays in reverse
and forms the suffix by a reverse cumsum from t_final * (bg * sum(g_rgb)
+ g_T).  The emulation below runs the kernel's per-pixel loop for every
row at once: the block stop at the first chunk without a live pixel, the
per-warp skip (a warp, 32 threads of the kernel's block shape, with no
pixel at T >= T_EPS skips the chunk; inside a chunk it stops after the
first pair of copies without a live pixel), the walk's end at the row's
last copy (the padding slots of a partly filled last chunk are not
walked), the column form of the moments (d0 is a thread's) and the zero
rows of unreached slots.  It asserts that every term a skip or the
walk's end leaves out is exactly zero.

Tolerance: 2e-3 of each attribute's largest gradient magnitude, B5b's
card tolerance (chip_smoke.py BWD_REL_ERR): the suffix is a difference of
the colour total and a running sum where the plain version sums the later
terms, 1/(1 - alpha) amplifies that rounding up to 100x, and the pixel
sums run in other orders.

Cases (8x16 tiles, cap 64, chunk 16, a frame 40 px wide, so the last
tile column reaches past the image; two views; background 0.3): seeded
tiles with empty lists and counts that are not a multiple of the chunk;
a tile whose column 3 saturates in every row, so that T underflows to 0
inside a replayed chunk while other columns of the same warps stay live;
and a tile whose first warp's pixels all die inside the first chunk
(dead from chunk 1 on).  A fourth case takes 8x128 tiles (the training
tiles: 128 threads of 8 pixels, a warp 32 columns of 8 rows).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsvc_tpu_torch.render import tile
from gsvc_tpu_torch.render.bidir import column_shape
from gsvc_tpu_torch.render.splat import (
    T_EPS, RasterSettings, gather_tile_planes_rows,
)
from test_torch_mirror_replay import _band, _random_tile

BWD_REL_ERR = 2e-3
BG = 0.3
SMALL = RasterSettings(image_height=40, image_width=40, threshold=0.15,
                       tile_h=8, tile_w=16, gaussian_cap=64, chunk=16,
                       tiles_per_gaussian=32, bg=BG)
WIDE = RasterSettings(image_height=16, image_width=200, threshold=0.1,
                      tile_h=8, tile_w=128, gaussian_cap=64, chunk=16,
                      tiles_per_gaussian=32, bg=BG)
SATURATED_TILE, DEAD_WARP_TILE = 4, 7


def _case(kind, seed=5):
    """(settings, planes 9 x [V*T, cap], counts [V*T]) of two views."""
    settings = WIDE if kind == "wide" else SMALL
    rng = np.random.default_rng(seed)
    t_n, cap = settings.n_tiles, settings.gaussian_cap
    planes, counts = [], []
    for view in range(2):
        per_tile = []
        for t in range(t_n):
            n = int(rng.integers(0, cap + 1))
            if t == 0:
                n = 0                               # an empty list
            elif t == 1:
                n = 37                              # 2 chunks + 5
            elif t == 2:
                n = cap
            rows = _random_tile(rng, settings, t, n)
            if kind == "saturated" and t == SATURATED_TILE:
                # column 3 saturates in every row (alpha 0.99: T reaches 0
                # at copy ~23, inside chunk 1) while columns 8-15 of the
                # same warps stay live to the end
                rows = np.concatenate([
                    _band(rng, settings, t, 40, 0, 2.95, 3.05, 1.0, 0.999),
                    _band(rng, settings, t, 20, 0, 8.0, 16.0, 6.0, 0.05)])
            if kind == "dead_warp" and t == DEAD_WARP_TILE:
                # warp 0 holds rows 0-1: eight opaque copies in chunk 0
                # kill them there, the rest of the tile lives on
                rows = np.concatenate([
                    _band(rng, settings, t, 8, 1, 0.4, 0.6, 0.7, 0.98),
                    _band(rng, settings, t, 8, 1, 3.0, 8.0, 6.0, 0.1),
                    _random_tile(rng, settings, t, 30) * [1, 1, 1, 1, 1,
                                                          0.3, 1, 1, 1]])
            per_tile.append(rows.astype(np.float32))
        m = sum(len(r) for r in per_tile)
        attrs = np.zeros((max(m, 1), 9), np.float32)
        lists = np.full((t_n, cap), -1, np.int32)
        start = 0
        for t, rows in enumerate(per_tile):
            attrs[start:start + len(rows)] = rows
            lists[t, :len(rows)] = np.arange(start, start + len(rows))
            counts.append(len(rows))
            start += len(rows)
        planes.append(gather_tile_planes_rows(torch.from_numpy(attrs),
                                              torch.from_numpy(lists)))
    return (settings,
            tuple(torch.cat([p[i] for p in planes]).contiguous()
                  for i in range(9)),
            torch.tensor(counts, dtype=torch.int32))


def replay_emulation(settings, planes, counts, out4, t_chk, g_out,
                     skip=True):
    """Kernel B5b's loop in float32, all rows at once.  Returns (per-slot
    gradients [V*T, 9, cap], diagnostics)."""
    n_rows = planes[0].shape[0]
    sel = torch.arange(n_rows)
    tl = tile._plane_tiles(settings, planes, counts, sel)
    threads, _ = column_shape(settings, "B5b")
    p_pix = settings.tile_h * settings.tile_w
    warp_of = (torch.arange(p_pix) % threads) // 32             # [P]
    n_warps = threads // 32
    chunk, n_chunks = tl.chunk, tl.n_chunks
    g3 = g_out[:, 0:3]
    # the suffix total: t_final g_T + g . out_rgb (out_rgb holds bg T)
    total = t_chk[:, n_chunks] * g_out[:, 3] \
        + (g3 * out4[:, 0:3]).sum(dim=1)
    pre = torch.zeros(n_rows, p_pix)
    grads = torch.zeros(n_rows, 9, settings.gaussian_cap)
    alive = torch.ones(n_rows, dtype=torch.bool)
    diag = dict(skipped_warp_chunks=0, early_stops=0, zero_t_live_rows=0,
                dead_at_1=set(), padding_pairs=0)

    def per_warp_any(x):                                       # [S, P]
        return torch.stack([x[:, warp_of == w].any(dim=1)
                            for w in range(n_warps)], dim=1)   # [S, W]

    for c in range(n_chunks):
        t0 = t_chk[:, c]
        alive &= (c < tl.n_used) & (t0.amax(dim=1) >= T_EPS)
        idx = alive.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        slot, alpha, act, d0, d1, r = tl.load(c, idx)
        t0 = t0[idx]
        walking = per_warp_any(t0 >= T_EPS) if skip \
            else torch.ones(len(idx), n_warps, dtype=torch.bool)
        diag["skipped_warp_chunks"] += int((~walking).sum())
        if c == 1:
            diag["dead_at_1"] |= {int(s) for s in idx[~walking[:, 0]]}
        real = tl.real_copies(c, idx)                          # [S']
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
            # the kernel walks no padding slot (past the row's count)
            mask = walking[:, warp_of] & (j < real)[:, None]   # [S', P]
            # the terms a skip leaves out are exactly zero
            assert (terms.permute(0, 2, 1)[~mask] == 0).all()
            diag["padding_pairs"] += int((j >= real).sum()) * p_pix
            diag["zero_t_live_rows"] += int(((tb == 0) & mask).any(dim=1)
                                            .sum())
            sums[:, :, j] = (terms * mask[:, None, :]).sum(dim=2)
            e = e * (1.0 - a)
            if skip and j % 2 == 1:
                # after each pair of copies: a warp without a live pixel
                # in the pair stops walking the chunk
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
        grads[idx[:, None, None], torch.arange(9)[None, :, None],
              slot[:, None, :]] = vals
    return grads, diag


def _forward_and_cotangent(settings, planes, counts, seed=11):
    out4, t_chk, _ = tile.tile_fwd_plain(settings, planes, counts)
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
    settings, planes, counts = _case(kind)
    out4, t_chk, g = _forward_and_cotangent(settings, planes, counts)
    want, _ = tile.tile_bwd_plain(settings, planes, counts, t_chk, g)
    got, diag = replay_emulation(settings, planes, counts, out4, t_chk, g)
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= BWD_REL_ERR
    # the skips change nothing: the walk without them gives the same bits
    full, _ = replay_emulation(settings, planes, counts, out4, t_chk, g,
                               skip=False)
    assert torch.equal(got, full)
    if kind in ("saturated", "dead_warp"):
        assert diag["skipped_warp_chunks"] > 0 and diag["early_stops"] > 0
    assert diag["padding_pairs"] > 0


def test_cases_reach_their_corner():
    """Each case holds what it is named for: lists that end inside a chunk
    and empty lists, a background that the colour total carries; a
    replayed chunk in which a walking warp's pixel has T = 0 while the
    block is still live; a warp dead from chunk 1 on in the first view."""
    settings, planes, counts = _case("random")
    assert (counts == 0).any() and (counts % settings.chunk != 0).any()
    out4, t_chk, _ = _forward_and_cotangent(settings, planes, counts)
    assert settings.bg != 0 and (out4[:, 0:3] >= settings.bg
                                 * t_chk[:, -1, None]).all()
    for kind, t in (("saturated", SATURATED_TILE),
                    ("dead_warp", DEAD_WARP_TILE)):
        settings, planes, counts = _case(kind)
        out4, t_chk, g = _forward_and_cotangent(settings, planes, counts)
        _, diag = replay_emulation(settings, planes, counts, out4, t_chk, g)
        if kind == "saturated":
            assert diag["zero_t_live_rows"] > 0
            # column 3 underflows to exactly 0, columns 8-15 stay live
            final = t_chk[t, -1].reshape(settings.tile_h, settings.tile_w)
            assert (final[:, 3] == 0).all()
            assert (final[:, 8:] >= T_EPS).all()
        else:
            assert t in diag["dead_at_1"]


def test_unreached_slots_are_zero():
    """Slots past the block's stop (and of unused chunks and padding)
    are zero rows, as in the plain version."""
    settings, planes, counts = _case("dead_warp")
    out4, t_chk, g = _forward_and_cotangent(settings, planes, counts)
    want, _ = tile.tile_bwd_plain(settings, planes, counts, t_chk, g)
    got, _ = replay_emulation(settings, planes, counts, out4, t_chk, g)
    unreached = (want == 0).all(dim=1)
    assert unreached.any()
    assert (got.permute(0, 2, 1)[unreached] == 0).all()


def test_tile_kernel_shape():
    """B5f and B5b run one thread per tile column, whole warps
    (``tile.launch_shape``: ``column_shape``, B1/B2's): 128 x 8 at the
    training tiles, 128 x 1 at 8x16, 256 x 8 at 16x128; a tile width
    that does not divide the block is refused."""
    assert tile.launch_shape(WIDE) == column_shape(WIDE, "B5b") == (128, 8)
    assert tile.launch_shape(SMALL) == column_shape(SMALL, "B5b") \
        == (128, 1)
    taller = dataclasses.replace(WIDE, tile_h=16, image_height=32)
    assert tile.launch_shape(taller) == column_shape(taller, "B5b") \
        == (256, 8)
    odd = dataclasses.replace(SMALL, tile_w=48, image_width=48)
    with pytest.raises(ValueError, match="B5b"):
        column_shape(odd, "B5b")
    with pytest.raises(ValueError, match="B5f"):
        tile.launch_shape(odd)


@pytest.mark.parametrize("bad", ["shape", "dtype", "device"])
def test_tile_backward_checks_out4(bad):
    """The backward takes the forward's out4 (kernel B5b reads its colour
    total) and refuses a malformed one on every device."""
    settings, planes, counts = _case("random")
    out4, t_chk, g = _forward_and_cotangent(settings, planes, counts)
    grads = tile.tile_backward(settings, planes, counts, out4, t_chk, g)
    want, _ = tile.tile_bwd_plain(settings, planes, counts, t_chk, g)
    assert torch.equal(grads, want)
    bad_out4 = {"shape": out4[:, :3], "dtype": out4.double(),
                "device": out4.to("meta")}[bad]
    with pytest.raises(ValueError, match="out4"):
        tile.tile_backward(settings, planes, counts, bad_out4, t_chk, g)
