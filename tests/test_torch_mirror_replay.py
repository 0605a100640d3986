"""Kernel B2's replay of the mirror composite (gsvc_tpu_torch/csrc/
mirror_bwd.cu, replay.cuh ``replay_chunk``), emulated in float32 on the
CPU and held against the plain version ``mirror_bwd_plain``.

The kernel walks each tile's composite positions FORWARD, evaluates each
copy's alpha once per pixel, and takes each copy's suffix from the colour
total that the forward wrote (``out4``) minus a running sum of w (c . g),
where the plain version replays in reverse and forms the suffix by a
reverse cumsum.  The emulation below runs the kernel's per-pixel loop for
every step at once: the block stop at the first position without a live
pixel, the per-warp skip (a warp, 32 threads of the kernel's block shape,
with no pixel at T >= T_EPS skips the chunk; inside a chunk it stops after
the first pair of copies without a live pixel), the column form of the
moments (d0 is a thread's) and the zero rows of unreached slots.  It
asserts that every term a skip leaves out is exactly zero.

Tolerance: 2e-3 of each attribute's largest gradient magnitude, B2's card
tolerance (chip_smoke.py BWD_REL_ERR): the suffix is a difference of the
colour total and a running sum where the plain version sums the later
terms, 1/(1 - alpha) amplifies that rounding up to 100x, and the pixel
sums run in other orders.

Cases (8x16 tiles, cap 64, chunk 16, both views of every tile): seeded
tiles with empty lists and counts that are not a multiple of the chunk;
a tile whose column 3 saturates in every row, so that T underflows to 0
inside a replayed chunk while other columns of the same warps stay live;
and a tile whose first warp's pixels all die inside the first chunk
(dead from position 1 on).
A fourth case takes 8x128 tiles (the training tiles: 128 threads of 8
pixels, a warp 32 columns of 8 rows).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsvc_tpu_torch.render import mirror
from gsvc_tpu_torch.render.bidir import column_shape
from gsvc_tpu_torch.render.splat import T_EPS, RasterSettings

BWD_REL_ERR = 2e-3
SMALL = RasterSettings(image_height=40, image_width=48, threshold=0.15,
                       tile_h=8, tile_w=16, gaussian_cap=64, chunk=16,
                       tiles_per_gaussian=32)
WIDE = RasterSettings(image_height=16, image_width=256, threshold=0.1,
                      tile_h=8, tile_w=128, gaussian_cap=64, chunk=16,
                      tiles_per_gaussian=32)
SATURATED_TILE, DEAD_WARP_TILE = 4, 7


def _random_tile(rng, settings, tile, n):
    """n seeded copies around ``tile`` (attribute rows [n, 9])."""
    tw, th, ntx = settings.tile_w, settings.tile_h, settings.n_tiles_x
    rows = np.zeros((n, 9), np.float32)
    rows[:, 0] = (tile % ntx) * tw + rng.uniform(-0.25, 1.25, n) * tw
    rows[:, 1] = (tile // ntx) * th + rng.uniform(-0.25, 1.25, n) * th
    sig = rng.uniform(1, 20, (n, 2))
    rows[:, 2] = 1 / sig[:, 0] ** 2
    rows[:, 4] = 1 / sig[:, 1] ** 2
    rows[:, 3] = rng.uniform(-0.4, 0.4, n) / (sig[:, 0] * sig[:, 1])
    rows[:, 5] = rng.uniform(0.05, 0.99, n)
    rows[:, 6:9] = rng.uniform(0, 1, (n, 3))
    return rows


def _band(rng, settings, tile, n, axis, lo, hi, sigma, opacity):
    """n copies with means in tile-local pixels [lo, hi) along ``axis``
    (0: x, 1: y), width ``sigma`` there and wide along the other axis:
    they cover a band of columns (axis 0) or rows (axis 1)."""
    tw, th, ntx = settings.tile_w, settings.tile_h, settings.n_tiles_x
    size = (tw, th)
    rows = np.zeros((n, 9), np.float32)
    rows[:, 0] = (tile % ntx) * tw + 0.5 * tw
    rows[:, 1] = (tile // ntx) * th + 0.5 * th
    rows[:, axis] += rng.uniform(lo, hi, n) - 0.5 * size[axis]
    rows[:, 2 + 2 * axis] = 1 / sigma ** 2
    rows[:, 4 - 2 * axis] = 1 / (4.0 * size[1 - axis]) ** 2
    rows[:, 5] = opacity
    rows[:, 6:9] = rng.uniform(0, 1, (n, 3))
    return rows


def _case(kind, seed=3):
    """(settings, attrs [2, M, 9], lists [2, T, cap], counts [2, T])."""
    settings = WIDE if kind == "wide" else SMALL
    rng = np.random.default_rng(seed)
    t_n, cap = settings.n_tiles, settings.gaussian_cap
    frames = []
    for f in range(2):
        per_tile = []
        for tile in range(t_n):
            n = int(rng.integers(0, cap + 1))
            if tile == 0:
                n = 0                               # an empty tile
            elif tile == 1:
                n = 37                              # 2 chunks + 5
            elif tile == 2:
                n = cap
            rows = _random_tile(rng, settings, tile, n)
            if kind == "saturated" and tile == SATURATED_TILE:
                # column 3 saturates in every row (alpha 0.99: T reaches 0
                # at copy ~23, inside chunk 1) while columns 8-15 of the
                # same warps stay live to the end
                rows = np.concatenate([
                    _band(rng, settings, tile, 40, 0, 2.95, 3.05, 1.0,
                          0.999),
                    _band(rng, settings, tile, 20, 0, 8.0, 16.0, 6.0,
                          0.05)])
            if kind == "dead_warp" and tile == DEAD_WARP_TILE:
                # warp 0 holds rows 0-1: eight opaque copies in chunk 0
                # kill them there, the rest of the tile lives on
                rows = np.concatenate([
                    _band(rng, settings, tile, 8, 1, 0.4, 0.6, 0.7, 0.98),
                    _band(rng, settings, tile, 8, 1, 3.0, 8.0, 6.0, 0.1),
                    _random_tile(rng, settings, tile, 30) * [1, 1, 1, 1, 1,
                                                             0.3, 1, 1, 1]])
            per_tile.append(rows.astype(np.float32))
        frames.append(per_tile)
    m = max(sum(len(r) for r in per_tile) for per_tile in frames)
    attrs = np.zeros((2, m, 9), np.float32)
    lists = np.full((2, t_n, cap), -1, np.int32)
    counts = np.zeros((2, t_n), np.int32)
    for f, per_tile in enumerate(frames):
        start = 0
        for tile, rows in enumerate(per_tile):
            attrs[f, start:start + len(rows)] = rows
            lists[f, tile, :len(rows)] = np.arange(start, start + len(rows))
            counts[f, tile] = len(rows)
            start += len(rows)
    return (settings, torch.from_numpy(attrs), torch.from_numpy(lists),
            torch.from_numpy(counts))


def replay_emulation(settings, attrs, tile_lists, counts, out4, t_chk,
                     g_out, skip=True):
    """Kernel B2's loop in float32, all grid steps at once.  Returns
    (per-copy gradients [2F*T, 9, cap] in grid order, diagnostics)."""
    f_n = attrs.shape[0]
    n_grid = 2 * f_n * settings.n_tiles
    sel = torch.arange(n_grid)
    tl = mirror._mirror_tiles(settings, attrs, tile_lists, counts, sel)
    threads, _ = column_shape(settings, "B1/B2")
    p_pix = settings.tile_h * settings.tile_w
    warp_of = (torch.arange(p_pix) % threads) // 32             # [P]
    n_warps = threads // 32
    chunk, n_chunks = tl.chunk, tl.n_chunks
    chk, o4, g4 = t_chk[tl.out_row], out4[tl.out_row], g_out[tl.out_row]
    g3 = g4[:, 0:3]
    # the suffix total: t_final g_T + g . out_rgb
    total = chk[:, n_chunks] * g4[:, 3] + (g3 * o4[:, 0:3]).sum(dim=1)
    pre = torch.zeros(n_grid, p_pix)
    grads = torch.zeros(n_grid, 9, settings.gaussian_cap)
    alive = torch.ones(n_grid, dtype=torch.bool)
    diag = dict(skipped_warp_chunks=0, early_stops=0, zero_t_live_rows=0,
                dead_at_1=set())

    def per_warp_any(x):                                       # [S, P]
        return torch.stack([x[:, warp_of == w].any(dim=1)
                            for w in range(n_warps)], dim=1)   # [S, W]

    for p in range(n_chunks):
        t0 = chk[:, p]
        alive &= (p < tl.n_used) & (t0.amax(dim=1) >= T_EPS)
        idx = alive.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        slot, alpha, act, d0, d1, r = tl.load(p, idx)
        t0 = t0[idx]
        walking = per_warp_any(t0 >= T_EPS) if skip \
            else torch.ones(len(idx), n_warps, dtype=torch.bool)
        diag["skipped_warp_chunks"] += int((~walking).sum())
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
            mask = walking[:, warp_of]                         # [S', P]
            # the terms a skip leaves out are exactly zero
            assert (terms.permute(0, 2, 1)[~mask] == 0).all()
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


def _forward_and_cotangent(settings, attrs, lists, counts, seed=11):
    out4, t_chk, _ = mirror.mirror_fwd_plain(settings, attrs, lists, counts)
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
    settings, attrs, lists, counts = _case(kind)
    out4, t_chk, g = _forward_and_cotangent(settings, attrs, lists, counts)
    want, _ = mirror.mirror_bwd_plain(settings, attrs, lists, counts, t_chk,
                                      g)
    got, diag = replay_emulation(settings, attrs, lists, counts, out4,
                                 t_chk, g)
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= BWD_REL_ERR
    # the skips change nothing: the walk without them gives the same bits
    full, _ = replay_emulation(settings, attrs, lists, counts, out4, t_chk,
                               g, skip=False)
    assert torch.equal(got, full)
    if kind in ("saturated", "dead_warp"):
        assert diag["skipped_warp_chunks"] > 0 and diag["early_stops"] > 0


def test_cases_reach_their_corner():
    """Each case holds what it is named for: lists that end inside a chunk
    and an empty tile (both views of each); a replayed chunk in which a
    walking warp's pixel has T = 0 while the block is still live; a warp
    dead from position 1 on in the forward view of its tile."""
    settings, attrs, lists, counts = _case("random")
    assert (counts == 0).any() and (counts % settings.chunk != 0).any()
    for kind, tile in (("saturated", SATURATED_TILE),
                       ("dead_warp", DEAD_WARP_TILE)):
        settings, attrs, lists, counts = _case(kind)
        out4, t_chk, g = _forward_and_cotangent(settings, attrs, lists,
                                                counts)
        _, diag = replay_emulation(settings, attrs, lists, counts, out4,
                                   t_chk, g)
        _, _, out_all = mirror.grid_rows(settings, 2, "cpu")
        if kind == "saturated":
            assert diag["zero_t_live_rows"] > 0
            chk = t_chk[out_all[2 * tile]]                     # f0, fwd
            # column 3 underflows to exactly 0, columns 8-15 stay live
            final = chk[-1].reshape(settings.tile_h, settings.tile_w)
            assert (final[:, 3] == 0).all()
            assert (final[:, 8:] >= T_EPS).all()
        else:
            assert 2 * tile in diag["dead_at_1"]               # f0, fwd


def test_unreached_slots_are_zero():
    """Slots past the block's stop (and of unused chunks and padding)
    are zero rows, as in the plain version."""
    settings, attrs, lists, counts = _case("dead_warp")
    out4, t_chk, g = _forward_and_cotangent(settings, attrs, lists, counts)
    want, _ = mirror.mirror_bwd_plain(settings, attrs, lists, counts, t_chk,
                                      g)
    got, _ = replay_emulation(settings, attrs, lists, counts, out4, t_chk, g)
    unreached = (want == 0).all(dim=1)
    assert unreached.any()
    assert (got.permute(0, 2, 1)[unreached] == 0).all()


def test_mirror_kernel_shape():
    """B1/B2 run one thread per tile column (``column_shape``): 128 x 8
    at the training tiles, 128 x 1 at 8x16, 256 x 8 at 8x256 and at
    16x128 (at most 8 pixels a thread while the block allows), 256 x 16
    at 16x256, and refuse a tile width that does not divide the block."""
    assert column_shape(WIDE, "B1/B2") == (128, 8)
    assert column_shape(SMALL, "B1/B2") == (128, 1)
    wider = dataclasses.replace(WIDE, tile_w=256, image_width=512)
    assert column_shape(wider, "B1/B2") == (256, 8)
    taller = dataclasses.replace(WIDE, tile_h=16, image_height=32)
    assert column_shape(taller, "B1/B2") == (256, 8)
    both = dataclasses.replace(wider, tile_h=16, image_height=32)
    assert column_shape(both, "B1/B2") == (256, 16)
    odd = dataclasses.replace(SMALL, tile_w=48, image_width=48)
    with pytest.raises(ValueError, match="B1/B2"):
        column_shape(odd, "B1/B2")


def test_mirror_backward_checks_out4():
    """The backward takes the forward's out4 (kernel B2 reads its colour
    total) and refuses one of the wrong shape on every device."""
    settings, attrs, lists, counts = _case("random")
    out4, t_chk, g = _forward_and_cotangent(settings, attrs, lists, counts)
    grads = mirror.mirror_backward(settings, attrs, lists, counts, out4,
                                   t_chk, g)
    want, _ = mirror.mirror_bwd_plain(settings, attrs, lists, counts, t_chk,
                                      g)
    assert torch.equal(grads, want)
    with pytest.raises(ValueError, match="out4"):
        mirror.mirror_backward(settings, attrs, lists, counts, out4[:, :3],
                               t_chk, g)
