"""Kernel B5f's walk of the single-view composite (gsvc_tpu_torch/csrc/
tile_fwd.cu on replay.cuh's stage and column alpha), emulated in float32
on the CPU and held against the full-chunk walk and the plain version
``tile_fwd_plain``.

The kernel runs one thread a pixel column: it forms a copy's x terms of
the alpha once (``column_at``: d0 = x - mean x, (conic a * -1/2) d0,
(conic b * -1/2) d0) and finishes the alpha per pixel (``alpha_col``),
every product and sum rounded on its own in the plain version's order.
Each chunk's walk ends at the row's count (clamped to cap where a list
overflowed), so the padding slots of a partly filled last chunk are not
walked; the stop is chunk-granular: a row runs chunk c only while c is a
used chunk and some pixel of the tile, those past the image's right and
bottom edges included, keeps T >= T_EPS.  The emulation below runs that
walk for every row at once (float32 elementwise operations, each rounded
on its own), and the same walk over every slot of a used chunk, which is
the kernel's earlier design.

Bit for bit: a padding slot carries opacity 0 (``gather_tile_planes_rows``
forces it), so its alpha is exactly 0, ``e *= 1 - 0`` changes no bit and
its weight adds exactly 0: ending the walk at the count changes no bit of
out4 or t_chk.  Tolerance against the plain version: 2 T_EPS, the card
tolerance of tests/test_torch_kernels.py's ``test_tile_kernels_match_plain``
(both run the same chunk stops and differ by float rounding, except where
a pixel's transmittance rounds across T_EPS on one side only);
``tile_fwd_plain`` is held to JAX in tests/test_torch_tile.py.

Cases: two views of a frame 40 px wide (8x16 tiles: the last tile column
reaches 8 px past the image; 8x128 tiles: 88 px), cap 64, chunk 16, with
empty lists, counts that are a multiple of the chunk and counts that are
not, full lists, counts above cap (an overflowed list), a tile that
saturates within its first chunk, and a background of 0.3.
"""

import numpy as np
import pytest
import torch

from gsvc_tpu_torch.render import tile
from gsvc_tpu_torch.render.splat import (
    ALPHA_MAX, ALPHA_MIN, T_EPS, RasterSettings, _bin_gaussians,
    attr_rows_from_proj, gather_tile_planes_rows, project_gaussians,
)
from test_torch_mirror_replay import _band, _random_tile
from test_torch_stream_replay import _scene

BG = 0.3
NARROW_16 = RasterSettings(image_height=40, image_width=40, threshold=0.15,
                           tile_h=8, tile_w=16, gaussian_cap=64, chunk=16,
                           tiles_per_gaussian=32, bg=BG)
NARROW_128 = RasterSettings(image_height=40, image_width=40, threshold=0.15,
                            tile_h=8, tile_w=128, gaussian_cap=64, chunk=16,
                            tiles_per_gaussian=32, bg=BG)
SETTINGS = {"8x16": NARROW_16, "8x128": NARROW_128}
SATURATED_TILE = 1


def _case(name, seed=7):
    """(settings, planes 9 x [V*T, cap], counts [V*T]) of two views; a
    count above cap stands for a list that overflowed (its planes hold
    the first cap copies)."""
    settings = SETTINGS[name]
    rng = np.random.default_rng(seed)
    t_n, cap, chunk = settings.n_tiles, settings.gaussian_cap, settings.chunk
    fixed = [0, 2 * chunk + 5, cap, 3 * chunk, cap + 9]
    planes, counts = [], []
    for view in range(2):
        per_tile, cnt = [], []
        for t in range(t_n):
            n = fixed[(t + view) % len(fixed)] if t < len(fixed) \
                else int(rng.integers(0, cap + 1))
            rows = _random_tile(rng, settings, t, min(n, cap))
            if t == SATURATED_TILE:
                # opaque bands over every pixel of the tile (those past
                # the image included): the row stops after chunk 0
                rows = np.concatenate([
                    _band(rng, settings, t, 8, 1, 0.0, float(settings.tile_h),
                          20.0, 0.99),
                    _random_tile(rng, settings, t, max(min(n, cap) - 8,
                                                       0))])
                n = max(n, len(rows))
            per_tile.append(rows.astype(np.float32))
            cnt.append(n)
        m = sum(len(r) for r in per_tile)
        attrs = np.zeros((max(m, 1), 9), np.float32)
        lists = np.full((t_n, cap), -1, np.int32)
        start = 0
        for t, rows in enumerate(per_tile):
            attrs[start:start + len(rows)] = rows
            lists[t, :len(rows)] = np.arange(start, start + len(rows))
            start += len(rows)
        planes.append(gather_tile_planes_rows(torch.from_numpy(attrs),
                                              torch.from_numpy(lists)))
        counts += cnt
    return (settings,
            tuple(torch.cat([p[i] for p in planes]).contiguous()
                  for i in range(9)),
            torch.tensor(counts, dtype=torch.int32))


def walk_emulation(settings, planes, counts, to_count=True):
    """Kernel B5f's loop in float32, all rows at once: the column x terms
    once per copy, alpha_col's rounding order, the chunk-granular stop,
    and each chunk walked to the row's count (``to_count``) or over every
    slot of a used chunk.  Returns (out4 [V*T, 4, P], t_chk [V*T,
    n_chunks + 1, P], walked (copy, pixel) pairs of padding slots)."""
    n_rows = planes[0].shape[0]
    th, tw = settings.tile_h, settings.tile_w
    chunk, cap = settings.chunk, settings.gaussian_cap
    n_chunks = cap // chunk
    p_pix = th * tw
    u = torch.arange(n_rows) % settings.n_tiles
    cx = ((u % settings.n_tiles_x) * tw).float() + (tw - 1) / 2.0
    cy = ((u // settings.n_tiles_x) * th).float() + (th - 1) / 2.0
    lin = torch.arange(p_pix)
    x = (lin % tw).float() - (tw - 1) / 2.0                     # [P]
    y = (lin // tw).float() - (th - 1) / 2.0
    count = counts.long().clamp(max=cap)
    n_used = (count + chunk - 1) // chunk
    t = torch.ones(n_rows, p_pix)
    acc = torch.zeros(n_rows, 3, p_pix)
    t_chk = torch.empty(n_rows, n_chunks + 1, p_pix)
    alive = torch.ones(n_rows, dtype=torch.bool)
    padding_pairs = 0
    for c in range(n_chunks):
        t_chk[:, c] = t
        alive &= (c < n_used) & (t.amax(dim=1) >= T_EPS)
        idx = alive.nonzero().squeeze(1)
        if idx.numel() == 0:
            continue
        real = (count[idx] - c * chunk).clamp(0, chunk)         # [S]
        n = real if to_count else torch.full_like(real, chunk)
        e = torch.ones(len(idx), p_pix)
        ti, ai = t[idx], acc[idx]
        for j in range(chunk):
            walk = (j < n)[:, None]                             # [S, 1]
            padding_pairs += int(((j < n) & (j >= real)).sum()) * p_pix
            k = c * chunk + j
            # the stage: tile-local means, conic * -1/2
            mx = planes[0][idx, k] - cx[idx]
            my = planes[1][idx, k] - cy[idx]
            ha, hb, hc = (-0.5 * planes[q][idx, k] for q in (2, 3, 4))
            op = planes[5][idx, k]
            rgb = [planes[q][idx, k] for q in (6, 7, 8)]
            # column_at: the x terms, once per copy and column
            d0 = x[None] - mx[:, None]                          # [S, P]
            had0, hbd0 = ha[:, None] * d0, hb[:, None] * d0
            # alpha_col: per pixel
            d1 = y[None] - my[:, None]
            uu = had0 + hb[:, None] * d1
            vv = hbd0 + hc[:, None] * d1
            q = d0 * uu + d1 * vv
            raw = op[:, None] * torch.exp(q)
            a = torch.clamp(raw, max=ALPHA_MAX)
            a = torch.where(a >= ALPHA_MIN, a, torch.zeros_like(a))
            tb = ti * e
            w = torch.where(tb >= T_EPS, a * tb, torch.zeros_like(a))
            for ch in range(3):
                ai[:, ch] = torch.where(walk, ai[:, ch]
                                        + w * rgb[ch][:, None], ai[:, ch])
            e = torch.where(walk, e * (1.0 - a), e)
        t[idx] = ti * e
        acc[idx] = ai
    t_chk[:, n_chunks] = t
    out4 = torch.cat([acc + t[:, None] * settings.bg, t[:, None]], dim=1)
    return out4, t_chk, padding_pairs


@pytest.mark.parametrize("name", ["8x16", "8x128"])
def test_walk_to_count_equals_full_chunk_walk(name):
    """Ending each chunk's walk at the row's count changes no bit of out4
    or t_chk: the slots it leaves out are padding (opacity 0)."""
    settings, planes, counts = _case(name)
    out4, t_chk, skipped = walk_emulation(settings, planes, counts)
    full4, full_chk, padding = walk_emulation(settings, planes, counts,
                                              to_count=False)
    assert skipped == 0 and padding > 0
    assert torch.equal(out4, full4) and torch.equal(t_chk, full_chk)


@pytest.mark.parametrize("name", ["8x16", "8x128"])
def test_walk_matches_plain(name):
    """The emulated walk against ``tile_fwd_plain`` to 2 T_EPS: out4 and
    every checkpoint."""
    settings, planes, counts = _case(name)
    out4, t_chk, _ = walk_emulation(settings, planes, counts)
    want4, want_chk, pairs = tile.tile_fwd_plain(settings, planes, counts)
    assert pairs > 0 and torch.isfinite(out4).all()
    torch.testing.assert_close(out4, want4, atol=2 * T_EPS, rtol=0)
    torch.testing.assert_close(t_chk, want_chk, atol=2 * T_EPS, rtol=0)


@pytest.mark.parametrize("name", ["8x16", "8x128"])
def test_cases_reach_their_corner(name):
    """Each case holds what it is named for: empty rows, counts that are
    a multiple of the chunk and counts that are not, counts above cap,
    tile columns past the image's right edge, and a row whose every
    pixel (those past the image included) saturates inside chunk 0, so
    that it stops with used chunks left and its later checkpoints hold
    the final T."""
    settings, planes, counts = _case(name)
    cap, chunk = settings.gaussian_cap, settings.chunk
    assert (counts == 0).any() and (counts > cap).any()
    assert ((counts % chunk == 0) & (counts > 0)).any()
    assert (counts % chunk != 0).any()
    assert settings.n_tiles_x * settings.tile_w > settings.image_width
    _, t_chk, _ = walk_emulation(settings, planes, counts)
    sat = t_chk[SATURATED_TILE]
    assert int(counts[SATURATED_TILE]) > chunk
    assert float(sat[1].max()) < T_EPS
    assert torch.equal(sat[2:], sat[-1:].expand_as(sat[2:]))


@pytest.mark.parametrize("m, seed, grow", [
    (40, 0, 1.0), (150, 5, 3.0), (300, 4, 1.5), (120, 9, 2.5)],
    ids=["sparse", "crowded", "dense", "mixed"])
def test_padding_slots_have_zero_opacity(m, seed, grow):
    """Every slot at or past a row's count in ``gather_tile_planes_rows``'
    planes (binned lists, -1 past the count) has opacity exactly 0, so
    its alpha is exactly 0 and the kernels may end their walk at the
    count; the slots before it hold their gaussians' opacity."""
    settings = RasterSettings(image_height=40, image_width=40,
                              threshold=0.15, tile_h=8, tile_w=16,
                              gaussian_cap=64, chunk=16,
                              tiles_per_gaussian=32)
    proj = project_gaussians(*_scene(m, seed, grow), 0.0, -1.0, -0.75,
                             24.0, settings)
    lists, counts = _bin_gaussians(proj, settings)[:2]
    rng = np.random.default_rng(seed)
    opacity = torch.from_numpy(rng.uniform(0.05, 1.0, (m, 1))
                               .astype(np.float32))
    color = torch.from_numpy(rng.uniform(0, 1, (m, 3)).astype(np.float32))
    planes = gather_tile_planes_rows(
        attr_rows_from_proj(proj, opacity, color), lists)
    slot = torch.arange(settings.gaussian_cap)[None]
    past = slot >= counts.long()[:, None]
    assert past.any() and (~past).any()
    assert (planes[5][past] == 0).all()
    assert torch.equal(planes[5][~past],
                       opacity[lists.long()[~past], 0])
