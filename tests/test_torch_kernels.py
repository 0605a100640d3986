"""Card-only tests of the port's hand-written kernels against their plain
PyTorch versions on the same card.

These need an NVIDIA GPU and skip elsewhere.  The file imports neither
JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

(``--noconftest`` skips tests/conftest.py, which configures JAX.)
Forward tolerance (B4, B1): 2 T_EPS — both versions run the same
chunk-granular loop stops and differ by float rounding, except where a
pixel's transmittance rounds across T_EPS on one side only (one term of
weight < T_EPS per view).  Backward tolerance (B2): 2e-3 of the largest
gradient magnitude of each attribute — the kernel forms each suffix as
the colour total of the forward's out4 minus a running sum, the plain
version by a reverse cumsum, and 1/(1 - alpha) amplifies that rounding up
to 100x; the pixel sums are also taken in other orders.  B2 adds no float
atomics: two launches on the same inputs give the same bits.  Besides the
seeded tiles, B1/B2 take the replay cases of
tests/test_torch_mirror_replay.py: a tile whose T underflows to 0 inside
a replayed chunk, a warp dead from position 1 on, 8x128 tiles.

B4 runs one thread-block cluster per tile, heaviest tiles first: every
cluster size its C entry takes gives the same bits, and a cluster the
card refuses raises.

Single-view kernels B5f/B5b (widths that are not a multiple of tile_w):
the forward and checkpoints to 2 T_EPS, the gradients to 2e-3 of each
attribute's largest magnitude, for the reasons given for B1/B2; at an
aligned width B5f's output equals B1's forward view bit for bit on the
same copies, and a count above cap composites cap copies; B5b
(B2's replay on B5f's out4) adds no float atomics either, and takes the
replay cases of tests/test_torch_tile_replay.py and the 16x128 tiles
(256 threads, past the 48 KiB of shared memory a block gets without
opting in).

Stream kernels B6f/B6b (the chunk-aligned copy stream of the same seeded
lists, chunk 16 and 128, with dead tail blocks): the forward and the
per-block checkpoints to 2 T_EPS, the gradients to 2e-3 of each
attribute's largest magnitude, for the reasons given for B1/B2; B6f's
output equals B1's bit for bit on the same copies, and B6b (B2's replay
on B6f's out4) takes the replay cases of
tests/test_torch_stream_replay.py and the 16x128 tiles (256 threads,
past 48 KiB of shared memory).

Hash-grid kernels B3f/B3b (at the fixture's spec, F = 8, 12 3D + 4 2D
levels, N = 25k and 150k queries): the forward equals the plain version
to 1e-6 (both round the cell, the corner sums and the division alike);
the gradients to 1e-4 of the largest gradient magnitude — the table
gradient is an atomic sum whose order changes from run to run (float32,
up to ~10^3 terms per row at N = 150k: n eps ~ 6e-5 relative), and the
kernel forms each position gradient as sum_c r_c dw_c with r_c = sum_f
g_f (V_cf - out_f) / W where autograd takes the two terms apart.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsvc_tpu_torch.ops import hashgrid_kernels as hk
from gsvc_tpu_torch.ops.hashgrid import make_mix_grid_spec
from gsvc_tpu_torch.render import bidir, mirror, stream, tile
from gsvc_tpu_torch.render.bidir import column_shape
from gsvc_tpu_torch.render.splat import (
    T_EPS, RasterSettings, gather_tile_planes_rows,
)
from test_torch_mirror_replay import _case as replay_case
from test_torch_stream_replay import stream_case as stream_replay_case
from test_torch_tile_replay import _case as tile_replay_case

SMALL = RasterSettings(image_height=40, image_width=48, threshold=0.15,
                       tile_h=8, tile_w=16, gaussian_cap=64, chunk=16,
                       tiles_per_gaussian=32)
DECODE = RasterSettings(image_height=64, image_width=384, threshold=0.1,
                        tile_h=16, tile_w=128, gaussian_cap=1024, chunk=128,
                        tiles_per_gaussian=32)
TRAIN = RasterSettings(image_height=32, image_width=384, threshold=0.1,
                       tile_h=8, tile_w=128, gaussian_cap=1024, chunk=128,
                       tiles_per_gaussian=32)
BWD_REL = 2e-3


def _tiles(settings, seed, opacity_hi):
    """Seeded attribute rows around each tile, counts 0..cap (empty,
    full and partial last chunks), as CUDA tensors."""
    rng = np.random.default_rng(seed)
    t_n, cap = settings.n_tiles, settings.gaussian_cap
    counts = rng.integers(0, cap + 1, t_n)
    counts[0], counts[-1] = 0, cap
    owner = np.repeat(np.arange(t_n), counts)
    m = max(len(owner), 1)
    attrs = np.zeros((m, 9), np.float32)
    tw, th = settings.tile_w, settings.tile_h
    attrs[:len(owner), 0] = (owner % settings.n_tiles_x) * tw \
        + rng.uniform(-0.25, 1.25, len(owner)) * tw
    attrs[:len(owner), 1] = (owner // settings.n_tiles_x) * th \
        + rng.uniform(-0.25, 1.25, len(owner)) * th
    sig = rng.uniform(1, 30, (len(owner), 2))
    attrs[:len(owner), 2] = 1 / sig[:, 0] ** 2
    attrs[:len(owner), 4] = 1 / sig[:, 1] ** 2
    attrs[:len(owner), 3] = rng.uniform(-0.4, 0.4, len(owner)) / (
        sig[:, 0] * sig[:, 1])
    attrs[:len(owner), 5] = rng.uniform(0.05, opacity_hi, len(owner))
    attrs[:len(owner), 6:9] = rng.uniform(0, 1, (len(owner), 3))
    lists = np.full((t_n, cap), -1, np.int32)
    start = np.cumsum(counts) - counts
    lists[owner, np.arange(len(owner)) - start[owner]] = np.arange(
        len(owner), dtype=np.int32)
    return (torch.from_numpy(attrs)[None].cuda(),
            torch.from_numpy(lists)[None].cuda(),
            torch.from_numpy(counts.astype(np.int32))[None].cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "decode"])
@pytest.mark.parametrize("opacity_hi", [0.1, 0.99])
def test_bidir_kernel_matches_plain(shape, opacity_hi):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    settings = SMALL if shape == "small" else DECODE
    attrs, lists, counts = _tiles(settings, seed=1, opacity_hi=opacity_hi)
    before = bidir.bidir_composite_attrs.launches
    img_k, tau_k = bidir.bidir_composite_attrs(settings, attrs, lists,
                                               counts)
    assert bidir.bidir_composite_attrs.launches == before + 1
    img_p, tau_p = bidir.bidir_composite_plain(settings, attrs, lists,
                                               counts)
    torch.cuda.synchronize()
    assert torch.isfinite(img_k).all()
    torch.testing.assert_close(img_k, img_p, atol=2 * T_EPS, rtol=0)
    torch.testing.assert_close(tau_k, tau_p, atol=2 * T_EPS, rtol=0)


def _strip(settings, seed):
    """A decoded frame's imbalance: a vertical strip of full tiles (two
    tile columns, every count at cap, copies that keep the strip
    unsaturated so every chunk is walked) among tiles of 0-40 copies."""
    rng = np.random.default_rng(seed)
    t_n, cap, ntx = settings.n_tiles, settings.gaussian_cap, \
        settings.n_tiles_x
    col = np.arange(t_n) % ntx
    strip = (col == ntx // 2) | (col == ntx // 2 + 1)
    cnt = np.where(strip, cap, rng.integers(0, 41, t_n)).astype(np.int32)
    m = int(cnt.sum())
    owner = np.repeat(np.arange(t_n), cnt)
    tw, th = settings.tile_w, settings.tile_h
    rows = np.zeros((m, 9), np.float32)
    rows[:, 0] = (owner % ntx) * tw + rng.uniform(-0.25, 1.25, m) * tw
    rows[:, 1] = (owner // ntx) * th + rng.uniform(-0.25, 1.25, m) * th
    sig = rng.uniform(1, 30, (m, 2))
    rows[:, 2] = 1 / sig[:, 0] ** 2
    rows[:, 4] = 1 / sig[:, 1] ** 2
    rows[:, 5] = np.where(strip[owner], rng.uniform(0.003, 0.01, m),
                          rng.uniform(0.05, 0.9, m))
    rows[:, 6:9] = rng.uniform(0, 1, (m, 3))
    lists = np.full((t_n, cap), -1, np.int32)
    start = np.cumsum(cnt) - cnt
    lists[owner, np.arange(m) - start[owner]] = np.arange(m, dtype=np.int32)
    return (torch.from_numpy(rows)[None].cuda(),
            torch.from_numpy(lists)[None].cuda(),
            torch.from_numpy(cnt)[None].cuda())


STRIP = RasterSettings(image_height=160, image_width=768, threshold=0.1,
                       tile_h=16, tile_w=128, gaussian_cap=1024, chunk=128,
                       tiles_per_gaussian=32)


@pytest.mark.cuda
def test_bidir_kernel_on_an_imbalanced_frame():
    """A strip of full, unsaturated tiles among near-empty ones (a decoded
    frame's imbalance, where one tile holds ~1000x the pairs of most):
    kernel against its plain version at the decode tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    attrs, lists, counts = _strip(STRIP, 3)
    out_k = bidir.bidir_out4_cuda(STRIP, attrs, lists, counts)
    out_p, pairs = bidir.bidir_out4_plain(STRIP, attrs, lists, counts)
    torch.cuda.synchronize()
    full = int((counts == STRIP.gaussian_cap).sum())
    # the strip's tiles walk every chunk: most of the frame's pairs
    assert full == 2 * STRIP.n_tiles_y and pairs >= 0.8 * full * \
        STRIP.gaussian_cap * STRIP.tile_h * STRIP.tile_w
    assert torch.isfinite(out_k).all()
    torch.testing.assert_close(out_k, out_p, atol=2 * T_EPS, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("settings", [SMALL, DECODE, STRIP],
                         ids=["small", "decode", "strip"])
def test_bidir_cluster_sizes_give_the_same_bits(settings):
    """Every cluster size the C entry takes (1, 2, 4, 8 CTAs a tile)
    gives the launch plan's output bit for bit: each pixel sees the same
    copies, operations and tile stops."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if settings is STRIP:
        attrs, lists, counts = _strip(STRIP, 4)
    else:
        attrs, lists, counts = _tiles(settings, seed=5, opacity_hi=0.99)
    want = bidir.bidir_out4_cuda(settings, attrs, lists, counts)
    assert bidir.bidir_launch_plan(settings)[0] == bidir.B4_CLUSTER >= 2
    for cluster in (1, 2, 4, 8):
        got = bidir.bidir_out4_cuda(settings, attrs, lists, counts,
                                    cluster=cluster)
        torch.cuda.synchronize()
        assert torch.equal(got, want), cluster


@pytest.mark.cuda
def test_bidir_refused_cluster_launch_raises():
    """A cluster the card does not take (16 CTAs without the non-portable
    attribute) raises instead of running another shape; the next launch
    runs clean."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    attrs, lists, counts = _tiles(DECODE, seed=6, opacity_hi=0.5)
    with pytest.raises(RuntimeError, match="16 CTAs a tile"):
        bidir.bidir_out4_cuda(DECODE, attrs, lists, counts, cluster=16)
    out = bidir.bidir_out4_cuda(DECODE, attrs, lists, counts)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


@pytest.mark.cuda
def test_bidir_kernel_rejects_non_contiguous():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    attrs, lists, counts = _tiles(SMALL, seed=2, opacity_hi=0.5)
    lists_nc = lists.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        bidir.bidir_composite_attrs(SMALL, attrs, lists_nc, counts)


def _frames(settings, seed, opacity_hi, n_frames=2):
    """F frames of seeded tiles, stacked: attrs [F, M, 9] (M the largest
    frame's rows, the others zero padded), lists [F, T, cap], counts
    [F, T]."""
    parts = [_tiles(settings, seed + f, opacity_hi) for f in range(n_frames)]
    m = max(p[0].shape[1] for p in parts)
    attrs = torch.zeros((n_frames, m, 9), device="cuda")
    for f, p in enumerate(parts):
        attrs[f, :p[0].shape[1]] = p[0][0]
    return (attrs.contiguous(), torch.cat([p[1] for p in parts]),
            torch.cat([p[2] for p in parts]))


def _check_bwd(got, want):
    for k in range(9):
        scale = float(want[:, k].abs().max())
        err = float((got[:, k] - want[:, k]).abs().max())
        assert err <= BWD_REL * max(scale, 1e-12), (k, err, scale)


def _mirror_case(shape, opacity_hi):
    """(settings, attrs, lists, counts) on the card: seeded tiles at the
    small, training or 16x128 decode shapes (B1/B2 at 128 x 1, 128 x 8 and
    256 x 8 threads x pixels), or a replay case (saturated, dead_warp,
    wide) of tests/test_torch_mirror_replay.py."""
    if shape in ("small", "train", "decode"):
        settings = {"small": SMALL, "train": TRAIN, "decode": DECODE}[shape]
        return (settings, *_frames(settings, 3, opacity_hi))
    settings, attrs, lists, counts = replay_case(shape)
    return settings, attrs.cuda(), lists.cuda(), counts.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("shape, opacity_hi", [
    ("small", 0.1), ("small", 0.99), ("train", 0.1), ("train", 0.99),
    ("decode", 0.99), ("saturated", None), ("dead_warp", None),
    ("wide", None)])
def test_mirror_kernels_match_plain(shape, opacity_hi):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    settings, attrs, lists, counts = _mirror_case(shape, opacity_hi)
    before = mirror.mirror_forward.launches
    out_k, chk_k = mirror.mirror_forward(settings, attrs, lists, counts)
    assert mirror.mirror_forward.launches == before + 1
    out_p, chk_p, _ = mirror.mirror_fwd_plain(settings, attrs, lists, counts)
    torch.cuda.synchronize()
    assert torch.isfinite(out_k).all()
    torch.testing.assert_close(out_k, out_p, atol=2 * T_EPS, rtol=0)
    torch.testing.assert_close(chk_k, chk_p, atol=2 * T_EPS, rtol=0)

    g = torch.randn(out_p.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(4))
    before = mirror.mirror_backward.launches
    gr_k = mirror.mirror_backward(settings, attrs, lists, counts, out_p,
                                  chk_p, g)
    assert mirror.mirror_backward.launches == before + 1
    gr_p, _ = mirror.mirror_bwd_plain(settings, attrs, lists, counts, chk_p,
                                      g)
    torch.cuda.synchronize()
    assert torch.isfinite(gr_k).all()
    _check_bwd(gr_k, gr_p)
    # on B1's own outputs, as the autograd function runs it
    gr_1 = mirror.mirror_backward(settings, attrs, lists, counts, out_k,
                                  chk_k, g)
    gr_p1, _ = mirror.mirror_bwd_plain(settings, attrs, lists, counts, chk_k,
                                       g)
    torch.cuda.synchronize()
    _check_bwd(gr_1, gr_p1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["train", "saturated"])
def test_mirror_backward_is_deterministic(shape):
    """Two B2 launches on the same inputs give bit-identical per-copy
    rows (fixed-order reductions, no float atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    settings, attrs, lists, counts = _mirror_case(shape, 0.99)
    out, chk = mirror.mirror_forward(settings, attrs, lists, counts)
    g = torch.randn(out.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(6))
    first = mirror.mirror_backward(settings, attrs, lists, counts, out, chk,
                                   g)
    second = mirror.mirror_backward(settings, attrs, lists, counts, out, chk,
                                    g)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_mirror_views_do_not_collide():
    """Both views of every data tile hold the same copies: the kernel
    writes each view's gradients to its own row and the scatter adds
    them, so the summed and per-view gradients equal the plain
    version's (a cross-block add into one row would race here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    attrs, lists, counts = _frames(SMALL, 9, 0.6)
    m2d = torch.zeros((4, attrs.shape[1], 2), device="cuda",
                      requires_grad=True)
    a = attrs.clone().requires_grad_(True)
    out = mirror.mirror_composite_attrs(SMALL, a, lists, counts, m2d)
    g = torch.randn(out.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(5))
    out.backward(g)
    _, chk, _ = mirror.mirror_fwd_plain(SMALL, attrs, lists, counts)
    gr_p, _ = mirror.mirror_bwd_plain(SMALL, attrs, lists, counts, chk, g)
    da_p, dm_p = mirror.scatter_grads(SMALL, gr_p, lists, attrs.shape[1],
                                      per_view=True)
    torch.cuda.synchronize()
    _check_bwd(a.grad.reshape(-1, 9)[:, :, None],
               da_p.reshape(-1, 9)[:, :, None])
    for view in range(4):
        scale = float(dm_p[view].abs().max())
        assert scale > 0
        err = float((m2d.grad[view] - dm_p[view]).abs().max())
        assert err <= BWD_REL * scale, (view, err, scale)


def _stream(settings, seed, opacity_hi):
    """Seeded tiles of two frames as the stream composite's inputs: attrs
    [2, M, 9] and the chunk-aligned stream of their lists, sized with
    spare (dead) blocks at each frame's tail."""
    attrs, lists, counts = _frames(settings, seed, opacity_hi)
    nblk = torch.clamp((counts + settings.chunk - 1) // settings.chunk,
                       min=1)
    b_max = int(nblk.sum(dim=1).max()) + 3
    return attrs, stream.stream_from_tile_lists(settings, lists, counts,
                                                b_max)


def _live_blocks(bins, chunk):
    """Masks of the live blocks [F*B] and live slots [F*S]."""
    blk = bins[1] >= 0
    return blk, blk.repeat_interleave(chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "train"])
@pytest.mark.parametrize("opacity_hi", [0.1, 0.99])
def test_stream_kernels_match_plain(shape, opacity_hi):
    """B6f (with and without checkpoints) and B6b against their plain
    versions: empty tiles (one block of dead slots), full lists, partial
    last blocks, saturated tiles and dead tail blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    settings = SMALL if shape == "small" else TRAIN
    attrs, bins = _stream(settings, 11, opacity_hi)
    rows = stream.stream_rows(attrs, bins[0])
    before = stream.stream_forward.launches
    out_k, chk_k = stream.stream_forward(settings, rows, *bins)
    out_i, none = stream.stream_forward(settings, rows, *bins,
                                        save_tchk=False)
    assert stream.stream_forward.launches == before + 2 and none is None
    out_p, chk_p, pairs = stream.stream_fwd_plain(settings, rows, *bins)
    torch.cuda.synchronize()
    assert pairs > 0 and torch.isfinite(out_k).all()
    assert (bins[3] == 1).any() and (bins[1] < 0).any()
    torch.testing.assert_close(out_k, out_p, atol=2 * T_EPS, rtol=0)
    torch.testing.assert_close(chk_k, chk_p, atol=2 * T_EPS, rtol=0)
    torch.testing.assert_close(out_i, out_k, atol=0, rtol=0)

    g = torch.randn(out_p.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(12))
    before = stream.stream_backward.launches
    gr_k = stream.stream_backward(settings, rows, *bins, out_p, chk_p, g)
    assert stream.stream_backward.launches == before + 1
    gr_p, _ = stream.stream_bwd_plain(settings, rows, *bins, out_p, chk_p,
                                      g)
    torch.cuda.synchronize()
    assert torch.isfinite(gr_k).all()
    _, live = _live_blocks(bins, settings.chunk)
    assert float(gr_k[:, :, ~live].abs().max()) == 0.0
    for v in range(2):
        _check_bwd(gr_k[v].T[:, :, None], gr_p[v].T[:, :, None])


@pytest.mark.cuda
@pytest.mark.parametrize("with_m2d", [False, True])
def test_stream_composite_autograd_matches_plain(with_m2d):
    """``stream_composite_attrs`` on the card (B6f/B6b and the scatter)
    against the same autograd function on CPU copies: outputs, attribute
    gradients and each view's m2d gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    attrs, bins = _stream(SMALL, 13, 0.6)
    outs, grads = [], []
    for dev in ("cuda", "cpu"):
        a = attrs.to(dev).clone().requires_grad_(True)
        m2d = (torch.zeros((4, attrs.shape[1], 2), device=dev,
                           requires_grad=True) if with_m2d else None)
        out = stream.stream_composite_attrs(
            SMALL, a, *(b.to(dev) for b in bins), m2d)
        g = torch.randn(out.shape,
                        generator=torch.Generator().manual_seed(14))
        out.backward(g.to(dev))
        outs.append(out.detach().cpu())
        grads.append((a.grad.cpu(),
                      m2d.grad.cpu() if with_m2d else None))
    torch.testing.assert_close(outs[0], outs[1], atol=2 * T_EPS, rtol=0)
    _check_bwd(grads[0][0].reshape(-1, 9)[:, :, None],
               grads[1][0].reshape(-1, 9)[:, :, None])
    if with_m2d:
        for view in range(4):
            scale = float(grads[1][1][view].abs().max())
            assert scale > 0
            err = float((grads[0][1][view] - grads[1][1][view]).abs().max())
            assert err <= BWD_REL * scale, (view, err, scale)


@pytest.mark.cuda
def test_stream_kernels_raise_without_their_library(monkeypatch):
    """On CUDA tensors the stream composite launches its kernels or
    raises: a library that does not build, and settings the kernels do
    not take, raise instead of running the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    attrs, bins = _stream(SMALL, 15, 0.5)
    rows = stream.stream_rows(attrs, bins[0])

    def no_build(name):
        raise RuntimeError(f"building {name} failed")

    monkeypatch.setattr(stream, "load", no_build)
    before = stream.stream_forward.launches
    with pytest.raises(RuntimeError, match="building stream_fwd"):
        stream.stream_composite_attrs(SMALL, attrs, *bins)
    with pytest.raises(RuntimeError, match="building stream_fwd"):
        stream.stream_composite_inference(SMALL, attrs, *bins)
    assert stream.stream_forward.launches == before
    monkeypatch.undo()
    big_chunk = RasterSettings(image_height=40, image_width=48,
                               threshold=0.15, tile_h=8, tile_w=16,
                               gaussian_cap=512, chunk=256,
                               tiles_per_gaussian=32)
    with pytest.raises(ValueError, match="chunk"):
        stream.stream_forward(big_chunk, rows, bins[0].reshape(2, -1),
                              *bins[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "train", "decode"])
@pytest.mark.parametrize("opacity_hi", [0.1, 0.99])
def test_stream_forward_equals_b1_bit_for_bit(shape, opacity_hi):
    """B6f composites the same copies as B1, block for chunk, with the
    same column alpha, the same running products and the same stops, and
    ends a block's walk where B1's padding slots (zero alpha) begin: its
    output, and its checkpoint-free launch, equal B1's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    settings = {"small": SMALL, "train": TRAIN, "decode": DECODE}[shape]
    attrs, lists, counts = _frames(settings, 21, opacity_hi)
    nblk = torch.clamp((counts + settings.chunk - 1) // settings.chunk,
                       min=1)
    bins = stream.stream_from_tile_lists(settings, lists, counts,
                                         int(nblk.sum(dim=1).max()) + 3)
    rows = stream.stream_rows(attrs, bins[0])
    out_6, _ = stream.stream_fwd_cuda(settings, rows, *bins)
    inf_6, _ = stream.stream_fwd_cuda(settings, rows, *bins,
                                      save_tchk=False)
    out_1, _ = mirror.mirror_fwd_cuda(settings, attrs, lists, counts)
    torch.cuda.synchronize()
    assert (counts == 0).any() and (counts % settings.chunk != 0).any()
    assert torch.equal(out_6, out_1) and torch.equal(inf_6, out_1)


TALL_STREAM = dataclasses.replace(DECODE, image_height=32)


@pytest.mark.cuda
def test_stream_kernels_at_tall_tiles():
    """B6f/B6b at 16x128 tiles, where B6b runs 256 threads and its shared
    memory passes 48 KiB: forward and backward against their plain
    versions (background 0.3), and two backward launches give the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    settings = dataclasses.replace(TALL_STREAM, bg=0.3)
    assert stream.launch_shape(settings) == (256, 8)
    attrs, bins = _stream(settings, 16, 0.9)
    rows = stream.stream_rows(attrs, bins[0])
    out_k, chk_k = stream.stream_fwd_cuda(settings, rows, *bins)
    out_p, chk_p, _ = stream.stream_fwd_plain(settings, rows, *bins)
    g = torch.randn(out_p.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(17))
    gr_k = stream.stream_bwd_cuda(settings, rows, *bins, out_p, chk_p, g)
    gr_k2 = stream.stream_bwd_cuda(settings, rows, *bins, out_p, chk_p, g)
    gr_p, _ = stream.stream_bwd_plain(settings, rows, *bins, out_p, chk_p,
                                      g)
    torch.cuda.synchronize()
    torch.testing.assert_close(out_k, out_p, atol=2 * T_EPS, rtol=0)
    torch.testing.assert_close(chk_k, chk_p, atol=2 * T_EPS, rtol=0)
    assert torch.isfinite(gr_k).all() and torch.equal(gr_k, gr_k2)
    for v in range(2):
        _check_bwd(gr_k[v].T[:, :, None], gr_p[v].T[:, :, None])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["saturated", "dead_warp", "wide"])
def test_stream_backward_replay_cases(kind):
    """B6b on the replay cases of tests/test_torch_stream_replay.py (a
    column whose T underflows to 0 mid-block, a warp dead inside the
    first block, 8x128 tiles; background 0.3) against its plain version,
    on B6f's own outputs as the autograd function runs it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    settings, rows, bins = stream_replay_case(kind)
    rows, bins = rows.cuda(), tuple(b.cuda() for b in bins)
    out_k, chk_k = stream.stream_fwd_cuda(settings, rows, *bins)
    g = torch.randn(out_k.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(18))
    gr_k = stream.stream_bwd_cuda(settings, rows, *bins, out_k, chk_k, g)
    gr_p, _ = stream.stream_bwd_plain(settings, rows, *bins, out_k, chk_k,
                                      g)
    torch.cuda.synchronize()
    assert torch.isfinite(gr_k).all()
    for v in range(2):
        _check_bwd(gr_k[v].T[:, :, None], gr_p[v].T[:, :, None])


SMALL_NARROW = RasterSettings(image_height=40, image_width=40, threshold=0.15,
                              tile_h=8, tile_w=16, gaussian_cap=64, chunk=16,
                              tiles_per_gaussian=32)
TRAIN_NARROW = RasterSettings(image_height=32, image_width=360, threshold=0.1,
                              tile_h=8, tile_w=128, gaussian_cap=1024,
                              chunk=128, tiles_per_gaussian=32)


def _planes(settings, seed, opacity_hi, n_views=4):
    """Seeded tiles of ``n_views`` views as the single-view composite's
    planes 9 x [V*T, cap] and counts [V*T] (CUDA tensors)."""
    attrs, lists, counts = _frames(settings, seed, opacity_hi, n_views)
    views = [gather_tile_planes_rows(attrs[v], lists[v])
             for v in range(n_views)]
    return (tuple(torch.cat([p[i] for p in views]).contiguous()
                  for i in range(9)), counts.reshape(-1).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "train"])
@pytest.mark.parametrize("opacity_hi", [0.1, 0.99])
def test_tile_kernels_match_plain(shape, opacity_hi):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    settings = SMALL_NARROW if shape == "small" else TRAIN_NARROW
    planes, counts = _planes(settings, 5, opacity_hi)
    before = tile.tile_forward.launches
    out_k, chk_k = tile.tile_forward(settings, planes, counts)
    out_i, none = tile.tile_forward(settings, planes, counts,
                                    save_tchk=False)
    assert tile.tile_forward.launches == before + 2 and none is None
    out_p, chk_p, pairs = tile.tile_fwd_plain(settings, planes, counts)
    torch.cuda.synchronize()
    assert pairs > 0 and torch.isfinite(out_k).all()
    torch.testing.assert_close(out_k, out_p, atol=2 * T_EPS, rtol=0)
    torch.testing.assert_close(chk_k, chk_p, atol=2 * T_EPS, rtol=0)
    torch.testing.assert_close(out_i, out_k, atol=0, rtol=0)

    g = torch.randn(out_p.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(6))
    before = tile.tile_backward.launches
    gr_k = tile.tile_backward(settings, planes, counts, out_p, chk_p, g)
    assert tile.tile_backward.launches == before + 1
    gr_p, _ = tile.tile_bwd_plain(settings, planes, counts, chk_p, g)
    torch.cuda.synchronize()
    assert torch.isfinite(gr_k).all()
    _check_bwd(gr_k, gr_p)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "train"])
def test_tile_backward_is_deterministic(shape):
    """B5b adds no float atomics: two launches on the same inputs give
    the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    settings = SMALL_NARROW if shape == "small" else TRAIN_NARROW
    planes, counts = _planes(settings, 9, 0.9)
    out_p, chk_p, _ = tile.tile_fwd_plain(settings, planes, counts)
    g = torch.randn(out_p.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(10))
    first = tile.tile_bwd_cuda(settings, planes, counts, out_p, chk_p, g)
    second = tile.tile_bwd_cuda(settings, planes, counts, out_p, chk_p, g)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["saturated", "dead_warp", "wide"])
def test_tile_backward_replay_cases(kind):
    """B5b on the replay cases of tests/test_torch_tile_replay.py (a
    column whose T underflows to 0 mid-chunk, a warp dead inside the
    first chunk, 8x128 tiles; background 0.3) against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    settings, planes, counts = tile_replay_case(kind)
    planes = tuple(p.cuda() for p in planes)
    counts = counts.cuda()
    out_p, chk_p, _ = tile.tile_fwd_plain(settings, planes, counts)
    g = torch.randn(out_p.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(12))
    gr_k = tile.tile_bwd_cuda(settings, planes, counts, out_p, chk_p, g)
    gr_p, _ = tile.tile_bwd_plain(settings, planes, counts, chk_p, g)
    torch.cuda.synchronize()
    assert torch.isfinite(gr_k).all()
    _check_bwd(gr_k, gr_p)


TALL_NARROW = dataclasses.replace(TRAIN_NARROW, image_height=48, tile_h=16)


@pytest.mark.cuda
def test_tile_kernels_at_tall_tiles():
    """B5f/B5b at 16x128 tiles, where B5b runs 256 threads and its
    shared memory passes 48 KiB: forward and backward against their
    plain versions, and two backward launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert column_shape(TALL_NARROW, "B5b") == (256, 8)
    planes, counts = _planes(TALL_NARROW, 14, 0.9)
    out_k, chk_k = tile.tile_fwd_cuda(TALL_NARROW, planes, counts)
    out_p, chk_p, _ = tile.tile_fwd_plain(TALL_NARROW, planes, counts)
    g = torch.randn(out_p.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(15))
    gr_k = tile.tile_bwd_cuda(TALL_NARROW, planes, counts, out_p, chk_p, g)
    gr_k2 = tile.tile_bwd_cuda(TALL_NARROW, planes, counts, out_p, chk_p,
                               g)
    gr_p, _ = tile.tile_bwd_plain(TALL_NARROW, planes, counts, chk_p, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(out_k, out_p, atol=2 * T_EPS, rtol=0)
    torch.testing.assert_close(chk_k, chk_p, atol=2 * T_EPS, rtol=0)
    assert torch.isfinite(gr_k).all() and torch.equal(gr_k, gr_k2)
    _check_bwd(gr_k, gr_p)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "train", "decode"])
@pytest.mark.parametrize("opacity_hi", [0.1, 0.99])
def test_tile_forward_equals_b1_bit_for_bit(shape, opacity_hi):
    """B5f composites a view's planes as B1 composites its forward view
    from the lists: the same column alpha, running products and stops,
    its walk ending where B1's padding slots (zero alpha) begin.  At a
    tile-aligned width its out4 and t_chk, and its checkpoint-free
    launch, equal B1's forward-view rows bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    settings = {"small": SMALL, "train": TRAIN, "decode": DECODE}[shape]
    attrs, lists, counts = _frames(settings, 22, opacity_hi)
    views = [gather_tile_planes_rows(attrs[f], lists[f])
             for f in range(attrs.shape[0])]
    planes = tuple(torch.cat([p[i] for p in views]).contiguous()
                   for i in range(9))
    cnt = counts.reshape(-1).contiguous()
    out_5, chk_5 = tile.tile_fwd_cuda(settings, planes, cnt)
    inf_5, _ = tile.tile_fwd_cuda(settings, planes, cnt, save_tchk=False)
    out_1, chk_1 = mirror.mirror_fwd_cuda(settings, attrs, lists, counts)
    torch.cuda.synchronize()
    t_n = settings.n_tiles
    fwd = (torch.arange(2 * attrs.shape[0] * t_n, device="cuda")
           // t_n) % 2 == 0
    assert (cnt == 0).any() and (cnt % settings.chunk != 0).any()
    assert torch.equal(out_5, out_1[fwd]) and torch.equal(chk_5, chk_1[fwd])
    assert torch.equal(inf_5, out_1[fwd])


@pytest.mark.cuda
def test_tile_forward_clamps_overflowed_counts():
    """Rows whose count passed cap (an overflowed list) composite their
    cap copies: at a width that is not a multiple of tile_w (the last
    tile column reaches 24 px past the image), B5f on such counts equals
    B5f on the counts clamped to cap bit for bit, and the plain version
    to 2 T_EPS."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    settings = TRAIN_NARROW
    assert settings.n_tiles_x * settings.tile_w > settings.image_width
    planes, counts = _planes(settings, 23, 0.5)
    cap = settings.gaussian_cap
    over = counts.clone()
    over[counts == cap] = cap + 7
    over[1] = 5 * cap
    assert (over > cap).sum() >= 2
    clamped = over.clamp(max=cap)
    out_o, chk_o = tile.tile_fwd_cuda(settings, planes, over)
    inf_o, _ = tile.tile_fwd_cuda(settings, planes, over, save_tchk=False)
    out_c, chk_c = tile.tile_fwd_cuda(settings, planes, clamped)
    out_p, chk_p, _ = tile.tile_fwd_plain(settings, planes, over)
    torch.cuda.synchronize()
    assert torch.equal(out_o, out_c) and torch.equal(chk_o, chk_c)
    assert torch.equal(inf_o, out_c)
    torch.testing.assert_close(out_o, out_p, atol=2 * T_EPS, rtol=0)
    torch.testing.assert_close(chk_o, chk_p, atol=2 * T_EPS, rtol=0)


@pytest.mark.cuda
def test_tile_composite_autograd_with_background_matches_plain():
    """``tile_composite`` at the training tiles with a background of 0.3:
    the backward reads the out4 the autograd function saved (bg inside
    it) and matches the plain versions on CPU copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    settings = dataclasses.replace(TRAIN_NARROW, bg=0.3)
    planes, counts = _planes(settings, 11, 0.8, n_views=2)
    outs, grads = [], []
    for dev in ("cuda", "cpu"):
        p = tuple(x.to(dev).clone().requires_grad_(True) for x in planes)
        out = tile.tile_composite(settings, p, counts.to(dev))
        g = torch.randn(out.shape,
                        generator=torch.Generator().manual_seed(13))
        out.backward(g.to(dev))
        outs.append(out.detach().cpu())
        grads.append(torch.stack([x.grad.cpu() for x in p], dim=1))
    torch.testing.assert_close(outs[0], outs[1], atol=2 * T_EPS, rtol=0)
    assert float(grads[1].abs().max()) > 0
    _check_bwd(grads[0], grads[1])


@pytest.mark.cuda
def test_tile_composite_autograd_matches_plain():
    """``tile_composite`` on the card (B5f/B5b) against the same autograd
    function on CPU copies (the plain versions): outputs and the nine
    plane gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    planes, counts = _planes(SMALL_NARROW, 8, 0.6)
    outs, grads = [], []
    for dev in ("cuda", "cpu"):
        p = tuple(x.to(dev).clone().requires_grad_(True) for x in planes)
        out = tile.tile_composite(SMALL_NARROW, p, counts.to(dev))
        g = torch.randn(out.shape,
                        generator=torch.Generator().manual_seed(7))
        out.backward(g.to(dev))
        outs.append(out.detach().cpu())
        grads.append(torch.stack([x.grad.cpu() for x in p], dim=1))
    torch.testing.assert_close(outs[0], outs[1], atol=2 * T_EPS, rtol=0)
    assert float(grads[1].abs().max()) > 0
    _check_bwd(grads[0], grads[1])


# the fixture's hash grid (artifacts/rd_r5/realtex_0.004/cfg_args.yaml)
FIXTURE_GRID = make_mix_grid_spec(
    n_features=8,
    resolutions_list=(18, 24, 33, 44, 59, 80, 108, 148, 201, 275, 376, 514),
    log2_hashmap_size=13, resolutions_list_2d=(130, 258, 514, 1026),
    log2_hashmap_size_2d=15)
HASH_GRAD_REL = 1e-4


def _hash_inputs(n, seed, binary):
    """A seeded table (random signs, as the STE-binarised table of
    training, or uniform values) and queries: uniform in [0, 1] with the
    first rows on the border (0, 1) and on cell edges of the first 3D
    level."""
    rng = np.random.default_rng(seed)
    spec = FIXTURE_GRID
    if binary:
        table = np.where(rng.random((spec.total_rows, 8)) < 0.5, -1.0, 1.0)
    else:
        table = rng.uniform(-1, 1, (spec.total_rows, 8))
    x = rng.uniform(0, 1, (n, 3))
    x[:64] = rng.choice([0.0, 1.0], (64, 3))
    res = spec.grid_3d.resolutions[0]
    x[64:128] = (rng.integers(1, res - 2, (64, 3)) - 0.5) / (res - 2)
    return (torch.from_numpy(table.astype(np.float32)).cuda(),
            torch.from_numpy(x.astype(np.float32)).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [25_000, 150_000])
@pytest.mark.parametrize("binary", [True, False])
def test_hashgrid_kernels_match_plain(n, binary):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    table, x = _hash_inputs(n, seed=n, binary=binary)
    spec = FIXTURE_GRID
    before = hk.hashgrid_forward.launches
    out_k = hk.hashgrid_forward(table, x, spec)
    assert hk.hashgrid_forward.launches == before + 1
    out_p = hk.hashgrid_fwd_plain(table, x, spec)
    torch.cuda.synchronize()
    assert out_k.shape == (n, spec.output_dim)
    torch.testing.assert_close(out_k, out_p, atol=1e-6, rtol=0)

    g = torch.randn(out_p.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(n))
    before = hk.hashgrid_backward.launches
    gt_k, gx_k = hk.hashgrid_backward(table, x, g, spec)
    assert hk.hashgrid_backward.launches == before + 1
    gt_p, gx_p = hk.hashgrid_bwd_plain(table, x, g, spec)
    torch.cuda.synchronize()
    for got, want in ((gt_k, gt_p), (gx_k, gx_p)):
        assert torch.isfinite(got).all()
        scale = float(want.abs().max())
        assert scale > 0
        err = float((got - want).abs().max())
        assert err <= HASH_GRAD_REL * scale, (err, scale)


@pytest.mark.cuda
def test_hashgrid_autograd_through_kernels():
    """mix_grid_encode_kernel with the STE binarisation: the gradients of
    a weighted output sum reach the raw table (inside [-1, 1]) and the
    positions as the plain version's autograd gives them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gsvc_tpu_torch.ops.hashgrid import mix_grid_encode
    from gsvc_tpu_torch.ops.quant import ste_binary

    table, x = _hash_inputs(5000, seed=3, binary=False)
    table = table * 1.5
    w = torch.randn((5000, FIXTURE_GRID.output_dim), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(8))
    grads = []
    for fn in (hk.mix_grid_encode_kernel, mix_grid_encode):
        t = table.clone().requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        (fn(t, xx, FIXTURE_GRID, binarize=ste_binary) * w).sum().backward()
        grads.append((t.grad, xx.grad))
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= HASH_GRAD_REL * scale
    assert float(grads[0][0][table.abs() > 1].abs().max()) == 0.0


def _grid(f):
    """The fixture's levels with f features a row."""
    return FIXTURE_GRID if f == 8 else make_mix_grid_spec(
        n_features=f,
        resolutions_list=FIXTURE_GRID.grid_3d.resolutions,
        log2_hashmap_size=13,
        resolutions_list_2d=FIXTURE_GRID.grid_2d.resolutions,
        log2_hashmap_size_2d=15)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [2, 4, 8])
@pytest.mark.parametrize("order", ["z_sorted", "shuffled"])
def test_hashgrid_kernels_per_feature_count(f, order):
    """B3f equals its plain version bit for bit and B3b (with dL/dx
    summed over the instances inside the kernel) agrees to 1e-4 of the
    largest gradient, at F = 2, 4 and 8 (one and two lanes a query), on
    queries sorted by z as the anchors are, and shuffled; 3,001 queries
    leave a partial last warp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = _grid(f)
    rng = np.random.default_rng(f)
    x = rng.uniform(0, 1, (3001, 3))
    x[:8] = [[a, b, c] for a in (0.0, 1.0) for b in (0.0, 1.0)
             for c in (0.0, 1.0)]
    x = x[np.argsort(x[:, 2])] if order == "z_sorted" else x
    x = torch.from_numpy(x.astype(np.float32)).cuda()
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.total_rows, f))
                             .astype(np.float32)).cuda()
    out_k = hk.hashgrid_forward(table, x, spec)
    out_p = hk.hashgrid_fwd_plain(table, x, spec)
    assert out_k.shape == (3001, spec.output_dim)
    assert torch.equal(out_k, out_p)
    g = torch.randn(out_p.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(f))
    gt_k, gx_k = hk.hashgrid_backward(table, x, g, spec)
    gt_p, gx_p = hk.hashgrid_bwd_plain(table, x, g, spec)
    torch.cuda.synchronize()
    assert gx_k.shape == (3001, 3)
    for got, want in ((gt_k, gt_p), (gx_k, gx_p)):
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= HASH_GRAD_REL * scale


@pytest.mark.cuda
def test_hashgrid_backward_is_one_kernel_and_no_per_instance_buffer():
    """A B3b call runs one memset (the table gradient) and one kernel,
    with no reduction after it, and allocates no [n_inst, N, 3] buffer:
    its peak is the two gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    table, x = _hash_inputs(25_000, seed=4, binary=True)
    g = torch.randn((25_000, FIXTURE_GRID.output_dim), device="cuda")
    hk.hashgrid_backward(table, x, g, FIXTURE_GRID)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        hk.hashgrid_backward(table, x, g, FIXTURE_GRID)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    kernels = [k for k in names if "emset" not in k]
    assert len(kernels) == 1 and "hashgrid_bwd_kernel" in kernels[0], names
    assert len(names) == 2, names   # and the memset of the table gradient
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gt, gx = hk.hashgrid_backward(table, x, g, FIXTURE_GRID)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    n_inst = hk.instance_table(FIXTURE_GRID).shape[0]
    assert n_inst * 25_000 * 3 * 4 > 2 ** 22   # a per-instance buffer's size
    assert grown <= gt.numel() * 4 + gx.numel() * 4 + 2 ** 20, grown


@pytest.mark.cuda
def test_hashgrid_launch_plan_built_once_per_spec_and_device():
    """The first call on a (spec, device) builds its plan; later calls,
    forward and backward, reuse it; another spec object builds its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = _grid(4)
    table = torch.rand((spec.total_rows, 4), device="cuda")
    x = torch.rand((100, 3), device="cuda")
    before = hk.launch_plan.built
    out = hk.hashgrid_forward(table, x, spec)
    hk.hashgrid_forward(table, x, spec)
    hk.hashgrid_backward(table, x, torch.ones_like(out), spec)
    assert hk.launch_plan.built == before + 1
    hk.hashgrid_forward(table, x, _grid(4))
    assert hk.launch_plan.built == before + 2


def _tiny_fit_config():
    from gsvc_tpu_torch.config import (
        Config, ModelConfig, OptimizationConfig, PipelineConfig,
    )

    return Config(
        model=ModelConfig(anchor_feature_dim=8, n_offsets=4, threshold=0.3,
                          time_multi_res=4, offset_multi_res=4, log2=6,
                          log2_2D=7, grid_feature_dim=2,
                          resolutions_list=(6, 10),
                          resolutions_list_2D=(12, 20)),
        pipeline=PipelineConfig(tile_h=8, tile_w=16, visible_capacity=256,
                                gaussian_chunk=32),
        optimization=OptimizationConfig(init_anchor_num=120))


def _tiny_frames():
    return np.random.default_rng(0).integers(0, 256, (3, 24, 32, 3),
                                             dtype=np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["auto", "xla", "lanegather"])
def test_every_hash_backend_takes_the_kernels(backend):
    """On the card the entropy context runs B3f and its gradient B3b
    whatever ``hash_backend`` says."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.models.gaussians import (
        calc_entropy_context, get_anchor,
    )
    from gsvc_tpu_torch.train.fit import GOPFitter

    fitter = GOPFitter(_tiny_fit_config(),
                       FrameCubeDataset(images=_tiny_frames()), seed=5,
                       device="cuda")
    cfg = dataclasses.replace(fitter.gcfg, hash_backend=backend)
    anchor = get_anchor(fitter.state).detach().requires_grad_(True)
    f0, b0 = hk.hashgrid_forward.launches, hk.hashgrid_backward.launches
    ec = calc_entropy_context(fitter.state, cfg, anchor)
    ec.mean_feat.sum().backward()
    torch.cuda.synchronize()
    assert hk.hashgrid_forward.launches == f0 + 1
    assert hk.hashgrid_backward.launches == b0 + 1
    assert torch.isfinite(anchor.grad).all()


@pytest.mark.cuda
def test_seed_gives_the_same_networks_on_cpu_and_card():
    """GOPFitter(seed, "cuda") and GOPFitter(seed, "cpu") start from
    equal hash tables and MLP weights (drawn on the CPU, then moved)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.train.fit import GOPFitter
    from gsvc_tpu_torch.train.optim import tree_leaves

    cfg, frames = _tiny_fit_config(), _tiny_frames()
    nets = [GOPFitter(cfg, FrameCubeDataset(images=frames), seed=7,
                      device=dev).state.nets for dev in ("cuda", "cpu")]
    leaves = [tree_leaves(n) for n in nets]
    assert len(leaves[0]) == len(leaves[1]) > 8
    for a, b in zip(*leaves):
        assert torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# LPIPS on the card, and the kernels against the dense per-pixel oracle
# ---------------------------------------------------------------------------

# torchvision VGG16 conv widths (the LPIPS exporter's shapes)
_VGG16_CHANNELS = (64, 64, 128, 128, 256, 256, 256,
                   512, 512, 512, 512, 512, 512)


def _full_width_lpips_weights(seed=0):
    """Full-width VGG16 + linear-head weights in the exporter's schema."""
    from gsvc_tpu_torch.metrics.lpips import _SLICES, _VGG_CONVS

    rng = np.random.default_rng(seed)
    out, in_ch = {}, 3
    for ci, conv_idx in enumerate(_VGG_CONVS):
        oc = _VGG16_CHANNELS[ci]
        out[f"features.{conv_idx}.weight"] = torch.from_numpy(rng.normal(
            0, np.sqrt(2.0 / (in_ch * 9)), (oc, in_ch, 3, 3)).astype(
                np.float32))
        out[f"features.{conv_idx}.bias"] = torch.zeros(oc)
        in_ch = oc
    for k, upto in enumerate(_SLICES):
        c = _VGG16_CHANNELS[upto - 1]
        out[f"lin{k}.weight"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, (1, c, 1, 1)).astype(np.float32) / c)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["proxy", "full"])
def test_lpips_on_the_card_matches_cpu(kind):
    """LPIPS on the card equals the CPU's to rel 1e-6 with cuDNN's TF32
    switch at PyTorch's default (on): ``lpips`` turns it off around its
    convolutions and leaves the process flag as it was.  (float32 on both
    sides differs by ~1e-7 relative; TF32 convolutions move the value by
    ~1e-5, which a 1e-4 tolerance would not catch.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gsvc_tpu_torch.metrics.lpips import lpips, proxy_lpips_weights

    assert torch.backends.cudnn.allow_tf32, "PyTorch's default"
    w = proxy_lpips_weights() if kind == "proxy" \
        else _full_width_lpips_weights()
    rng = np.random.default_rng(4)
    a = rng.random((144, 208, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.08, a.shape), 0, 1).astype(np.float32)
    want = float(lpips(w, a, b))
    got = lpips({k: v.cuda() for k, v in w.items()}, torch.from_numpy(a)
                .cuda(), torch.from_numpy(b).cuda())
    assert got.is_cuda and torch.backends.cudnn.allow_tf32
    assert float(got) == pytest.approx(want, rel=1e-6)


def _visible_fitter(width, device="cuda"):
    """A GOPFitter of the tiny model on three seeded 128 x ``width`` frames
    at the training tile shape (8x128, cap 1024, chunk 128), its opacity
    head's output bias set to 0.8 so that gaussians show, and its z bounds
    widened so that no gaussian is clamped onto a bound: clamped ones share
    a depth, and the flip view's composite order of such a tie (the
    forward order reversed) is not the dense reference's (by index)."""
    from gsvc_tpu_torch.config import (
        Config, ModelConfig, OptimizationConfig, PipelineConfig,
    )
    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.train.fit import GOPFitter

    cfg = Config(
        model=ModelConfig(anchor_feature_dim=8, n_offsets=4, threshold=0.3,
                          time_multi_res=4, offset_multi_res=4, log2=6,
                          log2_2D=7, grid_feature_dim=2,
                          resolutions_list=(6, 10),
                          resolutions_list_2D=(12, 20)),
        pipeline=PipelineConfig(tile_h=8, tile_w=128, visible_capacity=1024,
                                gaussian_chunk=128),
        optimization=OptimizationConfig(init_anchor_num=300))
    frames = np.random.default_rng(1).integers(0, 256, (3, 128, width, 3),
                                               dtype=np.uint8)
    fitter = GOPFitter(cfg, FrameCubeDataset(images=frames), seed=3,
                       device=device)
    fitter.state.nets.mlp_opacity["out"]["b"].fill_(0.8)
    fitter.state.x_bound_min[..., 2] = -1.0
    fitter.state.x_bound_max[..., 2] = 1.0
    return fitter


def _dense(fitter, gss, frame_z, flip):
    from gsvc_tpu_torch.render.splat import rasterize_dense_reference

    ds = fitter.dataset
    return rasterize_dense_reference(
        gss.xyz, gss.color, gss.opacity, gss.scaling, gss.rot, gss.valid,
        frame_z, ds.x_min, ds.y_min, ds.scale, fitter.settings, flip=flip)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [256, 250])
def test_frame_renders_match_the_dense_reference(width):
    """``render_frame(..., rasterizer="pallas")`` (B5f, forward and flip
    view) and, at the tile-aligned width, the forward view of
    ``render_frame_views`` (B1) against ``rasterize_dense_reference`` on
    the card, which composites every pixel with no binning, capacity or
    chunk: 2 T_EPS.  (B1's flip view takes its x means from the forward
    view's, (W - 1) - x, one rounding away from the flip projection's, so
    at the alpha cliff it differs from this oracle by up to T/255; the
    tests above hold it to B1's plain version.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gsvc_tpu_torch.models.gaussians import GenerateMode
    from gsvc_tpu_torch.render.batched import render_frame_views
    from gsvc_tpu_torch.render.pipeline import render_frame

    fitter = _visible_fitter(width)
    ds, s = fitter.dataset, fitter.settings
    geom = (ds.x_min, ds.y_min, ds.scale, s, fitter.window_cap)
    for fz in (float(fitter.frame_zs[0]), float(fitter.frame_zs[1])):
        with torch.no_grad():
            for flip in (False, True):
                b5f = tile.tile_forward.launches
                r = render_frame(fitter.state, fitter.gcfg, fz, *geom,
                                 GenerateMode.FULL_PRECISION, flip=flip,
                                 rasterizer="pallas")
                assert tile.tile_forward.launches == b5f + 1
                assert int(r.overflow) == 0 and int(r.num_rendered) > 1000
                ref = _dense(fitter, r.gaussians, fz, flip)
                assert float(ref.std()) > 0.05
                torch.testing.assert_close(r.image, ref, atol=2 * T_EPS,
                                           rtol=0)
            if width % s.tile_w:
                continue
            b1 = mirror.mirror_forward.launches
            _, images, _, aux = render_frame_views(
                fitter.state, fitter.gcfg, fz, *geom,
                GenerateMode.FULL_PRECISION, inference=True)
            assert mirror.mirror_forward.launches == b1 + 1
            assert int(aux[4]) == 0
            torch.testing.assert_close(images[0],
                                       _dense(fitter, aux[0], fz, False),
                                       atol=2 * T_EPS, rtol=0)


@pytest.mark.cuda
def test_mirror_decode_launches_b1_once_per_frame(monkeypatch):
    """``GSVC_DECODE=mirror``: ``evaluate_video`` composites each frame
    with one B1 launch (both views) and never B4; ``bidir`` the reverse."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gsvc_tpu_torch.models.gaussians import GenerateMode
    from gsvc_tpu_torch.report import evaluate_video

    fitter = _visible_fitter(256)
    ds = fitter.dataset
    monkeypatch.delenv("GSVC_RASTERIZER", raising=False)
    got = {}
    for kind in ("mirror", "bidir"):
        monkeypatch.setenv("GSVC_DECODE", kind)
        b1, b4 = mirror.mirror_forward.launches, \
            bidir.bidir_composite_attrs.launches
        ev = evaluate_video(fitter.state, fitter.gcfg, fitter.settings,
                            fitter.window_cap, fitter.frame_zs, ds.x_min,
                            ds.y_min, ds.scale, gt_images=ds.images,
                            mode=GenerateMode.FULL_PRECISION, decoded=False)
        got[kind] = (mirror.mirror_forward.launches - b1,
                     bidir.bidir_composite_attrs.launches - b4, ev["psnr"])
    assert got["mirror"][:2] == (3, 0) and got["bidir"][:2] == (0, 3)
    assert got["mirror"][2] == pytest.approx(got["bidir"][2], abs=0.01)


# ---------------------------------------------------------------------------
# Multi-rank collectives on the card (gloo ranks sharing cuda:0)
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_gloo_ranks(fn, world, out_dir, timeout=240.0):
    """``fn(rank, world, port, out_dir)`` on ``world`` spawned processes;
    a rank that raises fails the test, and ranks past ``timeout`` seconds
    are killed and fail it."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world, _free_port(), str(out_dir)),
                             nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"gloo ranks still running after {timeout} s")


def _gloo_init(rank, world, port):
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    torch.cuda.set_device(0)


def _collectives_rank(rank, world, port, out_dir):
    """psum, all_gather and ppermute (forward and backward) on cuda:0
    against the same calls on CPU copies (to float rounding); ppermute
    over gloo stages the CUDA tensor through the host, counted."""
    import torch.distributed as dist

    from gsvc_tpu_torch.parallel import spmd

    _gloo_init(rank, world, port)
    try:
        mesh = spmd.make_mesh(1, world, "cuda:0")
        perm = [(s, (s + 1) % world) for s in range(world)]
        got = {}
        for dev in ("cpu", "cuda"):
            gen = torch.Generator().manual_seed(rank)
            x = torch.randn(3, 5, 7, generator=gen).to(dev).requires_grad_()
            w = torch.randn(3, 5, 7, generator=gen).to(dev)
            before = mesh.stats.host_copies
            outs = (spmd.psum(x, mesh), spmd.all_gather(x, mesh).sum(0),
                    spmd.ppermute(x, mesh, perm), spmd.pmean(x, mesh))
            loss = sum((o * w * (i + 1)).sum() for i, o in enumerate(outs))
            (g,) = torch.autograd.grad(loss, [x])
            got[dev] = ([o.detach().cpu() for o in outs], g.cpu(),
                        mesh.stats.host_copies - before)
        # gloo's CUDA all-reduce may add in another order than its CPU one
        for a, b in zip(got["cpu"][0] + [got["cpu"][1]],
                        got["cuda"][0] + [got["cuda"][1]]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        # the CPU path copies nothing; the CUDA ppermute stages its send
        # and its receive, forward and backward
        assert got["cpu"][2] == 0 and got["cuda"][2] == 4
        assert mesh.backend == "gloo"
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_gloo_collectives_on_the_card_equal_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _run_gloo_ranks(_collectives_rank, 3, tmp_path)


def _spread_state(device):
    """A tiny model whose 128 anchors spread over z in [-0.5, 0.5], with
    a +-0.08 window at z = 0 spanning 2 of 4 slabs, and nonzero features
    and offsets (tests/test_parallel.py's neighbour-exchange case).  The
    offsets have no z component: the slab composite equals the one-rank
    composite only when the slabs are depth-disjoint, and a gaussian
    offset past its slab's last anchor is composited in slab order, not
    depth order (the JAX package's design; ROADMAP §C).  With z offsets
    drawn like the x and y ones the two differ by up to 1.9e-3 here."""
    from gsvc_tpu_torch.config import ModelConfig
    from gsvc_tpu_torch.models.gaussians import (
        GaussianConfig, init_model, update_anchor_bound,
    )

    cfg = GaussianConfig.from_model_config(ModelConfig(
        anchor_feature_dim=8, n_offsets=4, threshold=0.08,
        time_multi_res=4, offset_multi_res=4, log2=6, log2_2D=7,
        grid_feature_dim=2, resolutions_list=(6, 10),
        resolutions_list_2D=(12, 20)))
    rng = np.random.default_rng(11)
    pts = rng.uniform([-0.5, -0.4, -0.5], [0.5, 0.4, 0.5],
                      (128, 3)).astype(np.float32)
    state = init_model(torch.Generator().manual_seed(3), cfg, pts, 128,
                       device=device)
    state = update_anchor_bound(state, -0.6, -0.45, -0.5)
    gen = torch.Generator().manual_seed(4)
    a = state.anchors
    offset = 0.3 * torch.randn(a.offset.shape, generator=gen)
    offset[..., 2] = 0.0
    state = state._replace(anchors=a._replace(
        feat=(0.5 * torch.randn(a.feat.shape, generator=gen)).to(device),
        offset=offset.to(device)))
    return cfg, state


def _slab_rank(rank, world, port, out_dir):
    """Each rank renders its z-slab of ``_spread_state`` (kernel B5f) and
    combines the partials over sp with both branches; rank 0 holds them
    against the single-rank render of the whole state."""
    import torch.distributed as dist

    from gsvc_tpu_torch.parallel import spmd
    from gsvc_tpu_torch.render.pipeline import (
        make_raster_settings, render_frame,
    )

    _gloo_init(rank, world, port)
    try:
        cfg, full = _spread_state("cuda")
        # no tile overflows: the whole state's 512 gaussians fit a tile
        settings = make_raster_settings(cfg, 24, 32, tile_h=8, tile_w=16,
                                        gaussian_cap=512, chunk=32)
        geom = (-0.6, -0.45, 26.0)
        for n_sp in (2, 4):
            mesh = spmd.make_mesh(world // n_sp, n_sp, "cuda:0")
            local = spmd.shard_model_state(full, mesh)
            for flip in (False, True):
                r = render_frame(local, cfg, 0.0, *geom, settings,
                                 128 // n_sp, flip=flip)
                imgs = [spmd.combine_slab_renders(
                    r.image, r.transmittance, flip, settings.bg, mesh,
                    neighbors=nb)[0] for nb in (None, 1)]
                ref = render_frame(full, cfg, 0.0, *geom, settings, 128,
                                   flip=flip).image
                torch.testing.assert_close(imgs[1], imgs[0], atol=1e-6,
                                           rtol=0)
                torch.testing.assert_close(imgs[0], ref, atol=2e-4, rtol=0)
                assert float(ref.abs().max()) > 0.05
            if n_sp == 4:
                assert mesh.stats.host_copies > 0   # ppermute rounds ran
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_slab_composite_over_gloo_ranks_matches_one_rank(tmp_path):
    """``combine_slab_renders`` on four gloo ranks sharing cuda:0, as 2 x 2
    (sp = 2: the all-gather branch) and 1 x 4 (sp = 4: one ppermute round,
    staged through the host) against the single-rank render at
    tests/test_parallel.py's 2e-4; the branches agree to 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _run_gloo_ranks(_slab_rank, 4, tmp_path)
