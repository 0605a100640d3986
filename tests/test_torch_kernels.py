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

Single-view kernels B5f/B5b (widths that are not a multiple of tile_w):
the forward and checkpoints to 2 T_EPS, the gradients to 2e-3 of each
attribute's largest magnitude, for the reasons given for B1/B2.

Stream kernels B6f/B6b (the chunk-aligned copy stream of the same seeded
lists, chunk 16 and 128, with dead tail blocks): the forward and the
per-block checkpoints to 2 T_EPS, the gradients to 2e-3 of each
attribute's largest magnitude, for the reasons given for B1/B2.

Hash-grid kernels B3f/B3b (at the fixture's spec, F = 8, 12 3D + 4 2D
levels, N = 25k and 150k queries): the forward equals the plain version
to 1e-6 (both round the cell, the corner sums and the division alike);
the gradients to 1e-4 of the largest gradient magnitude — the table
gradient is an atomic sum whose order changes from run to run (float32,
up to ~10^3 terms per row at N = 150k: n eps ~ 6e-5 relative), and the
kernel forms each position gradient as sum_c r_c dw_c with r_c = sum_f
g_f (V_cf - out_f) / W where autograd takes the two terms apart.
"""

import numpy as np
import pytest
import torch

from gsvc_tpu_torch.ops import hashgrid_kernels as hk
from gsvc_tpu_torch.ops.hashgrid import make_mix_grid_spec
from gsvc_tpu_torch.render import bidir, mirror, stream, tile
from gsvc_tpu_torch.render.splat import (
    T_EPS, RasterSettings, gather_tile_planes_rows,
)
from test_torch_mirror_replay import _case as replay_case

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
    gr_k = tile.tile_backward(settings, planes, counts, chk_p, g)
    assert tile.tile_backward.launches == before + 1
    gr_p, _ = tile.tile_bwd_plain(settings, planes, counts, chk_p, g)
    torch.cuda.synchronize()
    assert torch.isfinite(gr_k).all()
    _check_bwd(gr_k, gr_p)


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
