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
gradient magnitude of each attribute — the kernel forms each in-chunk
suffix as the chunk's sum minus a running prefix, the plain version by a
reverse cumsum, and 1/(1 - alpha) amplifies that rounding up to 100x;
the pixel sums are also taken in other orders.
"""

import numpy as np
import pytest
import torch

from gsvc_tpu_torch.render import bidir, mirror
from gsvc_tpu_torch.render.splat import T_EPS, RasterSettings

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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "train"])
@pytest.mark.parametrize("opacity_hi", [0.1, 0.99])
def test_mirror_kernels_match_plain(shape, opacity_hi):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    settings = SMALL if shape == "small" else TRAIN
    attrs, lists, counts = _frames(settings, 3, opacity_hi)
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
    gr_k = mirror.mirror_backward(settings, attrs, lists, counts, chk_p, g)
    assert mirror.mirror_backward.launches == before + 1
    gr_p, _ = mirror.mirror_bwd_plain(settings, attrs, lists, counts, chk_p,
                                      g)
    torch.cuda.synchronize()
    assert torch.isfinite(gr_k).all()
    _check_bwd(gr_k, gr_p)


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
