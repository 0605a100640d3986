"""Card-only tests of the port's hand-written kernels against their plain
PyTorch versions on the same card.

These need an NVIDIA GPU and skip elsewhere.  The file imports neither
JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

(``--noconftest`` skips tests/conftest.py, which configures JAX.)
Tolerance: 2 T_EPS — both versions run the same chunk-granular loop stops
and differ by float rounding, except where a pixel's transmittance
rounds across T_EPS on one side only (one term of weight < T_EPS per
view).
"""

import numpy as np
import pytest
import torch

from gsvc_tpu_torch.render import bidir
from gsvc_tpu_torch.render.splat import T_EPS, RasterSettings

SMALL = RasterSettings(image_height=40, image_width=48, threshold=0.15,
                       tile_h=8, tile_w=16, gaussian_cap=64, chunk=16,
                       tiles_per_gaussian=32)
DECODE = RasterSettings(image_height=64, image_width=384, threshold=0.1,
                        tile_h=16, tile_w=128, gaussian_cap=1024, chunk=128,
                        tiles_per_gaussian=32)


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
