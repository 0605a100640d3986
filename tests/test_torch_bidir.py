"""Kernel B4's plain PyTorch version against the JAX bidirectional
composite (``bidir_composite_attrs``, Pallas interpret mode on the CPU),
and the wrapper's device dispatch.

Inputs are the cases of tests/test_bidir.py: projected, binned scenes
from ``tests.test_splat.make_scene`` at 40x48 px, 8x16 tiles, cap 64,
chunk 16.  Tolerances: where no early exit triggers (tiny opacities) the
two differ only by float rounding of the transmittance products (the
TPU kernel takes exp(sum log1p), the port running products), so 1e-5;
where it triggers, a pixel whose transmittance rounds across T_EPS on
one side keeps or drops one term of weight < T_EPS per view, so 2 T_EPS.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.render.pallas_splat import bidir_composite_attrs as jax_bidir
from gsvc_tpu.render.splat import (
    RasterSettings as JaxSettings, _bin_gaussians as jax_bin,
    attr_rows_from_proj as jax_attr_rows, project_gaussians as jax_project,
)
from gsvc_tpu_torch.render import bidir
from gsvc_tpu_torch.render.splat import T_EPS, RasterSettings
from tests.test_splat import make_scene

JSET = JaxSettings(image_height=40, image_width=48, threshold=0.15,
                   tile_h=8, tile_w=16, gaussian_cap=64, chunk=16,
                   tiles_per_gaussian=32)
SET = RasterSettings(**dataclasses.asdict(JSET))
GEOM = dict(x_min=-1.0, y_min=-0.75, scale=24.0)
EXACT_ATOL = 1e-5
EARLY_EXIT_ATOL = 2 * T_EPS


def _opaque_case(seed=0):
    """Wide, nearly opaque gaussians listed in every tile, counts 33..64:
    every pixel saturates within the first chunk, so the front loop stops
    at a chunk boundary and the back loop walks down to it."""
    rng = np.random.default_rng(seed)
    m = 64
    attrs = np.zeros((m, 9), np.float32)
    attrs[:, 0] = rng.uniform(0, 48, m)
    attrs[:, 1] = rng.uniform(0, 40, m)
    attrs[:, 2] = attrs[:, 4] = rng.uniform(1e-4, 1e-3, m)
    attrs[:, 3] = rng.uniform(-5e-5, 5e-5, m)
    attrs[:, 5] = rng.uniform(0.6, 0.99, m)
    attrs[:, 6:9] = rng.uniform(0, 1, (m, 3))
    counts = rng.integers(33, 65, SET.n_tiles).astype(np.int32)
    lists = np.full((SET.n_tiles, SET.gaussian_cap), -1, np.int32)
    for t, c in enumerate(counts):
        lists[t, :c] = rng.permutation(m)[:c]
    return attrs[None], lists[None], counts[None]


def _case(m=40, seed=0, opacity_scale=None, empty_tiles=False,
          opaque=False):
    """(attrs, lists, counts) as numpy, made by the JAX package."""
    if opaque:
        return _opaque_case(seed)
    xyz, color, opacity, scaling, rot, valid = make_scene(m=m, seed=seed)
    if opacity_scale is not None:
        opacity = jnp.clip(opacity * opacity_scale, 0.0, 0.995)
    if empty_tiles:
        xyz = xyz.at[:, 0].set(jnp.abs(xyz[:, 0]) * -0.4 - 0.5)
    proj = jax_project(xyz, scaling, rot, valid, 0.0, GEOM["x_min"],
                       GEOM["y_min"], GEOM["scale"], JSET)
    op = jnp.where(proj.valid[:, None], opacity, 0.0)
    attrs = jax_attr_rows(proj, op, color)
    lists, counts, _, _, _ = jax_bin(proj, JSET)
    return (np.array(attrs)[None], np.array(lists)[None],
            np.array(counts)[None])


def _both(attrs, lists, counts):
    img_j, t_j = jax_bidir(JSET, jnp.asarray(attrs), jnp.asarray(lists),
                           jnp.asarray(counts))
    img_p, t_p = bidir.bidir_composite_attrs(
        SET, torch.from_numpy(attrs), torch.from_numpy(lists),
        torch.from_numpy(counts))
    return (np.asarray(img_j), np.asarray(t_j), img_p.numpy(), t_p.numpy())


CASES = {
    "matches": (dict(), EARLY_EXIT_ATOL),
    "unsaturated": (dict(opacity_scale=0.05), EXACT_ATOL),
    "saturated": (dict(m=120, seed=3, opacity_scale=4.0), EARLY_EXIT_ATOL),
    "deep_stack": (dict(m=400, seed=5, opacity_scale=8.0), EARLY_EXIT_ATOL),
    "opaque_tiles": (dict(opaque=True), EARLY_EXIT_ATOL),
    "empty_tiles": (dict(empty_tiles=True), EARLY_EXIT_ATOL),
    "partial_chunks_1": (dict(m=25, seed=1), EARLY_EXIT_ATOL),
    "partial_chunks_2": (dict(m=25, seed=2), EARLY_EXIT_ATOL),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_kernel(name):
    kwargs, atol = CASES[name]
    img_j, t_j, img_p, t_p = _both(*_case(**kwargs))
    assert img_p.shape == img_j.shape == (1, 3, 40, 48)
    np.testing.assert_allclose(img_p, img_j, atol=atol, rtol=0)
    np.testing.assert_allclose(t_p, t_j, atol=atol, rtol=0)


def test_case_coverage():
    """The cases exercise what their names say: empty tiles, counts that
    straddle chunk boundaries, stacks that saturate (T < T_EPS, so the
    per-pixel gating acts), tiles whose loops stop early (fewer pairs
    evaluated than listed), while tiny opacities never saturate."""
    _, _, counts = _case(empty_tiles=True)
    assert counts.min() == 0
    _, _, counts = _case(m=25, seed=1)
    assert np.any(counts % SET.chunk != 0)
    _, tau_deep, _, _ = _both(*_case(m=400, seed=5, opacity_scale=8.0))
    assert tau_deep.min() < T_EPS
    _, tau_low, _, _ = _both(*_case(opacity_scale=0.05))
    assert tau_low.min() > 10 * T_EPS
    attrs, lists, counts = _case(opaque=True)
    _, pairs = bidir.bidir_out4_plain(SET, torch.from_numpy(attrs),
                                      torch.from_numpy(lists),
                                      torch.from_numpy(counts))
    assert pairs < int(counts.sum()) * SET.tile_h * SET.tile_w


def test_cpu_tensors_take_plain_version_without_counting():
    attrs, lists, counts = (torch.from_numpy(a) for a in _case())
    before = bidir.bidir_composite_attrs.launches
    img, tau = bidir.bidir_composite_attrs(SET, attrs, lists, counts)
    ref_img, ref_tau = bidir.bidir_composite_plain(SET, attrs, lists, counts)
    assert bidir.bidir_composite_attrs.launches == before
    assert torch.equal(img, ref_img) and torch.equal(tau, ref_tau)


@pytest.mark.parametrize("bad", ["lists_int64", "counts_shape", "attrs_cols"])
def test_wrapper_rejects_malformed_inputs(bad):
    attrs, lists, counts = (torch.from_numpy(a) for a in _case())
    if bad == "lists_int64":
        lists = lists.long()
    elif bad == "counts_shape":
        counts = counts[:, :-1]
    else:
        attrs = attrs[..., :8]
    with pytest.raises(ValueError):
        bidir.bidir_composite_attrs(SET, attrs, lists, counts)


def test_kernel_shape_limits():
    """B4's launch plan: B4_CLUSTER CTAs a tile, each a band of rows of
    every column (one thread a column): 2 x 64 x 1 at 8x16 (8 x 16 x 1
    at 8 CTAs: partial warps), 2 x 128 x 8 at the decode tiles
    (16x128), 2 x 128 x 4 at the training tiles;
    the cluster halves until it divides tile_h; a given size that does
    not divide it, or a chunk past the stage, is refused."""
    assert bidir.B4_CLUSTER == 2
    assert bidir.bidir_launch_plan(SET) == (2, 64, 1)
    # B4 reduces over no warp: a CTA of one 16-pixel row is taken
    assert bidir.bidir_launch_plan(SET, cluster=8) == (8, 16, 1)
    wide = dataclasses.replace(SET, tile_h=16, tile_w=128)
    assert bidir.bidir_launch_plan(wide) == (2, 128, 8)
    assert bidir.bidir_launch_plan(wide, cluster=1) == (1, 256, 8)
    assert bidir.bidir_launch_plan(wide, cluster=4) == (4, 128, 4)
    assert bidir.bidir_launch_plan(wide, cluster=8) == (8, 128, 2)
    train = dataclasses.replace(wide, tile_h=8)
    assert bidir.bidir_launch_plan(train) == (2, 128, 4)
    low = dataclasses.replace(wide, tile_h=1, tile_w=256,
                              image_width=256)
    assert bidir.bidir_launch_plan(low) == (1, 256, 1)
    with pytest.raises(ValueError, match="3 CTAs"):
        bidir.bidir_launch_plan(wide, cluster=3)
    with pytest.raises(ValueError):
        bidir.bidir_launch_plan(dataclasses.replace(SET, chunk=256,
                                                    gaussian_cap=512))

