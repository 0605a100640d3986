"""The port's decode-render modules against the JAX package on the same
numpy-seeded inputs: projection, tile binning (exact and quantized depth
ranks), the TSW window, neural-gaussian generation on a state carried
over by ``gsvc_tpu_torch.convert``, and the image metrics.

Tolerances: binning and windows are integer paths and must be equal;
float outputs agree to 1e-5 (float32 rounding of the same arithmetic,
taken in another order by the other framework).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.metrics import image as jmetrics
from gsvc_tpu.models.gaussians import (
    GenerateMode as JMode, generate_neural_gaussians as jax_generate,
    window_for_frame as jax_window,
)
from gsvc_tpu.render.splat import (
    RasterSettings as JaxSettings, _bin_gaussians as jax_bin,
    project_gaussians as jax_project,
)
from gsvc_tpu_torch.config import ModelConfig
from gsvc_tpu_torch.convert import state_from_numpy
from gsvc_tpu_torch.metrics import image as pmetrics
from gsvc_tpu_torch.models.gaussians import (
    GaussianConfig, GenerateMode, generate_neural_gaussians, window_for_frame,
)
from gsvc_tpu_torch.render.splat import (
    RasterSettings, _bin_gaussians, project_gaussians,
)
from tests.test_model import make_state
from tests.test_splat import make_scene

ATOL = 1e-5
JSET = JaxSettings(image_height=40, image_width=56, threshold=0.15,
                   tile_h=8, tile_w=16, gaussian_cap=64, chunk=16,
                   tiles_per_gaussian=32)
GEOM = dict(x_min=-1.0, y_min=-0.75, scale=28.0)


def _settings(jset):
    return RasterSettings(**dataclasses.asdict(jset))


def _quantized_scene(m=4608, seed=0):
    """m >= 4096 gaussians (the quantized-rank branch) with distinct
    depths 6e-5 apart, far above the 18-bit rank quantum (~1.1e-6), so no
    two copies share a tile and a rank."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.9, 0.9, (m, 3)).astype(np.float32)
    xyz[:, 2] = rng.permutation(np.linspace(-0.14, 0.14, m))
    color = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    opacity = rng.uniform(0.2, 0.9, (m, 1)).astype(np.float32)
    scaling = rng.uniform(0.005, 0.03, (m, 3)).astype(np.float32)
    rot = rng.normal(size=(m, 4)).astype(np.float32)
    rot[:, 0] += 2.0
    return xyz, color, opacity, scaling, rot, np.ones(m, bool)


def _scene(kind):
    if kind == "exact_rank":
        return [np.array(a) for a in make_scene(m=40, seed=0)]
    if kind == "exact_rank_flip":
        return [np.array(a) for a in make_scene(m=60, seed=7)]
    return list(_quantized_scene())


def _project_both(kind, flip=False):
    xyz, _, _, scaling, rot, valid = _scene(kind)
    pj = jax_project(jnp.asarray(xyz), jnp.asarray(scaling),
                     jnp.asarray(rot), jnp.asarray(valid), 0.0,
                     settings=JSET, flip=flip, **GEOM)
    pp = project_gaussians(torch.from_numpy(xyz), torch.from_numpy(scaling),
                           torch.from_numpy(rot), torch.from_numpy(valid),
                           0.0, settings=_settings(JSET), flip=flip, **GEOM)
    return pj, pp


@pytest.mark.parametrize("kind,flip", [("exact_rank", False),
                                       ("exact_rank_flip", True),
                                       ("quantized_rank", False)])
def test_projection_matches(kind, flip):
    pj, pp = _project_both(kind, flip)
    for name in ("mean2d", "depth"):
        np.testing.assert_allclose(getattr(pp, name).numpy(),
                                   np.asarray(getattr(pj, name)),
                                   atol=ATOL, rtol=0)
    np.testing.assert_allclose(pp.conic.numpy(), np.asarray(pj.conic),
                               rtol=1e-5, atol=ATOL)
    np.testing.assert_array_equal(pp.radius.numpy(), np.asarray(pj.radius))
    np.testing.assert_array_equal(pp.valid.numpy(), np.asarray(pj.valid))


@pytest.mark.parametrize("kind", ["exact_rank", "exact_rank_flip",
                                  "quantized_rank"])
def test_binning_matches_exactly(kind):
    pj, pp = _project_both(kind, flip=kind.endswith("flip"))
    if kind == "quantized_rank":
        assert pp.mean2d.shape[0] >= 4096
    lists_j, counts_j, dropped_j, ovf_j, total_j = jax_bin(pj, JSET)
    lists_p, counts_p, dropped_p, ovf_p, total_p = _bin_gaussians(
        pp, _settings(JSET))
    assert lists_p.dtype == counts_p.dtype == torch.int32
    np.testing.assert_array_equal(counts_p.numpy(), np.asarray(counts_j))
    np.testing.assert_array_equal(lists_p.numpy(), np.asarray(lists_j))
    np.testing.assert_array_equal(dropped_p.numpy(), np.asarray(dropped_j))
    assert int(ovf_p) == int(ovf_j) and int(total_p) == int(total_j)


def _carried_state(seed=3):
    """A JAX state from init_model with numpy-seeded attributes, and the
    same state carried over into the port."""
    cfg_j, state = make_state(n=64, capacity=96, seed=seed)
    rng = np.random.default_rng(seed)
    a = state.anchors
    anchors = a._replace(
        feat=jnp.asarray(rng.normal(0, 0.5, a.feat.shape), jnp.float32),
        offset=jnp.asarray(rng.normal(0, 0.3, a.offset.shape), jnp.float32),
        scaling=jnp.asarray(rng.uniform(0.005, 0.05, a.scaling.shape),
                            jnp.float32),
        mask=jnp.asarray(rng.uniform(size=a.mask.shape) < 0.8, jnp.float32))
    state = state._replace(anchors=anchors)
    payload = {
        "anchors": jax.tree.map(np.asarray, state.anchors._asdict()),
        "nets": jax.tree.map(np.asarray, state.nets._asdict()),
        "n_active": int(state.n_active),
        "x_bound_min": np.asarray(state.x_bound_min),
        "x_bound_max": np.asarray(state.x_bound_max),
    }
    mc = ModelConfig(
        anchor_feature_dim=8, n_offsets=4, threshold=0.15,
        time_multi_res=4, offset_multi_res=4, log2=6, log2_2D=7,
        grid_feature_dim=2, resolutions_list=(6, 10),
        resolutions_list_2D=(12, 20))
    return cfg_j, state, GaussianConfig.from_model_config(mc), \
        state_from_numpy(payload)


@pytest.mark.parametrize("frame_z", [-0.2, 0.0, 0.17])
def test_window_matches(frame_z):
    cfg_j, sj, cfg_p, sp = _carried_state()
    start_j, inw_j = jax_window(sj, cfg_j, jnp.float32(frame_z), 32)
    start_p, inw_p = window_for_frame(sp, cfg_p, frame_z, 32)
    assert start_p == int(start_j)
    np.testing.assert_array_equal(inw_p.numpy(), np.asarray(inw_j))


@pytest.mark.parametrize("mode,decoded", [("DECODED", True),
                                          ("FULL_PRECISION", False)])
def test_generate_matches(mode, decoded):
    cfg_j, sj, cfg_p, sp = _carried_state()
    fz = 0.05
    start, inw = window_for_frame(sp, cfg_p, fz, 48)
    start_j, inw_j = jax_window(sj, cfg_j, jnp.float32(fz), 48)
    gj = jax_generate(sj, cfg_j, jnp.float32(fz), jnp.float32(fz), start_j,
                      inw_j, 48, getattr(JMode, mode), decoded=decoded)
    gp = generate_neural_gaussians(sp, cfg_p, fz, fz, start, inw, 48,
                                   getattr(GenerateMode, mode),
                                   decoded=decoded)
    np.testing.assert_array_equal(gp.valid.numpy(), np.asarray(gj.valid))
    # rows of padding anchors (z = 1e9 sentinel) carry meaningless
    # magnitudes; compare the live anchors' gaussians
    live = np.repeat(np.arange(start, start + 48) < sp.n_active,
                     cfg_p.n_offsets)
    assert live.sum() > 100
    for name in ("xyz", "color", "opacity", "scaling", "rot",
                 "neural_opacity", "offsets_world"):
        np.testing.assert_allclose(getattr(gp, name).numpy()[live],
                                   np.asarray(getattr(gj, name))[live],
                                   atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("name", ["psnr", "ssim", "ms_ssim"])
def test_metrics_match(name):
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (3, 181, 190)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    got = float(getattr(pmetrics, name)(torch.from_numpy(a),
                                        torch.from_numpy(b)))
    want = float(getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b)))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)
