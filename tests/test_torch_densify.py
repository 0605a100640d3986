"""The port's densify epoch against the JAX package's, exactly: from one
state, Adam moments, statistics and numpy rng state, both packages must
make the same decisions and write the same buffers.

* ``adjust_anchors`` + ``resort_by_z`` (the host path, padded as the
  fitters pad it) against JAX's;
* ``build_plan``: an identical index plan;
* ``apply_plan`` (torch gathers, a ``scatter_reduce_`` segment max)
  against JAX's jitted apply: identical padded anchors, Adam moments and
  statistics;
* the port's host path against its plan path, as JAX's own
  tests/test_densify_plan.py holds them, on its cases: grow and prune,
  no candidates, capacity growth; and the two paths of ``GOPFitter``
  after the same short fit;
* ``candidate_fraction`` / ``calibrate_densify_threshold``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.models.gaussians import AnchorState as JaxAnchorState
from gsvc_tpu.train.calibrate import (
    calibrate_densify_threshold as jax_calibrate,
    candidate_fraction as jax_fraction,
)
from gsvc_tpu.train.densify_plan import apply_plan as jax_apply_plan
from gsvc_tpu.train.densify_plan import build_plan as jax_build_plan
from gsvc_tpu.train.trainer import TrainStats as JaxTrainStats
from gsvc_tpu_torch.config import ModelConfig, OptimizationConfig
from gsvc_tpu_torch.models.gaussians import AnchorState
from gsvc_tpu_torch.train.calibrate import (
    calibrate_densify_threshold, candidate_fraction,
)
from gsvc_tpu_torch.train.densify import adjust_anchors, resort_by_z
from gsvc_tpu_torch.train.densify_plan import apply_plan, build_plan
from gsvc_tpu_torch.train.trainer import TrainStats
from tests.test_densify_plan import (
    _FIELDS, K, _host_surgery, _make_inputs, _round_up,
)

STAT_FIELDS = ("opacity_accum", "anchor_demon", "offset_gradient_accum",
               "offset_denom")
CASES = {  # name: (seed, n, grow_frac, prune_frac, voxel, rng seed, cap)
    "grow_and_prune_0": (0, 300, 0.3, 0.2, 0.05, 10, 2048),
    "grow_and_prune_1": (1, 300, 0.3, 0.2, 0.05, 11, 2048),
    "grow_and_prune_2": (2, 300, 0.3, 0.2, 0.05, 12, 2048),
    "no_candidates": (3, 200, 0.0, 0.3, 0.05, 7, 1024),
    "capacity_growth": (4, 300, 0.6, 0.0, 0.02, 11, 320),
}


def _case(name):
    seed, n, grow, prune, voxel, rseed, cap = CASES[name]
    jmc, jopt, anchors, adam_m, adam_v, stats = _make_inputs(
        seed, n, grow_frac=grow, prune_frac=prune)
    mc = ModelConfig(n_offsets=K, update_depth=3, update_init_factor=16,
                     update_hierarchy_factor=4)
    opt = OptimizationConfig(update_interval=100, success_threshold=0.8,
                             min_opacity=0.005, densify_grad_threshold=0.01)
    return (jmc, jopt, mc, opt, anchors, adam_m, adam_v, stats, voxel,
            rseed, cap)


def _port_host_surgery(mc, opt, anchors, adam_m, adam_v, stats, voxel,
                       seed, capacity):
    """The port's host path with the fitter's padding (fit.py
    _densify_host), in numpy."""
    anchors = {f: v.copy() for f, v in anchors.items()}
    adam_m = {f: v.copy() for f, v in adam_m.items()}
    adam_v = {f: v.copy() for f, v in adam_v.items()}
    stats = {f: v.copy() for f, v in stats.items()}
    res = adjust_anchors(anchors, adam_m, adam_v, stats, mc, opt, voxel,
                         np.random.default_rng(seed))
    resort_by_z(anchors, adam_m, adam_v, stats, mc.n_offsets)
    n_new = res.n_active
    cap = capacity if n_new <= capacity else _round_up(int(n_new * 1.5),
                                                        1024)

    def pad(x, rows):
        out = np.zeros((rows,) + x.shape[1:], np.float32)
        out[:x.shape[0]] = x
        return out

    out = {f: pad(anchors[f], cap) for f in _FIELDS}
    out["anchor"][n_new:, 2] = 1e9
    return (res, cap, out, {f: pad(adam_m[f], cap) for f in _FIELDS},
            {f: pad(adam_v[f], cap) for f in _FIELDS},
            {f: pad(stats[f], cap * (K if f.startswith("offset") else 1))
             for f in STAT_FIELDS})


def _padded(anchors, adam_m, adam_v, stats, capacity):
    """Capacity-padded device buffers as numpy dicts (z = 1e9 padding)."""
    n = anchors["anchor"].shape[0]

    def pad(x, rows):
        out = np.zeros((rows,) + x.shape[1:], np.float32)
        out[:x.shape[0]] = x
        return out

    a = {f: pad(anchors[f], capacity) for f in _FIELDS}
    a["anchor"][n:, 2] = 1e9
    return (a, {f: pad(adam_m[f], capacity) for f in _FIELDS},
            {f: pad(adam_v[f], capacity) for f in _FIELDS},
            {f: pad(stats[f], capacity * (K if f.startswith("offset") else 1))
             for f in STAT_FIELDS})


def _plans(name):
    (jmc, jopt, mc, opt, anchors, adam_m, adam_v, stats, voxel, rseed,
     cap) = _case(name)
    a, m, v, s = _padded(anchors, adam_m, adam_v, stats, cap)
    flat = a["offset"].reshape(-1, 3)
    kw = dict(anchor=anchors["anchor"], scaling=anchors["scaling"],
              fetch_offsets=lambda idx: flat[idx], voxel_size=voxel,
              capacity=cap)
    jplan = jax_build_plan(stats={f: x.copy() for f, x in stats.items()},
                           mc=jmc, opt=jopt,
                           rng=np.random.default_rng(rseed), **kw)
    plan = build_plan(stats={f: x.copy() for f, x in stats.items()},
                      mc=mc, opt=opt, rng=np.random.default_rng(rseed), **kw)
    return jplan, plan, (a, m, v, s)


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_path_matches_jax(name):
    (jmc, jopt, mc, opt, anchors, adam_m, adam_v, stats, voxel, rseed,
     cap) = _case(name)
    j = _host_surgery(jmc, jopt, anchors, adam_m, adam_v, stats, voxel,
                      rseed, cap)
    p = _port_host_surgery(mc, opt, anchors, adam_m, adam_v, stats, voxel,
                           rseed, cap)
    assert (p[0].n_grown, p[0].n_pruned, p[0].n_active) == (
        j[0].n_grown, j[0].n_pruned, j[0].n_active)
    assert p[1] == j[1]
    for pd, jd in zip(p[2:], j[2:]):
        for f in jd:
            np.testing.assert_array_equal(pd[f], jd[f], err_msg=f)
    if name == "capacity_growth":
        assert p[1] > cap
    if name.startswith("grow"):
        assert p[0].n_grown > 0 and p[0].n_pruned > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_matches_jax(name):
    jplan, plan, _ = _plans(name)
    assert vars(plan.result) == vars(jplan.result)
    assert (plan.n0, plan.capacity_out) == (jplan.n0, jplan.capacity_out)
    for f in ("src_idx", "new_anchor", "new_scaling", "is_new_real",
              "pairs_src", "pairs_dst", "offset_reset", "opdem_reset",
              "z_full"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(jplan, f),
                                      err_msg=f)


@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_plan_matches_jax_and_the_host_path(name):
    jplan, plan, (a, m, v, s) = _plans(name)
    jout = jax_apply_plan(
        jplan, JaxAnchorState(**{f: jnp.asarray(a[f]) for f in _FIELDS}),
        JaxAnchorState(**{f: jnp.asarray(m[f]) for f in _FIELDS}),
        JaxAnchorState(**{f: jnp.asarray(v[f]) for f in _FIELDS}),
        JaxTrainStats(**{f: jnp.asarray(s[f]) for f in STAT_FIELDS}))
    pout = apply_plan(
        plan, AnchorState(**{f: torch.from_numpy(a[f]) for f in _FIELDS}),
        AnchorState(**{f: torch.from_numpy(m[f]) for f in _FIELDS}),
        AnchorState(**{f: torch.from_numpy(v[f]) for f in _FIELDS}),
        TrainStats(**{f: torch.from_numpy(s[f]) for f in STAT_FIELDS}))
    (jmc, jopt, mc, opt, anchors, adam_m, adam_v, stats, voxel, rseed,
     cap) = _case(name)
    host = _port_host_surgery(mc, opt, anchors, adam_m, adam_v, stats,
                              voxel, rseed, cap)
    for pt, jt, hd in zip(pout, jout, host[2:]):
        for f in hd:
            got = getattr(pt, f).numpy()
            np.testing.assert_array_equal(got, np.asarray(getattr(jt, f)),
                                          err_msg=f)
            np.testing.assert_array_equal(got, hd[f], err_msg=f)
    np.testing.assert_array_equal(plan.z_full, host[2]["anchor"][:, 2])


def test_calibration_matches_jax():
    (jmc, jopt, mc, opt, anchors, adam_m, adam_v, stats, *_) = _case(
        "grow_and_prune_0")
    for thr in (0.005, 0.01, 0.05):
        assert candidate_fraction(stats, opt, thr) == jax_fraction(
            stats, jopt, thr)
    for target in (0.01, 0.04, 0.3):
        got = calibrate_densify_threshold(stats, opt, target)
        assert got == jax_calibrate(stats, jopt, target)
        np.testing.assert_allclose(candidate_fraction(stats, opt, got),
                                   target, atol=0.01)
    empty = {f: np.zeros_like(x) for f, x in stats.items()}
    assert calibrate_densify_threshold(empty, opt) == \
        opt.densify_grad_threshold == jax_calibrate(empty, jopt)


def test_fitter_densify_paths_agree():
    """The fitter's host and plan epochs on the state of the same short
    fit: identical anchors, moments, statistics, rng state and capacity."""
    from tests.test_torch_train import _configs, _video_u8
    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.train.fit import GOPFitter

    out = []
    for device_densify in (False, True):
        _, pcfg = _configs()
        pcfg.optimization.densify_grad_threshold = 1e-5
        pcfg.optimization.update_interval = 2   # statistics gate 0.8
        pcfg.pipeline.device_densify = device_densify
        f = GOPFitter(pcfg, FrameCubeDataset(images=_video_u8()), seed=0,
                      device="cpu")
        f.fit(iterations=4, log_every=0)
        res = f._densify()
        out.append((res, f))
    (rh, fh), (rd, fd) = out
    assert rh == rd and rh.n_grown > 0
    assert fh.capacity == fd.capacity and fh.window_cap == fd.window_cap
    assert fh.rng.bit_generator.state == fd.rng.bit_generator.state
    for a, b in ((fh.state.anchors, fd.state.anchors),
                 (fh.adam.m[0], fd.adam.m[0]), (fh.adam.v[0], fd.adam.v[0]),
                 (fh.stats, fd.stats)):
        for name in a._fields:
            assert torch.equal(getattr(a, name), getattr(b, name)), name
