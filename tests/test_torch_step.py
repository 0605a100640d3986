"""One training step of the port against the JAX package's on the same
carried-over state and numpy-seeded frames and flow: the loss, every
parameter leaf's gradient, the parameters after Adam and the
densification statistics, with and without ``do_stats``.

The JAX side runs ``make_pair_loss(rasterizer="pallas_train")`` (kernels
B1/B2 in Pallas interpret mode), then its own ``adam_update`` and
``accumulate_stats``; the port runs ``make_step_body`` on the CPU (the
kernels' plain versions).  Tolerances:

* loss rtol 1e-5: float32 rounding of the same terms;
* gradients rtol 2e-3 / atol 2e-4, as the mirror backward's
  (tests/test_torch_mirror.py states why);
* parameters after Adam: Adam's first step moves every element by
  lr * g / (|g| + 1e-15), about lr * sign(g).  Where JAX's gradient is
  resolved (|g| > 10 atol) the two steps agree to 1e-3 lr; below that
  the sign of a near-zero gradient is rounding and the step may differ
  by up to 2 lr;
* statistics: the window counts exactly, the screen-gradient norms at
  the gradient tolerance scaled by the pixel-to-NDC factor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.config import OptimizationConfig as JaxOpt
from gsvc_tpu.models.gaussians import GenerateMode as JMode
from gsvc_tpu.train.optim import (
    adam_init as jax_adam_init, adam_update as jax_adam_update,
    build_lr_tree as jax_lr_tree,
)
from gsvc_tpu.train.schedules import build_schedules as jax_schedules
from gsvc_tpu.train.trainer import (
    accumulate_stats as jax_accumulate, init_stats as jax_init_stats,
    make_pair_loss as jax_pair_loss,
)
from gsvc_tpu_torch.config import ModelConfig, OptimizationConfig
from gsvc_tpu_torch.convert import state_from_numpy
from gsvc_tpu_torch.models.gaussians import GaussianConfig, GenerateMode
from gsvc_tpu_torch.render.splat import RasterSettings
from gsvc_tpu_torch.train.optim import (
    adam_init, tree_leaves, tree_unflatten,
)
from gsvc_tpu_torch.train.schedules import build_schedules
from gsvc_tpu_torch.train.trainer import (
    init_stats, make_pair_loss, make_step_body,
)
from tests.test_batched import GEOM, WINDOW_CAP, Z1, Z2, settings_for, \
    tiny_model

RTOL, ATOL = 2e-3, 2e-4
WIDTH, HEIGHT = 48, 40
OPT = dict(optical_lambda=5.0, scaling_reg=0.01, opacity_reg=0.01,
           lambda_dssim=0.2)


def _port_cfg():
    return GaussianConfig.from_model_config(ModelConfig(
        anchor_feature_dim=8, n_offsets=4, threshold=0.3,
        time_multi_res=4, offset_multi_res=4, log2=6, log2_2D=7,
        grid_feature_dim=2, resolutions_list=(6, 10),
        resolutions_list_2D=(12, 20)))


def _inputs():
    rng = np.random.default_rng(21)
    gt = rng.integers(0, 256, (2, 3, HEIGHT, WIDTH)).astype(np.uint8)
    flow = rng.normal(0, 1.5, (2, HEIGHT, WIDTH)).astype(np.float32)
    return gt, flow


def _payload(jstate):
    return {
        "anchors": {k: np.asarray(v)
                    for k, v in jstate.anchors._asdict().items()},
        "nets": jax.tree.map(np.asarray, jstate.nets._asdict()),
        "n_active": int(jstate.n_active),
        "x_bound_min": np.asarray(jstate.x_bound_min),
        "x_bound_max": np.asarray(jstate.x_bound_max)}


@pytest.fixture(scope="module", params=[False, True],
                ids=["no_stats", "do_stats"])
def step_case(request):
    do_stats = request.param
    jstate, jcfg = tiny_model(seed=6)
    jset = settings_for(jcfg, WIDTH)
    jopt = JaxOpt(**OPT)
    gt, flow = _inputs()
    k = jcfg.n_offsets
    rows = WINDOW_CAP * k
    loss_fn = jax_pair_loss(jcfg, jset, WINDOW_CAP, jopt, WIDTH, HEIGHT,
                            GEOM["scale"], GEOM["x_min"], GEOM["y_min"],
                            rasterizer="pallas_train")

    def f(p, m2d):
        st = jstate._replace(anchors=p[0], nets=p[1])
        return loss_fn(st, Z1, Z2, jnp.asarray(gt[0]) / 255.0,
                       jnp.asarray(gt[1]) / 255.0, jnp.asarray(flow), None,
                       JMode.FULL_PRECISION, m2d)

    params = (jstate.anchors, jstate.nets)
    m2d = jnp.zeros((4, rows, 2)) if do_stats else None
    argnums = (0, 1) if do_stats else 0
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        f, argnums=argnums, has_aux=True))(params, m2d)
    g_params = grads[0] if do_stats else grads
    lrs = {n: s(1) for n, s in jax_schedules(jopt).items()}
    new_params, _ = jax_adam_update(params, g_params, jax_adam_init(params),
                                    jax_lr_tree(params, lrs))
    stats = jax_init_stats(jstate.anchors.anchor.shape[0], k)
    if do_stats:
        stats = jax_accumulate(stats, aux["renders"],
                               [grads[1][i] for i in range(4)],
                               GEOM["scale"], k)
    jax_out = dict(loss=float(loss), grads=g_params, new=new_params,
                   stats=stats, lrs=lrs)

    # the port, on the carried-over state
    state = state_from_numpy(_payload(jstate))
    cfg = _port_cfg()
    pset = RasterSettings(**dataclasses.asdict(jset))
    opt = OptimizationConfig(**OPT)
    p_lrs = {n: s(1) for n, s in build_schedules(opt).items()}
    gt_t = [torch.from_numpy(gt[i]) for i in range(2)]
    flow_t = torch.from_numpy(flow)
    # gradients: the step's loss and autograd, taken on their own
    leaves = [p.detach().requires_grad_(True)
              for p in tree_leaves((state.anchors, state.nets))]
    p_tree = tree_unflatten((state.anchors, state.nets), leaves)
    st = state._replace(anchors=p_tree[0], nets=p_tree[1])
    p_loss, _ = make_pair_loss(cfg, pset, WINDOW_CAP, opt, WIDTH, HEIGHT,
                               GEOM["scale"], GEOM["x_min"], GEOM["y_min"])(
        st, Z1, Z2, gt_t[0].float() / 255.0, gt_t[1].float() / 255.0,
        flow_t, GenerateMode.FULL_PRECISION, None)
    p_grads = torch.autograd.grad(p_loss, leaves, allow_unused=True)
    step = make_step_body(cfg, pset, WINDOW_CAP, opt, WIDTH, HEIGHT,
                          GEOM["scale"], GEOM["x_min"], GEOM["y_min"])
    new_state, adam, p_stats, metrics = step(
        state, adam_init((state.anchors, state.nets)),
        init_stats(state.anchors.anchor.shape[0], cfg.n_offsets), p_lrs,
        Z1, Z2, gt_t[0], gt_t[1], flow_t, GenerateMode.FULL_PRECISION,
        do_stats)
    port_out = dict(loss=float(metrics.loss),
                    p_loss=float(p_loss.detach()), grads=p_grads, new=(new_state.anchors, new_state.nets),
                    stats=p_stats, lrs=p_lrs, adam=adam)
    return do_stats, jax_out, port_out


def _jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _port_leaves_named(tree):
    """(name, numpy) leaves in the JAX tree order: NamedTuple fields in
    order, dict keys sorted (jax's flattening order)."""
    out = []

    def walk(t, name):
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            for f, v in zip(t._fields, t):
                walk(v, f"{name}.{f}")
        elif isinstance(t, tuple):
            for i, v in enumerate(t):
                walk(v, f"{name}[{i}]")
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{name}.{k}")
        else:
            out.append((name, t.detach().numpy()))

    walk(tree, "")
    return out


def test_step_loss_matches_jax(step_case):
    _, j, p = step_case
    assert p["lrs"] == j["lrs"]
    np.testing.assert_allclose(p["loss"], j["loss"], rtol=1e-5)
    np.testing.assert_allclose(p["p_loss"], j["loss"], rtol=1e-5)


def test_step_gradients_match_jax(step_case):
    _, j, p = step_case
    shape_tree = p["new"]
    port = _port_leaves_named(tree_unflatten(
        shape_tree, [torch.zeros(()) if g is None else g
                     for g in p["grads"]]))
    want = _jax_leaves(j["grads"])
    assert len(port) == len(want)
    resolved = 0
    for (name, got), w in zip(port, want):
        if got.shape == ():   # no gradient reached the leaf in the port
            assert not np.any(w), name
            continue
        np.testing.assert_allclose(got, w, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        resolved += int(np.abs(w).max() > 10 * ATOL)
    assert resolved >= 10


def test_step_params_after_adam_match_jax(step_case):
    _, j, p = step_case
    port = _port_leaves_named(p["new"])
    want = _jax_leaves(j["new"])
    grads = _jax_leaves(j["grads"])
    lr_leaves = jax.tree_util.tree_leaves(jax_lr_tree(j["new"], j["lrs"]))
    for (name, got), w, g, lr in zip(port, want, grads, lr_leaves):
        lr = float(lr)
        tol = np.where(np.abs(g) > 10 * ATOL, 1e-3 * lr, 2.0 * lr) + 1e-7
        assert np.all(np.abs(got - w) <= tol), name
    assert p["adam"].step == 1


def test_step_stats_match_jax(step_case):
    do_stats, j, p = step_case
    js, ps = j["stats"], p["stats"]
    for name in ("opacity_accum", "anchor_demon", "offset_denom"):
        np.testing.assert_allclose(getattr(ps, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(ps.offset_gradient_accum.numpy(),
                               np.asarray(js.offset_gradient_accum),
                               rtol=RTOL, atol=ATOL * GEOM["scale"])
    assert (float(ps.offset_denom.sum()) > 0) == do_stats
    if do_stats:
        assert float(ps.offset_gradient_accum.max()) > 0
