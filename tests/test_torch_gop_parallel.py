"""The port's GOP fan-out and multi-rank CLI against the JAX package.

* ``make_gop_parallel_step`` at dp = 2 (two spawned gloo ranks, JAX and
  the JAX package blocked; tests/test_torch_spmd.py:run_ranks) against
  JAX's ``shard_map`` fan-out step on the 8-device virtual CPU mesh,
  from the same two per-GOP states (tests/test_parallel.py's): per-GOP
  losses at rtol 1e-4 (tests/test_parallel.py:308), statistics counts
  exactly.
* ``gop_densify_epoch`` from JAX's post-step arrays: every GOP's buffers,
  moments and statistics, the shared capacity and the results exactly,
  and the shared generator's state after the epoch equal to JAX's (its
  draws are taken GOP by GOP on every rank, as JAX takes them).
* ``fit_gops`` for two iterations of two GOPs against JAX's: the shared
  generator's state, capacity and ``window_cap``, the anchor counts and
  the reported losses (each GOP's nets transplanted from JAX's init).

The multi-rank CLI runs in tests/test_torch_multirank_cli.py.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsvc_tpu.config import ModelConfig as JaxModelConfig
from gsvc_tpu.config import OptimizationConfig as JaxOpt
from gsvc_tpu.models.gaussians import GenerateMode as JMode
from gsvc_tpu.parallel.spmd import (
    gop_densify_epoch as jax_gop_densify,
    make_gop_parallel_step as jax_gop_step, make_mesh as jax_mesh,
    stack_states as jax_stack,
)
from gsvc_tpu.render.pipeline import make_raster_settings as jax_settings
from gsvc_tpu.train.optim import adam_init as jax_adam_init
from gsvc_tpu.train.schedules import build_schedules as jax_schedules
from gsvc_tpu.train.trainer import init_stats as jax_init_stats
from tests.test_model import make_state
from tests.test_torch_spmd import start_ranks, wait_ranks

REPO = pathlib.Path(__file__).resolve().parents[1]
GEOM = dict(x_min=-0.4, y_min=-0.4, scale=20.0)
OPT = dict(optical_lambda=0.0, densify_grad_threshold=1e-5,
           update_interval=2)
TINY = dict(anchor_feature_dim=8, n_offsets=4, threshold=0.15,
            time_multi_res=4, offset_multi_res=4, log2=6, log2_2D=7,
            grid_feature_dim=2, resolutions_list=(6, 10),
            resolutions_list_2D=(12, 20))
FIT_PIPE = dict(tile_h=8, tile_w=16, visible_capacity=64, gaussian_chunk=16)
FIT_OPT = dict(iterations=2, init_anchor_num=64)

_JOB = r"""
def run(rank, job):
    import numpy as np
    import torch
    import torch.distributed as dist

    from gsvc_tpu_torch.config import ModelConfig, OptimizationConfig
    from gsvc_tpu_torch.convert import (
        state_from_numpy, training_state_from_numpy,
    )
    from gsvc_tpu_torch.models.gaussians import GaussianConfig, GenerateMode
    from gsvc_tpu_torch.parallel import spmd
    from gsvc_tpu_torch.render.pipeline import make_raster_settings
    from gsvc_tpu_torch.train.optim import adam_init
    from gsvc_tpu_torch.train.schedules import build_schedules
    from gsvc_tpu_torch.train.trainer import init_stats

    mesh = spmd.make_mesh(2, 1, "cpu")
    g = mesh.dp_index
    mc = ModelConfig(**job["model"])
    cfg = GaussianConfig.from_model_config(mc)
    opt = OptimizationConfig(**job["opt"])
    settings = make_raster_settings(cfg, 16, 16, tile_h=8, tile_w=16,
                                    gaussian_cap=64, chunk=16)
    geom = job["geom"]
    step = spmd.make_gop_parallel_step(
        cfg, settings, 64, opt, 16, 16, geom["scale"], geom["x_min"],
        geom["y_min"], mesh)
    state = state_from_numpy(job["states"][g])
    lrs = {n: s(1) for n, s in build_schedules(opt).items()}
    gt = torch.from_numpy(job["gts"][g])
    state, adam, stats, m = step(
        state, adam_init((state.anchors, state.nets)),
        init_stats(64, cfg.n_offsets), lrs, 0.0, 0.01, gt, gt,
        torch.zeros((2, 16, 16)), GenerateMode.FULL_PRECISION, True)
    out = {"metrics": [None, None], "stats": [None, None]}
    dist.all_gather_object(out["metrics"],
                           {k: float(v) for k, v in m.items()})
    dist.all_gather_object(out["stats"], {
        k: v.numpy() for k, v in stats._asdict().items()})

    # the densify epoch, on JAX's post-step arrays of this rank's GOP
    st, ad, sts = training_state_from_numpy(job["densify"][g])
    rng = np.random.default_rng(5)
    st, ad, sts, results, cap = spmd.gop_densify_epoch(
        st, ad, sts, mesh, mc, opt, 0.01, rng, cfg.n_offsets, 64)
    stacked = spmd.stack_states(st, mesh)
    gathered = {}
    for name, tree in (("m", ad.m[0]), ("v", ad.v[0]), ("stats", sts)):
        got = [None, None]
        dist.all_gather_object(got, {k: v.numpy() for k, v in
                                     tree._asdict().items()})
        gathered[name] = got
    out["densify"] = {
        "anchors": {k: v.numpy() for k, v in
                    stacked.anchors._asdict().items()},
        "n_active": stacked.n_active, "cap": cap,
        "results": [(r.n_grown, r.n_pruned, r.n_active) for r in results],
        "rng": rng.bit_generator.state, **gathered}
    per = spmd.unstack_states(stacked, 2)
    out["unstacked_rows"] = [p.anchors.anchor.shape[0] for p in per]

    # the library entry: two FULL_PRECISION iterations of two GOPs, each
    # GOP's model with the nets JAX's fit_gops drew from the seed that the
    # port's init asks for (a wrong seed takes another GOP's nets)
    from gsvc_tpu_torch.config import Config, PipelineConfig
    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.models.gaussians import NetParams, map_tree
    from gsvc_tpu_torch.train import fit as fit_mod

    real_init, real_fit = fit_mod.init_model, fit_mod.GOPFitter.fit

    def init_model(gen, *a, **k):
        st = real_init(gen, *a, **k)
        nets = job["fit_gops"]["nets"][gen.initial_seed()]
        return st._replace(nets=NetParams(**{
            f: map_tree(lambda x: torch.from_numpy(np.array(x)), nets[f])
            for f in NetParams._fields}))

    fitters = []

    def fit(self, *a, **k):
        fitters.append(self)
        return real_fit(self, *a, **k)

    fit_mod.init_model, fit_mod.GOPFitter.fit = init_model, fit
    fcfg = Config(model=mc, pipeline=PipelineConfig(**job["fit_gops"]["pipe"]),
                  optimization=OptimizationConfig(**job["fit_gops"]["opt"]))
    states, reports = spmd.fit_gops(
        mesh, fcfg, [FrameCubeDataset(images=v)
                     for v in job["fit_gops"]["videos"]],
        iterations=2, device="cpu")
    (f,) = fitters
    window_caps = [None, None]
    dist.all_gather_object(window_caps, f.window_cap)
    out["fit_gops"] = {"n": [s.n_active for s in states],
                       "reports": reports, "rng": f.rng.bit_generator.state,
                       "window_cap": window_caps,
                       "capacity": f.capacity}
    return out
"""


def _jax_init_nets(n_gops: int) -> dict:
    """The nets JAX's ``init_model`` draws from ``PRNGKey(seed)`` for
    seeds 0 .. n_gops - 1 (they depend on the key alone)."""
    from gsvc_tpu.models.gaussians import GaussianConfig as JaxGaussianConfig
    from gsvc_tpu.models.gaussians import init_model as jax_init_model

    gcfg = JaxGaussianConfig.from_model_config(JaxModelConfig(**TINY))
    pts = np.zeros((1, 3), np.float32)
    return {s: jax.tree.map(np.asarray, jax_init_model(
        jax.random.PRNGKey(s), gcfg, pts, 1024).nets._asdict())
        for s in range(n_gops)}


def _jax_fit_gops(videos):
    """JAX's ``fit_gops`` for two iterations of two GOPs, recording the
    ``window_cap`` its step is built with, its generator's state after
    the fit and each GOP's initial nets (the recorders wrap the JAX
    package's functions for this call only)."""
    import gsvc_tpu.models.gaussians as jg
    import gsvc_tpu.parallel.spmd as js
    from gsvc_tpu.config import Config as JaxConfig
    from gsvc_tpu.config import PipelineConfig as JaxPipeline
    from gsvc_tpu.framecube import FrameCubeDataset as JaxDataset

    seen = {"window_cap": [], "rng": [], "nets": []}
    real_step, real_init = js.make_gop_parallel_step, jg.init_model
    real_rng = np.random.default_rng

    def step(gcfg, settings, window_cap, *a, **k):
        seen["window_cap"].append(window_cap)
        return real_step(gcfg, settings, window_cap, *a, **k)

    def init_model(key, *a, **k):
        st = real_init(key, *a, **k)
        seen["nets"].append(jax.tree.map(np.asarray, st.nets._asdict()))
        return st

    def default_rng(*a, **k):
        g = real_rng(*a, **k)
        seen["rng"].append(g)
        return g

    cfg = JaxConfig(model=JaxModelConfig(**TINY),
                    pipeline=JaxPipeline(**FIT_PIPE),
                    optimization=JaxOpt(**FIT_OPT))
    datasets = [JaxDataset(images=v.astype(np.float32) / 255.0)
                for v in videos]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(js, "make_gop_parallel_step", step)
        mp.setattr(jg, "init_model", init_model)
        mp.setattr(np.random, "default_rng", default_rng)
        states, reports = js.fit_gops(
            jax_mesh(2, 1, devices=jax.devices()[:2]), cfg, datasets,
            iterations=2, seed=0)
    return {"n": [int(s.n_active) for s in states], "reports": reports,
            "rng": seen["rng"][0].bit_generator.state,
            "window_cap": seen["window_cap"],
            "capacity": int(states[0].anchors.anchor.shape[0]),
            "nets": dict(enumerate(seen["nets"]))}


@pytest.fixture(scope="module")
def fanout(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gop")
    cfgs_states = [make_state(n=64, capacity=64, seed=10 + i)
                   for i in range(2)]
    cfg = cfgs_states[0][0]
    states = [s for _, s in cfgs_states]
    settings = jax_settings(cfg, 16, 16, tile_h=8, tile_w=16,
                            gaussian_cap=64, chunk=16)
    opt = JaxOpt(**OPT)
    mesh = jax_mesh(2, 1, devices=jax.devices()[:2])
    step = jax_gop_step(cfg, settings, 64, opt, width=16, height=16,
                        **GEOM, mesh=mesh)
    stacked = jax_stack(states)
    adams = jax_adam_init((stacked.anchors, stacked.nets))
    lrs = {k: fn(1) for k, fn in jax_schedules(opt).items()}
    gts = np.random.default_rng(0).uniform(0.2, 0.8, (2, 3, 16, 16)) \
        .astype(np.float32)
    gstats = jax.tree.map(lambda x: jnp.stack([x] * 2),
                          jax_init_stats(64, cfg.n_offsets))
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    stacked2, adams2, gstats2, metrics = step(
        stacked, adams, gstats, lrs, jnp.zeros(2), jnp.full(2, 0.01),
        jnp.asarray(gts), jnp.asarray(gts), jnp.zeros((2, 2, 16, 16)),
        keys, mode=JMode.FULL_PRECISION, do_stats=True)

    def payload(i, st, adam, stats):
        pick = lambda t: jax.tree.map(lambda x: np.asarray(x[i]), t)
        return {"anchors": pick(st.anchors._asdict()),
                "nets": pick(st.nets._asdict()),
                "n_active": int(st.n_active[i]),
                "x_bound_min": np.asarray(st.x_bound_min[i]),
                "x_bound_max": np.asarray(st.x_bound_max[i]),
                "adam_m": pick((adam.m[0]._asdict(), adam.m[1]._asdict())),
                "adam_v": pick((adam.v[0]._asdict(), adam.v[1]._asdict())),
                "adam_step": int(adam.step),
                "stats": pick(stats._asdict())}

    def initial(st):
        return {"anchors": jax.tree.map(np.asarray, st.anchors._asdict()),
                "nets": jax.tree.map(np.asarray, st.nets._asdict()),
                "n_active": int(st.n_active),
                "x_bound_min": np.asarray(st.x_bound_min),
                "x_bound_max": np.asarray(st.x_bound_max)}

    post = [payload(i, stacked2, adams2, gstats2) for i in range(2)]
    rng = np.random.default_rng(5)
    mc = JaxModelConfig(**TINY)
    d_st, d_ad, d_stats, d_res, d_cap = jax_gop_densify(
        stacked2, adams2, gstats2, mesh, mc, opt, 0.01, rng, cfg.n_offsets,
        64)
    jax_out = {
        "loss": np.asarray(metrics["loss"]),
        "psnr": np.asarray(metrics["psnr"]),
        "stats": jax.tree.map(np.asarray, gstats2._asdict()),
        "densify": {
            "anchors": jax.tree.map(np.asarray, d_st.anchors._asdict()),
            "m": jax.tree.map(np.asarray, d_ad.m[0]._asdict()),
            "v": jax.tree.map(np.asarray, d_ad.v[0]._asdict()),
            "stats": jax.tree.map(np.asarray, d_stats._asdict()),
            "n_active": [int(n) for n in np.asarray(d_st.n_active)],
            "cap": d_cap, "rng": rng.bit_generator.state,
            "results": [(r.n_grown, r.n_pruned, r.n_active)
                        for r in d_res]}}
    videos = np.random.default_rng(2).integers(0, 256, (2, 3, 16, 16, 3),
                                               dtype=np.uint8)
    nets = _jax_init_nets(2)
    # the ranks run while JAX fits the two GOPs
    ranks = start_ranks(tmp, 2, _JOB, {
        "model": TINY, "opt": OPT, "geom": GEOM, "gts": gts,
        "states": [initial(s) for s in states], "densify": post,
        "fit_gops": {"videos": videos, "pipe": FIT_PIPE, "opt": FIT_OPT,
                     "nets": nets}})
    jax_out["fit_gops"] = _jax_fit_gops(videos)
    for s_, got in jax_out["fit_gops"]["nets"].items():
        jax.tree.map(np.testing.assert_array_equal, got, nets[s_])
    return jax_out, wait_ranks(ranks)


def test_gop_parallel_step_losses_match_jax(fanout):
    j, p = fanout
    for g in range(2):
        np.testing.assert_allclose(p["metrics"][g]["loss"], j["loss"][g],
                                   rtol=1e-4)
        np.testing.assert_allclose(p["metrics"][g]["psnr"], j["psnr"][g],
                                   rtol=1e-4)
    # independent GOPs
    assert p["metrics"][0]["loss"] != p["metrics"][1]["loss"]


def test_gop_parallel_step_stats_match_jax(fanout):
    j, p = fanout
    for g in range(2):
        for name in ("opacity_accum", "anchor_demon", "offset_denom"):
            np.testing.assert_allclose(p["stats"][g][name],
                                       j["stats"][name][g], rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        assert float(p["stats"][g]["offset_denom"].sum()) > 0


def test_gop_densify_epoch_matches_jax_exactly(fanout):
    j, p = fanout[0]["densify"], fanout[1]["densify"]
    assert p["results"] == j["results"]
    assert any(r[0] > 0 for r in p["results"])       # anchors grew
    assert (p["n_active"], p["cap"]) == (j["n_active"], j["cap"])
    # the shared generator: every GOP's draws, in JAX's order
    assert p["rng"] == j["rng"]
    for k, want in j["anchors"].items():
        np.testing.assert_array_equal(p["anchors"][k], want, err_msg=k)
    for group in ("m", "v", "stats"):
        for k, want in j[group].items():
            got = np.stack([p[group][g][k] for g in range(2)])
            np.testing.assert_array_equal(got, want, err_msg=f"{group}.{k}")
    assert fanout[1]["unstacked_rows"] == [p["cap"], p["cap"]]


def test_fit_gops_runs_every_gop(fanout):
    """``fit_gops``: every GOP's state and loss history on every rank."""
    got = fanout[1]["fit_gops"]
    assert len(got["n"]) == 2 and all(n > 0 for n in got["n"])
    for rep in got["reports"]:
        assert [r["iter"] for r in rep] == [2]
        assert np.isfinite(rep[0]["loss"])
    assert got["reports"][0] != got["reports"][1]


def test_fit_gops_matches_jax(fanout):
    """``fit_gops`` against JAX's on the same two videos: the shared
    generator's state after the fit (the point clouds GOP by GOP, then
    every step's frame draw for every GOP), the shared capacity and
    ``window_cap``, each GOP's anchor count, and the reported losses and
    PSNRs at rtol 1e-3 (as the mesh fitter's in tests/test_torch_spmd.py;
    each GOP starts from the nets JAX drew from ``PRNGKey(seed + gi)``)."""
    j, p = fanout[0]["fit_gops"], fanout[1]["fit_gops"]
    assert p["rng"] == j["rng"]
    assert p["capacity"] == j["capacity"]
    assert p["window_cap"] == [j["window_cap"][-1]] * 2
    assert p["n"] == j["n"]
    for g in range(2):
        assert [r["iter"] for r in p["reports"][g]] == \
            [r["iter"] for r in j["reports"][g]] == [2]
        for key in ("loss", "psnr"):
            np.testing.assert_allclose(p["reports"][g][0][key],
                                       j["reports"][g][0][key], rtol=1e-3,
                                       err_msg=f"GOP {g} {key}")
