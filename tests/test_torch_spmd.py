"""The port's multi-rank path (gsvc_tpu_torch/parallel/spmd.py) against
the JAX package's ``shard_map`` path on the same inputs.

The JAX side runs on the 8-device virtual CPU mesh of tests/conftest.py
with ``rasterizer="jnp"``; its programs are built once, in the
module-scoped fixture ``case``.  The port side runs in four spawned
processes (one a rank, ``torch.distributed`` over gloo on the CPU) that
import neither JAX nor the JAX package (``run_ranks``: the imports are
blocked); they take JAX's initial state through a JAX checkpoint, run
every scenario in one launch and hand back the gathered results.

* ``combine_slab_renders`` at sp = 4, both branches (all-gather and one
  ``ppermute`` round) and both view directions: against JAX's at the
  image tolerance (1e-5), the branches against each other to 1e-6 and
  both against the port's single-rank render of the whole state at
  JAX's own 2e-4 (tests/test_parallel.py:67).
* One ``make_spmd_train_step`` step (the mesh fitter's, dp = 2, sp = 2)
  in FULL_PRECISION with the densification statistics and one in
  ENTROPY with JAX's noise injected: the metrics, the parameters after
  Adam, the Adam moments and the statistics, at the mirror path's
  tolerances (tests/test_torch_step.py states them).  The first moment
  is (1 - beta1) g, so holding it to JAX's shows that the port
  reproduces the reference's n_sp scaling of every gradient that passes
  a collective (ROADMAP §C); without it the moments would be off by 2x.
  The nets are bit-identical on all four ranks.
* ``spmd_densify_epoch`` from JAX's post-step arrays and seed: exact.
* ``GOPFitter(mesh=...)`` for three iterations from the same checkpoint:
  the same frame draws (equal generator states) and losses to 1e-3, as
  tests/test_torch_train.py holds the single-GPU fit.
"""

import pathlib
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from gsvc_tpu.config import Config as JaxConfig
from gsvc_tpu.config import ModelConfig as JaxModelConfig
from gsvc_tpu.config import OptimizationConfig as JaxOpt
from gsvc_tpu.config import PipelineConfig as JaxPipeline
from gsvc_tpu.framecube import FrameCubeDataset as JaxDataset
from gsvc_tpu.models.gaussians import (
    GaussianConfig as JaxGaussianConfig, GenerateMode as JMode,
    ModelState as JaxModelState, init_model as jax_init_model,
    update_anchor_bound as jax_bound,
)
from gsvc_tpu.parallel.spmd import (
    combine_slab_renders as jax_combine, make_mesh as jax_mesh,
    shard_model_state as jax_shard, spmd_densify_epoch as jax_densify,
)
from gsvc_tpu.render.pipeline import (
    make_raster_settings as jax_settings, render_frame as jax_render,
)
from gsvc_tpu.train.fit import GOPFitter as JaxFitter
from gsvc_tpu.train.optim import build_lr_tree as jax_lr_tree
from gsvc_tpu.utils.checkpoint import save_checkpoint as jax_save_ckpt
from tests.test_torch_mirror import _jax_pair_noise
from tests.test_train import synthetic_video

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-3, 2e-4          # gradients (the mirror backward's)
IMG_ATOL = 1e-5
BETA1, BETA2 = 0.9, 0.999
MODEL = dict(anchor_feature_dim=8, n_offsets=4, threshold=0.3,
             time_multi_res=4, offset_multi_res=4, log2=6, log2_2D=7,
             grid_feature_dim=2, resolutions_list=(6, 10),
             resolutions_list_2D=(12, 20))
# FULL_PRECISION with statistics from iteration 1, no densify epoch in
# the fit; 680 initial anchors fill 2/3 of the 1024 rows, so the second
# of two z-slabs holds live anchors too
OPT = dict(iterations=3, init_anchor_num=680, optical_lambda=5.0,
           scaling_reg=0.01, opacity_reg=0.01, lmbda=0.05, mask_reg=0.01,
           start_stat=0, update_from=10 ** 9, update_until=10,
           full_precision_training_total=10, quantized_training_total=0,
           entropy_constrained_train_total=0,
           ste_entropy_constrained_train_total=0,
           densify_grad_threshold=1e-5, update_interval=2)
PIPE = dict(tile_h=8, tile_w=16, visible_capacity=256, gaussian_chunk=32,
            rasterizer="jnp")
H, W = 24, 32
COMBINE_GEOM = dict(x_min=-0.6, y_min=-0.45, scale=26.0)
COMBINE_MODEL = dict(MODEL, threshold=0.08)

# ---------------------------------------------------------------------------
# Spawned ranks
# ---------------------------------------------------------------------------

_WORKER = r"""
import datetime, importlib.abc, pickle, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "gsvc_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
repo, job_path, out_path, rank, world, port = sys.argv[1:7]
rank, world = int(rank), int(world)
sys.path.insert(0, repo)
import torch
import torch.distributed as dist

torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
try:
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    ns = {}
    exec(compile(job["source"], "<job>", "exec"), ns)
    res = ns["run"](rank, job)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "gsvc_tpu"))
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump({"res": res, "bad": bad}, f)
finally:
    dist.destroy_process_group()
"""


def start_ranks(tmp_path: pathlib.Path, world: int, source: str,
                job: dict) -> tuple:
    """Start ``source``'s ``run(rank, job)`` on ``world`` spawned ranks
    (one gloo group on 127.0.0.1, JAX and the JAX package blocked);
    ``wait_ranks`` collects rank 0's result."""
    worker = tmp_path / "rank_worker.py"
    worker.write_text(_WORKER)
    job_path, out_path = tmp_path / "job.pkl", tmp_path / "out.pkl"
    with open(job_path, "wb") as f:
        pickle.dump(dict(job, source=source), f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(REPO), str(job_path),
         str(out_path), str(r), str(world), str(port)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=env) for r in range(world)]
    return procs, out_path


def wait_ranks(started: tuple, timeout: float = 150.0) -> dict:
    """Rank 0's result of ``start_ranks``.  A rank that fails, or ranks
    still running after ``timeout`` seconds (all are killed), fail the
    test."""
    import time

    procs, out_path = started
    deadline = time.monotonic() + timeout
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            errs.append(err)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"ranks still running after {timeout} s")
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r}:\n{err[-4000:]}"
    with open(out_path, "rb") as f:
        got = pickle.load(f)
    assert got["bad"] == [], got["bad"]
    return got["res"]


def run_ranks(tmp_path: pathlib.Path, world: int, source: str, job: dict,
              timeout: float = 150.0) -> dict:
    """``start_ranks`` then ``wait_ranks``."""
    return wait_ranks(start_ranks(tmp_path, world, source, job), timeout)


_JOB = r"""
def run(rank, job):
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from gsvc_tpu_torch.config import (
        Config, ModelConfig, OptimizationConfig, PipelineConfig,
    )
    from gsvc_tpu_torch.convert import (
        state_from_numpy, training_state_from_numpy,
    )
    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.models.gaussians import GaussianConfig, GenerateMode
    from gsvc_tpu_torch.parallel import spmd
    from gsvc_tpu_torch.render.pipeline import (
        make_raster_settings, render_frame,
    )
    from gsvc_tpu_torch.train.fit import GOPFitter
    from gsvc_tpu_torch.train.optim import tree_leaves
    from gsvc_tpu_torch.utils.checkpoint import load_checkpoint

    def host(tree):
        return [t.detach().numpy().copy() for t in tree_leaves(tree)]

    out = {}
    # 1. the slab composite at sp = 4
    c = job["combine"]
    mesh14 = spmd.make_mesh(1, 4, "cpu")
    ccfg = GaussianConfig.from_model_config(ModelConfig(**c["model"]))
    full = state_from_numpy(c["state"])
    cstate = spmd.shard_model_state(full, mesh14)
    cset = make_raster_settings(ccfg, 24, 32, tile_h=8, tile_w=16,
                                gaussian_cap=128, chunk=32)
    for flip in (False, True):
        # the single-rank render of the whole state
        out[("full", flip)] = render_frame(
            full, ccfg, 0.0, c["geom"]["x_min"], c["geom"]["y_min"],
            c["geom"]["scale"], cset, 128, flip=flip).image.detach().numpy()
        r = render_frame(cstate, ccfg, 0.0, c["geom"]["x_min"],
                         c["geom"]["y_min"], c["geom"]["scale"], cset, 32,
                         flip=flip)
        for nb in (None, 1):
            img, _ = spmd.combine_slab_renders(
                r.image, r.transmittance, flip, cset.bg, mesh14,
                neighbors=nb)
            out[("combine", flip, nb)] = img.detach().numpy()

    # 2. the mesh fitter's step at dp = 2, sp = 2, from JAX's checkpoint
    mesh = spmd.make_mesh(2, 2, "cpu")
    cfg = Config(model=ModelConfig(**job["model"]),
                 pipeline=PipelineConfig(**job["pipe"]),
                 optimization=OptimizationConfig(**job["opt"]))
    frames = job["frames"]

    def fitter():
        f = GOPFitter(cfg, FrameCubeDataset(images=frames), seed=0,
                      device="cpu", mesh=mesh)
        load_checkpoint(job["ckpt0"], f)
        return f

    f = fitter()
    out["window_cap"], out["capacity"] = f.window_cap, f.capacity
    lrs = {n: s(1) for n, s in f.schedules.items()}
    e, d = job["inputs"], mesh.dp_index
    t = torch.from_numpy
    for case, mode, do_stats in (("fp_stats", "FULL_PRECISION", True),
                                 ("entropy", "ENTROPY", False)):
        noise = None
        if mode == "ENTROPY":
            noise = [tuple(t(a) for a in fr) for fr in e["noise"][d]]
        st, adam, stats, m = f.train_step(
            f.state, f.adam, f.stats, lrs, float(e["z1"][d]),
            float(e["z2"][d]), t(e["gt1"][d]), t(e["gt2"][d]),
            t(e["flow"][d]), GenerateMode[mode], do_stats, noise=noise)
        gs, ga, gst = spmd.gather_training_state(st, adam, stats, mesh)
        digest = hashlib.sha256(b"".join(
            x.numpy().tobytes() for x in tree_leaves(st.nets))).hexdigest()
        digests = [None] * 4
        dist.all_gather_object(digests, digest)
        out[case] = {"params": host((gs.anchors, gs.nets)),
                     "m": host(ga.m), "v": host(ga.v), "step": ga.step,
                     "stats": {k: v.numpy() for k, v in
                               gst._asdict().items()},
                     "metrics": {k: float(v) for k, v in
                                 m._asdict().items()},
                     "digests": digests}

    # 3. the densify epoch on JAX's post-step arrays
    dj = job["densify"]
    state, adam, stats = training_state_from_numpy(dj)
    state, adam, stats, res, cap = spmd.spmd_densify_epoch(
        spmd.shard_model_state(state, mesh), spmd.shard_adam_state(adam, mesh),
        spmd.shard_train_stats(stats, mesh), mesh, cfg.model,
        cfg.optimization, dj["voxel_size"], np.random.default_rng(3),
        cfg.model.n_offsets)
    gs, ga, gst = spmd.gather_training_state(state, adam, stats, mesh)
    out["densify"] = {
        "anchors": {k: v.numpy() for k, v in gs.anchors._asdict().items()},
        "m": {k: v.numpy() for k, v in ga.m[0]._asdict().items()},
        "v": {k: v.numpy() for k, v in ga.v[0]._asdict().items()},
        "stats": {k: v.numpy() for k, v in gst._asdict().items()},
        "n_active": state.n_active, "cap": cap,
        "result": (res.n_grown, res.n_pruned, res.n_active),
        "local_rows": state.anchors.anchor.shape[0]}

    # 4. three iterations of the mesh fitter
    f = fitter()
    rep = f.fit(iterations=3, log_every=1)
    gs, ga, gst = spmd.gather_training_state(f.state, f.adam, f.stats, mesh)
    out["fit"] = {"history": rep.history, "adam_step": ga.step,
                  "rng": f.rng.bit_generator.state,
                  "offset_denom": gst.offset_denom.numpy(),
                  "anchor_demon": gst.anchor_demon.numpy()}
    return out
"""


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _combine_state():
    """tests/test_parallel.py's neighbour-exchange state: anchors over z
    in [-0.5, 0.5], a +-0.08 window at z = 0 spanning 2 of 4 slabs."""
    cfg = JaxGaussianConfig.from_model_config(JaxModelConfig(
        **COMBINE_MODEL))
    rng = np.random.default_rng(11)
    pts = rng.uniform([-0.5, -0.4, -0.5], [0.5, 0.4, 0.5],
                      (128, 3)).astype(np.float32)
    state = jax_init_model(jax.random.PRNGKey(3), cfg, pts, capacity=128,
                           voxel_size=0.001)
    state = jax_bound(state, -0.6, -0.45, -0.5)
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    state = state._replace(anchors=state.anchors._replace(
        feat=0.5 * jax.random.normal(k1, state.anchors.feat.shape),
        offset=0.3 * jax.random.normal(k2, state.anchors.offset.shape)))
    payload = {"anchors": {k: np.asarray(v)
                           for k, v in state.anchors._asdict().items()},
               "nets": jax.tree.map(np.asarray, state.nets._asdict()),
               "n_active": int(state.n_active),
               "x_bound_min": np.asarray(state.x_bound_min),
               "x_bound_max": np.asarray(state.x_bound_max)}
    return cfg, state, {"model": COMBINE_MODEL, "state": payload,
                        "geom": COMBINE_GEOM}


def _combine_jax(cfg, state):
    """JAX's slab composite of the state at sp = 4, both view directions
    and both branches, in one program."""
    settings = jax_settings(cfg, 24, 32, tile_h=8, tile_w=16,
                            gaussian_cap=128, chunk=32)
    mesh = jax_mesh(1, 4, devices=jax.devices()[:4])

    def body(anchors, nets, n_active, bmin, bmax):
        st = JaxModelState(anchors=anchors, nets=nets, n_active=n_active,
                           x_bound_min=bmin, x_bound_max=bmax)
        outs = []
        for flip in (False, True):
            r = jax_render(st, cfg, 0.0, settings=settings, window_cap=32,
                           mode=JMode.FULL_PRECISION, flip=flip,
                           **COMBINE_GEOM)
            for nb in (None, 1):
                outs.append(jax_combine(r.image, r.transmittance, flip,
                                        settings.bg, neighbors=nb)[0])
        return jnp.stack(outs)

    f = shard_map(body, mesh=mesh, in_specs=(P("sp"), P(), P(), P(), P()),
                  out_specs=P(), check_vma=False)
    sh = jax_shard(state, mesh)
    imgs = np.asarray(jax.jit(f)(sh.anchors, state.nets, state.n_active,
                                 state.x_bound_min, state.x_bound_max))
    return {key: imgs[i] for i, key in enumerate(
        [(False, None), (False, 1), (True, None), (True, 1)])}


def _payload(jf_like, state, adam, stats):
    """A checkpoint-layout dict of global arrays."""
    return {"anchors": jax.tree.map(np.asarray, state.anchors._asdict()),
            "nets": jax.tree.map(np.asarray, state.nets._asdict()),
            "n_active": int(state.n_active),
            "x_bound_min": np.asarray(state.x_bound_min),
            "x_bound_max": np.asarray(state.x_bound_max),
            "adam_m": jax.tree.map(np.asarray, (adam.m[0]._asdict(),
                                                adam.m[1]._asdict())),
            "adam_v": jax.tree.map(np.asarray, (adam.v[0]._asdict(),
                                                adam.v[1]._asdict())),
            "adam_step": int(adam.step),
            "stats": jax.tree.map(np.asarray, stats._asdict()),
            "voxel_size": jf_like.voxel_size}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd")
    ccfg, cstate, combine_job = _combine_state()

    jcfg = JaxConfig(model=JaxModelConfig(**MODEL),
                     pipeline=JaxPipeline(**PIPE),
                     optimization=JaxOpt(**OPT))
    frames = np.round(synthetic_video(t=4, h=H, w=W) * 255).astype(np.uint8)
    mesh = jax_mesh(2, 2, devices=jax.devices()[:4])
    jf = JaxFitter(jcfg, JaxDataset(images=frames.astype(np.float32)
                                    / 255.0), seed=0, mesh=mesh)
    ckpt0 = tmp / "jax0.pkl"
    jax_save_ckpt(str(ckpt0), jf, 0)

    rng = np.random.default_rng(21)
    pairs = [(0, 1), (1, 2)]
    inputs = {
        "z1": np.array([jf.frame_zs[a] for a, _ in pairs], np.float32),
        "z2": np.array([jf.frame_zs[b] for _, b in pairs], np.float32),
        # uint8, as the fitter's frame store: the fit below reuses the
        # step's compilation
        "gt1": np.stack([frames[a].transpose(2, 0, 1) for a, _ in pairs]),
        "gt2": np.stack([frames[b].transpose(2, 0, 1) for _, b in pairs]),
        "flow": rng.normal(0, 1.5, (2, 2, H, W)).astype(np.float32)}
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    inputs["noise"] = [[tuple(a.numpy() for a in fr) for fr in
                        _jax_pair_noise(keys[d], jf.gcfg, jf.window_cap)]
                       for d in range(2)]
    lrs = {n: s(1) for n, s in jf.schedules.items()}

    def jax_step(mode, do_stats):
        st, adam, stats, m = jf.train_step(
            jf.state, jf.adam, jf.stats, lrs,
            jnp.asarray(inputs["z1"]), jnp.asarray(inputs["z2"]),
            jnp.asarray(inputs["gt1"]), jnp.asarray(inputs["gt2"]),
            jnp.asarray(inputs["flow"]), keys, mode=mode,
            do_stats=do_stats)
        return {"state": st, "adam": adam, "stats": stats,
                "params": _leaves((st.anchors, st.nets)),
                "m": _leaves(adam.m), "v": _leaves(adam.v),
                "lr": [float(x) for x in jax.tree_util.tree_leaves(
                    jax_lr_tree((st.anchors, st.nets), lrs))],
                "metrics": {k: float(v) for k, v in m._asdict().items()}}

    fp = jax_step(JMode.FULL_PRECISION, True)
    # the densify epoch on the FULL_PRECISION step's arrays
    densify_in = _payload(jf, fp["state"], fp["adam"], fp["stats"])
    d_state, d_adam, d_stats, d_res, d_cap = jax_densify(
        fp["state"], fp["adam"], fp["stats"], mesh, jcfg.model,
        jcfg.optimization, densify_in["voxel_size"],
        np.random.default_rng(3), jf.gcfg.n_offsets)
    jax_densified = {
        "anchors": jax.tree.map(np.asarray, d_state.anchors._asdict()),
        "m": jax.tree.map(np.asarray, d_adam.m[0]._asdict()),
        "v": jax.tree.map(np.asarray, d_adam.v[0]._asdict()),
        "stats": jax.tree.map(np.asarray, d_stats._asdict()),
        "n_active": int(d_state.n_active), "cap": d_cap,
        "result": (d_res.n_grown, d_res.n_pruned, d_res.n_active)}

    # the ranks run while JAX compiles the rest
    ranks = start_ranks(tmp, 4, _JOB, {
        "combine": combine_job, "model": MODEL, "pipe": PIPE, "opt": OPT,
        "frames": frames, "ckpt0": str(ckpt0), "inputs": inputs,
        "densify": densify_in})
    jax_steps = {"fp_stats": fp,
                 "entropy": jax_step(JMode.ENTROPY, False)}
    jax_combine_out = _combine_jax(ccfg, cstate)
    jrep = jf.fit(iterations=3, log_every=1)
    jax_fit = {"history": jrep.history, "adam_step": int(jf.adam.step),
               "rng": jf.rng.bit_generator.state,
               "offset_denom": np.asarray(jf.stats.offset_denom),
               "anchor_demon": np.asarray(jf.stats.anchor_demon)}

    port = wait_ranks(ranks)
    return {"combine": jax_combine_out, "steps": jax_steps,
            "densify": jax_densified, "fit": jax_fit,
            "window_cap": jf.window_cap, "capacity": jf.capacity,
            "port": port}


# ---------------------------------------------------------------------------
# The slab composite
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flip", [False, True], ids=["fwd", "flip"])
@pytest.mark.parametrize("neighbors", [None, 1], ids=["gather", "ppermute"])
def test_combine_slab_renders_matches_jax(case, flip, neighbors):
    got = case["port"][("combine", flip, neighbors)]
    np.testing.assert_allclose(got, case["combine"][(flip, neighbors)],
                               rtol=0, atol=IMG_ATOL)
    # the branches agree, and both give the single-device render
    other = case["port"][("combine", flip, None if neighbors else 1)]
    np.testing.assert_allclose(got, other, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, case["port"][("full", flip)], rtol=0,
                               atol=2e-4)
    assert float(np.abs(got).max()) > 0.05


# ---------------------------------------------------------------------------
# The SPMD step at dp = 2, sp = 2
# ---------------------------------------------------------------------------

STEP_CASES = ["fp_stats", "entropy"]


def test_mesh_fitter_sizes_match_jax(case):
    port = case["port"]
    assert (port["window_cap"], port["capacity"]) == (
        case["window_cap"], case["capacity"])
    assert port["capacity"] % 2 == 0
    # the second slab holds live anchors: both ranks render
    assert case["port"]["densify"]["local_rows"] * 2 == \
        case["densify"]["cap"]


@pytest.mark.parametrize("name", STEP_CASES)
def test_spmd_step_metrics_match_jax(case, name):
    j, p = case["steps"][name]["metrics"], case["port"][name]["metrics"]
    for key in ("loss", "l1", "psnr", "scaling_reg", "optical_loss",
                "bit_per_param", "bit_per_feat_param",
                "bit_per_scaling_param", "bit_per_offsets_param",
                "mask_ratio"):
        np.testing.assert_allclose(p[key], j[key], rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    for key in ("active_gaussians", "num_rendered", "overflow",
                "harmful_overflow"):
        assert p[key] == j[key], key
    assert (j["bit_per_param"] > 0) == (name == "entropy")
    assert p["optical_loss"] > 0


def _grad_atol(w, name, entropy):
    # in the entropy modes the rate's float32 erf error sets a floor of
    # 4e-3 of each leaf's largest gradient (tests/test_torch_step.py)
    return max(ATOL, 4e-3 * float(np.abs(w).max())) if entropy else ATOL


@pytest.mark.parametrize("name", STEP_CASES)
def test_spmd_step_adam_moments_match_jax(case, name):
    """The first moment after one step is (1 - beta1) g and the second
    (1 - beta2) g^2: held as gradients, at the step's gradient
    tolerance.  Both carry JAX's n_sp factor."""
    j, p = case["steps"][name], case["port"][name]
    assert p["step"] == 1
    for i, (gm, pm, gv, pv) in enumerate(zip(j["m"], p["m"], j["v"],
                                             p["v"])):
        g_want = gm / (1 - BETA1)
        atol = _grad_atol(g_want, i, name == "entropy")
        np.testing.assert_allclose(pm / (1 - BETA1), g_want, rtol=RTOL,
                                   atol=atol, err_msg=f"m leaf {i}")
        np.testing.assert_allclose(np.sqrt(pv / (1 - BETA2)),
                                   np.sqrt(gv / (1 - BETA2)), rtol=RTOL,
                                   atol=atol, err_msg=f"v leaf {i}")
    assert max(float(np.abs(m).max()) for m in p["m"]) > 1e-4


@pytest.mark.parametrize("name", STEP_CASES)
def test_spmd_step_params_after_adam_match_jax(case, name):
    """Adam's first step moves an element by about lr * sign(g): where
    JAX's gradient is resolved (|g| > 10 atol) the two agree to 1e-3 lr,
    below that by up to 2 lr (tests/test_torch_step.py)."""
    j, p = case["steps"][name], case["port"][name]
    for i, (got, want, m, lr) in enumerate(zip(p["params"], j["params"],
                                               j["m"], j["lr"])):
        g = m / (1 - BETA1)
        tol = np.where(np.abs(g) > 10 * ATOL, 1e-3 * lr, 2.0 * lr) + 1e-7
        assert np.all(np.abs(got - want) <= tol), f"leaf {i}"


@pytest.mark.parametrize("name", STEP_CASES)
def test_spmd_step_nets_identical_on_every_rank(case, name):
    digests = case["port"][name]["digests"]
    assert len(digests) == 4 and len(set(digests)) == 1


def test_spmd_step_stats_match_jax(case):
    js = {k: np.asarray(v) for k, v in
          case["steps"]["fp_stats"]["stats"]._asdict().items()}
    ps = case["port"]["fp_stats"]["stats"]
    for name in ("opacity_accum", "anchor_demon", "offset_denom"):
        np.testing.assert_allclose(ps[name], js[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(ps["offset_gradient_accum"],
                               js["offset_gradient_accum"], rtol=RTOL,
                               atol=ATOL * 24.0)
    # four views a step, both dp groups' samples summed
    assert float(ps["anchor_demon"].max()) == 8.0
    assert float(ps["offset_gradient_accum"].max()) > 0


# ---------------------------------------------------------------------------
# Densification and the fitter
# ---------------------------------------------------------------------------

def test_spmd_densify_epoch_matches_jax_exactly(case):
    j, p = case["densify"], case["port"]["densify"]
    assert p["result"] == j["result"] and p["result"][0] > 0
    assert (p["n_active"], p["cap"]) == (j["n_active"], j["cap"])
    assert p["cap"] % 2 == 0
    for group in ("anchors", "m", "v", "stats"):
        for k, want in j[group].items():
            np.testing.assert_array_equal(p[group][k], want,
                                          err_msg=f"{group}.{k}")


def test_mesh_fitter_three_iterations_match_jax(case):
    j, p = case["fit"], case["port"]["fit"]
    assert [h["iter"] for h in p["history"]] == [1, 2, 3]
    # two frame-pair draws a step from equal generators
    assert p["rng"] == j["rng"]
    np.testing.assert_allclose([h["loss"] for h in p["history"]],
                               [h["loss"] for h in j["history"]],
                               rtol=1e-3)
    assert p["adam_step"] == j["adam_step"] == 3
    np.testing.assert_array_equal(p["offset_denom"], j["offset_denom"])
    np.testing.assert_array_equal(p["anchor_demon"], j["anchor_demon"])
