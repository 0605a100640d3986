"""The port's training loop against the JAX package's: the phase
controller and learning-rate schedules, ``init_model``'s anchors, the
frame dataset, the fitter's frame-pair draws, three iterations of
``GOPFitter.fit`` from a carried-over state, a fit through all four
phases with densify epochs (JAX's noise injected), and checkpoints read
both ways and across device types — plus the train CLI with JAX blocked
from import.

Integer and host-numpy paths (controller, schedules, voxelisation, 3-NN
scales, padding, frame-pair draws, densify decisions, rng states) must be
equal.  Losses agree to rtol 1e-3: the first equals to float rounding
(tests/test_torch_step.py), later ones follow Adam steps of about
lr * sign(g), where a near-zero gradient's sign is rounding.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gsvc_tpu.config import Config as JaxConfig
from gsvc_tpu.config import ModelConfig as JaxModelConfig
from gsvc_tpu.config import OptimizationConfig as JaxOpt
from gsvc_tpu.config import PipelineConfig as JaxPipeline
from gsvc_tpu.framecube import FrameCubeDataset as JaxDataset
from gsvc_tpu.models.gaussians import (
    GaussianConfig as JaxGaussianConfig, init_model as jax_init_model,
    mean_nn3_distance as jax_nn3,
)
from gsvc_tpu.train.controller import TrainingController as JaxController
from gsvc_tpu.train.fit import GOPFitter as JaxFitter
from gsvc_tpu.train.schedules import build_schedules as jax_schedules
from gsvc_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_ckpt, save_checkpoint as jax_save_ckpt,
)
from gsvc_tpu_torch.config import Config, ModelConfig, OptimizationConfig, \
    PipelineConfig, load_config
from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
from gsvc_tpu_torch.models.gaussians import (
    GaussianConfig, init_model, mean_nn3_distance,
)
from gsvc_tpu_torch.train.controller import TrainingController
from gsvc_tpu_torch.train.fit import GOPFitter
from gsvc_tpu_torch.train.schedules import build_schedules
from gsvc_tpu_torch.utils.checkpoint import (
    load_checkpoint, read_checkpoint, save_checkpoint,
)
from tests.test_torch_mirror import _jax_pair_noise
from tests.test_train import synthetic_video

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE_CFG = REPO / "artifacts" / "rd_r5" / "realtex_0.004" / \
    "cfg_args.yaml"
MODEL = dict(anchor_feature_dim=8, n_offsets=4, threshold=0.3,
             time_multi_res=4, offset_multi_res=4, log2=6, log2_2D=7,
             grid_feature_dim=2, resolutions_list=(6, 10),
             resolutions_list_2D=(12, 20))
# FULL_PRECISION throughout (no noise draws to match), statistics from
# iteration 2 on, no densify epoch
SCHEDULE = dict(iterations=3, init_anchor_num=120, optical_lambda=5.0,
                start_stat=1, update_from=10 ** 9, update_until=10,
                full_precision_training_total=10,
                quantized_training_total=0,
                entropy_constrained_train_total=0,
                ste_entropy_constrained_train_total=0)
# all four phases (4 + 2 + 3 + 2 iterations, then STE_ENTROPY past the
# schedule's end) with densify epochs at iterations 3, 6 and 9
FOUR_PHASES = dict(iterations=12, update_from=2, update_interval=3,
                   update_until=10, full_precision_training_total=4,
                   quantized_training_total=2,
                   entropy_constrained_train_total=3,
                   ste_entropy_constrained_train_total=2,
                   pause_densification=1, densify_grad_threshold=1e-5)


def _configs():
    pipe = dict(tile_h=8, tile_w=16, visible_capacity=256,
                gaussian_chunk=32, rasterizer="pallas_train")
    jcfg = JaxConfig(model=JaxModelConfig(**MODEL),
                     pipeline=JaxPipeline(**pipe),
                     optimization=JaxOpt(**SCHEDULE))
    pcfg = Config(model=ModelConfig(**MODEL),
                  pipeline=PipelineConfig(**pipe),
                  optimization=OptimizationConfig(**SCHEDULE))
    return jcfg, pcfg


def _video_u8():
    return np.round(synthetic_video(t=4, h=24, w=32) * 255).astype(np.uint8)


def test_controller_and_schedules_match_jax():
    jopt = load_config_jax(FIXTURE_CFG).optimization
    opt = load_config(str(FIXTURE_CFG)).optimization
    jc, pc = JaxController(jopt), TrainingController(opt)
    js, ps = jax_schedules(jopt), build_schedules(opt)
    assert sorted(js) == sorted(ps)
    for it in list(range(0, 3200)) + [4999, 5000, 5001, 8000, 9000]:
        jc.current_iteration = pc.current_iteration = it
        jm, pm = jc.render_mode, pc.render_mode
        assert (None if jm is None else jm.name) == \
            (None if pm is None else pm.name), it
        assert jc.gaussian_statis == pc.gaussian_statis, it
        assert jc.gaussian_adjust_anchor == pc.gaussian_adjust_anchor, it
        assert jc.clean_denorm == pc.clean_denorm, it
        for name in js:
            assert js[name](it) == ps[name](it), (name, it)


def load_config_jax(path):
    from gsvc_tpu.config import load_config as jax_load_config

    return jax_load_config(str(path))


@pytest.mark.parametrize("n", [3, 400])
def test_init_model_anchors_match_jax(n):
    rng = np.random.default_rng(n)
    pts = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    pts[1] = pts[0] + 1e-5                # merged by the voxelisation
    np.testing.assert_array_equal(mean_nn3_distance(pts), jax_nn3(pts))
    jcfg = JaxGaussianConfig.from_model_config(JaxModelConfig(**MODEL))
    cfg = GaussianConfig.from_model_config(ModelConfig(**MODEL))
    cap = 512
    js = jax_init_model(jax.random.PRNGKey(0), jcfg, pts, cap)
    ps = init_model(torch.Generator().manual_seed(0), cfg, pts, cap)
    assert ps.n_active == int(js.n_active) < n
    for name, got in ps.anchors._asdict().items():
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(js.anchors, name)),
                                      err_msg=name)
    # the networks: the JAX shapes, drawn from the JAX distributions
    # (the hash table U(-1e-4, 1e-4), each linear U(+-1/sqrt(fan_in)))
    assert ps.nets.hash_table.shape == js.nets.hash_table.shape
    assert float(ps.nets.hash_table.abs().max()) <= 1e-4

    def linears(tree):
        if set(tree) == {"w", "b"}:
            return [tree]
        return [x for k in sorted(tree) for x in linears(tree[k])]

    for name in ps.nets._fields[1:]:
        jl, pl = linears(getattr(js.nets, name)), linears(
            getattr(ps.nets, name))
        assert len(jl) == len(pl), name
        for ja, pa in zip(jl, pl):
            bound = 1.0 / np.sqrt(ja["w"].shape[0])
            for k in ("w", "b"):
                assert tuple(pa[k].shape) == ja[k].shape, name
                assert float(pa[k].abs().max()) <= bound, name
                assert pa[k].numel() < 8 or \
                    float(pa[k].std()) > 0.3 * bound, name


def test_frame_folder_dataset_matches_jax(tmp_path):
    frames = _video_u8()
    for i, fr in enumerate(frames):
        Image.fromarray(fr).save(tmp_path / f"f_{i:03d}.png")
    jd = JaxDataset(str(tmp_path), cache=False)
    pd = FrameCubeDataset(str(tmp_path))              # builds the cache
    pd2 = FrameCubeDataset(str(tmp_path))             # reads it
    np.testing.assert_array_equal(np.asarray(pd.images_u8), frames)
    np.testing.assert_array_equal(np.asarray(pd2.images_u8), frames)
    np.testing.assert_array_equal(pd.images[2], jd.images[2])
    for d in (pd, pd2):
        assert (d.width, d.height, d.num_frames, d.scale, d.x_min,
                d.y_min, d.z_min) == (jd.width, jd.height, jd.num_frames,
                                      jd.scale, jd.x_min, jd.y_min,
                                      jd.z_min)
    mem = FrameCubeDataset(images=frames)
    assert mem.images_u8.dtype == np.uint8
    np.testing.assert_array_equal(mem.images[1], jd.images[1])


@pytest.fixture(scope="module")
def fitters(tmp_path_factory):
    """A JAX fitter and a port fitter on the same video, the port's
    state carried over from the JAX fitter through a JAX checkpoint."""
    jcfg, pcfg = _configs()
    frames = _video_u8()
    jf = JaxFitter(jcfg, JaxDataset(images=frames.astype(np.float32) / 255.0),
                   seed=0)
    pf = GOPFitter(pcfg, FrameCubeDataset(images=frames), seed=0,
                   device="cpu")
    init_states = (jf.rng.bit_generator.state, pf.rng.bit_generator.state)
    path = tmp_path_factory.mktemp("ckpt") / "jax.pkl"
    jax_save_ckpt(str(path), jf, 0)
    assert load_checkpoint(str(path), pf) == 0
    return jf, pf, init_states


def test_fitter_init_matches_jax(fitters):
    jf, pf, (j_rng, p_rng) = fitters
    assert j_rng == p_rng                   # the point-cloud draw
    assert (pf.capacity, pf.window_cap) == (jf.capacity, jf.window_cap)
    assert dataclasses.asdict(pf.settings) == dataclasses.asdict(
        jf.settings)
    np.testing.assert_array_equal(pf.frame_zs, jf.frame_zs)
    np.testing.assert_array_equal(pf.images.numpy(), np.asarray(jf.images))
    for name, got in pf.state.anchors._asdict().items():
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(jf.state.anchors, name)))


def test_three_iterations_match_jax(fitters):
    jf, pf, _ = fitters
    jr = jf.fit(iterations=3, log_every=1)
    pr = pf.fit(iterations=3, log_every=1)
    assert [h["iter"] for h in pr.history] == [1, 2, 3]
    # the same frame-pair draws: one integers() per iteration on equal
    # generators leaves equal states
    assert jf.rng.bit_generator.state == pf.rng.bit_generator.state
    np.testing.assert_allclose([h["loss"] for h in pr.history],
                               [h["loss"] for h in jr.history], rtol=1e-3)
    assert pf.adam.step == int(jf.adam.step) == 3
    assert float(pf.stats.offset_denom.sum()) == float(
        np.asarray(jf.stats.offset_denom).sum()) > 0


def test_checkpoints_read_both_ways(fitters, tmp_path):
    jf, pf, _ = fitters
    path = tmp_path / "port.pkl"
    save_checkpoint(str(path), pf, 3)
    assert jax_load_ckpt(str(path), jf) == 3
    for name, got in pf.state.anchors._asdict().items():
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(jf.state.anchors, name)))
    jm = jax.tree_util.tree_leaves(jf.adam.m)
    pm = jax.tree_util.tree_leaves(jax.tree.map(lambda t: t.numpy(),
                                                pf.adam.m))
    assert len(jm) == len(pm)
    for a, b in zip(jm, pm):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(jf.adam.step) == pf.adam.step
    assert jf.controller.current_iteration == \
        pf.controller.current_iteration
    assert jf.rng.bit_generator.state == pf.rng.bit_generator.state
    np.testing.assert_array_equal(np.asarray(jf.key),
                                  np.asarray(jax.random.PRNGKey(0)))
    # and back into a fresh port fitter, generator state included
    _, pcfg = _configs()
    fresh = GOPFitter(pcfg, FrameCubeDataset(images=_video_u8()), seed=5,
                      device="cpu")
    assert load_checkpoint(str(path), fresh) == 3
    assert torch.equal(fresh.generator.get_state(),
                       pf.generator.get_state())
    np.testing.assert_array_equal(fresh.stats.offset_gradient_accum.numpy(),
                                  pf.stats.offset_gradient_accum.numpy())


def test_four_phase_fit_matches_jax(tmp_path, monkeypatch):
    """Twelve iterations through FULL_PRECISION, QUANTIZED_NOISE, ENTROPY
    and STE_ENTROPY (and one past the schedule) with three densify epochs
    (the index-plan path), from a carried-over state: the port takes the
    uniform draws of JAX's key chain (one split per iteration, then per
    frame and attribute), so every iteration's loss and bits per
    parameter follow JAX's and the densify epochs grow and prune the same
    anchors."""
    import gsvc_tpu_torch.train.fit as port_fit
    from gsvc_tpu_torch.models.gaussians import GenerateMode

    jcfg, pcfg = _configs()
    for c in (jcfg, pcfg):
        for k, v in FOUR_PHASES.items():
            setattr(c.optimization, k, v)
    frames = _video_u8()
    jf = JaxFitter(jcfg, JaxDataset(images=frames.astype(np.float32)
                                    / 255.0), seed=0)
    pf = GOPFitter(pcfg, FrameCubeDataset(images=frames), seed=0,
                   device="cpu")
    jax_save_ckpt(str(tmp_path / "jax.pkl"), jf, 0)
    load_checkpoint(str(tmp_path / "jax.pkl"), pf)

    key = [jf.key]
    make_step = port_fit.make_step_body

    def with_jax_noise(cfg, settings, window_cap, *args, **kw):
        body = make_step(cfg, settings, window_cap, *args, **kw)

        def step(*a, mode, do_stats, generator=None, noise=None,
                 timer=None):
            key[0], sk = jax.random.split(key[0])
            if mode in (GenerateMode.QUANTIZED_NOISE, GenerateMode.ENTROPY):
                noise = _jax_pair_noise(sk, cfg, window_cap)
            return body(*a, mode=mode, do_stats=do_stats, noise=noise,
                        timer=timer)
        return step

    monkeypatch.setattr(port_fit, "make_step_body", with_jax_noise)
    pf._build_step()
    jr = jf.fit(log_every=1)
    pr = pf.fit(log_every=1)
    assert [h["iter"] for h in pr.history] == list(range(1, 13))
    np.testing.assert_allclose([h["loss"] for h in pr.history],
                               [h["loss"] for h in jr.history], rtol=1e-3)
    # the bits count quantised symbols: once Adam steps differ in the
    # sign of near-zero gradients, a value at a rounding edge of
    # round(x / q) moves a symbol and its bits (the first entropy
    # iteration agrees to 1e-6, the last to 3e-3)
    np.testing.assert_allclose([h["bpp"] for h in pr.history],
                               [h["bpp"] for h in jr.history], rtol=5e-3)
    counts = [h["n_active"] for h in pr.history]
    assert counts == [h["n_active"] for h in jr.history]
    assert counts[2] > counts[1]                 # the first epoch grew
    assert [h["bpp"] > 0 for h in pr.history] == [False] * 6 + [True] * 6
    assert jf.rng.bit_generator.state == pf.rng.bit_generator.state
    assert (pf.capacity, pf.window_cap) == (jf.capacity, jf.window_cap)
    assert pf.adam.step == int(jf.adam.step) == 12


def test_checkpoint_from_another_device_type_loads(fitters, tmp_path):
    """A checkpoint whose noise-generator state is a CUDA generator's (16
    bytes, no device type recorded, as written on the card before the
    device type was stored) loads into a CPU fitter: the model state
    restores and the generator is reseeded from (seed, iteration)."""
    _, pf, _ = fitters
    path = tmp_path / "card.pkl"
    save_checkpoint(str(path), pf, 3)
    assert read_checkpoint(str(path))["torch_generator_device"] == "cpu"
    import pickle
    p = read_checkpoint(str(path))
    p["torch_generator"] = np.arange(16, dtype=np.uint8)
    del p["torch_generator_device"]
    with open(path, "wb") as f:
        pickle.dump(p, f)
    _, pcfg = _configs()
    logs = []
    fresh = GOPFitter(pcfg, FrameCubeDataset(images=_video_u8()), seed=5,
                      device="cpu", log_fn=logs.append)
    assert load_checkpoint(str(path), fresh) == 3
    assert any("reseeded" in m for m in logs)
    for name, got in fresh.state.anchors._asdict().items():
        assert torch.equal(got, getattr(pf.state.anchors, name)), name
    again = GOPFitter(pcfg, FrameCubeDataset(images=_video_u8()), seed=9,
                      device="cpu")
    load_checkpoint(str(path), again)
    assert torch.equal(again.generator.get_state(),
                       fresh.generator.get_state())


_BLOCKED_FIT = r"""
import importlib, importlib.abc, json, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "gsvc_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import gsvc_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(gsvc_tpu_torch.__path__,
                                              "gsvc_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from gsvc_tpu_torch.cli.train import main
res = main(sys.argv[2:])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "gsvc_tpu"))
print(json.dumps({"modules": len(mods), "bad": bad, "res": res}))
"""


def _cli_inputs(tmp_path, frames):
    """PNG frames and a config of the tiny model with a six-iteration
    four-phase schedule (a densify epoch at iteration 4)."""
    src = tmp_path / "frames"
    src.mkdir()
    for i, fr in enumerate(frames):
        Image.fromarray(fr).save(src / f"f_{i:03d}.png")
    cfg = tmp_path / "small.yaml"
    _, pcfg = _configs()
    pcfg.optimization.iterations = 6
    pcfg.optimization.full_precision_training_total = 2
    pcfg.optimization.quantized_training_total = 1
    pcfg.optimization.entropy_constrained_train_total = 2
    pcfg.optimization.ste_entropy_constrained_train_total = 1
    pcfg.optimization.pause_densification = 1
    pcfg.optimization.update_from = 1
    pcfg.optimization.update_interval = 4
    from gsvc_tpu_torch.config import save_config
    save_config(pcfg, str(cfg))
    return src, cfg


def _run_blocked_cli(tmp_path, args):
    import json
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_FIT, str(REPO), *args],
        capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == [] and got["modules"] >= 30
    return got


def test_cli_fits_on_cpu_with_jax_blocked(tmp_path):
    """Every module of the port imports with JAX blocked, and the train
    CLI fits a tiny GOP on the CPU, checkpoints and writes results."""
    import json
    src, cfg = _cli_inputs(tmp_path, _video_u8())
    out = tmp_path / "out"
    got = _run_blocked_cli(tmp_path, [
        "--source_path", str(src), "--model_path", str(out),
        "--config_path", str(cfg), "--device", "cpu", "--skip_codec",
        "--checkpoint_iterations", "2"])
    assert got["res"]["iterations"] == 6 and np.isfinite(
        got["res"]["fit_psnr"])
    assert (out / "chkpnt_final.pkl").exists()
    assert (out / "chkpnt2.pkl").exists()
    assert json.loads((out / "results.json").read_text()) == got["res"]


# the keys of the JAX train CLI's results.json on the single-GOP path
# (gsvc_tpu/cli/train.py main and _codec_eval; tests/test_torch_encode.py
# holds the port's _codec_eval keys to JAX's at run time)
JAX_RESULT_KEYS = {"fit_psnr", "iterations", "n_anchors", "bpp",
                   "encode_seconds", "decode_seconds", "decoded_psnr",
                   "decoded_ssim", "decoded_ms_ssim", "decoded_lpips",
                   "decode_fps", "size_mb"}


@pytest.mark.parametrize("width", [32, 40], ids=["aligned", "unaligned"])
def test_cli_encodes_on_cpu_with_jax_blocked(tmp_path, width):
    """Without ``--skip_codec`` the train CLI fits, estimates, encodes,
    saves, decodes and evaluates a tiny GOP on the CPU with JAX blocked,
    at a width that is a multiple of ``tile_w`` (16) and at one that is
    not: ``bitstreams/`` in the JAX package's format and ``results.json``
    with JAX's keys (plus ``device``)."""
    import json
    import pickle
    import zlib
    frames = np.round(synthetic_video(t=4, h=24, w=width) * 255).astype(
        np.uint8)
    src, cfg = _cli_inputs(tmp_path, frames)
    out = tmp_path / "out"
    got = _run_blocked_cli(tmp_path, [
        "--source_path", str(src), "--model_path", str(out),
        "--config_path", str(cfg), "--device", "cpu", "--eval_stride", "2"])
    res = json.loads((out / "results.json").read_text())
    assert res == got["res"]
    assert set(res) == JAX_RESULT_KEYS | {"device", "eval_stride",
                                          "eval_frames"}
    assert res["bpp"] > 0 and np.isfinite(res["decoded_psnr"])
    assert res["eval_frames"] == 2 and res["decoded_lpips"] is None
    bs = out / "bitstreams"
    total = sum(p.stat().st_size for p in bs.iterdir())
    assert res["size_mb"] == total / 2 ** 20
    assert res["bpp"] == total * 8 / (width * 24 * 4)
    meta = zlib.decompress((bs / "meta.bin").read_bytes())
    assert b"gsvc_tpu.codec.bitstream" in meta
    from gsvc_tpu.codec.bitstream import EncodeMeta as JaxMeta
    jm = pickle.loads(meta)
    assert isinstance(jm, JaxMeta) and jm.video_info == {
        "width": width, "height": 24, "num_frames": 4}
    log = (out / "output.log").read_text()
    assert "estimated bits: total=" in log and "encoded " in log


def test_cli_refuses_unported_options(tmp_path):
    """Only multi-GPU fitting is left unported (ROADMAP A5); LPIPS,
    --gop_size and --profile work (tests/test_torch_cli_surface.py)."""
    from gsvc_tpu_torch.cli.train import main

    with pytest.raises(NotImplementedError, match="mesh"):
        main(["--model_path", str(tmp_path), "--device", "cpu",
              "--skip_codec", "--mesh", "dp=2,sp=1"])
    with pytest.raises(NotImplementedError, match="gop_parallel"):
        main(["--model_path", str(tmp_path), "--device", "cpu",
              "--gop_size", "2", "--gop_parallel"])
