"""The stream composite in the port's training and streaming entry points:
a short four-phase fit with ``rasterizer="pallas_stream"`` and the
compacted copy stream against the port's ``pallas_train`` fit (held to
JAX by tests/test_torch_train.py), one training step against JAX's
``make_train_step(rasterizer="pallas_stream")``, the fitter's reaction to
overflow on ``copy_budget_factor`` against JAX's, and
``gsvc_tpu_torch.cli.stream`` on the CPU.  Tolerances:

* losses of the two port fits rtol 1e-5: their composites run the same
  forward and backward loops (tests/test_torch_stream.py holds them to
  rtol 1e-5 / atol 1e-6), and no copy exceeds the budget;
* the step against JAX: the loss rtol 1e-5, the window counts exactly,
  the screen-gradient norms rtol 2e-3 / atol 2e-4 x the pixel-to-NDC
  scale, as tests/test_torch_step.py holds the mirror step;
* the CLI's stream files byte for byte, its decoded PSNR within 1e-2 dB
  of the bidirectional composite's evaluation (both render the same
  decoded state; their frames agree to 2 T_EPS).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.config import OptimizationConfig as JaxOpt
from gsvc_tpu.framecube import FrameCubeDataset as JaxDataset
from gsvc_tpu.models.gaussians import GenerateMode as JMode
from gsvc_tpu.train.fit import GOPFitter as JaxFitter
from gsvc_tpu.train.optim import adam_init as jax_adam_init
from gsvc_tpu.train.schedules import build_schedules as jax_schedules
from gsvc_tpu.train.trainer import (
    init_stats as jax_init_stats, make_train_step as jax_train_step,
)
from gsvc_tpu_torch.config import OptimizationConfig
from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
from gsvc_tpu_torch.models.gaussians import GenerateMode
from gsvc_tpu_torch.render.splat import RasterSettings
from gsvc_tpu_torch.train.fit import GOPFitter
from gsvc_tpu_torch.train.optim import adam_init
from gsvc_tpu_torch.train.schedules import build_schedules
from gsvc_tpu_torch.train.trainer import init_stats, make_step_body
from tests.test_batched import GEOM, WINDOW_CAP, Z1, Z2, settings_for, \
    tiny_model
from tests.test_torch_step import OPT, _inputs, _payload, _port_cfg
from tests.test_torch_train import FOUR_PHASES, _cli_inputs, _configs, \
    _video_u8

STREAM = {"rasterizer": "pallas_stream", "copy_budget_factor": 8}


def _fit(rasterizer_set: dict, frames):
    _, pcfg = _configs()
    for k, v in FOUR_PHASES.items():
        setattr(pcfg.optimization, k, v)
    for k, v in rasterizer_set.items():
        setattr(pcfg.pipeline, k, v)
    fitter = GOPFitter(pcfg, FrameCubeDataset(images=frames), seed=0,
                       device="cpu")
    return fitter, fitter.fit(log_every=1)


def test_stream_fit_matches_pallas_train_fit():
    """Twelve iterations through the four phases with three densify
    epochs: the stream composite over the compacted copy stream gives the
    losses, bits and anchor counts of the mirror composite's fit."""
    frames = _video_u8()
    fs, rs = _fit(STREAM, frames)
    fm, rm = _fit({"rasterizer": "pallas_train"}, frames)
    # both fitters grew the same capacities on the same overflow (the
    # budget with them: 8 -> 16)
    assert fs.rasterizer == "pallas_stream"
    assert dataclasses.replace(fs.settings, copy_budget_factor=0) == \
        fm.settings and fs.settings.copy_budget_factor >= 8
    np.testing.assert_allclose([h["loss"] for h in rs.history],
                               [h["loss"] for h in rm.history], rtol=1e-5)
    np.testing.assert_allclose([h["bpp"] for h in rs.history],
                               [h["bpp"] for h in rm.history], rtol=1e-5)
    counts = [h["n_active"] for h in rs.history]
    assert counts == [h["n_active"] for h in rm.history]
    assert len(counts) == 12 and counts[2] > counts[1]


def test_stream_train_step_matches_jax():
    """One FULL_PRECISION step with the densification statistics through
    both packages' stream composite: loss, overflow, composited copies and
    the statistics (each view's screen gradients)."""
    jstate, jcfg = tiny_model(seed=6)
    jset = settings_for(jcfg, 48)
    jopt = JaxOpt(**OPT)
    gt, flow = _inputs()
    h, w = gt.shape[2:]
    k = jcfg.n_offsets
    step = jax_train_step(jcfg, jset, WINDOW_CAP, jopt, width=w, height=h,
                          scale=GEOM["scale"], x_min=GEOM["x_min"],
                          y_min=GEOM["y_min"], rasterizer="pallas_stream")
    lrs = {n: s(1) for n, s in jax_schedules(jopt).items()}
    st, _, jstats, jm = step(
        jax.tree.map(jnp.copy, jstate),
        jax_adam_init((jstate.anchors, jstate.nets)),
        jax_init_stats(jstate.anchors.anchor.shape[0], k), lrs, Z1, Z2,
        jnp.asarray(gt[0]) / 255.0, jnp.asarray(gt[1]) / 255.0,
        jnp.asarray(flow), None, mode=JMode.FULL_PRECISION, do_stats=True)

    from gsvc_tpu_torch.convert import state_from_numpy
    state = state_from_numpy(_payload(jstate))
    opt = OptimizationConfig(**OPT)
    body = make_step_body(_port_cfg(), RasterSettings(
        **dataclasses.asdict(jset)), WINDOW_CAP, opt, w, h, GEOM["scale"],
        GEOM["x_min"], GEOM["y_min"], rasterizer="pallas_stream")
    _, _, pstats, pm = body(
        state, adam_init((state.anchors, state.nets)),
        init_stats(state.anchors.anchor.shape[0], k),
        {n: s(1) for n, s in build_schedules(opt).items()}, Z1, Z2,
        torch.from_numpy(gt[0]), torch.from_numpy(gt[1]),
        torch.from_numpy(flow), GenerateMode.FULL_PRECISION, True)
    np.testing.assert_allclose(float(pm.loss), float(jm.loss), rtol=1e-5)
    for name in ("overflow", "num_rendered", "harmful_overflow"):
        assert int(getattr(pm, name)) == int(getattr(jm, name)), name
    for name in ("opacity_accum", "anchor_demon", "offset_denom"):
        np.testing.assert_allclose(getattr(pstats, name).numpy(),
                                   np.asarray(getattr(jstats, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(pstats.offset_gradient_accum.numpy(),
                               np.asarray(jstats.offset_gradient_accum),
                               rtol=2e-3, atol=2e-4 * GEOM["scale"])
    assert float(pstats.offset_gradient_accum.max()) > 0


def test_overflow_reaction_changes_copy_budget_as_jax():
    """Persistent harmful overflow doubles ``gaussian_cap``,
    ``tiles_per_gaussian`` and ``copy_budget_factor`` (the budget capped
    at the new tiles_per_gaussian); persistent underfill halves them back
    toward the config's values; both fitters change the same settings at
    the same calls."""
    jcfg, pcfg = _configs()
    for c in (jcfg, pcfg):
        c.pipeline.rasterizer = "pallas_stream"
        c.pipeline.copy_budget_factor = 8
        c.pipeline.overflow_autogrow = True
    frames = _video_u8()
    jf = JaxFitter(jcfg, JaxDataset(images=frames.astype(np.float32)
                                    / 255.0), seed=0)
    pf = GOPFitter(pcfg, FrameCubeDataset(images=frames), seed=0,
                   device="cpu")
    fields = ("gaussian_cap", "tiles_per_gaussian", "copy_budget_factor")

    def settings_of(f):
        return tuple(getattr(f.settings, n) for n in fields)

    calls = ([dict(overflow=50, harmful=50, num_rendered=10)] * 6
             + [dict(overflow=0, harmful=0, num_rendered=1)] * 12)
    seen = []
    for it, kw in enumerate(calls, start=1):
        got = pf._react_to_overflow(it=it, **kw)
        want = jf._react_to_overflow(it=it, **kw)
        assert got == want and settings_of(pf) == settings_of(jf), it
        seen.append(settings_of(pf))
    assert (512, 64, 16) in seen and (1024, 128, 32) in seen
    assert seen[-1][2] < 32


def test_stream_cli_on_cpu(tmp_path, monkeypatch):
    """``gsvc_tpu_torch.cli.stream.main --device cpu`` with the stream
    composite: ``stream_bitstreams/`` holds what the port's
    ``conduct_encoding(streaming=True)`` writes for the checkpoint's state
    (held byte for byte to JAX's by tests/test_torch_encode.py), JAX's
    decoder reads it, and ``stream_results.json`` has the JAX CLI's
    keys."""
    from gsvc_tpu.codec.bitstream import conduct_decoding as jax_decode
    from gsvc_tpu.utils.checkpoint import load_streams as jax_load_streams
    from gsvc_tpu_torch.cli.common import model_config_dict
    from gsvc_tpu_torch.cli.stream import main
    from gsvc_tpu_torch.codec.bitstream import (
        conduct_decoding, conduct_encoding,
    )
    from gsvc_tpu_torch.config import load_config
    from gsvc_tpu_torch.report import evaluate_video
    from gsvc_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint,
    )

    frames = _video_u8()
    src, cfg_path = _cli_inputs(tmp_path, frames)
    over = ["pipeline.rasterizer=pallas_stream",
            "pipeline.copy_budget_factor=8"]
    cfg = load_config(str(cfg_path), overrides={
        k: (v if k.endswith("rasterizer") else int(v))
        for k, v in (o.split("=") for o in over)})
    cfg.pipeline.source_path = str(src)
    fitter = GOPFitter(cfg, FrameCubeDataset(str(src)), seed=0,
                       device="cpu")
    fitter.fit(iterations=6, log_every=0)
    ckpt = tmp_path / "chkpnt6.pkl"
    save_checkpoint(str(ckpt), fitter, 6)

    monkeypatch.setenv("GSVC_RASTERIZER", "pallas_stream")
    out = tmp_path / "out"
    argv = ["--source_path", str(src), "--model_path", str(out),
            "--config_path", str(cfg_path), "--checkpoint", str(ckpt),
            "--device", "cpu"]
    for o in over:
        argv += ["--set", o]
    res = main(argv)
    assert json.loads((out / "stream_results.json").read_text()) == res
    assert set(res) == {"bpp", "size_mb", "encode_seconds",
                        "decode_seconds", "psnr", "ssim", "fps",
                        "z_slices"}
    assert res["z_slices"] >= 1 and np.isfinite(res["psnr"])
    assert "stream-decoded" in (out / "stream.log").read_text()

    # the files equal the port's streaming encode of the same state
    again = GOPFitter(cfg, FrameCubeDataset(str(src)), seed=0, device="cpu")
    load_checkpoint(str(ckpt), again)
    d = again.dataset
    streams, meta, _, enc_state, _ = conduct_encoding(
        again.state, again.gcfg, streaming=True,
        model_config=model_config_dict(cfg),
        video_info={"width": d.width, "height": d.height,
                    "num_frames": d.num_frames})
    bs = out / "stream_bitstreams"
    assert sorted(p.name for p in bs.iterdir()) == sorted(streams)
    for name, data in streams.items():
        assert (bs / name).read_bytes() == data, name
    assert res["z_slices"] == len(meta.index_splits)
    assert res["size_mb"] == sum(len(v) for v in streams.values()) / 2 ** 20

    # JAX's decoder reads the files: the same anchors as the port's decode
    from gsvc_tpu.config import ModelConfig as JaxModelConfig
    from gsvc_tpu.models.gaussians import (
        GaussianConfig as JaxGaussianConfig, init_model as jax_init_model,
        update_anchor_bound as jax_bound,
    )
    jcfg = JaxGaussianConfig.from_model_config(
        JaxModelConfig(**model_config_dict(cfg)))
    pts = np.random.default_rng(0).uniform(-0.1, 0.1, (8, 3)).astype(
        np.float32)
    template = jax_bound(jax_init_model(
        jax.random.PRNGKey(0), jcfg, pts, again.capacity, voxel_size=0.001),
        d.x_min, d.y_min, d.z_min)
    sj, jmeta, _ = jax_decode(jax_load_streams(str(bs)), jcfg, template,
                              capacity=again.capacity)
    sp, _, _ = conduct_decoding(streams, again.gcfg, enc_state,
                                capacity=again.capacity, device="cpu")
    assert jmeta.anchor_num == meta.anchor_num > 0
    for field in ("anchor", "feat", "offset", "mask", "scaling"):
        np.testing.assert_array_equal(getattr(sp.anchors, field).numpy(),
                                      np.asarray(getattr(sj.anchors, field)),
                                      err_msg=field)

    # the stream composite's decoded PSNR against the bidirectional one's
    monkeypatch.delenv("GSVC_RASTERIZER")
    ev = evaluate_video(sp, again.gcfg, again.settings, again.window_cap,
                        again.frame_zs, d.x_min, d.y_min, d.scale,
                        gt_images=d.images, mode=GenerateMode.DECODED,
                        decoded=True)
    assert abs(ev["psnr"] - res["psnr"]) < 1e-2


def test_fitter_refuses_unknown_rasterizers():
    """Every served name builds a fitter; any other raises."""
    _, pcfg = _configs()
    frames = FrameCubeDataset(images=_video_u8())
    for name in ("", "jnp", "pallas", "pallas_train", "pallas_stream"):
        pcfg.pipeline.rasterizer = name
        assert GOPFitter(pcfg, frames, seed=0, device="cpu").rasterizer \
            == name
    pcfg.pipeline.rasterizer = "pallas_v9"
    with pytest.raises(ValueError, match="unknown rasterizer"):
        GOPFitter(pcfg, frames, seed=0, device="cpu")
