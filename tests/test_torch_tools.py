"""The port's host tools and test oracles against the JAX package's on
the same seeded inputs:

* ``utils/ply.py``: the same arrays give the same file bytes, and the
  file reads back to the arrays;
* ``GOPFitter.save_snapshot`` on one carried-over state (both called
  unbound on a namespace holding only the state): byte-equal
  ``point_cloud.ply`` and ``networks.pkl`` dicts with the same keys and
  equal arrays;
* ``utils/flow_viz.flow_to_image`` and ``utils/inspector.check_tensor``:
  exactly equal output (numpy on both sides);
* ``utils/logging``: ``MetricsWriter`` lines and ``dump_config``'s YAML;
* the splat oracles ``composite_tiles`` (JAX: ``composite_tiles_jnp``),
  ``rasterize`` and ``rasterize_dense_reference`` at rtol 1e-5 / atol
  1e-6: the same float32 arithmetic, the in-chunk transmittance taken as
  a running product here and an associative scan there;
* ``report.evaluate_video`` under ``GSVC_DECODE=mirror`` and ``bidir``
  with proxy LPIPS, on one tiny state decoded in both packages from the
  same streams: frames equal JAX's (``rasterizer="jnp"`` on the CPU, the
  two views averaged) to 1e-5 through the mirror composite's plain
  version (as tests/test_torch_mirror.py) and to 2 T_EPS through the
  bidirectional composite's (as tests/test_torch_decode.py), and the
  metrics to what those bounds allow; unknown values raise.
"""

import dataclasses
import json
import os
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.codec.bitstream import (
    conduct_decoding as jax_decode, conduct_encoding as jax_encode,
)
from gsvc_tpu.models.gaussians import GenerateMode as JMode
from gsvc_tpu.render import splat as jsplat
from gsvc_tpu.render.pipeline import make_raster_settings as jax_settings
from gsvc_tpu.train.fit import GOPFitter as JaxFitter
from gsvc_tpu.utils import flow_viz as jflow, inspector as jinsp, ply as jply
from gsvc_tpu_torch.codec.bitstream import conduct_decoding
from gsvc_tpu_torch.config import ModelConfig
from gsvc_tpu_torch.models.gaussians import (
    GaussianConfig, GenerateMode, decode_template,
)
from gsvc_tpu_torch.render import splat as psplat
from gsvc_tpu_torch.render.pipeline import make_raster_settings
from gsvc_tpu_torch.train.fit import GOPFitter
from gsvc_tpu_torch.utils import flow_viz as pflow, inspector as pinsp
from gsvc_tpu_torch.utils import ply as pply
from tests.test_splat import make_scene
from tests.test_torch_decode import TINY_MC, _visible_state
from tests.test_torch_encode import _port_state

RTOL, ATOL = 1e-5, 1e-6
JSET = jsplat.RasterSettings(image_height=40, image_width=56, threshold=0.15,
                             tile_h=8, tile_w=16, gaussian_cap=64, chunk=16,
                             tiles_per_gaussian=32)
PSET = psplat.RasterSettings(**dataclasses.asdict(JSET))
GEOM = (0.0, -1.0, -0.75, 28.0)


def _anchors(n=37, k=5, f=6, seed=0):
    rng = np.random.default_rng(seed)
    return {"anchor": rng.normal(size=(n, 3)).astype(np.float32),
            "feat": rng.normal(size=(n, f)).astype(np.float32),
            "offset": rng.normal(size=(n, k, 3)).astype(np.float32),
            "mask": (rng.random((n, k, 1)) < 0.7).astype(np.float32),
            "scaling": rng.normal(size=(n, 6)).astype(np.float32),
            "rotation": rng.normal(size=(n, 4)).astype(np.float32),
            "opacity": rng.normal(size=(n, 1)).astype(np.float32)}


def test_gaussian_ply_same_bytes_and_round_trip(tmp_path):
    a = _anchors()
    pply.save_gaussian_ply(str(tmp_path / "p.ply"), a)
    jply.save_gaussian_ply(str(tmp_path / "j.ply"), a)
    assert (tmp_path / "p.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    back = pply.load_gaussian_ply(str(tmp_path / "p.ply"))
    want = jply.load_gaussian_ply(str(tmp_path / "j.ply"))
    assert set(back) == set(a) == set(want)
    for k in a:
        np.testing.assert_array_equal(back[k], a[k], err_msg=k)
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    names = list(pply.read_ply(str(tmp_path / "p.ply")))
    assert names[:8] == ["x", "y", "z", "nx", "ny", "nz", "f_offset_0",
                         "f_offset_1"]
    assert names[-11:-4] == ["opacity"] + [f"scale_{i}" for i in range(6)]
    assert names[-4:] == ["rot_0", "rot_1", "rot_2", "rot_3"]


@pytest.fixture(scope="module")
def tiny_state():
    """A seeded tiny JAX state of 120 anchors in a capacity of 160."""
    return _visible_state(n=120, capacity=160, seed=5)


def test_snapshot_matches_jax(tmp_path, tiny_state):
    _, jstate = tiny_state
    pstate = _port_state(jstate)
    assert pstate.n_active < pstate.anchors.anchor.shape[0]
    JaxFitter.save_snapshot(SimpleNamespace(state=jstate), str(tmp_path / "j"))
    GOPFitter.save_snapshot(SimpleNamespace(state=pstate), str(tmp_path / "p"))
    assert (tmp_path / "p" / "point_cloud.ply").read_bytes() == \
        (tmp_path / "j" / "point_cloud.ply").read_bytes()
    got = pply.load_gaussian_ply(str(tmp_path / "p" / "point_cloud.ply"))
    for k, v in got.items():
        np.testing.assert_array_equal(
            v, getattr(pstate.anchors, k)[:pstate.n_active].numpy())
    with open(tmp_path / "p" / "networks.pkl", "rb") as f:
        nets_p = pickle.load(f)
    with open(tmp_path / "j" / "networks.pkl", "rb") as f:
        nets_j = pickle.load(f)
    leaves_p = jax.tree_util.tree_leaves_with_path(nets_p)
    leaves_j = jax.tree_util.tree_leaves_with_path(nets_j)
    assert [p for p, _ in leaves_p] == [p for p, _ in leaves_j]
    for (path, a), (_, b) in zip(leaves_p, leaves_j):
        assert type(a) is np.ndarray and a.dtype == np.float32, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("max_flow", [None, 3.0])
def test_flow_to_image_equals_jax(max_flow):
    rng = np.random.default_rng(2)
    u = rng.normal(0, 2, (23, 31)).astype(np.float32)
    v = rng.normal(0, 2, (23, 31)).astype(np.float32)
    got = pflow.flow_to_image(u, v, max_flow)
    assert got.dtype == np.uint8 and got.shape == (23, 31, 3)
    np.testing.assert_array_equal(got, jflow.flow_to_image(u, v, max_flow))
    np.testing.assert_array_equal(pflow._color_wheel(), jflow._color_wheel())


def test_check_tensor_prints_jax_line(capsys):
    rng = np.random.default_rng(3)
    a = rng.normal(size=(4, 5)).astype(np.float32)
    a[1, 2] = np.nan
    ints = np.arange(12, dtype=np.int32).reshape(3, 4)
    for x in (a, ints):
        want = jinsp.check_tensor(jnp.asarray(x), "x")
        assert pinsp.check_tensor(torch.from_numpy(x), "x") == want
        assert pinsp.check_tensor(x, "x") == want
    some_name = torch.from_numpy(a)
    msg = pinsp.check_tensor(some_name)
    assert msg.startswith("some_name: shape=(4, 5) dtype=float32")
    assert msg.endswith("nan=1") and msg in capsys.readouterr().out


def test_metrics_writer_and_dump_config(tmp_path):
    from gsvc_tpu.config import load_config as jax_load_config
    from gsvc_tpu.utils.logging import MetricsWriter as JaxWriter
    from gsvc_tpu_torch.config import Config, load_config
    from gsvc_tpu_torch.utils.logging import MetricsWriter, dump_config

    for cls, sub in ((MetricsWriter, "p"), (JaxWriter, "j")):
        w = cls(str(tmp_path / sub))
        w.write(3, loss=torch.tensor(0.25), psnr=np.float32(21.5), note="x")
        w.write(4, loss=1)
        w.close()
    recs = {sub: [json.loads(line) for line in
                  (tmp_path / sub / "metrics.jsonl").read_text().splitlines()]
            for sub in ("p", "j")}
    for r in recs.values():
        for rec in r:
            rec.pop("time")
    assert recs["p"] == recs["j"] == [
        {"step": 3, "loss": 0.25, "psnr": 21.5, "note": "x"},
        {"step": 4, "loss": 1.0}]
    cfg = Config()
    cfg.optimization.iterations = 17
    dump_config(cfg, str(tmp_path / "c"))
    path = str(tmp_path / "c" / "cfg_args.yaml")
    assert load_config(path) == cfg
    assert jax_load_config(path).optimization.iterations == 17


def _scene(seed, m=60):
    return [np.array(a) for a in make_scene(m=m, seed=seed)]


@pytest.mark.parametrize("seed,flip", [(0, False), (7, True)])
def test_splat_oracles_match_jax(seed, flip):
    sc = _scene(seed)
    jin = [jnp.asarray(a) for a in sc]
    pin = [torch.from_numpy(a) for a in sc]
    rj = jsplat.rasterize(*jin, *GEOM, JSET, flip=flip)
    rp = psplat.rasterize(*pin, *GEOM, PSET, flip=flip)
    assert int(rp.num_rendered) == int(rj.num_rendered) > 0
    assert int(rp.overflow) == int(rj.overflow)
    assert int(rp.harmful_overflow) == int(rj.harmful_overflow)
    for name in ("image", "transmittance", "radii"):
        np.testing.assert_allclose(getattr(rp, name).numpy(),
                                   np.asarray(getattr(rj, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    dp = psplat.rasterize_dense_reference(*pin, *GEOM, PSET, flip=flip)
    dj = jsplat.rasterize_dense_reference(*jin, *GEOM, JSET, flip=flip)
    assert dp.shape == (3, 40, 56)
    np.testing.assert_allclose(dp.numpy(), np.asarray(dj), rtol=RTOL,
                               atol=ATOL)
    # the binned path and the dense reference agree when nothing overflows
    np.testing.assert_allclose(rp.image.numpy(), dp.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_composite_tiles_matches_jax_on_two_views():
    """Two views' planes concatenated along the rows, a count at the cap
    and an empty tile: the same [V*T, 4, P] as ``composite_tiles_jnp``."""
    sc = _scene(3, m=90)
    proj = psplat.project_gaussians(
        *(torch.from_numpy(sc[i]) for i in (0, 3, 4, 5)), *GEOM, PSET)
    lists, counts, _, _, _ = psplat._bin_gaussians(proj, PSET)
    planes = psplat.gather_tile_planes(proj, torch.from_numpy(sc[2]),
                                       torch.from_numpy(sc[1]), lists)
    planes = tuple(torch.cat([p, p.flip(0)]) for p in planes)
    counts = torch.cat([counts, counts.flip(0)])
    counts[0], counts[1] = 0, PSET.gaussian_cap
    got = psplat.composite_tiles(PSET, planes, counts)
    want = jsplat.composite_tiles_jnp(
        JSET, tuple(jnp.asarray(p.numpy()) for p in planes),
        jnp.asarray(counts.numpy()))
    assert got.shape == (2 * PSET.n_tiles, 4, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_composite_tiles_is_differentiable():
    sc = _scene(5)
    color = torch.from_numpy(sc[1]).requires_grad_(True)
    out = psplat.rasterize(torch.from_numpy(sc[0]), color,
                           *(torch.from_numpy(sc[i]) for i in (2, 3, 4, 5)),
                           *GEOM, PSET)
    out.image.sum().backward()
    assert color.grad is not None and color.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# evaluate_video and GSVC_DECODE
# ---------------------------------------------------------------------------

KW = dict(tile_h=8, tile_w=16, gaussian_cap=64, chunk=16,
          tiles_per_gaussian=32)
EGEOM = (-1.0, -0.75, 24.0)
ZS = np.array([-0.05, 0.0, 0.1], np.float32)


@pytest.fixture(scope="module")
def decoded(tiny_state):
    """One tiny state decoded in both packages from the same streams,
    seeded ground-truth frames [3, 40, 48, 3], and JAX's frames and
    ``evaluate_video`` with proxy LPIPS.  On the CPU the JAX package
    renders both ``GSVC_DECODE`` values the same way (its jnp compositor,
    the two views averaged), so one JAX evaluation serves both."""
    from gsvc_tpu import report as jreport
    from gsvc_tpu.metrics.lpips import proxy_lpips_weights as jax_proxy

    cfg_j, state = tiny_state
    streams, _, _, enc, _ = jax_encode(state, cfg_j)
    sj, _, _ = jax_decode(streams, cfg_j, enc, capacity=160)
    cfg_p = GaussianConfig.from_model_config(ModelConfig(**TINY_MC))
    sp, _, _ = conduct_decoding(streams, cfg_p,
                                decode_template(cfg_p, -0.6, -0.6, -0.6),
                                capacity=160, device="cpu")
    gt = np.random.default_rng(8).uniform(0, 1, (3, 40, 48, 3)).astype(
        np.float32)
    js = jax_settings(cfg_j, 40, 48, **KW)
    env = os.environ.pop("GSVC_RASTERIZER", None)
    try:
        jr, _ = jreport._make_eval_render(cfg_j, js, 160, *EGEOM,
                                          JMode.DECODED, True)
        imgs = [np.asarray(jr(sj, jnp.float32(z))) for z in ZS]
        ej = jreport.evaluate_video(sj, cfg_j, js, 160, ZS, *EGEOM,
                                    gt_images=gt, mode=JMode.DECODED,
                                    decoded=True, lpips_weights=jax_proxy())
    finally:
        if env is not None:
            os.environ["GSVC_RASTERIZER"] = env
    return cfg_p, sp, gt, imgs, ej


@pytest.mark.parametrize("kind,atol", [("mirror", 1e-5),
                                       ("bidir", 2 * jsplat.T_EPS)])
def test_evaluate_video_matches_jax(decoded, kind, atol, monkeypatch):
    from gsvc_tpu_torch import report
    from gsvc_tpu_torch.metrics.lpips import proxy_lpips_weights

    cfg_p, sp, gt, imgs, ej = decoded
    monkeypatch.delenv("GSVC_RASTERIZER", raising=False)
    monkeypatch.setenv("GSVC_DECODE", kind)
    ps = make_raster_settings(cfg_p, 40, 48, **KW)
    pr = report._make_eval_render(cfg_p, ps, 160, *EGEOM,
                                  GenerateMode.DECODED, True)
    for z, want in zip(ZS, imgs):
        assert float(np.abs(want).max()) > 0.05
        np.testing.assert_allclose(pr(sp, float(z)).numpy(), want, rtol=0,
                                   atol=atol)
    ep = report.evaluate_video(sp, cfg_p, ps, 160, ZS, *EGEOM, gt_images=gt,
                               lpips_weights=proxy_lpips_weights())
    assert set(ej) <= set(ep) and ep["num_frames"] == 3
    # PSNR moves by at most 20 log10(e) |d img| / rms error (< 0.01 dB at
    # 2 T_EPS); SSIM and LPIPS are smooth in the image
    rel = 1e-5 if kind == "mirror" else 1e-3
    np.testing.assert_allclose(ep["per_frame_psnr"], ej["per_frame_psnr"],
                               rtol=rel)
    for key in ("psnr", "ssim", "lpips"):
        np.testing.assert_allclose(ep[key], ej[key], rtol=rel, err_msg=key)
    assert 0 < ep["lpips"] < 1


def test_unknown_decode_kind_raises(decoded, monkeypatch):
    from gsvc_tpu_torch import report

    cfg_p, sp = decoded[:2]
    monkeypatch.setenv("GSVC_DECODE", "bidirectional")
    with pytest.raises(ValueError, match="GSVC_DECODE"):
        report.evaluate_video(sp, cfg_p, make_raster_settings(
            cfg_p, 40, 48, **KW), 160, ZS, *EGEOM)
