"""The port's whole-video CLI surface against the JAX package's:

* the segment and sweep fan-out (``cli.train._train_segmented``,
  ``cli.sweep``) with ``main`` replaced in both packages by a recorder:
  the same segments, frame and flow names and argv (the port adds
  ``--device``), and the same summary for the same per-GOP results;
* port-only CPU runs on a 6-frame synthetic GOP with flows:
  ``cli.train --gop_size 3 --lpips_weights proxy`` (two GOP directories
  with every artifact; as in the JAX package, the segments are given
  neither ``--lpips_weights`` nor ``--set``, so the 40-step schedule is
  in the config file), ``cli.train --profile`` (a Chrome trace),
  ``cli.decode --lpips_weights proxy`` under ``GSVC_DECODE=mirror`` on
  the first GOP, and ``cli.debug_vis`` and ``viewer.ViewerServer`` (over
  HTTP on 127.0.0.1) against the JAX package's on one checkpoint (the
  first GOP's, its opacity head biased so that gaussians show): the
  flow-field PNG byte-equal, at least 99% of the scatter pixels equal
  (gaussian positions agree to float rounding, so a dot can land one
  pixel over), the viewer's PNG to 1 LSB;
* ``--gop_parallel`` and ``--mesh`` raise, naming ROADMAP A5.

``report.evaluate_video`` under both ``GSVC_DECODE`` values is held to
JAX's in tests/test_torch_tools.py.
"""

import io
import json
import os
import pathlib
import pickle
import urllib.request

import numpy as np
import pytest
from PIL import Image

from tests.test_train import synthetic_video

# ---------------------------------------------------------------------------
# Segment and sweep fan-out, main replaced by a recorder
# ---------------------------------------------------------------------------

def _recorder(calls, results, segments=True):
    """A stand-in for ``cli.train.main``: records the argv and, for
    ``segments``, the listings of the symlinked frame and flow directories
    at call time (the temporary directories by name only); returns the
    next canned result."""
    def fake_main(argv):
        argv = list(argv)
        rec = {"argv": argv}
        for flag in ("--source_path", "--optical_path"):
            if segments and flag in argv:
                d = pathlib.Path(argv[argv.index(flag) + 1])
                if d.name in ("frames", "flow"):
                    rec[flag] = sorted(p.name for p in d.iterdir())
                    assert all(p.is_symlink() for p in d.iterdir())
                    argv[argv.index(flag) + 1] = "<tmp>/" + d.name
        calls.append(rec)
        return dict(results[len(calls) - 1])
    return fake_main


PER_GOP = [{"decoded_psnr": 21.5, "bpp": 0.25, "size_mb": 0.5,
            "decoded_ms_ssim": 0.9},
           {"decoded_psnr": None, "bpp": 0.5, "size_mb": 1.0},
           {"decoded_psnr": 19.0, "bpp": None, "size_mb": 0.25}]


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    """7 frame files and 6 flow files (names only matter here)."""
    root = tmp_path_factory.mktemp("fanout")
    (root / "frames").mkdir()
    (root / "flow").mkdir()
    for i in range(7):
        (root / "frames" / f"im{i:03d}.png").write_bytes(b"x")
    for i in range(6):
        (root / "flow" / f"flow{i:03d}.pkl").write_bytes(b"x")
    return root


@pytest.mark.parametrize("extra", [
    [], ["--lmbda", "0.002", "--iterations", "7", "--config_path",
         "cfg.yaml"]], ids=["plain", "flags"])
@pytest.mark.parametrize("flows", [True, False], ids=["flows", "noflows"])
def test_segments_equal_jax(video_dir, tmp_path, monkeypatch, extra, flows):
    import gsvc_tpu.cli.train as jcli
    import gsvc_tpu_torch.cli.train as pcli

    (tmp_path / "cfg.yaml").write_text("optimization:\n  iterations: 7\n")
    monkeypatch.chdir(tmp_path)
    got = {}
    for name, mod in (("jax", jcli), ("port", pcli)):
        calls = []
        monkeypatch.setattr(mod, "main", _recorder(calls, PER_GOP))
        (tmp_path / name).mkdir()     # the segments' main would make it
        argv = ["--source_path", str(video_dir / "frames"),
                "--model_path", str(tmp_path / name), "--gop_size", "3",
                "--seed", "4", "--set", "optimization.lmbda=0.5",
                "--lpips_weights", "proxy", "--skip_codec",
                "--eval_stride", "2"] + extra
        if flows:
            argv += ["--optical_path", str(video_dir / "flow")]
        if name == "port":
            argv += ["--device", "cpu"]
        args = mod.base_parser("").parse_known_args(argv)[0]
        args.gop_size = 3
        summary = mod._train_segmented(args, mod.resolve_config(args))
        for c in calls:
            mp = c["argv"].index("--model_path") + 1
            c["argv"][mp] = pathlib.Path(c["argv"][mp]).relative_to(
                tmp_path / name).as_posix()
        got[name] = (calls, summary, json.loads(
            (tmp_path / name / "results.json").read_text()))
    (jcalls, jsum, jfile), (pcalls, psum, pfile) = got["jax"], got["port"]
    assert len(jcalls) == 3
    assert [c["--source_path"] for c in jcalls] == [
        ["im000.png", "im001.png", "im002.png"],
        ["im003.png", "im004.png", "im005.png"], ["im006.png"]]
    if flows:
        assert [c["--optical_path"] for c in jcalls] == [
            ["flow000.pkl", "flow001.pkl"], ["flow003.pkl", "flow004.pkl"],
            []]
    for jc, pc in zip(jcalls, pcalls):
        assert pc["argv"] == jc["argv"] + ["--device", "cpu"]
        assert {k: v for k, v in pc.items() if k != "argv"} == \
            {k: v for k, v in jc.items() if k != "argv"}
    assert [c["argv"][3] for c in pcalls] == [
        "gop_00000", "gop_00003", "gop_00006"]
    assert psum == jsum == pfile == jfile
    assert set(psum) == {"gops", "mean_psnr", "mean_bpp", "per_gop"}
    assert psum["gops"] == 3 and psum["mean_psnr"] == pytest.approx(40.5 / 3)


def test_sweep_equals_jax(video_dir, tmp_path, monkeypatch):
    import gsvc_tpu.cli.sweep as jsweep
    import gsvc_tpu.cli.train as jcli
    import gsvc_tpu_torch.cli.sweep as psweep
    import gsvc_tpu_torch.cli.train as pcli

    got = {}
    for name, sweep, train in (("jax", jsweep, jcli),
                               ("port", psweep, pcli)):
        calls = []
        monkeypatch.setattr(train, "main", _recorder(calls, PER_GOP, False))
        (tmp_path / name).mkdir()
        argv = ["--source_path", str(video_dir / "frames"),
                "--optical_path", str(video_dir / "flow"),
                "--model_path", str(tmp_path / name), "--config_path",
                "c.yaml", "--iterations", "9", "--seed", "2", "--lmbdas",
                "0.001", "0.0025", "0.01"]
        curve = sweep.main(argv + (["--device", "cpu"] if name == "port"
                                   else []))
        for c in calls:
            mp = c["argv"].index("--model_path") + 1
            c["argv"][mp] = pathlib.Path(c["argv"][mp]).name
        got[name] = (calls, curve, json.loads(
            (tmp_path / name / "rd_curve.json").read_text()))
    (jcalls, jcurve, jfile), (pcalls, pcurve, pfile) = got["jax"], \
        got["port"]
    assert [c["argv"] + ["--device", "cpu"] for c in jcalls] == \
        [c["argv"] for c in pcalls]
    assert [c["argv"][3] for c in pcalls] == [
        "lmbda_0.001", "lmbda_0.0025", "lmbda_0.01"]
    assert pcurve == jcurve == pfile == jfile
    assert set(pcurve[0]) == {"lmbda", "bpp", "psnr", "ms_ssim", "size_mb"}


def test_multi_gpu_options_raise(tmp_path):
    from gsvc_tpu_torch.cli.train import main

    for extra in (["--gop_size", "2", "--gop_parallel"],
                  ["--mesh", "dp=2,sp=1"]):
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            main(["--model_path", str(tmp_path), "--device", "cpu"] + extra)


# ---------------------------------------------------------------------------
# Port-only CPU runs of the CLIs, and the JAX debug renders and viewer
# ---------------------------------------------------------------------------

SMALL_YAML = """
model:
  anchor_feature_dim: 8
  n_offsets: 4
  threshold: 0.3
  time_multi_res: 4
  offset_multi_res: 4
  log2: 6
  log2_2D: 7
  grid_feature_dim: 2
  resolutions_list: [6, 10]
  resolutions_list_2D: [12, 20]
pipeline:
  tile_h: 8
  tile_w: 16
  visible_capacity: 256
  gaussian_chunk: 32
optimization:
  iterations: 40
  init_anchor_num: 300
  optical_lambda: 0.0
  full_precision_training_total: 10
  quantized_training_total: 10
  entropy_constrained_train_total: 10
  ste_entropy_constrained_train_total: 10
  start_stat: 2
  update_from: 5
  update_interval: 8
  pause_densification: 2
  min_opacity: 0
"""

ARTIFACTS = ("bitstreams", "results.json", "metrics.jsonl", "cfg_args.yaml",
             "chkpnt_final.pkl", "output.log",
             "point_cloud/final/point_cloud.ply",
             "point_cloud/final/networks.pkl")


@pytest.fixture(scope="module")
def segmented(tmp_path_factory):
    """The verify notes' 6-frame 64x48 synthetic GOP (with seeded flows)
    encoded by the port's train CLI in two GOPs of 3 frames."""
    from gsvc_tpu_torch.cli.train import main

    root = tmp_path_factory.mktemp("surface")
    for sub in ("frames", "flow", "gop0_frames"):
        (root / sub).mkdir()
    for i, fr in enumerate(synthetic_video(t=6, h=48, w=64)):
        Image.fromarray((fr * 255).astype(np.uint8)).save(
            root / "frames" / f"f_{i:03d}.png")
        if i < 3:
            os.symlink(root / "frames" / f"f_{i:03d}.png",
                       root / "gop0_frames" / f"f_{i:03d}.png")
    rng = np.random.default_rng(0)
    for i in range(5):
        with open(root / "flow" / f"flow_{i:03d}.pkl", "wb") as f:
            pickle.dump(rng.normal(0, 2, (2, 48, 64)).astype(np.float32), f)
    (root / "small.yaml").write_text(SMALL_YAML)
    summary = main(["--source_path", str(root / "frames"), "--optical_path",
                    str(root / "flow"), "--model_path", str(root / "out"),
                    "--config_path", str(root / "small.yaml"), "--device",
                    "cpu", "--gop_size", "3", "--lpips_weights", "proxy"])
    return root, summary


def test_segmented_encode_writes_every_artifact(segmented):
    from gsvc_tpu_torch.utils.checkpoint import read_checkpoint
    from gsvc_tpu_torch.utils.ply import load_gaussian_ply

    root, summary = segmented
    out = root / "out"
    assert json.loads((out / "results.json").read_text()) == summary
    assert summary["gops"] == 2 and len(summary["per_gop"]) == 2
    for start, res in zip((0, 3), summary["per_gop"]):
        gop = out / f"gop_{start:05d}"
        for name in ARTIFACTS:
            assert (gop / name).exists(), (gop, name)
        assert json.loads((gop / "results.json").read_text()) == res
        assert res["bpp"] > 0 and np.isfinite(res["decoded_psnr"])
        # as in the JAX package, --lpips_weights is not passed on
        assert res["decoded_lpips"] is None and "lpips_kind" not in res
        ck = read_checkpoint(str(gop / "chkpnt_final.pkl"))
        n = int(ck["n_active"])
        ply = load_gaussian_ply(str(gop / "point_cloud/final/point_cloud.ply"))
        for k, v in ply.items():
            np.testing.assert_array_equal(v, ck["anchors"][k][:n], err_msg=k)
        with open(gop / "point_cloud/final/networks.pkl", "rb") as f:
            nets = pickle.load(f)
        np.testing.assert_array_equal(nets["hash_table"],
                                      ck["nets"]["hash_table"])
        other = out / f"gop_{3 - start:05d}"
        text = (gop / "output.log").read_text()
        assert str(gop / "chkpnt_final.pkl") in text
        assert str(other) not in text
    assert summary["mean_psnr"] == pytest.approx(np.mean(
        [r["decoded_psnr"] for r in summary["per_gop"]]))


def test_profile_writes_a_trace(segmented):
    from gsvc_tpu_torch.cli.train import main

    root, _ = segmented
    res = main(["--source_path", str(root / "gop0_frames"), "--model_path",
                str(root / "prof"), "--config_path", str(root / "small.yaml"),
                "--device", "cpu", "--skip_codec", "--iterations", "3",
                "--profile", str(root / "trace")])
    trace = json.loads((root / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert res["iterations"] == 3 and "aten::mul" in names


def test_mirror_decode_with_lpips(segmented, monkeypatch):
    from gsvc_tpu_torch.cli.decode import main

    root, summary = segmented
    monkeypatch.setenv("GSVC_DECODE", "mirror")
    ev = main(["--bitstream_path", str(root / "out/gop_00000/bitstreams"),
               "--model_path", str(root / "dec"), "--source_path",
               str(root / "gop0_frames"), "--lpips_weights", "proxy",
               "--device", "cpu"])
    assert ev["num_frames"] == 3
    assert abs(ev["psnr"] - summary["per_gop"][0]["decoded_psnr"]) < 0.01
    assert 0 <= ev["lpips"] < 1
    assert json.loads((root / "dec/decode_results.json").read_text())[
        "lpips"] == ev["lpips"]
    assert "decode eval" in (root / "dec/decode.log").read_text()


@pytest.fixture(scope="module")
def visible_ckpt(segmented):
    """The first GOP's checkpoint with its opacity head's output bias set
    to 0.8 (as tests/test_torch_decode.py:_visible_state does): 40 steps
    of the tiny model leave almost every gaussian transparent."""
    root, _ = segmented
    with open(root / "out/gop_00000/chkpnt_final.pkl", "rb") as f:
        ck = pickle.load(f)
    b = ck["nets"]["mlp_opacity"]["out"]["b"]
    ck["nets"]["mlp_opacity"]["out"]["b"] = np.full_like(b, 0.8)
    path = root / "visible.pkl"
    with open(path, "wb") as f:
        pickle.dump(ck, f)
    return str(path)


def _pixels_equal(a, b):
    a, b = np.asarray(Image.open(a)), np.asarray(Image.open(b))
    assert a.shape == b.shape
    return float((a == b).all(axis=-1).mean())


def test_debug_vis_matches_jax(segmented, visible_ckpt):
    from gsvc_tpu.cli import debug_vis as jvis
    from gsvc_tpu_torch.cli import debug_vis as pvis

    root, _ = segmented
    argv = ["--model_path", str(root / "vis"), "--checkpoint",
            visible_ckpt, "--source_path",
            str(root / "gop0_frames"), "--optical_path", str(root / "flow"),
            "--config_path", str(root / "small.yaml"), "--frame", "0"]
    pvis.main(argv + ["--out", str(root / "vis_p"), "--device", "cpu"])
    jvis.main(argv + ["--out", str(root / "vis_j")])
    assert (root / "vis_p/flow_field_0.png").read_bytes() == \
        (root / "vis_j/flow_field_0.png").read_bytes()
    for name in ("gaussians_xy_0.png", "flow_scatter_0.png"):
        img = np.asarray(Image.open(root / "vis_p" / name))
        assert (img < 250).any(axis=-1).sum() > 200, f"{name}: few dots"
        assert _pixels_equal(root / "vis_p" / name,
                             root / "vis_j" / name) >= 0.99, name


def test_viewer_matches_jax_over_http(segmented, visible_ckpt):
    from gsvc_tpu.config import load_config as jax_load_config
    from gsvc_tpu.framecube import FrameCubeDataset as JaxDataset
    from gsvc_tpu.train.fit import GOPFitter as JaxFitter
    from gsvc_tpu.utils.checkpoint import load_checkpoint as jax_load
    from gsvc_tpu.viewer import ViewerServer as JaxViewer
    from gsvc_tpu_torch.config import load_config
    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.train.fit import GOPFitter
    from gsvc_tpu_torch.utils.checkpoint import load_checkpoint
    from gsvc_tpu_torch.viewer import ViewerServer

    root, _ = segmented
    ckpt = visible_ckpt
    frames = str(root / "gop0_frames")
    pf = GOPFitter(load_config(str(root / "small.yaml")),
                   FrameCubeDataset(frames), device="cpu")
    load_checkpoint(ckpt, pf)
    jf = JaxFitter(jax_load_config(str(root / "small.yaml")),
                   JaxDataset(frames))
    jax_load(ckpt, jf)
    geom = (pf.dataset.x_min, pf.dataset.y_min, pf.dataset.scale)
    pv = ViewerServer(pf.state, pf.gcfg, pf.settings, pf.window_cap,
                      pf.frame_zs, *geom)
    jv = JaxViewer(jf.state, jf.gcfg, jf.settings, jf.window_cap,
                   jf.frame_zs, *geom)
    httpd = pv.serve(port=0, background=True)
    port = httpd.server_address[1]
    try:
        base = f"http://127.0.0.1:{port}"
        page = urllib.request.urlopen(base + "/", timeout=60).read()
        assert b"gsvc-tpu viewer" in page and b'max="2"' in page
        info = json.loads(urllib.request.urlopen(base + "/info",
                                                 timeout=60).read())
        assert info == {"num_frames": 3}
        for idx in (0, 2):
            png = urllib.request.urlopen(f"{base}/frame/{idx}?1",
                                         timeout=60).read()
            assert png == pv.render_png(idx)
            got = np.asarray(Image.open(io.BytesIO(png)), np.int16)
            want = np.asarray(Image.open(io.BytesIO(jv.render_png(idx))),
                              np.int16)
            assert got.shape == want.shape == (48, 64, 3)
            assert np.abs(got - want).max() <= 1
            assert got.std() > 1
    finally:
        httpd.shutdown()
    assert pv.render_png(0) is pv.render_png(0)     # cached
    assert pv.render_png(99) == pv.render_png(2)    # clamped
