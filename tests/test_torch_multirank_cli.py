"""The port's multi-rank CLI on the CPU, spawning its own ranks.

On the 6-frame synthetic GOP of the verify notes, through the CLI's own
spawner (gloo ranks on the CPU) and with JAX and the JAX package blocked
in every process: ``pipeline.mesh_shape`` dp=2,sp=2 with
``--skip_codec``, resumed from a single-GPU checkpoint whose window is
wider than one slab, whose final checkpoint loads into a single-GPU
``GOPFitter`` (capacity a multiple of sp), and ``--gop_size 3
--gop_parallel`` with the codec: every ``gop_*`` file of the sequential
run and JAX's summary keys with ``"mesh"``.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_train import _configs
from tests.test_train import synthetic_video

REPO = pathlib.Path(__file__).resolve().parents[1]

_BLOCKED_CLI = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "gsvc_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
if __name__ == "__main__":
    sys.path.insert(0, sys.argv[1])
    from gsvc_tpu_torch.cli.train import main
    main(sys.argv[2:])
"""


def run_cli(tmp_path: pathlib.Path, args: list, timeout: float = 150.0):
    """``cli.train.main(args)`` in a subprocess with JAX and the JAX
    package blocked; the ranks it spawns re-import this script as their
    main module, so the block holds in them too."""
    script = tmp_path / "blocked_cli.py"
    script.write_text(_BLOCKED_CLI)
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, str(script), str(REPO), *args],
                         capture_output=True, text=True, timeout=timeout,
                         env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    return res


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """The verify notes' 6-frame 48x64 synthetic GOP as PNGs, and the
    tiny model with a six-iteration four-phase schedule (a densify epoch
    at iteration 4)."""
    root = tmp_path_factory.mktemp("video")
    src = root / "frames"
    src.mkdir()
    frames = np.round(synthetic_video(t=6, h=48, w=64) * 255).astype(
        np.uint8)
    for i, fr in enumerate(frames):
        Image.fromarray(fr).save(src / f"f_{i:03d}.png")
    _, pcfg = _configs()
    o = pcfg.optimization
    o.iterations = 6
    o.full_precision_training_total = 2
    o.quantized_training_total = 1
    o.entropy_constrained_train_total = 2
    o.ste_entropy_constrained_train_total = 1
    o.pause_densification = 1
    o.update_from = 1
    o.update_interval = 4
    o.min_opacity = 0.0
    from gsvc_tpu_torch.config import save_config
    save_config(pcfg, str(root / "small.yaml"))
    return root, frames, pcfg


def test_cli_mesh_resumes_a_single_gpu_checkpoint(video, tmp_path):
    """``pipeline.mesh_shape`` (``--set pipeline.mesh_shape=dp=2,sp=2``,
    which ``--mesh`` overrides; ``--mesh`` runs in
    tests/test_torch_train.py) with ``--skip_codec``, from a single-GPU
    checkpoint at iteration 0: four spawned ranks fit the six iterations
    (a densify epoch included); the mesh checkpoint loads into a
    single-GPU fitter, whose evaluation of frame 0 is finite.  The
    single-GPU file's window spans the whole buffer, wider than one slab:
    the mesh fitter clamps it to a slab's rows."""
    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.train.fit import GOPFitter
    from gsvc_tpu_torch.utils.checkpoint import (
        load_checkpoint, read_checkpoint, save_checkpoint,
    )

    root, frames, pcfg = video
    single = GOPFitter(pcfg, FrameCubeDataset(images=frames), seed=0,
                       device="cpu")
    single.window_cap = single.capacity
    start = tmp_path / "single0.pkl"
    save_checkpoint(str(start), single, 0)
    out = tmp_path / "out_mesh"
    run_cli(tmp_path, [
        "--source_path", str(root / "frames"), "--model_path", str(out),
        "--config_path", str(root / "small.yaml"), "--device", "cpu",
        "--skip_codec", "--set", "pipeline.mesh_shape=dp=2,sp=2",
        "--checkpoint", str(start)])
    got = json.loads((out / "results.json").read_text())
    assert got["iterations"] == 6 and np.isfinite(got["fit_psnr"])
    assert set(got) == {"fit_psnr", "iterations", "n_anchors", "device"}
    log = (out / "output.log").read_text()
    assert "dp=2 x sp=2" in log and "backend gloo" in log
    assert "densify +" in log
    assert "resumed from" in log
    for name in ("cfg_args.yaml", "metrics.jsonl", "chkpnt_final.pkl",
                 "point_cloud/final/point_cloud.ply",
                 "point_cloud/final/networks.pkl"):
        assert (out / name).exists(), name
    ck = read_checkpoint(str(out / "chkpnt_final.pkl"))
    assert ck["capacity"] % 2 == 0 and ck["n_active"] == got["n_anchors"]
    assert ck["window_cap"] <= ck["capacity"] // 2
    assert ck["anchors"]["anchor"].shape[0] == ck["capacity"]
    assert ck["adam_step"] == 6
    back = GOPFitter(pcfg, FrameCubeDataset(images=frames), seed=0,
                     device="cpu")
    assert load_checkpoint(str(out / "chkpnt_final.pkl"), back) == 6
    np.testing.assert_array_equal(back.state.anchors.feat.numpy(),
                                  ck["anchors"]["feat"])
    assert np.isfinite(back.evaluate(frames=[0])["psnr"])


def test_cli_gop_parallel_with_codec(video, tmp_path):
    """``--gop_size 3 --gop_parallel``: two spawned ranks, one GOP each;
    each ``gop_*`` holds what the sequential run writes there, and the
    summary JAX's keys with ``"gops": 2`` and the mesh."""
    root, _, _ = video
    out = tmp_path / "out_gop"
    run_cli(tmp_path, [
        "--source_path", str(root / "frames"), "--model_path", str(out),
        "--config_path", str(root / "small.yaml"), "--device", "cpu",
        "--gop_size", "3", "--gop_parallel"])
    summary = json.loads((out / "results.json").read_text())
    assert set(summary) == {"gops", "mesh", "mean_psnr", "mean_bpp",
                            "per_gop"}
    assert summary["gops"] == 2 and summary["mesh"] == {"dp": 2, "sp": 1}
    for g, start in enumerate((0, 3)):
        d = out / f"gop_{start:05d}"
        for name in ("bitstreams", "results.json", "metrics.jsonl",
                     "cfg_args.yaml", "chkpnt_final.pkl", "output.log",
                     "point_cloud/final/point_cloud.ply",
                     "point_cloud/final/networks.pkl"):
            assert (d / name).exists(), f"{d.name}/{name}"
        res = json.loads((d / "results.json").read_text())
        assert res == summary["per_gop"][g]
        assert res["bpp"] > 0 and np.isfinite(res["decoded_psnr"])
        assert res["iterations"] == 6
    assert summary["per_gop"][0]["n_anchors"] != \
        summary["per_gop"][1]["n_anchors"] or \
        summary["per_gop"][0]["decoded_psnr"] != \
        summary["per_gop"][1]["decoded_psnr"]
