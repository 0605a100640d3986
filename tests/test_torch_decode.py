"""The port's decoder against the JAX package's.

* The committed 1080p fixture (artifacts/rd_r5/realtex_0.004) decodes in
  both packages to arrays that are exactly equal: anchors, features,
  scalings, offsets, masks, the hash table and every MLP leaf.
* A tiny seeded model encoded by the JAX package decodes identically in
  both, flat and streaming, and one frame rendered from each decode
  through ``render_frame_bidir`` (JAX: the Pallas kernel in interpret
  mode; port: the plain version) agrees to 2 T_EPS — the bound both
  compositors' early exits keep.
* The port's CLI decodes and renders a bitstream on the CPU.
* Isolation: the port decodes the fixture with ``jax`` and ``gsvc_tpu``
  blocked from import, and its unpickler refuses unlisted globals.
"""

import ast
import dataclasses
import json
import pathlib
import pickle
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.codec.bitstream import (
    conduct_decoding as jax_decode, conduct_encoding,
)
from gsvc_tpu.config import ModelConfig as JaxModelConfig
from gsvc_tpu.framecube import frame_geometry as jax_frame_geometry
from gsvc_tpu.models.gaussians import (
    GaussianConfig as JaxGaussianConfig, GenerateMode as JMode, init_model,
    update_anchor_bound,
)
from gsvc_tpu.render.batched import render_frame_bidir as jax_render
from gsvc_tpu.render.pipeline import make_raster_settings as jax_settings
from gsvc_tpu.utils.checkpoint import load_streams as jax_load_streams
from gsvc_tpu.utils.checkpoint import save_streams
from gsvc_tpu_torch.codec.bitstream import (
    EncodeMeta, conduct_decoding, load_streams, read_meta,
)
from gsvc_tpu_torch.codec.param_codec import flatten_with_keys
from gsvc_tpu_torch.codec.unpickle import restricted_loads
from gsvc_tpu_torch.config import ModelConfig
from gsvc_tpu_torch.models.gaussians import (
    MLP_FIELDS, GaussianConfig, decode_template,
)
from gsvc_tpu_torch.render.batched import render_frame_bidir
from gsvc_tpu_torch.render.pipeline import make_raster_settings
from gsvc_tpu_torch.render.splat import T_EPS
from tests.test_bitstream import _randomize_state
from tests.test_model import make_state

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "artifacts" / "rd_r5" / "realtex_0.004" / "bitstreams"
ANCHOR_FIELDS = ("anchor", "feat", "scaling", "offset", "mask")


def _flat_mlps(nets, to_np):
    return {k: to_np(v) for f in MLP_FIELDS
            for k, v in flatten_with_keys(f, getattr(nets, f))}


def _jax_flat_mlps(nets):
    out = {}
    for f in MLP_FIELDS:
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                getattr(nets, f))[0]:
            out[f + "".join(str(p) for p in path)] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def fixture_decodes():
    """(JAX decoded state, port decoded state) of the 1080p fixture."""
    streams = jax_load_streams(str(FIXTURE))
    meta = pickle.loads(zlib.decompress(streams["meta.bin"]))
    cap = max(meta.anchor_num, 8)
    w, h, t = (meta.video_info[k] for k in ("width", "height", "num_frames"))
    scale, x0, y0, z0 = jax_frame_geometry(w, h, t)

    cfg_j = JaxGaussianConfig.from_model_config(
        JaxModelConfig(**meta.model_config))
    pts = np.random.default_rng(0).uniform(
        -0.1, 0.1, (min(64, cap), 3)).astype(np.float32)
    tmpl = update_anchor_bound(
        init_model(jax.random.PRNGKey(0), cfg_j, pts, cap), x0, y0, z0)
    sj, _, _ = jax_decode(streams, cfg_j, tmpl, capacity=cap)

    pstreams = load_streams(str(FIXTURE))
    cfg_p = GaussianConfig.from_model_config(
        ModelConfig(**read_meta(pstreams).model_config))
    sp, meta_p, _ = conduct_decoding(pstreams, cfg_p,
                                     decode_template(cfg_p, x0, y0, z0),
                                     capacity=cap, device="cpu")
    return sj, sp, meta_p


@pytest.mark.parametrize("field", ANCHOR_FIELDS)
def test_fixture_anchor_arrays_exactly_equal(fixture_decodes, field):
    sj, sp, meta = fixture_decodes
    assert meta.anchor_num == 30_224
    got = getattr(sp.anchors, field).numpy()
    want = np.asarray(getattr(sj.anchors, field))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_fixture_hash_and_mlps_exactly_equal(fixture_decodes):
    sj, sp, _ = fixture_decodes
    assert np.array_equal(sp.nets.hash_table.numpy(),
                          np.asarray(sj.nets.hash_table))
    got = _flat_mlps(sp.nets, lambda t: t.numpy())
    want = _jax_flat_mlps(sj.nets)
    assert set(got) == set(want) and len(got) == 78
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert int(sj.n_active) == sp.n_active
    assert np.array_equal(sp.x_bound_min.numpy(), np.asarray(sj.x_bound_min))


# ---------------------------------------------------------------------------
# A tiny model encoded by the JAX package
# ---------------------------------------------------------------------------

TINY_MC = dict(anchor_feature_dim=8, n_offsets=4, threshold=0.15,
               time_multi_res=4, offset_multi_res=4, log2=6, log2_2D=7,
               grid_feature_dim=2, resolutions_list=(6, 10),
               resolutions_list_2D=(12, 20))


def _visible_state(n, capacity, seed):
    """A seeded tiny JAX state with random attributes whose opacity head
    is biased positive (the random init leaves every tanh opacity <= 0,
    which would render nothing)."""
    cfg_j, state = make_state(n=n, capacity=capacity, seed=seed)
    state = _randomize_state(state, seed=seed)
    op = dict(state.nets.mlp_opacity)
    op["out"] = {"w": op["out"]["w"],
                 "b": jnp.full_like(op["out"]["b"], 0.8)}
    return cfg_j, state._replace(nets=state.nets._replace(mlp_opacity=op))


@pytest.fixture(scope="module", params=[False, True],
                ids=["flat", "streaming"])
def tiny_decodes(request):
    cfg_j, state = _visible_state(n=120, capacity=160, seed=5)
    streams, _, _, enc, _ = conduct_encoding(state, cfg_j,
                                             streaming=request.param)
    sj, _, _ = jax_decode(streams, cfg_j, enc, capacity=160)
    cfg_p = GaussianConfig.from_model_config(ModelConfig(**TINY_MC))
    sp, _, _ = conduct_decoding(streams, cfg_p,
                                decode_template(cfg_p, -0.6, -0.6, -0.6),
                                capacity=160, device="cpu")
    return cfg_j, sj, cfg_p, sp


def test_tiny_encode_decodes_identically(tiny_decodes):
    _, sj, _, sp = tiny_decodes
    for field in ANCHOR_FIELDS:
        assert np.array_equal(getattr(sp.anchors, field).numpy(),
                              np.asarray(getattr(sj.anchors, field))), field
    assert np.array_equal(sp.nets.hash_table.numpy(),
                          np.asarray(sj.nets.hash_table))
    want = _jax_flat_mlps(sj.nets)
    got = _flat_mlps(sp.nets, lambda t: t.numpy())
    assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("frame_z", [0.0, 0.1])
def test_tiny_decoded_frame_matches_jax_kernel(tiny_decodes, frame_z):
    cfg_j, sj, cfg_p, sp = tiny_decodes
    kw = dict(tile_h=8, tile_w=16, gaussian_cap=64, chunk=16,
              tiles_per_gaussian=32)
    img_j, tau_j, aux = jax_render(
        sj, cfg_j, jnp.float32(frame_z), -1.0, -0.75, 24.0,
        jax_settings(cfg_j, 40, 48, **kw), 160, mode=JMode.DECODED,
        rasterizer="pallas", decoded=True)
    img_p, tau_p, fs = render_frame_bidir(
        sp, cfg_p, frame_z, -1.0, -0.75, 24.0,
        make_raster_settings(cfg_p, 40, 48, **kw), 160)
    assert int(fs.num_rendered) == int(aux[5]) > 0
    np.testing.assert_allclose(img_p.numpy(), np.asarray(img_j),
                               atol=2 * T_EPS, rtol=0)
    np.testing.assert_allclose(tau_p.numpy(), np.asarray(tau_j),
                               atol=2 * T_EPS, rtol=0)


def test_cli_decodes_on_cpu(tmp_path):
    """JAX-encoded bitstream with self-contained decode info -> the
    port's CLI on the CPU: results JSON and dumped frames under
    --model_path only."""
    from gsvc_tpu_torch.cli.decode import main

    cfg_j, state = _visible_state(n=80, capacity=96, seed=2)
    video = {"width": 128, "height": 32, "num_frames": 3}
    streams, _, _, _, _ = conduct_encoding(
        state, cfg_j, model_config=dataclasses.asdict(
            JaxModelConfig(**TINY_MC)), video_info=video)
    save_streams(str(tmp_path / "bits"), streams)
    out = tmp_path / "out"
    ev = main(["--bitstream_path", str(tmp_path / "bits"), "--model_path",
               str(out), "--dump_frames", "--device", "cpu"])
    assert ev["num_frames"] == 3 and ev["device"] == "cpu"
    res = json.loads((out / "decode_results.json").read_text())
    assert res["fps"] > 0
    frames = sorted((out / "frames").iterdir())
    assert [f.name for f in frames] == [f"frame_{i:05d}.png"
                                        for i in range(3)]


def test_entry_point_refuses_missing_card(monkeypatch):
    from gsvc_tpu_torch.cli.decode import decode_bitstream

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_bitstream(str(FIXTURE))


# ---------------------------------------------------------------------------
# Isolation from JAX and the JAX package
# ---------------------------------------------------------------------------

_BLOCKED_RUN = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "gsvc_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import importlib, pkgutil
import gsvc_tpu_torch
for mod in pkgutil.walk_packages(gsvc_tpu_torch.__path__, "gsvc_tpu_torch."):
    importlib.import_module(mod.name)      # every module of the port
from gsvc_tpu_torch.cli.decode import decode_bitstream
from gsvc_tpu_torch.render.batched import frame_splats
dec = decode_bitstream(sys.argv[2], device="cpu")
fs = frame_splats(dec.state, dec.cfg, float(dec.frame_zs[300]), dec.x_min,
                  dec.y_min, dec.scale, dec.settings, dec.window_cap)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "gsvc_tpu"))
print(dec.meta.anchor_num, int(fs.num_rendered), len(bad))
"""


def test_port_decodes_with_jax_blocked():
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(REPO), str(FIXTURE)],
        capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "HOME": str(REPO)})
    assert res.returncode == 0, res.stderr[-3000:]
    anchors, rendered, n_bad = map(int, res.stdout.split())
    assert anchors == 30_224 and rendered > 0 and n_bad == 0


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("target", ["chip_smoke.py", "gsvc_tpu_torch"])
def test_sources_import_no_jax(target):
    path = REPO / target
    files = [path] if path.is_file() else sorted(path.rglob("*.py"))
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "gsvc_tpu"), (f, mod)


@pytest.mark.parametrize("payload", ["os_system", "collections"])
def test_unpickler_refuses_unlisted_globals(payload):
    import collections
    import os

    obj = os.system if payload == "os_system" else collections.OrderedDict()
    with pytest.raises(pickle.UnpicklingError):
        restricted_loads(pickle.dumps(obj))


def test_unpickler_maps_jax_meta_class():
    meta = restricted_loads(zlib.decompress(
        (FIXTURE / "meta.bin").read_bytes()))
    assert type(meta) is EncodeMeta
    assert meta.video_info == {"width": 1920, "height": 1080,
                               "num_frames": 600}
    assert meta.anchor_interval.dtype == np.float32


@pytest.mark.parametrize("name", ["default", "cfg_20240919",
                                  "cfg_20240919_16k", "cfg_20240919_8k",
                                  "cfg_20240919_ft"])
def test_config_yaml_overlay_matches(name):
    from gsvc_tpu.config import load_config as jax_load_config
    from gsvc_tpu_torch.config import load_config

    path = str(REPO / "cfgs" / f"{name}.yaml")
    assert dataclasses.asdict(load_config(path)) == dataclasses.asdict(
        jax_load_config(path))


def test_build_compiles_into_its_own_directory(tmp_path, monkeypatch):
    """``build.build`` compiles every native library (here the codec
    alone: the CPU has no nvcc) into the build directory, content-
    addressed, and a second call finds it built."""
    from gsvc_tpu_torch import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(build, "KERNELS", ())
    logs = build.build()
    assert set(logs) == {"gsvc_codec"}
    built = sorted(p.name for p in (tmp_path / "b").iterdir())
    assert len(built) == 1 and built[0].startswith("libgsvc_codec-")
    assert build.build() == {"gsvc_codec": ""}
