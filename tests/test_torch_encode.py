"""The port's encode half of the codec against the JAX package's on the
same carried-over states: ``conduct_encoding`` (flat and streaming) gives
byte-identical stream files (``meta.bin`` and ``mlp.pkl`` included), the
streams the port writes decode in both packages, and the pieces it is
built from — the host codec's encode entries, canonical Huffman, the MLP
quantizer, the hash-table coder and the anchor quantizer — equal JAX's;
then the train CLI's post-fit codec block against JAX's ``_codec_eval``.

Everything here is integer or host-numpy float64 work with one
float32-exact rule, so the comparisons are exact; only the decoded
evaluation's PSNR, rendered by JAX's jnp compositor and the port's
kernels' plain versions, is held to 1e-3 dB.
"""

import dataclasses
import pickle
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.codec import native as jax_native
from gsvc_tpu.codec.bitstream import (
    conduct_decoding as jax_decode, conduct_encoding as jax_encode,
)
from gsvc_tpu.codec.hashctx import encode_hash_table as jax_hash_encode
from gsvc_tpu.codec.huffman import (
    build_canonical_code as jax_canonical, huffman_encode as jax_huffman,
)
from gsvc_tpu.codec.param_codec import encode_mlp_params as jax_mlp_encode
from gsvc_tpu.config import ModelConfig as JaxModelConfig
from gsvc_tpu.ops.quant import quantize_anchor_indices as jax_qai
from gsvc_tpu.utils.checkpoint import load_streams as jax_load_streams
from gsvc_tpu_torch.codec import native
from gsvc_tpu_torch.codec.bitstream import (
    conduct_decoding, conduct_encoding, read_meta,
)
from gsvc_tpu_torch.codec.hashctx import decode_hash_table, encode_hash_table
from gsvc_tpu_torch.codec.huffman import (
    build_canonical_code, huffman_decode, huffman_encode,
)
from gsvc_tpu_torch.codec.param_codec import (
    encode_mlp_params, flatten_with_keys,
)
from gsvc_tpu_torch.config import ModelConfig
from gsvc_tpu_torch.convert import state_from_numpy
from gsvc_tpu_torch.models.gaussians import MLP_FIELDS, GaussianConfig
from gsvc_tpu_torch.ops.quant import quantize_anchor_indices
from gsvc_tpu_torch.utils.checkpoint import save_streams
from tests.test_torch_decode import TINY_MC, _visible_state

VIDEO = {"width": 40, "height": 24, "num_frames": 4}


def _port_state(jstate):
    return state_from_numpy({
        "anchors": {k: np.asarray(v)
                    for k, v in jstate.anchors._asdict().items()},
        "nets": jax.tree.map(np.asarray, jstate.nets._asdict()),
        "n_active": int(jstate.n_active),
        "x_bound_min": np.asarray(jstate.x_bound_min),
        "x_bound_max": np.asarray(jstate.x_bound_max)})


@pytest.fixture(scope="module")
def states():
    """A seeded tiny JAX state of 1,200 anchors (two flat batches, many z
    slices) and its carried-over port copy."""
    cfg_j, jstate = _visible_state(n=1200, capacity=1280, seed=3)
    cfg_p = GaussianConfig.from_model_config(ModelConfig(**TINY_MC))
    return cfg_j, jstate, cfg_p, _port_state(jstate)


@pytest.fixture(scope="module", params=[False, True],
                ids=["flat", "streaming"])
def encoded(request, states):
    cfg_j, jstate, cfg_p, pstate = states
    jres = jax_encode(jstate, cfg_j, streaming=request.param,
                      model_config=dataclasses.asdict(
                          JaxModelConfig(**TINY_MC)), video_info=VIDEO)
    pres = conduct_encoding(pstate, cfg_p, streaming=request.param,
                            model_config=dataclasses.asdict(
                                ModelConfig(**TINY_MC)), video_info=VIDEO)
    return request.param, jres, pres


def test_stream_files_identical_to_jax(encoded):
    """Every stream file — geometry, per-batch attributes, hash, masks,
    MLPs and the pickled side info — byte for byte."""
    streaming, (js, jmeta, jbits, _, _), (ps, pmeta, pbits, _, _) = encoded
    assert sorted(ps) == sorted(js)
    assert len(js) > 8 and (len(pmeta.batch_ranges) > 2 if streaming
                            else len(pmeta.batch_ranges) == 2)
    for name in js:
        assert ps[name] == js[name], name
    assert dataclasses.asdict(pbits) == dataclasses.asdict(jbits)
    assert pbits.total_bits == jbits.total_bits > 0


def test_meta_carries_jax_class_and_plain_values(encoded):
    """``meta.bin`` names JAX's ``EncodeMeta``; unpickled by JAX's plain
    ``pickle`` it is that class with the encoder's fields; the port's
    restricted unpickler maps it to its own."""
    _, (js, jmeta, _, _, _), (ps, _, _, _, _) = encoded
    raw = zlib.decompress(ps["meta.bin"])
    assert b"gsvc_tpu.codec.bitstream" in raw
    assert b"gsvc_tpu_torch" not in raw
    got = pickle.loads(raw)
    assert type(got) is type(jmeta)
    for f in dataclasses.fields(jmeta):
        a, b = getattr(got, f.name), getattr(jmeta, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    pm = read_meta(ps)
    assert type(pm).__module__ == "gsvc_tpu_torch.codec.bitstream"
    assert pm.batch_ranges == jmeta.batch_ranges


def test_port_streams_decode_in_both_packages(encoded, states, tmp_path):
    """Streams the port writes (``save_streams``) decode in
    ``gsvc_tpu.codec.bitstream.conduct_decoding``: the decoded anchors are
    the encoder's quantized anchors and every field equals the port
    decoder's."""
    cfg_j, jstate, cfg_p, _ = states
    _, (_, _, _, jenc, _), (ps, pmeta, _, penc, _) = encoded
    total = save_streams(str(tmp_path / "bs"), ps)
    assert total == sum(len(v) for v in ps.values())
    streams = jax_load_streams(str(tmp_path / "bs"))
    sj, _, _ = jax_decode(streams, cfg_j, jenc, capacity=1280)
    sp, _, _ = conduct_decoding(streams, cfg_p, penc, capacity=1280,
                                device="cpu")
    for field in ("anchor", "feat", "offset", "mask", "scaling"):
        np.testing.assert_array_equal(getattr(sp.anchors, field).numpy(),
                                      np.asarray(getattr(sj.anchors, field)),
                                      err_msg=field)
    n = pmeta.anchor_num
    q, interval, lo = (t.numpy() for t in quantize_anchor_indices(
        *(torch.tensor(np.asarray(a)) for a in (
            jstate.anchors.anchor, jstate.x_bound_min,
            jstate.x_bound_max))))
    want = (q.astype(np.float32) * interval + lo).astype(np.float32)
    got = sp.anchors.anchor.numpy()[:n]
    assert sorted(map(tuple, got)) == sorted(
        map(tuple, want[:int(jstate.n_active)][
            np.asarray(_mask_anchor(jstate))[:int(jstate.n_active)]]))
    np.testing.assert_array_equal(
        sp.nets.hash_table.numpy(),
        np.where(np.asarray(jstate.nets.hash_table) >= 0, 1.0, -1.0))


def _mask_anchor(jstate):
    from gsvc_tpu.models.gaussians import get_mask_anchor
    return get_mask_anchor(jstate.anchors)


def test_encoded_state_mlps_equal_jax(encoded):
    """The encoder replaces the MLPs by their quantized copies: the port's
    leaves equal JAX's bit for bit, and the rest of the state is kept."""
    _, (_, _, _, jenc, _), (_, _, _, penc, _) = encoded
    for f in MLP_FIELDS:
        for key, leaf in flatten_with_keys(f, getattr(penc.nets, f)):
            want = dict(_jax_leaves(f, getattr(jenc.nets, f)))[key]
            np.testing.assert_array_equal(leaf.numpy(), want, err_msg=key)
    np.testing.assert_array_equal(penc.nets.hash_table.numpy(),
                                  np.asarray(jenc.nets.hash_table))


def _jax_leaves(field, tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(field + "".join(str(p) for p in path), np.asarray(v))
            for path, v in leaves]


def test_encode_mlp_params_matches_jax(states):
    _, jstate, _, pstate = states
    jstream, jnets = jax_mlp_encode(jstate.nets)
    pstream, pnets = encode_mlp_params(pstate.nets)
    assert pstream == jstream
    for f in MLP_FIELDS:
        want = _jax_leaves(f, getattr(jnets, f))
        got = flatten_with_keys(f, getattr(pnets, f))
        assert [k for k, _ in got] == [k for k, _ in want]
        for (_, g), (_, w) in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), w)


def test_huffman_matches_jax():
    rng = np.random.default_rng(4)
    syms = [int(v) for v in np.round(rng.normal(128, 20, 5000)).clip(0, 255)]
    table = build_canonical_code(syms)
    assert table == jax_canonical(syms)
    data = huffman_encode(syms, table)
    assert data == jax_huffman(syms, table)
    assert huffman_decode(data, table, len(syms)) == syms
    assert build_canonical_code([7, 7]) == jax_canonical([7, 7]) == [(7, 1)]


def test_native_encoders_match_jax():
    rng = np.random.default_rng(9)
    n = 3000
    sym = rng.integers(-40, 40, n).astype(np.int32)
    mu = rng.normal(0, 10, n)
    sg = rng.uniform(0.5, 20, n)
    assert native.encode_gaussian_symbols(sym, mu, sg, -40, 40) == \
        jax_native.encode_gaussian_symbols(sym, mu, sg, -40, 40)
    bits = (rng.uniform(size=n) < 0.3).astype(np.uint8)
    p = rng.uniform(0.05, 0.95, n)
    for p1 in (0.3, p):
        assert native.encode_binary(bits, p1) == \
            jax_native.encode_binary(bits, p1)
    q = rng.integers(0, 2 ** 16, (n, 3)).astype(np.uint32)
    q[5] = q[6]                                  # a duplicate point
    assert native.encode_octree(q, 16) == jax_native.encode_octree(q, 16)
    np.testing.assert_array_equal(native.morton_sort_indices(q, 16),
                                  jax_native.morton_sort_indices(q, 16))


@pytest.mark.parametrize("rows", ["context", "global"])
def test_hash_table_encode_matches_jax(rows):
    """The context stream (a structured table) and the global-Bernoulli
    fallback (a table too small to pay the context header)."""
    rng = np.random.default_rng(2)
    sizes = [512, 1024, 2048] if rows == "context" else [2, 3]
    n = sum(sizes)
    # each channel mostly repeats the one before it: the context wins
    bits = np.zeros((n, 4), np.uint8)
    bits[:, 0] = rng.uniform(size=n) < 0.5
    for c in range(1, 4):
        bits[:, c] = bits[:, c - 1] ^ (rng.uniform(size=n) < 0.05)
    blob = encode_hash_table(bits, sizes)
    assert blob == jax_hash_encode(bits, sizes)
    assert blob[0] == (2 if rows == "context" else 1)
    np.testing.assert_array_equal(decode_hash_table(blob, sizes, 4), bits)


def test_anchor_indices_match_jax_at_cell_edges():
    """The encoder's anchor quantizer (``quantize_anchor_indices`` on CPU
    float32 tensors, each operation rounded on its own) gives JAX's eager
    integers, including anchors exactly on, and one ulp either side of,
    cell edges, the box's ends and anchors outside the box (clipped)."""
    def port(pts, lo, hi):
        return tuple(t.numpy() for t in quantize_anchor_indices(
            torch.from_numpy(pts), torch.from_numpy(lo),
            torch.from_numpy(hi)))

    lo = np.array([[-0.66, -0.5, -0.125]], np.float32)
    hi = np.array([[0.66, 0.75, 0.5]], np.float32)
    _, interval, _ = port(np.zeros((1, 3), np.float32), lo, hi)
    rng = np.random.default_rng(1)
    k = rng.integers(0, 2 ** 16, (400, 3)).astype(np.float32)
    edge = (k * interval + lo).astype(np.float32)
    pts = np.concatenate([
        edge, np.nextafter(edge, np.float32(np.inf)),
        np.nextafter(edge, np.float32(-np.inf)), lo, hi, lo - 0.1,
        hi + 0.1,
        rng.uniform(lo, hi, (400, 3)).astype(np.float32)])
    q, iv, mv = port(pts, lo, hi)
    jq, jiv, jmv = jax_qai(jnp.asarray(pts), jnp.asarray(lo),
                           jnp.asarray(hi))
    np.testing.assert_array_equal(q, np.asarray(jq))
    np.testing.assert_array_equal(iv, np.asarray(jiv))
    np.testing.assert_array_equal(mv, np.asarray(jmv))
    assert q.max() == 2 ** 16 - 1 and q.min() == 0
    assert (q[:400] == k).mean() > 0.5          # edges land in their cell


def test_codec_eval_matches_jax(tmp_path):
    """The train CLI's post-fit block on a carried-over state and a tiny
    GOP: the same result keys as JAX's ``_codec_eval``, the same bytes on
    disk, the same bpp, and the decoded PSNR within 1e-3 dB (JAX renders
    with its jnp compositor on the CPU, the port with its kernels' plain
    versions)."""
    from gsvc_tpu.cli.train import _codec_eval as jax_codec_eval
    from gsvc_tpu.config import Config as JaxConfig
    from gsvc_tpu.framecube import FrameCubeDataset as JaxDataset
    from gsvc_tpu.render.pipeline import make_raster_settings as jax_rs
    from gsvc_tpu_torch.cli.train import _codec_eval
    from gsvc_tpu_torch.config import Config
    from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
    from gsvc_tpu_torch.render.pipeline import make_raster_settings
    from tests.test_train import synthetic_video

    cfg_j, jstate = _visible_state(n=150, capacity=192, seed=6)
    cfg_p = GaussianConfig.from_model_config(ModelConfig(**TINY_MC))
    pstate = _port_state(jstate)
    frames = np.round(synthetic_video(t=4, h=24, w=40) * 255).astype(
        np.uint8)
    jd = JaxDataset(images=frames.astype(np.float32) / 255.0)
    pd = FrameCubeDataset(images=frames)
    zs = np.linspace(-0.1, 0.1, 4).astype(np.float32)
    kw = dict(tile_h=8, tile_w=16, gaussian_cap=64, chunk=16,
              tiles_per_gaussian=32)
    jres = jax_codec_eval(
        jstate, cfg_j, jax_rs(cfg_j, 24, 40, **kw), 192, 192, zs, jd,
        JaxConfig(model=JaxModelConfig(**TINY_MC)), str(tmp_path / "j"),
        None, lambda *a: None, eval_stride=2)
    pres = _codec_eval(
        pstate, cfg_p, make_raster_settings(cfg_p, 24, 40, **kw), 192, 192,
        zs, pd, Config(model=ModelConfig(**TINY_MC)), str(tmp_path / "p"),
        None, lambda *a: None, eval_stride=2)
    assert set(pres) == set(jres)
    assert pres["bpp"] == jres["bpp"] > 0
    assert pres["size_mb"] == jres["size_mb"]
    assert (pres["eval_stride"], pres["eval_frames"]) == (2, 2)
    assert abs(pres["decoded_psnr"] - jres["decoded_psnr"]) < 1e-3
    assert np.isfinite(pres["decoded_psnr"])
    for name in sorted(p.name for p in (tmp_path / "j" / "bitstreams")
                       .iterdir()):
        assert (tmp_path / "p" / "bitstreams" / name).read_bytes() == \
            (tmp_path / "j" / "bitstreams" / name).read_bytes(), name
