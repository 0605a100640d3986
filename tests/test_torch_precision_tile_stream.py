"""The compositing precision modes through the single-view composite
(kernels B5f/B5b, ``tile_composite``) and the stream composite (kernels
B6f/B6b, ``stream_composite_attrs`` over the compacted copy stream), held
against the JAX package's same modes and the port's own float32 on the
CPU (the kernels' plain PyTorch versions; render/mirror.py's docstring
has the table of what each mode rounds).

The single-view case is tests/test_torch_tile.py's dense one: four views
of two ``make_scene`` scenes at 40 px (16 px tiles: the last tile column
reaches past the image), with several chunks per tile, lists cut at the
cap and saturated tiles.  The stream case is two frames of
tests/test_torch_stream.py's scenes at 48 px, binned into the compacted
copy stream (``copy_budget_factor`` 8), with tiles of several blocks and
saturated pixels.  Both are projected and binned by the port (the tests
of tests/test_torch_tile.py and test_torch_stream.py hold those steps to
JAX) and handed to both packages as numpy arrays.  The JAX side runs
``pallas_tile_composite`` and ``stream_composite_attrs`` in Pallas
interpret mode, under ``jax.jit``.  The bands are JAX's own, as in
tests/test_torch_precision.py: ``matmul_dtype="bf16x2"`` image and
transmittance atol 3e-4, gradient cosine > 0.999 with the norm ratio in
(0.99, 1.01); the other modes atol 2e-2 and cosine > 0.99.  Gradients
are held column by column: the nine plane gradients of the single-view
composite, the nine attribute columns and both views' screen means of
the stream composite.

The replay that kernels B5b and B6b run (the suffix as the colour total
minus a running sum, tests/test_torch_precision.py ``replay_rows``) is
emulated in float32 in each mode and held to the plain version at their
card tolerance, 2e-3 of each attribute's largest gradient.  Two short CPU
fits run every composite of their path in the mode: ``GOPFitter`` at a
width that is not a multiple of ``tile_w`` with ``matmul_dtype="bf16x2"``
(B5f/B5b in the steps, B5f in the evaluation) and with
``rasterizer="pallas_stream"`` and ``matmul_dtype="bfloat16"`` (B6f/B6b
in the steps, B4 in the evaluation).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.render.pallas_splat import pallas_tile_composite as jax_ptc
from gsvc_tpu.render.pallas_stream import stream_composite_attrs as jax_sca
from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
from gsvc_tpu_torch.render import bidir, mirror, stream, tile
from gsvc_tpu_torch.render.bidir import check_precision
from gsvc_tpu_torch.render.splat import (
    RasterSettings, _bin_gaussians, attr_rows_from_proj, bin_gaussians_stream,
    gather_tile_planes, project_gaussians,
)
from gsvc_tpu_torch.train.fit import GOPFitter
from tests.test_torch_precision import (
    BANDS, BWD_REL_ERR, MODES, WIDE_BAND, _rel_errs, _with, replay_rows,
)
from tests.test_splat import make_scene
from tests.test_torch_stream import GEOM as STREAM_GEOM
from tests.test_torch_stream import JSET as STREAM_JSET
from tests.test_torch_stream import _scene
from tests.test_torch_stream_replay import stream_case
from tests.test_torch_tile import JSET as TILE_JSET
from tests.test_torch_tile_replay import _case as tile_case
from tests.test_torch_train import _configs
from tests.test_train import synthetic_video

F32 = ("float32", "float32")
STREAM_J = dataclasses.replace(STREAM_JSET, copy_budget_factor=8)


def _pset(jset):
    return RasterSettings(**dataclasses.asdict(jset))


def _cosine_band(got_cols, want_cols, band, what):
    _, min_cos, ratio = band
    for k, (a, b) in enumerate(zip(want_cols, got_cols)):
        a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30)
        assert cos > min_cos, f"{what}: column {k} gradient cosine {cos}"
        if ratio is not None:
            r = np.linalg.norm(b) / (np.linalg.norm(a) + 1e-30)
            assert ratio[0] < r < ratio[1], f"{what}: column {k} ratio {r}"


def _assert_band(got, want, band, what):
    np.testing.assert_allclose(got["out"], want["out"], atol=band[0], rtol=0,
                               err_msg=f"{what}: image/T")
    _cosine_band(got["grads"], want["grads"], band, what)


# ---------------------------------------------------------------------------
# B5f/B5b: the single-view composite at an unaligned width
# ---------------------------------------------------------------------------

def _tile_inputs():
    """tests/test_torch_tile.py's dense case, projected and binned by the
    port: four views (two seeded scenes of 300 nearly opaque, wide
    gaussians, each forward and flipped) as planes 9 x [4T, cap] and
    counts [4T], numpy."""
    ps = _pset(TILE_JSET)
    planes, counts = [], []
    with torch.no_grad():
        for seed in (0, 1):
            xyz, color, op, sc, rot, valid = (
                torch.from_numpy(np.array(a))
                for a in make_scene(m=300, seed=seed + 3))
            op, sc = 0.9 + 0.09 * op, 6.0 * sc
            for flip in (False, True):
                proj = project_gaussians(xyz, sc, rot, valid, 0.0, -1.0,
                                         -0.75, 24.0, ps, flip=flip)
                lists, cnt = _bin_gaussians(proj, ps)[:2]
                opac = torch.where(proj.valid[:, None], op, torch.zeros(1))
                planes.append(gather_tile_planes(proj, opac, color, lists))
                counts.append(cnt)
    return (tuple(torch.cat([p[i] for p in planes]).numpy()
                  for i in range(9)), torch.cat(counts).numpy())


def _tile_jax(mode, planes, counts, g):
    js = _with(TILE_JSET, mode)

    @jax.jit
    def run(p, c, g):
        out, vjp = jax.vjp(lambda *q: jax_ptc(js, q, c), *p)
        return out, vjp(g)

    out, grads = run(tuple(jnp.asarray(p) for p in planes),
                     jnp.asarray(counts), jnp.asarray(g))
    return dict(out=np.asarray(out), grads=[np.asarray(d) for d in grads])


def _tile_port(mode, planes, counts, g):
    ps = _with(_pset(TILE_JSET), mode)
    pl = tuple(torch.tensor(p, requires_grad=True) for p in planes)
    out = tile.tile_composite(ps, pl, torch.from_numpy(counts))
    out.backward(torch.from_numpy(g))
    return dict(out=out.detach().numpy(), grads=[p.grad.numpy() for p in pl])


@pytest.fixture(scope="module")
def tile_runs():
    """Both packages' single-view forward and plane gradients in every
    mode (the port's float32 too) on the dense case, one seeded
    cotangent."""
    planes, counts = _tile_inputs()
    assert (counts == TILE_JSET.gaussian_cap).any()
    g = np.random.default_rng(12).normal(
        size=(4 * TILE_JSET.n_tiles, 4,
              TILE_JSET.tile_h * TILE_JSET.tile_w)).astype(np.float32)
    res = {F32: (None, _tile_port(F32, planes, counts, g))}
    for mode in MODES:
        res[mode] = (_tile_jax(mode, planes, counts, g),
                     _tile_port(mode, planes, counts, g))
    return res


@pytest.mark.parametrize("mode", MODES, ids="/".join)
def test_tile_modes_match_jax_and_float32(tile_runs, mode):
    """B5f's image and T of every view and B5b's nine plane gradients
    within JAX's band of JAX's same mode and of the port's own float32."""
    assert TILE_JSET.image_width % TILE_JSET.tile_w
    band = BANDS.get(mode, WIDE_BAND)
    want_jax, got = tile_runs[mode]
    _assert_band(got, want_jax, band, f"{mode} vs JAX")
    _assert_band(got, tile_runs[F32][1], band, f"{mode} vs the port's "
                 f"float32")


# ---------------------------------------------------------------------------
# B6f/B6b: the stream composite over the compacted copy stream
# ---------------------------------------------------------------------------

def _stream_case():
    """(JAX attrs, JAX bins, port attrs, port bins) of two frames of
    tests/test_torch_stream.py's scenes (80 nearly opaque gaussians with
    three times the footprint), projected and binned into the compacted
    copy stream by the port (tests/test_torch_stream.py holds its bins
    equal to JAX's)."""
    ps = _pset(STREAM_J)
    attrs, bins = [], []
    for seed, z in ((3, 0.0), (4, 0.02)):
        xyz, color, op, sc, rot, valid = (
            torch.from_numpy(a) for a in _scene(80, seed, grow=3.0,
                                                opaque=True))
        proj = project_gaussians(xyz, sc, rot, valid, z, **STREAM_GEOM,
                                 settings=ps)
        attrs.append(attr_rows_from_proj(
            proj, torch.where(proj.valid[:, None], op, torch.zeros(1)),
            color))
        bins.append(bin_gaussians_stream(proj, ps))
    pattrs = torch.stack(attrs)
    pbins = stream.concat_stream_bins(bins, ps)
    return (jnp.asarray(pattrs.numpy()),
            tuple(jnp.asarray(b.numpy()) for b in pbins), pattrs, pbins)


def _stream_jax(mode, jattrs, jbins, g):
    js = _with(STREAM_J, mode)

    @jax.jit
    def run(a, bins, g):
        m2d = jnp.zeros((4, a.shape[1], 2))
        out, vjp = jax.vjp(lambda x, d: jax_sca(js, x, *bins, d), a, m2d)
        return out, vjp(g)

    out, (da, dm) = run(jattrs, jbins, jnp.asarray(g))
    return dict(out=np.asarray(out), grads=_stream_columns(
        np.asarray(da), np.asarray(dm)))


def _stream_port(mode, pattrs, pbins, g):
    ps = _with(_pset(STREAM_J), mode)
    a = pattrs.clone().requires_grad_(True)
    m2d = torch.zeros((4, pattrs.shape[1], 2), requires_grad=True)
    out = stream.stream_composite_attrs(ps, a, *pbins, m2d)
    out.backward(torch.from_numpy(g))
    return dict(out=out.detach().numpy(),
                grads=_stream_columns(a.grad.numpy(), m2d.grad.numpy()))


def _stream_columns(d_attrs, d_m2d):
    """The nine attribute gradient columns and the two screen-mean
    columns of every view, each on its own."""
    return ([d_attrs[..., k] for k in range(9)]
            + [d_m2d[..., k] for k in range(2)])


@pytest.fixture(scope="module")
def stream_runs():
    jattrs, jbins, pattrs, pbins = _stream_case()
    g = np.random.default_rng(7).normal(
        size=(4 * STREAM_J.n_tiles, 4,
              STREAM_J.tile_h * STREAM_J.tile_w)).astype(np.float32)
    res = {F32: (None, _stream_port(F32, pattrs, pbins, g))}
    for mode in MODES:
        res[mode] = (_stream_jax(mode, jattrs, jbins, g),
                     _stream_port(mode, pattrs, pbins, g))
    return dict(res=res, bins=pbins)


def test_stream_case_reaches_blocks_and_saturation(stream_runs):
    """The compacted stream gives tiles several blocks, and the float32
    composite saturates pixels (so the comparisons see the block stops)."""
    nblk = stream_runs["bins"][3]
    assert int(nblk.max()) >= 3
    t_final = stream_runs["res"][F32][1]["out"][:, 3]
    assert (t_final < 1e-4).sum() >= 50


@pytest.mark.parametrize("mode", MODES, ids="/".join)
def test_stream_modes_match_jax_and_float32(stream_runs, mode):
    """Both views' image and T of B6f, and the attribute and per-view
    screen-mean gradients through B6b and the scatter, within JAX's band
    of JAX's same mode and of the port's own float32."""
    band = BANDS.get(mode, WIDE_BAND)
    want_jax, got = stream_runs["res"][mode]
    _assert_band(got, want_jax, band, f"{mode} vs JAX")
    _assert_band(got, stream_runs["res"][F32][1], band,
                 f"{mode} vs the port's float32")


def test_modes_move_tile_and_stream_outputs(tile_runs, stream_runs):
    """Each mode is taken by both composites: compute_dtype and
    matmul_dtype "bfloat16" change the image, bf16x2 leaves the forward
    float32's and changes the gradients only."""
    for runs in (tile_runs, stream_runs["res"]):
        f32 = runs[F32][1]
        for mode in MODES:
            got = runs[mode][1]
            moved = not np.array_equal(got["out"], f32["out"])
            assert moved == (mode != ("float32", "bf16x2")), mode
            assert not all(np.array_equal(a, b) for a, b in
                           zip(got["grads"], f32["grads"])), mode


# ---------------------------------------------------------------------------
# B5b's and B6b's replay (suffix from the colour total) in every mode
# ---------------------------------------------------------------------------

def _cotangent(shape):
    return torch.from_numpy(np.random.default_rng(11).normal(
        size=shape).astype(np.float32))


@pytest.mark.parametrize("mode", MODES, ids="/".join)
def test_b5b_replay_algebra_matches_plain(mode):
    """What kernel B5b computes in each mode (B2's replay: the suffix is
    the colour total minus a running sum) stays within its card tolerance
    of the plain version, on tests/test_torch_tile_replay.py's saturated
    case (a column whose T underflows inside a replayed chunk, 40 px,
    background 0.3)."""
    settings, planes, counts = tile_case("saturated")
    settings = _with(settings, mode)
    out4, t_chk, _ = tile.tile_fwd_plain(settings, planes, counts)
    g = _cotangent(out4.shape)
    want, _ = tile.tile_bwd_plain(settings, planes, counts, t_chk, g)
    tl = tile._plane_tiles(settings, planes, counts,
                           torch.arange(planes[0].shape[0]))
    assert tl.mode == check_precision(settings)
    errs = _rel_errs(replay_rows(settings, tl, t_chk, out4, g), want)
    assert max(errs) <= BWD_REL_ERR, errs


@pytest.mark.parametrize("mode", MODES, ids="/".join)
def test_b6b_replay_algebra_matches_plain(mode):
    """The same for kernel B6b on tests/test_torch_stream_replay.py's
    saturated case (both views, the flip view walking each block's
    copies bottom-up, dead tail blocks, background 0.3): the replay of
    every step's blocks from the per-block checkpoints."""
    settings, rows, bins = stream_case("saturated")
    settings = _with(settings, mode)
    out4, t_chk, _ = stream.stream_fwd_plain(settings, rows, *bins)
    g = _cotangent(out4.shape)
    first, live = stream._block_map(settings, *bins)
    f_n = bins[3].numel() // settings.n_tiles
    sel = torch.arange(2 * f_n * settings.n_tiles)
    tl, _, _ = stream._stream_tiles(settings, rows, first, live, bins[3],
                                    sel)
    assert tl.mode == check_precision(settings) and (tl.v == 1).any()
    # the steps' checkpoints by composite position, as stream_bwd_plain
    # lays them out
    d = mirror.grid_rows(settings, f_n, "cpu")[0]
    blk, in_span = stream._block_of_position(settings, tl, first[d].long(),
                                             bins[3][d].long())
    n_chunks = tl.n_chunks
    chk = torch.zeros((sel.numel(), n_chunks + 1, t_chk.shape[2]))
    view = tl.v[:, None].expand(-1, n_chunks)
    chk[:, :n_chunks][in_span] = t_chk[view[in_span], blk[in_span]]
    chk[:, n_chunks] = out4[tl.out_row, 3]
    want = torch.zeros((sel.numel(), 9, settings.gaussian_cap))
    mirror.backward_rows(settings, tl, chk, g[tl.out_row], want)
    got = replay_rows(settings, tl, chk, out4[tl.out_row], g[tl.out_row])
    errs = _rel_errs(got, want)
    assert max(errs) <= BWD_REL_ERR, errs


# ---------------------------------------------------------------------------
# Short CPU fits: every composite of the path in the mode
# ---------------------------------------------------------------------------

def _record_composites(monkeypatch):
    """Wraps the plain versions' shared loops and every composite's plain
    entry: records (entry, mode bits) per call and the mode of every
    batch of tiles the loops composite."""
    seen = {"entries": set(), "tiles": set()}
    for mod, name in ((tile, "tile_fwd_plain"), (tile, "tile_bwd_plain"),
                      (stream, "stream_fwd_plain"),
                      (stream, "stream_bwd_plain"),
                      (mirror, "mirror_fwd_plain"),
                      (mirror, "mirror_bwd_plain"),
                      (bidir, "bidir_out4_plain")):
        fn = getattr(mod, name)

        def wrapped(settings, *a, _fn=fn, _name=name):
            seen["entries"].add((_name, check_precision(settings)))
            return _fn(settings, *a)

        monkeypatch.setattr(mod, name, wrapped)
    for name in ("composite_rows", "backward_rows"):
        fn = getattr(mirror, name)

        def rows(settings, tl, *a, _fn=fn):
            seen["tiles"].add(tl.mode)
            return _fn(settings, tl, *a)

        monkeypatch.setattr(mirror, name, rows)
    return seen


def _short_fit(width, pipeline):
    _, cfg = _configs()
    cfg.optimization.iterations = 3
    for k, v in pipeline.items():
        setattr(cfg.pipeline, k, v)
    frames = np.round(synthetic_video(t=4, h=24, w=width) * 255).astype(
        np.uint8)
    fitter = GOPFitter(cfg, FrameCubeDataset(images=frames), seed=0,
                       device="cpu")
    report = fitter.fit(log_every=1)
    ev = fitter.evaluate(frames=[0])
    return fitter, report, ev


@pytest.mark.parametrize("case", ["unaligned_bf16x2", "stream_bfloat16"])
def test_short_fit_runs_every_composite_in_the_mode(monkeypatch, case):
    """Three steps and an evaluation: at 40 px with 16 px tiles and
    ``matmul_dtype="bf16x2"`` every step runs B5f/B5b's plain versions
    and the evaluation B5f's; with ``rasterizer="pallas_stream"``,
    ``copy_budget_factor`` 8 and ``matmul_dtype="bfloat16"`` every step
    runs B6f/B6b's and the evaluation B4's.  Every composite and every
    batch of tiles takes the mode; the losses are finite."""
    seen = _record_composites(monkeypatch)
    if case == "unaligned_bf16x2":
        fitter, report, ev = _short_fit(40, {"matmul_dtype": "bf16x2"})
        mode = check_precision(fitter.settings)
        want = {("tile_fwd_plain", mode), ("tile_bwd_plain", mode)}
    else:
        fitter, report, ev = _short_fit(32, {
            "matmul_dtype": "bfloat16", "rasterizer": "pallas_stream",
            "copy_budget_factor": 8})
        mode = check_precision(fitter.settings)
        want = {("stream_fwd_plain", mode), ("stream_bwd_plain", mode),
                ("bidir_out4_plain", mode)}
    assert mode == {"unaligned_bf16x2": bidir.GRAD_BF16,
                    "stream_bfloat16": bidir.TRANS_BF16
                    | bidir.GRAD_BF16}[case]
    assert seen["entries"] == want
    assert seen["tiles"] == {mode}
    assert len(report.history) == 3
    assert all(np.isfinite(h["loss"]) for h in report.history)
    assert np.isfinite(ev["psnr"])
