"""The port's stream composite (kernels B6f/B6b through their plain
PyTorch versions on the CPU), its chunk-aligned and compacted copy
streams, and the render paths that take it with
``rasterizer="pallas_stream"``, against the JAX package on the same
numpy-seeded inputs, at the settings of tests/test_pallas_stream.py
(40x48 frames, 8x16 tiles, cap 64, chunk 16).  The fit, the train step,
the overflow reaction and the stream CLI are in
tests/test_torch_stream_fit.py.

The JAX side runs ``stream_composite_attrs`` /
``stream_composite_inference`` (on the CPU: the TPU kernels
``_fwd_kernel_stream`` / ``_bwd_kernel_stream`` in Pallas interpret
mode) and ``bin_gaussians_stream``.  Tolerances:

* binning, streams, block maps and the compacted stream: exact (integer
  work, one stable sort of the same keys);
* composite outputs 1e-6, JAX's own stream-vs-mirror tolerance
  (tests/test_pallas_stream.py);
* attribute and m2d gradients against JAX rtol 2e-3 / atol 2e-6, the
  single-view composite's plane-gradient tolerance
  (tests/test_torch_tile.py): the port takes the mean/conic moments about
  the gaussian's mean where the TPU kernel takes them about the tile
  centre, and sums the suffixes in another order (the largest difference
  seen is ~4e-5 on gradients of magnitude ~18, 2e-6 of the largest);
  against the port's own mirror composite, which runs the same backward
  loops, JAX's stream-vs-mirror tolerance rtol 1e-5 / atol 1e-6;
* render paths: images 1e-5 and gradients rtol 2e-3 / atol 2e-4, as
  tests/test_torch_mirror.py holds the mirror path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.models.gaussians import GenerateMode as JMode
from gsvc_tpu.render.batched import (
    render_frame_views as jax_views, render_pair as jax_render_pair,
)
from gsvc_tpu.render.pallas_stream import (
    concat_stream_bins as jax_concat,
    stream_composite_attrs as jax_sca,
    stream_composite_inference as jax_sci,
)
from gsvc_tpu.render.splat import (
    RasterSettings as JaxSettings, _bin_gaussians as jax_bin,
    _sorted_copy_stream as jax_sorted,
    attr_rows_from_proj as jax_attr_rows,
    bin_gaussians_stream as jax_bin_stream,
    project_gaussians as jax_project,
)
from gsvc_tpu_torch.models.gaussians import GenerateMode
from gsvc_tpu_torch.render import mirror, stream
from gsvc_tpu_torch.render.bidir import column_shape
from gsvc_tpu_torch.render.batched import (
    can_mirror, render_frame_views, render_pair,
)
from gsvc_tpu_torch.render.splat import (
    RasterSettings, _bin_gaussians, _sorted_copy_stream,
    attr_rows_from_proj, bin_gaussians_stream, project_gaussians,
    stream_blocks_max,
)
from tests.test_batched import GEOM as BGEOM, WINDOW_CAP, Z1, Z2, \
    settings_for, tiny_model
from tests.test_splat import make_scene
from tests.test_torch_tile import _port_state

OUT_ATOL = 1e-6
GRAD_JAX_RTOL, GRAD_JAX_ATOL = 2e-3, 2e-6
GRAD_MIRROR_RTOL, GRAD_MIRROR_ATOL = 1e-5, 1e-6
IMG_ATOL = 1e-5
RENDER_RTOL, RENDER_ATOL = 2e-3, 2e-4
JSET = JaxSettings(image_height=40, image_width=48, threshold=0.15,
                   tile_h=8, tile_w=16, gaussian_cap=64, chunk=16,
                   tiles_per_gaussian=32)
GEOM = dict(x_min=-1.0, y_min=-0.75, scale=24.0)
P = JSET.tile_h * JSET.tile_w


def _pset(jset):
    return RasterSettings(**dataclasses.asdict(jset))


def _scene(m, seed, empty_tiles=False, grow=1.0, opaque=False):
    """A numpy-seeded scene: (xyz, color, opacity, scaling, rot, valid)
    as numpy arrays.  ``empty_tiles`` pushes every gaussian into the left
    third (the right tiles stay empty); ``grow`` scales the footprints;
    ``opaque`` lifts the opacities to 0.9-0.99 (saturated tiles)."""
    xyz, color, op, sc, rot, valid = (np.array(a) for a in make_scene(
        m=m, seed=seed))
    if empty_tiles:
        xyz[:, 0] = np.abs(xyz[:, 0]) * -0.4 - 0.5
    if opaque:
        op = (0.9 + 0.09 * op).astype(np.float32)
    return xyz, color, op, (sc * grow).astype(np.float32), rot, valid


def _both_frames(scene, frame_z, jset):
    """(JAX projection, JAX attribute rows, port projection, port rows) of
    one scene at one frame plane."""
    xyz, color, op, sc, rot, valid = scene
    jp = jax_project(*(jnp.asarray(a) for a in (xyz, sc, rot, valid)),
                     frame_z, GEOM["x_min"], GEOM["y_min"], GEOM["scale"],
                     jset)
    ja = jax_attr_rows(jp, jnp.where(jp.valid[:, None], op, 0.0), color)
    t = torch.from_numpy
    pp = project_gaussians(t(xyz), t(sc), t(rot), t(valid), frame_z,
                           GEOM["x_min"], GEOM["y_min"], GEOM["scale"],
                           _pset(jset))
    pa = attr_rows_from_proj(
        pp, torch.where(pp.valid[:, None], t(op), torch.zeros(1)), t(color))
    return jp, ja, pp, pa


# (m, seed, empty_tiles, footprint scale, copy_budget_factor)
BIN_CASES = {
    "padded": (40, 0, False, 1.0, 0),
    "budget8": (40, 0, False, 1.0, 8),
    "empty_tiles": (40, 1, True, 1.0, 8),
    "over_budget": (300, 2, False, 4.0, 1),
    "quantized_rank": (5000, 3, False, 1.0, 8),
}


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_stream_bins_match_jax(case):
    """Every StreamBins field, and the sorted copy stream under it, equal
    JAX's: padded and compacted streams, empty tiles, a budget that drops
    copies (the deepest, with ``overflow`` counting them) and the
    quantised depth rank of scenes of >= 4096 gaussians."""
    m, seed, empty, grow, factor = BIN_CASES[case]
    jset = dataclasses.replace(JSET, copy_budget_factor=factor)
    jp, _, pp, _ = _both_frames(_scene(m, seed, empty, grow), 0.0, jset)
    want, got = jax_bin_stream(jp, jset), bin_gaussians_stream(pp,
                                                               _pset(jset))
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    for a, b in zip(_sorted_copy_stream(pp, _pset(jset)),
                    jax_sorted(jp, jset)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    nblk = got.nblk.numpy()
    assert nblk.min() >= 1 and int((got.ids >= 0).sum()) == int(
        got.n_rendered) > 0
    budget_dropped = int(_sorted_copy_stream(pp, _pset(jset))[3])
    assert (budget_dropped > 0) == (case == "over_budget")
    if case == "empty_tiles":
        assert (got.counts == 0).any()


@pytest.mark.parametrize("factor", [8, 1])
def test_bin_gaussians_with_copy_budget_matches_jax(factor):
    """The tile lists of the compacted stream: lists, counts, dropped
    copies, overflow (budget drops included) and composited copies."""
    jset = dataclasses.replace(JSET, copy_budget_factor=factor)
    jp, _, pp, _ = _both_frames(_scene(300, 4, grow=3.0), 0.0, jset)
    for a, b in zip(_bin_gaussians(pp, _pset(jset)), jax_bin(jp, jset)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _stream_inputs(frames, jset):
    """Both packages' stream composite inputs for a list of scenes (one
    per frame): (JAX attrs, JAX bins, port attrs, port bins, port
    projections)."""
    ja, jb, pa, pb, projs = [], [], [], [], []
    for scene, z in frames:
        jp, jrows, pp, prows = _both_frames(scene, z, jset)
        ja.append(jrows)
        pa.append(prows)
        jb.append(jax_bin_stream(jp, jset))
        pb.append(bin_gaussians_stream(pp, _pset(jset)))
        projs.append(pp)
    return (jnp.stack(ja), jax_concat(jb, jset), torch.stack(pa),
            stream.concat_stream_bins(pb, _pset(jset)), projs)


@pytest.mark.parametrize("factor", [0, 8])
def test_stream_from_tile_lists_matches_binning(factor):
    """The stream layout of given tile lists (the kernels' card tests and
    the smoke build theirs from synthetic lists) equals what
    ``concat_stream_bins`` of ``bin_gaussians_stream`` lays out."""
    jset = dataclasses.replace(JSET, copy_budget_factor=factor)
    pset = _pset(jset)
    frames = [(_scene(300, 10, grow=3.0), 0.0), (_scene(300, 11, True),
                                                 0.02)]
    _, _, _, want, projs = _stream_inputs(frames, jset)
    lists, counts = _mirror_inputs(projs, pset)
    got = stream.stream_from_tile_lists(pset, lists, counts,
                                        stream_blocks_max(pset, 300))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="b_max"):
        stream.stream_from_tile_lists(pset, lists, counts, 2)


def _mirror_inputs(projs, pset):
    lists, counts = zip(*(_bin_gaussians(p, pset)[:2] for p in projs))
    return torch.stack(lists), torch.stack(counts)


def test_concat_stream_bins_matches_jax():
    frames = [(_scene(40, 5), 0.0), (_scene(40, 6, True), 0.02)]
    _, jbins, _, pbins, _ = _stream_inputs(frames, JSET)
    for a, b in zip(pbins, jbins):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (pbins[1] >= JSET.n_tiles).any()         # frame 1's tiles offset


@pytest.mark.parametrize("empty_tiles", [False, True])
def test_stream_forward_matches_jax_and_mirror(empty_tiles):
    """Both views of two frames: the training form and the inference form
    against JAX's, and against the port's mirror composite on the padded
    lists of the same scenes."""
    frames = [(_scene(40, 0, empty_tiles), 0.0),
              (_scene(40, 1, empty_tiles), 0.02)]
    jattrs, jbins, pattrs, pbins, projs = _stream_inputs(frames, JSET)
    pset = _pset(JSET)
    out = stream.stream_composite_attrs(pset, pattrs, *pbins)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jax_sca(JSET, jattrs, *jbins,
                                                  None)),
                               rtol=0, atol=OUT_ATOL)
    inf = stream.stream_composite_inference(pset, pattrs, *pbins)
    np.testing.assert_allclose(inf.numpy(),
                               np.asarray(jax_sci(JSET, jattrs, *jbins)),
                               rtol=0, atol=OUT_ATOL)
    lists, counts = _mirror_inputs(projs, pset)
    want, t_chk_m, _ = mirror.mirror_fwd_plain(pset, pattrs, lists, counts)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0,
                               atol=OUT_ATOL)
    if empty_tiles:
        empty = (counts.reshape(-1) == 0).nonzero().squeeze(1)
        assert empty.numel() > 0
        # an empty tile's forward view renders background with T = 1
        rows_f = (empty // pset.n_tiles) * 2 * pset.n_tiles \
            + empty % pset.n_tiles
        assert torch.equal(out[rows_f, 3], torch.ones(len(rows_f), P))
    # the per-block checkpoints hold the mirror composite's checkpoint of
    # the block's composite position, for each view
    rows = stream.stream_rows(pattrs, pbins[0])
    _, t_chk, pairs = stream.stream_fwd_plain(pset, rows, *pbins)
    first = stream.block_starts(pset, pbins[3], pbins[0].shape[1]
                                // pset.chunk)
    d, v, out_row = mirror.grid_rows(pset, 2, "cpu")
    for g in range(0, len(d), 7):
        nb = int(pbins[3][d[g]])
        for p in range(nb):
            b = int(first[d[g]]) + (nb - 1 - p if v[g] else p)
            torch.testing.assert_close(t_chk[v[g], b], t_chk_m[out_row[g], p],
                                       rtol=0, atol=OUT_ATOL)
    assert pairs > 0


def test_stream_gradients_match_jax_and_mirror():
    """Attribute and per-view m2d gradients of a seeded cotangent: against
    ``jax.grad`` through JAX's stream composite, and against the port's
    mirror composite on the same scenes."""
    frames = [(_scene(40, 3), 0.0), (_scene(40, 4), 0.02)]
    jattrs, jbins, pattrs, pbins, projs = _stream_inputs(frames, JSET)
    pset = _pset(JSET)
    m = jattrs.shape[1]
    cot = np.random.default_rng(7).normal(
        size=(4 * JSET.n_tiles, 4, P)).astype(np.float32)

    def jloss(a, m2d):
        return jnp.sum(jax_sca(JSET, a, *jbins, m2d) * cot)

    jga, jgm = jax.grad(jloss, argnums=(0, 1))(jattrs, jnp.zeros((4, m, 2)))

    def port_grads(compose, *inputs):
        a = pattrs.clone().requires_grad_(True)
        m2d = torch.zeros((4, m, 2), requires_grad=True)
        (compose(pset, a, *inputs, m2d) * torch.from_numpy(cot)).sum() \
            .backward()
        return a.grad.numpy(), m2d.grad.numpy()

    ga, gm = port_grads(stream.stream_composite_attrs, *pbins)
    np.testing.assert_allclose(ga, np.asarray(jga), rtol=GRAD_JAX_RTOL,
                               atol=GRAD_JAX_ATOL)
    np.testing.assert_allclose(gm, np.asarray(jgm), rtol=GRAD_JAX_RTOL,
                               atol=GRAD_JAX_ATOL)
    assert np.abs(np.asarray(jga)).max() > 1.0
    assert np.abs(np.asarray(jgm)[1]).max() > 1e-3
    ma, mm = port_grads(mirror.mirror_composite_attrs,
                        *_mirror_inputs(projs, pset))
    np.testing.assert_allclose(ga, ma, rtol=GRAD_MIRROR_RTOL,
                               atol=GRAD_MIRROR_ATOL)
    np.testing.assert_allclose(gm, mm, rtol=GRAD_MIRROR_RTOL,
                               atol=GRAD_MIRROR_ATOL)


def test_stream_plain_versions_independent_of_batching(monkeypatch):
    frames = [(_scene(300, 8, grow=6.0, opaque=True), 0.0),
              (_scene(300, 9, True, 6.0, True), 0.02)]
    _, _, pattrs, pbins, _ = _stream_inputs(frames, JSET)
    pset = _pset(JSET)
    rows = stream.stream_rows(pattrs, pbins[0])
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4 * JSET.n_tiles, 4, P)).astype(np.float32))

    def run():
        out, t_chk, pairs = stream.stream_fwd_plain(pset, rows, *pbins)
        grads, pairs_b = stream.stream_bwd_plain(pset, rows, *pbins, out,
                                                 t_chk, g)
        return out, t_chk, grads, pairs, pairs_b

    want = run()
    monkeypatch.setattr(mirror, "PLAIN_BATCH", 5)
    got = run()
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert got[3:] == want[3:] and want[3] > 0
    # saturated tiles stop early; lists run over several blocks and are
    # cut at the cap
    assert float(want[0][:, 3].amax(dim=1).min()) < 1e-4
    assert int(pbins[3].max()) == JSET.gaussian_cap // JSET.chunk


def test_stream_refuses_bad_inputs():
    frames = [(_scene(40, 0), 0.0)]
    _, _, pattrs, pbins, _ = _stream_inputs(frames, JSET)
    pset = _pset(JSET)
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        stream.stream_composite_attrs(
            dataclasses.replace(pset, compute_dtype="float16"), pattrs,
            *pbins)
    with pytest.raises(ValueError, match="multiple of tile_w"):
        stream.stream_composite_attrs(
            dataclasses.replace(pset, image_width=40), pattrs, *pbins)
    with pytest.raises(ValueError, match="nblk"):
        stream.stream_composite_attrs(pset, pattrs, *pbins[:3],
                                      pbins[3].long())
    jstate, jcfg = tiny_model(seed=1)
    state, cfg = _port_state(jstate)
    with pytest.raises(ValueError, match="unknown rasterizer"):
        render_pair(state, cfg, Z1, Z2, BGEOM["x_min"], BGEOM["y_min"],
                    BGEOM["scale"], _pset(settings_for(jcfg, 48)),
                    WINDOW_CAP, GenerateMode.FULL_PRECISION,
                    rasterizer="pallas_v9")


# ---------------------------------------------------------------------------
# The render paths with rasterizer="pallas_stream"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,width", [("FULL_PRECISION", 48),
                                        ("STE_ENTROPY", 48),
                                        ("FULL_PRECISION", 40)],
                         ids=["fp", "ste_entropy", "unaligned_fallback"])
def test_render_pair_stream_matches_jax(mode, width):
    """``render_pair(rasterizer="pallas_stream")`` against JAX's: images,
    transmittances, overflow, composited copies and harmful overflow; in
    FULL_PRECISION also the gradients of a weighted image sum in the
    anchor leaves, one MLP and each view's means2d.  At width 40 (not a
    multiple of the 16 px tiles) both packages fall back to the
    single-view planes (B5f/B5b)."""
    jstate, jcfg = tiny_model(seed=4)
    jset = settings_for(jcfg, width)
    assert can_mirror(_pset(jset)) == (width == 48)
    rows = WINDOW_CAP * jcfg.n_offsets
    wts = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    with_grads = mode == "FULL_PRECISION" and width == 48

    def jloss(p, m2d):
        st = jstate._replace(anchors=p[0], nets=p[1])
        pr = jax_render_pair(st, jcfg, Z1, Z2, settings=jset,
                             window_cap=WINDOW_CAP, mode=JMode[mode],
                             key=None, rasterizer="pallas_stream",
                             means2d=m2d, **BGEOM)
        return jnp.sum(jnp.asarray(wts)[:, None, None, None]
                       * pr.images ** 2), (pr.images, pr.transmittances, [
                           (r.overflow, r.harmful_overflow, r.num_rendered)
                           for r in pr.renders])

    params = (jstate.anchors, jstate.nets)
    if with_grads:
        (_, (jimg, jts, jcounts)), (jg, jgm) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(
            params, jnp.zeros((4, rows, 2)))
    else:
        _, (jimg, jts, jcounts) = jax.jit(jloss)(params, None)

    state, cfg = _port_state(jstate, grad=with_grads)
    mlp = state.nets.mlp_color["out"]["w"].requires_grad_(with_grads)
    m2d = torch.zeros((4, rows, 2), requires_grad=True) if with_grads \
        else None
    pr = render_pair(state, cfg, Z1, Z2, BGEOM["x_min"], BGEOM["y_min"],
                     BGEOM["scale"], _pset(jset), WINDOW_CAP,
                     GenerateMode[mode], means2d=m2d,
                     rasterizer="pallas_stream")
    np.testing.assert_allclose(pr.images.detach().numpy(), np.asarray(jimg),
                               rtol=0, atol=IMG_ATOL)
    np.testing.assert_allclose(pr.transmittances.detach().numpy(),
                               np.asarray(jts), rtol=0, atol=IMG_ATOL)
    assert float(pr.images.detach().abs().max()) > 0.05
    for r, (ovf, harm, nrend) in zip(pr.renders, jcounts):
        assert (int(r.overflow), int(r.harmful_overflow),
                int(r.num_rendered)) == (int(ovf), int(harm), int(nrend))
    if not with_grads:
        return
    torch.sum(torch.from_numpy(wts)[:, None, None, None]
              * pr.images ** 2).backward()
    for name in ("feat", "offset", "scaling", "anchor"):
        np.testing.assert_allclose(
            getattr(state.anchors, name).grad.numpy(),
            np.asarray(getattr(jg[0], name)), rtol=RENDER_RTOL,
            atol=RENDER_ATOL, err_msg=name)
    np.testing.assert_allclose(
        mlp.grad.numpy(), np.asarray(jg[1].mlp_color["out"]["w"]),
        rtol=RENDER_RTOL, atol=RENDER_ATOL)
    for view in range(4):
        np.testing.assert_allclose(m2d.grad[view].numpy(),
                                   np.asarray(jgm[view]), rtol=RENDER_RTOL,
                                   atol=RENDER_ATOL, err_msg=f"view {view}")
    assert np.abs(np.asarray(jgm[1])).max() > 1e-3


@pytest.mark.parametrize("inference", [False, True])
def test_render_frame_views_stream_matches_jax(inference):
    """Both views of one frame through the stream composite (B6f; the
    training form with ``inference=False``) against JAX's
    ``render_frame_views(rasterizer="pallas_stream")``."""
    jstate, jcfg = tiny_model(seed=2)
    jset = settings_for(jcfg, 48)
    javg, jimgs, jts, jaux = jax.jit(lambda st: jax_views(
        st, jcfg, 0.01, settings=jset, window_cap=WINDOW_CAP,
        rasterizer="pallas_stream", inference=inference, **BGEOM))(jstate)
    state, cfg = _port_state(jstate)
    with torch.no_grad():
        avg, imgs, ts, aux = render_frame_views(
            state, cfg, 0.01, BGEOM["x_min"], BGEOM["y_min"],
            BGEOM["scale"], _pset(jset), WINDOW_CAP, inference=inference,
            rasterizer="pallas_stream")
    for got, want in ((imgs, jimgs), (ts, jts), (avg, javg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=IMG_ATOL)
    assert (int(aux[4]), int(aux[5])) == (int(jaux[4]), int(jaux[5]))
    assert float(avg.abs().max()) > 0.05


def test_evaluate_video_renders_through_the_stream(monkeypatch):
    """``GSVC_RASTERIZER=pallas_stream`` makes ``evaluate_video`` render
    ``render_frame_views``' average through the stream composite, as JAX's
    ``_make_eval_render`` does; other served names keep the bidirectional
    composite; unknown names raise."""
    from gsvc_tpu_torch.report import evaluate_video

    jstate, jcfg = tiny_model(seed=2)
    state, cfg = _port_state(jstate)
    pset = _pset(settings_for(jcfg, 48))
    zs = [0.0, 0.01]
    gt = np.random.default_rng(0).uniform(
        0, 1, (2, pset.image_height, pset.image_width, 3)).astype(np.float32)
    kw = dict(gt_images=gt, mode=GenerateMode.FULL_PRECISION, decoded=False)
    args = (state, cfg, pset, WINDOW_CAP, zs, BGEOM["x_min"],
            BGEOM["y_min"], BGEOM["scale"])
    fwd0 = stream.stream_forward.launches
    monkeypatch.setenv("GSVC_RASTERIZER", "pallas_stream")
    ev_s = evaluate_video(*args, **kw)
    with torch.no_grad():
        want = [render_frame_views(*args[:2], z, *args[5:], pset,
                                   WINDOW_CAP, rasterizer="pallas_stream",
                                   inference=True)[0] for z in zs]
    from gsvc_tpu_torch.metrics.image import psnr
    expect = [float(psnr(w, torch.from_numpy(g).permute(2, 0, 1)))
              for w, g in zip(want, gt)]
    np.testing.assert_allclose(ev_s["per_frame_psnr"], expect, rtol=0,
                               atol=1e-9)
    monkeypatch.setenv("GSVC_RASTERIZER", "pallas_train")
    ev_b = evaluate_video(*args, **kw)
    np.testing.assert_allclose(ev_b["psnr"], ev_s["psnr"], atol=1e-3)
    assert stream.stream_forward.launches == fwd0      # CPU: no launches
    monkeypatch.setenv("GSVC_RASTERIZER", "pallas_v9")
    with pytest.raises(ValueError, match="unknown rasterizer"):
        evaluate_video(*args, **kw)


def test_stream_kernel_shape():
    """B6f/B6b run one thread per tile column, whole warps
    (``column_shape``, B1/B2's): 128 x 1 at 8x16, 128 x 8 at 8x128, 256 x
    8 at 16x128; a chunk past the shared-memory stage and a tile width
    that does not divide the block are refused."""
    base = RasterSettings(image_height=40, image_width=48, threshold=0.15,
                          tile_h=8, tile_w=16, gaussian_cap=64, chunk=16,
                          tiles_per_gaussian=32)
    assert stream.launch_shape(base) == column_shape(base, "B6f/B6b") \
        == (128, 1)
    train = dataclasses.replace(base, tile_w=128, image_width=256)
    assert stream.launch_shape(train) == (128, 8)
    decode = dataclasses.replace(train, tile_h=16)
    assert stream.launch_shape(decode) == (256, 8)
    with pytest.raises(ValueError, match="B6f/B6b"):
        stream.launch_shape(dataclasses.replace(base, chunk=256,
                                                gaussian_cap=512))
    with pytest.raises(ValueError, match="B6f/B6b"):
        stream.launch_shape(dataclasses.replace(base, tile_w=48,
                                                image_width=48))
