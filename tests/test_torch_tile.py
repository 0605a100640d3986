"""The port's single-view composite (kernels B5f/B5b through their plain
PyTorch versions on the CPU) and the paths that take it at frame widths
that are not a multiple of ``tile_w`` — ``render_pair``,
``render_frame_views``, ``render_frame_bidir``'s fallback and the
single-view ``render_frame`` — against the JAX package on the same
numpy-seeded inputs (the four-phase fit at such a width is in
tests/test_torch_tile_fit.py).

The JAX side runs ``pallas_tile_composite`` / ``composite_tiles_inference``
(on the CPU: the TPU kernels ``_fwd_kernel`` / ``_bwd_kernel`` in Pallas
interpret mode), reached from ``render_pair`` and ``render_frame_views``
with ``rasterizer="pallas_train"`` / ``"pallas"``.  Tolerances:

* composite outputs and checkpoints 1e-5: the same arithmetic, with the
  in-chunk transmittance a running product here and a log-space cumsum
  there (float rounding only);
* plane gradients rtol 2e-3 / atol 2e-6: the backward's suffix sums and
  pixel sums are reduced in other orders, and the port takes the
  mean/conic moments about the gaussian's mean where the TPU kernel takes
  them about the tile centre;
* images 1e-5 and parameter / means2d gradients rtol 2e-3 / atol 2e-4 for
  the render paths, as tests/test_torch_mirror.py holds the mirror path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.models.gaussians import GenerateMode as JMode
from gsvc_tpu.render.batched import (
    _frame_views as jax_frame_views, render_frame_bidir as jax_bidir,
    render_frame_views as jax_views, render_pair as jax_render_pair,
)
from gsvc_tpu.render.pallas_splat import (
    composite_tiles_inference as jax_inference,
    pallas_tile_composite as jax_ptc,
)
from gsvc_tpu.render.pipeline import render_frame as jax_render_frame
from gsvc_tpu.render.splat import (
    RasterSettings as JaxSettings, _bin_gaussians as jax_bin,
    gather_tile_planes as jax_gather_planes,
    project_gaussians as jax_project,
)
from gsvc_tpu_torch.config import ModelConfig
from gsvc_tpu_torch.convert import state_from_numpy
from gsvc_tpu_torch.models.gaussians import GaussianConfig, GenerateMode
from gsvc_tpu_torch.render import tile
from gsvc_tpu_torch.render.batched import (
    _frame_views, can_mirror, render_frame_bidir, render_frame_views,
    render_pair,
)
from gsvc_tpu_torch.render.pipeline import render_frame
from gsvc_tpu_torch.render.splat import RasterSettings
from tests.test_batched import GEOM, WINDOW_CAP, Z1, Z2, settings_for, \
    tiny_model
from tests.test_splat import make_scene
from tests.test_torch_mirror import _jax_pair_noise

OUT_ATOL = 1e-5
PLANE_RTOL, PLANE_ATOL = 2e-3, 2e-6
IMG_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
# 40 px wide with 16 px tiles: three tile columns, the last one 8 px short
JSET = JaxSettings(image_height=40, image_width=40, threshold=0.15,
                   tile_h=8, tile_w=16, gaussian_cap=64, chunk=16,
                   tiles_per_gaussian=32)
PSET = RasterSettings(**dataclasses.asdict(JSET))
MODEL = dict(anchor_feature_dim=8, n_offsets=4, threshold=0.3,
             time_multi_res=4, offset_multi_res=4, log2=6, log2_2D=7,
             grid_feature_dim=2, resolutions_list=(6, 10),
             resolutions_list_2D=(12, 20))


def _planes(kind):
    """Four views' planes (two seeded scenes, forward and flip, each
    projected and binned by JAX) concatenated to [4T, cap].  ``dense``:
    300 wide, nearly opaque gaussians — several chunks per tile, lists cut
    at the cap, saturated tiles and early stops; ``sparse``: one or two
    chunks per tile, the last partial, and empty tiles."""
    planes, counts = [], []
    for seed in (0, 1):
        m = 300 if kind == "dense" else 40
        xyz, color, op, sc, rot, valid = make_scene(m=m, seed=seed + 3)
        if kind == "dense":
            op = 0.9 + 0.09 * op
            sc = 6.0 * sc
        for flip in (False, True):
            proj = jax_project(xyz, sc, rot, valid, 0.0, -1.0, -0.75, 24.0,
                               JSET, flip=flip)
            tl, cnt, _, _, _ = jax_bin(proj, JSET)
            opac = jnp.where(proj.valid[:, None], op, 0.0)
            planes.append(jax_gather_planes(proj, opac, color, tl))
            counts.append(cnt)
    return (tuple(np.array(jnp.concatenate([p[i] for p in planes]))
                  for i in range(9)),
            np.array(jnp.concatenate(counts)))


@pytest.fixture(scope="module", params=["sparse", "dense"])
def tile_case(request):
    """JAX forward, checkpoints and plane vjp of the single-view composite
    on one case, with a seeded cotangent."""
    planes, counts = _planes(request.param)
    rng = np.random.default_rng(12)
    g = rng.normal(size=(4 * JSET.n_tiles, 4,
                         JSET.tile_h * JSET.tile_w)).astype(np.float32)
    jp = tuple(jnp.asarray(p) for p in planes)
    jc = jnp.asarray(counts)
    out, vjp = jax.vjp(lambda *p: jax_ptc(JSET, p, jc), *jp)
    from gsvc_tpu.render.pallas_splat import _composite_call
    _, t_chk = _composite_call(JSET, jp, jc, save_tchk=True)
    return dict(kind=request.param, planes=planes, counts=counts, g=g,
                out=np.asarray(out), t_chk=np.asarray(t_chk),
                inference=np.asarray(jax_inference(JSET, jp, jc)),
                d_planes=[np.asarray(d) for d in vjp(jnp.asarray(g))])


def _torch_planes(case, grad=False):
    return tuple(torch.tensor(p, requires_grad=grad) for p in case["planes"])


def test_tile_case_covers_the_loop_stops(tile_case):
    """The dense case reaches several chunks per tile, early stops on
    saturated tiles and lists cut at the cap; the sparse one short lists,
    partial last chunks and empty tiles (so the comparisons below see every
    loop exit)."""
    counts = tile_case["counts"]
    out, t_chk, pairs = tile.tile_fwd_plain(
        PSET, _torch_planes(tile_case), torch.from_numpy(counts))
    t_final = out[:, 3].amax(dim=1)
    assert pairs > 0
    if tile_case["kind"] == "dense":
        assert (counts == JSET.gaussian_cap).any()
        assert (counts > 2 * JSET.chunk).sum() > 10
        assert (t_final < 1e-4).sum() > 5
    else:
        assert counts.max() <= 2 * JSET.chunk
        assert (counts % JSET.chunk).any() and (counts == 0).any()
    torch.testing.assert_close(t_chk[:, -1], out[:, 3], rtol=0, atol=0)


def test_tile_forward_and_checkpoints_match_jax(tile_case):
    planes = _torch_planes(tile_case)
    counts = torch.from_numpy(tile_case["counts"])
    out, t_chk, _ = tile.tile_fwd_plain(PSET, planes, counts)
    np.testing.assert_allclose(out.numpy(), tile_case["out"], rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(t_chk.numpy(), tile_case["t_chk"], rtol=0,
                               atol=OUT_ATOL)
    inf = tile.composite_tiles_inference(PSET, planes, counts)
    np.testing.assert_allclose(inf.numpy(), tile_case["inference"], rtol=0,
                               atol=OUT_ATOL)


def test_tile_plane_gradients_match_jax(tile_case):
    planes = _torch_planes(tile_case, grad=True)
    out = tile.tile_composite(PSET, planes,
                              torch.from_numpy(tile_case["counts"]))
    out.backward(torch.from_numpy(tile_case["g"]))
    names = ("mux", "muy", "con_a", "con_b", "con_c", "opacity", "r", "g",
             "b")
    for i, name in enumerate(names):
        np.testing.assert_allclose(planes[i].grad.numpy(),
                                   tile_case["d_planes"][i],
                                   rtol=PLANE_RTOL, atol=PLANE_ATOL,
                                   err_msg=name)
    assert np.abs(tile_case["d_planes"][0]).max() > 1e-3


def test_tile_plain_versions_independent_of_batching(tile_case,
                                                     monkeypatch):
    from gsvc_tpu_torch.render import mirror

    planes = _torch_planes(tile_case)
    counts = torch.from_numpy(tile_case["counts"])
    g = torch.from_numpy(tile_case["g"])
    out, t_chk, pairs = tile.tile_fwd_plain(PSET, planes, counts)
    grads, _ = tile.tile_bwd_plain(PSET, planes, counts, t_chk, g)
    monkeypatch.setattr(mirror, "PLAIN_BATCH", 5)
    out5, t_chk5, pairs5 = tile.tile_fwd_plain(PSET, planes, counts)
    grads5, _ = tile.tile_bwd_plain(PSET, planes, counts, t_chk5, g)
    assert pairs5 == pairs > 0
    for a, b in ((out5, out), (t_chk5, t_chk), (grads5, grads)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_tile_refuses_other_precisions_and_bad_inputs():
    planes = tuple(torch.zeros((PSET.n_tiles, PSET.gaussian_cap))
                   for _ in range(9))
    counts = torch.zeros(PSET.n_tiles, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        tile.tile_composite(dataclasses.replace(PSET, compute_dtype="float16"),
                            planes, counts)
    with pytest.raises(ValueError, match="multiple"):
        tile.tile_composite(PSET, tuple(p[:-1] for p in planes),
                            counts[:-1])
    with pytest.raises(ValueError, match="counts"):
        tile.tile_composite(PSET, planes, counts.long())
    with pytest.raises(ValueError, match="9 planes"):
        tile.tile_composite(PSET, planes[:8], counts)


def test_plane_gather_gradient_matches_indexing():
    """The plane gather's backward (``index_add_``, padding slots into
    scratch rows) gives the gradient of plain indexing wherever the
    padding slots' cotangents are zero, as the composite's are (zero
    opacity is zero alpha): every slot's plane gradient lands on its
    gaussian's row."""
    from gsvc_tpu_torch.render.splat import gather_tile_planes_rows

    rng = np.random.default_rng(3)
    attrs = torch.tensor(rng.normal(size=(50, 9)).astype(np.float32),
                         requires_grad=True)
    lists = torch.from_numpy(rng.integers(-1, 50, (6, 16)).astype(np.int32))
    gs = [torch.from_numpy(rng.normal(size=(6, 16)).astype(np.float32))
          * (lists >= 0) for _ in range(9)]
    planes = gather_tile_planes_rows(attrs, lists)
    (got,) = torch.autograd.grad(planes, attrs, gs)
    a = attrs.detach().clone().requires_grad_(True)
    rows = a[lists.clamp_min(0).long()]
    op = torch.where(lists >= 0, rows[..., 5], torch.zeros_like(rows[..., 5]))
    want_planes = rows.unbind(-1)[:5] + (op,) + rows.unbind(-1)[6:]
    (want,) = torch.autograd.grad(want_planes, a, gs)
    for p, q in zip(planes, want_planes):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert (lists < 0).any() and float(got[0].abs().max()) > 0


def test_mirror_and_bidir_composites_refuse_unaligned_widths():
    """B1/B2 and B4 read the flip view from the forward lists, which is
    exact only at tile-aligned widths: called directly at another width
    they raise (the render paths take B5 there)."""
    from gsvc_tpu_torch.render import bidir, mirror

    attrs = torch.zeros((1, 4, 9))
    lists = torch.full((1, PSET.n_tiles, PSET.gaussian_cap), -1,
                       dtype=torch.int32)
    counts = torch.zeros((1, PSET.n_tiles), dtype=torch.int32)
    for fn in (bidir.bidir_composite_attrs, mirror.mirror_composite_attrs):
        with pytest.raises(ValueError, match="tile-aligned"):
            fn(PSET, attrs, lists, counts)


# ---------------------------------------------------------------------------
# The render paths at a width that is not a multiple of tile_w
# ---------------------------------------------------------------------------

def _port_state(jstate, grad=False):
    payload = {
        "anchors": {k: np.asarray(v)
                    for k, v in jstate.anchors._asdict().items()},
        "nets": jax.tree.map(np.asarray, jstate.nets._asdict()),
        "n_active": int(jstate.n_active),
        "x_bound_min": np.asarray(jstate.x_bound_min),
        "x_bound_max": np.asarray(jstate.x_bound_max)}
    state = state_from_numpy(payload)
    if grad:
        for t in state.anchors:
            t.requires_grad_(True)
    return state, GaussianConfig.from_model_config(ModelConfig(**MODEL))


@pytest.mark.parametrize("mode", ["FULL_PRECISION", "QUANTIZED_NOISE"])
def test_render_pair_at_unaligned_width_matches_jax(mode):
    """Images of the four views and the gradients of a weighted image sum
    (anchor leaves, one MLP and each view's means2d) against JAX's
    render_pair on its non-mirror branch (``_frame_views`` with the flip
    view projected and binned on its own, then ``pallas_tile_composite``)."""
    jstate, jcfg = tiny_model(seed=4)
    jset = settings_for(jcfg, 40)
    assert not can_mirror(RasterSettings(**dataclasses.asdict(jset)))
    rows = WINDOW_CAP * jcfg.n_offsets
    key = jax.random.PRNGKey(7)
    wts = np.array([1.0, 2.0, 3.0, 4.0], np.float32)

    def jloss(p, m2d):
        st = jstate._replace(anchors=p[0], nets=p[1])
        pr = jax_render_pair(st, jcfg, Z1, Z2, settings=jset,
                             window_cap=WINDOW_CAP, mode=JMode[mode],
                             key=key, rasterizer="pallas_train",
                             means2d=m2d, **GEOM)
        return jnp.sum(jnp.asarray(wts)[:, None, None, None]
                       * pr.images ** 2), (pr.images, [
                           (r.overflow, r.harmful_overflow, r.num_rendered)
                           for r in pr.renders])

    (_, (jimg, jcounts)), (jg, jgm) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        (jstate.anchors, jstate.nets), jnp.zeros((4, rows, 2)))

    state, cfg = _port_state(jstate, grad=True)
    mlp = state.nets.mlp_color["out"]["w"].requires_grad_(True)
    noise = (_jax_pair_noise(key, cfg, WINDOW_CAP)
             if mode == "QUANTIZED_NOISE" else None)
    m2d = torch.zeros((4, rows, 2), requires_grad=True)
    pr = render_pair(state, cfg, Z1, Z2, GEOM["x_min"], GEOM["y_min"],
                     GEOM["scale"], RasterSettings(**dataclasses.asdict(jset)),
                     WINDOW_CAP, GenerateMode[mode], means2d=m2d,
                     noise=noise)
    torch.sum(torch.from_numpy(wts)[:, None, None, None]
              * pr.images ** 2).backward()

    np.testing.assert_allclose(pr.images.detach().numpy(), np.asarray(jimg),
                               rtol=0, atol=IMG_ATOL)
    assert float(pr.images.detach().abs().max()) > 0.05
    for r, (ovf, harm, nrend) in zip(pr.renders, jcounts):
        assert (int(r.overflow), int(r.harmful_overflow),
                int(r.num_rendered)) == (int(ovf), int(harm), int(nrend))
    for name in ("feat", "offset", "scaling", "mask", "anchor"):
        np.testing.assert_allclose(
            getattr(state.anchors, name).grad.numpy(),
            np.asarray(getattr(jg[0], name)), rtol=GRAD_RTOL,
            atol=GRAD_ATOL, err_msg=name)
    assert np.abs(np.asarray(jg[0].feat)).max() > 1e-3
    np.testing.assert_allclose(
        mlp.grad.numpy(), np.asarray(jg[1].mlp_color["out"]["w"]),
        rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for view in range(4):
        np.testing.assert_allclose(m2d.grad[view].numpy(),
                                   np.asarray(jgm[view]), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"view {view}")
    # each view's screen gradient is its own: the flip views' differ
    assert np.abs(np.asarray(jgm[1])).max() > 1e-3
    assert not np.allclose(m2d.grad[0].numpy(), m2d.grad[1].numpy())


@pytest.mark.parametrize("width", [40, 48])
def test_frame_views_match_jax(width):
    """``_frame_views`` at an unaligned width (flip view binned on its own)
    and at an aligned one (flip lists and rows by mirror): planes, counts,
    overflow and dropped copies equal JAX's."""
    jstate, jcfg = tiny_model(seed=2)
    jset = settings_for(jcfg, width)
    from gsvc_tpu.models.gaussians import (
        generate_neural_gaussians as jax_gen, window_for_frame as jax_win,
    )
    start, inw = jax_win(jstate, jcfg, Z1, WINDOW_CAP)
    jg = jax_gen(jstate, jcfg, frame_z=Z1, cam_z=Z1, window_start=start,
                 in_window=inw, cap=WINDOW_CAP, mode=JMode.FULL_PRECISION)
    want = jax_frame_views(jg, Z1, GEOM["x_min"], GEOM["y_min"],
                           GEOM["scale"], jset, None, None)
    state, cfg = _port_state(jstate)
    from gsvc_tpu_torch.models.gaussians import (
        generate_neural_gaussians, window_for_frame,
    )
    ps, pinw = window_for_frame(state, cfg, Z1, WINDOW_CAP)
    pg = generate_neural_gaussians(state, cfg, frame_z=Z1, cam_z=Z1,
                                   window_start=ps, in_window=pinw,
                                   cap=WINDOW_CAP,
                                   mode=GenerateMode.FULL_PRECISION,
                                   decoded=False)
    got = _frame_views(pg, Z1, GEOM["x_min"], GEOM["y_min"], GEOM["scale"],
                       RasterSettings(**dataclasses.asdict(jset)), None,
                       None)
    slots = np.arange(jset.gaussian_cap)[None, :]
    for i, c in ((0, 1), (2, 3)):
        # padding slots copy row 0, which need not be a valid gaussian
        # (its generated position is not compared): opacity 0 there
        used = slots < np.asarray(want[c])[:, None]
        for p, q in zip(got[i], want[i]):
            np.testing.assert_allclose(p.detach().numpy()[used],
                                       np.asarray(q)[used], rtol=1e-6,
                                       atol=1e-5)
        np.testing.assert_array_equal(got[i][5].detach().numpy()[~used], 0)
    for i in (1, 3, 7, 8):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    assert int(got[5]) == int(want[5]) and int(got[6]) == int(want[6])
    assert int(got[3].sum()) > 0


def _views_pair(width, fn):
    jstate, jcfg = tiny_model(seed=5)
    jset = settings_for(jcfg, width)
    state, cfg = _port_state(jstate)
    pset = RasterSettings(**dataclasses.asdict(jset))
    return fn(jstate, jcfg, jset, state, cfg, pset)


@pytest.mark.parametrize("width", [40, 48], ids=["unaligned", "aligned"])
def test_render_frame_views_matches_jax(width):
    """Both views of one frame, forward-only: at an unaligned width
    through the single-view composite (JAX: ``composite_tiles_inference``
    over the two views' planes), at an aligned one through the mirror
    composite (JAX: ``mirror_composite_attrs``)."""
    def run(jstate, jcfg, jset, state, cfg, pset):
        javg, jimgs, jts, jaux = jax_views(
            jstate, jcfg, Z2, settings=jset, window_cap=WINDOW_CAP,
            rasterizer="pallas", inference=True, **GEOM)
        with torch.no_grad():
            avg, imgs, ts, aux = render_frame_views(
                state, cfg, Z2, GEOM["x_min"], GEOM["y_min"],
                GEOM["scale"], pset, WINDOW_CAP, inference=True)
        np.testing.assert_allclose(imgs.numpy(), np.asarray(jimgs), rtol=0,
                                   atol=IMG_ATOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(jts), rtol=0,
                                   atol=IMG_ATOL)
        np.testing.assert_allclose(avg.numpy(), np.asarray(javg), rtol=0,
                                   atol=IMG_ATOL)
        assert (int(aux[4]), int(aux[5])) == (int(jaux[4]), int(jaux[5]))
        assert float(avg.abs().max()) > 0.05
    _views_pair(width, run)


def test_render_frame_bidir_falls_back_at_unaligned_width():
    """``render_frame_bidir`` at an unaligned width returns
    ``render_frame_views``' average and forward transmittance, as JAX's
    fallback (decoded mode, ``rasterizer="pallas"``)."""
    def run(jstate, jcfg, jset, state, cfg, pset):
        javg, jt, _ = jax_bidir(jstate, jcfg, Z1, settings=jset,
                                window_cap=WINDOW_CAP,
                                mode=JMode.FULL_PRECISION,
                                rasterizer="pallas", **GEOM)
        with torch.no_grad():
            avg, t, aux = render_frame_bidir(
                state, cfg, Z1, GEOM["x_min"], GEOM["y_min"], GEOM["scale"],
                pset, WINDOW_CAP, mode=GenerateMode.FULL_PRECISION,
                decoded=False)
        np.testing.assert_allclose(avg.numpy(), np.asarray(javg), rtol=0,
                                   atol=IMG_ATOL)
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0,
                                   atol=IMG_ATOL)
        assert len(aux) == 6
    _views_pair(40, run)


@pytest.mark.parametrize("flip", [False, True])
def test_render_frame_single_view_matches_jax(flip):
    """``render_frame`` through the single-view drop-in
    (``rasterize_pallas_train``): the image and the gradient of its
    squared sum in the anchor features and ``means2d``."""
    jstate, jcfg = tiny_model(seed=6)
    jset = settings_for(jcfg, 40)
    rows = WINDOW_CAP * jcfg.n_offsets

    def jloss(feat, m2d):
        st = jstate._replace(anchors=jstate.anchors._replace(feat=feat))
        r = jax_render_frame(st, jcfg, Z1, settings=jset,
                             window_cap=WINDOW_CAP, flip=flip, means2d=m2d,
                             rasterizer="pallas_train", **GEOM)
        return jnp.sum(r.image ** 2), r.image

    (_, jimg), (jgf, jgm) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jstate.anchors.feat,
                                             jnp.zeros((rows, 2)))
    state, cfg = _port_state(jstate, grad=True)
    m2d = torch.zeros((rows, 2), requires_grad=True)
    r = render_frame(state, cfg, Z1, GEOM["x_min"], GEOM["y_min"],
                     GEOM["scale"], RasterSettings(**dataclasses.asdict(jset)),
                     WINDOW_CAP, flip=flip, means2d=m2d)
    torch.sum(r.image ** 2).backward()
    np.testing.assert_allclose(r.image.detach().numpy(), np.asarray(jimg),
                               rtol=0, atol=IMG_ATOL)
    np.testing.assert_allclose(state.anchors.feat.grad.numpy(),
                               np.asarray(jgf), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(m2d.grad.numpy(), np.asarray(jgm),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert np.abs(np.asarray(jgm)).max() > 1e-3
    # the forward-only drop-in (rasterize_pallas) gives the same image
    with torch.no_grad():
        r_inf = render_frame(state, cfg, Z1, GEOM["x_min"], GEOM["y_min"],
                             GEOM["scale"],
                             RasterSettings(**dataclasses.asdict(jset)),
                             WINDOW_CAP, flip=flip, rasterizer="pallas")
    torch.testing.assert_close(r_inf.image, r.image.detach(), rtol=0,
                               atol=0)
    assert int(r_inf.num_rendered) == int(r.num_rendered) > 0


def test_render_frame_averaged_matches_jax():
    """The two-render average (``render_frame_averaged``) at an unaligned
    width against JAX's, which composites with its jnp compositor: equal
    to float rounding here (no tile saturates, so the kernels' T_EPS
    early stop changes nothing)."""
    from gsvc_tpu.render.pipeline import render_frame_averaged as jax_avg
    from gsvc_tpu_torch.render.pipeline import render_frame_averaged

    jstate, jcfg = tiny_model(seed=7)
    jset = settings_for(jcfg, 40)
    jimg, jrf, _ = jax_avg(jstate, jcfg, Z2, settings=jset,
                           window_cap=WINDOW_CAP, **GEOM)
    state, cfg = _port_state(jstate)
    with torch.no_grad():
        img, rf, _ = render_frame_averaged(
            state, cfg, Z2, GEOM["x_min"], GEOM["y_min"], GEOM["scale"],
            RasterSettings(**dataclasses.asdict(jset)), WINDOW_CAP)
    assert float(rf.transmittance.min()) > 1e-3
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=0,
                               atol=IMG_ATOL)
    np.testing.assert_allclose(rf.transmittance.numpy(),
                               np.asarray(jrf.transmittance), rtol=0,
                               atol=IMG_ATOL)

