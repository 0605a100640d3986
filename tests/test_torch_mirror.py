"""The port's mirror composite (kernels B1/B2 through their plain PyTorch
versions on the CPU), ``render_pair`` and the quantisation primitives
against the JAX package on the same numpy-seeded inputs.

The JAX side runs ``mirror_composite_attrs`` (``rasterizer=
"pallas_train"``), which on the CPU is the TPU kernels B1/B2 in Pallas
interpret mode.  Tolerances:

* images 1e-5 (as ``test_pallas_batched_matches_jnp``): the same
  arithmetic, with the in-chunk transmittance taken as a running product
  here and as a log-space cumsum there — float rounding only;
* gradients rtol 2e-3 / atol 2e-4 (as
  ``test_means2d_gradients_pallas_matches_jnp``): the backward's suffix
  sums, its 1/(1 - alpha) (up to 100x amplification at ALPHA_MAX) and the
  moment sums over a tile's pixels are reduced in other orders, and the
  port takes the mean/conic moments about the gaussian's mean where the
  TPU kernel takes them about the tile centre.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.models.gaussians import (
    GenerateMode as JMode, get_anchor as jax_get_anchor,
    get_mask as jax_get_mask,
)
from gsvc_tpu.ops.quant import (
    ste_round as jax_ste_round,
    uniform_noise_quantize as jax_noise_quantize,
)
from gsvc_tpu.render.batched import render_pair as jax_render_pair
from gsvc_tpu.render.pallas_splat import mirror_composite_attrs as jax_mca
from gsvc_tpu.render.splat import (
    RasterSettings as JaxSettings, _bin_gaussians as jax_bin,
    attr_rows_from_proj as jax_attr_rows,
    gather_tile_planes_rows as jax_gather, project_gaussians as jax_project,
    tile_harmful_overflow as jax_harmful,
)
from gsvc_tpu_torch.convert import state_from_numpy
from gsvc_tpu_torch.models.gaussians import (
    GaussianConfig, GenerateMode, get_anchor, get_mask,
)
from gsvc_tpu_torch.config import ModelConfig
from gsvc_tpu_torch.ops.quant import ste_round, uniform_noise_quantize
from gsvc_tpu_torch.render import mirror
from gsvc_tpu_torch.render.batched import render_pair
from gsvc_tpu_torch.render.splat import (
    RasterSettings, gather_tile_planes_rows, tile_harmful_overflow,
)
from tests.test_batched import GEOM, WINDOW_CAP, Z1, Z2, settings_for, \
    tiny_model
from tests.test_splat import make_scene

IMG_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
JSET = JaxSettings(image_height=40, image_width=48, threshold=0.15,
                   tile_h=8, tile_w=16, gaussian_cap=64, chunk=16,
                   tiles_per_gaussian=32)
PSET = RasterSettings(**dataclasses.asdict(JSET))


def _frames(kind):
    """Two frames' attribute rows, tile lists and counts from the JAX
    projection and binning of seeded scenes.  ``dense``: 300 wide, nearly
    opaque gaussians — several chunks per tile, lists past the cap,
    saturated pixels and early stops; ``sparse``: one or two chunks per
    tile, the last one partial."""
    attrs, lists, counts = [], [], []
    for seed in (0, 1):
        m = 300 if kind == "dense" else 60
        xyz, color, op, sc, rot, valid = make_scene(m=m, seed=seed + 3)
        if kind == "dense":
            op = 0.9 + 0.09 * op
            sc = 6.0 * sc
        proj = jax_project(xyz, sc, rot, valid, 0.0, -1.0, -0.75, 24.0,
                           JSET)
        tl, cnt, _, _, _ = jax_bin(proj, JSET)
        opac = jnp.where(proj.valid[:, None], op, 0.0)
        attrs.append(jax_attr_rows(proj, opac, color))
        lists.append(tl)
        counts.append(cnt)
    return (np.array(jnp.stack(attrs)), np.array(jnp.stack(lists)),
            np.array(jnp.stack(counts)))


@pytest.fixture(scope="module", params=["sparse", "dense"])
def composite_case(request):
    """JAX forward and vjp (with and without per-view means2d) of the
    mirror composite on one case, with a seeded cotangent."""
    attrs, lists, counts = _frames(request.param)
    m = attrs.shape[1]
    rng = np.random.default_rng(11)
    g = rng.normal(size=(4 * JSET.n_tiles, 4,
                         JSET.tile_h * JSET.tile_w)).astype(np.float32)
    a, tl, c = jnp.asarray(attrs), jnp.asarray(lists), jnp.asarray(counts)
    out, vjp = jax.vjp(lambda x, m2d: jax_mca(JSET, x, tl, c, m2d), a,
                       jnp.zeros((4, m, 2)))
    da, dm = vjp(jnp.asarray(g))
    _, vjp0 = jax.vjp(lambda x: jax_mca(JSET, x, tl, c, None), a)
    (da0,) = vjp0(jnp.asarray(g))
    return dict(kind=request.param, attrs=attrs, lists=lists,
                counts=counts, g=g, out=np.asarray(out),
                d_attrs=np.asarray(da), d_m2d=np.asarray(dm),
                d_attrs_no_m2d=np.asarray(da0))


def _port_composite(case, with_m2d):
    attrs = torch.tensor(case["attrs"], requires_grad=True)
    m2d = None
    if with_m2d:
        m2d = torch.zeros((4, attrs.shape[1], 2), requires_grad=True)
    out = mirror.mirror_composite_attrs(
        PSET, attrs, torch.from_numpy(case["lists"]),
        torch.from_numpy(case["counts"]), m2d)
    out.backward(torch.from_numpy(case["g"]))
    return out.detach().numpy(), attrs.grad.numpy(), (
        m2d.grad.numpy() if with_m2d else None)


def test_mirror_case_covers_the_loop_stops(composite_case):
    """The dense case reaches several chunks per tile, early stops on
    saturated tiles and lists cut at the cap; the sparse one short lists
    with partial last chunks (so the comparisons below see every loop
    exit)."""
    counts = composite_case["counts"]
    out, t_chk, _ = mirror.mirror_fwd_plain(
        PSET, torch.from_numpy(composite_case["attrs"]),
        torch.from_numpy(composite_case["lists"]), torch.from_numpy(counts))
    t_final = out[:, 3].amax(dim=1)
    if composite_case["kind"] == "dense":
        assert (counts == JSET.gaussian_cap).any()
        assert (counts > 2 * JSET.chunk).sum() > 10
        assert (t_final < 1e-4).sum() > 5
    else:
        assert counts.max() <= 2 * JSET.chunk
        assert (counts % JSET.chunk).any()
    # slot n_chunks holds the final T
    torch.testing.assert_close(t_chk[:, -1], out[:, 3], rtol=0, atol=0)


def test_mirror_forward_matches_jax(composite_case):
    out, _, _ = _port_composite(composite_case, with_m2d=False)
    np.testing.assert_allclose(out, composite_case["out"], rtol=0,
                               atol=IMG_ATOL)


@pytest.mark.parametrize("with_m2d", [False, True])
def test_mirror_backward_matches_jax(composite_case, with_m2d):
    _, d_attrs, d_m2d = _port_composite(composite_case, with_m2d)
    want = composite_case["d_attrs" if with_m2d else "d_attrs_no_m2d"]
    for col in range(9):
        np.testing.assert_allclose(d_attrs[..., col], want[..., col],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"attribute column {col}")
    if with_m2d:
        for view in range(4):
            np.testing.assert_allclose(
                d_m2d[view], composite_case["d_m2d"][view],
                rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f"view {view}")


def test_plain_versions_independent_of_batching(composite_case,
                                                monkeypatch):
    """The plain versions walk grid rows in batches; a batch of 3 rows
    (views of one data tile split across batches) gives the same
    numbers."""
    args = [torch.from_numpy(composite_case[k])
            for k in ("attrs", "lists", "counts")]
    out, t_chk, pairs = mirror.mirror_fwd_plain(PSET, *args)
    g = torch.from_numpy(composite_case["g"])
    grads, _ = mirror.mirror_bwd_plain(PSET, *args, t_chk, g)
    monkeypatch.setattr(mirror, "PLAIN_BATCH", 3)
    out3, t_chk3, pairs3 = mirror.mirror_fwd_plain(PSET, *args)
    grads3, _ = mirror.mirror_bwd_plain(PSET, *args, t_chk3, g)
    assert pairs3 == pairs > 0
    torch.testing.assert_close(out3, out, rtol=0, atol=0)
    torch.testing.assert_close(t_chk3, t_chk, rtol=0, atol=0)
    torch.testing.assert_close(grads3, grads, rtol=0, atol=0)


def test_mirror_refuses_other_precisions_and_widths():
    attrs = torch.zeros((1, 4, 9))
    lists = torch.full((1, PSET.n_tiles, PSET.gaussian_cap), -1,
                       dtype=torch.int32)
    counts = torch.zeros((1, PSET.n_tiles), dtype=torch.int32)
    # the precision modes run (tests/test_torch_precision.py); a value
    # that is none of them raises
    for field in ("compute_dtype", "matmul_dtype"):
        other = dataclasses.replace(PSET, **{field: "float16"})
        with pytest.raises(ValueError, match=f"unknown {field}"):
            mirror.mirror_composite_attrs(other, attrs, lists, counts)
    narrow = dataclasses.replace(PSET, image_width=40)
    with pytest.raises(ValueError, match="tile-aligned"):
        mirror.mirror_composite_attrs(narrow, attrs, lists, counts)


def test_gather_and_harmful_overflow_match_jax(composite_case):
    attrs = composite_case["attrs"][0]
    lists = composite_case["lists"][0]
    want = jax_gather(jnp.asarray(attrs), jnp.asarray(lists))
    got = gather_tile_planes_rows(torch.from_numpy(attrs),
                                  torch.from_numpy(lists))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rng = np.random.default_rng(5)
    t = rng.uniform(0, 0.01, (JSET.image_height, JSET.image_width)
                    ).astype(np.float32)
    dropped = rng.integers(0, 4, JSET.n_tiles).astype(np.int32)
    assert int(tile_harmful_overflow(PSET, torch.from_numpy(t),
                                     torch.from_numpy(dropped))) == \
        int(jax_harmful(JSET, jnp.asarray(t), jnp.asarray(dropped)))


# ---------------------------------------------------------------------------
# render_pair
# ---------------------------------------------------------------------------

def _jax_pair_noise(key, cfg, window_cap):
    """The uniform draws JAX's QUANTIZED_NOISE generation takes from
    ``key`` (render_pair splits it per frame, generation per attribute)."""
    out = []
    for k in jax.random.split(key):
        k1, k2, k3 = jax.random.split(k, 3)
        shapes = ((window_cap, cfg.feat_dim), (window_cap, 6),
                  (window_cap, cfg.n_offsets, 3))
        out.append(tuple(
            torch.from_numpy(np.array(jax.random.uniform(
                kk, s, jnp.float32, -0.5, 0.5)))
            for kk, s in zip((k1, k2, k3), shapes)))
    return out


@pytest.mark.parametrize("mode", ["FULL_PRECISION", "QUANTIZED_NOISE"])
def test_render_pair_matches_jax(mode):
    """Images of the four views and the gradients of a weighted image sum
    (anchor features, offsets, scales, masks, one MLP and the per-view
    means2d) against JAX's render_pair on the mirror kernels."""
    jstate, jcfg = tiny_model(seed=4)
    jset = settings_for(jcfg, 48)
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
                       * pr.images ** 2), pr.images

    (_, jimg), (jg, jgm) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        (jstate.anchors, jstate.nets), jnp.zeros((4, rows, 2)))

    payload = {
        "anchors": {k: np.asarray(v)
                    for k, v in jstate.anchors._asdict().items()},
        "nets": jax.tree.map(np.asarray, jstate.nets._asdict()),
        "n_active": int(jstate.n_active),
        "x_bound_min": np.asarray(jstate.x_bound_min),
        "x_bound_max": np.asarray(jstate.x_bound_max)}
    state = state_from_numpy(payload)
    for t in state.anchors:
        t.requires_grad_(True)
    mlp = state.nets.mlp_color["out"]["w"].requires_grad_(True)
    cfg = GaussianConfig.from_model_config(ModelConfig(
        anchor_feature_dim=8, n_offsets=4, threshold=0.3,
        time_multi_res=4, offset_multi_res=4, log2=6, log2_2D=7,
        grid_feature_dim=2, resolutions_list=(6, 10),
        resolutions_list_2D=(12, 20)))
    pset = RasterSettings(**dataclasses.asdict(jset))
    noise = (_jax_pair_noise(key, cfg, WINDOW_CAP)
             if mode == "QUANTIZED_NOISE" else None)
    m2d = torch.zeros((4, rows, 2), requires_grad=True)
    pr = render_pair(state, cfg, Z1, Z2, GEOM["x_min"], GEOM["y_min"],
                     GEOM["scale"], pset, WINDOW_CAP, GenerateMode[mode],
                     means2d=m2d, noise=noise)
    loss = torch.sum(torch.from_numpy(wts)[:, None, None, None]
                     * pr.images ** 2)
    loss.backward()

    np.testing.assert_allclose(pr.images.detach().numpy(),
                               np.asarray(jimg), rtol=0, atol=IMG_ATOL)
    assert float(pr.images.detach().abs().max()) > 0.05
    for name in ("feat", "offset", "scaling", "mask", "anchor"):
        got = getattr(state.anchors, name).grad.numpy()
        want = np.asarray(getattr(jg[0], name))
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
    assert np.abs(np.asarray(jg[0].feat)).max() > 1e-3
    np.testing.assert_allclose(
        mlp.grad.numpy(), np.asarray(jg[1].mlp_color["out"]["w"]),
        rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for view in range(4):
        np.testing.assert_allclose(m2d.grad[view].numpy(),
                                   np.asarray(jgm[view]), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"view {view}")


# ---------------------------------------------------------------------------
# Straight-through accessors and quantisers
# ---------------------------------------------------------------------------

def _accessor_inputs():
    rng = np.random.default_rng(3)
    mask = rng.normal(0, 3, (12, 4, 1)).astype(np.float32)
    mask[0, 0, 0] = -4.59512  # sigmoid just around the 0.01 threshold
    anchor = rng.uniform(-0.7, 0.7, (12, 3)).astype(np.float32)
    lo = np.full((1, 3), -0.66, np.float32)
    return mask, anchor, lo, -lo


@pytest.mark.parametrize("accessor", ["mask", "anchor"])
def test_undecoded_accessors_pass_straight_through_gradients(accessor):
    """get_mask / get_anchor: forward values bit-identical to JAX's, and
    the gradient of a weighted sum equal to JAX's straight-through one
    (the sigmoid's, resp. the identity) — not zero."""
    from gsvc_tpu_torch.models.gaussians import AnchorState, ModelState

    mask, anchor, lo, hi = _accessor_inputs()
    w = np.random.default_rng(4).normal(
        size=mask.shape if accessor == "mask" else anchor.shape
    ).astype(np.float32)

    class _JA:  # the fields the JAX accessors read
        pass

    def jfn(x):
        ja = _JA()
        if accessor == "mask":
            ja.mask = x
            return jax_get_mask(ja)
        ja.anchors = _JA()
        ja.anchors.anchor = x
        ja.x_bound_min, ja.x_bound_max = jnp.asarray(lo), jnp.asarray(hi)
        return jax_get_anchor(ja)

    src = mask if accessor == "mask" else anchor
    jval = np.asarray(jfn(jnp.asarray(src)))
    jgrad = np.asarray(jax.grad(lambda x: jnp.sum(jfn(x) * w))(
        jnp.asarray(src)))

    x = torch.tensor(src, requires_grad=True)
    if accessor == "mask":
        anchors = AnchorState(*([None] * 3), x, *([None] * 3))
        val = get_mask(anchors)
    else:
        anchors = AnchorState(x, *([None] * 6))
        val = get_anchor(ModelState(anchors, None, 12, torch.from_numpy(lo),
                                    torch.from_numpy(hi)))
    torch.sum(val * torch.from_numpy(w)).backward()
    np.testing.assert_array_equal(val.detach().numpy(), jval)
    assert np.abs(jgrad).max() > 0
    np.testing.assert_allclose(x.grad.numpy(), jgrad, rtol=1e-6, atol=0)


def test_quantizers_match_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(0, 3, (64, 5)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    noise = np.array(jax.random.uniform(key, x.shape, jnp.float32, -0.5,
                                        0.5))
    want = np.asarray(jax_noise_quantize(jnp.asarray(x), 0.2, key))
    got = uniform_noise_quantize(torch.from_numpy(x), 0.2,
                                 noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    drawn = uniform_noise_quantize(torch.from_numpy(x), 0.2, gen) \
        - torch.from_numpy(x)
    assert drawn.abs().max() <= 0.1 + 1e-6 and drawn.std() > 0.03

    xt = torch.tensor(x, requires_grad=True)
    r = ste_round(xt, 0.25)
    np.testing.assert_array_equal(
        r.detach().numpy(), np.asarray(jax_ste_round(jnp.asarray(x), 0.25)))
    r.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))
