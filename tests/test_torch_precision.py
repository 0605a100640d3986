"""The compositing precision modes of the port — ``compute_dtype``
"bfloat16" and ``matmul_dtype`` "bf16x2" / "bfloat16" through kernels
B1/B2 (``mirror_composite_attrs``) and B4 (``bidir_composite_attrs``) —
held against the JAX package's same modes and the port's own float32, on
the CPU (the kernels' plain PyTorch versions; render/mirror.py's
docstring has the table of what each mode rounds).

The scene is ``tests/test_splat.py``'s ``make_scene`` at its tile and
chunk sizes (8x16 tiles, cap 64, chunk 16), two frames at a tile-aligned
width, projected and binned by the JAX package.  The JAX side runs
``mirror_composite_attrs`` and ``bidir_composite_attrs`` in Pallas
interpret mode, as tests/test_matmul_dtype.py does.  The bands are the
JAX package's own:

* ``matmul_dtype="bf16x2"``: image and transmittance atol 3e-4, gradient
  cosine > 0.999 with the norm ratio in (0.99, 1.01)
  (tests/test_matmul_dtype.py);
* ``compute_dtype="bfloat16"`` and ``matmul_dtype="bfloat16"`` (alone and
  together): image atol 2e-2, gradient cosine > 0.99
  (tests/test_pallas_train.py ``test_bf16_compute_close_to_fp32``).

Gradients are those of the 9 attribute columns and of both views' screen
means (``m2d``), each column on its own.  Port against JAX is a band, not
bits: XLA on the CPU may keep excess precision inside a fused bf16 chain
(the bf16 alphas of the two packages differ by up to ~2e-3 in the image).
The alpha alone is exact: the port's bf16 expression equals a numpy
emulation of JAX's, each step rounded in ``ml_dtypes.bfloat16``, bit for
bit.  B2's replay as the kernel computes it (the suffix from the colour
total) is emulated in float32 and held to the plain version at B2's card
tolerance in every mode, and ``cli.train --device cpu --set
pipeline.matmul_dtype=bfloat16`` fits, encodes and decodes a tiny GOP
through the modes' plain versions.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gsvc_tpu.render.pallas_splat import (
    bidir_composite_attrs as jax_bidir, mirror_composite_attrs as jax_mca,
)
from gsvc_tpu.render.splat import (
    _bin_gaussians as jax_bin, attr_rows_from_proj as jax_attr_rows,
    project_gaussians as jax_project,
)
from gsvc_tpu_torch.render import bidir, mirror
from gsvc_tpu_torch.render.bidir import (
    ALPHA_BF16, GRAD_BF16, TRANS_BF16, alpha_raw, check_precision,
    trans_factor,
)
from gsvc_tpu_torch.render.splat import T_EPS, RasterSettings
from tests.test_splat import GEOM, SETTINGS, make_scene

# test_splat's SETTINGS at a tile-aligned width (the mirror composites
# need one)
JSET = dataclasses.replace(SETTINGS, image_width=48)
PSET = RasterSettings(**dataclasses.asdict(JSET))
MODES = [("bfloat16", "float32"), ("float32", "bf16x2"),
         ("float32", "bfloat16"), ("bfloat16", "bfloat16")]
# (image atol, gradient cosine, norm ratio band or None)
BANDS = {("float32", "bf16x2"): (3e-4, 0.999, (0.99, 1.01))}
WIDE_BAND = (2e-2, 0.99, None)
BWD_REL_ERR = 2e-3          # B2's card tolerance (chip_smoke.py)


def _with(settings, mode):
    return dataclasses.replace(settings, compute_dtype=mode[0],
                               matmul_dtype=mode[1])


@functools.lru_cache(maxsize=1)
def _frames():
    """Two frames' attribute rows, tile lists and counts from the JAX
    projection and binning of make_scene (m = 80, opaque and wide:
    several chunks per tile, saturated pixels and tiles)."""
    attrs, lists, counts = [], [], []
    for seed in (0, 1):
        xyz, color, op, sc, rot, valid = make_scene(m=80, seed=seed + 3)
        op = 0.8 + 0.19 * op
        sc = 4.0 * sc
        proj = jax_project(xyz, sc, rot, valid, GEOM["frame_z"],
                           GEOM["x_min"], GEOM["y_min"], GEOM["scale"], JSET)
        tl, cnt, _, _, _ = jax_bin(proj, JSET)
        attrs.append(jax_attr_rows(
            proj, jnp.where(proj.valid[:, None], op, 0.0), color))
        lists.append(tl)
        counts.append(cnt)
    return (np.array(jnp.stack(attrs)), np.array(jnp.stack(lists)),
            np.array(jnp.stack(counts)))


def _jax_run(mode, attrs, lists, counts, g):
    js = _with(JSET, mode)
    a, tl, c = jnp.asarray(attrs), jnp.asarray(lists), jnp.asarray(counts)
    out, vjp = jax.vjp(lambda x, m2d: jax_mca(js, x, tl, c, m2d), a,
                       jnp.zeros((4, attrs.shape[1], 2)))
    da, dm = vjp(jnp.asarray(g))
    img, tau = jax_bidir(js, a, tl, c)
    return dict(out=np.asarray(out), d_attrs=np.asarray(da),
                d_m2d=np.asarray(dm), b4=(np.asarray(img), np.asarray(tau)))


def _port_run(mode, attrs, lists, counts, g):
    ps = _with(PSET, mode)
    a = torch.tensor(attrs, requires_grad=True)
    m2d = torch.zeros((4, attrs.shape[1], 2), requires_grad=True)
    tl, c = torch.from_numpy(lists), torch.from_numpy(counts)
    out = mirror.mirror_composite_attrs(ps, a, tl, c, m2d)
    out.backward(torch.from_numpy(g))
    img, tau = bidir.bidir_composite_attrs(ps, a.detach(), tl, c)
    return dict(out=out.detach().numpy(), d_attrs=a.grad.numpy(),
                d_m2d=m2d.grad.numpy(), b4=(img.numpy(), tau.numpy()))


@pytest.fixture(scope="module")
def runs():
    """Both packages' forward, gradients and B4 frame in every mode (and
    float32) on the same inputs and seeded cotangent."""
    attrs, lists, counts = _frames()
    g = np.random.default_rng(11).normal(
        size=(4 * JSET.n_tiles, 4, JSET.tile_h * JSET.tile_w)).astype(
            np.float32)
    res = {}
    for mode in [("float32", "float32")] + MODES:
        res[mode] = (_jax_run(mode, attrs, lists, counts, g),
                     _port_run(mode, attrs, lists, counts, g))
    return dict(res=res, inputs=(attrs, lists, counts), g=g)


def _grad_columns(r):
    """Each gradient column on its own: the 9 attribute columns and the
    per-view screen-mean columns."""
    return ([r["d_attrs"][..., k] for k in range(9)]
            + [r["d_m2d"][..., k] for k in range(2)])


def _assert_band(got, want, band, what):
    atol, min_cos, ratio = band
    np.testing.assert_allclose(got["out"], want["out"], atol=atol, rtol=0,
                               err_msg=f"{what}: image/T")
    for k, (a, b) in enumerate(zip(_grad_columns(want), _grad_columns(got))):
        a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30)
        assert cos > min_cos, f"{what}: column {k} gradient cosine {cos}"
        if ratio is not None:
            r = np.linalg.norm(b) / (np.linalg.norm(a) + 1e-30)
            assert ratio[0] < r < ratio[1], f"{what}: column {k} ratio {r}"


def test_case_reaches_several_chunks_and_saturation(runs):
    attrs, lists, counts = runs["inputs"]
    assert (counts > 2 * JSET.chunk).sum() >= 4
    t_final = runs["res"][("float32", "float32")][1]["out"][:, 3]
    # saturated pixels, and tiles that stop before their last chunk
    assert (t_final < T_EPS).sum() >= 100
    assert (t_final.max(axis=1) < T_EPS).sum() >= 1


@pytest.mark.parametrize("mode", MODES, ids="/".join)
def test_mirror_modes_match_jax_and_float32(runs, mode):
    """Both views' image and T, and every gradient column, within JAX's
    band of JAX's same mode and of the port's own float32."""
    band = BANDS.get(mode, WIDE_BAND)
    want_jax, got = runs["res"][mode]
    _assert_band(got, want_jax, band, f"{mode} vs JAX")
    _assert_band(got, runs["res"][("float32", "float32")][1], band,
                 f"{mode} vs the port's float32")
    # the port's float32 itself is JAX's float32 (tests/test_torch_mirror.py)
    f_jax, f_port = runs["res"][("float32", "float32")]
    np.testing.assert_allclose(f_port["out"], f_jax["out"], atol=1e-5)


@pytest.mark.parametrize("mode", MODES, ids="/".join)
def test_bidir_modes_match_jax_and_float32(runs, mode):
    atol = BANDS.get(mode, WIDE_BAND)[0]
    want_jax, got = runs["res"][mode]
    f32 = runs["res"][("float32", "float32")][1]
    for i in range(2):
        np.testing.assert_allclose(got["b4"][i], want_jax["b4"][i],
                                   atol=atol, rtol=0)
        np.testing.assert_allclose(got["b4"][i], f32["b4"][i], atol=atol,
                                   rtol=0)


def test_modes_move_the_output(runs):
    """Each mode is taken: compute_dtype bfloat16 and matmul_dtype
    bfloat16 change the image, bf16x2 leaves the forward float32's (its
    in-chunk transmittance is float32, render/mirror.py) and changes the
    gradients only."""
    f32 = runs["res"][("float32", "float32")][1]
    for mode in MODES:
        got = runs["res"][mode][1]
        moved = not np.array_equal(got["out"], f32["out"])
        assert moved == (mode != ("float32", "bf16x2")), mode
        assert not np.array_equal(got["d_attrs"], f32["d_attrs"]), mode


def test_bidir_composite_honours_the_precision_fields():
    """B4's entry takes the settings' modes: with matmul_dtype "bfloat16"
    its frame differs from float32's and equals the plain version in
    that mode (before, ``bidir_composite_attrs`` composited float32
    under any setting)."""
    attrs, lists, counts = (torch.from_numpy(x.copy()) for x in _frames())
    bf = _with(PSET, ("float32", "bfloat16"))
    img, tau = bidir.bidir_composite_attrs(bf, attrs, lists, counts)
    img32, tau32 = bidir.bidir_composite_attrs(PSET, attrs, lists, counts)
    # the in-chunk transmittance moves the image; the chunks' totals, and
    # so the total transmittance, stay float32
    assert not torch.equal(img, img32) and torch.equal(tau, tau32)
    want = bidir.bidir_composite_plain(bf, attrs, lists, counts)
    assert torch.equal(img, want[0]) and torch.equal(tau, want[1])


def test_bf16x2_with_bf16_compute_equals_bf16_compute():
    """compute_dtype "bfloat16" already rounds the backward's products,
    and bf16x2's transmittance is float32: the two settings are one
    function."""
    attrs, lists, counts = (torch.from_numpy(x.copy()) for x in _frames())
    outs = []
    for mode in (("bfloat16", "float32"), ("bfloat16", "bf16x2")):
        a = attrs.clone().requires_grad_(True)
        out = mirror.mirror_composite_attrs(_with(PSET, mode), a, lists,
                                            counts)
        out.sum().backward()
        outs.append((out.detach(), a.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def _jax_bf16_alpha(rows, d0f, d1f):
    """JAX's bf16 alpha (pallas_splat.py ``_chunk_alpha``) in numpy, every
    step rounded in ml_dtypes.bfloat16, widened to float32."""
    bf = ml_dtypes.bfloat16
    d0, d1 = d0f.astype(bf), d1f.astype(bf)
    a, b, c, op = (rows[..., k:k + 1].astype(bf) for k in (2, 3, 4, 5))
    q = a * d0 * d0 + bf(2.0) * b * d0 * d1 + c * d1 * d1
    return (op * np.exp(bf(-0.5) * q)).astype(np.float32)


def test_bf16_alpha_is_jax_expression_bit_for_bit():
    """The port's bf16 alpha (``alpha_raw``, which the kernels follow bit
    for bit) against JAX's expression emulated step by step in
    ml_dtypes.bfloat16, on every (copy, pixel) pair of the scene's tiles:
    equal bits."""
    attrs, lists, counts = _frames()
    ft = lists.shape[0] * lists.shape[1]
    tl = mirror._mirror_tiles(_with(PSET, ("bfloat16", "float32")),
                              torch.from_numpy(attrs),
                              torch.from_numpy(lists),
                              torch.from_numpy(counts),
                              torch.arange(0, 2 * ft))
    r = tl.rows                                              # [S, cap, 9]
    mu_x = r[..., 0] - tl.cx[:, None]
    mu_y = r[..., 1] - tl.cy[:, None]
    d0 = tl.xs[:, None, :] - mu_x[..., None]                 # [S, cap, P]
    d1 = tl.ys[None, None, :] - mu_y[..., None]
    got = alpha_raw(r, d0, d1, ALPHA_BF16).numpy()
    want = _jax_bf16_alpha(r.numpy(), d0.numpy(), d1.numpy())
    live = want > 0
    assert live.sum() > 10_000
    differ = np.argwhere(got.view(np.int32) != want.view(np.int32))
    assert differ.size == 0, (
        f"{len(differ)} of {got.size} alphas differ, first at "
        f"{differ[:5].tolist()}: {got[tuple(differ[0])]} vs "
        f"{want[tuple(differ[0])]}")


def test_check_precision():
    """Every known combination runs through every composite (B1/B2, B4,
    B5f/B5b, B6f/B6b) with its mode bits; an unknown value raises."""
    bits = {("float32", "float32"): 0,
            ("bfloat16", "float32"): ALPHA_BF16 | GRAD_BF16,
            ("float32", "bf16x2"): GRAD_BF16,
            ("float32", "bfloat16"): TRANS_BF16 | GRAD_BF16,
            ("bfloat16", "bfloat16"): ALPHA_BF16 | TRANS_BF16 | GRAD_BF16,
            ("bfloat16", "bf16x2"): ALPHA_BF16 | GRAD_BF16}
    for mode, want in bits.items():
        assert check_precision(_with(PSET, mode)) == want
    for field in ("compute_dtype", "matmul_dtype"):
        s = dataclasses.replace(PSET, **{field: "float16"})
        with pytest.raises(ValueError, match=f"unknown {field}"):
            check_precision(s)


def replay_rows(settings, tl, chk, o4, g4, round_suffix=False):
    """The replay that kernels B2, B5b and B6b share (csrc/replay.cuh
    ``replay_chunk``) in float32 on the CPU, for the composite steps of
    ``tl`` (a ``mirror._Tiles``) with their checkpoints ``chk`` [S,
    n_chunks + 1, P] (the last the final T), forward outputs ``o4`` and
    cotangents ``g4`` [S, 4, P], all steps at once, in the tiles' mode:
    the suffix from the colour total (the bf16-rounded cotangent dotted
    with out4) minus a running sum of w (c . g), dL/da's gc from the
    bf16-rounded colours, bf16(dq), bf16(d) and bf16(w) in the sums, the
    mode's transmittance factors.  ``round_suffix`` takes the running
    sum's terms as bf16(w) bf16(c . g) instead, as JAX rounds its suffix
    terms.  Returns per-step gradients [S, 9, cap].
    (tests/test_torch_mirror_replay.py emulates the float32 walk's warp
    skips and shows they change no bit.)"""
    q = mirror._bf16_round if tl.mode & GRAD_BF16 else (lambda x: x)
    chunk, n_chunks = tl.chunk, tl.n_chunks
    n_steps = chk.shape[0]
    g3 = q(g4[:, 0:3])
    total = chk[:, n_chunks] * g4[:, 3] + (g3 * o4[:, 0:3]).sum(dim=1)
    pre = torch.zeros_like(total)
    grads = torch.zeros(n_steps, 9, settings.gaussian_cap)
    alive = torch.ones(n_steps, dtype=torch.bool)
    for p in range(n_chunks):
        alive &= (p < tl.n_used) & (chk[:, p].amax(dim=1) >= T_EPS)
        idx = alive.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        slot, alpha, act, d0, d1, r = tl.load(p, idx)
        t0, e = chk[idx, p], torch.ones(len(idx), total.shape[1])
        sums = torch.zeros(len(idx), 9, chunk)
        for j in range(chunk):
            a = alpha[:, j]
            tb = t0 * e
            live = tb >= T_EPS
            w = torch.where(live, a * tb, torch.zeros_like(a))
            gc = (q(r[:, j, 6:9, None]) * g3[idx]).sum(dim=1)
            pre[idx] += (q(w) * q(gc) if round_suffix else
                         w * (r[:, j, 6:9, None] * g3[idx]).sum(dim=1))
            d_alpha = torch.where(
                live & act[:, j], gc * tb - (total[idx] - pre[idx])
                / torch.clamp(1.0 - a, min=1e-6), torch.zeros_like(a))
            dq = q(d_alpha * a * (-0.5))
            dd0, dd1 = q(d0[:, j]), q(d1[:, j])
            sums[:, :, j] = torch.stack(
                [dq, dq * dd0, dq * dd1, dq * dd0 * dd0, dq * dd0 * dd1,
                 dq * dd1 * dd1] + [q(w) * g3[idx, k] for k in range(3)],
                dim=1).sum(dim=2)
            e = e * trans_factor(a, 1.0 - a, tl.mode)
        con_a, con_b, con_c = r[..., 2], r[..., 3], r[..., 4]
        vals = torch.stack([
            -(2.0 * con_a * sums[:, 1] + 2.0 * con_b * sums[:, 2]),
            -(2.0 * con_c * sums[:, 2] + 2.0 * con_b * sums[:, 1]),
            sums[:, 3], 2.0 * sums[:, 4], sums[:, 5],
            -2.0 * sums[:, 0] / torch.clamp(r[..., 5], min=1e-12),
            sums[:, 6], sums[:, 7], sums[:, 8]], dim=1)
        grads[idx[:, None, None], torch.arange(9)[None, :, None],
              slot[:, None, :]] = vals
    return grads


def _replay_emulation(settings, attrs, lists, counts, out4, t_chk, g_out,
                      round_suffix=False):
    """Kernel B2's replay (``replay_rows``) of every step of the mirror
    grid, in grid order."""
    n_grid = 2 * attrs.shape[0] * settings.n_tiles
    tl = mirror._mirror_tiles(settings, attrs, lists, counts,
                              torch.arange(n_grid))
    return replay_rows(settings, tl, t_chk[tl.out_row], out4[tl.out_row],
                       g_out[tl.out_row], round_suffix)


def _b2_case(mode):
    from tests.test_torch_mirror_replay import _case

    settings, attrs, lists, counts = _case("saturated")
    settings = _with(settings, mode)
    out4, t_chk, _ = mirror.mirror_fwd_plain(settings, attrs, lists, counts)
    g = torch.from_numpy(np.random.default_rng(11).normal(
        size=out4.shape).astype(np.float32))
    want, _ = mirror.mirror_bwd_plain(settings, attrs, lists, counts, t_chk,
                                      g)
    return (settings, attrs, lists, counts, out4, t_chk, g), want


def _rel_errs(got, want):
    return [float((got[:, k] - want[:, k]).abs().max())
            / max(float(want[:, k].abs().max()), 1e-30) for k in range(9)]


@pytest.mark.parametrize("mode", MODES, ids="/".join)
def test_b2_replay_algebra_matches_plain(mode):
    """What kernel B2 computes in each mode (its suffix is the colour
    total minus a running sum, where the plain version sums the later
    terms) stays within B2's card tolerance of the plain version: 2e-3
    of each attribute's largest gradient.  Rounding dq, d and w to bf16
    can move a term by one bf16 step where the two sums differ in their
    last float32 bits, so the difference is larger than float32's
    (~2e-6) but far inside the tolerance."""
    args, want = _b2_case(mode)
    errs = _rel_errs(_replay_emulation(*args), want)
    assert max(errs) <= BWD_REL_ERR, errs


def test_b2_suffix_terms_keep_float32():
    """Why B2's running sum keeps the float32 terms w (c . g): with JAX's
    bf16-rounded terms, each suffix (the colour total minus the running
    sum) would carry the rounding of every term walked so far, and B2
    would leave its tolerance of the plain version (render/mirror.py)."""
    args, want = _b2_case(("float32", "bf16x2"))
    errs = _rel_errs(_replay_emulation(*args, round_suffix=True), want)
    assert max(errs) > 5 * BWD_REL_ERR, errs


def test_cli_train_runs_the_bfloat16_mode(tmp_path, monkeypatch, capsys):
    """``cli.train --device cpu --set pipeline.matmul_dtype=bfloat16`` on
    the verify notes' tiny GOP (6 frames of 64x48, 12 steps, then
    encode, decode and the decoded evaluation): every
    composite of the fit and of the evaluations takes the mode, and the
    run ends in its results line."""
    from PIL import Image

    from gsvc_tpu_torch.cli.train import main
    from tests.test_torch_cli_surface import SMALL_YAML
    from tests.test_train import synthetic_video

    (tmp_path / "frames").mkdir()
    for i, fr in enumerate(synthetic_video(t=6, h=48, w=64)):
        Image.fromarray((fr * 255).astype(np.uint8)).save(
            tmp_path / "frames" / f"f_{i:03d}.png")
    (tmp_path / "small.yaml").write_text(SMALL_YAML)
    seen = {"mirror": set(), "bidir": set()}
    composite_rows, bidir_plain = mirror.composite_rows, \
        bidir.bidir_out4_plain

    def rows(settings, tl):
        seen["mirror"].add(tl.mode)
        return composite_rows(settings, tl)

    def b4(settings, *a):
        seen["bidir"].add((settings.compute_dtype, settings.matmul_dtype))
        return bidir_plain(settings, *a)

    monkeypatch.setattr(mirror, "composite_rows", rows)
    monkeypatch.setattr(bidir, "bidir_out4_plain", b4)
    res = main(["--source_path", str(tmp_path / "frames"), "--model_path",
                str(tmp_path / "out"), "--config_path",
                str(tmp_path / "small.yaml"), "--device", "cpu",
                "--iterations", "12", "--set",
                "pipeline.matmul_dtype=bfloat16"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == res
    assert res["bpp"] > 0 and np.isfinite(res["decoded_psnr"])
    assert seen == {"mirror": {TRANS_BF16 | GRAD_BF16},
                    "bidir": {("float32", "bfloat16")}}
