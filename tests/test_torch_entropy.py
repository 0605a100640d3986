"""The port's quantisers and rate estimators against the JAX package's on
the same numpy-seeded inputs: ``ste_binary``, ``ste_round`` and
``uniform_noise_quantize`` with per-anchor steps, ``ste_quantize``, the
anchor index quantisation, ``gaussian_bits`` (both branches, with the
likelihood floor's asymmetric gradient rule), ``bernoulli_bits``, the
factorised model and ``binary_vxl_size``; then ``calc_entropy_context``
and ``estimate_final_bits`` on a model state carried over from JAX.

Tolerances: exact where both sides compute the same float32 operations
on the same values (signs, rounding, clamps, the anchor grid); rtol 1e-5
for the transcendental paths (log, softplus, the MLPs: the two
libraries' float32 kernels differ by a few ulps); ``gaussian_bits``
through its likelihood (see the test: a difference of two CDFs near 1,
where erf's ulps are amplified in the bits); the entropy context
to rtol 1e-5 / atol 1e-6 (it feeds float32 MLPs with hash features);
estimated bits to rtol 1e-5 (sums of ~10^4 terms).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.codec.estimate import estimate_final_bits as jax_estimate
from gsvc_tpu.models.gaussians import (
    calc_entropy_context as jax_context, get_anchor as jax_get_anchor,
)
from gsvc_tpu.ops import entropy as je
from gsvc_tpu.ops import quant as jq
from gsvc_tpu_torch.codec.estimate import estimate_final_bits
from gsvc_tpu_torch.config import ModelConfig
from gsvc_tpu_torch.convert import state_from_numpy
from gsvc_tpu_torch.models.gaussians import (
    GaussianConfig, calc_entropy_context, get_anchor,
)
from gsvc_tpu_torch.ops import entropy as pe
from gsvc_tpu_torch.ops import quant as pq
from tests.test_batched import tiny_model

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _grad_torch(fn, *arrays):
    """(value, gradient of sum(value * w) w.r.t. the first argument)."""
    x = _t(arrays[0]).clone().requires_grad_(True)
    out = fn(x, *[_t(a) for a in arrays[1:]])
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=tuple(out.shape)).astype(np.float32))
    (out * w).sum().backward()
    return out.detach().numpy(), x.grad.numpy(), w.numpy()


def _grad_jax(fn, w, *arrays):
    xs = [jnp.asarray(a) for a in arrays]
    out = fn(*xs)
    g = jax.grad(lambda x: jnp.sum(fn(x, *xs[1:]) * w))(xs[0])
    return np.asarray(out), np.asarray(g)


def test_ste_binary_matches_jax():
    x = np.random.default_rng(0).uniform(-2, 2, 1000).astype(np.float32)
    x[:3] = [0.0, -1.0, 1.0]
    out, g, w = _grad_torch(pq.ste_binary, x)
    jout, jg = _grad_jax(jq.ste_binary, w, x)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(g, jg)
    assert set(np.unique(out)) == {-1.0, 1.0}
    assert np.all(g[np.abs(x) > 1] == 0) and np.all(g[np.abs(x) < 1] != 0)


def test_per_anchor_quantisers_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 2, (64, 5)).astype(np.float32)
    q = np.exp(rng.uniform(-1, 1, (64, 1))).astype(np.float32) * 0.2
    mean = np.float32(x.mean())
    out, g, w = _grad_torch(lambda a, b: pq.ste_round(a, b, _t(mean)), x, q)
    jout, jg = _grad_jax(lambda a, b: jq.ste_round(a, b, mean), w, x, q)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(g, jg)

    noise = rng.uniform(-0.5, 0.5, x.shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jq.uniform_noise_quantize(jnp.asarray(x),
                                                jnp.asarray(q), key,
                                                x_mean=mean))
    jnoise = np.asarray(jax.random.uniform(key, x.shape, jnp.float32, -0.5,
                                           0.5))
    got = pq.uniform_noise_quantize(_t(x), _t(q), x_mean=_t(mean),
                                    noise=_t(jnoise)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        pq.ste_quantize(_t(x), _t(q), -3, 3).numpy(),
        np.asarray(jq.ste_quantize(jnp.asarray(x), jnp.asarray(q), -3, 3)))
    del noise


def test_anchor_indices_match_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(-1.2, 1.2, (500, 3)).astype(np.float32)
    lo = np.array([[-1.1, -0.8, -0.3]], np.float32)
    hi = -lo
    idx, interval, mn = pq.quantize_anchor_indices(_t(a), _t(lo), _t(hi))
    jidx, jint, jmn = jq.quantize_anchor_indices(jnp.asarray(a),
                                                 jnp.asarray(lo),
                                                 jnp.asarray(hi))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(interval.numpy(), np.asarray(jint))
    np.testing.assert_array_equal(
        pq.dequantize_anchor(idx, interval, mn).numpy(),
        np.asarray(jq.dequantize_anchor(jidx, jint, jmn)))
    np.testing.assert_array_equal(
        pq.dequantize_anchor(idx, interval, mn).numpy(),
        pq.quantize_anchor(_t(a), _t(lo), _t(hi)).detach().numpy())


@pytest.mark.parametrize("quantized", [False, True])
def test_gaussian_bits_match_jax(quantized):
    rng = np.random.default_rng(5)
    n = 2000
    x = rng.normal(0, 3, (n, 1)).astype(np.float32)
    if quantized:
        x = np.round(x)
    mean = rng.normal(0, 1, (n, 1)).astype(np.float32)
    scale = rng.uniform(0.05, 2, (n, 1)).astype(np.float32)
    q = np.exp(rng.uniform(-1, 1, (n, 1))).astype(np.float32) * 0.5
    # 100 values in the tail, 4.2 to 5.2 scales from the mean: likelihood
    # under the 2^-16 floor, CDF slopes still nonzero
    scale[:100], q[:100] = 0.5, 0.5
    x[:100] = np.round(2 * mean[:100] + 5.2) if quantized \
        else mean[:100] + 2.6

    def port(m, xx, s, qq):
        return pe.gaussian_bits(xx, m, s, qq, quantized=quantized)

    def jaxf(m, xx, s, qq):
        return je.gaussian_bits(xx, m, s, qq, quantized=quantized)

    out, g, w = _grad_torch(port, mean, x, scale, q)
    jout, jg = _grad_jax(jaxf, w, mean, x, scale, q)
    # bits = -log2 of a difference of two CDFs: the libraries' float32
    # erf differ by up to 3e-7 (2.5 ulps of 1), so the likelihoods agree
    # to 1e-6 and the bits to that over the likelihood — compared directly
    # where the likelihood exceeds 0.05, through the likelihood elsewhere
    lik, jlik = 2.0 ** -out, 2.0 ** -jout
    np.testing.assert_allclose(lik, jlik, rtol=0, atol=1e-6)
    big = jlik > 0.05
    assert big.sum() > n // 4
    np.testing.assert_allclose(out[big], jout[big], rtol=RTOL, atol=3e-5)
    np.testing.assert_allclose(g[big], jg[big], rtol=1e-4, atol=1e-5)
    # the gradient of the likelihood, d(2^-bits) = -ln2 2^-bits d(bits)
    np.testing.assert_allclose(g * lik, jg * jlik, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(out[:100], 16.0)
    np.testing.assert_array_equal(jout[:100], 16.0)
    # at the floor the likelihood's gradient (-w / (L ln 2)) passes only
    # where it is negative, i.e. where w > 0
    assert np.all((g[:100] == 0) == (w[:100] < 0))
    assert np.all((jg[:100] == 0) == (w[:100] < 0))


def test_bernoulli_and_binary_sizes_match_jax():
    rng = np.random.default_rng(6)
    x = np.where(rng.random(3000) < 0.3, 1.0, -1.0).astype(np.float32)
    p = rng.uniform(0, 1, 3000).astype(np.float32)
    p[:2] = [0.0, 1.0]
    np.testing.assert_allclose(
        pe.bernoulli_bits(_t(x), _t(p)).numpy(),
        np.asarray(je.bernoulli_bits(jnp.asarray(x), jnp.asarray(p))),
        rtol=RTOL)
    b = (x + 1) / 2
    got = pe.binary_vxl_size(_t(b))
    want = je.binary_vxl_size(jnp.asarray(b))
    for gv, wv in zip(got[:3], want[:3]):
        np.testing.assert_allclose(float(gv), float(wv), rtol=RTOL)
    assert got[3] == want[3] == 3000


def test_factorized_bits_match_jax():
    params = pe.factorized_entropy_init(3)
    jparams = je.factorized_entropy_init(jax.random.PRNGKey(0), 3)
    for name in ("matrices", "biases", "factors"):
        for a, b in zip(params[name], jparams[name]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = np.random.default_rng(7).normal(0, 4, (400, 3)).astype(np.float32)
    out, g, w = _grad_torch(lambda xx: pe.factorized_bits(params, xx, 0.5),
                            x)
    jout, jg = _grad_jax(lambda xx: je.factorized_bits(jparams, xx, 0.5), w,
                         x)
    np.testing.assert_allclose(out, jout, rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-5)


def _carried_state():
    """A JAX model state with a random hash table and masks, and its
    port counterpart."""
    jstate, jcfg = tiny_model(seed=9)
    rng = np.random.default_rng(9)
    nets = jstate.nets._replace(hash_table=jnp.asarray(rng.uniform(
        -1, 1, jstate.nets.hash_table.shape).astype(np.float32)))
    anchors = jstate.anchors._replace(mask=jnp.asarray(rng.normal(
        0, 4, jstate.anchors.mask.shape).astype(np.float32)))
    jstate = jstate._replace(nets=nets, anchors=anchors)
    payload = {
        "anchors": {k: np.asarray(v)
                    for k, v in jstate.anchors._asdict().items()},
        "nets": jax.tree.map(np.asarray, jstate.nets._asdict()),
        "n_active": int(jstate.n_active),
        "x_bound_min": np.asarray(jstate.x_bound_min),
        "x_bound_max": np.asarray(jstate.x_bound_max)}
    cfg = GaussianConfig.from_model_config(ModelConfig(
        anchor_feature_dim=8, n_offsets=4, threshold=0.3, time_multi_res=4,
        offset_multi_res=4, log2=6, log2_2D=7, grid_feature_dim=2,
        resolutions_list=(6, 10), resolutions_list_2D=(12, 20)))
    return jstate, jcfg, state_from_numpy(payload), cfg


@pytest.mark.parametrize("decoded", [False, True])
def test_entropy_context_matches_jax(decoded):
    jstate, jcfg, state, cfg = _carried_state()
    jec = jax_context(jstate, jcfg, jax_get_anchor(jstate, decoded),
                      decoded)
    ec = calc_entropy_context(state, cfg, get_anchor(state, decoded),
                              decoded)
    for name, got in ec._asdict().items():
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(getattr(jec, name)),
                                   rtol=RTOL, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("backend", ["xla", "lanegather", "bogus"])
def test_hash_backend_routes_by_device(backend):
    """``hash_backend`` does not pick the route: every known value gives
    the "auto" context (the plain encode on CPU tensors), and an unknown
    one raises."""
    _, _, state, cfg = _carried_state()
    other = dataclasses.replace(cfg, hash_backend=backend)
    anchor = get_anchor(state)
    if backend == "bogus":
        with pytest.raises(ValueError, match="hash_backend"):
            calc_entropy_context(state, other, anchor)
        return
    want = calc_entropy_context(state, cfg, anchor)
    got = calc_entropy_context(state, other, anchor)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_estimate_final_bits_matches_jax():
    jstate, jcfg, state, cfg = _carried_state()
    want = jax_estimate(jstate, jcfg)
    got = estimate_final_bits(state, cfg)
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=RTOL, err_msg=name)
    np.testing.assert_allclose(got.total, want.total, rtol=RTOL)
    assert got.bit_feat > 0 and got.bit_masks > 0


@pytest.mark.parametrize("mode", ["ENTROPY", "STE_ENTROPY"])
def test_rate_gradients_against_float64(mode):
    """The window rate's gradients w.r.t. the anchor positions and the
    offset entropy net's output bias (the step test's state, one frame)
    in float32, against the port's float64 evaluation.  They pass through
    d(bits)/d(mean, scale), which divides by a likelihood that is a
    difference of two CDFs near 1, so float32 erf error is amplified: the
    port's float32 stays within 5e-4 of each gradient's largest value,
    JAX's within 4e-3 (tests/test_torch_step.py holds the entropy steps'
    gradients to the latter)."""
    from gsvc_tpu.models.gaussians import (
        GenerateMode as JMode, generate_neural_gaussians as jax_generate,
        window_for_frame as jax_window,
    )
    from gsvc_tpu_torch.models.gaussians import (
        GenerateMode, generate_neural_gaussians, window_for_frame,
    )
    from gsvc_tpu_torch.train.optim import tree_map
    from tests.test_batched import WINDOW_CAP, Z1
    from tests.test_torch_mirror import _jax_pair_noise

    jstate, jcfg = tiny_model(seed=6)
    jstate = jstate._replace(nets=jstate.nets._replace(
        hash_table=jnp.asarray(np.random.default_rng(6).uniform(
            -1.5, 1.5, jstate.nets.hash_table.shape).astype(np.float32))))
    payload = {
        "anchors": {k: np.asarray(v)
                    for k, v in jstate.anchors._asdict().items()},
        "nets": jax.tree.map(np.asarray, jstate.nets._asdict()),
        "n_active": int(jstate.n_active),
        "x_bound_min": np.asarray(jstate.x_bound_min),
        "x_bound_max": np.asarray(jstate.x_bound_max)}
    _, _, _, cfg = _carried_state()
    start, in_win = jax_window(jstate, jcfg, Z1, WINDOW_CAP)
    key = jax.random.PRNGKey(11)
    noise = _jax_pair_noise(key, jcfg, WINDOW_CAP)[0] \
        if mode == "ENTROPY" else None

    def with_leaves(st, anchor, bias):
        enet = st.nets.mlp_offset_enet
        return st._replace(
            anchors=st.anchors._replace(anchor=anchor),
            nets=st.nets._replace(mlp_offset_enet={
                **enet, "dist_out": {**enet["dist_out"], "b": bias}}))

    def jax_rate(anchor, bias):
        st = with_leaves(jstate, anchor, bias)
        return jax_generate(st, jcfg, Z1, Z1, start, in_win, WINDOW_CAP,
                            JMode[mode], key=jax.random.split(key)[0]
                            ).rate.bit_per_param

    jgrads = [np.asarray(g) for g in jax.grad(jax_rate, argnums=(0, 1))(
        jstate.anchors.anchor,
        jstate.nets.mlp_offset_enet["dist_out"]["b"])]
    grads = []
    for dtype in (torch.float32, torch.float64):
        state = state_from_numpy(payload)
        state = state._replace(
            anchors=tree_map(lambda t: t.to(dtype), state.anchors),
            nets=tree_map(lambda t: t.to(dtype), state.nets),
            x_bound_min=state.x_bound_min.to(dtype),
            x_bound_max=state.x_bound_max.to(dtype))
        c = cfg
        s, w = window_for_frame(state, c, Z1, WINDOW_CAP)
        assert s == int(start)
        a = state.anchors.anchor.clone().requires_grad_(True)
        b = state.nets.mlp_offset_enet["dist_out"]["b"].clone() \
            .requires_grad_(True)
        generate_neural_gaussians(
            with_leaves(state, a, b), c, Z1, Z1, s, w, WINDOW_CAP,
            GenerateMode[mode], decoded=False,
            noise=None if noise is None
            else tuple(n.to(dtype) for n in noise)
        ).rate.bit_per_param.backward()
        grads.append([a.grad.double().numpy(), b.grad.double().numpy()])
    for g32, g64, jg in zip(grads[0], grads[1], jgrads):
        scale = np.abs(g64).max()
        assert scale > 0.5
        assert np.abs(g32 - g64).max() <= 5e-4 * scale
        assert np.abs(jg - g64).max() <= 4e-3 * scale
