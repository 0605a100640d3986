"""The port's hash-grid encode (the plain version of kernels B3f/B3b)
against three references on the same numpy-seeded inputs:

* JAX ``mix_grid_encode`` (the XLA path) — forward to 1e-6 absolute,
  gradients (``jax.grad`` of a weighted output sum) to rtol 1e-5 with an
  absolute floor: 1e-7 for the table (the gather transposes add in other
  orders), and 1e-7 of the largest magnitude for the positions, whose
  gradient is a sum over corners of terms (res - 2) |V| / W in size that
  cancel — float32 rounding of those terms, not of the result, sets its
  absolute error;
* JAX ``mix_grid_encode_lanegather`` — its Pallas kernels in interpret
  mode, as tests/test_pallas_hashgrid.py runs them — forward to 1e-6;
* the port's float64 host grid (``codec/detctx.py:_mix_grid``) — forward
  to 2e-5 on random positions: float32 rounds ``pos = x (res - 2) + 0.5``
  to half an ulp of ``pos`` (2^-19 for res 40), which moves each weight by
  that much per dimension, times corner values that differ by up to 3.
  Points placed exactly on cell edges are held to the float32 references
  only: there the float64 ``floor`` may pick the other cell.

Positions are uniform in [0, 1], plus points on the border (0 and 1) and
on cell edges of several levels; tables are uniform values or, with the
STE binarisation, their signs.  The autograd function around the kernels
(``mix_grid_encode_kernel``) takes the plain versions on CPU tensors and
is held to the same references.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.ops.hashgrid import make_mix_grid_spec as jax_mix_spec
from gsvc_tpu.ops.hashgrid import mix_grid_encode as jax_encode
from gsvc_tpu.ops.pallas_hashgrid import mix_grid_encode_lanegather
from gsvc_tpu.ops.quant import ste_binary as jax_ste_binary
from gsvc_tpu_torch.codec.detctx import _mix_grid
from gsvc_tpu_torch.ops import hashgrid_kernels as hk
from gsvc_tpu_torch.ops.hashgrid import (
    init_mix_grid_params, make_mix_grid_spec, mix_grid_encode,
)
from gsvc_tpu_torch.ops.quant import ste_binary

# a small grid with dense and hashed 3D and 2D levels
GRID = dict(resolutions_list=(6, 10, 18), log2_hashmap_size=8,
            resolutions_list_2d=(12, 20, 40), log2_hashmap_size_2d=8)


def _specs(f):
    return (jax_mix_spec(f, *GRID.values()),
            make_mix_grid_spec(f, *GRID.values()))


def _inputs(spec, seed, n=257, edges=True):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1.5, 1.5, (spec.total_rows, spec.n_features))
    x = rng.uniform(0, 1, (n, 3))
    if edges:
        x[:32] = rng.choice([0.0, 1.0], (32, 3))
        for i, res in enumerate(spec.grid_3d.resolutions
                                + spec.grid_2d.resolutions):
            rows = slice(32 + 16 * i, 48 + 16 * i)
            x[rows] = (rng.integers(1, res - 2, (16, 3)) - 0.5) / (res - 2)
    return table.astype(np.float32), x.astype(np.float32)


def test_spec_matches_jax():
    js, ps = _specs(4)
    assert ps.output_dim == js.output_dim
    assert ps.total_rows == js.total_rows
    assert ps.param_splits() == js.param_splits()
    for a, b in ((ps.grid_3d, js.grid_3d), (ps.grid_2d, js.grid_2d)):
        assert (a.level_sizes, a.level_offsets) == (b.level_sizes,
                                                    b.level_offsets)
    assert hk.instance_table(ps).shape == (
        ps.grid_3d.n_levels + 3 * ps.grid_2d.n_levels, 9)
    t = init_mix_grid_params(torch.Generator().manual_seed(0), ps)
    assert t.shape == (ps.total_rows, 4) and float(t.abs().max()) <= 1e-4


@pytest.mark.parametrize("binarize", [False, True], ids=["raw", "ste"])
@pytest.mark.parametrize("f", [2, 4, 8])
def test_forward_matches_jax_and_host_grid(f, binarize):
    js, ps = _specs(f)
    table, x = _inputs(ps, seed=f)
    jb = jax_ste_binary if binarize else None
    pb = ste_binary if binarize else None
    want = np.asarray(jax_encode(jnp.asarray(table), jnp.asarray(x), js,
                                 binarize=jb))
    got = mix_grid_encode(torch.from_numpy(table), torch.from_numpy(x), ps,
                          binarize=pb).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    via_fn = hk.mix_grid_encode_kernel(torch.from_numpy(table),
                                       torch.from_numpy(x), ps,
                                       binarize=pb).detach().numpy()
    np.testing.assert_array_equal(via_fn, got)
    lg = np.asarray(mix_grid_encode_lanegather(
        jnp.asarray(table), jnp.asarray(x), js, binarize=jb))
    np.testing.assert_allclose(got, lg, rtol=0, atol=1e-6)
    host_table = np.where(table >= 0, 1.0, -1.0) if binarize else table
    rand = slice(32 + 16 * 6, None)          # the uniform positions
    host = _mix_grid(host_table.astype(np.float64),
                     x[rand].astype(np.float64), ps)
    np.testing.assert_allclose(got[rand], host, rtol=0, atol=2e-5)


@pytest.mark.parametrize("binarize", [False, True], ids=["raw", "ste"])
@pytest.mark.parametrize("f", [2, 4, 8])
def test_gradients_match_jax(f, binarize):
    js, ps = _specs(f)
    table, x = _inputs(ps, seed=10 + f)
    w = np.random.default_rng(f).normal(
        size=(x.shape[0], ps.output_dim)).astype(np.float32)
    jb = jax_ste_binary if binarize else None

    def loss(t, xx):
        return jnp.sum(jax_encode(t, xx, js, binarize=jb) * w)

    jt, jx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(table),
                                           jnp.asarray(x))
    for fn in (mix_grid_encode, hk.mix_grid_encode_kernel):
        t = torch.from_numpy(table).requires_grad_(True)
        xx = torch.from_numpy(x).requires_grad_(True)
        out = fn(t, xx, ps, binarize=ste_binary if binarize else None)
        (out * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jt),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(
            xx.grad.numpy(), np.asarray(jx), rtol=1e-5,
            atol=1e-7 * float(np.abs(np.asarray(jx)).max()))
    if binarize:
        # the STE passes the gradient only inside [-1, 1]
        assert not np.any(np.asarray(jt)[np.abs(table) > 1])


def test_kernel_wrappers_refuse_bad_inputs():
    _, ps = _specs(4)
    table, x = (torch.from_numpy(a) for a in _inputs(ps, seed=0, n=40,
                                                    edges=False))
    with pytest.raises(ValueError, match="table"):
        hk.hashgrid_forward(table[:-1], x, ps)
    with pytest.raises(ValueError, match="float32"):
        hk.hashgrid_forward(table.double(), x, ps)
    with pytest.raises(ValueError, match="CUDA"):
        hk.hashgrid_fwd_cuda(table, x, ps)
    before = hk.hashgrid_forward.launches
    hk.hashgrid_forward(table, x, ps)
    assert hk.hashgrid_forward.launches == before   # the CPU runs no kernel
