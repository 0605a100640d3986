"""The corner rows and weights of kernels B3f/B3b (``csrc/hashgrid.cuh``:
``cell``, ``corner``), reckoned as the kernels reckon them
(``kernel_corners`` here: no modulo in dense levels,
``h & (size - 1)`` in hashed ones, 32-bit rows), against the plain
version's ``ops/hashgrid.py:_level_indices``, exactly; the instance
table's mask column; and the launcher's checks.

A dense level's valid corner has every coordinate in (0, res - 1), so its
row-major index is below res^D <= size and the plain version's modulo
leaves it as it is; a hashed level's size is ``min(2^log2, res^D)``
rounded up to 8 with res^D above it, so it is 2^log2 (or 8): a power of
two, and ``h % size == h & (size - 1)``.  Border corners weigh 0 in both;
their rows are never read.
"""

import numpy as np
import pytest
import torch

from gsvc_tpu_torch.ops import hashgrid_kernels as hk
from gsvc_tpu_torch.ops.hashgrid import (
    HashGridSpec, MixGridSpec, _level_indices, make_grid_spec,
    make_mix_grid_spec,
)

FIXTURE = dict(n_features=8,
               resolutions_list=(18, 24, 33, 44, 59, 80, 108, 148, 201, 275,
                                 376, 514),
               log2_hashmap_size=13, resolutions_list_2d=(130, 258, 514, 1026),
               log2_hashmap_size_2d=15)


def kernel_corners(x, inst):
    """The kernels' corner math (``csrc/hashgrid.cuh``: ``cell``,
    ``corner``) for one row ``inst`` of ``instance_table``, in PyTorch:
    (rows int64 [N, C] into the flat table, -1 at border corners; weights
    [N, C], 0 at border corners; valid bool [N, C]).  Dense levels take
    the row-major index as it is, hashed ones ``h & mask``, the table's
    mask column."""
    res, _, offset, ndim = (int(v) for v in inst[:4])
    dims = [int(v) for v in inst[4:4 + ndim]]
    use_hash, mask = bool(inst[7]), int(inst[8])
    pos = x[:, dims].to(torch.float32) * float(res - 2) + 0.5
    fl = torch.floor(pos)
    frac = pos - fl
    pg = fl.clamp(-1e9, 1e9).to(torch.int64)
    primes = (1, 2654435761, 805459861)
    rows, ws, valids = [], [], []
    for c in range(1 << ndim):
        w = torch.ones_like(pos[:, 0])
        valid = torch.ones_like(pg[:, 0], dtype=torch.bool)
        h = torch.zeros_like(pg[:, 0])
        idx = torch.zeros_like(pg[:, 0])
        for d in range(ndim):
            if (c >> d) & 1:
                w = w * frac[:, d]
                coord = torch.clamp(pg[:, d] + 1, max=res - 1)
            else:
                w = w * (1.0 - frac[:, d])
                coord = pg[:, d]
            valid = valid & (coord > 0) & (coord < res - 1)
            h = h ^ (((coord & 0xFFFFFFFF) * primes[d]) & 0xFFFFFFFF)
            idx = idx + coord * res ** d
        local = (h & mask) if use_hash else idx
        rows.append(torch.where(valid, offset + local, -1))
        ws.append(torch.where(valid, w, 0.0))
        valids.append(valid)
    return (torch.stack(rows, 1), torch.stack(ws, 1),
            torch.stack(valids, 1))


def _straddling_spec(log2):
    """Resolutions on both sides of the dense/hash threshold 2^log2, in 3D
    and 2D (res^D == 2^log2 stays dense, the next resolution hashes)."""
    r3 = max(int(round(2 ** (log2 / 3))), 3)
    r2 = max(int(round(2 ** (log2 / 2))), 3)
    return make_mix_grid_spec(
        2, (3, r3 - 1 if r3 > 3 else 3, r3, r3 + 1, 2 * r3 + 1), log2,
        (3, r2 - 1 if r2 > 3 else 3, r2, r2 + 1, 3 * r2), log2)


SPECS = {"fixture": make_mix_grid_spec(**FIXTURE)}
SPECS.update({f"log2_{k}": _straddling_spec(k) for k in range(3, 20)})


def _queries(spec, seed, n=2000):
    """Uniform queries, the border (0 and 1 in every combination) and
    points on cell edges and cell centres of every level."""
    rng = np.random.default_rng(seed)
    x = [rng.uniform(0, 1, (n, 3)),
         np.array([[a, b, c] for a in (0.0, 1.0) for b in (0.0, 1.0)
                   for c in (0.0, 1.0)])]
    for res in spec.grid_3d.resolutions + spec.grid_2d.resolutions:
        k = rng.integers(0, res - 1, (32, 3))
        x.append(np.clip((k - 0.5) / (res - 2), 0, 1))   # pos on an integer
        x.append(np.clip(k / (res - 2), 0, 1))           # pos on a half
    return torch.from_numpy(np.concatenate(x).astype(np.float32))


def _plain_levels(spec, x):
    """(rows, weights) per level-instance from ``_level_indices``, in the
    instance table's order."""
    s = spec.param_splits()
    out = []
    for base, grid, cols in ((s[0], spec.grid_3d, [0, 1, 2]),
                             (s[1], spec.grid_2d, [0, 1]),
                             (s[2], spec.grid_2d, [0, 2]),
                             (s[3], spec.grid_2d, [1, 2])):
        for lvl in range(grid.n_levels):
            idx, w = _level_indices(x[:, cols], grid.resolutions[lvl],
                                    grid.level_sizes[lvl],
                                    grid.level_offsets[lvl], grid.num_dim)
            out.append((idx + base, w))
    return out


@pytest.mark.parametrize("name", list(SPECS))
def test_kernel_corners_equal_level_indices(name):
    spec = SPECS[name]
    table = hk.instance_table(spec)
    for seed in (0, 1):
        x = _queries(spec, seed)
        plain = _plain_levels(spec, x)
        assert len(plain) == table.shape[0]
        for inst, (rows_p, w_p) in zip(table, plain):
            rows_k, w_k, valid = kernel_corners(x, inst)
            assert torch.equal(w_k, w_p)
            assert torch.equal(rows_k[valid], rows_p[valid])
            assert bool((rows_k[~valid] == -1).all())
            # a valid row lies inside its level; 32-bit arithmetic holds it
            lo, size = int(inst[2]), int(inst[1])
            assert bool(((rows_k[valid] >= lo)
                         & (rows_k[valid] < lo + size)).all())
            assert spec.total_rows * spec.n_features < 2 ** 31


@pytest.mark.parametrize("num_dim", [2, 3])
def test_hashed_levels_are_powers_of_two(num_dim):
    hashed = 0
    for log2 in range(1, 25):
        res = list(range(3, 80)) + [2 ** k + d for k in range(4, 12)
                                    for d in (-1, 0, 1)]
        g = make_grid_spec(num_dim, 2, res, log2)
        for r, size in zip(g.resolutions, g.level_sizes):
            if r ** num_dim > size:
                hashed += 1
                assert size & (size - 1) == 0, (log2, r, size)
                assert size == max(2 ** log2, 8)
    assert hashed > 1000


@pytest.mark.parametrize("name", ["fixture", "log2_3", "log2_8", "log2_19"])
def test_instance_table_mask_column(name):
    spec = SPECS[name]
    table = hk.instance_table(spec)
    g3, g2 = spec.grid_3d, spec.grid_2d
    assert table.shape == (g3.n_levels + 3 * g2.n_levels, 9)
    assert table.dtype == np.int32
    res, size, ndim = table[:, 0], table[:, 1], table[:, 3]
    use_hash, mask = table[:, 7], table[:, 8]
    np.testing.assert_array_equal(use_hash, (res.astype(np.int64) ** ndim
                                             > size).astype(np.int32))
    np.testing.assert_array_equal(mask, np.where(use_hash == 1, size - 1, 0))
    assert ((size[use_hash == 1] & mask[use_hash == 1]) == 0).all()
    np.testing.assert_array_equal(size, spec.flat_level_sizes())


def test_instance_table_refuses_a_hashed_level_that_is_not_a_power_of_two():
    bad = HashGridSpec(num_dim=2, n_features=2, resolutions=(20,),
                       level_sizes=(24,), level_offsets=(0, 24))
    with pytest.raises(ValueError, match="power of two"):
        hk.instance_table(MixGridSpec(grid_3d=make_grid_spec(3, 2, (4,), 6),
                                      grid_2d=bad))


@pytest.mark.parametrize("f,log2", [(8, 28), (4, 29), (2, 30)])
def test_launcher_refuses_a_table_past_32_bit_rows(f, log2):
    """rows x F must stay below 2^31 (the kernels index in 32 bits); the
    plan checks it before it touches a device."""
    spec = make_mix_grid_spec(f, (2000,), log2, (40,), 6)
    assert spec.total_rows * f >= 2 ** 31
    with pytest.raises(ValueError, match="32 bits"):
        hk.LaunchPlan(spec, 0)
    with pytest.raises(ValueError, match="32 bits"):
        hk.launch_plan(spec, 0)


def test_launcher_refuses_other_feature_counts():
    with pytest.raises(ValueError, match="F in"):
        hk.LaunchPlan(make_mix_grid_spec(3, (6,), 6, (8,), 6), 0)


def test_launch_plans_kept_are_bounded(monkeypatch):
    """``launch_plan`` builds a plan once per (spec, device), keeps the
    ``_PLANS_KEPT`` most recently used and drops the oldest; a plan in use
    is kept.  ``LaunchPlan`` is stood in for, so no device is needed."""
    monkeypatch.setattr(hk, "LaunchPlan",
                        lambda spec, device: ("plan", spec, device))
    monkeypatch.setattr(hk, "_plans", type(hk._plans)())
    specs = [make_mix_grid_spec(2, (6,), 6, (8,), 6)
             for _ in range(hk._PLANS_KEPT + 1)]
    built = hk.launch_plan.built
    first = hk.launch_plan(specs[0], 0)
    assert hk.launch_plan(specs[0], 0) is first
    assert hk.launch_plan(specs[0], 1) is not first
    assert hk.launch_plan.built == built + 2
    for spec in specs[1:hk._PLANS_KEPT - 1]:
        hk.launch_plan(spec, 0)
    assert len(hk._plans) == hk._PLANS_KEPT
    hk.launch_plan(specs[0], 0)                # used again: kept
    hk.launch_plan(specs[-1], 0)               # drops (specs[0], 1)
    assert len(hk._plans) == hk._PLANS_KEPT
    assert (id(specs[0]), 1) not in hk._plans
    assert hk.launch_plan(specs[0], 0) is first
    assert hk.launch_plan.built == built + hk._PLANS_KEPT + 1

# ---------------------------------------------------------------------------
# Kernel B3b's reduction, emulated in float32
# ---------------------------------------------------------------------------

HASH_BWD_REL_ERR = 1e-4   # chip_smoke.py: 1e-4 of the largest gradient


def _emulate_b3b(table, x, g, spec):
    """B3b's arithmetic (``csrc/hashgrid_bwd.cu``) in float32 PyTorch:
    per instance, in the instance table's order, the corners' forward
    (``acc + w v``, ``wn + w``, corner by corner), r_c summed over each
    lane's features (two lanes of four at F = 8, one lane otherwise) and
    the lanes' sums added, the table gradient ``(g / W) w_c`` added per
    row, and each query's position gradient summed over the instances in
    their order."""
    f = spec.n_features
    lanes = 2 if f == 8 else 1
    fl = f // lanes
    n = x.shape[0]
    g_table = torch.zeros_like(table)
    g_x = torch.zeros((n, 3), dtype=torch.float32)
    for i, inst in enumerate(hk.instance_table(spec)):
        res, ndim, dims = int(inst[0]), int(inst[3]), [int(d) for d in inst[4:7]]
        rows, w, valid = kernel_corners(x, inst)
        v = table[rows.clamp(min=0)] * valid[..., None]
        gi = g[:, i * f:(i + 1) * f]
        acc = torch.zeros((n, f))
        wn = torch.zeros(n)
        for c in range(1 << ndim):
            acc = acc + w[:, c:c + 1] * v[:, c]
            wn = wn + w[:, c]
        big_w = torch.clamp(wn, min=1e-9)
        out = torch.where((wn >= 1e-9)[:, None], acc / big_w[:, None], 0.0)
        gw = gi / big_w[:, None]
        pos = x[:, dims[:ndim]] * float(res - 2) + 0.5
        frac = pos - torch.floor(pos)
        gx = torch.zeros((n, ndim))
        for c in range(1 << ndim):
            r = torch.zeros(n)
            for lane in range(lanes):
                part = torch.zeros(n)
                for k in range(lane * fl, (lane + 1) * fl):
                    part = part + gi[:, k] * (v[:, c, k] - out[:, k])
                r = r + part
            r = torch.where(valid[:, c], r, 0.0) / big_w
            ok = valid[:, c]
            g_table.index_add_(0, rows[ok, c], (gw * w[:, c:c + 1])[ok])
            for d in range(ndim):
                p = torch.full((n,), 1.0 if (c >> d) & 1 else -1.0)
                for d2 in range(ndim):
                    if d2 != d:
                        p = p * (frac[:, d2] if (c >> d2) & 1
                                 else 1.0 - frac[:, d2])
                gx[:, d] = gx[:, d] + r * (p * float(res - 2))
        for d in range(ndim):
            g_x[:, dims[d]] = g_x[:, dims[d]] + gx[:, d]
    return g_table, g_x


@pytest.mark.parametrize("f", [2, 4, 8])
@pytest.mark.parametrize("binary", [True, False])
def test_b3b_reduction_emulated_matches_plain(f, binary):
    """The emulation of B3b's summation orders against the plain
    version's autograd gradient, within 1e-4 of the largest gradient, at
    the fixture's levels on queries sorted by z (as the anchors are)."""
    spec = make_mix_grid_spec(**{**FIXTURE, "n_features": f})
    rng = np.random.default_rng(f + 10 * binary)
    x = _queries(spec, seed=f, n=1500).numpy()
    x = torch.from_numpy(x[np.argsort(x[:, 2], kind="stable")])
    table = rng.uniform(-1, 1, (spec.total_rows, f))
    if binary:
        table = np.where(table < 0, -1.0, 1.0)
    table = torch.from_numpy(table.astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (x.shape[0], spec.output_dim)).astype(np.float32))
    got = _emulate_b3b(table, x, g, spec)
    want = hk.hashgrid_bwd_plain(table, x, g, spec)
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= HASH_BWD_REL_ERR * scale
