"""The Mix3d2d multi-resolution hash grid: its static layout and the
plain PyTorch encode (port of ``gsvc_tpu/ops/hashgrid.py``).

The layout — level sizes, offsets and the flat-table split — is shared by
the hash bitstream (``codec/hashctx.py``), the host entropy context
(``codec/detctx.py``) and kernels B3f/B3b.  Per-level table sizes are
``min(2**log2_hashmap_size, res**dim)`` rounded up to a multiple of 8
(GridEncoder.__init__, utils/encodings.py:647-666).

``mix_grid_encode`` is the plain version of kernels B3f/B3b
(``ops/hashgrid_kernels.py``): the reference gridencoder's semantics —
``pos = x * (res - 2) + 0.5``, corners with a coordinate outside
(0, res - 1) weigh zero and the rest are renormalised by
``max(sum w, 1e-9)``, direct row-major rows when ``res**dim`` fits the
level and the instant-NGP xor-prime hash otherwise.  The uint32 hash is
computed in int64 masked to 32 bits (uint32 multiplication is not
available on every PyTorch backend).  Gradients reach the table through
the gathers and the positions through the interpolation weights.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static layout of one grid encoder (one num_dim, L levels)."""

    num_dim: int
    n_features: int
    resolutions: Tuple[int, ...]
    level_sizes: Tuple[int, ...]     # rows per level
    level_offsets: Tuple[int, ...]   # starting row per level (len L+1)

    @property
    def n_levels(self) -> int:
        return len(self.resolutions)

    @property
    def total_rows(self) -> int:
        return self.level_offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features


def make_grid_spec(num_dim: int, n_features: int,
                   resolutions_list: Sequence[int],
                   log2_hashmap_size: int) -> HashGridSpec:
    max_params = 2 ** log2_hashmap_size
    sizes, offsets, off = [], [0], 0
    for res in resolutions_list:
        n = min(max_params, res ** num_dim)
        n = -(-n // 8) * 8
        sizes.append(n)
        off += n
        offsets.append(off)
    return HashGridSpec(num_dim=num_dim, n_features=n_features,
                        resolutions=tuple(int(r) for r in resolutions_list),
                        level_sizes=tuple(sizes),
                        level_offsets=tuple(offsets))


@dataclasses.dataclass(frozen=True)
class MixGridSpec:
    """One 3D grid + three 2D grids over (xy, xz, yz)
    (reference: scene/gaussian_model.py:81-147)."""

    grid_3d: HashGridSpec
    grid_2d: HashGridSpec   # shared layout for xy / xz / yz

    @property
    def output_dim(self) -> int:
        return self.grid_3d.output_dim + 3 * self.grid_2d.output_dim

    @property
    def total_rows(self) -> int:
        return self.grid_3d.total_rows + 3 * self.grid_2d.total_rows

    @property
    def n_features(self) -> int:
        return self.grid_3d.n_features

    def param_splits(self):
        """Row boundaries of (xyz, xy, xz, yz) inside the flat table."""
        r3, r2 = self.grid_3d.total_rows, self.grid_2d.total_rows
        return [0, r3, r3 + r2, r3 + 2 * r2, r3 + 3 * r2]

    def flat_level_sizes(self) -> list:
        """Per-level row counts in flattened table order (the 3D grid's
        levels, then the xy/xz/yz 2D grids' levels)."""
        return (list(self.grid_3d.level_sizes)
                + list(self.grid_2d.level_sizes) * 3)


def make_mix_grid_spec(n_features: int,
                       resolutions_list: Sequence[int],
                       log2_hashmap_size: int,
                       resolutions_list_2d: Sequence[int],
                       log2_hashmap_size_2d: int) -> MixGridSpec:
    return MixGridSpec(
        grid_3d=make_grid_spec(3, n_features, resolutions_list,
                               log2_hashmap_size),
        grid_2d=make_grid_spec(2, n_features, resolutions_list_2d,
                               log2_hashmap_size_2d),
    )


def init_mix_grid_params(gen: torch.Generator, spec: MixGridSpec,
                         std: float = 1e-4, device="cpu") -> torch.Tensor:
    """The flat [rows, F] table (xyz | xy | xz | yz blocks), U(-std, std),
    drawn from ``gen`` on its own device and moved to ``device``."""
    t = torch.rand((spec.total_rows, spec.n_features), generator=gen,
                   dtype=torch.float32, device=gen.device)
    return ((t * 2.0 - 1.0) * std).to(device)


def _level_indices(x, res: int, level_size: int, level_offset: int,
                   num_dim: int):
    """Corner rows (int64 [N, C], into the flat multi-level table) and
    weights ([N, C], border corners zeroed) of one level."""
    pos = x * float(res - 2) + 0.5
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    pg = pos_grid.to(torch.int64)
    use_hash = (res ** num_dim) > level_size
    idxs, ws = [], []
    for corner in range(1 << num_dim):
        w = torch.ones_like(x[:, 0])
        coords = []
        for d in range(num_dim):
            if (corner >> d) & 1:
                w = w * frac[:, d]
                coords.append(torch.clamp(pg[:, d] + 1, max=res - 1))
            else:
                w = w * (1.0 - frac[:, d])
                coords.append(pg[:, d])
        valid = torch.ones_like(coords[0], dtype=torch.bool)
        for c in coords:
            valid = valid & (c > 0) & (c < res - 1)
        if use_hash:
            h = torch.zeros_like(coords[0])
            for d in range(num_dim):
                h = h ^ (((coords[d] & _MASK32) * _PRIMES[d]) & _MASK32)
            idx = h % level_size
        else:
            stride = 1
            idx = torch.zeros_like(coords[0])
            for d in range(num_dim):
                idx = idx + coords[d] * stride
                stride *= res
            idx = idx % level_size
        idxs.append(idx + level_offset)
        ws.append(torch.where(valid, w, torch.zeros_like(w)))
    return torch.stack(idxs, dim=1), torch.stack(ws, dim=1)


def hashgrid_encode(params, x, spec: HashGridSpec):
    """Encode ``x`` [N, num_dim] through every level of one grid:
    [N, L * F].  Per level, corner by corner, ``acc + w * row`` and
    ``wn + w``, then ``acc / max(wn, 1e-9)``."""
    outs = []
    for lvl in range(spec.n_levels):
        idx, w = _level_indices(x, spec.resolutions[lvl],
                                spec.level_sizes[lvl],
                                spec.level_offsets[lvl], spec.num_dim)
        acc = torch.zeros((x.shape[0], spec.n_features), dtype=params.dtype,
                          device=params.device)
        wn = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
        for corner in range(idx.shape[1]):
            wc = w[:, corner:corner + 1]
            acc = acc + wc * params[idx[:, corner]]
            wn = wn + wc
        outs.append(acc / torch.clamp(wn, min=1e-9))
    return torch.cat(outs, dim=-1)


def mix_grid_encode(params, x, spec: MixGridSpec, binarize=None):
    """x [N, 3] in [0, 1] -> [N, output_dim]: the 3D grid's levels, then
    the xy, xz and yz planes' levels.  ``binarize`` (optional) is applied
    to the table first (the STE binarisation of training)."""
    if binarize is not None:
        params = binarize(params)
    s = spec.param_splits()
    return torch.cat([
        hashgrid_encode(params[s[0]:s[1]], x, spec.grid_3d),
        hashgrid_encode(params[s[1]:s[2]], x[:, [0, 1]], spec.grid_2d),
        hashgrid_encode(params[s[2]:s[3]], x[:, [0, 2]], spec.grid_2d),
        hashgrid_encode(params[s[3]:s[4]], x[:, [1, 2]], spec.grid_2d),
    ], dim=-1)
