"""Static layout of the Mix3d2d multi-resolution hash grid.

Port of the spec half of ``gsvc_tpu/ops/hashgrid.py``: level sizes,
offsets and the flat-table split that the hash bitstream
(``codec/hashctx.py``) and the host entropy context (``codec/detctx.py``)
share.  Per-level table sizes are ``min(2**log2_hashmap_size, res**dim)``
rounded up to a multiple of 8 (GridEncoder.__init__,
utils/encodings.py:647-666).  The grid encode itself (kernel B3) belongs
to the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


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
