"""Deterministic host entropy context — what keeps the rANS streams in
sync (port of ``gsvc_tpu/codec/detctx.py``).

The attribute streams are coded against entropy contexts (mu, sigma, q)
from tiny MLPs over a hash-grid interpolation.  Encoder and decoder must
build bit-identical CDFs, so this path is plain numpy **float64** with a
fixed summation order (``np.einsum(optimize=False)`` runs numpy's own C
sum-of-products loop and never dispatches to BLAS, whose blocking varies
across builds and CPUs).  It deliberately does not use torch, float32 or
the card: any of those changes the rounding and desyncs the decode.

    exact anchors -> bound-normalize -> mix-grid interpolation (gathers +
    elementwise) -> 3 entropy nets (einsum matmuls + tanh-GELU) ->
    clip/exp/floor

The Q_PROBA = 1024 snap in ``bitstream.py`` absorbs the few-ulp libm
residue of tanh/exp across platforms.
"""

from __future__ import annotations

import numpy as np

from gsvc_tpu_torch.models.gaussians import EntropyContext, map_tree
from gsvc_tpu_torch.ops.hashgrid import HashGridSpec, MixGridSpec

_PRIMES = np.array([1, 2654435761, 805459861], dtype=np.uint64)


def as_f64(x) -> np.ndarray:
    """float64 numpy copy of a tensor or array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _matmul(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    # optimize=False keeps einsum on its deterministic C loop — never BLAS
    return np.einsum("nd,dh->nh", x, w, optimize=False)


def _linear(p, x: np.ndarray) -> np.ndarray:
    return _matmul(x, p["w"]) + p["b"]


def _gelu_tanh(x: np.ndarray) -> np.ndarray:
    c = np.float64(np.sqrt(2.0 / np.pi))
    return 0.5 * x * (1.0 + np.tanh(c * (x + 0.044715 * x ** 3)))


def _entropy_net(p, x: np.ndarray):
    h = _gelu_tanh(_linear(p["dist0"], x))
    if "dist1" in p:
        h = _gelu_tanh(_linear(p["dist1"], h))
    params = _linear(p["dist_out"], h)
    mean, scale = np.split(params, 2, axis=-1)
    q = _linear(p["q1"], _gelu_tanh(_linear(p["q0"], x)))
    return mean, scale, q


def _grid_level(x: np.ndarray, res: int, level_size: int,
                level_offset: int, num_dim: int):
    """Corner (rows, weights) of one level; border corners weigh 0."""
    pos = x * np.float64(res - 2) + 0.5
    pos_grid = np.floor(pos)
    frac = pos - pos_grid
    pos_grid = pos_grid.astype(np.int64)

    use_hash = (res ** num_dim) > level_size
    idxs, ws = [], []
    for corner in range(1 << num_dim):
        w = np.ones((x.shape[0],), np.float64)
        coords = []
        for d in range(num_dim):
            if (corner >> d) & 1:
                w = w * frac[:, d]
                coords.append(np.minimum(pos_grid[:, d] + 1, res - 1))
            else:
                w = w * (1.0 - frac[:, d])
                coords.append(pos_grid[:, d])
        coords = np.stack(coords, axis=-1)
        valid = np.all((coords > 0) & (coords < res - 1), axis=-1)
        if use_hash:
            h = np.zeros((x.shape[0],), np.uint64)
            for d in range(num_dim):
                h = h ^ ((coords[:, d].astype(np.uint64) * _PRIMES[d])
                         & np.uint64(0xFFFFFFFF))
            idx = (h % np.uint64(level_size)).astype(np.int64)
        else:
            stride = 1
            idx = np.zeros((x.shape[0],), np.int64)
            for d in range(num_dim):
                idx = idx + coords[:, d] * stride
                stride *= res
            idx = idx % level_size
        idxs.append(idx + level_offset)
        ws.append(np.where(valid, w, 0.0))
    return np.stack(idxs, axis=1), np.stack(ws, axis=1)


def _grid_encode(params: np.ndarray, x: np.ndarray,
                 spec: HashGridSpec) -> np.ndarray:
    n = x.shape[0]
    outs = []
    for lvl in range(spec.n_levels):
        idx, w = _grid_level(x, spec.resolutions[lvl],
                             spec.level_sizes[lvl],
                             spec.level_offsets[lvl], spec.num_dim)
        acc = np.zeros((n, spec.n_features), np.float64)
        wn = np.zeros((n, 1), np.float64)
        for corner in range(1 << spec.num_dim):
            wc = w[:, corner]
            acc = acc + wc[:, None] * params[idx[:, corner]]
            wn = wn + wc[:, None]
        outs.append(acc / np.maximum(wn, 1e-9))
    return np.concatenate(outs, axis=-1)


def _mix_grid(table: np.ndarray, xn: np.ndarray,
              spec: MixGridSpec) -> np.ndarray:
    s = spec.param_splits()
    p_xyz, p_xy, p_xz, p_yz = (table[s[0]:s[1]], table[s[1]:s[2]],
                               table[s[2]:s[3]], table[s[3]:s[4]])
    return np.concatenate([
        _grid_encode(p_xyz, xn, spec.grid_3d),
        _grid_encode(p_xy, xn[:, (0, 1)], spec.grid_2d),
        _grid_encode(p_xz, xn[:, (0, 2)], spec.grid_2d),
        _grid_encode(p_yz, xn[:, (1, 2)], spec.grid_2d),
    ], axis=-1)


def host_nets(nets) -> dict:
    """float64 numpy copies of the hash table (signed, 0 -> +1) and the
    three entropy nets — convert once, reuse for every batch."""
    table = np.sign(as_f64(nets.hash_table))
    return {
        "table": np.where(table == 0.0, 1.0, table),
        "feat": map_tree(as_f64, nets.mlp_feature_enet),
        "scaling": map_tree(as_f64, nets.mlp_scaling_enet),
        "offsets": map_tree(as_f64, nets.mlp_offset_enet),
    }


def det_entropy_context(hnets: dict, bound_min, bound_max, cfg,
                        anchors: np.ndarray) -> EntropyContext:
    """EntropyContext (numpy float64) of ``anchors`` [N, 3] — the
    decoder-identical positions — from ``host_nets`` output and the
    learned-bounds box."""
    x = np.asarray(anchors, np.float64)
    lo, hi = as_f64(bound_min), as_f64(bound_max)
    feat_ctx = _mix_grid(hnets["table"], (x - lo) / (hi - lo), cfg.grid)

    m_f, s_f, qf = _entropy_net(hnets["feat"], feat_ctx)
    m_s, s_s, qs = _entropy_net(hnets["scaling"], feat_ctx)
    m_o, s_o, qo = _entropy_net(hnets["offsets"], feat_ctx)

    clip_exp = lambda v: np.exp(np.clip(v, -10.0, 10.0))  # noqa: E731
    floor = lambda v: np.maximum(v, 1e-9)                 # noqa: E731
    return EntropyContext(
        mean_feat=m_f, scale_feat=floor(s_f),
        mean_scaling=m_s, scale_scaling=floor(s_s),
        mean_offsets=m_o, scale_offsets=floor(s_o),
        q_feat_adj=clip_exp(qf), q_scaling_adj=clip_exp(qs),
        q_offsets_adj=clip_exp(qo),
    )
