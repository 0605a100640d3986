"""Anchor-based gaussian video model: state containers + the decode-side
functions (port of ``gsvc_tpu/models/gaussians.py``).

State is a tree of NamedTuples holding tensors, padded to a fixed anchor
capacity with the anchors z-sorted over the live prefix (padding rows
carry the z = 1e9 sentinel), exactly as in the JAX package, so a frame's
Toast-like Sliding Window is one contiguous slice.

Ported modes of ``generate_neural_gaussians``: FULL_PRECISION (with
gradients, through the straight-through anchor quantization and mask),
QUANTIZED_NOISE and DECODED.  The entropy modes (ENTROPY, STE_ENTROPY)
need the hash-grid context and belong to the next slice.

Reference symbol map:
  activations                scene/gaussian_model.py:641-704
  generate_neural_gaussians  ortho_gaussian_renderer/guassian.py:134-310
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Optional

import numpy as np
import torch

from gsvc_tpu_torch.config import ModelConfig
from gsvc_tpu_torch.models.mlps import (
    deform_mlp, deform_mlp_init, deform_mlp_shapes, entropy_params_net_init,
    entropy_params_net_shapes, generator_net, generator_net_init,
    generator_net_shapes,
)
from gsvc_tpu_torch.ops.embed import positional_embedder
from gsvc_tpu_torch.ops.hashgrid import MixGridSpec, make_mix_grid_spec
from gsvc_tpu_torch.ops.quant import (
    _ste, quantize_anchor, uniform_noise_quantize,
)

# base quantization steps (reference: guassian.py:165-167)
Q_FEAT = 1.0
Q_SCALING = 0.001
Q_OFFSETS = 0.2

NEXT_SLICE = ("the entropy phases (ENTROPY, STE_ENTROPY: hash-grid kernels "
              "B3f/B3b and ops/entropy.py), the densify epoch and the "
              "encode half of the codec are the next slice of the port")


class GenerateMode(enum.IntEnum):
    """Phase-dependent treatment of anchor attributes
    (reference: guassian.py:21-27)."""

    FULL_PRECISION = 0
    QUANTIZED_NOISE = 1
    ENTROPY = 2
    STE_ENTROPY = 3
    DECODED = 4


@dataclasses.dataclass(frozen=True)
class GaussianConfig:
    """Static model shape info derived from ModelConfig."""

    feat_dim: int
    n_offsets: int
    grid: MixGridSpec
    time_multi_res: int
    offset_multi_res: int
    threshold: float
    kernel_size: float
    ste_binary: bool = True
    hash_backend: str = "auto"

    @staticmethod
    def from_model_config(mc: ModelConfig) -> "GaussianConfig":
        grid = make_mix_grid_spec(
            n_features=mc.grid_feature_dim,
            resolutions_list=mc.resolutions_list,
            log2_hashmap_size=mc.log2,
            resolutions_list_2d=mc.resolutions_list_2D,
            log2_hashmap_size_2d=mc.log2_2D,
        )
        return GaussianConfig(
            feat_dim=mc.anchor_feature_dim, n_offsets=mc.n_offsets,
            grid=grid, time_multi_res=mc.time_multi_res,
            offset_multi_res=mc.offset_multi_res, threshold=mc.threshold,
            kernel_size=mc.kernel_size, ste_binary=mc.ste_binary,
            hash_backend=mc.hash_backend)

    @property
    def pe_dim(self) -> int:
        return (1 + 2 * self.time_multi_res) + (1 + 2 * self.offset_multi_res)


class AnchorState(NamedTuple):
    """Per-anchor tensors padded to capacity N: anchor [N,3], feat [N,F],
    offset [N,K,3], mask [N,K,1], scaling [N,6] ([:3] offset scale, [3:]
    gaussian scale), rotation [N,4], opacity [N,1]
    (reference: scene/gaussian_model.py:754-800)."""

    anchor: torch.Tensor
    feat: torch.Tensor
    offset: torch.Tensor
    mask: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor


class NetParams(NamedTuple):
    """All network parameters: the flat hash table and seven MLP dicts."""

    hash_table: torch.Tensor         # [rows, F] flat mix-grid table
    mlp_opacity: dict
    mlp_cov: dict
    mlp_color: dict
    mlp_deform: dict
    mlp_feature_enet: dict
    mlp_scaling_enet: dict
    mlp_offset_enet: dict


MLP_FIELDS = ("mlp_opacity", "mlp_cov", "mlp_color", "mlp_deform",
              "mlp_feature_enet", "mlp_scaling_enet", "mlp_offset_enet")


class ModelState(NamedTuple):
    anchors: Optional[AnchorState]   # None in a decode template
    nets: NetParams
    n_active: int                    # live anchor prefix
    x_bound_min: torch.Tensor        # [1, 3]
    x_bound_max: torch.Tensor        # [1, 3]


class EntropyContext(NamedTuple):
    """Outputs of the three entropy-parameter nets
    (reference: scene/gaussian_model.py:68-78)."""

    mean_feat: object
    scale_feat: object
    mean_scaling: object
    scale_scaling: object
    mean_offsets: object
    scale_offsets: object
    q_feat_adj: object
    q_scaling_adj: object
    q_offsets_adj: object


class GeneratedGaussians(NamedTuple):
    """Flattened per-gaussian tensors of one window, [V*K, ...]."""

    xyz: torch.Tensor
    color: torch.Tensor
    opacity: torch.Tensor         # [V*K, 1] — culled rows are 0
    scaling: torch.Tensor
    rot: torch.Tensor
    valid: torch.Tensor           # [V*K] bool
    neural_opacity: torch.Tensor  # [V*K, 1] pre-cull
    anchor_xyz: torch.Tensor      # [V*K, 3] parent anchor position
    offsets_world: torch.Tensor   # [V*K, 3]


def net_param_shapes(cfg: GaussianConfig) -> dict:
    """Shapes of every NetParams leaf, as the JAX ``init_model`` makes
    them (models/gaussians.py:init_model)."""
    fd, k = cfg.feat_dim, cfg.n_offsets
    inner, cond, grid_out = fd * 2, cfg.pe_dim, cfg.grid.output_dim
    return {
        "hash_table": (cfg.grid.total_rows, cfg.grid.n_features),
        "mlp_opacity": generator_net_shapes(fd, k, inner, cond),
        "mlp_cov": generator_net_shapes(fd, 7 * k, inner, cond),
        "mlp_color": generator_net_shapes(fd, 3 * k, inner, cond),
        "mlp_deform": deform_mlp_shapes(fd + cond, fd * 2, 3 * k),
        "mlp_feature_enet": entropy_params_net_shapes(
            grid_out, fd * 3, fd, fd),
        "mlp_scaling_enet": entropy_params_net_shapes(
            grid_out, fd * 2, fd, 6, layer=3),
        "mlp_offset_enet": entropy_params_net_shapes(
            grid_out, fd * 3, fd, 3 * k),
    }


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf of nested dicts."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def net_params_template(cfg: GaussianConfig, device="cpu") -> NetParams:
    """A NetParams tree of zeros with the shapes the config implies —
    the decoder's template (every leaf is overwritten by the decoded
    weights; no random initialisation is needed)."""
    shapes = net_param_shapes(cfg)
    is_shape = lambda s: isinstance(s, tuple)  # noqa: E731

    def build(tree):
        if is_shape(tree):
            return torch.zeros(tree, dtype=torch.float32, device=device)
        return {k: build(v) for k, v in tree.items()}

    return NetParams(**{k: build(v) for k, v in shapes.items()})


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def mean_nn3_distance(points: np.ndarray) -> np.ndarray:
    """Mean squared distance to the 3 nearest neighbours, per point
    (replaces simple-knn ``distCUDA2``): exact 3-NN with a k-d tree in
    float64 on the host, as the JAX package computes it."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    if n <= 4:
        if n < 2:
            return np.full((n,), 1e-6, np.float32)
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        d2.sort(axis=1)
        return d2[:, 1:min(4, n)].mean(axis=1).astype(np.float32)
    dist, _ = cKDTree(pts).query(pts, k=4, workers=-1)
    return (dist[:, 1:4] ** 2).mean(axis=1).astype(np.float32)


def init_anchor_arrays(cfg: GaussianConfig, points: np.ndarray,
                       capacity: int, voxel_size: float = 0.001):
    """Host part of ``init_model`` (create_from_pcd,
    scene/gaussian_model.py:754-800): voxelise, z-sort, scales from the
    3-NN distance, zero offsets and features, all-ones masks, identity
    rotations, opacity logit of 0.1, padded to ``capacity`` with the
    z = 1e9 sentinel.  Returns (AnchorState fields as float32 numpy, n)."""
    pts = np.unique(np.round(points / voxel_size), axis=0) * voxel_size
    pts = pts.astype(np.float32)
    n = pts.shape[0]
    if n > capacity:
        raise ValueError(f"capacity {capacity} < initial anchors {n}")
    pts = pts[np.argsort(pts[:, 2], kind="stable")]
    dist2 = np.maximum(mean_nn3_distance(pts), 1e-7)
    scales = np.log(np.sqrt(dist2))[:, None].repeat(6, axis=1)
    k, f = cfg.n_offsets, cfg.feat_dim

    def pad(x):
        out = np.zeros((capacity,) + x.shape[1:], np.float32)
        out[:n] = x
        return out

    anchor = np.zeros((capacity, 3), np.float32)
    anchor[:n] = pts
    anchor[n:, 2] = 1e9  # padding sorts past every real z
    rots = np.zeros((n, 4), np.float32)
    rots[:, 0] = 1.0
    opacity_logit = float(np.log(0.1 / 0.9))
    fields = dict(
        anchor=anchor,
        feat=pad(np.zeros((n, f), np.float32)),
        offset=pad(np.zeros((n, k, 3), np.float32)),
        mask=pad(np.ones((n, k, 1), np.float32)),
        scaling=pad(scales),
        rotation=pad(rots),
        opacity=pad(np.full((n, 1), opacity_logit, np.float32)))
    return fields, n


def init_model(gen: torch.Generator, cfg: GaussianConfig,
               points: np.ndarray, capacity: int, voxel_size: float = 0.001,
               device="cpu") -> ModelState:
    """A ModelState from an initial point cloud (port of ``init_model``).

    The anchor arrays equal the JAX package's exactly; the network
    weights are drawn from ``gen`` with the JAX distributions (hash table
    U(-1e-4, 1e-4), linears U(+-1/sqrt(fan_in))) in the JAX order."""
    fields, n = init_anchor_arrays(cfg, points, capacity, voxel_size)
    anchors = AnchorState(**{k: torch.from_numpy(v).to(device)
                             for k, v in fields.items()})
    fd, k = cfg.feat_dim, cfg.n_offsets
    inner, cond, grid_out = fd * 2, cfg.pe_dim, cfg.grid.output_dim
    hash_table = (torch.rand((cfg.grid.total_rows, cfg.grid.n_features),
                             generator=gen, device=device) * 2.0 - 1.0) * 1e-4
    nets = NetParams(
        hash_table=hash_table,
        mlp_opacity=generator_net_init(gen, fd, k, inner, cond, device),
        mlp_cov=generator_net_init(gen, fd, 7 * k, inner, cond, device),
        mlp_color=generator_net_init(gen, fd, 3 * k, inner, cond, device),
        mlp_deform=deform_mlp_init(gen, fd + cond, fd * 2, 3 * k, device),
        mlp_feature_enet=entropy_params_net_init(
            gen, grid_out, fd * 3, fd, fd, device=device),
        mlp_scaling_enet=entropy_params_net_init(
            gen, grid_out, fd * 2, fd, 6, layer=3, device=device),
        mlp_offset_enet=entropy_params_net_init(
            gen, grid_out, fd * 3, fd, 3 * k, device=device))
    return ModelState(
        anchors=anchors, nets=nets, n_active=n,
        x_bound_min=torch.zeros((1, 3), device=device),
        x_bound_max=torch.ones((1, 3), device=device))


def update_anchor_bound(state: ModelState, x_lim, y_lim, z_lim,
                        bleed: float = 0.1) -> ModelState:
    """The learned-bounds box from the video's NDC extents + bleed."""
    lo, hi = anchor_bounds(x_lim, y_lim, z_lim, bleed)
    dev = state.x_bound_min.device
    return state._replace(x_bound_min=torch.from_numpy(lo).to(dev),
                          x_bound_max=torch.from_numpy(hi).to(dev))


def anchor_bounds(x_lim: float, y_lim: float, z_lim: float,
                  bleed: float = 0.1):
    """Learned-bounds box from the video's NDC extents + bleed
    (update_anchor_bound, scene/gaussian_model.py:706-724; the limits are
    negative): (min [1,3], max [1,3]) float32 numpy."""
    lim = np.array([[x_lim, y_lim, z_lim]], np.float32) * (1 + bleed)
    return lim, -lim


def decode_template(cfg: GaussianConfig, x_lim: float, y_lim: float,
                    z_lim: float) -> ModelState:
    """What the decoder needs before the streams: the NetParams tree of
    the config's shapes and the bounds box, which derives from the video
    geometry alone.  Lives on the CPU; the decoder moves the result."""
    lo, hi = anchor_bounds(x_lim, y_lim, z_lim)
    return ModelState(anchors=None, nets=net_params_template(cfg),
                      n_active=0, x_bound_min=torch.from_numpy(lo),
                      x_bound_max=torch.from_numpy(hi))


# ---------------------------------------------------------------------------
# Accessors (decoded=True bypasses the activations, gaussian_model.py:641-704)
# ---------------------------------------------------------------------------

def get_scaling(anchors: AnchorState, decoded: bool = False):
    return anchors.scaling if decoded else torch.exp(anchors.scaling)


def get_mask(anchors: AnchorState, decoded: bool = False):
    """Binary gaussian mask, or the decoded bits.  Undecoded: exactly
    ``sigmoid(mask) > 0.01`` forward with the sigmoid's gradient
    (straight-through, ``gsvc_tpu/models/gaussians.py:get_mask``)."""
    if decoded:
        return anchors.mask
    s = torch.sigmoid(anchors.mask)
    return _ste((s > 0.01).to(s.dtype), s)


def get_mask_anchor(anchors: AnchorState, decoded: bool = False):
    """[N] bool — anchor has at least one unmasked gaussian."""
    return (get_mask(anchors, decoded)[:, :, 0].sum(dim=1) > 0).detach()


def get_anchor(state: ModelState, decoded: bool = False):
    """Anchor positions; undecoded ones go through the 16-bit-per-axis
    quantization with a straight-through gradient (Quantize_anchor,
    utils/encodings.py:452-465)."""
    if decoded:
        return state.anchors.anchor
    return quantize_anchor(state.anchors.anchor, state.x_bound_min,
                           state.x_bound_max)


# ---------------------------------------------------------------------------
# TSW visibility window
# ---------------------------------------------------------------------------

def window_for_frame(state: ModelState, cfg: GaussianConfig, frame_z: float,
                     cap: int):
    """(start, in_window [cap] bool) for a frame plane.

    Padding rows carry the z = 1e9 sentinel, so the z test alone excludes
    them.  ``start`` is a Python int (the slice origin)."""
    z = state.anchors.anchor[:, 2].contiguous()
    fz = torch.tensor(frame_z, dtype=torch.float32, device=z.device)
    lo = (fz - cfg.threshold).reshape(1)
    start = int(torch.searchsorted(z, lo).item())
    start = min(max(start, 0), max(z.shape[0] - cap, 0))
    zw = z[start:start + cap]
    in_window = torch.abs(zw - fz) <= cfg.threshold
    return start, in_window


# ---------------------------------------------------------------------------
# Neural gaussian generation
# ---------------------------------------------------------------------------

def generate_neural_gaussians(
    state: ModelState, cfg: GaussianConfig, frame_z: float, cam_z: float,
    window_start: int, in_window: torch.Tensor, cap: int,
    mode: GenerateMode = GenerateMode.DECODED, decoded: bool = True,
    generator: Optional[torch.Generator] = None, noise=None,
) -> GeneratedGaussians:
    """Per-gaussian splat inputs for one frame window (guassian.py:134-310),
    static-shape form: culled gaussians keep their rows with opacity 0 and
    valid=False.

    QUANTIZED_NOISE adds uniform quantization noise to the window's
    features, scales and offsets, drawn from ``generator`` — or taken
    from ``noise``, a (feat [V, F], scaling [V, 6], offsets [V, K, 3])
    tuple of U[-0.5, 0.5) draws (tests inject the JAX key's)."""
    if mode in (GenerateMode.ENTROPY, GenerateMode.STE_ENTROPY):
        raise NotImplementedError(f"{mode.name} generation: {NEXT_SLICE}")
    k = cfg.n_offsets
    anchors = state.anchors
    sl = slice(window_start, window_start + cap)

    anchor_w = get_anchor(state, decoded)[sl]                    # [V, 3]
    feat = anchors.feat[sl]                                      # [V, F]
    grid_offsets = anchors.offset[sl]                            # [V, K, 3]
    all_scaling = get_scaling(anchors, decoded)
    grid_scaling = all_scaling[sl]                               # [V, 6]
    binary_mask = get_mask(anchors, decoded)[sl]                 # [V, K, 1]

    if mode == GenerateMode.QUANTIZED_NOISE:
        # clamp centres: whole-model means, gradient-free
        n_feat, n_scal, n_off = noise if noise is not None else (None,) * 3
        feat = uniform_noise_quantize(
            feat, Q_FEAT, generator, x_mean=anchors.feat.mean().detach(),
            noise=n_feat)
        grid_scaling = uniform_noise_quantize(
            grid_scaling, Q_SCALING, generator,
            x_mean=all_scaling.mean().detach(), noise=n_scal)
        grid_offsets = uniform_noise_quantize(
            grid_offsets, Q_OFFSETS, generator,
            x_mean=anchors.offset.mean().detach(), noise=n_off)

    # conditions: embed(cam_z) and embed(anchor_z - cam_z)
    embed_time, _ = positional_embedder(cfg.time_multi_res, 1)
    embed_z, _ = positional_embedder(cfg.offset_multi_res, 1)
    cz = torch.tensor(cam_z, dtype=torch.float32, device=feat.device)
    abs_z = torch.full_like(anchor_w[:, 2:], float(cz))
    ob_z = anchor_w[:, 2:] - cz
    pe = torch.cat([embed_time(abs_z), embed_z(ob_z)], dim=-1)

    v = cap
    nets = state.nets
    neural_opacity = generator_net(nets.mlp_opacity, feat, pe,
                                   out_act=torch.tanh)           # [V, K]
    neural_opacity = neural_opacity.reshape(v * k, 1) \
        * binary_mask.reshape(v * k, 1)
    g_valid = (neural_opacity[:, 0] > 0.0) \
        & torch.repeat_interleave(in_window, k, dim=0)

    color = generator_net(nets.mlp_color, feat, pe,
                          out_act=torch.sigmoid).reshape(v * k, 3)
    scale_rot = generator_net(nets.mlp_cov, feat, pe).reshape(v * k, 7)
    neural_offset = deform_mlp(nets.mlp_deform,
                               torch.cat([feat, pe], dim=-1))
    neural_offset = neural_offset.reshape(v * k, 3)

    offsets = grid_offsets.reshape(v * k, 3) + neural_offset
    offset_scale = torch.repeat_interleave(grid_scaling[:, :3], k, dim=0)
    gauss_scale_base = torch.repeat_interleave(grid_scaling[:, 3:], k, dim=0)
    anchor_rep = torch.repeat_interleave(anchor_w, k, dim=0)

    scaling_g = gauss_scale_base * torch.sigmoid(scale_rot[:, :3])
    rot = scale_rot[:, 3:7]
    rot_g = rot / torch.linalg.norm(rot, dim=-1, keepdim=True).clamp_min(
        1e-12)

    offsets_world = offsets * offset_scale
    xyz = torch.minimum(torch.maximum(anchor_rep + offsets_world,
                                      state.x_bound_min), state.x_bound_max)

    return GeneratedGaussians(
        xyz=xyz, color=color,
        opacity=torch.where(g_valid[:, None], neural_opacity,
                            torch.zeros_like(neural_opacity)),
        scaling=scaling_g, rot=rot_g, valid=g_valid,
        neural_opacity=neural_opacity, anchor_xyz=anchor_rep,
        offsets_world=offsets_world)
