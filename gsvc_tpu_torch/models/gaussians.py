"""Anchor-based gaussian video model: state containers + the decode-side
functions (port of ``gsvc_tpu/models/gaussians.py``).

State is a tree of NamedTuples holding tensors, padded to a fixed anchor
capacity with the anchors z-sorted over the live prefix (padding rows
carry the z = 1e9 sentinel), exactly as in the JAX package, so a frame's
Toast-like Sliding Window is one contiguous slice.

Ported modes of ``generate_neural_gaussians``: FULL_PRECISION and
DECODED (the decoder's), forward only.  The quantization-noise and
entropy modes belong to the training slice.

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
    deform_mlp, deform_mlp_shapes, entropy_params_net_shapes, generator_net,
    generator_net_shapes,
)
from gsvc_tpu_torch.ops.embed import positional_embedder
from gsvc_tpu_torch.ops.hashgrid import MixGridSpec, make_mix_grid_spec

# base quantization steps (reference: guassian.py:165-167)
Q_FEAT = 1.0
Q_SCALING = 0.001
Q_OFFSETS = 0.2

ANCHOR_ROUND_DIGITS = 16
Q_ANCHOR = 1.0 / (2 ** ANCHOR_ROUND_DIGITS - 1)
# symbol clamp half-range shared by the quantizers and the coder
CLAMP_BOUND = 15_000


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
    """Binary gaussian mask: sigmoid(mask) > 0.01 (the forward value of
    the JAX straight-through estimator), or the decoded bits."""
    if decoded:
        return anchors.mask
    return (torch.sigmoid(anchors.mask) > 0.01).to(anchors.mask.dtype)


def get_mask_anchor(anchors: AnchorState, decoded: bool = False):
    """[N] bool — anchor has at least one unmasked gaussian."""
    return get_mask(anchors, decoded)[:, :, 0].sum(dim=1) > 0


def get_anchor(state: ModelState, decoded: bool = False):
    """Anchor positions; undecoded ones go through the 16-bit-per-axis
    quantization (Quantize_anchor, utils/encodings.py:452-465)."""
    a = state.anchors.anchor
    if decoded:
        return a
    lo, hi = state.x_bound_min, state.x_bound_max
    interval = (hi - lo) * Q_ANCHOR + 1e-6
    q = torch.clamp(torch.floor((a - lo) / interval),
                    0, 2 ** ANCHOR_ROUND_DIGITS - 1)
    return q * interval + lo


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
) -> GeneratedGaussians:
    """Per-gaussian splat inputs for one frame window (guassian.py:134-310),
    static-shape form: culled gaussians keep their rows with opacity 0 and
    valid=False."""
    if mode not in (GenerateMode.FULL_PRECISION, GenerateMode.DECODED):
        raise NotImplementedError(
            f"{mode.name} generation is not ported (training slice)")
    k = cfg.n_offsets
    anchors = state.anchors
    sl = slice(window_start, window_start + cap)

    anchor_w = get_anchor(state, decoded)[sl]                    # [V, 3]
    feat = anchors.feat[sl]                                      # [V, F]
    grid_offsets = anchors.offset[sl]                            # [V, K, 3]
    grid_scaling = get_scaling(anchors, decoded)[sl]             # [V, 6]
    binary_mask = get_mask(anchors, decoded)[sl]                 # [V, K, 1]

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
        neural_opacity=neural_opacity, offsets_world=offsets_world)
