"""Configuration dataclasses, the PyTorch port's copy of ``gsvc_tpu.config``.

Field names, defaults and the YAML overlay are identical to the JAX
package, so ``cfgs/*.yaml`` files and the ``model_config`` dict a
bitstream carries load unchanged.  The JAX package's execution knobs are
kept so configs round-trip; among them ``pipeline.matmul_dtype`` is the
compositing precision mode of every compositing kernel
(``render/mirror.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class ModelConfig:
    """Model hyperparameters (reference: arguments/__init__.py:50-77)."""

    sh_degree: int = 0
    threshold: float = 0.1          # TSW render horizon (z half width, NDC)
    kernel_size: float = 0.3        # low-pass filter added to 2D covariance
    anchor_feature_dim: int = 50
    n_offsets: int = 10             # K gaussians per anchor
    voxel_size: float = 0.001
    update_depth: int = 3
    update_init_factor: int = 16
    update_hierarchy_factor: int = 4

    time_multi_res: int = 16        # positional-embedding freqs for cam z
    offset_multi_res: int = 16      # … for (anchor z - cam z)

    log2: int = 13                  # 3D hash table size (log2)
    log2_2D: int = 15               # 2D hash table size (log2)
    grid_feature_dim: int = 4       # features per hash level

    use_feat_bank: bool = False
    resolution: int = -1
    white_background: bool = False

    # Hash grid resolutions (reference: scene/gaussian_model.py:280-281)
    resolutions_list: Tuple[int, ...] = (
        18, 24, 33, 44, 59, 80, 108, 148, 201, 275, 376, 514)
    resolutions_list_2D: Tuple[int, ...] = (130, 258, 514, 1026)
    ste_binary: bool = True         # binarize hash embeddings with STE
    use_2D: bool = True             # Mix3d2d: one 3D grid + xy/xz/yz 2D grids
    hash_backend: str = "auto"      # JAX package's hash-encode backend


@dataclass
class PipelineConfig:
    """IO / execution paths (reference: arguments/__init__.py:115-134)."""

    source_path: str = ""
    optical_path: str = ""
    model_path: str = ""
    init_point_cloud: str = ""
    skip_prefetch: bool = False
    debug: bool = False

    # --- execution knobs of the JAX package (kept so configs round-trip;
    # the port's decoder reads none of them) ---
    visible_capacity: int = 0
    gaussian_chunk: int = 128
    tile_h: int = 8
    tile_w: int = 128
    use_pallas: bool = True
    overflow_autogrow: bool = True
    mesh_shape: str = ""
    steps_per_dispatch: int = 0
    copy_budget_factor: int = 0
    device_densify: bool = True
    matmul_dtype: str = "float32"
    rasterizer: str = ""


@dataclass
class OptimizationConfig:
    """Optimization schedule (reference: arguments/__init__.py:144-244)."""

    iterations: int = 40_000

    position_lr_init: float = 0.0   # anchors are frozen in place
    position_lr_final: float = 0.0
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 40_000

    offset_lr_init: float = 0.01
    offset_lr_final: float = 0.0001
    offset_lr_delay_mult: float = 0.01
    offset_lr_max_steps: int = 40_000

    mask_lr_init: float = 0.01
    mask_lr_final: float = 0.0001
    mask_lr_delay_mult: float = 0.01
    mask_lr_max_steps: int = 40_000

    feature_lr: float = 0.0075
    opacity_lr: float = 0.02
    scaling_lr: float = 0.007
    rotation_lr: float = 0.002

    mlp_opacity_lr_init: float = 0.002
    mlp_opacity_lr_final: float = 0.00002
    mlp_opacity_lr_delay_mult: float = 0.01
    mlp_opacity_lr_max_steps: int = 40_000

    mlp_cov_lr_init: float = 0.004
    mlp_cov_lr_final: float = 0.004
    mlp_cov_lr_delay_mult: float = 0.01
    mlp_cov_lr_max_steps: int = 40_000

    mlp_color_lr_init: float = 0.008
    mlp_color_lr_final: float = 0.00005
    mlp_color_lr_delay_mult: float = 0.01
    mlp_color_lr_max_steps: int = 40_000

    encoding_xyz_lr_init: float = 0.005
    encoding_xyz_lr_final: float = 0.00001
    encoding_xyz_lr_delay_mult: float = 0.33
    encoding_xyz_lr_max_steps: int = 40_000

    mlp_deform_lr_init: float = 0.005
    mlp_deform_lr_final: float = 0.0005
    mlp_deform_lr_delay_mult: float = 0.01
    mlp_deform_lr_max_steps: int = 40_000

    mlp_entropy_net_lr_init: float = 0.005
    mlp_entropy_net_lr_final: float = 0.0005
    mlp_entropy_net_lr_delay_mult: float = 0.01
    mlp_entropy_net_lr_max_steps: int = 40_000

    init_anchor_num: int = 10_000
    lmbda: float = 0.001            # rate-distortion trade-off

    percent_dense: float = 0.01
    lambda_dssim: float = 0.2

    # densification windows (reference: arguments/__init__.py:216-227)
    start_stat: int = 500
    update_from: int = 1500
    update_interval: int = 100
    update_until: int = 25_000
    pause_densification: int = 1_000

    scaling_reg: float = 0.01
    opacity_reg: float = 0.0
    optical_lambda: float = 5.0

    # 4-phase schedule (reference: arguments/__init__.py:232-235)
    full_precision_training_total: int = 10_000
    quantized_training_total: int = 5_000
    entropy_constrained_train_total: int = 20_000
    ste_entropy_constrained_train_total: int = 5_000

    min_opacity: float = 0.005
    success_threshold: float = 0.8
    densify_grad_threshold: float = 0.0005
    # calibrate densify_grad_threshold at the first densify event so the
    # candidate fraction matches the reference's growth dynamics in OUR
    # (NDC) gradient units — see train/calibrate.py
    auto_densify_threshold: bool = False
    densify_target_fraction: float = 0.04

    mask_reg: float = 5e-4          # sigmoid-mask regularizer weight


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)


def _apply_overrides(obj, overrides: dict, path: str):
    valid = {f.name for f in dataclasses.fields(obj)}
    for k, v in overrides.items():
        if k not in valid:
            raise KeyError(f"unknown config key {path}.{k}")
        cur = getattr(obj, k)
        if isinstance(cur, tuple) and isinstance(v, list):
            v = tuple(v)
        setattr(obj, k, v)


def load_config(yaml_path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    """Build a Config, optionally overlaying a YAML file and a flat dict.

    YAML layout mirrors the reference's cfgs/*.yaml: top-level sections
    ``model`` / ``pipeline`` / ``optimization`` with field names inside.
    ``overrides`` accepts dotted keys like ``"optimization.lmbda"``.
    """
    cfg = Config()
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        for section in ("model", "pipeline", "optimization"):
            if section in data and data[section]:
                _apply_overrides(getattr(cfg, section), data[section], section)
    if overrides:
        for key, v in overrides.items():
            section, _, name = key.partition(".")
            if not name:
                raise KeyError(f"override key must be dotted: {key}")
            _apply_overrides(getattr(cfg, section), {name: v}, section)
    return cfg


def save_config(cfg: Config, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(
            {
                "model": dataclasses.asdict(cfg.model),
                "pipeline": dataclasses.asdict(cfg.pipeline),
                "optimization": dataclasses.asdict(cfg.optimization),
            },
            f,
        )
