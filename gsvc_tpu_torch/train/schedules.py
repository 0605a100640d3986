"""Learning-rate schedules (port of gsvc_tpu/train/schedules.py;
reference: utils/general_utils.py:49-82).

Log-linear interpolation from lr_init to lr_final over max_steps with an
optional sine delay ramp, evaluated on the host per step.
"""

from __future__ import annotations

import numpy as np


def expon_lr(lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000,
             step_sub: int = 0):
    def helper(step: int) -> float:
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        if lr_delay_steps > 0:
            delay = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
                0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1))
        else:
            delay = 1.0
        t = np.clip((step - step_sub) / (max_steps - step_sub), 0, 1)
        return float(delay * np.exp(np.log(lr_init) * (1 - t)
                                    + np.log(lr_final) * t))

    return helper


def build_schedules(opt, spatial_lr_scale: float = 1.0, ste_binary=True):
    """Name -> lr(step) for every parameter group (training_setup's
    registry, scene/gaussian_model.py:844-1058)."""
    def const(v):
        return lambda step: float(v)

    return {
        "anchor": expon_lr(opt.position_lr_init * spatial_lr_scale,
                           opt.position_lr_final * spatial_lr_scale,
                           lr_delay_mult=opt.position_lr_delay_mult,
                           max_steps=opt.position_lr_max_steps),
        "offset": expon_lr(opt.offset_lr_init * spatial_lr_scale,
                           opt.offset_lr_final * spatial_lr_scale,
                           lr_delay_mult=opt.offset_lr_delay_mult,
                           max_steps=opt.offset_lr_max_steps),
        "mask": expon_lr(opt.mask_lr_init * spatial_lr_scale,
                         opt.mask_lr_final * spatial_lr_scale,
                         lr_delay_mult=opt.mask_lr_delay_mult,
                         max_steps=opt.mask_lr_max_steps),
        "feat": const(opt.feature_lr),
        "opacity": const(0.0),    # frozen (requires_grad=False in reference)
        "scaling": const(opt.scaling_lr),
        "rotation": const(0.0),   # frozen
        "mlp_opacity": expon_lr(opt.mlp_opacity_lr_init,
                                opt.mlp_opacity_lr_final,
                                lr_delay_mult=opt.mlp_opacity_lr_delay_mult,
                                max_steps=opt.mlp_opacity_lr_max_steps),
        "mlp_cov": expon_lr(opt.mlp_cov_lr_init, opt.mlp_cov_lr_final,
                            lr_delay_mult=opt.mlp_cov_lr_delay_mult,
                            max_steps=opt.mlp_cov_lr_max_steps),
        "mlp_color": expon_lr(opt.mlp_color_lr_init, opt.mlp_color_lr_final,
                              lr_delay_mult=opt.mlp_color_lr_delay_mult,
                              max_steps=opt.mlp_color_lr_max_steps),
        "hash": expon_lr(opt.encoding_xyz_lr_init, opt.encoding_xyz_lr_final,
                         lr_delay_mult=opt.encoding_xyz_lr_delay_mult,
                         max_steps=opt.encoding_xyz_lr_max_steps,
                         step_sub=0 if ste_binary else 10000),
        "mlp_deform": expon_lr(opt.mlp_deform_lr_init,
                               opt.mlp_deform_lr_final,
                               lr_delay_mult=opt.mlp_deform_lr_delay_mult,
                               max_steps=opt.mlp_deform_lr_max_steps),
        "mlp_enet": expon_lr(opt.mlp_entropy_net_lr_init,
                             opt.mlp_entropy_net_lr_final,
                             lr_delay_mult=opt.mlp_entropy_net_lr_delay_mult,
                             max_steps=opt.mlp_entropy_net_lr_max_steps),
    }
