"""4-phase training controller (port of gsvc_tpu/train/controller.py;
reference: utils/train_util.py:8-93).

Maps the iteration counter onto a GenerateMode (full precision -> noise
quantized -> entropy -> STE entropy) and gates the densification
statistics, the anchor adjustment and the accumulator cleanup, with the
pause window after quantization starts.
"""

from __future__ import annotations

from gsvc_tpu_torch.config import OptimizationConfig
from gsvc_tpu_torch.models.gaussians import GenerateMode


class TrainingController:
    def __init__(self, opt: OptimizationConfig):
        self.opt = opt
        self.current_iteration = 0
        self._entropy_constrained = False

    @property
    def render_mode(self):
        o = self.opt
        it = self.current_iteration
        t1 = o.full_precision_training_total
        t2 = t1 + o.quantized_training_total
        t3 = t2 + o.entropy_constrained_train_total
        t4 = t3 + o.ste_entropy_constrained_train_total
        if it <= t1:
            return GenerateMode.FULL_PRECISION
        if it <= t2:
            return GenerateMode.QUANTIZED_NOISE
        if it <= t3:
            self._entropy_constrained = True
            return GenerateMode.ENTROPY
        if it <= t4:
            self._entropy_constrained = True
            return GenerateMode.STE_ENTROPY
        return None

    @property
    def entropy_constrained(self) -> bool:
        return self._entropy_constrained

    @property
    def gaussian_statis(self) -> bool:
        o = self.opt
        it = self.current_iteration
        t1 = o.full_precision_training_total
        if t1 <= it < t1 + o.pause_densification:
            return False
        return o.update_until > it > o.start_stat

    @property
    def gaussian_adjust_anchor(self) -> bool:
        o = self.opt
        it = self.current_iteration
        if it >= o.update_until:
            return False
        t1 = o.full_precision_training_total
        if t1 <= it <= t1 + o.pause_densification:
            return False
        return it > o.update_from and it % o.update_interval == 0

    @property
    def clean_denorm(self) -> bool:
        return self.current_iteration == self.opt.update_until

    def step(self):
        self.current_iteration += 1
