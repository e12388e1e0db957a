"""Trainer (counterpart of femasr_tpu/train): FeMaSRModel, the schedules
and the training loop."""

from .base_model import BaseModel
from .femasr_model import FeMaSRModel, optimizer_from_opt
from .lr_scheduler import (build_schedule, cosine_annealing_restart_lr,
                           multi_step_lr, multi_step_restart_lr, with_warmup)

__all__ = ['BaseModel', 'FeMaSRModel', 'optimizer_from_opt',
           'build_schedule', 'multi_step_lr', 'multi_step_restart_lr',
           'cosine_annealing_restart_lr', 'with_warmup']
