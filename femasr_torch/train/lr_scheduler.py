"""Learning-rate schedules as functions of the step (counterpart of
femasr_tpu/train/lr_scheduler.py).

`build_schedule(opt, base_lr, warmup_iter)(step)` is the learning rate of
optimizer update number `step` (0 for the first), the indexing of the JAX
package's optax schedules. The trainer sets it on its optimizer before
every update; no torch scheduler object holds state.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence


def multi_step_lr(base_lr: float, milestones: Sequence[int],
                  gamma: float = 0.1) -> Callable[[int], float]:
    """torch MultiStepLR: base_lr * gamma^(milestones passed)."""
    milestones = sorted(int(m) for m in milestones)

    def schedule(step: int) -> float:
        return base_lr * gamma ** sum(step >= m for m in milestones)

    return schedule


def multi_step_restart_lr(base_lr: float, milestones: Sequence[int],
                          gamma: float = 0.1,
                          restarts: Sequence[int] = (0,),
                          restart_weights: Sequence[float] = (1,)
                          ) -> Callable[[int], float]:
    """MultiStepLR with restarts: at each restart the rate goes back to
    base_lr * weight, and only later milestones count."""
    assert len(restarts) == len(restart_weights), (
        'restarts and their weights need to match.')
    milestones = sorted(int(m) for m in milestones)
    restarts = [int(r) for r in restarts]

    def schedule(step: int) -> float:
        weight, last = 1.0, 0
        for r, w in zip(restarts, restart_weights):
            if step >= r:
                weight, last = w, r
        count = sum(step >= m and m > last for m in milestones)
        return base_lr * weight * gamma ** count

    return schedule


def cosine_annealing_restart_lr(base_lr: float, periods: Sequence[int],
                                restart_weights: Sequence[float] = (1,),
                                eta_min: float = 0
                                ) -> Callable[[int], float]:
    """Cosine annealing with restarts; a period's last step belongs to it
    (the first i with step <= cumulative[i])."""
    assert len(periods) == len(restart_weights), (
        'periods and restart_weights should have the same length.')
    cumulative = [sum(periods[:i + 1]) for i in range(len(periods))]

    def schedule(step: int) -> float:
        for i, cum in enumerate(cumulative):
            if step <= cum:
                start = cumulative[i - 1] if i else 0
                return eta_min + restart_weights[i] * 0.5 * (
                    base_lr - eta_min) * (1 + math.cos(
                        math.pi * (step - start) / periods[i]))
        return eta_min

    return schedule


def with_warmup(schedule: Callable[[int], float], warmup_iter: int
                ) -> Callable[[int], float]:
    """Linear warmup over the first warmup_iter steps."""
    if warmup_iter <= 0:
        return schedule

    def warmed(step: int) -> float:
        target = schedule(step)
        return target * (step / warmup_iter) if step < warmup_iter \
            else target

    return warmed


def build_schedule(scheduler_opt: Optional[dict], base_lr: float,
                   warmup_iter: int = -1) -> Callable[[int], float]:
    """The schedule of a YAML `train.scheduler` dict."""
    opt = dict(scheduler_opt or {'type': 'MultiStepLR', 'milestones': [],
                                 'gamma': 1})
    stype = opt.pop('type')
    if stype == 'MultiStepLR':
        sched = multi_step_lr(base_lr, opt.get('milestones', []),
                              opt.get('gamma', 0.1))
    elif stype == 'MultiStepRestartLR':
        sched = multi_step_restart_lr(base_lr, opt.get('milestones', []),
                                      opt.get('gamma', 0.1),
                                      opt.get('restarts', [0]),
                                      opt.get('restart_weights', [1]))
    elif stype == 'CosineAnnealingRestartLR':
        sched = cosine_annealing_restart_lr(base_lr, opt['periods'],
                                            opt.get('restart_weights', [1]),
                                            opt.get('eta_min', 0))
    else:
        raise NotImplementedError(f'Scheduler {stype} is not implemented yet.')
    return with_warmup(sched, warmup_iter)
