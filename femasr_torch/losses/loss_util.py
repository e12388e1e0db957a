"""Weighted-loss reduction (counterpart of femasr_tpu/losses/loss_util.py).
Tensors are NCHW: channels are dim 1."""

from __future__ import annotations

import functools
from typing import Optional

import torch


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == 'none':
        return loss
    if reduction == 'mean':
        return loss.mean()
    if reduction == 'sum':
        return loss.sum()
    raise ValueError(f'invalid reduction: {reduction}')


def weight_reduce_loss(loss: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       reduction: str = 'mean') -> torch.Tensor:
    """Apply an elementwise weight, then reduce; with a weight, 'mean'
    divides the sum by the weight's sum (a 1-channel weight counts once per
    channel of the loss)."""
    if weight is not None:
        loss = loss * weight
    if weight is None or reduction == 'sum':
        return reduce_loss(loss, reduction)
    if reduction == 'mean':
        denom = weight.sum()
        if weight.shape[1] == 1 and loss.shape[1] > 1:
            denom = denom * loss.shape[1]
        return loss.sum() / denom
    return loss


def weighted_loss(loss_func):
    """Decorator adding (weight=None, reduction='mean') to an elementwise
    loss."""

    @functools.wraps(loss_func)
    def wrapper(pred, target, weight=None, reduction='mean', **kwargs):
        return weight_reduce_loss(loss_func(pred, target, **kwargs), weight,
                                  reduction)

    return wrapper
