"""Training losses (counterpart of femasr_tpu/losses/losses.py).

The loss classes the training configs build: L1Loss, MSELoss,
CharbonnierLoss, GANLoss and MultiScaleGANLoss (vanilla, lsgan, wgan,
wgan_softplus, hinge), PerceptualLoss (VGG features, optional Gram style
term) and LPIPSLoss. All compute in float32 on NCHW tensors. The frozen
networks of PerceptualLoss and LPIPSLoss get their weights through
`bind_params` (a state dict in this package's keys), as the JAX losses get
their parameter trees; called without them they raise.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from .loss_util import weighted_loss

_reduction_modes = ['none', 'mean', 'sum']


@weighted_loss
def l1_loss(pred, target):
    return (pred - target).abs()


@weighted_loss
def mse_loss(pred, target):
    return (pred - target).square()


@weighted_loss
def charbonnier_loss(pred, target, eps=1e-12):
    return torch.sqrt((pred - target).square() + eps)


class _WeightedLoss(nn.Module):
    """Common (loss_weight, reduction) wrapper."""

    def __init__(self, loss_weight: float = 1.0, reduction: str = 'mean'):
        super().__init__()
        if reduction not in _reduction_modes:
            raise ValueError(f'Unsupported reduction mode: {reduction}. '
                             f'Supported ones are: {_reduction_modes}')
        self.loss_weight = loss_weight
        self.reduction = reduction


class L1Loss(_WeightedLoss):
    def forward(self, pred, target, weight=None):
        return self.loss_weight * l1_loss(pred.float(), target.float(),
                                          weight, reduction=self.reduction)


class MSELoss(_WeightedLoss):
    def forward(self, pred, target, weight=None):
        return self.loss_weight * mse_loss(pred.float(), target.float(),
                                           weight, reduction=self.reduction)


class CharbonnierLoss(_WeightedLoss):
    def __init__(self, loss_weight=1.0, reduction='mean', eps=1e-12):
        super().__init__(loss_weight, reduction)
        self.eps = eps

    def forward(self, pred, target, weight=None):
        return self.loss_weight * charbonnier_loss(
            pred.float(), target.float(), weight, eps=self.eps,
            reduction=self.reduction)


class _FrozenNet(nn.Module):
    """A loss that holds a frozen network, bound by `bind_params`."""

    def bind_params(self, state_dict: Mapping[str, torch.Tensor]):
        """Load the frozen network from `state_dict`, which may hold more
        (a whole VGG for a truncated one) but not less."""
        own = self.net.state_dict()
        self.net.load_state_dict({k: v for k, v in state_dict.items()
                                  if k in own}, strict=True)
        self.net.requires_grad_(False).eval()
        self.bound = True
        return self

    def _check_bound(self, what: str) -> None:
        if not getattr(self, 'bound', False):
            raise RuntimeError(
                f'{type(self).__name__} has no weights bound: load {what} '
                'and pass them through bind_params')


class LPIPSLoss(_FrozenNet):
    """LPIPS (VGG16) perceptual loss; returns (mean LPIPS * loss_weight,
    None) like the reference's pyiqa-backed version."""

    def __init__(self, loss_weight: float = 1.0):
        super().__init__()
        from .lpips import LPIPS
        self.loss_weight = loss_weight
        self.net = LPIPS()

    def forward(self, x, gt):
        self._check_bound('LPIPS-VGG weights (path.pretrain_lpips)')
        return self.net(x, gt).mean() * self.loss_weight, None


class PerceptualLoss(_FrozenNet):
    """VGG-feature perceptual loss plus an optional Gram style loss."""

    def __init__(self, layer_weights: Dict[str, float], vgg_type='vgg19',
                 use_input_norm=True, range_norm=False, perceptual_weight=1.0,
                 style_weight=0., criterion='l1'):
        super().__init__()
        from ..models.vgg_arch import VGGFeatureExtractor
        if criterion not in ('l1', 'l2', 'fro'):
            raise NotImplementedError(f'{criterion} criterion')
        self.layer_weights = dict(layer_weights)
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.criterion_type = criterion
        self.net = VGGFeatureExtractor(list(self.layer_weights), vgg_type,
                                       use_input_norm, range_norm)

    def _crit(self, a, b):
        if self.criterion_type == 'l1':
            return (a - b).abs().mean()
        if self.criterion_type == 'l2':
            return (a - b).square().mean()
        return torch.linalg.vector_norm(a - b)

    @staticmethod
    def _gram(x):
        n, c, h, w = x.shape
        f = x.float().reshape(n, c, h * w)
        return f @ f.transpose(1, 2) / (c * h * w)

    def forward(self, x, gt):
        self._check_bound('VGG weights (path.pretrain_vgg)')
        x_feats = self.net(x)
        gt_feats = self.net(gt.detach())
        percep = style = None
        if self.perceptual_weight > 0:
            percep = sum(self._crit(x_feats[k].float(), gt_feats[k].float())
                         * w for k, w in self.layer_weights.items())
            percep = percep * self.perceptual_weight
        if self.style_weight > 0:
            style = sum(self._crit(self._gram(x_feats[k]),
                                   self._gram(gt_feats[k])) * w
                        for k, w in self.layer_weights.items())
            style = style * self.style_weight
        return percep, style


class GANLoss(nn.Module):
    """vanilla / lsgan / wgan / wgan_softplus / hinge; loss_weight applies
    to generator losses only (is_disc=False)."""

    def __init__(self, gan_type: str, real_label_val=1.0, fake_label_val=0.0,
                 loss_weight=1.0):
        super().__init__()
        if gan_type not in ('vanilla', 'lsgan', 'wgan', 'wgan_softplus',
                            'hinge'):
            raise NotImplementedError(f'GAN type {gan_type} is not '
                                      'implemented.')
        self.gan_type = gan_type
        self.real_label_val = real_label_val
        self.fake_label_val = fake_label_val
        self.loss_weight = loss_weight

    def _loss(self, pred, target_is_real: bool, is_disc: bool):
        pred = pred.float()
        label = self.real_label_val if target_is_real else self.fake_label_val
        t = self.gan_type
        if t == 'hinge':
            if is_disc:
                return F.relu(1 + (-pred if target_is_real else pred)).mean()
            return -pred.mean()
        if t == 'vanilla':     # BCE with logits, in its stable form
            return (pred.clamp_min(0) - pred * label
                    + torch.log1p(torch.exp(-pred.abs()))).mean()
        if t == 'lsgan':
            return (pred - label).square().mean()
        if t == 'wgan':
            return -pred.mean() if target_is_real else pred.mean()
        return (F.softplus(-pred) if target_is_real else F.softplus(pred)
                ).mean()

    def forward(self, pred, target_is_real: bool, is_disc: bool = False):
        loss = self._loss(pred, target_is_real, is_disc)
        return loss if is_disc else loss * self.loss_weight


class MultiScaleGANLoss(GANLoss):
    """GANLoss averaged over a list of predictions (of a list, the last)."""

    def forward(self, preds, target_is_real: bool, is_disc: bool = False):
        if not isinstance(preds, (list, tuple)):
            return super().forward(preds, target_is_real, is_disc)
        total = 0.0
        for p in preds:
            if isinstance(p, (list, tuple)):
                p = p[-1]
            total = total + super().forward(p, target_is_real, is_disc)
        return total / len(preds)


LOSSES = {c.__name__: c for c in (L1Loss, MSELoss, CharbonnierLoss,
                                  LPIPSLoss, PerceptualLoss, GANLoss,
                                  MultiScaleGANLoss)}


def build_loss(opt: Mapping) -> nn.Module:
    """A loss from a YAML dict with a `type` key."""
    opt = dict(opt)
    loss_type = opt.pop('type')
    if loss_type not in LOSSES:
        raise NotImplementedError(
            f'loss {loss_type!r} is not ported (ported: {sorted(LOSSES)})')
    return LOSSES[loss_type](**opt)
