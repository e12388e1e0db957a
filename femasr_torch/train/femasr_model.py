"""FeMaSR GAN trainer (counterpart of femasr_tpu/train/femasr_model.py).

One iteration, in the JAX step's order and with its gates:
  0. LQ stage with `datasets.train.on_device_degradation`: the LQ batch is
     synthesized from the GT batch on the device (the BSRGAN degradation,
     ops/degradations.py), the whole batch before any chunking, with a
     generator seeded from (manual_seed, step): no state of its own, so a
     resumed run replays the degradations of the uninterrupted one. The
     HQ stage ignores the flag.
  1. LQ stage: the frozen HQ prior reconstructs the GT batch under
     torch.no_grad() and gives the GT code indices (its conv3 tail and its
     codebook search run as kernels).
  2. HQ stage with the semantic loss: frozen VGG19 relu4_4 features of GT.
  3. Generator step: codebook, semantic, pixel, perceptual and (gated by
     `current_iter > net_d_init_iters`) GAN losses through the
     discriminator without a spectral update and without discriminator
     gradients; the forward is differentiable (model.forward(...,
     differentiable=True)), so the conv3 tail and the attention take the
     kernels' plain versions, and only the trainee's codebook search, on
     detached tokens, is a kernel. With grad_accum_chunks = K the batch
     runs in K equal chunks whose gradients average. One optimizer update
     (frozen modules, by frozen_module_keywords in the LQ stage, are not
     handed to the optimizer).
  4. Discriminator step (unless fixed_disc): the hinge loss on GT with one
     power iteration of every spectral-norm conv, then on the generator's
     output with one more; the two gradients add and one update follows.
     Gated off, neither the parameters nor the spectral vectors change.
  5. The EMA of the generator's parameters (ema_decay > 0).
The learning rate of update k is the schedule at step k.

Precision (`network_g.dtype`, `network_d.dtype`: float32 or bfloat16, as
the JAX trainer): the trainee computes in its dtype from the input cast
to it; the frozen prior runs in network_g's dtype with the f32 search,
the semantic loss's VGG19 too (on GT cast to it); the discriminator casts
its input to its own dtype. The losses take the f32 output. Parameters,
Adam moments, the EMA and every checkpoint stay float32, so a bf16 run
saves the same .pth as an f32 one. `network_g.use_checkpoint`
recomputes the Swin blocks' activations in the backward.

Data parallel (`opt['dist']`, one process per device): net_g and net_d
train wrapped in DistributedDataParallel, which averages their gradients
over the ranks once per step (the chunks and the discriminator's real
phase run under no_sync); the G step's GAN term runs the bare
discriminator, whose frozen parameters get no gradient; the frozen prior,
VGG19 and the EMA copy stay bare. Each rank trains on its block of the
global batch; the on-device degradation degrades the whole global batch on
every rank (the same draws) and keeps the rank's block, so W ranks at
batch B compute what one process computes at W x B. Logged values are
means over the ranks, the codebook perplexity that of the global batch.
Rank 0 writes the checkpoints and the training state, which holds every
rank's RNG state.

Validation (`validation`, every `val.val_freq` iterations) and offline
evaluation (test_cli) serve the trainee, or with ema_decay > 0 one eval
copy holding the EMA weights, through SRInferencer's live-module form
(no_grad, eval mode, the conv3 tail, attention and search as kernels) in
network_g's dtype: whole images below 8000^2 px, tiles above. The
metrics see the output's 8-bit levels in RGB, as tensor2img writes them,
against the GT as read. `dist_validation` gives rank r the images whose
index is r modulo the world size; each rank writes its own images, the
per-image metrics are all-reduced and averaged in image order, so the
results equal `nondist_validation`'s; rank 0 saves the best networks.

Tensor parallel (`model_parallel: N`, under a launcher): the ranks form a
('data', 'model') mesh (rank = d * N + m). net_g and the frozen prior are
split over the model ranks of each data group (`FeMaSRNet(tp=...)`: the
Swin linears and the codebooks); the discriminator, VGG19 and LPIPS stay
whole, as in the JAX trainer. Everything above that follows the data
rank: the loader's block, the degradation's kept block, DDP and the
logged means (over the data group), validation's images (data rank r
takes the images r modulo the data size; model rank 0 fills the metric
rows and writes the images). Before each update the gradients of the
tensors held whole on every model rank (net_g's other tensors, all of
net_d's) are broadcast from model rank 0, which keeps their copies
bit-equal (`parallel.tensor_parallel.broadcast_grads`). Checkpoints and
the training state are written whole (every model rank gathers net_g,
its EMA and the optimizer moments of the split parameters before rank 0
writes), so a .pth of a split run loads strictly into one process and
back; a resume takes the rank's parts of the whole state.
"""

from __future__ import annotations

import contextlib
import os
from collections import OrderedDict
from os import path as osp
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel
from torch.utils.data import default_collate

from ..data.loader import DevicePrefetcher
from ..losses import LPIPSLoss, PerceptualLoss, build_loss
from ..losses.lpips import convert_lpips_checkpoint
from ..metrics import create_metric
from ..models.convert import load_torch_checkpoint, merge_state_dict
from ..models.discriminator_arch import UNetDiscriminatorSN, init_discriminator
from ..models.femasr_arch import FeMaSRNet, init_weights
from ..models.inference import SRInferencer, resolve_device
from ..models.vgg_arch import (VGGFeatureExtractor, convert_vgg_checkpoint,
                               vgg_truncated_state)
from ..ops.degradations import degradation_bsrgan
from ..ops.quantize import code_counts, perplexity_of_counts
from ..parallel.dist_util import all_gather_object, is_dist
from ..parallel.mesh import (create_mesh, gather_batch, gather_state_dict,
                             local_slice, local_state, split_layout)
from ..parallel.tensor_parallel import (ModelAxis, all_gather,
                                        broadcast_grads, model_axis, shard,
                                        unshard)
from ..utils.img_util import imwrite, round_8bit
from ..utils.logger import get_root_logger
from .base_model import BaseModel
from .lr_scheduler import build_schedule

# network_g option keys that configure the trainer or the search, not
# FeMaSRNet (the port's search is always the f32 kernel)
_TRAINER_KEYS = ('type', 'frozen_module_keywords', 'vq_backend',
                 'vq_index_f32', 'dtype')
DTYPES = {None: torch.float32, 'float32': torch.float32,
          'bfloat16': torch.bfloat16}


def compute_dtype(opt: Mapping) -> torch.dtype:
    """The compute dtype of a network_g / network_d options dict."""
    return DTYPES[opt.get('dtype')]


def build_generator(opt: Mapping, tp: Optional[ModelAxis] = None
                    ) -> FeMaSRNet:
    if opt.get('type', 'FeMaSRNet') != 'FeMaSRNet':
        raise NotImplementedError(f'network {opt["type"]!r} is not ported')
    return FeMaSRNet(**{k: v for k, v in opt.items()
                        if k not in _TRAINER_KEYS}, tp=tp)


def build_discriminator(opt: Mapping) -> UNetDiscriminatorSN:
    if opt.get('type', 'UNetDiscriminatorSN') != 'UNetDiscriminatorSN':
        raise NotImplementedError(f'network {opt["type"]!r} is not ported')
    return UNetDiscriminatorSN(dtype=compute_dtype(opt), **{
        k: v for k, v in opt.items() if k not in ('type', 'dtype')})


def frozen_names(names, keywords) -> set:
    """Parameter names holding any of the keywords (path substrings)."""
    return {n for n in names if any(kw in n for kw in keywords or ())}


def optimizer_from_opt(optim_opt: Mapping, params) -> torch.optim.Optimizer:
    """torch.optim optimizer of a YAML `optim_*` dict: Adam (coupled L2
    weight decay, as torch.optim.Adam and the JAX package's
    add_decayed_weights + adam), AdamW (decoupled), SGD. The learning rate
    is the schedule's, set before each update."""
    opt = dict(optim_opt)
    otype = opt.pop('type', 'Adam')
    lr = float(opt.get('lr', 1e-4))
    betas = tuple(opt.get('betas', (0.9, 0.999)))
    wd = float(opt.get('weight_decay', 0) or 0)
    if otype == 'Adam':
        return torch.optim.Adam(params, lr=lr, betas=betas, weight_decay=wd)
    if otype == 'AdamW':
        return torch.optim.AdamW(params, lr=lr, betas=betas, weight_decay=wd)
    if otype == 'SGD':
        return torch.optim.SGD(params, lr=lr,
                               momentum=opt.get('momentum', 0) or 0,
                               nesterov=bool(opt.get('nesterov', False)))
    raise ValueError(f'unsupported optimizer type {otype!r} '
                     '(supported: Adam, AdamW, SGD)')


def _seed_init(seed: int):
    return lambda m: init_weights(m, torch.Generator().manual_seed(seed))


def _sync_if(net: torch.nn.Module, sync: bool):
    """A DDP net's gradients are all-reduced in the backward that follows
    a forward made with sync true; with sync false they accumulate on the
    rank (no_sync)."""
    if sync or not isinstance(net, DistributedDataParallel):
        return contextlib.nullcontext()
    return net.no_sync()


class FeMaSRModel(BaseModel):
    """The trainer: options in, `feed_data` + `optimize_parameters` per
    iteration, `save` / `resume_training` for checkpoints."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        logger = get_root_logger()
        self.device = resolve_device(opt.get('device', 'cuda'))
        if self.dist and is_dist():
            self.mesh = create_mesh(
                model=int(opt.get('model_parallel', 1) or 1),
                device_type=self.device.type)
        self.tp = model_axis(self.mesh)
        self.seed = int(opt.get('manual_seed', 0) or 0)
        nopt = opt['network_g']
        self.dtype = compute_dtype(nopt)
        if self.dtype != torch.float32 and 'vq_index_f32' not in nopt:
            logger.info('network_g.dtype bfloat16: the codebook searches '
                        'run in float32 (vq_index_f32: true); the JAX '
                        'trainer would search the trainee\'s tokens with '
                        'bfloat16 cross terms')
        self.net_g = build_generator(nopt, self.tp)
        self.layout_g = split_layout(self.net_g)
        init_weights(self.net_g, torch.Generator().manual_seed(self.seed))
        self.LQ_stage = self.net_g.LQ_stage
        self.scale = self.net_g.scale_factor
        self.n_e = self.net_g.codebook_params[0][1]

        # the frozen HQ prior of the LQ stage; the LQ net starts from it
        self.net_hq = None
        if self.LQ_stage:
            load_path = opt['path'].get('pretrain_network_hq')
            if self.is_train and load_path is None:
                raise ValueError('Need to specify hq prior model path in LQ '
                                 'stage (path.pretrain_network_hq)')
            if load_path is not None:
                hq_sd = load_torch_checkpoint(load_path)
                self.net_hq = build_generator(dict(nopt, LQ_stage=False),
                                              self.tp)
                merge_state_dict(self.net_hq, hq_sd, _seed_init(self.seed))
                self.net_hq.requires_grad_(False).eval()
                merge_state_dict(self.net_g, hq_sd, _seed_init(self.seed))
        load_path = opt['path'].get('pretrain_network_g')
        if load_path is not None:
            logger.info(f'Loading net_g from {load_path}')
            merge_state_dict(self.net_g, load_torch_checkpoint(load_path),
                             _seed_init(self.seed))
        self.net_g.to(self.device)
        if self.net_hq is not None:
            self.net_hq.to(self.device)
        self.lpips_sd = self._load_lpips()
        self.vgg_sd = self._load_vgg()
        self.ema = None
        self.net_g_ema = None       # the eval copy of the EMA weights
        self._inferencer = None
        if self.is_train:
            self.init_training_settings()
        else:
            self.net_g.requires_grad_(False).eval()

    # -- setup -----------------------------------------------------------

    def _load_lpips(self) -> Optional[Dict[str, torch.Tensor]]:
        path = self.opt['path'].get('pretrain_lpips')
        if not path or not os.path.exists(path):
            return None
        return convert_lpips_checkpoint(load_torch_checkpoint(path, None))

    def _load_vgg(self) -> Optional[Dict[str, torch.Tensor]]:
        path = self.opt['path'].get('pretrain_vgg')
        if not path or not os.path.exists(path):
            return None
        return convert_vgg_checkpoint(load_torch_checkpoint(path, None),
                                      'vgg19')

    def init_training_settings(self) -> None:
        logger = get_root_logger()
        opt, train_opt = self.opt, self.opt['train']

        self.net_d = build_discriminator(opt['network_d'])
        init_discriminator(self.net_d, torch.Generator().manual_seed(1))
        load_path = opt['path'].get('pretrain_network_d')
        if load_path is not None:
            logger.info(f'Loading net_d from {load_path}')
            merge_state_dict(self.net_d, load_torch_checkpoint(load_path),
                             lambda m: init_discriminator(m))
        self.net_d.to(self.device)

        self.cri_pix = (build_loss(train_opt['pixel_opt']).to(self.device)
                        if train_opt.get('pixel_opt') else None)
        self.cri_perceptual = None
        if train_opt.get('perceptual_opt'):
            cri = build_loss(train_opt['perceptual_opt'])
            if isinstance(cri, LPIPSLoss) and self.lpips_sd is None:
                logger.warning('LPIPS weights unavailable (set '
                               'path.pretrain_lpips); perceptual loss '
                               'DISABLED for this run.')
            elif isinstance(cri, PerceptualLoss) and self.vgg_sd is None:
                logger.warning('VGG weights unavailable (set '
                               'path.pretrain_vgg); perceptual loss '
                               'DISABLED for this run.')
            else:
                sd = (self.lpips_sd if isinstance(cri, LPIPSLoss)
                      else self.vgg_sd)
                self.cri_perceptual = cri.bind_params(sd).to(self.device)
        self.cri_gan = build_loss(train_opt['gan_opt']).to(self.device)
        self.use_dis = train_opt['gan_opt']['loss_weight'] != 0
        self.fixed_disc = train_opt.get('fixed_disc', False)
        train_set = (opt.get('datasets') or {}).get('train') or {}
        self.degrade_on_device = self.LQ_stage and bool(
            train_set.get('on_device_degradation'))
        self.grad_accum_chunks = max(int(train_opt.get('grad_accum_chunks',
                                                       1) or 1), 1)
        # read but unused, as in the reference and the JAX package
        self.net_d_iters = train_opt.get('net_d_iters', 1)
        self.net_d_init_iters = int(train_opt.get('net_d_init_iters', 0))
        self.codebook_w = (train_opt.get('codebook_opt') or {}).get(
            'loss_weight', 0.0)
        self.semantic_w = (train_opt.get('semantic_opt') or {}).get(
            'loss_weight', 0.0)
        self.use_semantic = (self.net_g.use_semantic_loss
                             and self.vgg_sd is not None
                             and self.semantic_w > 0)
        if self.net_g.use_semantic_loss and self.vgg_sd is None:
            logger.warning('use_semantic_loss requested but no VGG weights; '
                           'semantic loss DISABLED for this run.')
        self.vgg = None
        if self.use_semantic:
            self.vgg = VGGFeatureExtractor(['relu4_4'], 'vgg19')
            self.vgg.load_state_dict(vgg_truncated_state(self.vgg_sd,
                                                         self.vgg))
            self.vgg.requires_grad_(False).eval().to(self.device)

        warmup = train_opt.get('warmup_iter', -1)
        self.sched_g = build_schedule(train_opt.get('scheduler'),
                                      train_opt['optim_g']['lr'], warmup)
        self.sched_d = build_schedule(train_opt.get('scheduler'),
                                      train_opt['optim_d']['lr'], warmup)
        keywords = opt['network_g'].get('frozen_module_keywords')
        names = [n for n, _ in self.net_g.named_parameters()]
        frozen = (frozen_names(names, keywords) if self.LQ_stage and keywords
                  else set())
        if frozen:
            logger.info(f'Froze {len(frozen)} param tensors by keywords '
                        f'{keywords}')
        self.net_g.requires_grad_(True)
        for n, p in self.net_g.named_parameters():
            p.requires_grad_(n not in frozen)
        self.trainable_names = [n for n, _ in self.net_g.named_parameters()
                                if n not in frozen]
        # trainable tensors held whole on every model rank
        self.whole_g = [p for n, p in self.net_g.named_parameters()
                        if n not in frozen and n not in self.layout_g]
        self.trainable_g = [p for n, p in self.net_g.named_parameters()
                            if n not in frozen]
        self.opt_g = optimizer_from_opt(train_opt['optim_g'],
                                        self.trainable_g)
        self.opt_d = optimizer_from_opt(train_opt['optim_d'],
                                        list(self.net_d.parameters()))
        if (self.dist and self.net_g.use_semantic_loss
                and not self.use_semantic
                and not opt.get('find_unused_parameters')):
            raise ValueError(
                'network_g.use_semantic_loss with the semantic loss off (no '
                'path.pretrain_vgg, or semantic_opt.loss_weight 0): '
                'conv_semantic gets no gradient, which DistributedDataParallel '
                'refuses; set find_unused_parameters: true, or '
                'use_semantic_loss: false')
        # the networks the steps run: DDP wrappers in a data-parallel run
        # (after the frozen parameters are set: DDP syncs what needs grad)
        self.net_g_train = self.model_to_device(self.net_g)
        self.net_d_train = self.model_to_device(self.net_d)
        self.ema_decay = float(train_opt.get('ema_decay', 0) or 0)
        self.ema = ({n: p.detach().clone() for n, p in
                     self.net_g.named_parameters()}
                    if self.ema_decay > 0 else None)
        self.step = 0
        self.net_g.train()
        self.net_d.train()

    # -- one iteration ---------------------------------------------------

    def wrap_loader(self, loader):
        """The train loader's batches staged on this model's device by a
        DevicePrefetcher (on the CPU, as they are)."""
        return DevicePrefetcher(loader, self.device)

    def feed_data(self, data: Mapping[str, Any]) -> None:
        """The batch's lq (if any) and gt on the device; a batch that the
        prefetcher staged there is taken as it is (`.to` is a no-op)."""
        nb = self.device.type == 'cuda'
        self.lq = (data['lq'].to(self.device, non_blocking=nb)
                   if data.get('lq') is not None else None)
        self.gt = data['gt'].to(self.device, non_blocking=nb)

    @torch.no_grad()
    def hq_prior(self, gt: torch.Tensor):
        """The frozen prior's reconstruction of GT (in the compute dtype)
        and its code indices per codebook scale."""
        rec, _, _, indices = self.net_hq(gt.to(self.dtype))
        return rec, indices

    def chunks(self, batch: int) -> int:
        """grad_accum_chunks, when it divides the batch (else 1)."""
        k = self.grad_accum_chunks
        return k if batch % k == 0 else 1

    def gan_gate(self) -> bool:
        """The GAN terms and the discriminator update start after
        net_d_init_iters iterations (current_iter counts from 1)."""
        return self.use_dis and self.step + 1 > self.net_d_init_iters

    def g_losses(self, gen_in, gt, gt_indices=None, vgg_feat=None,
                 gate: bool = True):
        """(total, loss dict, f32 output, first-scale indices) of one
        generator forward in training mode."""
        out, l_codebook, l_semantic, idx_list = self.net_g_train(
            gen_in, gt_indices=gt_indices, vgg_feat=vgg_feat, train=True,
            differentiable=True)
        out32 = out.float()
        total = torch.zeros((), device=out.device)
        ld = OrderedDict()
        if self.codebook_w:
            ld['l_codebook'] = l_codebook * self.codebook_w
            total = total + ld['l_codebook']
        if self.use_semantic and self.semantic_w:
            ld['l_semantic'] = l_semantic * self.semantic_w
            total = total + ld['l_semantic']
        if self.cri_pix is not None:
            ld['l_pix'] = self.cri_pix(out32, gt)
            total = total + ld['l_pix']
        if self.cri_perceptual is not None:
            l_percep, l_style = self.cri_perceptual(out32, gt)
            if l_percep is not None:
                ld['l_percep'] = l_percep
                total = total + l_percep
            if l_style is not None:
                ld['l_style'] = l_style
                total = total + l_style
        if self.use_dis:
            if gate:
                ld['l_g_gan'] = self.cri_gan(self.net_d(out), True,
                                             is_disc=False)
                total = total + ld['l_g_gan']
            else:
                ld['l_g_gan'] = torch.zeros((), device=out.device)
        return total, ld, out32, idx_list[0]

    def g_backward(self, lq, gt):
        """The generator's forward and backward over the chunks, gradients
        left in .grad (averaged over the chunks, and over the ranks in the
        last chunk's backward). Returns (mean total, mean loss dict,
        output, first-scale indices, prior indices)."""
        n = self.chunks(gt.shape[0])
        gt_indices = None
        if self.LQ_stage:
            self.gt_rec, gt_indices = self.hq_prior(gt)
        vgg_feat = None
        if self.use_semantic:
            with torch.no_grad():
                vgg_feat = self.vgg(gt.to(self.dtype))['relu4_4']
        gen_in = (lq if self.LQ_stage else gt).to(self.dtype)
        gate = self.gan_gate()
        self.net_d.requires_grad_(False)
        bs = gt.shape[0] // n
        totals, lds, outs, idxs = [], [], [], []
        for c in range(n):
            sl = slice(c * bs, (c + 1) * bs)
            with _sync_if(self.net_g_train, c == n - 1):
                total, ld, out, idx = self.g_losses(
                    gen_in[sl], gt[sl],
                    None if gt_indices is None else [g[sl] for g in
                                                     gt_indices],
                    None if vgg_feat is None else vgg_feat[sl], gate)
                (total / n).backward()
            totals.append(total.detach())
            lds.append({k: v.detach() for k, v in ld.items()})
            outs.append(out.detach())
            idxs.append(idx)
        self.net_d.requires_grad_(True)
        mean_ld = OrderedDict((k, torch.stack([d[k] for d in lds]).mean())
                              for k in lds[0])
        return (torch.stack(totals).mean(), mean_ld, torch.cat(outs),
                torch.cat(idxs), gt_indices)

    def _d_phase(self, data: torch.Tensor, real: bool, n: int,
                 sync: bool = True):
        """Hinge loss of one side over n chunks, backward; the first chunk
        runs the power iteration. With sync, the last chunk's backward
        all-reduces the discriminator's accumulated gradients."""
        bs = data.shape[0] // n
        losses, preds = [], []
        for c in range(n):
            with _sync_if(self.net_d_train, sync and c == n - 1):
                pred = self.net_d_train(data[c * bs:(c + 1) * bs],
                                        update=c == 0)
                loss = self.cri_gan(pred, real, is_disc=True)
                (loss / n).backward()
            losses.append(loss.detach())
            preds.append(pred.detach().float().mean())
        return torch.stack(losses).mean(), torch.stack(preds).mean()

    def _set_lr(self, optimizer, schedule) -> None:
        lr = schedule(self.step)
        for group in optimizer.param_groups:
            group['lr'] = lr

    def degradation_generator(self) -> torch.Generator:
        """The generator of this step's on-device degradation, on the
        device, seeded from (manual_seed, step)."""
        seed = np.random.SeedSequence((self.seed, self.step)).generate_state(
            1, np.uint64)[0]
        return torch.Generator(self.device).manual_seed(int(seed))

    def degrade(self, gt: torch.Tensor) -> torch.Tensor:
        """This step's on-device LQ of the GT batch; in a data-parallel run
        of the data rank's block, degraded as part of the whole global
        batch."""
        if not self.dist:
            return degradation_bsrgan(gt, self.degradation_generator(),
                                      sf=self.scale)
        lq = degradation_bsrgan(gather_batch(gt, self.mesh),
                                self.degradation_generator(), sf=self.scale)
        return local_slice(lq, self.mesh)

    def optimize_parameters(self, current_iter: Optional[int] = None) -> None:
        if self.degrade_on_device:
            self.lq = self.degrade(self.gt)
        gate = self.gan_gate()
        self.opt_g.zero_grad(set_to_none=True)
        total, loss_dict, output, idx, _ = self.g_backward(self.lq, self.gt)
        if self.tp is not None:
            broadcast_grads(self.whole_g, self.tp)
        # filled at log time from the code counts of the global batch
        loss_dict['codebook_perplexity'] = None
        self._code_counts = code_counts(idx, self.n_e)
        self._set_lr(self.opt_g, self.sched_g)
        self.opt_g.step()
        loss_dict['l_g_total'] = total

        if self.use_dis and not self.fixed_disc:
            n = self.chunks(self.gt.shape[0])
            spectral = None if gate else {
                k: v.clone() for k, v in self.net_d.state_dict().items()
                if k.endswith(('weight_u', 'weight_v'))}
            self.opt_d.zero_grad(set_to_none=True)
            l_real, p_real = self._d_phase(self.gt, True, n, sync=False)
            l_fake, p_fake = self._d_phase(output, False, n)
            if gate:
                if self.tp is not None:
                    broadcast_grads(list(self.net_d.parameters()), self.tp)
                self._set_lr(self.opt_d, self.sched_d)
                self.opt_d.step()
            else:       # the spectral vectors stay as they were
                self.net_d.load_state_dict(spectral, strict=False)
            self.opt_d.zero_grad(set_to_none=True)
            loss_dict.update(l_d_real=l_real, l_d_fake=l_fake,
                             out_d_real=p_real, out_d_fake=p_fake)
        if self.ema is not None:
            self.ema_update(self.ema, dict(self.net_g.named_parameters()),
                            self.ema_decay)
        self.step += 1
        self.output = output
        self._device_log = loss_dict

    def get_current_log(self) -> Dict[str, float]:
        """The last iteration's losses as floats (in a data-parallel run
        every rank calls this at the same iterations: it all-reduces)."""
        log = getattr(self, '_device_log', None)
        if log is not None:
            counts = self._code_counts
            if self.dist:
                counts = counts.clone()
                dist.all_reduce(counts, group=self.data_group)
            vals = self.reduce_loss_dict({k: v for k, v in log.items()
                                          if k != 'codebook_perplexity'})
            vals['codebook_perplexity'] = float(perplexity_of_counts(counts))
            self.log_dict = {k: vals[k] for k in log}
            self._device_log = None
        return self.log_dict

    def get_current_learning_rate(self):
        return [self.sched_g(self.step), self.sched_d(self.step)]

    # -- validation and evaluation -------------------------------------------

    def eval_net(self) -> FeMaSRNet:
        """The network validation serves: the trainee, or with ema_decay > 0
        an eval copy that the EMA weights are copied into at each call
        (built once, under a forked RNG so that no random stream moves)."""
        if self.ema is None:
            return self.net_g
        if self.net_g_ema is None:
            with torch.random.fork_rng(devices=[]):
                net = build_generator(self.opt['network_g'], self.tp)
            self.net_g_ema = net.requires_grad_(False).eval().to(self.device)
        with torch.no_grad():
            for n, p in self.net_g_ema.named_parameters():
                p.copy_(self.ema[n])
        return self.net_g_ema

    def _get_inferencer(self) -> SRInferencer:
        net = self.eval_net()
        if self._inferencer is None or self._inferencer.model is not net:
            self._inferencer = SRInferencer(model=net, dtype=self.dtype)
        return self._inferencer

    def test(self, lq: torch.Tensor) -> torch.Tensor:
        """SR of a (1, 3, H, W) image in [0, 1]: the whole image below
        8000^2 px, tiles above. (1, 3, sH, sW) float32 on the device."""
        sr = self._get_inferencer()
        h, w = lq.shape[2:]
        if h * w < 8000 * 8000:
            return sr.run_padded(lq)
        return sr.run_tiled(lq)

    def nondist_validation(self, dataloader, current_iter, tb_logger,
                           save_img: bool = False) -> None:
        self._run_validation(dataloader, current_iter, tb_logger, save_img)

    def dist_validation(self, dataloader, current_iter, tb_logger,
                        save_img: bool = False) -> None:
        self._run_validation(dataloader, current_iter, tb_logger, save_img,
                             shard=True)

    def _metric_funcs(self) -> Dict[str, Any]:
        funcs = {}
        for name, mopt in self.opt['val']['metrics'].items():
            kw = {k: v for k, v in mopt.items() if k not in ('type', 'better')}
            fn = create_metric(mopt['type'], lpips_params=self.lpips_sd,
                               device=self.device, **kw)
            if fn is None:
                get_root_logger().warning(
                    f'metric {name} unavailable (no LPIPS weights: set '
                    'path.pretrain_lpips), skipped')
            else:
                funcs[name] = fn
        return funcs

    def _save_path(self, img_name: str, current_iter, dataset_name: str
                   ) -> str:
        vis = self.opt['path']['visualization']
        if self.is_train:
            return osp.join(vis, 'image_results', f'{current_iter}',
                            f'{img_name}.png')
        suffix = self.opt['val'].get('suffix') or self.opt['name']
        return osp.join(vis, dataset_name, f'{img_name}_{suffix}.png')

    def _run_validation(self, dataloader, current_iter, tb_logger,
                        save_img: bool, shard: bool = False) -> None:
        """SR every image of the loader; with `val.metrics`, average each
        metric over the images that have a GT, keep the best records (by
        `val.key_metric`, or per metric when it is absent or skipped) and
        save net_g_best / net_d_best when they improve. With shard, this
        rank takes the images whose index is its data rank modulo the
        data size (the model ranks of a data group serve them together),
        and a table of every image's metrics, filled by model rank 0 of
        each data group, is all-reduced."""
        dataset_name = dataloader.dataset.opt['name']
        metric_funcs = (self._metric_funcs()
                        if self.opt['val'].get('metrics') else {})
        self.metric_results = {m: 0.0 for m in metric_funcs}
        if metric_funcs:
            self._initialize_best_metric_results(dataset_name)
        n_gt = 0
        if shard:
            data = dataloader.dataset
            # per image: its metrics, then 1 if it has a GT
            table = torch.zeros(len(data), len(metric_funcs) + 1,
                                dtype=torch.float64)
            items = ((i, default_collate([data[i]])) for i in
                     range(self.data_rank, len(data), self.data_size))
        else:
            items = enumerate(dataloader)
        # one rank of each data group writes its images and metric rows
        writes = self.tp is None or self.tp.rank == 0
        for i, val_data in items:
            img_name = osp.splitext(osp.basename(val_data['lq_path'][0]))[0]
            # HWC RGB 8-bit levels, on the device
            levels = round_8bit(self.test(val_data['lq']))[0].permute(1, 2, 0)
            if save_img and writes:
                imwrite(levels.flip(-1).to(torch.uint8).cpu().numpy(),
                        self._save_path(img_name, current_iter,
                                        dataset_name))
            if metric_funcs and 'gt' in val_data:
                sr01 = levels / 255.0
                gt = val_data['gt'][0].permute(1, 2, 0).to(self.device)
                if shard:
                    if writes:
                        table[i] = torch.tensor(
                            [fn(sr01, gt) for fn in metric_funcs.values()]
                            + [1.0], dtype=torch.float64)
                    continue
                n_gt += 1
                for name, fn in metric_funcs.items():
                    self.metric_results[name] += fn(sr01, gt)
        if shard and metric_funcs:
            # one rank wrote each row, the others zeros: the sum is exact,
            # and the images add up in the order nondist_validation adds
            total = table.to(self.device)
            dist.all_reduce(total)
            for row in total.cpu().tolist():
                if row[-1]:
                    n_gt += 1
                    for name, val in zip(metric_funcs, row):
                        self.metric_results[name] += val
        if not n_gt:                # no GT: nothing to measure
            self.metric_results = {}
            return
        for m in self.metric_results:
            self.metric_results[m] /= n_gt
        key = self.opt['val'].get('key_metric')
        if key in self.metric_results:
            if self._update_best_metric_result(
                    dataset_name, key, self.metric_results[key],
                    current_iter):
                for name, val in self.metric_results.items():
                    self._update_metric_result(dataset_name, name, val,
                                               current_iter)
                self._save_best_models()
        elif any([self._update_best_metric_result(dataset_name, name, val,
                                                  current_iter)
                  for name, val in self.metric_results.items()]):
            self._save_best_models()
        self._log_validation_metric_values(current_iter, dataset_name,
                                           tb_logger)

    def _save_best_models(self) -> None:
        """net_g_best (the weights validated) and net_d_best; offline
        evaluation has no models folder and saves nothing."""
        if not self.is_train:
            return
        self.save_network(self.whole_state(self.eval_net().state_dict()),
                          'net_g_best', '')
        self.save_network(self.net_d.state_dict(), 'net_d_best', '')

    def _log_validation_metric_values(self, current_iter, dataset_name: str,
                                      tb_logger) -> None:
        log_str = f'Validation {dataset_name}\n'
        for metric, value in self.metric_results.items():
            log_str += f'\t # {metric}: {value:.4f}'
            rec = self.best_metric_results[dataset_name][metric]
            log_str += f"\tBest: {rec['val']:.4f} @ {rec['iter']} iter\n"
        get_root_logger().info(log_str)
        if tb_logger is not None:
            for metric, value in self.metric_results.items():
                tb_logger.add_scalar(f'metrics/{dataset_name}/{metric}',
                                     value, current_iter)

    # -- visuals -------------------------------------------------------------

    @torch.no_grad()
    def vis_single_code(self, up_factor: int = 2) -> torch.Tensor:
        """Every code of the first codebook decoded to an image (a map of
        up_factor^2 copies of the code) by the network validation serves,
        under no_grad, in chunks of 256, in network_g's dtype: (n_e, 3, h,
        w) float32 on the device."""
        net = self.eval_net()
        idx = torch.arange(self.n_e, device=self.device)[:, None, None]
        idx = idx.expand(-1, up_factor, up_factor)
        return torch.cat([net.decode_indices(idx[i:i + 256], self.dtype)
                          for i in range(0, self.n_e, 256)]).float()

    def get_current_visuals(self) -> Dict[str, torch.Tensor]:
        """The last iteration's batches for TensorBoard, the first 16 of
        each, NCHW float32: lq (the loaded one: absent under on-device
        degradation, as in the JAX trainer), result, the HQ stage's
        codebook grid, the prior's reconstruction gt_rec (LQ stage) and
        gt."""
        vis = 16
        out = OrderedDict()
        if self.lq is not None and not self.degrade_on_device:
            out['lq'] = self.lq[:vis].float()
        out['result'] = self.output[:vis].float()
        if not self.LQ_stage:
            out['codebook'] = self.vis_single_code()
        if getattr(self, 'gt_rec', None) is not None:
            out['gt_rec'] = self.gt_rec[:vis].float()
        out['gt'] = self.gt[:vis].float()
        return out

    # -- checkpoints -------------------------------------------------------

    def whole_state(self, state: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """A state of net_g's keys (its parameters, the EMA) whole: the
        split tensors gathered over the model ranks (every model rank
        calls this)."""
        return gather_state_dict(state, self.layout_g, self.tp)

    def _opt_g_state(self, state: Mapping, part: bool) -> Mapping:
        """opt_g's state dict with each moment of a split parameter made
        whole (part False: gathered over the model ranks, every one
        calling) or cut to the rank's part (part True)."""
        if self.tp is None:
            return state
        out = dict(state, state={})
        for i in sorted(state['state']):
            spec = self.layout_g.get(self.trainable_names[i])
            entry = {}
            for k in sorted(state['state'][i]):
                v = state['state'][i][k]
                if spec is not None and torch.is_tensor(v) and v.dim():
                    v = (shard(v, *spec, self.tp.size, self.tp.rank) if part
                         else unshard(all_gather(v, self.tp.group,
                                                 self.tp.size), *spec))
                entry[k] = v
            out['state'][i] = entry
        return out

    def save(self, epoch: int, current_iter: int) -> None:
        """The networks and the training state, written whole; in a
        data-parallel run every rank calls this (the ranks' RNG states
        are gathered, and the split tensors over the model ranks) and
        rank 0 writes."""
        rng = {'cpu': torch.get_rng_state()}
        if self.device.type == 'cuda':
            rng['cuda'] = torch.cuda.get_rng_state(self.device)
        rngs = all_gather_object(rng) if self.dist else [rng]
        params_g = self.whole_state(self.net_g.state_dict())
        ema = self.whole_state(self.ema) if self.ema is not None else None
        opt_g = self._opt_g_state(self.opt_g.state_dict(), part=False)
        if self.rank != 0:
            return
        self.save_network(params_g, 'net_g', current_iter,
                          extra_keys=({'params_ema': ema}
                                      if ema is not None else None))
        self.save_network(self.net_d.state_dict(), 'net_d', current_iter)
        state = {'step': self.step,
                 'params_g': params_g,
                 'params_d': self.net_d.state_dict(),
                 'opt_g': opt_g,
                 'opt_d': self.opt_d.state_dict(),
                 'rng_cpu': rng['cpu']}
        if ema is not None:
            state['params_g_ema'] = ema
        if 'cuda' in rng:
            state['rng_cuda'] = rng['cuda']
        if len(rngs) > 1:
            state['rng_by_rank'] = rngs
        self.save_training_state(state, epoch, current_iter)

    def resume_training(self, state_path: str) -> Dict[str, int]:
        """Every rank loads the state onto its device (the rank's parts of
        the split tensors: the state is whole) and restores its own RNG
        state (a state saved at another world size gives the ranks it has
        no state of their seeded streams)."""
        tree = self.resume_training_state(state_path)
        state = tree['state']
        self.net_g.load_state_dict(local_state(self.net_g,
                                               state['params_g']))
        self.net_d.load_state_dict(state['params_d'])
        self.opt_g.load_state_dict(self._opt_g_state(state['opt_g'],
                                                     part=True))
        self.opt_d.load_state_dict(state['opt_d'])
        self.step = int(state['step'])
        if self.ema is not None and 'params_g_ema' in state:
            for k, v in local_state(self.net_g,
                                    state['params_g_ema']).items():
                self.ema[k].copy_(v)
        rngs = state.get('rng_by_rank') or [
            {'cpu': state['rng_cpu'], **({'cuda': state['rng_cuda']}
                                         if 'rng_cuda' in state else {})}]
        if self.rank < len(rngs):
            torch.set_rng_state(rngs[self.rank]['cpu'])
            if 'cuda' in rngs[self.rank] and self.device.type == 'cuda':
                torch.cuda.set_rng_state(rngs[self.rank]['cuda'],
                                         self.device)
        return {'epoch': int(tree['epoch']), 'iter': int(tree['iter'])}
