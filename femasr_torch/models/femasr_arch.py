"""FeMaSRNet in PyTorch (counterpart of femasr_tpu/models/femasr_arch.py).

NCHW tensors, reference torch state-dict keys, one formulation per op. The
last decoder level and out_conv run through the conv3 kernel (ResBlock
convs with the GroupNorm-affine + SiLU prologue, out_conv with bias only),
the placement of the JAX serving tail; every other conv is F.conv2d.
Parameters stay float32; the compute dtype is that of the input.

Training runs the same forward with differentiable=True: the conv3 tail
takes its kernel's plain version in f32 and the plain layers in bf16 (they
round where the JAX trainer's layers round), the Swin attention core its
kernel's plain version and the bf16 activations their op-by-op twin (the
same functions under autograd; the kernels have no backward, as the JAX
package's Pallas kernels have no VJP), while the codebook search stays a
kernel on the detached tokens. In
bfloat16 the parameters stay float32 and every layer computes in the
input's dtype, rounding where the JAX layers round; the loss algebra is
float32 (ops/quantize.py). use_checkpoint recomputes the Swin blocks'
activations in the backward (ops/swin.py BasicLayer).

The int8 serving lane (int8_tail, int8_levels, int8_enc_up, int8_swin,
int8_mlp, as in the JAX FeMaSRNet) swaps convs and linears for their w8a8
layers with the same parameters, so one state dict serves both lanes.

Tensor parallelism (`tp`, the mesh's 'model' axis): the Swin blocks'
attention by head and MLP by hidden width (ops/swin.py), and the codebooks
by codes (ops/quantize.py), are split over the model ranks; everything
else is whole on every rank and computes the same values there. The
state dict then holds the rank's parts (`parallel.mesh.split_layout`);
`init_weights` draws every tensor at its whole shape and keeps the rank's
part, so a split model starts from the whole model's weights.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from ..kernels.conv3 import conv3, conv3_plain
from ..ops.layers import (CombineQuantBlock, Conv2d, Conv2dInt8, ResBlock,
                          Upsample, sequential)
from ..ops.quantize import VectorQuantizer
from ..ops.swin import SwinLayers
from ..parallel.mesh import split_layout
from ..parallel.tensor_parallel import ModelAxis, shard

# resolution -> channel width (femasr_arch.py:244-252)
CHANNEL_QUERY_DICT = {8: 256, 16: 256, 32: 256, 64: 256, 128: 128, 256: 64,
                      512: 32}


def EncoderDownBlock(in_ch: int, out_ch: int, norm_type: str,
                     act_type: str) -> nn.Sequential:
    """[Conv s2, ResBlock, ResBlock] (keys .0, .1, .2)."""
    return nn.Sequential(
        Conv2d(in_ch, out_ch, 3, 2, 1),
        ResBlock(out_ch, out_ch, norm_type, act_type),
        ResBlock(out_ch, out_ch, norm_type, act_type))


def _upconv(in_ch: int, out_ch: int, int8: bool) -> list:
    """Nearest x2 upsample then conv3; int8: the upsample is materialized
    and the conv is w8a8 (UpConv3(int8=True))."""
    return [Upsample(), Conv2dInt8(in_ch, out_ch) if int8
            else Conv2d(in_ch, out_ch, 3, 1, 1)]


def EncoderUpBlock(in_ch: int, out_ch: int, norm_type: str,
                   act_type: str, int8: bool = False) -> nn.Sequential:
    """[Upsample x2, Conv3, ResBlock, ResBlock] (keys .1, .2, .3); int8:
    all three convs w8a8 (index-safe: these outputs only feed the
    post-quantizer skips)."""
    return nn.Sequential(
        *_upconv(in_ch, out_ch, int8),
        ResBlock(out_ch, out_ch, norm_type, act_type, int8=int8),
        ResBlock(out_ch, out_ch, norm_type, act_type, int8=int8))


class DecoderBlock(nn.Module):
    """Upsample x2 -> Conv3 -> ResBlock x2 under `.block`.

    kernel=True runs the ResBlocks through the conv3 kernel; int8=True
    (DecoderBlockInt8) runs all three convs w8a8.
    """

    def __init__(self, in_ch: int, out_ch: int, norm_type: str = 'gn',
                 act_type: str = 'silu', kernel: bool = False,
                 int8: bool = False):
        super().__init__()
        self.block = nn.Sequential(
            *_upconv(in_ch, out_ch, int8),
            ResBlock(out_ch, out_ch, norm_type, act_type, kernel=kernel,
                     int8=int8),
            ResBlock(out_ch, out_ch, norm_type, act_type, kernel=kernel,
                     int8=int8))
        self.kernel = kernel

    def forward(self, x: torch.Tensor,
                differentiable: bool = False) -> torch.Tensor:
        if self.kernel:  # upsample and conv then emit channels_last
            x = x.contiguous(memory_format=torch.channels_last)
        return sequential(self.block, x, differentiable)


class MultiScaleEncoder(nn.Module):
    """in_conv + stride-2 down blocks (+ SwinLayers + 2 up blocks in LQ)."""

    def __init__(self, in_channel: int, max_depth: int, input_res: int = 256,
                 norm_type: str = 'gn', act_type: str = 'silu',
                 lq_stage: bool = True, int8_enc_up: bool = False,
                 int8_swin: bool = False, int8_mlp: bool = False,
                 use_checkpoint: bool = False,
                 tp: Optional[ModelAxis] = None):
        super().__init__()
        ksz = 4  # k=4, pad 1: shrinks H and W by 1 (reference quirk)
        ch = CHANNEL_QUERY_DICT[input_res]
        self.in_conv = Conv2d(in_channel, ch, ksz, 1, 1)
        blocks = []
        res = input_res
        for _ in range(max_depth):
            out_ch = CHANNEL_QUERY_DICT[res // 2]
            blocks.append(EncoderDownBlock(ch, out_ch, norm_type, act_type))
            ch = out_ch
            res //= 2
        if lq_stage:
            blocks.append(SwinLayers(int8_linears=int8_swin,
                                     int8_mlp=int8_mlp,
                                     use_checkpoint=use_checkpoint, tp=tp))
            for _ in range(2):
                out_ch = CHANNEL_QUERY_DICT[res * 2]
                blocks.append(EncoderUpBlock(ch, out_ch, norm_type, act_type,
                                             int8_enc_up))
                ch = out_ch
                res *= 2
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor,
                differentiable: bool = False) -> List[torch.Tensor]:
        x = self.in_conv(x)
        outputs = []
        for m in self.blocks:
            x = (m(x, differentiable) if isinstance(m, SwinLayers)
                 else sequential(m, x, differentiable))
            outputs.append(x)
        return outputs


class FeMaSRNet(nn.Module):
    """FeMaSR generator (femasr_arch.py:214-479).

    codebook_params: [[scale, n_e, e_dim], ...] low -> high resolution;
    release config [[32, 1024, 512]]. use_quantize and use_semantic_loss
    (the 512-channel `conv_semantic` head, trained against frozen VGG
    features) as in the JAX FeMaSRNet.

    Serving-only int8 lane (femasr_tpu FeMaSRNet's flags): int8_tail runs
    the last int8_levels decoder levels and out_conv in w8a8 (instead of
    the conv3-kernel tail); int8_enc_up the LQ encoder's two up blocks;
    int8_swin the Swin qkv / proj / MLP linears (per-tensor); int8_mlp the
    Swin MLPs as the per-token int8 chain.

    use_checkpoint: the LQ encoder's Swin blocks recompute their
    activations in the training backward (JAX: nn.remat); serving and
    no_grad forwards never checkpoint.

    tp: a `parallel.ModelAxis` to split the Swin linears and the
    codebooks over (see the module doc); every model rank of the axis
    runs each forward together.
    """

    def __init__(self, codebook_params: Sequence[Sequence[int]],
                 in_channel: int = 3, gt_resolution: int = 256,
                 LQ_stage: bool = False, norm_type: str = 'gn',
                 act_type: str = 'silu', scale_factor: int = 4,
                 use_quantize: bool = True, use_semantic_loss: bool = False,
                 int8_tail: bool = False, int8_levels: int = 1,
                 int8_enc_up: bool = False, int8_swin: bool = False,
                 int8_mlp: bool = False, use_checkpoint: bool = False,
                 tp: Optional[ModelAxis] = None):
        super().__init__()
        self.tp = tp
        params = [[int(v) for v in p] for p in codebook_params]
        self.codebook_scale = [p[0] for p in params]
        self.codebook_params = params
        self.gt_resolution = gt_resolution
        self.LQ_stage = LQ_stage
        self.use_quantize = use_quantize
        self.use_semantic_loss = use_semantic_loss
        self.scale_factor = scale_factor if LQ_stage else 1
        self.max_depth = int(math.log2(gt_resolution // self.codebook_scale[0]))
        encode_depth = int(math.log2(
            gt_resolution // self.scale_factor // self.codebook_scale[0]))

        self.multiscale_encoder = MultiScaleEncoder(
            in_channel, encode_depth, gt_resolution // self.scale_factor,
            norm_type, act_type, LQ_stage, int8_enc_up, int8_swin, int8_mlp,
            use_checkpoint, tp)

        # without int8_tail the last decoder level and out_conv run through
        # the conv3 kernel (gn + silu: its prologue is the GroupNorm affine
        # + SiLU); no codebook may sit at that level's input
        self.int8_tail = int8_tail
        kernel_tail = (not int8_tail and (norm_type.lower(), act_type.lower())
                       == ('gn', 'silu'))
        tail_res = gt_resolution // 2
        assert not kernel_tail or tail_res not in self.codebook_scale, (
            f'codebook scale {tail_res} falls on the conv3-kernel level')
        decoders = []
        in_ch = None
        for i in range(self.max_depth):
            res = gt_resolution // 2 ** self.max_depth * 2 ** i
            if in_ch is None:
                in_ch = CHANNEL_QUERY_DICT[res]
            out_ch = CHANNEL_QUERY_DICT[res * 2]
            decoders.append(DecoderBlock(
                in_ch, out_ch, norm_type, act_type,
                kernel=kernel_tail and i == self.max_depth - 1,
                int8=int8_tail and i >= self.max_depth - int8_levels))
            in_ch = out_ch
        self.decoder_group = nn.ModuleList(decoders)
        self.out_conv = (Conv2dInt8(in_ch, 3) if int8_tail
                         else Conv2d(in_ch, 3, 3, 1, 1))

        quantizers, before_quant, after_quant = [], [], []
        for s, (scale, n_e, e_dim) in enumerate(params):
            quantizers.append(VectorQuantizer(n_e, e_dim,
                                              lq_stage=LQ_stage, tp=tp))
            scale_in_ch = CHANNEL_QUERY_DICT[scale]
            if s == 0:
                before_in, comb_ch1, comb_ch2 = scale_in_ch, e_dim, 0
            else:
                before_in = scale_in_ch + CHANNEL_QUERY_DICT[scale]
                comb_ch1, comb_ch2 = params[s - 1][2], e_dim
            before_quant.append(Conv2d(before_in, e_dim, 1))
            after_quant.append(CombineQuantBlock(comb_ch1, comb_ch2,
                                                 scale_in_ch))
        self.quantize_group = nn.ModuleList(quantizers)
        self.before_quant_group = nn.ModuleList(before_quant)
        self.after_quant_group = nn.ModuleList(after_quant)
        if use_semantic_loss:
            self.conv_semantic = nn.Sequential(
                Conv2d(params[0][2], 512, 1), nn.ReLU())

    def _out_conv(self, x: torch.Tensor,
                  differentiable: bool = False) -> torch.Tensor:
        if self.int8_tail or (differentiable and x.dtype != torch.float32):
            return self.out_conv(x)
        conv = conv3_plain if differentiable else conv3
        return conv(x.contiguous(memory_format=torch.channels_last),
                    self.out_conv.weight, self.out_conv.bias)

    def encode_and_decode(self, x: torch.Tensor,
                          gt_indices: Optional[Sequence[torch.Tensor]] = None,
                          vgg_feat: Optional[torch.Tensor] = None,
                          differentiable: bool = False):
        """x: (B, 3, H, W) in [0, 1], in the compute dtype; no gradient
        flows back into it.

        gt_indices: the frozen HQ prior's codes per codebook scale (LQ-stage
        training); vgg_feat: frozen VGG relu4_4 features of x (the semantic
        loss, with use_semantic_loss). differentiable: see the module doc.
        Returns (out_img, codebook_loss, semantic_loss, indices_list).
        """
        enc_feats = self.multiscale_encoder(x.detach(), differentiable)
        enc_feats = enc_feats[-3:] if self.LQ_stage else enc_feats[::-1]

        codebook_losses, semantic_losses, indices_list = [], [], []
        quant_idx = 0
        prev_dec_feat = prev_quant_feat = None
        out = enc_feats[0]
        for i in range(self.max_depth):
            cur_res = self.gt_resolution // 2 ** self.max_depth * 2 ** i
            if cur_res in self.codebook_scale:
                feat = enc_feats[i]
                if prev_dec_feat is not None:
                    feat = torch.cat([feat, prev_dec_feat], dim=1)
                feat = self.before_quant_group[quant_idx](feat)
                z_quant, loss, indices = self.quantize_group[quant_idx](
                    feat, None if gt_indices is None
                    else gt_indices[quant_idx])
                if self.use_semantic_loss and vgg_feat is not None:
                    sem = self.conv_semantic(z_quant)
                    semantic_losses.append(
                        (sem.float() - vgg_feat.float()).square().mean())
                if not self.use_quantize:
                    z_quant = feat
                out = self.after_quant_group[quant_idx](z_quant,
                                                        prev_quant_feat)
                codebook_losses.append(loss)
                indices_list.append(indices)
                quant_idx += 1
                prev_quant_feat = z_quant
            elif self.LQ_stage:
                out = out + enc_feats[i]
            out = self.decoder_group[i](out, differentiable)
            prev_dec_feat = out

        out_img = self._out_conv(out, differentiable)
        semantic = (sum(semantic_losses) if semantic_losses
                    else torch.zeros((), device=out_img.device))
        return out_img, sum(codebook_losses), semantic, indices_list

    def decode_indices(self, indices: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Decode a code-index map (B, H, W) to an image (B, 3, H', W'),
        computed in `dtype` (float32 or bfloat16) from the gathered codes
        on."""
        x = self.quantize_group[0].get_codebook_entry(indices, dtype)
        x = self.after_quant_group[0](x)
        for dec in self.decoder_group:
            x = dec(x)
        return self._out_conv(x)

    def forward(self, x: torch.Tensor,
                gt_indices: Optional[Sequence[torch.Tensor]] = None,
                vgg_feat: Optional[torch.Tensor] = None,
                train: bool = False, differentiable: bool = False):
        """encode_and_decode; `train` is accepted for the JAX signature (the
        model has no train-only layer)."""
        return self.encode_and_decode(x, gt_indices, vgg_feat,
                                      differentiable)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init (reference initializers) from an explicit generator.

    Conv / linear weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    norms ones / zeros, relative-position tables (and SwinIR's absolute
    position embedding) N(0, 0.02) clipped at 2 std, codebooks
    U(-1/n_e, 1/n_e). A tensor-parallel model's split
    parameters are drawn at their whole shapes and keep the rank's part:
    every rank and the unsplit model draw the same stream.
    """
    layout = split_layout(model)
    tp = getattr(model, 'tp', None)

    def whole(name: str, t: torch.Tensor) -> torch.Size:
        if name not in layout:
            return t.shape
        dim = layout[name][0]
        return t.shape[:dim] + (t.shape[dim] * tp.size,) + t.shape[dim + 1:]

    def draw(name: str, vals: torch.Tensor) -> torch.Tensor:
        if name not in layout:
            return vals
        return shard(vals, *layout[name], tp.size, tp.rank)

    for name, p in model.named_parameters():
        leaf = name.rsplit('.', 1)[-1]
        prefix = name.rsplit('.', 1)[0] if '.' in name else ''
        owner = model.get_submodule(prefix) if prefix else model
        shape = whole(name, p)
        if isinstance(owner, nn.Embedding):
            vals = torch.rand(shape, generator=generator) * 2 - 1
            p.copy_(draw(name, vals / shape[0]))
        elif isinstance(owner, nn.PReLU):
            p.fill_(0.25)
        elif leaf in ('relative_position_bias_table',
                      'absolute_pos_embed'):
            p.copy_(draw(name, (torch.randn(shape, generator=generator)
                                * 0.02).clamp(-0.04, 0.04)))
        elif isinstance(owner, (nn.Conv2d, nn.Linear)):
            w = whole(f'{prefix}.weight', owner.weight)
            bound = 1.0 / math.sqrt(math.prod(w[1:]))
            vals = torch.rand(shape, generator=generator) * 2 - 1
            p.copy_(draw(name, vals * bound))
        elif leaf == 'weight':
            p.fill_(1.0)
        else:
            p.fill_(0.0)
    return model
