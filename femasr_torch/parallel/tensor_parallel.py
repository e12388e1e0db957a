"""Tensor parallelism on the mesh's 'model' axis (Megatron style).

The JAX package annotates its parameters with TP_RULES and XLA inserts
the collectives (femasr_tpu/parallel/mesh.py); the port writes them out:

- `copy_to_model`: identity forward, all-reduce of the gradient backward
  (the input of a column-parallel layer);
- `reduce_from_model`: all-reduce forward, identity backward (the output
  of a row-parallel layer, and of a vocab-parallel lookup).

With one pair around each split region, every tensor outside the regions
and every replicated parameter gets the same value and gradient on every
model rank in exact arithmetic: an all-reduce leaves one result on all
ranks. A trainer also broadcasts the replicated gradients from model rank
0 (`broadcast_grads`), so that the ranks' copies stay bit-equal where a
library computes the same function another way in another process.

`ModelAxis` is what a split module holds: the 'model' process group, its
size and this process's rank on it. A module built with `ModelAxis(None,
size, rank)` has the split shapes but runs no collective (rule checks).

The int8 serving lanes (B4 `matmul_w8a8`, B5 `matmul_w8a8_q`) are never
split: B4's per-tensor activation scale and B5's per-row requantization
span the whole feature axis, and the JAX package does not split them
either (XLA does not partition a Pallas call, so it gathers their
operands). Their layers run whole on every model rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class ModelAxis:
    """The 'model' axis as one process sees it."""

    group: Optional[object]
    size: int
    rank: int

    def splits(self, n: int) -> bool:
        """Whether n (heads, hidden width, codes) divides over the axis:
        a layer whose dimension does not stays replicated, as the JAX
        package's `param_shardings` leaves such a leaf."""
        return self.size > 1 and n % self.size == 0


def model_axis(mesh) -> Optional[ModelAxis]:
    """The mesh's 'model' axis, or None for no mesh or an axis of 1."""
    if mesh is None or mesh['model'].size() == 1:
        return None
    return ModelAxis(mesh.get_group('model'), mesh['model'].size(),
                     mesh.get_local_rank('model'))


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """x reduced over the group, in a new tensor. Under gloo a CUDA tensor
    goes through the host (two ranks may share one card only under
    gloo)."""
    staged = x.is_cuda and dist.get_backend(group) == 'gloo'
    out = x.detach().cpu() if staged else x.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    return out.to(x.device) if staged else out


def all_gather(x: torch.Tensor, group, size: int) -> list:
    """Every rank's x (of one shape), in rank order (through the host
    under gloo, which gathers CPU tensors only)."""
    staged = x.is_cuda and dist.get_backend(group) == 'gloo'
    src = (x.detach().cpu() if staged else x.detach()).contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return [p.to(x.device) for p in parts]


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyToModel.apply(x, axis.group)
    return x


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, axis.group)
    return all_reduce(x, axis.group)


def dense(x: torch.Tensor, w: torch.Tensor,
          bias: Optional[torch.Tensor]) -> torch.Tensor:
    """x @ w.T + bias rounded where flax's nn.Dense rounds: outside float32
    the product rounds, then the sum (one rounding of the fused product +
    bias moves ~5% of bf16 outputs by more than an ulp)."""
    if bias is None or x.dtype == torch.float32:
        return F.linear(x, w, bias)
    return F.linear(x, w) + bias.to(x.dtype)


class ColumnParallelLinear(nn.Linear):
    """A linear whose output features are split over the axis: rank m
    holds piece m of each of `groups` equal blocks of them (qkv: its
    heads' rows of q, k and v), weight and bias alike. Its input is
    `copy_to_model`'d; its output is the rank's features."""

    def __init__(self, in_features: int, out_features: int,
                 axis: ModelAxis, groups: int = 1):
        super().__init__(in_features, out_features // axis.size)
        self.axis = axis
        self.tp_layout: Dict[str, Tuple[int, int]] = {
            'weight': (0, groups), 'bias': (0, groups)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(copy_to_model(x, self.axis), self.weight.to(x.dtype),
                     self.bias)


class RowParallelLinear(nn.Linear):
    """A linear whose input features are split over the axis (its input
    is the rank's features of a column-parallel layer): the partial
    products are summed over the axis, then the bias, held whole on every
    rank, is added once. Outside float32 the partial products are taken
    and summed in float32 and rounded once, then the bias is added in the
    input dtype: the rounding points of `dense`, with the product's f32
    sum in another order."""

    def __init__(self, in_features: int, out_features: int,
                 axis: ModelAxis):
        super().__init__(in_features // axis.size, out_features)
        self.axis = axis
        self.tp_layout: Dict[str, Tuple[int, int]] = {'weight': (1, 1)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.float(), self.weight.float())
        y = reduce_from_model(y, self.axis)
        if x.dtype == torch.float32:
            return y + self.bias
        return y.to(x.dtype) + self.bias.to(x.dtype)


def broadcast_grads(params, axis: ModelAxis) -> None:
    """Model rank 0's gradients of `params` (held whole on every model
    rank) on every model rank, in place (one broadcast of them all). The
    pairs above give every model rank the same gradients in exact
    arithmetic; on the card a library may take another algorithm in
    another process (cuDNN's convolution plans depend on the process's
    cached free memory), and without this the ranks' copies would drift
    apart by rounding."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    staged = flat.is_cuda and dist.get_backend(axis.group) == 'gloo'
    buf = flat.cpu() if staged else flat
    dist.broadcast(buf, src=dist.get_global_rank(axis.group, 0),
                   group=axis.group)
    flat = buf.to(flat.device) if staged else buf
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def shard(full: torch.Tensor, dim: int, groups: int, size: int,
          rank: int) -> torch.Tensor:
    """This rank's part of a full tensor split on `dim`: the dimension is
    `groups` equal blocks (qkv: q, k and v), each cut into `size` pieces,
    and the rank holds piece `rank` of every block, in block order."""
    blocks = full.chunk(groups, dim)
    return torch.cat([b.chunk(size, dim)[rank] for b in blocks], dim)


def unshard(parts: list, dim: int, groups: int) -> torch.Tensor:
    """The full tensor of every rank's part (inverse of `shard`)."""
    per_rank = [p.chunk(groups, dim) for p in parts]
    return torch.cat([pr[g] for g in range(groups) for pr in per_rank], dim)


def order_key(dist_: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (distance, index) pairs: the f32 distance's
    order-preserving bits above, the non-negative index below (-0.0 is
    taken as +0.0, as a comparison does)."""
    bits = (dist_.float() + 0.0).view(torch.int32).long()
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (bits << 32) | index.long()


def first_minimum(dists: list, indices: list) -> torch.Tensor:
    """The index of the least distance over several (distance, index)
    candidates per token, ties to the lower index: B3's rule across
    shards, in one process (what the sharded search all-reduces)."""
    keys = torch.stack([order_key(d, i) for d, i in zip(dists, indices)])
    return keys.min(0).values & 0xFFFFFFFF


def sharded_argmin(dist_: torch.Tensor, index: torch.Tensor,
                   axis: ModelAxis) -> torch.Tensor:
    """The global first minimum of every rank's (distance, global index)
    per token: one all-reduce MIN of `order_key`s over the model axis."""
    key = all_reduce(order_key(dist_, index), axis.group, dist.ReduceOp.MIN)
    return key & 0xFFFFFFFF


def vocab_lookup(table: torch.Tensor, index: torch.Tensor,
                 axis: ModelAxis) -> torch.Tensor:
    """Rows `index` (global) of a table split by rows over the axis: each
    rank gathers the rows it holds, zeros elsewhere, and the parts are
    summed (adding zeros is exact). The gradient reaches only the rank's
    own rows."""
    n = table.shape[0]
    local = index.long() - axis.rank * n
    mine = (local >= 0) & (local < n)
    rows = torch.where(mine[:, None], table[local.clamp(0, n - 1)], 0.0)
    return reduce_from_model(rows, axis)
