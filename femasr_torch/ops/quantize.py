"""Codebook vector quantization (counterpart of femasr_tpu/ops/quantize.py).

The nearest-code search runs through the VQ-argmin kernel in f32 whatever
the model dtype (the JAX package's `index_f32` / Pallas behaviour), on the
detached tokens and codebook: the search carries no gradient, so the
kernel serves training too. All loss algebra is f32. Tensors are NCHW. The
counterpart of `nearest_code_indices` is `kernels.vq_argmin.vq_argmin`
itself (always the f32 search).

Training side: the HQ-stage commitment loss q_latent + beta * e_latent, the
LQ-stage loss against the frozen HQ prior's codes (beta * MSE(z, z_q_gt) +
gram_loss(z, z_q_gt)), the straight-through output z + (z_q - z).detach(),
and `codebook_perplexity` (code-usage telemetry).

Tensor parallelism (`tp`): the codebook is split by codes over the model
ranks. Each rank searches its codes with the kernel, which also returns
the distance it compared, and the ranks reduce their (distance, global
index) pairs by the kernel's own rule (the first minimum: equal distances
go to the lower index), so the split search equals the whole one bit for
bit (a code's distance does not depend on the other codes). Lookups are
vocab-parallel (`parallel.tensor_parallel.vocab_lookup`): the gradient of
the HQ stage's codebook loss reaches each rank's own codes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels.vq_argmin import vq_argmin
from ..parallel.tensor_parallel import ModelAxis, sharded_argmin, vocab_lookup


def gram_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean squared difference of the (B, C, C) Gram matrices of two
    (B, C, H, W) maps, each normalised by H * W (femasr_arch.py:40-48)."""
    b, c, h, w = x.shape
    xf = x.float().reshape(b, c, h * w)
    yf = y.float().reshape(b, c, h * w)
    gmx = xf @ xf.transpose(1, 2) / (h * w)
    gmy = yf @ yf.transpose(1, 2) / (h * w)
    return (gmx - gmy).square().mean()


def nearest_codes(z_flat: torch.Tensor, codebook: torch.Tensor,
                  tp: Optional[ModelAxis] = None) -> torch.Tensor:
    """(N,) int64 global index of each token's nearest code; with tp, of
    the codebook whose rows `codebook` (this rank's part) are."""
    if tp is None:
        return vq_argmin(z_flat, codebook).long()
    local, dist = vq_argmin(z_flat, codebook, with_dist=True)
    return sharded_argmin(dist, local.long() + tp.rank * len(codebook), tp)


def lookup(codebook: torch.Tensor, indices: torch.Tensor,
           tp: Optional[ModelAxis] = None) -> torch.Tensor:
    """Rows `indices` (global) of the codebook (this rank's part with
    tp)."""
    if tp is None:
        return codebook[indices.long()]
    return vocab_lookup(codebook, indices, tp)


def vector_quantize(z: torch.Tensor, codebook: torch.Tensor,
                    gt_indices: Optional[torch.Tensor] = None,
                    beta: float = 0.25, lq_stage: bool = False,
                    tp: Optional[ModelAxis] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize (B, C, H, W) z to its nearest codebook entries.

    gt_indices: (B, H, W) or (B, 1, H, W) codes of the frozen HQ prior;
    with lq_stage they replace the commitment loss by the LQ-stage loss.
    tp: the codebook is this rank's codes of one split over the axis.
    Returns (z_q, codebook_loss, indices): z_q in z's dtype (straight-
    through form z + (z_q - z).detach()), the f32 scalar loss, and
    (B, H, W) int32 indices.
    """
    b, c, h, w = z.shape
    zf = z.float()
    cb = codebook.float()
    z_flat = z.detach().permute(0, 2, 3, 1).reshape(-1, c)
    indices = nearest_codes(z_flat, codebook.detach(), tp)
    z_q = lookup(cb, indices, tp).view(b, h, w, c).permute(0, 3, 1, 2)
    if lq_stage and gt_indices is not None:
        gt = gt_indices.reshape(-1).long()
        z_q_gt = lookup(cb, gt, tp).view(b, h, w, c).permute(
            0, 3, 1, 2).detach()
        loss = (beta * (z_q_gt - zf).square().mean()
                + gram_loss(zf, z_q_gt))
    else:
        e_latent = (z_q.detach() - zf).square().mean()
        q_latent = (z_q - zf.detach()).square().mean()
        loss = q_latent + beta * e_latent
    z_q = z + (z_q.to(z.dtype) - z).detach()
    return z_q, loss, indices.to(torch.int32).view(b, h, w)


def codebook_perplexity(indices: torch.Tensor, n_e: int) -> torch.Tensor:
    """exp(entropy) of the code-usage distribution of `indices` (f32)."""
    return perplexity_of_counts(code_counts(indices, n_e))


def code_counts(indices: torch.Tensor, n_e: int) -> torch.Tensor:
    """How often each of the n_e codes occurs in `indices` (f32)."""
    return torch.bincount(indices.reshape(-1).long(), minlength=n_e).float()


def perplexity_of_counts(counts: torch.Tensor) -> torch.Tensor:
    """exp(entropy) of a code-usage histogram (f32)."""
    probs = counts / counts.sum().clamp_min(1.0)
    plogp = torch.where(probs > 0, probs * probs.clamp_min(1e-30).log(),
                        torch.zeros_like(probs))
    return torch.exp(-plogp.sum())


class VectorQuantizer(nn.Module):
    """Owns the (n_e, e_dim) codebook as `embedding.weight`; with tp (and
    n_e dividing the axis) this rank's n_e / tp.size codes of it."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25,
                 lq_stage: bool = False, tp: Optional[ModelAxis] = None):
        super().__init__()
        self.e_dim = e_dim
        self.beta = beta
        self.lq_stage = lq_stage
        self.tp = tp if tp is not None and tp.splits(n_e) else None
        self.embedding = nn.Embedding(
            n_e // tp.size if self.tp is not None else n_e, e_dim)
        if self.tp is not None:
            self.tp_layout = {'embedding.weight': (0, 1)}

    def forward(self, z: torch.Tensor,
                gt_indices: Optional[torch.Tensor] = None):
        return vector_quantize(z, self.embedding.weight, gt_indices,
                               self.beta, self.lq_stage, self.tp)

    def get_codebook_entry(self, indices: torch.Tensor,
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
        """(B, H, W) or (B, 1, H, W) int indices -> (B, C, H, W) embeddings
        in `dtype` (the model's compute dtype, as JAX's `.astype(dtype)`)."""
        if indices.dim() == 4:
            indices = indices[:, 0]
        b, h, w = indices.shape
        z_q = lookup(self.embedding.weight, indices.reshape(-1),
                     self.tp).to(dtype)
        return z_q.view(b, h, w, self.e_dim).permute(0, 3, 1, 2)
