"""Codebook vector quantization (counterpart of femasr_tpu/ops/quantize.py).

The nearest-code search runs through the VQ-argmin kernel in f32 whatever
the model dtype (the JAX package's `index_f32` / Pallas behaviour). The
serving-side codebook loss is computed in f32. Tensors are NCHW. The
counterpart of `nearest_code_indices` is `kernels.vq_argmin.vq_argmin`
itself (always the f32 search). The
LQ-stage supervised loss (gt indices, gram loss) belongs to training and
is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..kernels.vq_argmin import vq_argmin


def vector_quantize(z: torch.Tensor, codebook: torch.Tensor,
                    beta: float = 0.25
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize (B, C, H, W) z to its nearest codebook entries.

    Returns (z_q, codebook_loss, indices): z_q in z's dtype (straight-
    through form z + (z_q - z)), the f32 scalar loss q_latent + beta *
    e_latent, and (B, H, W) int32 indices.
    """
    b, c, h, w = z.shape
    zf = z.float()
    z_flat = z.detach().permute(0, 2, 3, 1).reshape(-1, c)
    indices = vq_argmin(z_flat, codebook).long()
    z_q = codebook.float()[indices].view(b, h, w, c).permute(0, 3, 1, 2)
    e_latent = (z_q.detach() - zf).square().mean()
    q_latent = (z_q - zf.detach()).square().mean()
    loss = q_latent + beta * e_latent
    z_q = z + (z_q.to(z.dtype) - z).detach()
    return z_q, loss, indices.to(torch.int32).view(b, h, w)


class VectorQuantizer(nn.Module):
    """Owns the (n_e, e_dim) codebook as `embedding.weight`."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25):
        super().__init__()
        self.e_dim = e_dim
        self.beta = beta
        self.embedding = nn.Embedding(n_e, e_dim)

    def forward(self, z: torch.Tensor):
        return vector_quantize(z, self.embedding.weight, self.beta)

    def get_codebook_entry(self, indices: torch.Tensor,
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
        """(B, H, W) or (B, 1, H, W) int indices -> (B, C, H, W) embeddings
        in `dtype` (the model's compute dtype, as JAX's `.astype(dtype)`)."""
        if indices.dim() == 4:
            indices = indices[:, 0]
        b, h, w = indices.shape
        z_q = self.embedding.weight[indices.reshape(-1).long()].to(dtype)
        return z_q.view(b, h, w, self.e_dim).permute(0, 3, 1, 2)
