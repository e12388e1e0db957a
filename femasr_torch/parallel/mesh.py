"""The ('data', 'model') device mesh and batch sharding of a data-parallel
run (counterpart of femasr_tpu/parallel/mesh.py).

The mesh is torch's DeviceMesh over the ranks of the process group. Each
rank feeds its own contiguous block of a global batch (`local_slice`), so
the JAX package's `make_global_batch` has no counterpart; `gather_batch`
puts the blocks back together on every rank, in rank order. The 'model'
axis is 1: tensor parallelism (the JAX package's TP_RULES) is ROADMAP
A11b.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .dist_util import get_dist_info, is_dist

TP_LATER = ('tensor parallelism (model > 1: column- and row-parallel Swin '
            'linears, a codebook split over the ranks) is not ported yet '
            '(ROADMAP A11b); data parallelism is')


def create_mesh(data: Optional[int] = None, model: int = 1,
                device_type: str = 'cuda'):
    """A ('data', 'model') DeviceMesh over the process group's ranks, data
    x model = world size (data defaults to world size / model), whose axes
    use the process group's backend (DeviceMesh would otherwise give a
    CUDA mesh NCCL groups under a gloo run). Needs an initialized process
    group (`dist_util.init_dist`); model > 1 raises."""
    if model > 1:
        raise NotImplementedError(TP_LATER)
    if not is_dist():
        raise RuntimeError('create_mesh needs a process group: start the '
                           'ranks with torchrun and init_dist (--launcher '
                           'pytorch)')
    world = dist.get_world_size()
    data = world // model if data is None else int(data)
    if data * model != world:
        raise ValueError(f'mesh {data}x{model} != {world} ranks')
    from torch.distributed.device_mesh import init_device_mesh
    backend = dist.get_backend()
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=('data', 'model'),
                            backend_override={'data': backend,
                                              'model': backend})


def data_size(mesh) -> int:
    """Ranks on the mesh's 'data' axis (the world size without a mesh)."""
    return mesh['data'].size() if mesh is not None else get_dist_info()[1]


def data_rank(mesh) -> int:
    return (mesh.get_local_rank('data') if mesh is not None
            else get_dist_info()[0])


def is_main_process() -> bool:
    """Rank 0 of the run (the only rank without a process group)."""
    return get_dist_info()[0] == 0


def local_slice(batch: torch.Tensor, mesh=None) -> torch.Tensor:
    """This rank's contiguous block of a global batch whose leading size
    is a multiple of the data axis."""
    w, r = data_size(mesh), data_rank(mesh)
    if batch.shape[0] % w:
        raise ValueError(f'batch {batch.shape[0]} is not a multiple of the '
                         f'{w} data-parallel ranks')
    n = batch.shape[0] // w
    return batch[r * n:(r + 1) * n]


def gather_batch(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Every rank's block of the same shape, concatenated in rank order,
    on every rank (on x's device). gloo gathers CPU tensors only, so a
    CUDA block goes through the host under gloo."""
    group = mesh.get_group('data') if mesh is not None else None
    w = data_size(mesh)
    if w == 1:
        return x
    staged = x.is_cuda and dist.get_backend(group) == 'gloo'
    src = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(w)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)
