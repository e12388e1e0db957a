"""The ('data', 'model') device mesh, batch sharding and the tensor-parallel
parameter layout (counterpart of femasr_tpu/parallel/mesh.py).

The mesh is torch's DeviceMesh over the ranks of the process group, with
the model ranks of one data group adjacent (rank = d * model + m, as the
JAX package's `devices.reshape(data, model)`). Each data group feeds its
own contiguous block of a global batch (`local_slice`), so the JAX
package's `make_global_batch` has no counterpart; `gather_batch` puts the
blocks back together on every rank, in data-rank order.

Tensor parallelism splits parameters over the 'model' axis
(`tensor_parallel.py` holds the layers and collectives). `TP_RULES` is the
port's copy of the JAX package's rules, keyed on the torch state-dict
names; a layout maps a key to (dim, blocks): the dimension it is split
on, cut in that many equal blocks that each rank holds a piece of (qkv:
q, k and v). `shard_state_dict` cuts a full state dict to a rank's part,
`gather_state_dict` puts the parts back together; checkpoints are always
written whole.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .dist_util import get_dist_info, is_dist
from .tensor_parallel import ModelAxis, all_gather, shard, unshard

Layout = Dict[str, Tuple[int, int]]

# key pattern -> (dim, blocks, guard): the key is split on `dim`, cut in
# `blocks` equal blocks. Megatron layout: qkv and fc1 split their output
# features, proj and fc2 their input features; the codebook its codes.
# The guard (JAX: every split dimension divides the axis) is the tensor
# and dim whose size must divide the axis, found by replacing the key's
# tail: the heads for the attention (qkv by head, so that each rank holds
# whole heads of q, k and v), the hidden width for the MLP, the codes for
# the codebook; a pair whose dimension does not divide stays whole. The
# relative-position bias table is split by head too (JAX keeps it whole):
# each rank reads only its heads' columns, so a whole table would need its
# gradient all-reduced to keep the model ranks equal.
_HEADS = (r'attn\..*$', 'attn.relative_position_bias_table', 1)
_HIDDEN = (r'mlp\..*$', 'mlp.fc1.weight', 0)
_CODES = (r'$', '', 0)
TP_RULES = (
    (r'.*attn\.qkv\.weight$', 0, 3, _HEADS),
    (r'.*attn\.qkv\.bias$', 0, 3, _HEADS),
    (r'.*attn\.proj\.weight$', 1, 1, _HEADS),
    (r'.*attn\.relative_position_bias_table$', 1, 1, _HEADS),
    (r'.*mlp\.fc1\.weight$', 0, 1, _HIDDEN),
    (r'.*mlp\.fc1\.bias$', 0, 1, _HIDDEN),
    (r'.*mlp\.fc2\.weight$', 1, 1, _HIDDEN),
    (r'.*quantize_group\.\d+\.embedding\.weight$', 0, 1, _CODES),
)


def rule_layout(state: Mapping[str, torch.Tensor], size: int) -> Layout:
    """The layout TP_RULES give a full state dict on an axis of `size`."""
    out = {}
    for key in state:
        for pattern, dim, blocks, (tail, repl, gdim) in TP_RULES:
            if re.match(pattern, key):
                guard = state[re.sub(tail, repl, key, count=1)]
                if guard.shape[gdim] % size == 0:
                    out[key] = (dim, blocks)
                break
    return out


def split_layout(model: nn.Module) -> Layout:
    """The layout of a model's split parameters (each split module's
    `tp_layout`), keyed as in its state dict."""
    out = {}
    for name, mod in model.named_modules():
        for key, spec in getattr(mod, 'tp_layout', {}).items():
            out[f'{name}.{key}' if name else key] = spec
    return out


def shard_state_dict(state: Mapping[str, torch.Tensor], rank: int, tp: int,
                     layout: Optional[Layout] = None
                     ) -> Dict[str, torch.Tensor]:
    """Rank `rank`'s part of a full state dict on an axis of `tp`, by
    `layout` (default: `rule_layout`); other keys are kept whole."""
    layout = rule_layout(state, tp) if layout is None else layout
    return {k: (shard(v, *layout[k], tp, rank) if k in layout else v)
            for k, v in state.items()}


def gather_state_dict(state: Mapping[str, torch.Tensor], layout: Layout,
                      axis: Optional[ModelAxis]
                      ) -> Dict[str, torch.Tensor]:
    """The full state dict of every model rank's part (`layout` keys are
    gathered over the axis; a collective: every model rank calls it, and
    every one gets the result)."""
    if axis is None:
        return dict(state)
    return {k: (unshard(all_gather(v, axis.group, axis.size), *layout[k])
                if k in layout else v) for k, v in state.items()}


def local_state(model: nn.Module, state: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """A full state dict cut to the parts of `model`'s split parameters: a
    tensor of a split parameter's whole shape becomes the rank's part;
    any other is kept as it is (a load then sees its shape)."""
    axis = getattr(model, 'tp', None)
    if axis is None:
        return dict(state)
    own = model.state_dict()

    def whole(k, dim):
        shape = list(own[k].shape)
        shape[dim] *= axis.size
        return shape
    layout = {k: spec for k, spec in split_layout(model).items()
              if k in state and list(state[k].shape) == whole(k, spec[0])}
    return shard_state_dict(state, axis.rank, axis.size, layout)


def create_mesh(data: Optional[int] = None, model: int = 1,
                device_type: str = 'cuda'):
    """A ('data', 'model') DeviceMesh over the process group's ranks, data
    x model = world size (data defaults to world size / model), rank = d *
    model + m, whose axes use the process group's backend (DeviceMesh
    would otherwise give a CUDA mesh NCCL groups under a gloo run). Needs
    an initialized process group (`dist_util.init_dist`)."""
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


def model_size(mesh) -> int:
    """Ranks on the mesh's 'model' axis (1 without a mesh)."""
    return mesh['model'].size() if mesh is not None else 1


def model_rank(mesh) -> int:
    return mesh.get_local_rank('model') if mesh is not None else 0


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
    """Every data rank's block of the same shape, concatenated in rank
    order, on every rank (on x's device). gloo gathers CPU tensors only,
    so a CUDA block goes through the host under gloo."""
    group = mesh.get_group('data') if mesh is not None else None
    w = data_size(mesh)
    if w == 1:
        return x
    return torch.cat(all_gather(x, group, w))
