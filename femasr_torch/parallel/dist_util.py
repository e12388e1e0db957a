"""Process groups of a data-parallel run (counterpart of
femasr_tpu/parallel/dist_util.py): one process per device, started by
torchrun (`python -m torch.distributed.run`) or by Slurm, joined through
torch.distributed, NCCL on the card and gloo on the CPU.

Nothing here falls back. A launcher whose process group does not start
raises (the JAX package's `init_dist('jax')` carries on as one process);
the backend follows the device unless the caller names it; a CUDA device
without a card raises. Collectives time out after `DEFAULT_TIMEOUT`, so a
rank whose peer died fails instead of waiting for ever.
"""

from __future__ import annotations

import datetime
import functools
import os
from typing import Any, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)
SLURM_PORT = 29500
LAUNCHERS = ('none', 'pytorch', 'slurm')


def slurm_env(environ: Mapping[str, str] = os.environ,
              port: int = SLURM_PORT) -> dict:
    """torch.distributed's env:// variables from Slurm's: RANK from
    SLURM_PROCID, WORLD_SIZE from SLURM_NTASKS, LOCAL_RANK from
    SLURM_LOCALID, MASTER_ADDR the first host of SLURM_NODELIST (parsed as
    the JAX package parses it) and MASTER_PORT `port`, unless the
    environment already sets one."""
    node_list = environ['SLURM_NODELIST']
    addr = node_list.split(',')[0].replace('[', '').split('-')[0]
    return {'RANK': environ['SLURM_PROCID'],
            'WORLD_SIZE': environ['SLURM_NTASKS'],
            'LOCAL_RANK': environ['SLURM_LOCALID'],
            'MASTER_ADDR': addr,
            'MASTER_PORT': environ.get('MASTER_PORT', str(port))}


def _launcher_env(launcher: str) -> dict:
    if launcher == 'slurm':
        env = slurm_env()
        os.environ.update(env)
        return env
    missing = [k for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                           'MASTER_PORT') if k not in os.environ]
    if missing:
        raise RuntimeError(
            f'--launcher pytorch: {missing} are not set; start the processes '
            'with torchrun (python -m torch.distributed.run --nproc_per_node '
            'N ...)')
    return {k: os.environ[k] for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK',
                                       'MASTER_ADDR', 'MASTER_PORT')}


def init_dist(launcher: str, backend: Optional[str] = None,
              device='cuda', timeout: datetime.timedelta = DEFAULT_TIMEOUT,
              **kwargs) -> torch.device:
    """Join this process to the run's process group; returns its device.

    launcher: 'none' (one process: nothing to join; the device is returned
    as given), 'pytorch' (torchrun's RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT) or 'slurm' (`slurm_env`; `port=` overrides
    29500). device: 'cuda' puts rank r on cuda:LOCAL_RANK (under Slurm
    modulo the cards the task sees, as srun may bind one card per task),
    'cuda:i' puts every rank on card i (only gloo allows two ranks on one
    card), 'cpu' on the CPU. backend: 'nccl' for a CUDA device, 'gloo' for the CPU,
    unless given. A process already joined keeps its group."""
    from ..models.inference import resolve_device
    if launcher not in LAUNCHERS:
        raise ValueError(f'Invalid launcher type: {launcher} '
                         f'(one of {LAUNCHERS})')
    if launcher == 'none':
        return torch.device(device)
    device = resolve_device(device)
    if launcher == 'slurm' and 'port' in kwargs:
        os.environ['MASTER_PORT'] = str(kwargs['port'])
    env = _launcher_env(launcher)
    rank, world = int(env['RANK']), int(env['WORLD_SIZE'])
    if device.type == 'cuda':
        if device.index is None:
            index = int(env['LOCAL_RANK'])
            if launcher == 'slurm':     # srun may bind each task a card
                index %= torch.cuda.device_count()
            device = torch.device('cuda', index)
        torch.cuda.set_device(device)
        torch.cuda.init()
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise RuntimeError('a process group of another rank or size is '
                               'already initialized')
        return device
    dist.init_process_group(backend, init_method='env://', rank=rank,
                            world_size=world, timeout=timeout)
    return device


def get_dist_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) when no process group is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_dist() -> bool:
    return dist.is_available() and dist.is_initialized()


def master_only(func):
    """Decorator: the function runs on rank 0 only (None elsewhere)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if get_dist_info()[0] == 0:
            return func(*args, **kwargs)
        return None

    return wrapper


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if is_dist():
        dist.barrier()


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """rank src's `obj` on every rank (picklable objects)."""
    if not is_dist():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_object(obj: Any) -> list:
    """Every rank's `obj`, in rank order."""
    if not is_dist():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def shutdown() -> None:
    """Leave the process group (at the end of a CLI run)."""
    if is_dist():
        dist.destroy_process_group()
