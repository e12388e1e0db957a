"""Training and test options: the YAML (or JSON) schema and CLI of the JAX
package (counterpart of femasr_tpu/utils/options.py).

`parse_options` reads the file (`!!float` tags and anchors as PyYAML reads
them; a `.json` file needs no PyYAML) or takes a ready dict, applies
`--force_yml` overrides, refuses what the port does not carry (see
`check_port_options`), joins the run's process group under a launcher
(`--launcher pytorch|slurm`: one process per device; data parallel, and
with `model_parallel: N` the model split over N ranks of each data
group), seeds the global random streams with manual_seed + data rank (the
model ranks of a data group draw alike), and fills in the
paths: experiments/<name>/ for training, results/<name>/ for evaluation
(is_train=False). The device is `device` in the options: CUDA by default
(under a launcher cuda:LOCAL_RANK; `cuda:i` puts every rank on card i),
the CPU only when asked.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import random
import sys
from os import path as osp
from typing import Any, Optional

from ..parallel.dist_util import (LAUNCHERS, broadcast_object, get_dist_info,
                                  init_dist, master_only)

# network_g keys of the JAX FeMaSRNet that the port builds; vq_backend and
# vq_index_f32 are accepted because the port's search is always the f32
# kernel (the Pallas backend with index_f32)
NETWORK_G_KEYS = {'type', 'codebook_params', 'in_channel', 'gt_resolution',
                  'LQ_stage', 'norm_type', 'act_type', 'use_quantize',
                  'scale_factor', 'use_semantic_loss',
                  'frozen_module_keywords', 'vq_backend', 'vq_index_f32',
                  'dtype', 'use_checkpoint'}
NETWORK_D_KEYS = {'type', 'num_in_ch', 'num_feat', 'skip_connection', 'dtype'}
# TPU program knobs of the JAX package: the port keeps no such formulation
TPU_KNOBS = {('train', 'chain_steps'): 'K G+D steps per XLA dispatch',
             ('train', 'flat_optimizer'): 'one raveled Adam vector',
             ('network_g', 'attn_pack'): 'window-packed attention einsums',
             ('logger', 'profile_start_iter'): 'a jax.profiler window'}


class OptionError(ValueError):
    """An option the port does not carry, with what to do about it."""


def yaml_load(f: str) -> Any:
    """YAML from a file path or a literal YAML string."""
    import yaml
    if os.path.isfile(f):
        with open(f) as fh:
            return yaml.safe_load(fh)
    return yaml.safe_load(f)


def load_options(path: str) -> dict:
    """A `.json` options file, or a YAML one."""
    if path.endswith('.json'):
        with open(path) as f:
            return json.load(f)
    return yaml_load(path)


def dict2str(opt: dict, indent_level: int = 1) -> str:
    msg = '\n'
    for k, v in opt.items():
        pad = ' ' * (indent_level * 2)
        if isinstance(v, dict):
            msg += pad + k + ':[' + dict2str(v, indent_level + 1) + pad + ']\n'
        else:
            msg += pad + k + ': ' + str(v) + '\n'
    return msg


def _postprocess_yml_value(value: str) -> Any:
    if value == '~' or value.lower() == 'none':
        return None
    if value.lower() in ('true', 'false'):
        return value.lower() == 'true'
    if value.startswith('['):
        return json.loads(value)
    if value.isdigit():
        return int(value)
    try:
        return float(value)
    except ValueError:
        return value


def apply_force_yml(opt: dict, force_yml) -> None:
    """`key:sub=val` overrides."""
    for entry in force_yml or ():
        keys, value = entry.replace(' ', '').split('=', 1)
        target = opt
        key_path = keys.split(':')
        for key in key_path[:-1]:
            target = target[key]
        target[key_path[-1]] = _postprocess_yml_value(value)


def check_port_options(opt: dict) -> None:
    """Refuse, with the reason, every option whose behaviour the port does
    not have; none is silently ignored."""
    def refuse(msg):
        raise OptionError(msg)

    if opt.get('model_type', 'FeMaSRModel') != 'FeMaSRModel':
        refuse(f'model_type {opt["model_type"]!r} is not ported '
               '(FeMaSRModel is)')

    for (section, key), what in TPU_KNOBS.items():
        if key in (opt.get(section) or {}):
            refuse(f'{section}.{key} is a TPU program knob of the JAX '
                   f'package ({what}); the port does not carry it: remove '
                   'the key')
    for net, keys in (('network_g', NETWORK_G_KEYS),
                      ('network_d', NETWORK_D_KEYS)):
        nopt = opt.get(net) or {}
        extra = sorted(set(nopt) - keys)
        if extra:
            refuse(f'{net}: {extra} are serving or TPU formulations of the '
                   'JAX package that the port does not train')
        if nopt.get('dtype') not in (None, 'float32', 'bfloat16'):
            refuse(f'{net}.dtype: {nopt["dtype"]} is not ported (float32 '
                   'or bfloat16)')
    gopt = opt.get('network_g') or {}
    if gopt.get('dtype') == 'bfloat16' and gopt.get('vq_index_f32') is False:
        refuse('network_g.vq_index_f32: false (a bfloat16 codebook search) '
               'is not ported: the port searches in float32 at every dtype; '
               'remove the key or set it true')


def torchrun_command(n, is_train: bool) -> str:
    cli = 'train_cli' if is_train else 'test_cli'
    return (f'torchrun --nproc_per_node {n} -m femasr_torch.{cli} -opt '
            '<options> --launcher pytorch')


def resolve_world(opt: dict, launcher: str, is_train: bool) -> None:
    """opt['dist'], opt['rank'], opt['world_size'], num_gpu and the mesh's
    axes (model_parallel, data_parallel = world / model_parallel,
    data_rank = rank // model_parallel) from the launcher: under one,
    `num_gpu: auto` is the world size and an explicit value must equal
    it, and model_parallel must divide the world; without one, auto is 1
    and num_gpu > 1, model_parallel > 1 or `dist: true` is refused with
    the command that starts the ranks."""
    rank, world = get_dist_info()
    num_gpu = opt.get('num_gpu', 'auto')
    num_gpu = 'auto' if num_gpu is None else num_gpu
    mp = int(opt.get('model_parallel', 1) or 1)
    if mp < 1:
        raise OptionError(f'model_parallel: {mp}: give 1 or more')
    if launcher == 'none':
        if opt.get('dist'):
            raise OptionError('dist: true needs one process per device, '
                              'started by a launcher: '
                              + torchrun_command('N', is_train))
        if num_gpu != 'auto' and int(num_gpu) > 1:
            raise OptionError(
                f'num_gpu: {num_gpu} needs one process per device, started '
                f'by a launcher: {torchrun_command(num_gpu, is_train)} '
                '(or Slurm with --launcher slurm)')
        if mp > 1:
            raise OptionError(
                f'model_parallel: {mp} splits the model over {mp} processes, '
                f'one per device, started by a launcher: '
                f'{torchrun_command(mp, is_train)} (or Slurm with '
                '--launcher slurm)')
        opt.update(dist=False, rank=0, world_size=1,
                   num_gpu=1 if num_gpu == 'auto' else int(num_gpu),
                   model_parallel=1, data_parallel=1, data_rank=0)
        return
    if num_gpu != 'auto' and int(num_gpu) != world:
        raise OptionError(f'num_gpu: {num_gpu}, but the launcher started '
                          f'{world} processes: set num_gpu: auto or start '
                          f'{num_gpu} ({torchrun_command(num_gpu, is_train)})')
    if world % mp:
        raise OptionError(
            f'model_parallel: {mp} does not divide the {world} processes '
            'the launcher started (the data-parallel size is the world '
            'size / model_parallel): start a multiple of '
            f'{mp} ({torchrun_command(mp, is_train)})')
    opt.update(dist=True, rank=rank, world_size=world, num_gpu=world,
               model_parallel=mp, data_parallel=world // mp,
               data_rank=rank // mp)


def set_random_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global random streams (the port
    draws its own randomness from explicit generators; this keeps any
    other draw reproducible per rank)."""
    import numpy as np
    import torch
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def parse_options(root_path: str, is_train: bool = True,
                  argv: Optional[list] = None, opt: Optional[dict] = None):
    """CLI + options file (or the dict `opt`) -> (opt, args)."""
    parser = argparse.ArgumentParser()
    parser.add_argument('-opt', type=str, required=opt is None,
                        help='Path to the options YAML or JSON file.')
    parser.add_argument('--launcher', choices=list(LAUNCHERS),
                        default='none',
                        help='none: one process on one device; pytorch: one '
                             'process per device started by torchrun; '
                             'slurm: started by srun (data parallel)')
    parser.add_argument('--dist_backend', choices=['nccl', 'gloo'],
                        default=None,
                        help='with a launcher: the process group\'s backend '
                             '(default nccl on the card, gloo on the CPU)')
    parser.add_argument('--auto_resume', action='store_true')
    parser.add_argument('--debug', action='store_true')
    parser.add_argument('--force_yml', nargs='+', action='append',
                        default=None,
                        help='Override options, e.g. train:ema_decay=0.999')
    args = parser.parse_args(argv)
    force = [e for group in args.force_yml or () for e in group]

    opt = copy.deepcopy(opt) if opt is not None else load_options(args.opt)
    apply_force_yml(opt, force)
    check_port_options(opt)
    opt.setdefault('device', 'cuda')
    if args.launcher == 'none' and args.dist_backend is not None:
        raise OptionError('--dist_backend needs a launcher (--launcher '
                          'pytorch or slurm)')
    opt['device'] = str(init_dist(args.launcher, args.dist_backend,
                                  opt['device']))
    resolve_world(opt, args.launcher, is_train)

    # one seed for every rank, drawn on rank 0 when the file has none
    if opt.get('manual_seed') is None:
        opt['manual_seed'] = broadcast_object(random.randint(1, 10000))
    set_random_seed(int(opt['manual_seed']) + opt['data_rank'])
    opt.update(auto_resume=args.auto_resume, is_train=is_train,
               root_path=root_path)
    if args.debug and not opt['name'].startswith('debug'):
        opt['name'] = 'debug_' + opt['name']

    for phase, dataset in (opt.get('datasets') or {}).items():
        dataset['phase'] = phase.split('_')[0]
        if 'scale' in opt:
            dataset['scale'] = opt['scale']
        for key in ('dataroot_gt', 'dataroot_lq'):
            if dataset.get(key) is not None:
                dataset[key] = osp.expanduser(dataset[key])

    opt['path'] = dict(opt.get('path') or {})
    for key, val in opt['path'].items():
        if val is not None and ('resume_state' in key or 'pretrain' in key):
            opt['path'][key] = osp.expanduser(val)

    if is_train:
        root = osp.join(root_path, 'experiments', opt['name'])
        opt['path'].update(experiments_root=root, log=root,
                           models=osp.join(root, 'models'),
                           training_states=osp.join(root, 'training_states'),
                           visualization=osp.join(root, 'visualization'))
        if 'debug' in opt['name']:
            if 'val' in opt:
                opt['val']['val_freq'] = 8
            opt['logger']['print_freq'] = 1
            opt['logger']['save_checkpoint_freq'] = 8
    else:
        root = osp.join(root_path, 'results', opt['name'])
        opt['path'].update(results_root=root, log=root,
                           visualization=osp.join(root, 'visualization'))
    return opt, args


@master_only
def copy_opt_file(opt_file: Optional[str], opt: dict,
                  experiments_root: str) -> None:
    """Archive the options (the file, or the dict as JSON) and the command
    line in the experiment directory (rank 0)."""
    os.makedirs(experiments_root, exist_ok=True)
    cmd = ' '.join(sys.argv)
    if opt_file is None:
        with open(osp.join(experiments_root, 'options.json'), 'w') as f:
            json.dump({'cmd': cmd, 'options': opt}, f, indent=1,
                      default=str)
        return
    with open(opt_file) as f:
        text = f.read()
    dst = osp.join(experiments_root, osp.basename(opt_file))
    with open(dst, 'w') as f:
        if opt_file.endswith('.json'):
            f.write(text)
        else:
            f.write(f'# CMD:\n# {cmd}\n\n{text}')
