"""Shared trainer facilities: the validation dispatch and best-metric
records, EMA, checkpoint and training-state I/O (counterpart of
femasr_tpu/train/base_model.py).

Networks are saved as reference-format .pth files in the reference's torch
keys: models/<label>_<iter>.pth holding {'params': state dict} (plus
'params_ema' for the generator's EMA), which the reference, the JAX
package's converters and this package's loaders all read. The training
state (optimizers, step, EMA, parameters, discriminator spectral vectors,
RNG states) goes to training_states/<iter>.state.

Data parallel (`opt['dist']`): the trained networks run wrapped in
DistributedDataParallel over the mesh's 'data' group (`model_to_device`;
the bare networks stay the model's own, so nothing unwraps them), the
logged values are the mean over the data ranks (`reduce_loss_dict`), and
rank 0 alone writes files. With a 'model' axis above 1 each data rank is
a group of model ranks that hold their parts of the split parameters;
the tensors held whole on every model rank take model rank 0's gradients
(`FeMaSRModel`), and DDP over the data group keeps them equal.
"""

from __future__ import annotations

import os
import time
from os import path as osp
from typing import Any, Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..parallel.dist_util import get_dist_info
from ..parallel.mesh import data_rank, data_size
from ..utils.logger import get_root_logger


class BaseModel:
    """Option handling, loss-log and metric bookkeeping, checkpoint I/O."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.is_train = opt.get('is_train', False)
        self.log_dict: Dict[str, float] = {}
        # dataset name -> metric -> {'better', 'val', 'iter'}
        self.best_metric_results: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self.dist = bool(opt.get('dist', False))
        self.rank, self.world_size = get_dist_info() if self.dist else (0, 1)
        self.mesh = None        # the ('data', 'model') mesh of a run

    @property
    def data_group(self):
        """The process group of this rank's data axis (None: the world)."""
        return self.mesh.get_group('data') if self.mesh is not None else None

    @property
    def data_size(self) -> int:
        return data_size(self.mesh) if self.dist else 1

    @property
    def data_rank(self) -> int:
        return data_rank(self.mesh) if self.dist else 0

    # -- data parallel ---------------------------------------------------

    def model_to_device(self, net: torch.nn.Module) -> torch.nn.Module:
        """net on the model's device; in a data-parallel run wrapped in
        DistributedDataParallel over the data group (one device per rank;
        the options' find_unused_parameters; no buffer broadcast: the only
        buffers that change, the discriminator's spectral vectors, are
        computed alike on every rank from the same weights)."""
        net = net.to(self.device)
        if not self.dist:
            return net
        return DistributedDataParallel(
            net, device_ids=([self.device.index] if self.device.type == 'cuda'
                             else None),
            process_group=self.data_group, broadcast_buffers=False,
            find_unused_parameters=bool(self.opt.get(
                'find_unused_parameters', False)))

    def reduce_loss_dict(self, loss_dict: Mapping[str, torch.Tensor]
                         ) -> Dict[str, float]:
        """The logged values as floats: in a data-parallel run each is the
        mean over the data ranks (one all-reduce), which for means over
        equal blocks is the mean over the global batch."""
        if not loss_dict:
            return {}
        if not self.dist:
            return {k: float(v) for k, v in loss_dict.items()}
        vals = torch.stack([v.detach().float().reshape(())
                            for v in loss_dict.values()])
        dist.all_reduce(vals, group=self.data_group)
        vals = (vals / self.data_size).tolist()
        return dict(zip(loss_dict, vals))

    # -- validation ------------------------------------------------------

    def validation(self, dataloader, current_iter, tb_logger,
                   save_img: bool = False) -> None:
        if self.opt.get('dist', False):
            self.dist_validation(dataloader, current_iter, tb_logger,
                                 save_img)
        else:
            self.nondist_validation(dataloader, current_iter, tb_logger,
                                    save_img)

    def dist_validation(self, *args, **kwargs):
        raise NotImplementedError

    def nondist_validation(self, *args, **kwargs):
        raise NotImplementedError

    def _initialize_best_metric_results(self, dataset_name: str) -> None:
        if dataset_name in self.best_metric_results:
            return
        record = {}
        for metric, content in self.opt['val']['metrics'].items():
            better = content.get('better', 'higher')
            init_val = float('-inf') if better == 'higher' else float('inf')
            record[metric] = {'better': better, 'val': init_val, 'iter': -1}
        self.best_metric_results[dataset_name] = record

    def _update_best_metric_result(self, dataset_name: str, metric: str,
                                   val: float, current_iter) -> bool:
        """Record val if it is at least as good as the best; True if so."""
        rec = self.best_metric_results[dataset_name][metric]
        improved = (val >= rec['val'] if rec['better'] == 'higher'
                    else val <= rec['val'])
        if improved:
            rec['val'], rec['iter'] = val, current_iter
        return improved

    def _update_metric_result(self, dataset_name: str, metric: str,
                              val: float, current_iter) -> None:
        rec = self.best_metric_results[dataset_name][metric]
        rec['val'], rec['iter'] = val, current_iter

    @staticmethod
    @torch.no_grad()
    def ema_update(ema: Mapping[str, torch.Tensor],
                   params: Mapping[str, torch.Tensor],
                   decay: float = 0.999) -> None:
        """In place: ema = ema * decay + params * (1 - decay), per tensor."""
        for name, e in ema.items():
            e.mul_(decay).add_(params[name].detach().to(e.dtype),
                               alpha=1 - decay)

    @staticmethod
    def _save_with_retry(obj: Any, path: str, retries: int = 3) -> None:
        """torch.save, retried three times a second apart before giving up
        with a warning (flaky shared file systems)."""
        os.makedirs(osp.dirname(path), exist_ok=True)
        for attempt in range(retries):
            try:
                torch.save(obj, path)
                return
            except OSError as e:
                get_root_logger().warning(
                    f'Save model error: {e}, remaining retry times: '
                    f'{retries - attempt - 1}')
                time.sleep(1)
        get_root_logger().warning(f'Still cannot save {path}. Just ignore it.')

    def save_network(self, state_dict: Mapping[str, torch.Tensor],
                     net_label: str, current_iter,
                     param_key: str = 'params',
                     extra_keys: Optional[Dict[str, Any]] = None) -> str:
        """models/<label>_<iter>.pth ('latest' for -1) holding
        {param_key: state_dict, **extra_keys}, on the CPU (rank 0 writes;
        every rank returns the path)."""
        current_iter = 'latest' if current_iter == -1 else current_iter
        fname = (f'{net_label}_{current_iter}.pth' if current_iter != ''
                 else f'{net_label}.pth')
        path = osp.join(self.opt['path']['models'], fname)
        if self.rank != 0:
            return path
        tree = {param_key: _cpu(state_dict)}
        for k, v in (extra_keys or {}).items():
            tree[k] = _cpu(v)
        self._save_with_retry(tree, path)
        return path

    def save_training_state(self, state: Dict[str, Any], epoch: int,
                            current_iter: int) -> None:
        """training_states/<iter>.state (nothing for iter -1; rank 0
        writes)."""
        if current_iter == -1 or self.rank != 0:
            return
        path = osp.join(self.opt['path']['training_states'],
                        f'{current_iter}.state')
        self._save_with_retry({'epoch': epoch, 'iter': current_iter,
                               'state': state}, path)

    @staticmethod
    def resume_training_state(path: str) -> Dict[str, Any]:
        """The saved state on the host, from where every rank copies it
        onto its own device (RNG states must stay CPU tensors)."""
        return torch.load(path, map_location='cpu', weights_only=True)


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree
