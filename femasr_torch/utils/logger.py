"""Training logs: root logger, iteration messages with ETA, timers
(counterpart of femasr_tpu/utils/logger.py).

Besides the text log, `MessageLogger` appends each logged iteration as one
JSON object to `<experiment>/train_log.jsonl` (iteration, learning rates,
times, losses), for scripts that read a run back. In a data-parallel run
rank 0 logs at INFO, writes the log file and the JSON lines; the other
ranks log errors only.
"""

from __future__ import annotations

import datetime
import json
import logging
import time
from os import path as osp
from typing import Optional

from ..parallel.dist_util import get_dist_info

initialized_logger = {}


class AvgTimer:
    """Windowed average of the time between `record` calls."""

    def __init__(self, window: int = 200):
        self.window = window
        self.total_time = 0.
        self.count = 0
        self.avg_time = 0.
        self.start()

    def start(self) -> None:
        self.start_time = self.tic = time.time()

    def record(self) -> None:
        self.count += 1
        self.toc = time.time()
        self.total_time += self.toc - self.tic
        self.avg_time = self.total_time / self.count
        if self.count > self.window:
            self.count = 0
            self.total_time = 0
        self.tic = time.time()

    def get_avg_time(self) -> float:
        return self.avg_time


class MessageLogger:
    """Formats an iteration's log line with ETA; mirrors `l_*` keys to
    TensorBoard when a writer is given, and every record to the JSON-lines
    log."""

    def __init__(self, opt: dict, start_iter: int = 1, tb_logger=None):
        self.exp_name = opt['name']
        self.start_iter = start_iter
        self.max_iters = opt['train']['total_iter']
        self.tb_logger = tb_logger
        self.json_path = osp.join(opt['path']['log'], 'train_log.jsonl')
        self.start_time = time.time()
        self.logger = get_root_logger()

    def reset_start_time(self) -> None:
        self.start_time = time.time()

    def __call__(self, log_vars: dict) -> None:
        record = dict(log_vars)
        current_iter = log_vars.pop('iter')
        epoch = log_vars.pop('epoch', 0)
        lrs = log_vars.pop('lrs', [])
        message = (f'[{self.exp_name[:5]}..][epoch:{epoch:3d}, '
                   f'iter:{current_iter:8,d}, lr:(')
        message += ''.join(f'{v:.3e},' for v in lrs) + ')] '
        if 'time' in log_vars:
            iter_time = log_vars.pop('time')
            data_time = log_vars.pop('data_time', 0.)
            total = time.time() - self.start_time
            per_iter = total / max(current_iter - self.start_iter + 1, 1)
            eta = datetime.timedelta(seconds=int(
                per_iter * max(self.max_iters - current_iter, 0)))
            message += (f'[eta: {eta}, time (data): {iter_time:.3f} '
                        f'({data_time:.3f})] ')
        for k, v in log_vars.items():
            message += f'{k}: {v:.4e} '
            if self.tb_logger is not None:
                label = f'losses/{k}' if k.startswith('l_') else k
                self.tb_logger.add_scalar(label, v, current_iter)
        self.logger.info(message)
        if _rank() == 0:
            with open(self.json_path, 'a') as f:
                f.write(json.dumps(record) + '\n')


def init_tb_logger(log_dir: str):
    from torch.utils.tensorboard import SummaryWriter
    return SummaryWriter(log_dir=log_dir)


def get_root_logger(logger_name: str = 'femasr_torch',
                    log_level: int = logging.INFO,
                    log_file: Optional[str] = None) -> logging.Logger:
    """The package's logger: to stderr, and to `log_file` when a call
    gives one. Off rank 0 of a data-parallel run it logs errors only and
    writes no file."""
    logger = logging.getLogger(logger_name)
    if _rank() != 0:
        if logger_name not in initialized_logger:
            _add_stream(logger)
            initialized_logger[logger_name] = True
        logger.setLevel(logging.ERROR)
        return logger
    if logger_name in initialized_logger:
        if log_file is not None:
            _add_file(logger, log_file, log_level)
        return logger
    _add_stream(logger)
    logger.setLevel(log_level)
    if log_file is not None:
        _add_file(logger, log_file, log_level)
    initialized_logger[logger_name] = True
    return logger


def _rank() -> int:
    return get_dist_info()[0]


def _add_stream(logger: logging.Logger) -> None:
    stream = logging.StreamHandler()
    stream.setFormatter(logging.Formatter(
        '%(asctime)s %(levelname)s: %(message)s'))
    logger.addHandler(stream)
    logger.propagate = False


def _add_file(logger: logging.Logger, log_file: str, level: int) -> None:
    for h in list(logger.handlers):      # one run, one file
        if isinstance(h, logging.FileHandler):
            logger.removeHandler(h)
            h.close()
    handler = logging.FileHandler(log_file, 'w')
    handler.setFormatter(logging.Formatter(
        '%(asctime)s %(levelname)s: %(message)s'))
    handler.setLevel(level)
    logger.addHandler(handler)


def get_env_info() -> str:
    import torch
    dev = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
           else 'no CUDA device')
    return ('\nVersion Information: '
            f'\n\ttorch: {torch.__version__}'
            f'\n\tcuda: {torch.version.cuda}'
            f'\n\tdevice: {dev}')
