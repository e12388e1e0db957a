"""The training loop and offline evaluation (counterpart of
femasr_tpu/train/pipeline.py).

`train_pipeline` runs `train.total_iter` iterations over the train
DataLoader, logs every `logger.print_freq` (and with TensorBoard the
model's current visuals as `samples/<name>` every
`logger.show_tf_imgs_freq`), saves checkpoints and the
training state every `logger.save_checkpoint_freq` (and the latest networks
every `save_latest_freq`), validates on `datasets.val` every `val.val_freq`
and once more after the last iteration, and resumes from
`path.resume_state` or, with --auto_resume, from the newest state of the
experiment. A resumed run sees the batches the uninterrupted run would
have seen: the loader restarts at the epoch and position of the resumed
iteration. `test_pipeline` evaluates `path.pretrain_network_g` on each
dataset of the options.

Data parallel (`--launcher pytorch|slurm`): every rank runs this loop on
its block of each global batch of batch_size_per_gpu x world size, so an
epoch has len x ratio // (batch x world) iterations and the resume skip
counts global positions; rank 0 alone makes the experiment directory,
writes checkpoints, the log and TensorBoard (the others wait for it where
they read what it wrote), and validation and evaluation share the images
out among the ranks (`FeMaSRModel.dist_validation`).

Tensor parallel (`model_parallel: N` under a launcher): the N model ranks
of each data group split the networks and take the same block of each
global batch, so the loop runs on the data axis: batch_size_per_gpu x
(world size / N) a global batch.
"""

from __future__ import annotations

import datetime
import logging
import math
import time
from os import path as osp
from typing import Optional

from ..data import build_dataset, build_eval_loader, build_train_loader
from ..models.inference import resolve_device
from ..utils.logger import (AvgTimer, MessageLogger, get_env_info,
                            get_root_logger, init_tb_logger)
from ..utils.misc import disable_tf32, get_time_str, make_exp_dirs, scandir
from ..parallel.dist_util import barrier
from ..utils.options import copy_opt_file, dict2str, parse_options
from .femasr_model import FeMaSRModel


def load_resume_state(opt: dict) -> Optional[str]:
    """The state to resume from: the newest training_states/*.state of the
    experiment with auto_resume, else path.resume_state."""
    if opt['auto_resume']:
        state_dir = opt['path']['training_states']
        if osp.isdir(state_dir):
            states = [int(v.split('.state')[0]) for v in
                      scandir(state_dir, suffix='.state')]
            if states:
                opt['path']['resume_state'] = osp.join(
                    state_dir, f'{max(states)}.state')
    return opt['path'].get('resume_state')


def tb_wanted(opt: dict) -> bool:
    return bool(opt['logger'].get('use_tb_logger')
                and 'debug' not in opt['name'])


def init_tb(opt: dict, logger):
    if not tb_wanted(opt) or opt['rank'] != 0:
        return None
    try:
        return init_tb_logger(osp.join(opt['root_path'], 'tb_logger',
                                       opt['name']))
    except ImportError as e:
        logger.warning(f'tensorboard unavailable: {e}')
        return None


def crossed(freq, lo: int, hi: int) -> bool:
    """True iff a multiple of freq lies in (lo, hi]."""
    freq = int(float(freq))
    return freq > 0 and hi // freq > lo // freq


def train_pipeline(root_path: str, argv=None, opt: Optional[dict] = None
                   ) -> FeMaSRModel:
    opt, args = parse_options(root_path, is_train=True, argv=argv, opt=opt)
    resolve_device(opt['device'])       # no card: stop before any file
    resume_state_path = load_resume_state(opt)
    if resume_state_path is None:
        make_exp_dirs(opt)
    copy_opt_file(args.opt, opt, opt['path']['experiments_root'])
    logger = get_root_logger(log_level=logging.INFO, log_file=osp.join(
        opt['path']['log'], f"train_{opt['name']}_{get_time_str()}.log"))
    logger.info(get_env_info())
    logger.info(dict2str(opt))
    log_world(opt, logger)
    disable_tf32(logger)
    tb_logger = init_tb(opt, logger)

    dataset_opt = opt['datasets']['train']
    model = FeMaSRModel(opt)
    train_set = build_dataset(dataset_opt)
    val_loader = None
    for phase, vopt in opt['datasets'].items():
        if phase == 'val':
            val_loader = build_eval_loader(build_dataset(vopt))
            logger.info(f'Number of val images in {vopt["name"]}: '
                        f'{len(val_loader.dataset)}')
        elif phase != 'train':
            raise ValueError(f'Dataset phase {phase} is not recognized.')
    val_opt = opt.get('val') if val_loader is not None else None
    world = opt['data_parallel']
    loader, sampler = build_train_loader(
        train_set, dataset_opt, opt['manual_seed'],
        pin_memory=model.device.type == 'cuda', rank=opt['data_rank'],
        world_size=world)
    total_iters = int(float(opt['train']['total_iter']))
    global_batch = dataset_opt['batch_size_per_gpu'] * world
    per_epoch = len(train_set) * dataset_opt.get('dataset_enlarge_ratio', 1) \
        // global_batch
    if per_epoch == 0:
        raise ValueError('the train set holds fewer images than one batch')
    logger.info(f'Training statistics:\n\tNumber of train images: '
                f'{len(train_set)}\n\tBatch size per device: '
                f"{dataset_opt['batch_size_per_gpu']}\n\tData-parallel "
                f'size: {world}\n\tIters per epoch: '
                f'{per_epoch}\n\tTotal epochs: '
                f'{math.ceil(total_iters / per_epoch)}; iters: {total_iters}.')

    current_iter = 0
    if resume_state_path:
        current_iter = model.resume_training(resume_state_path)['iter']
        logger.info(f'Resuming training from iter: {current_iter}.')
    epoch, skip = divmod(current_iter, per_epoch)
    msg_logger = MessageLogger(opt, current_iter, tb_logger)
    data_timer, iter_timer = AvgTimer(), AvgTimer()
    start_time = time.time()
    lg = opt['logger']
    # a split net_g decodes the codebook visuals on every model rank
    # together; rank 0 shows them
    visuals = tb_logger is not None or (model.tp is not None
                                        and tb_wanted(opt))
    while current_iter < total_iters:
        sampler.start(epoch, skip * global_batch)
        skip = 0
        for train_data in loader:
            data_timer.record()
            prev_iter, current_iter = current_iter, current_iter + 1
            model.feed_data(train_data)
            model.optimize_parameters(current_iter)
            iter_timer.record()
            if prev_iter == 0:
                msg_logger.reset_start_time()
            if crossed(lg['print_freq'], prev_iter, current_iter):
                log_vars = {'epoch': epoch, 'iter': current_iter,
                            'lrs': model.get_current_learning_rate(),
                            'time': iter_timer.get_avg_time(),
                            'data_time': data_timer.get_avg_time()}
                log_vars.update(model.get_current_log())
                msg_logger(log_vars)
            if visuals and crossed(lg.get('show_tf_imgs_freq', 0),
                                   prev_iter, current_iter):
                shown = model.get_current_visuals()
                for k, v in shown.items() if tb_logger is not None else ():
                    tb_logger.add_images(f'samples/{k}', v.clamp(0, 1).cpu(),
                                         current_iter, dataformats='NCHW')
            if crossed(lg.get('save_checkpoint_freq', 0), prev_iter,
                       current_iter):
                logger.info('Saving models and training states.')
                model.save(epoch, current_iter)
            if crossed(lg.get('save_latest_freq', 0), prev_iter,
                       current_iter):
                logger.info('Saving latest models.')
                model.save(epoch, -1)
            if val_opt is not None and crossed(val_opt['val_freq'],
                                               prev_iter, current_iter):
                model.validation(val_loader, current_iter, tb_logger,
                                 val_opt.get('save_img', False))
            data_timer.start()
            iter_timer.start()
            if current_iter >= total_iters:
                break
        epoch += 1

    consumed = datetime.timedelta(seconds=int(time.time() - start_time))
    logger.info(f'End of training. Time consumed: {consumed}')
    logger.info('Save the latest model.')
    model.save(epoch=-1, current_iter=-1)
    if val_opt is not None:
        model.validation(val_loader, current_iter, tb_logger,
                         val_opt.get('save_img', False))
    if tb_logger is not None:
        tb_logger.close()
    barrier()       # every file of the run is written
    return model


def log_world(opt: dict, logger) -> None:
    """The run's world size; one process on a host with more cards says
    how to train on all of them."""
    if opt['dist']:
        logger.info(f"Data parallel: rank {opt['rank']} of "
                    f"{opt['world_size']} on {opt['device']}; data rank "
                    f"{opt['data_rank']} of {opt['data_parallel']}, "
                    f"model_parallel {opt['model_parallel']}")
        return
    import torch
    n = torch.cuda.device_count() if opt['device'].startswith('cuda') else 0
    if n > 1:
        cli = 'train_cli' if opt['is_train'] else 'test_cli'
        logger.info(f'{n} cards are visible and this run uses one; to use '
                    f'all: torchrun --nproc_per_node {n} -m '
                    f'femasr_torch.{cli} -opt <options> --launcher pytorch')


def test_pipeline(root_path: str, argv=None, opt: Optional[dict] = None
                  ) -> FeMaSRModel:
    """Evaluate the options' network on each of their datasets, in name
    order: SR images to results/<name>/visualization/<dataset>/ (unless
    val.save_img is false) and the val metrics on the datasets with GT."""
    opt, _ = parse_options(root_path, is_train=False, argv=argv, opt=opt)
    resolve_device(opt['device'])       # no card: stop before any file
    make_exp_dirs(opt)
    logger = get_root_logger(log_level=logging.INFO, log_file=osp.join(
        opt['path']['log'], f"test_{opt['name']}_{get_time_str()}.log"))
    logger.info(get_env_info())
    logger.info(dict2str(opt))
    log_world(opt, logger)
    disable_tf32(logger)
    loaders = []
    for _, dataset_opt in sorted(opt['datasets'].items()):
        loader = build_eval_loader(build_dataset(dataset_opt))
        logger.info(f"Number of test images in {dataset_opt['name']}: "
                    f'{len(loader.dataset)}')
        loaders.append(loader)
    model = FeMaSRModel(opt)
    for loader in loaders:
        logger.info(f"Testing {loader.dataset.opt['name']}...")
        model.validation(loader, current_iter=opt['name'], tb_logger=None,
                         save_img=opt['val'].get('save_img', True))
    barrier()
    return model
