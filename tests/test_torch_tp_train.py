"""Tensor-parallel training of the port on the CPU: `train_cli
--launcher pytorch` with `model_parallel: 2` (two gloo ranks, one data
group: net_g's Swin linears and codebook split over them; four ranks for
dp=2 x tp=2) against one process without a launcher, on the seeded
folder and weights of tests/torch_dist_cases.py (each rank a subprocess
on one thread, tests/torch_dist_worker.py). Evaluation at tp=2 is in
tests/test_torch_tp_serve.py.

Held:
- the LQ stage (2 iterations, the GAN term and the discriminator step)
  at tp=2 (batch 2) and at dp=2 x tp=2 (four ranks, batch 1 per data
  group), and the HQ stage (1 iteration, its codebook loss on the split
  codebook) at dp=2 x tp=2, equal one process at batch 2: the networks
  as saved (whole) within 1e-5 of each tensor's largest value, the
  logged losses within 1e-5; every tensor held whole on each rank (the
  replicated ones) is bit-equal across the ranks; the HQ step moves both
  halves of the codebook;
- the LQ runs train with SGD and momentum 0.9; the tp=2 run saves its
  state at iteration 1, and a resume from it replays iteration 2 bit for
  bit; the saved .pth and training state are whole: net_g loads strictly
  into the unsplit FeMaSRNet, and the momentum buffers of the split
  parameters have the whole shapes.
"""

import numpy as np
import pytest
import torch

from femasr_torch.models import FeMaSRNet
from torch_dist_cases import (CASES, LOSSES, RTOL, SMALL,
                              assert_states_close, job, make_folder,
                              read_runs)
from torch_port_util import start_ranks, wait_ranks



def _tp(opt, n=2):
    return dict(opt, model_parallel=n)


def _lq(root, batch, **kw):
    """The LQ case with SGD momentum (a moment of every parameter in the
    training state)."""
    opt = CASES['lq'](root, batch)
    opt['train'].update(kw)
    for k in ('optim_g', 'optim_d'):
        opt['train'][k]['momentum'] = 0.9
    return opt


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = make_folder(tmp_path_factory.mktemp('tp_train_data'))
    work = tmp_path_factory.mktemp('tp_train')
    lq_tp2 = _tp(_lq(root, 2))
    lq_tp2['logger']['save_checkpoint_freq'] = 1
    state = work / 'tp2' / 'experiments' / 'lq' / 'training_states'

    launcher = ('--launcher', 'pytorch')
    tp2 = [job(work / 'tp2', 'lq', lq_tp2, *launcher),
           job(work / 'tp2', 'again', lq_tp2, *launcher, '--force_yml',
               f'path:resume_state={state / "1.state"}', 'name=resumed')]
    w1 = [job(work / 'w1', 'lq', _lq(root, 2)),
          job(work / 'w1', 'hq', CASES['hq'](root, 2))]
    w4 = [job(work / 'w4', 'lq', _tp(_lq(root, 1)), *launcher),
          job(work / 'w4', 'hq', _tp(CASES['hq'](root, 1)), *launcher)]
    started = [start_ranks(tp2, str(work / 'out_tp2'), 2),
               start_ranks(w1, str(work / 'out_w1'), 0),
               start_ranks(w4, str(work / 'out_w4'), 4)]
    out = dict(zip(('tp2', 'w1', 'w4'), wait_ranks(*started, timeout=240)))
    out['state'] = torch.load(str(state / '1.state'), weights_only=True)
    out['hq_init'] = torch.load(str(root / 'hq.pth'))['params']
    out['runs'] = {k: read_runs(work / k) for k in ('tp2', 'w1', 'w4')}
    return out


def _equal_to_one_process(one, split, ranks):
    """The split run's saved networks and losses within RTOL of one
    process's, and its ranks' whole tensors bit-equal."""
    (log1, nets1), (log2, nets2) = one, split
    for net in ('net_g', 'net_d'):
        assert_states_close(nets1[net], nets2[net], RTOL)
    assert [r['iter'] for r in log1] == [r['iter'] for r in log2]
    for a, b in zip(log1, log2):
        for k in LOSSES:
            if k in a:
                assert np.isfinite(b[k]), (k, b[k])
                assert abs(a[k] - b[k]) <= RTOL * max(abs(a[k]), 1e-3), (
                    a['iter'], k, a[k], b[k])
    for r in ranks[1:]:
        assert r['whole_g'] == ranks[0]['whole_g']
        assert r['net_d'] == ranks[0]['net_d']
    assert ranks[0]['ddp'] == 'DistributedDataParallel'
    assert ranks[0]['no_grad'] == []


@pytest.mark.parametrize('world,case,n_split', [
    ('tp2', 'lq', 169), ('w4', 'lq', 169), ('w4', 'hq', 1)],
    ids=['lq', 'lq_dp2', 'hq_dp2'])
def test_tp2_training_equals_one_process(runs, world, case, n_split):
    ranks = runs[world][case]
    assert len(ranks) == (2 if world == 'tp2' else 4)
    assert len(ranks[0]['split']) == n_split   # 24 blocks x 7, codebook
    _equal_to_one_process(runs['runs']['w1'][case],
                          runs['runs'][world][case], ranks)
    if case == 'hq':
        key = 'quantize_group.0.embedding.weight'
        moved = runs['runs'][world]['hq'][1]['net_g'][key] != \
            runs['hq_init'][key]
        assert moved[:8].any() and moved[8:].any()   # both ranks' codes


def test_resume_at_tp2_replays_the_uninterrupted_run(runs):
    (log, nets), (again, nets_again) = (runs['runs']['tp2']['lq'],
                                        runs['runs']['tp2']['resumed'])
    assert [r['iter'] for r in log] == [1, 2]
    assert [r['iter'] for r in again] == [2]
    for k in LOSSES:
        assert log[1][k] == again[0][k], k
    for net in ('net_g', 'net_d'):
        for k, v in nets[net].items():
            assert torch.equal(v, nets_again[net][k]), (net, k)
    for rank in (0, 1):
        for net in ('net_g', 'net_d'):
            assert runs['tp2']['again'][rank][net] == \
                runs['tp2']['lq'][rank][net]


def test_tp2_checkpoints_are_whole(runs):
    _, nets = runs['runs']['tp2']['lq']
    net = FeMaSRNet(SMALL, LQ_stage=True)
    net.load_state_dict(nets['net_g'], strict=True)
    state = runs['state']['state']
    net.load_state_dict(state['params_g'], strict=True)
    whole = dict(net.named_parameters())
    frozen = ('quantize', 'decoder', 'after_quant_group', 'out_conv')
    names = [n for n in whole if not any(f in n for f in frozen)]
    assert len(state['opt_g']['state']) == len(names)
    split = set(runs['tp2']['lq'][0]['split'])
    assert split & set(names)
    for i, name in enumerate(names):
        buf = state['opt_g']['state'][i]['momentum_buffer']
        assert buf.shape == whole[name].shape, name
