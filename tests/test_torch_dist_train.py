"""Data-parallel training of the port on the CPU, the LQ stage: two gloo
ranks at batch_size_per_gpu 2 (`train_cli --launcher pytorch`,
DistributedDataParallel) against one process at batch 4, on the same
seeded folder and weights (tests/torch_dist_cases.py; each rank a
subprocess on one thread, tests/torch_dist_worker.py).

Held:
- the LQ stage with the GAN term and the discriminator step, plain and
  with grad_accum_chunks 2, two iterations: every parameter and spectral
  vector of both networks within 1e-5 of each tensor's largest value, the
  two ranks alike, and the logged losses (means over the ranks) within
  1e-5;
- one rank under the launcher (DDP at world 1) equals the run without a
  launcher bit for bit and leaves no trainable parameter without a
  gradient (so `find_unused_parameters` is not needed).

The training path reaches the JAX package through world 1:
tests/test_torch_train_grad_lq.py, test_torch_train_grad_hq.py and
test_torch_train_bf16*.py hold the port's one-process steps against JAX.
"""

import pytest
import torch

from torch_dist_cases import CASES, assert_world2_equals_world1, job
from torch_dist_cases import make_folder, read_runs
from torch_port_util import start_ranks, wait_ranks

NAMES = ('lq', 'lq_chunks')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = make_folder(tmp_path_factory.mktemp('dist_train_data'))
    work = tmp_path_factory.mktemp('dist_train')
    w2 = [job(work / 'w2', n, CASES[n](root, 2), '--launcher', 'pytorch')
          for n in NAMES]
    w1 = [job(work / 'w1', n, CASES[n](root, 4)) for n in NAMES]
    ddp1 = [job(work / 'ddp1', 'lq', CASES['lq'](root, 4), '--launcher',
                'pytorch')]
    started = [start_ranks(w2, str(work / 'out_w2'), 2),
               start_ranks(w1, str(work / 'out_w1'), 0),
               start_ranks(ddp1, str(work / 'out_ddp1'), 1)]
    out = dict(zip(('w2', 'w1', 'ddp1'), wait_ranks(*started,
                                                      timeout=150)))
    out['runs'] = {key: read_runs(work / key)
                   for key in ('w1', 'w2', 'ddp1')}
    return out


@pytest.mark.parametrize('case', NAMES)
def test_world2_equals_world1_at_the_global_batch(runs, case):
    assert_world2_equals_world1(runs['runs']['w1'][case],
                                runs['runs']['w2'][case], runs['w2'][case])


def test_one_rank_under_the_launcher_equals_no_launcher(runs):
    one, ddp = runs['w1']['lq'][0], runs['ddp1']['lq'][0]
    assert ddp['ddp'] == 'DistributedDataParallel'
    assert one['ddp'] == 'FeMaSRNet'
    (log1, nets1), (log_ddp, nets_ddp) = (runs['runs']['w1']['lq'],
                                          runs['runs']['ddp1']['lq'])
    for net in ('net_g', 'net_d'):
        for k in nets1[net]:
            assert torch.equal(nets1[net][k], nets_ddp[net][k]), k
    timing = ('time', 'data_time')
    for a, b in zip(log1, log_ddp):
        assert ({k: v for k, v in a.items() if k not in timing}
                == {k: v for k, v in b.items() if k not in timing})
    assert ddp['no_grad'] == []     # every trainable parameter got one
