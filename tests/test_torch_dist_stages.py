"""Data-parallel training of the port on the CPU, the on-device
degradation and the HQ stage: two gloo ranks at batch_size_per_gpu 2
(`train_cli --launcher pytorch`) against one process at batch 4
(tests/torch_dist_cases.py, tests/torch_dist_worker.py).

Held, every parameter and spectral vector within 1e-5 of each tensor's
largest value (the ranks alike) and the logged losses within 1e-5:
- the LQ stage with the LQ synthesized on the device, two iterations:
  every rank degrades the whole global batch under the step's draws and
  keeps its block, so the ranks train on the LQ one process makes;
- one HQ-stage iteration from the prior, which moves the weights, and
  leaves no trainable parameter without a gradient under DDP.

The training path reaches the JAX package through world 1 (see
tests/test_torch_dist_train.py).
"""

import pytest
import torch

from torch_dist_cases import CASES, assert_world2_equals_world1, job
from torch_dist_cases import make_folder, read_runs
from torch_port_util import start_ranks, wait_ranks

NAMES = ('lq_degrade', 'hq')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = make_folder(tmp_path_factory.mktemp('dist_stages_data'))
    work = tmp_path_factory.mktemp('dist_stages')
    w2 = [job(work / 'w2', n, CASES[n](root, 2), '--launcher', 'pytorch')
          for n in NAMES]
    w1 = [job(work / 'w1', n, CASES[n](root, 4)) for n in NAMES]
    out = dict(zip(('w2', 'w1'), wait_ranks(
        start_ranks(w2, str(work / 'out_w2'), 2),
        start_ranks(w1, str(work / 'out_w1'), 0), timeout=150)))
    out['runs'] = {key: read_runs(work / key) for key in ('w1', 'w2')}
    out['prior'] = torch.load(str(root / 'hq.pth'))['params']
    return out


@pytest.mark.parametrize('case', NAMES)
def test_world2_equals_world1_at_the_global_batch(runs, case):
    assert_world2_equals_world1(runs['runs']['w1'][case],
                                runs['runs']['w2'][case], runs['w2'][case])


def test_hq_step_under_ddp_leaves_no_parameter_without_a_gradient(runs):
    assert runs['w2']['hq'][0]['no_grad'] == []
    trained = runs['runs']['w2']['hq'][1]['net_g']
    moved = max((trained[k] - v).abs().max().item()
                for k, v in runs['prior'].items())
    assert moved > 1e-3
