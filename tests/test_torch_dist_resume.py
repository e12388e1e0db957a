"""A data-parallel training run of the port resumed on the CPU: two gloo
ranks (`train_cli --launcher pytorch`, batch_size_per_gpu 2, Adam) train
the LQ stage for 4 iterations, saving the state at 2 (an epoch boundary:
8 images, global batch 4); a second run resumes from it. Iterations 3-4
and the networks after them equal the uninterrupted run's within 1e-6, as
tests/test_torch_train_loop.py holds it at world 1, on both ranks; the
state holds each rank's RNG state (tests/torch_dist_cases.py,
tests/torch_dist_worker.py).
"""

import torch

from torch_dist_cases import LOSSES, assert_states_close, job, make_folder
from torch_dist_cases import options, read_runs
from torch_port_util import run_ranks

RTOL = 1e-6


def test_resume_at_world2_replays_the_uninterrupted_run(tmp_path):
    root = make_folder(tmp_path / 'data')
    work = tmp_path / 'w2'
    full = options(root, 'resume', 2, iters=4, optim='Adam', save_every=2)
    state = work / 'experiments' / 'resume' / 'training_states' / '2.state'
    ranks = run_ranks([
        job(work, 'full', full, '--launcher', 'pytorch'),
        job(work, 'again', full, '--launcher', 'pytorch', '--force_yml',
            f'path:resume_state={state}', 'name=resumed')],
        str(tmp_path / 'out'), 2, timeout=150)
    rngs = torch.load(str(state), weights_only=True)['state']['rng_by_rank']
    assert len(rngs) == 2 and not torch.equal(rngs[0]['cpu'],
                                              rngs[1]['cpu'])
    runs = read_runs(work)
    (log, nets), (again, nets_again) = runs['resume'], runs['resumed']
    assert [r['iter'] for r in log] == [1, 2, 3, 4]
    assert [r['iter'] for r in again] == [3, 4]
    for a, b in zip(log[2:], again):
        for k in LOSSES:
            assert abs(a[k] - b[k]) <= RTOL * abs(a[k]), (k, a, b)
    for net in ('net_g', 'net_d'):
        assert_states_close(nets[net], nets_again[net], RTOL)
        for rank in (0, 1):       # each rank's networks, to 1e-6 of a sum
            for k, (x, x2) in ranks['full'][rank][net].items():
                y, y2 = ranks['again'][rank][net][k]
                assert abs(x2 - y2) <= RTOL * abs(x2), (rank, k)
