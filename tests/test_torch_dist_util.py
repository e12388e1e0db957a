"""The port's data-parallel plumbing on the CPU: `parallel.dist_util`,
`parallel.mesh`, the options under a launcher and the sampler's split.

Two gloo ranks (subprocesses on one thread, tests/torch_dist_worker.py)
hold init_dist('pytorch'): ranks, master_only, barrier, broadcast, the
('data', 'model') mesh, local_slice and gather_batch; and parse_options
under --launcher pytorch: one manual_seed drawn on rank 0 when the file
has none, global streams seeded with manual_seed + rank, num_gpu resolved
to the world size and a different num_gpu refused. In this process:
Slurm's environment mapping, the refusals without a launcher (num_gpu >
1, dist, --dist_backend, a missing torchrun environment, a CUDA device
without a card) and of tensor parallelism (A11b), a DDP trainer whose
semantic head would get no gradient, and EpochSampler: the
ranks' batches concatenated in rank order are the world-1 batches of the
global size, across an epoch boundary and after a resume skip.
"""

import pytest
import torch

from femasr_torch.data import EpochSampler
from femasr_torch.parallel import create_mesh, get_dist_info, init_dist
from femasr_torch.parallel.dist_util import slurm_env
from femasr_torch.utils.options import OptionError, parse_options
from torch_port_util import run_ranks


def _opt(**kw):
    return dict({'name': 'opts', 'model_type': 'FeMaSRModel',
                 'device': 'cpu', 'path': {}, 'datasets': {}}, **kw)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    launcher = ['--launcher', 'pytorch']
    jobs = [{'kind': 'util', 'name': 'util'},
            {'kind': 'options', 'name': 'no_seed', 'opt': _opt(),
             'argv': launcher},
            {'kind': 'options', 'name': 'num_gpu_2',
             'opt': _opt(manual_seed=5, num_gpu=2), 'argv': launcher},
            {'kind': 'options', 'name': 'num_gpu_3',
             'opt': _opt(manual_seed=5, num_gpu=3), 'argv': launcher}]
    return run_ranks(jobs, str(tmp_path_factory.mktemp('dist_util')), 2,
                     timeout=90)


def test_init_dist_ranks_and_collectives(ranks):
    r0, r1 = ranks['util']
    assert (r0['rank'], r0['world'], r1['rank'], r1['world']) == (0, 2, 1, 2)
    assert r0['device'] == r1['device'] == 'cpu'
    assert (r0['master_only'], r1['master_only']) == ('ran', None)
    assert r0['seed'] == r1['seed'] == 100       # rank 0's value
    assert r0['mesh'] == r1['mesh'] == (2, 1, ('data', 'model'))
    whole = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    assert torch.equal(r0['block'], whole[:3])
    assert torch.equal(r1['block'], whole[3:])
    assert torch.equal(r0['gathered'], whole)
    assert torch.equal(r1['gathered'], whole)


def test_options_under_the_launcher(ranks):
    a, b = ranks['no_seed']
    assert a['manual_seed'] == b['manual_seed']          # drawn on rank 0
    assert a['draw'] != b['draw']               # streams: seed + rank
    for r, res in enumerate((a, b)):
        assert (res['dist'], res['rank'], res['world_size'],
                res['num_gpu']) == (True, r, 2, 2)
    assert [r['num_gpu'] for r in ranks['num_gpu_2']] == [2, 2]
    for res in ranks['num_gpu_3']:
        assert 'num_gpu: 3, but the launcher started 2' in res['error']


def test_slurm_environment_maps_to_torch_distributed():
    env = slurm_env({'SLURM_PROCID': '5', 'SLURM_NTASKS': '8',
                     'SLURM_LOCALID': '1',
                     'SLURM_NODELIST': 'gpu[03-04],gpu07'})
    assert env == {'RANK': '5', 'WORLD_SIZE': '8', 'LOCAL_RANK': '1',
                   'MASTER_ADDR': 'gpu03', 'MASTER_PORT': '29500'}
    env = slurm_env({'SLURM_PROCID': '0', 'SLURM_NTASKS': '2',
                     'SLURM_LOCALID': '0', 'SLURM_NODELIST': 'node1',
                     'MASTER_PORT': '1234'})
    assert (env['MASTER_ADDR'], env['MASTER_PORT']) == ('node1', '1234')


@pytest.mark.parametrize('opt,argv,match', [
    (_opt(num_gpu=2), [], 'torchrun --nproc_per_node 2 -m '
                          'femasr_torch.train_cli'),
    (_opt(dist=True), [], 'launcher'),
    (_opt(), ['--dist_backend', 'gloo'], 'needs a launcher'),
    (_opt(model_parallel=2), [], 'launcher: torchrun --nproc_per_node 2'),
], ids=['num_gpu', 'dist', 'backend', 'model_parallel'])
def test_options_without_a_launcher_refuse(opt, argv, match):
    with pytest.raises(OptionError, match=match):
        parse_options('.', opt=opt, argv=argv)


def test_an_unused_semantic_head_needs_find_unused_parameters(tmp_path):
    from femasr_torch.train import FeMaSRModel
    opt = _opt(manual_seed=0, dist=True, is_train=True, network_g={
        'type': 'FeMaSRNet', 'codebook_params': [[32, 16, 32]],
        'LQ_stage': False, 'use_semantic_loss': True},
        network_d={'type': 'UNetDiscriminatorSN', 'num_feat': 8},
        train={'optim_g': {'type': 'Adam', 'lr': 1e-4},
               'optim_d': {'type': 'Adam', 'lr': 1e-4},
               'gan_opt': {'type': 'GANLoss', 'gan_type': 'hinge',
                           'loss_weight': 0.1},
               'semantic_opt': {'loss_weight': 0.1}})
    with pytest.raises(ValueError, match='find_unused_parameters'):
        FeMaSRModel(opt)      # no VGG weights: the semantic loss is off


def test_one_process_defaults():
    opt, _ = parse_options('.', opt=_opt(manual_seed=3), argv=[])
    assert (opt['dist'], opt['rank'], opt['world_size'],
            opt['num_gpu']) == (False, 0, 1, 1)
    assert get_dist_info() == (0, 1)


def test_no_fallback(monkeypatch):
    with pytest.raises(RuntimeError, match='process group'):
        create_mesh(data=1, model=2)
    with pytest.raises(RuntimeError, match='process group'):
        create_mesh()
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
              'MASTER_PORT'):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match='torchrun'):
        init_dist('pytorch', device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            init_dist('pytorch', device='cuda')
    with pytest.raises(ValueError, match='launcher'):
        init_dist('mpi', device='cpu')


@pytest.mark.parametrize('world', [2, 3])
def test_sampler_ranks_concatenate_to_the_global_batch(world):
    batch, size, ratio = 2, 7, 3          # 21 positions an epoch
    gb = batch * world

    def batches(sampler, epoch, skip):
        sampler.start(epoch, skip)
        items = list(sampler)
        assert len(items) == len(sampler)
        return [items[i:i + sampler.batch]
                for i in range(0, len(items), sampler.batch)]

    one = EpochSampler(size, 9, ratio, 0, 1, gb)
    ranks = [EpochSampler(size, 9, ratio, r, world, batch)
             for r in range(world)]
    for epoch, skip in ((0, 0), (1, 0), (1, gb)):      # skip: a resume
        want = batches(one, epoch, skip)
        got = [batches(s, epoch, skip) for s in ranks]
        assert len(want) == (size * ratio - skip) // gb
        assert all(len(g) == len(want) for g in got)
        for step, items in enumerate(want):
            assert items == [x for g in got for x in g[step]]
    # a sample's seed is (seed, epoch, global position)
    assert [s for _, s in list(one)] == [
        (9, 1, pos) for pos in range(gb, size * ratio // gb * gb)]
