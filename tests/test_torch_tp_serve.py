"""Tensor-parallel serving of the port on the CPU: `SRInferencer(mesh=...)`
on a ('data', 'model') = (1, 2) mesh of two gloo ranks against one
process without a mesh, and against the JAX package's SRInferencer on
`create_mesh(data=1, model=2)` with `tensor_parallel=True` (two of
conftest's eight CPU devices), on the same seeded SMALL-codebook weights.

Held:
- run_padded, run_tiled and run_bucketed at tp=2 (the whole state dict
  loaded strictly into the split model) equal one process within 2e-5
  (the bound of the JAX package's mesh serving check), on both ranks,
  and (whole image and buckets) the JAX TP mesh within 2e-3 of the
  largest value (the whole-model bound, PARITY.md §A);
- `inference_cli --dp 1 --tp 2 --launcher pytorch` writes one process's
  images (within one 8-bit level: the split sums round apart), rank 0
  alone; --dp x --tp other than the world size is refused with both;
- evaluation: `test_cli --launcher pytorch` with `model_parallel: 2`
  (`dist_validation` at dp=1 x tp=2) gives `nondist_validation`'s metrics
  within 1e-4 relative (a few 8-bit levels may differ) on three seeded
  pairs, and writes the same images within one level (model rank 0);
- the split codebook search: each shard's (distance, index) pairs reduced
  by B3's rule (first minimum, ties to the lower global index) equal the
  whole search bit for bit, on constructed cross-shard ties and on
  random codes, at 2 and 4 shards;
- the split parameters: at tp 2 and 4, release and SMALL geometry, the
  port splits the image under convert's mapping of the leaves that the
  JAX package's `param_shardings` shards (jax.eval_shape: no compile),
  plus the relative-position bias tables (split by head: each rank reads
  only its heads' columns, so a whole table would need its gradient
  all-reduced over the model ranks).

Each rank runs in a subprocess on one thread (tests/torch_dist_worker.py).
"""

import functools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from femasr_torch.kernels.vq_argmin import vq_argmin_plain
from femasr_torch.models import FeMaSRNet, init_weights
from femasr_torch.models.convert import femasr_param_mapping
from femasr_torch.parallel import ModelAxis
from femasr_torch.parallel.mesh import (TP_RULES, rule_layout,
                                        shard_state_dict, split_layout)
from femasr_torch.parallel.tensor_parallel import first_minimum, order_key
from femasr_tpu.models import FeMaSRNet as JFeMaSRNet
from femasr_tpu.models.convert import convert_femasr_checkpoint
from femasr_tpu.models.inference import SRInferencer as JSRInferencer
from femasr_tpu.parallel.mesh import create_mesh as jcreate_mesh
from femasr_tpu.parallel.mesh import param_shardings
from torch_port_util import start_ranks, wait_ranks

SMALL = [[32, 16, 32]]
RELEASE = [[32, 1024, 512]]
ATOL = 2e-5
JAX_RTOL = 2e-3
VAL_RTOL = 1e-4
# what the port splits beyond the JAX package's TP_RULES, and why: see the
# module doc
EXTRA = 'attn.relative_position_bias_table'


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp('tp_serve')
    net = FeMaSRNet(SMALL, LQ_stage=True, scale_factor=4)
    init_weights(net, torch.Generator().manual_seed(0))
    sd = net.state_dict()
    torch.save({'params': sd}, str(root / 'net.pth'))
    rng = np.random.default_rng(7)
    imgs = rng.random((3, 20, 24, 3), dtype=np.float32)
    np.save(str(root / 'imgs.npy'), imgs)
    os.makedirs(root / 'lq')
    for i, size in enumerate(((20, 24), (33, 29))):
        cv2.imwrite(str(root / 'lq' / f'{i}.png'),
                    (rng.random((*size, 3)) * 255).astype(np.uint8))
    serve = {'kind': 'serve', 'name': 'serve', 'weights': str(root /
             'net.pth'), 'images': str(root / 'imgs.npy'), 'codebook': SMALL}

    def cli(name, *argv):
        return {'kind': 'cli', 'name': name, 'argv': [
            '-i', str(root / 'lq'), '-w', str(root / 'net.pth'), '-o',
            str(root / name), '--precision', 'f32', '--device', 'cpu',
            *argv]}

    for sub in ('gt', 'pair_lq'):
        os.makedirs(root / sub)
    for i, (h, w) in enumerate(((20, 24), (24, 20), (17, 22))):
        gt = (rng.random((4 * h, 4 * w, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / 'gt' / f'{i}.png'), gt)
        cv2.imwrite(str(root / 'pair_lq' / f'{i}.png'),
                    cv2.resize(gt, (w, h), interpolation=cv2.INTER_AREA))

    def evaluation(sub, *argv):
        return {'kind': 'test', 'name': 'eval', 'cwd': str(root / sub),
                'opt': _eval_options(root, 2 if argv else 1),
                'argv': list(argv)}

    tp2 = [dict(serve, tp=2, strict=True),
           cli('cli_tp2', '--dp', '1', '--tp', '2', '--launcher', 'pytorch'),
           cli('cli_bad', '--dp', '2', '--tp', '2', '--launcher', 'pytorch'),
           evaluation('eval_tp2', '--launcher', 'pytorch')]
    w1 = [serve, cli('cli_w1'), evaluation('eval_w1')]
    started = (start_ranks(tp2, str(root / 'out_tp2'), 2),
               start_ranks(w1, str(root / 'out_w1'), 0))
    jax_out = _jax_tp_outputs(sd, imgs)     # while the ranks run
    for codebook in (RELEASE, SMALL):       # test_split_parameters_...'s
        _jax_shapes(_frozen(codebook))
    two, one = wait_ranks(*started, timeout=120)
    return {'root': root, 'jax': jax_out, 'two': two, 'one': one}


def _eval_options(root, model_parallel):
    return {
        'name': 'eval', 'model_type': 'FeMaSRModel', 'scale': 4,
        'manual_seed': 0, 'device': 'cpu',
        'model_parallel': model_parallel,
        'datasets': {'test_1': {
            'name': 'seeded', 'type': 'PairedImageDataset',
            'dataroot_gt': str(root / 'gt'),
            'dataroot_lq': str(root / 'pair_lq')}},
        'network_g': {'type': 'FeMaSRNet', 'codebook_params': SMALL,
                      'LQ_stage': True, 'scale_factor': 4},
        'path': {'pretrain_network_g': str(root / 'net.pth')},
        'val': {'save_img': True, 'metrics': {
            'psnr': {'type': 'psnr', 'crop_border': 4,
                     'test_y_channel': True},
            'ssim': {'type': 'ssim', 'crop_border': 4,
                     'test_y_channel': True}}}}


def _jax_tp_outputs(sd, imgs):
    """The JAX SRInferencer on a ('data', 'model') = (1, 2) mesh with its
    TP_RULES layout."""
    params = convert_femasr_checkpoint(
        {k: v.numpy() for k, v in sd.items()},
        codebook_params=SMALL, LQ_stage=True, scale_factor=4)
    mesh = jcreate_mesh(data=1, model=2, devices=jax.devices()[:2])
    jsr = JSRInferencer(params, codebook_params=SMALL, scale_factor=4,
                        init_merge=False, mesh=mesh, tensor_parallel=True)
    x = jnp.asarray(imgs)
    return {'padded': np.asarray(jsr.run_padded(x)),
            'bucketed': np.stack(jsr.run_bucketed(list(imgs), bucket=32,
                                                  max_batch=3))}


def _outputs(result):
    return {'padded': result['padded'].numpy(),
            'tiled': result['tiled'].numpy(),
            'bucketed': np.stack(result['bucketed'])}


def test_tp_serving_equals_one_process(served):
    ref = _outputs(served['one']['serve'][0])
    for rank in (0, 1):
        got = served['two']['serve'][rank]
        assert got['tile_batch'] == 1     # one data group
        for path, out in _outputs(got).items():
            assert out.shape == ref[path].shape, path
            np.testing.assert_allclose(out, ref[path], atol=ATOL, rtol=0,
                                       err_msg=path)


def test_tp_serving_matches_the_jax_tp_mesh(served):
    ref = served['jax']
    got = _outputs(served['two']['serve'][0])
    got['padded'] = got['padded'].transpose(0, 2, 3, 1)
    del got['tiled']        # held to one process (the JAX tiles: 8 s)
    for path, out in got.items():
        assert out.shape == ref[path].shape, path
        assert np.abs(out - ref[path]).max() <= JAX_RTOL * np.abs(
            ref[path]).max(), path


def test_cli_tp_writes_the_single_process_images(served):
    root = served['root']
    names = sorted(os.listdir(root / 'cli_w1'))
    assert names == ['0.png', '1.png']
    assert sorted(os.listdir(root / 'cli_tp2')) == names
    for name in names:
        a = cv2.imread(str(root / 'cli_w1' / name), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(root / 'cli_tp2' / name), cv2.IMREAD_UNCHANGED)
        assert a.shape == b.shape, name
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name
    stats = served['two']['cli_tp2']
    assert stats[0]['stats']['images'] == stats[1]['stats']['images'] == 2
    for rank in (0, 1):
        msg = served['two']['cli_bad'][rank]['exit']
        assert '--dp 2, but the launcher started 2' in msg
        assert '--dp x --tp = 2 x 2' in msg


def test_dist_validation_at_tp2_equals_nondist_validation(served):
    want = served['one']['eval'][0]['metrics']
    assert sorted(want) == ['psnr', 'ssim']
    for rank in (0, 1):
        got = served['two']['eval'][rank]['metrics']
        assert sorted(got) == sorted(want)
        for k in want:
            assert abs(got[k] - want[k]) <= VAL_RTOL * abs(want[k]), (
                k, got[k], want[k])
    vis = [served['root'] / sub / 'results' / 'eval' / 'visualization' /
           'seeded' for sub in ('eval_w1', 'eval_tp2')]
    names = sorted(os.listdir(vis[0]))
    assert names == ['0_eval.png', '1_eval.png', '2_eval.png']
    assert sorted(os.listdir(vis[1])) == names
    for name in names:
        a, b = (cv2.imread(str(v / name)).astype(int) for v in vis)
        assert np.abs(a - b).max() <= 1, name


def _split_search(z, cb, shards):
    """B3 on each shard of the codebook, reduced as the ranks reduce."""
    n = len(cb) // shards
    dists, idxs = [], []
    for s in range(shards):
        idx, dist = vq_argmin_plain(z, cb[s * n:(s + 1) * n], with_dist=True)
        dists.append(dist)
        idxs.append(idx.long() + s * n)
    return first_minimum(dists, idxs).to(torch.int32)


@pytest.mark.parametrize('shards', [2, 4])
def test_split_search_equals_the_whole_search(shards):
    # exact ties: every distance is a sum of multiples of 1/16 (exact in
    # f32), and code j + 8 repeats code j, so each tie spans shards
    g = torch.Generator().manual_seed(0)
    base = torch.randint(-4, 5, (8, 8), generator=g).float() / 4
    cb = torch.cat([base, base])
    z = torch.cat([base, torch.randint(-4, 5, (40, 8), generator=g).float()
                   / 4, torch.zeros(1, 8)])
    whole, dist = vq_argmin_plain(z, cb, with_dist=True)
    assert (whole < 8).all()          # the lower copy wins every tie
    got = _split_search(z, cb, shards)
    assert torch.equal(got, whole)
    assert torch.equal(dist, vq_argmin_plain(z, cb, with_dist=True)[1])
    # random codes: the same winners
    z = torch.randn(500, 32, generator=g)
    cb = torch.randn(64, 32, generator=g)
    assert torch.equal(_split_search(z, cb, shards), vq_argmin_plain(z, cb))


def test_order_keys_order_distance_then_index():
    d = torch.tensor([-2.0, -1.0, -0.0, 0.0, 0.0, 1e-30, 3.0, 3.0])
    i = torch.tensor([5, 0, 9, 2, 4, 1, 3, 7])
    keys = order_key(d, i)
    assert torch.equal(keys.argsort(), torch.tensor([0, 1, 3, 4, 2, 5, 6, 7]))
    assert torch.equal(keys & 0xFFFFFFFF, i)


@functools.lru_cache(maxsize=None)
def _jax_shapes(codebook):
    """The JAX FeMaSRNet's parameter shapes (jax.eval_shape: no compile)."""
    model = JFeMaSRNet(codebook_params=[list(p) for p in codebook],
                       LQ_stage=True, scale_factor=4, norm_type='gn',
                       act_type='silu')
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))['params']


def _frozen(codebook):
    return tuple(tuple(p) for p in codebook)


def _jax_split_keys(codebook, tp):
    """Torch keys of the leaves that the JAX package's param_shardings
    shards on a (1, tp) mesh."""
    shapes = _jax_shapes(_frozen(codebook))
    mesh = jcreate_mesh(data=1, model=tp, devices=jax.devices()[:tp])
    specs = flatten_dict(param_shardings(mesh, shapes))
    mapping = femasr_param_mapping(codebook, LQ_stage=True, scale_factor=4)
    return {mapping[path][0] for path, s in specs.items()
            if any(a is not None for a in s.spec)}


@pytest.mark.parametrize('codebook', [RELEASE, SMALL],
                         ids=['release', 'small'])
@pytest.mark.parametrize('tp', [2, 4])
def test_split_parameters_are_the_jax_tp_rules(codebook, tp):
    jax_keys = _jax_split_keys(codebook, tp)
    whole = FeMaSRNet(codebook, LQ_stage=True, scale_factor=4).state_dict()
    layout = split_layout(FeMaSRNet(codebook, LQ_stage=True, scale_factor=4,
                                    tp=ModelAxis(None, tp, 0)))
    assert layout == rule_layout(whole, tp)
    extra = {k for k in layout if k.endswith(EXTRA)}
    assert len(extra) == 24               # one table per Swin block
    assert set(layout) - extra == jax_keys
    assert len(TP_RULES) == 8
    # each rank's parts tile the whole tensor
    parts = [shard_state_dict(whole, r, tp, layout) for r in range(tp)]
    for k, (dim, _) in layout.items():
        assert sum(p[k].shape[dim] for p in parts) == whole[k].shape[dim]
