"""Data-parallel serving of the port on the CPU: `SRInferencer(mesh=...)`
at world 2 (gloo ranks, `parallel.mesh.create_mesh`) against one process
without a mesh, and against the JAX package's mesh-sharded SRInferencer
at `create_mesh(data=2)` on two of conftest's eight CPU devices, on the
same seeded SMALL-codebook weights and a batch of three images (padded to
four: the padding path).

Held: run_padded, run_tiled (one tile per rank by default) and
run_bucketed equal world 1 within 2e-5 (the bound of the JAX package's
dp serving check, __graft_entry__.py:194) on both ranks, and the JAX mesh
within 2e-3 of the largest value (the whole-model bound, PARITY.md §A);
`inference_cli --dp 2 --launcher pytorch` writes world 1's images (rank 0
writes them); --dp other than the world size, and --dp > 1 or --tp > 1
without a launcher, are refused with their reasons. Each rank runs in a
subprocess on one thread (tests/torch_dist_worker.py).
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femasr_torch import inference_cli
from femasr_torch.models import FeMaSRNet, init_weights
from femasr_tpu.models.convert import convert_femasr_checkpoint
from femasr_tpu.models.inference import SRInferencer as JSRInferencer
from femasr_tpu.parallel.mesh import create_mesh as jcreate_mesh
from torch_port_util import start_ranks, wait_ranks

SMALL = [[32, 16, 32]]
ATOL = 2e-5
JAX_RTOL = 2e-3


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp('dist_serve')
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

    w2 = [serve, cli('cli_w2', '--dp', '2', '--launcher', 'pytorch'),
          cli('cli_dp3', '--dp', '3', '--launcher', 'pytorch')]
    w1 = [serve, cli('cli_w1')]
    started = (start_ranks(w2, str(root / 'out_w2'), 2),
               start_ranks(w1, str(root / 'out_w1'), 0))
    jax_out = _jax_mesh_outputs(sd, imgs)     # while the ranks run
    two, one = wait_ranks(*started, timeout=120)
    return {'root': root, 'jax': jax_out, 'two': two, 'one': one}


def _jax_mesh_outputs(sd, imgs):
    """The JAX SRInferencer on a ('data', 'model') = (2, 1) mesh."""
    params = convert_femasr_checkpoint(
        {k: v.numpy() for k, v in sd.items()},
        codebook_params=SMALL, LQ_stage=True, scale_factor=4)
    mesh = jcreate_mesh(data=2, devices=jax.devices()[:2])
    jsr = JSRInferencer(params, codebook_params=SMALL, scale_factor=4,
                        init_merge=False, mesh=mesh, max_tile_batch=2)
    x = jnp.asarray(imgs)
    return {'padded': np.asarray(jsr.run_padded(x)),
            'tiled': np.asarray(jsr.run_tiled(x, tile_size=16, tile_pad=4)),
            'bucketed': np.stack(jsr.run_bucketed(list(imgs), bucket=32,
                                                  max_batch=3))}


def _outputs(result):
    return {'padded': result['padded'].numpy(),
            'tiled': result['tiled'].numpy(),
            'bucketed': np.stack(result['bucketed'])}


def test_mesh_serving_equals_one_process(served):
    ref = _outputs(served['one']['serve'][0])
    for rank in (0, 1):
        got = served['two']['serve'][rank]
        assert got['tile_batch'] == 2     # one tile per rank
        for path, out in _outputs(got).items():
            assert out.shape == ref[path].shape, path
            np.testing.assert_allclose(out, ref[path], atol=ATOL, rtol=0,
                                       err_msg=path)


def test_mesh_serving_matches_the_jax_mesh(served):
    ref = served['jax']
    got = _outputs(served['two']['serve'][0])
    got['padded'] = got['padded'].transpose(0, 2, 3, 1)
    got['tiled'] = got['tiled'].transpose(0, 2, 3, 1)
    for path, out in got.items():
        assert out.shape == ref[path].shape, path
        assert np.abs(out - ref[path]).max() <= JAX_RTOL * np.abs(
            ref[path]).max(), path


def test_cli_dp_writes_the_single_process_images(served):
    root = served['root']
    names = sorted(os.listdir(root / 'cli_w1'))
    assert names == ['0.png', '1.png']
    assert sorted(os.listdir(root / 'cli_w2')) == names
    for name in names:
        a = cv2.imread(str(root / 'cli_w1' / name), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(root / 'cli_w2' / name), cv2.IMREAD_UNCHANGED)
        assert np.array_equal(a, b), name
    stats = served['two']['cli_w2']
    assert stats[0]['stats']['images'] == stats[1]['stats']['images'] == 2


def test_cli_refuses_what_data_parallel_serving_does_not_do(served):
    for rank in (0, 1):
        msg = served['two']['cli_dp3'][rank]['exit']
        assert '--dp 3, but the launcher started 2' in msg
    args = ['-i', 'x', '-w', 'x.pth', '--device', 'cpu']
    with pytest.raises(SystemExit, match='torchrun --nproc_per_node 2'):
        inference_cli.main(args + ['--dp', '2'])
    with pytest.raises(SystemExit, match='torchrun --nproc_per_node 2 .* '
                       '--dp 1 --tp 2'):
        inference_cli.main(args + ['--tp', '2'])
