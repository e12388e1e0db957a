"""bf16 training through `python -m femasr_torch.train_cli` on the CPU, port
only: after bf16 iterations the parameters, the Adam moments and the EMA
are float32, and the saved networks and training state hold float32
tensors (a bf16 checkpoint is the same .pth as an f32 one); a run resumed
at iteration 2 of 4 replays the uninterrupted run's iterations 3-4 within
1e-6; and a bf16 step with the on-device degradation in two
grad_accum_chunks degrades the batch as the whole-batch step does (bit
for bit: the degradation runs in f32 before the chunks) and gives its
losses within 1e-2."""

import json

import numpy as np
import torch

from femasr_torch import train_cli
from femasr_torch.data import build_dataset
from femasr_torch.train import FeMaSRModel
from femasr_torch.utils.options import parse_options
from test_torch_train_degrade import folder as degrade_folder  # noqa: F401
from test_torch_train_degrade import options as degrade_options
from test_torch_train_loop import folder, options  # noqa: F401 (fixture)

LOSSES = ('l_codebook', 'l_pix', 'l_g_gan', 'l_d_real', 'l_d_fake')


def bf16_run_options(root):
    opt = options(root, total_iter=4, ema_decay=0.9)
    opt['network_g'].update(dtype='bfloat16', vq_index_f32=True,
                            use_checkpoint=True)
    opt['network_d']['dtype'] = 'bfloat16'
    opt['name'] = 'lq_bf16'
    return opt


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _floats(tree):
    """The floating-point tensors of a nested dict / list."""
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _floats(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _floats(v)]
    return []


def test_bf16_run_keeps_f32_state_and_resumes(folder, tmp_path,  # noqa: F811
                                              monkeypatch):
    monkeypatch.chdir(tmp_path)
    opt_path = str(tmp_path / 'lq_bf16.json')
    with open(opt_path, 'w') as f:
        json.dump(bf16_run_options(folder), f)
    model = train_cli.main(['-opt', opt_path])
    assert model.dtype == torch.bfloat16
    assert model.net_d.dtype == torch.bfloat16
    exp = tmp_path / 'experiments' / 'lq_bf16'
    full = _log(exp / 'train_log.jsonl')
    assert [r['iter'] for r in full] == [1, 2, 3, 4]
    for key in LOSSES:
        assert np.isfinite([r[key] for r in full]).all(), key

    tensors = (list(model.net_g.parameters()) + list(model.net_d.parameters())
               + list(model.ema.values())
               + _floats(model.opt_g.state_dict()['state'])
               + _floats(model.opt_d.state_dict()['state']))
    assert len(tensors) > 1000
    assert {t.dtype for t in tensors} == {torch.float32}
    for name in ('net_g_2.pth', 'net_d_2.pth', 'net_g_latest.pth'):
        saved = torch.load(str(exp / 'models' / name))
        assert _floats(saved) and {t.dtype for t in _floats(saved)} == {
            torch.float32}, name
    state = torch.load(str(exp / 'training_states' / '2.state'),
                       weights_only=False)
    assert {t.dtype for t in _floats(state['state'])} == {torch.float32}

    resumed = train_cli.main(['-opt', opt_path, '--force_yml',
                              'path:resume_state=' + str(
                                  exp / 'training_states' / '2.state')])
    again = _log(exp / 'train_log.jsonl')[4:]
    assert [r['iter'] for r in again] == [3, 4]
    for a, b in zip(full[2:], again):
        for k in LOSSES:
            assert abs(a[k] - b[k]) <= 1e-6 * max(abs(a[k]), 1e-12), k
    for (name, p), q in zip(model.net_g.named_parameters(),
                            resumed.net_g.parameters()):
        assert (p - q).abs().max() <= 1e-6 * p.abs().max(), name


def test_bf16_on_device_degradation_in_chunks(degrade_folder):  # noqa: F811
    runs = {}
    for chunks in (1, 2):
        raw = degrade_options(degrade_folder)
        raw['network_g'].update(dtype='bfloat16', vq_index_f32=True)
        raw['network_d']['dtype'] = 'bfloat16'
        raw['train']['grad_accum_chunks'] = chunks
        opt, _ = parse_options('.', opt=raw, argv=[])
        data = build_dataset(opt['datasets']['train'])
        model = FeMaSRModel(opt)
        model.feed_data(torch.utils.data.default_collate(
            [data[(i, (5, 0, i))] for i in (0, 3)]))
        model.optimize_parameters(1)
        runs[chunks] = (model.lq, model.get_current_log())
    (lq1, log1), (lq2, log2) = runs[1], runs[2]
    assert lq1.dtype == torch.float32 and torch.equal(lq1, lq2)
    for k in LOSSES:
        assert np.isfinite(log2[k]), k
        assert abs(log1[k] - log2[k]) <= 1e-2 * max(abs(log1[k]), 1e-3), k
