"""Eval over several devices and processes in vfs_tpu_torch against the
JAX package on the CPU (ROADMAP Queue 1 item 5):

- ``single_process_test(devices=['cpu', 'cpu'])``, two worker threads each
  with its own copy of the weights, against the one-device loop and the
  JAX package's two-device loop (as tests/test_data/test_davis_e2e.py:230
  holds the JAX one): masks equal, dataset order kept;
- ``python -m vfs_tpu_torch.tools.test --local-devices 2 --device cpu``:
  the masks and J&F of ``--local-devices 1``; ``--device cuda:1`` reaches
  the eval loop as that device;
- two processes in a gloo group, through ``tools.test --launcher pytorch``
  (torchrun's environment, set by hand) and ``multi_process_test``: every
  rank gathers all the predictions, equal to ``single_process_test``'s, as
  tests/test_core/test_multiprocess.py holds the JAX one;
- ``build_val_eval_fn(local_devices=...)`` on the train model's weights:
  the JAX package's J&F with its two local devices, within 1e-4, as
  tests/test_models/test_train_validate.py:70 does;
- the worker threads under stress: 8 workers over 64 videos of a stub
  tracker, thread switches every 10 us: every result once, in order.

Every comparison of masks is exact: the same arithmetic runs on the same
CPU whatever the worker.
"""

import os
import os.path as osp
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from vfs_tpu.apis import single_process_test as jax_single_process_test
from vfs_tpu.apis.train import build_val_eval_fn as jax_build_val_eval_fn
from vfs_tpu.models import build_model as jax_build_model
from vfs_tpu.utils import Config as JaxConfig
from vfs_tpu_torch.apis import single_process_test
from vfs_tpu_torch.apis.train import build_val_eval_fn
from vfs_tpu_torch.checkpoint import flax_simsiam_to_torch
from vfs_tpu_torch.datasets import build_dataset
from vfs_tpu_torch.models import build_model
from vfs_tpu_torch.tools import test as tools_test
from vfs_tpu_torch.utils import Config

from test_torch_tools_test import eval_setup  # noqa: F401
from test_torch_train_model import _cfg_dict, data  # noqa: F401
from test_torch_train_step import MODEL_CFG, TRAIN_CFG, jax_variables

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _port_eval(config, ckpt):
    cfg = Config.fromfile(config)
    dataset = build_dataset(cfg.data.test, dict(test_mode=True))
    model_cfg = dict(type='VanillaTracker', backbone=dict(cfg.model.backbone))
    model_cfg['backbone']['pretrained'] = ckpt
    model = build_model(model_cfg, test_cfg=cfg.test_cfg)
    model.init_weights()
    return model, dataset


def _load(npz):
    with np.load(npz) as saved:
        return [saved[k] for k in sorted(saved.files,
                                         key=lambda n: int(n[4:]))]


def test_single_process_test_over_two_devices(eval_setup):  # noqa: F811
    config, ckpt, _ = eval_setup
    model, dataset = _port_eval(config, ckpt)
    one = single_process_test(model, dataset, device='cpu')
    two = single_process_test(model, dataset, devices=['cpu', 'cpu'])
    assert model.distribute(['cpu', 'cpu']) == [model.backbone] * 2
    assert not hasattr(model, '_replicas')
    assert len(one) == len(two) == len(dataset) == 2
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a, b)
    # the JAX package's two-device loop on the same weights
    cfg = JaxConfig.fromfile(config)
    cfg.merge_from_dict({'test_cfg.backend': 'tiled'})
    from vfs_tpu.datasets import build_dataset as jax_build_dataset
    jax_dataset = jax_build_dataset(cfg.data.test, dict(test_mode=True))
    model_cfg = dict(type='VanillaTracker', backbone=dict(cfg.model.backbone))
    model_cfg['backbone']['pretrained'] = ckpt
    jax_model = jax_build_model(model_cfg, test_cfg=cfg.test_cfg)
    jax_model.init_weights()
    ref = jax_single_process_test(jax_model, jax_dataset, progress=False,
                                  devices=jax.local_devices()[:2])
    for a, b in zip(two, ref):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_tools_test_local_devices(eval_setup):  # noqa: F811
    config, ckpt, tmp = eval_setup
    runs = {}
    for n in ('1', '2'):
        out = str(tmp / f'local{n}.npz')
        runs[n] = (tools_test.main([config, ckpt, '--eval', 'davis',
                                    '--device', 'cpu', '--local-devices', n,
                                    '--out', out]), _load(out))
    assert runs['1'][0] == runs['2'][0]
    assert len(runs['2'][1]) == 2
    for a, b in zip(runs['1'][1], runs['2'][1]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit):
        tools_test.parse_args([config, ckpt, '--local-devices', '0'])


def test_tools_test_device_index(eval_setup, monkeypatch):  # noqa: F811
    """``--device cuda:1`` evaluates on cuda:1: with one local device the
    eval loop gets that device and no list, and N local devices start
    there (three CUDA devices faked; the loop stops before any runs)."""
    import vfs_tpu_torch.apis as apis
    config, ckpt, _ = eval_setup
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 3)
    cuda1 = torch.device('cuda', 1)
    assert tools_test.local_devices('1', cuda1) == ['cuda:1']
    assert tools_test.local_devices('2', cuda1) == ['cuda:1', 'cuda:2']
    assert tools_test.local_devices('all', cuda1) == [
        'cuda:0', 'cuda:1', 'cuda:2']
    with pytest.raises(ValueError, match='3 CUDA devices'):
        tools_test.local_devices('3', cuda1)
    seen = []

    class Stop(Exception):
        pass

    def loop(model, dataset, devices=None, device=None):
        seen.append((devices, device))
        raise Stop

    monkeypatch.setattr(apis, 'single_process_test', loop)
    for n, want in (('1', (None, cuda1)),
                    ('2', (['cuda:1', 'cuda:2'], None))):
        with pytest.raises(Stop):
            tools_test.main([config, ckpt, '--device', 'cuda:1',
                             '--local-devices', n])
        assert seen.pop() == want


CHILD = r'''
import os, sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
torch.set_num_threads(1)
from vfs_tpu_torch.apis import multi_process_test, single_process_test
from vfs_tpu_torch.datasets import build_dataset
from vfs_tpu_torch.models import build_model
from vfs_tpu_torch.parallel import get_rank, get_world_size
from vfs_tpu_torch.tools import test as tools_test
from vfs_tpu_torch.utils import Config

config, ckpt, out = sys.argv[1:4]
got = tools_test.main([config, ckpt, '--eval', 'davis', '--device', 'cpu',
                       '--launcher', 'pytorch', '--out', out])
assert get_world_size() == 2
assert (got is None) == (get_rank() != 0), got
cfg = Config.fromfile(config)
dataset = build_dataset(cfg.data.test, dict(test_mode=True))
model_cfg = dict(type='VanillaTracker', backbone=dict(cfg.model.backbone))
model_cfg['backbone']['pretrained'] = ckpt
model = build_model(model_cfg, test_cfg=cfg.test_cfg)
model.init_weights()
multi = multi_process_test(model, dataset, device='cpu')
single = single_process_test(model, dataset, device='cpu')
assert len(multi) == len(single) == len(dataset)
for a, b in zip(multi, single):
    np.testing.assert_array_equal(a, b)
print('rank', get_rank(), 'ok', None if got is None else got['J&F-Mean'])
'''


def _free_port():
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def test_multi_process_test_two_gloo_ranks(eval_setup):  # noqa: F811
    """Two processes under torchrun's environment: ``tools.test
    --launcher pytorch`` (rank 0 saves and returns the metrics), then
    ``multi_process_test`` in the same group against each rank's own
    ``single_process_test``."""
    config, ckpt, tmp = eval_setup
    out = str(tmp / 'two_ranks.npz')
    env = dict(os.environ, MASTER_ADDR='localhost',
               MASTER_PORT=str(_free_port()), WORLD_SIZE='2',
               PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, '-c', CHILD.format(root=ROOT), config, ckpt, out],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, stderr[-3000:]
    assert 'rank 0 ok' in outs[0][0] and 'rank 1 ok None' in outs[1][0]
    ref = tools_test.main([config, ckpt, '--eval', 'davis', '--device',
                           'cpu', '--out', str(tmp / 'one_rank.npz')])
    assert f"rank 0 ok {ref['J&F-Mean']}" in outs[0][0]
    for a, b in zip(_load(out), _load(str(tmp / 'one_rank.npz'))):
        np.testing.assert_array_equal(a, b)


def test_build_val_eval_fn_local_devices(data, tmp_path):  # noqa: F811
    """The train model's weights evaluated over two local devices: the
    JAX package's J&F over its two devices, the port's one-device J&F."""
    cfg_dict = _cfg_dict(data, tmp_path / 'work')
    jax_model = jax_build_model(MODEL_CFG, train_cfg=TRAIN_CFG)
    params, stats = jax_variables(
        jax_model, np.zeros((1, 2, 2, 32, 32, 3), np.float32))

    class JaxState:
        pass
    JaxState.params, JaxState.batch_stats = params, stats
    ref = jax_build_val_eval_fn(JaxConfig.fromdict(cfg_dict),
                                lambda: JaxState,
                                local_devices=jax.local_devices()[:2])()
    model = build_model(MODEL_CFG, train_cfg=TRAIN_CFG)
    model.load_state_dict(flax_simsiam_to_torch(params, stats),
                          strict=False)
    cfg = Config.fromdict(cfg_dict)
    two = build_val_eval_fn(cfg, lambda: model, device='cpu',
                            local_devices=['cpu', 'cpu'])()
    one = build_val_eval_fn(cfg, lambda: model, device='cpu')()
    assert two == one
    assert set(two) == set(ref)
    for k in ref:
        assert two[k] == pytest.approx(float(ref[k]), abs=1e-4), k


def test_multi_device_workers_under_stress():
    """More worker threads than cores, switching often: the results, which
    the workers write by index while a lock guards their count, hold each
    video once and keep dataset order."""

    class Stub:
        def distribute(self, devices):
            return list(devices)

        def preload(self, imgs, device=None):
            time.sleep(1e-4 * (int(imgs[0]) % 3))
            return int(imgs[0])

        def forward_test(self, imgs, ref_seg_map, img_meta, device=None,
                         backbone=None):
            assert device == backbone == 'cpu'
            return [imgs * 10 + ref_seg_map]

    dataset = [dict(imgs=np.array([i]), ref_seg_map=i % 7, img_meta={})
               for i in range(64)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t0 = time.time()
        out = single_process_test(Stub(), dataset, devices=['cpu'] * 8)
        assert time.time() - t0 < 60
    finally:
        sys.setswitchinterval(switch)
    assert out == [i * 10 + i % 7 for i in range(64)]
