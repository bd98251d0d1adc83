"""The port's checkpoint tools against the JAX package's, on the CPU:

- ``python -m vfs_tpu_torch.tools.publish_model``: the optimizer state is
  gone, the name's stamp is the sha256 of the file written, and the saved
  dict equals ``tools/publish_model.py``'s on the same input (a port train
  state ``epoch_{n}`` and a ``.pth``);
- ``python -m vfs_tpu_torch.tools.convert_to_pretrained --mode torch``: a
  fabricated reference-layout VFS training checkpoint gives the JAX
  package's ``vfs_train_ckpt_to_torchvision`` dict;
- ``--mode state``: a port train state made from JAX SimSiam weights with
  ``flax_simsiam_to_torch`` gives what the JAX tool's orbax mode,
  ``orbax_state_to_torchvision``, gives on those weights (called directly:
  no orbax file is needed).
Every comparison is exact."""

import os
import os.path as osp
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vfs_tpu.checkpoint import _load_state_dict as jax_load_state_dict
from vfs_tpu.checkpoint import \
    vfs_train_ckpt_to_torchvision as jax_vfs_to_torchvision
from vfs_tpu.models import build_model as jax_build_model
from vfs_tpu_torch.checkpoint import save_checkpoint
from vfs_tpu_torch.tools import convert_to_pretrained, publish_model

from test_parity_torch import _fabricated_tv_state_dict
from test_torch_train_step import (MODEL_CFG, TRAIN_CFG, jax_variables,
                                   port_model, train_batch)

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools import publish_model as jax_publish  # noqa: E402
from tools.convert_weights.convert_to_pretrained import \
    orbax_state_to_torchvision  # noqa: E402


def _assert_dicts_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if torch.is_tensor(a[k]) or isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)
        elif isinstance(a[k], dict):
            _assert_dicts_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope='module')
def jax_simsiam():
    """JAX SimSiam trees (the r18 tracker, a narrow head) with randomised
    BatchNorm scales, shifts and running statistics."""
    model = jax_build_model(MODEL_CFG, train_cfg=TRAIN_CFG)
    params, stats = jax_variables(model, train_batch(0), seed=4)
    rng = np.random.RandomState(4)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.rand(*v.shape) + 0.5 if 'var' in str(path[-1])
                         else rng.randn(*v.shape)).astype(np.float32), stats)
    return params, stats


@pytest.fixture(scope='module')
def epoch_state(jax_simsiam, tmp_path_factory):
    """A port train state ``epoch_3``: a model holding the JAX weights and
    an SGD optimizer state (momentum buffers from one step taken on a copy
    of the weights). Returns its path and the model's state dict."""
    params, stats = jax_simsiam
    model = port_model(params, stats)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    d = tmp_path_factory.mktemp('ckpt')
    return save_checkpoint(str(d), 3, dict(
        model=weights, optimizer=opt.state_dict(), step=7, epoch=3)), weights


@pytest.mark.parametrize('kind', ['epoch_state', 'pth'])
def test_publish_model_equals_jax_tool(epoch_state, tmp_path, kind):
    src, _ = epoch_state
    if kind == 'pth':
        src = str(tmp_path / 'ckpt.pth')
        torch.save({'state_dict': _fabricated_tv_state_dict(18),
                    'optimizer': {'lr': 0.1}, 'meta': {'epoch': 2}}, src)
    final = publish_model.main([src, str(tmp_path / 'release.pth')])
    m = re.fullmatch(r'release-([0-9a-f]{8})\.pth', osp.basename(final))
    assert m is not None and not osp.exists(tmp_path / 'release.pth')
    assert m.group(1) == publish_model.sha256_of(final)
    assert m.group(1) == jax_publish.sha256_of(final)
    ours = torch.load(final, weights_only=False)
    ref_path = jax_publish.process_torch(src, str(tmp_path / 'jax.pth'))
    ref = torch.load(ref_path, weights_only=False)
    assert 'optimizer' not in ours
    _assert_dicts_equal(ours, ref)
    if kind == 'epoch_state':
        assert ours['epoch'] == 3 and ours['step'] == 7


def test_publish_model_cli_and_directory(tmp_path):
    src = str(tmp_path / 'w.pth')
    torch.save({'w': torch.arange(3.0), 'optimizer': {}}, src)
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    r = subprocess.run([sys.executable, '-m',
                        'vfs_tpu_torch.tools.publish_model', src,
                        str(tmp_path / 'out.pth')], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = r.stdout.split('published: ')[1].strip()
    assert torch.load(out, weights_only=False).keys() == {'w'}
    with pytest.raises(ValueError, match='directory'):
        publish_model.main([str(tmp_path), str(tmp_path / 'x')])


def _to_vfs_layout(tv):
    """A torchvision ResNet state dict in the reference's VFS training
    layout (ConvModule names under ``backbone.``)."""
    out = {}
    for k, v in tv.items():
        if k.startswith('fc.'):
            out['cls_head.fc_cls.' + k[3:]] = v
            continue
        k = re.sub(r'^conv1\.', 'conv1.conv.', k)
        k = re.sub(r'^bn1\.', 'conv1.bn.', k)
        k = re.sub(r'\.conv(\d)\.', r'.conv\1.conv.', k)
        k = re.sub(r'\.bn(\d)\.', r'.conv\1.bn.', k)
        k = k.replace('.downsample.0.', '.downsample.conv.')
        k = k.replace('.downsample.1.', '.downsample.bn.')
        out['backbone.' + k] = v
    out['img_head.projection.0.weight'] = torch.zeros(2, 2)
    return out


def test_convert_torch_mode_equals_jax(tmp_path):
    tv = _fabricated_tv_state_dict(18, seed=2)
    src = str(tmp_path / 'vfs_train.pth')
    torch.save({'state_dict': _to_vfs_layout(tv), 'meta': {}}, src)
    dst = str(tmp_path / 'tv.pth')
    assert convert_to_pretrained.main([src, dst, '--mode', 'torch']) == dst
    ours = torch.load(dst, weights_only=True)
    ref = jax_vfs_to_torchvision(jax_load_state_dict(src))
    _assert_dicts_equal(ours, ref)
    _assert_dicts_equal(ours, {k: v for k, v in tv.items()
                               if not k.startswith('fc.')})


def test_convert_state_mode_equals_jax_orbax_mode(jax_simsiam, epoch_state,
                                                 tmp_path):
    params, stats = jax_simsiam
    src, weights = epoch_state
    dst = str(tmp_path / 'tv.pth')
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    r = subprocess.run([sys.executable, '-m',
                        'vfs_tpu_torch.tools.convert_to_pretrained', src, dst,
                        '--mode', 'state'], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    ours = torch.load(dst, weights_only=True)
    ref = orbax_state_to_torchvision(params['_backbone'], stats['_backbone'])
    _assert_dicts_equal(ours, ref)
    # the learning loop's in-memory conversion is the same function
    _assert_dicts_equal(convert_to_pretrained.state_to_torchvision(weights),
                        ours)
    with pytest.raises(ValueError, match='no backbone weights'):
        convert_to_pretrained.convert(src, dst, 'torch')
