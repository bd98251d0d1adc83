"""vfs_tpu_torch ResNet against the JAX package's, with the JAX weights
carried over by ``flax_resnet_to_torch``.

Weights are flax-initialised with randomised BN statistics, scales and
shifts; input a 64x64 image. Features agree within rtol 1e-4 / atol 1e-4
(fp32; the frameworks sum the convolutions in different orders).
"""

import importlib.util
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu import checkpoint as jax_ckpt
from vfs_tpu.models.backbones import ResNet as JaxResNet
from vfs_tpu.models.backbones import ResNetBlockwise as JaxResNetBlockwise
from vfs_tpu_torch.checkpoint import (flax_resnet_to_torch,
                                      load_backbone_state,
                                      load_torchvision_resnet,
                                      vfs_train_ckpt_to_torchvision)
from vfs_tpu_torch.models.backbones import ResNet, ResNetBlockwise

torch.set_num_threads(1)


def _randomize_bn(tree, rng, stats=False):
    """BN leaves of a flax (params or batch_stats) tree, randomised like
    tests/test_models/test_resnet.py::_randomize_bn_stats."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            out[k] = _randomize_bn(v, rng, stats)
        elif k == 'mean':
            out[k] = (rng.randn(*v.shape) * .1).astype(np.float32)
        elif k == 'var':
            out[k] = (rng.rand(*v.shape) + .5).astype(np.float32)
        elif k == 'scale':
            out[k] = (rng.randn(*v.shape) * .1 + 1).astype(np.float32)
        elif k == 'bias':
            out[k] = (rng.randn(*v.shape) * .1).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def jax_resnet_variables(depth, strides, out_indices, seed=0, hw=(64, 64)):
    model = JaxResNet(depth=depth, strides=strides, out_indices=out_indices)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, *hw, 3)), train=False)
    rng = np.random.RandomState(seed)
    return model, {'params': _randomize_bn(variables['params'], rng),
                   'batch_stats': _randomize_bn(variables['batch_stats'],
                                                rng)}


def _port(cls, depth, strides, out_indices, state_dict):
    model = cls(depth=depth, strides=strides, out_indices=out_indices)
    load_backbone_state(model, state_dict)
    return model.eval()


def _assert_feats_close(jax_out, torch_out):
    jax_out = jax_out if isinstance(jax_out, tuple) else (jax_out,)
    torch_out = torch_out if isinstance(torch_out, tuple) else (torch_out,)
    assert len(jax_out) == len(torch_out)
    for a, b in zip(jax_out, torch_out):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize('depth,blockwise', [(18, False), (50, False),
                                             (18, True)])
def test_resnet_matches_jax(depth, blockwise):
    strides, out_indices = (1, 2, 1, 1), (2,)
    model, variables = jax_resnet_variables(depth, strides, out_indices)
    x = np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32)
    jax_cls = JaxResNetBlockwise if blockwise else JaxResNet
    ref = jax_cls(depth=depth, strides=strides,
                  out_indices=out_indices).apply(variables, jnp.asarray(x),
                                                 train=False)
    port = _port(ResNetBlockwise if blockwise else ResNet, depth, strides,
                 out_indices, flax_resnet_to_torch(variables['params'],
                                                   variables['batch_stats']))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    _assert_feats_close(ref, out)
    if not blockwise:
        assert out.shape == (1, 8, 8, model.stage_channels(2))


def _full_forward(model, x, blockwise):
    """Every stage run, layer4 included; the outputs at ``out_indices``."""
    x = model._stem(x)
    outs = []
    for i, name in enumerate(model.stage_names):
        for block in getattr(model, name):
            x = block(x)
            if blockwise and i in model.out_indices:
                outs.append(model._nhwc(x))
        if not blockwise and i in model.out_indices:
            outs.append(model._nhwc(x))
    return outs[0] if len(outs) == 1 else tuple(outs)


@pytest.mark.parametrize('blockwise', [False, True])
def test_resnet_skips_stages_past_last_output(blockwise):
    """With out_indices=(2,) layer4 feeds no output: it receives no call,
    and the features are bit-equal to those of a forward through every
    stage."""
    cls = ResNetBlockwise if blockwise else ResNet
    model = cls(depth=18, strides=(1, 2, 1, 1), out_indices=(2,),
                zero_init_residual=False)
    model.init_weights(torch.Generator().manual_seed(0))
    model.eval()
    calls = []
    for m in model.layer4.modules():
        m.register_forward_hook(lambda *args: calls.append(1))
    x = torch.randn(2, 48, 40, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = model(x)
        assert calls == []
        full = _full_forward(model, x, blockwise)
    assert calls  # the hooks do fire when layer4 runs
    out = out if isinstance(out, tuple) else (out,)
    full = full if isinstance(full, tuple) else (full,)
    assert len(out) == len(full)
    for a, b in zip(out, full):
        assert torch.equal(a, b)


def _torchvision_reference():
    path = osp.join(osp.dirname(__file__), 'test_models', 'test_resnet.py')
    spec = importlib.util.spec_from_file_location('_tv_resnet_reference',
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_load_torchvision_resnet_matches_bridge(tmp_path):
    """A fabricated torchvision-layout .pth loads straight into the port's
    ResNet, and gives the same model as the JAX loader + the bridge."""
    ref = _torchvision_reference()
    torch.manual_seed(0)
    tmodel = ref.TorchResNet(ref.TorchBasicBlock, (2, 2, 2, 2),
                             strides=(1, 2, 1, 1))
    ref._randomize_bn_stats(tmodel)
    tmodel.eval()
    path = str(tmp_path / 'r18.pth')
    torch.save(tmodel.state_dict(), path)

    direct = load_torchvision_resnet(path)
    params, stats = jax_ckpt.load_torchvision_resnet(path)
    bridged = flax_resnet_to_torch(params, stats)
    a = _port(ResNet, 18, (1, 2, 1, 1), (2,), direct)
    b = _port(ResNet, 18, (1, 2, 1, 1), (2,), bridged)
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = a(x)
        expect = tmodel(x.permute(0, 3, 1, 2), out_indices=(2,))[0]
    np.testing.assert_allclose(out.numpy(),
                               expect.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_vfs_train_ckpt_conversion_matches_jax():
    sd = {
        'backbone.conv1.conv.weight': np.zeros(1),
        'backbone.conv1.bn.weight': np.zeros(2),
        'backbone.conv1.bn.running_mean': np.zeros(3),
        'backbone.layer1.0.conv1.conv.weight': np.zeros(4),
        'backbone.layer1.0.conv1.bn.bias': np.zeros(5),
        'backbone.layer2.0.downsample.conv.weight': np.zeros(6),
        'backbone.layer2.0.downsample.bn.running_var': np.zeros(7),
        'img_head.projection_fcs.0.weight': np.zeros(8),
    }
    assert (set(vfs_train_ckpt_to_torchvision(sd))
            == set(jax_ckpt.vfs_train_ckpt_to_torchvision(sd)))


def test_resnet_init_and_modes():
    model = ResNet(depth=18, out_indices=(0, 1, 2, 3), frozen_stages=1,
                   norm_eval=True)
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        outs = model(torch.zeros(1, 64, 64, 3))
    assert [tuple(o.shape) for o in outs] == [(1, 16, 16, 64),
                                              (1, 8, 8, 128), (1, 4, 4, 256),
                                              (1, 2, 2, 512)]
    assert model.output_stride == 32 and model.feat_dim == 512
    assert ResNet(depth=18, strides=(1, 2, 1, 1)).output_stride == 8
    assert ResNet(depth=50).feat_dim == 2048
    model.train()
    # frozen stages: BatchNorm on running statistics, weights still
    # trainable (the JAX package's freeze)
    assert not model.bn1.training and not model.layer1[0].bn1.training
    assert model.conv1.weight.requires_grad
    assert model.layer1[0].conv1.weight.requires_grad
    assert model.layer2[0].conv1.weight.requires_grad
    assert not model.layer2[0].bn1.training  # norm_eval
    # zero-init residual: each block's last BN starts at scale 0
    assert float(model.layer3[1].bn2.weight.detach().abs().sum()) == 0.0
    with pytest.raises(ValueError):
        ResNet(depth=18, dtype='float16')
