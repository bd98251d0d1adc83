"""The port's recognition backbones and their temporal modules against the
JAX package's (``vfs_tpu/models/backbones/{resnet_tsm,resnet3d,
resnet3d_variants,resnet_tin,alexnet}.py``, ``vfs_tpu/models/common/
non_local.py``), with the JAX weights carried by
``flax_recognizer_to_torch`` (``test_torch_recognition.jax_variables``'
seeded draw). The port runs NCHW / NCTHW, the JAX package channels-last:
inputs and outputs are moved between the two here.

Tolerances: fp32 forwards at rtol 1e-4 / atol 1e-5 (convolutions summed
in other orders); the pure data movements (temporal shift, tin_shift,
max pool) bit for bit; linear_sampler's value and gradients at 1e-6.
Sizes: depth 18 (or 50 at 8 base channels), 2-4 segments or 4-8 frames,
32x32 frames (AlexNet 127x127, its SiamFC exemplar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.models import build_backbone as jax_build_backbone
from vfs_tpu.models.backbones import resnet3d as jax_resnet3d
from vfs_tpu.models.backbones import resnet_tin as jax_tin
from vfs_tpu.models.backbones import resnet_tsm as jax_tsm
from vfs_tpu.models.common.non_local import NonLocal3d as JaxNonLocal3d
from vfs_tpu_torch.models import build_backbone
from vfs_tpu_torch.models.backbones import (linear_sampler, max_pool_3d,
                                            temporal_shift, tin_shift)
from vfs_tpu_torch.models.backbones.resnet_tin import TemporalInterlace
from vfs_tpu_torch.models.common import BatchNorm3d, flax_module_init
from vfs_tpu_torch.models.common.non_local import NonLocal3d

from test_torch_recognition import (close, frames, jax_apply, jax_variables,
                                    load_port)

torch.set_num_threads(1)

SLOW = dict(type='resnet3d', depth=18, lateral=True, conv1_kernel=(1, 7, 7),
            conv1_stride_t=1, pool1_stride_t=1, inflate=(0, 0, 1, 1))
FAST = dict(type='resnet3d', depth=18, lateral=False, base_channels=8,
            conv1_kernel=(5, 7, 7), conv1_stride_t=1, pool1_stride_t=1)
# name: (config, channels-last input shape)
BACKBONES = {
    'tsm_r18': (dict(type='ResNetTSM', depth=18, num_segments=2),
                (4, 32, 32, 3)),
    'tsm_r50_non_local': (dict(
        type='ResNetTSM', depth=50, num_segments=2, out_indices=(2, 3),
        non_local=((0, 0, 0), (0, 1, 0, 1), 0, 0),
        non_local_cfg=dict(norm_cfg=dict(type='BN3d'), zeros_init=False)),
        (4, 32, 32, 3)),
    'tsm_no_shift': (dict(type='ResNetTSM', depth=18, num_segments=2,
                          is_shift=False), (4, 32, 32, 3)),
    'tin_r18': (dict(type='ResNetTIN', depth=18, num_segments=4),
                (4, 32, 32, 3)),
    'tin_r50': (dict(type='ResNetTIN', depth=50, num_segments=2),
                (2, 32, 32, 3)),
    'i3d_r18_non_local': (dict(
        type='ResNet3d', depth=18, base_channels=16, out_indices=(1, 3),
        non_local=(0, (1, 0), 0, 0),
        non_local_cfg=dict(sub_sample=True, zeros_init=False)),
        (2, 8, 32, 32, 3)),
    'i3d_r50': (dict(type='ResNet3d', depth=50, base_channels=8,
                     conv1_kernel=(5, 7, 7), pool1_stride_t=2,
                     inflate=((1, 1, 1), (1, 0, 1, 0), (1, 0, 1, 0, 1, 0),
                              (0, 1, 0))), (1, 8, 32, 32, 3)),
    'r3d_r50_3x3x3': (dict(type='ResNet3d', depth=50, base_channels=8,
                           conv1_kernel=(3, 7, 7), conv1_stride_t=1,
                           pool1_stride_t=1, inflate_style='3x3x3',
                           with_pool2=False, dilations=(1, 1, 2, 2)),
                      (1, 4, 32, 32, 3)),
    'slowonly_r18': (dict(type='ResNet3dSlowOnly', depth=18),
                     (1, 4, 32, 32, 3)),
    'slowfast_r18': (dict(type='ResNet3dSlowFast', resample_rate=4,
                          speed_ratio=4, slow_pathway=SLOW,
                          fast_pathway=FAST), (1, 8, 32, 32, 3)),
    'r2plus1d_r18': (dict(type='ResNet2Plus1d', depth=18),
                     (1, 8, 32, 32, 3)),
    'csn_ir': (dict(type='ResNet3dCSN', depth=18, base_channels=16),
               (1, 8, 32, 32, 3)),
    'csn_ip': (dict(type='ResNet3dCSN', depth=18, base_channels=16,
                    bottleneck_mode='ip', with_pool2=False),
               (1, 4, 32, 32, 3)),
    'alexnet_v1': (dict(type='AlexNetV1'), (2, 127, 127, 3)),
    'alexnet_v2': (dict(type='AlexNetV2'), (2, 127, 127, 3)),
    'alexnet_v3': (dict(type='AlexNetV3'), (1, 127, 127, 3)),
}


def to_port_layout(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


@pytest.mark.parametrize('name', list(BACKBONES))
def test_backbone_forward_matches_jax(name):
    """Eval-mode maps (every output of ``out_indices``; SlowFast's slow and
    fast) on the same weights."""
    cfg, shape = BACKBONES[name]
    jmodel = jax_build_backbone(dict(cfg))
    x = frames(*shape, seed=2)
    variables = jax_variables(jmodel, x, train=False)
    refs = jax_apply(jmodel, variables, jnp.asarray(x), train=False)
    model = load_port(build_backbone(dict(cfg)), variables).eval()
    with torch.no_grad():
        outs = model(to_port_layout(x))
    refs = refs if isinstance(refs, tuple) else (refs,)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        close(np.moveaxis(out.numpy(), 1, -1), ref, what=name)


def test_temporal_shift_matches_jax_by_value():
    """Channels [0, fold) from segment t+1, [fold, 2 fold) from t-1, zeros
    at the clip's edges; the fold on axis 1 here, on the last in JAX."""
    x = frames(6, 5, 5, 16, seed=3)  # 2 clips x 3 segments, NHWC
    ref = np.asarray(jax_tsm.temporal_shift(jnp.asarray(x), 3, 4))
    out = temporal_shift(to_port_layout(x), 3, 4)
    np.testing.assert_array_equal(np.moveaxis(out.numpy(), 1, -1), ref)
    clip = out.reshape(2, 3, 16, 5, 5)
    assert not clip[:, -1, :4].any() and not clip[:, 0, 4:8].any()
    assert torch.equal(clip[:, 0, :4], to_port_layout(x).reshape(
        2, 3, 16, 5, 5)[:, 1, :4])


def test_tin_shift_matches_jax():
    """Group g at time t reads t - offset[g], zeros outside [0, T),
    offsets past the clip included."""
    data = frames(2, 5, 8, 6, seed=4)
    offset = np.array([[0, 1, -2, 7], [3, -1, 2, -5]], np.int32)
    ref = jax_tin.tin_shift(jnp.asarray(data), jnp.asarray(offset))
    out = tin_shift(torch.from_numpy(data), torch.from_numpy(offset))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_linear_sampler_value_and_gradients_match_jax():
    """The value and the gradients with respect to the data and the
    offsets; ``floor`` passes none, so the offsets' gradient comes through
    the interpolation weights alone."""
    data = frames(2, 4, 8, 3, 3, seed=5)
    offset = np.array([[0.3, -1.6, 2.2, -0.4], [1.5, 0.0, -2.7, 0.9]],
                      np.float32)
    probe = frames(2, 4, 8, 3, 3, seed=6)

    def jax_loss(d, o):
        return jnp.sum(jax_tin.linear_sampler(d, o) * probe)

    ref = jax_tin.linear_sampler(jnp.asarray(data), jnp.asarray(offset))
    ref_gd, ref_go = jax.grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(data), jnp.asarray(offset))
    d = torch.from_numpy(data).requires_grad_()
    o = torch.from_numpy(offset).requires_grad_()
    out = linear_sampler(d, o)
    (out * torch.from_numpy(probe)).sum().backward()
    close(out, ref, 1e-6, 1e-6)
    close(d.grad, ref_gd, 1e-6, 1e-6)
    close(o.grad, ref_go, 1e-5, 1e-5)
    assert o.grad.abs().sum() > 0


def test_temporal_interlace_weight_layout_by_value():
    """32 channels / shift_div 2 = 16 folds in four groups of 4: group g
    takes weight g // 2 (the JAX module's repeat-then-tile), checked by
    value on the module alone; the offset net's fc2 bias starts at
    0.5108."""
    x = frames(6, 5, 5, 32, seed=7)  # 2 clips x 3 segments, NHWC
    jmodule = jax_tin.TemporalInterlace(32, 3, 2)
    variables = jax_variables(jmodule, x)
    ref = jax_apply(jmodule, {'params': variables['params']}, jnp.asarray(x))
    module = load_port(TemporalInterlace(32, 3, 2), variables)
    out = module(to_port_layout(x))
    close(np.moveaxis(out.detach().numpy(), 1, -1), ref, 1e-5, 1e-6)
    np.testing.assert_array_equal(out[:, 16:].detach().numpy(),
                                  to_port_layout(x)[:, 16:].numpy())
    with torch.no_grad():
        flax_module_init(module, torch.Generator().manual_seed(0))
    assert torch.allclose(module.offset_net.fc2.bias,
                          torch.full((2,), 0.5108))
    assert not module.weight_net.conv.bias.any()


@pytest.mark.parametrize('kernel,strides,padding', [
    ((1, 3, 3), (2, 2, 2), (0, 1, 1)), ((2, 1, 1), (2, 1, 1), (0, 0, 0)),
    ((3, 3, 3), (1, 2, 2), (1, 1, 1))], ids=['pool1', 'pool2', 'padded'])
def test_max_pool_3d_matches_jax(kernel, strides, padding):
    """Symmetric -inf padding: an all-negative input keeps its border."""
    x = -np.abs(frames(2, 5, 7, 9, 3, seed=8))
    ref = jax_resnet3d.max_pool_3d(jnp.asarray(x), kernel, strides, padding)
    out = max_pool_3d(torch.from_numpy(np.moveaxis(x, -1, 1)), kernel,
                      strides, padding)
    np.testing.assert_array_equal(np.moveaxis(out.numpy(), 1, -1),
                                  np.asarray(ref))


@pytest.mark.parametrize('mode,sub_sample,with_norm', [
    ('gaussian', False, False), ('embedded_gaussian', True, True),
    ('dot_product', False, True), ('concatenation', True, False)])
def test_non_local_modes_match_jax(mode, sub_sample, with_norm):
    x = frames(2, 3, 6, 4, 8, seed=9)  # NTHWC
    kwargs = dict(reduction=2, use_scale=True, mode=mode,
                  sub_sample=sub_sample, with_norm=with_norm,
                  zeros_init=False)
    jmodule = JaxNonLocal3d(8, **kwargs)
    variables = jax_variables(jmodule, jnp.asarray(x))
    ref = jax_apply(jmodule, variables, jnp.asarray(x))
    module = load_port(NonLocal3d(8, **kwargs), variables).eval()
    with torch.no_grad():
        out = module(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    close(np.moveaxis(out.numpy(), 1, -1), ref, 1e-5, 1e-6)


def test_flax_init_starts_residuals_and_non_local_at_identity():
    """``flax_module_init`` over a ``ResNet3d``: the last BatchNorm of each
    block starts at zero (``zero_init_residual``), a non-local block's
    norm scale too (``zeros_init``), the other BatchNorms at one; the
    kernels follow flax's lecun normal."""
    model = build_backbone(dict(type='ResNet3d', depth=18, base_channels=8,
                                non_local=(0, (1, 0), 0, 0),
                                non_local_cfg=dict(norm_cfg={})))
    with torch.no_grad():
        flax_module_init(model, torch.Generator().manual_seed(0))
    block = model.layer2[0]
    assert not block.conv2.bn.weight.any()
    assert bool((block.conv1.bn.weight == 1).all())
    assert not block.non_local_block.norm.weight.any()
    assert torch.all(block.non_local_block.g.weight.abs() < 0.06)
    w = model.layer4[0].conv1.conv.weight
    fan_in = w[0].numel()
    assert abs(w.std().item() * np.sqrt(fan_in) - 1) < 0.05


def test_frozen_stages_and_norm_eval_keep_running_statistics():
    model = build_backbone(dict(type='ResNet3d', depth=18, base_channels=8,
                                frozen_stages=1)).train()
    assert not model.conv1.bn.training
    assert not model.layer1[0].conv1.bn.training
    assert model.layer2[0].conv1.bn.training
    model = build_backbone(dict(type='ResNet3dSlowFast', slow_pathway=SLOW,
                                fast_pathway=FAST, norm_eval=True)).train()
    assert not any(m.training for m in model.modules()
                   if isinstance(m, BatchNorm3d))
    assert model.training
