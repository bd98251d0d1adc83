"""The port's ResNet in training mode against the JAX package's, with the
JAX weights carried over by ``flax_resnet_to_torch``: the forward and the
updated running statistics under ``norm_eval``, ``frozen_stages`` and
``partial_bn``; the zero-init residual scales; ``with_cp`` (equal
outputs and gradients, running statistics updated once); the bf16
backbone against the JAX package's ``dtype=bfloat16`` ConvBN.

Input: 8 smooth 32x32 frames (``test_torch_train_step.smooth_frames``).
Tolerances (fp32, convolutions summed in other orders, train-mode
BatchNorm over 8 frames): features and running statistics rtol 1e-4 /
atol 1e-4, as the eval-mode ResNet test holds the features.

bf16: a whole bf16 backbone cannot be held to the JAX one at this size.
One rounding that falls the other way (the two packages sum a conv's
products in other orders, so ~0.01% of outputs differ by one bf16 step)
is amplified by BatchNorm over 8 frames of 1x1 maps in layer4, and the
two bf16 outputs end 2-3% apart in relative L2 while each is 3-4% from
fp32 (measured at 32, 64 and 96 pixels). So each stage (the stem, each
residual block) runs on the same bf16 input, the JAX chain's, with the
same cotangent, and each reading is set beside the gap between the JAX
bf16 stage and the JAX fp32 stage on that input, which the test asserts
to be at least twice the tolerance. Measured, port vs JAX / gap to fp32: output at most 2.6e-4 / at
least 3.0e-3, held at 1e-3; running-statistic update 2.0e-5 / 4.0e-4,
held at 1e-4; input and parameter gradients at most 1.8e-3 / at least
3.0e-2, but 1.2e-2 / 7.4e-2 in layer2_1, where a ReLU or rounding that
falls the other way in the forward moves the backward, so held at a
quarter of the stage's own gap. A BatchNorm that normalises in bf16
instead of fp32 reads 5.9e-3 forward and about its gap backward, and
fails, as does one that takes its statistics in bf16. The port's
BatchNorm casts its input to fp32 twice, once for the statistics and
once for the normalisation, as flax does, so that a bf16 input's
gradient is the bf16 sum of two bf16-rounded parts; with one cast the
gradients read up to a sixth of the gap (2.9e-3 for a BatchNorm alone),
which this test lets pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.apis.train import apply_mixed_precision as jax_apply_mp
from vfs_tpu.models.backbones import ResNet as JaxResNet
from vfs_tpu.models.backbones.resnet import BasicBlock as JaxBasicBlock
from vfs_tpu.models.backbones.resnet import ConvBN as JaxConvBN
from vfs_tpu.models.backbones.resnet import max_pool_3x3_s2
from vfs_tpu.utils import Config as JaxConfig
from vfs_tpu_torch.apis.train import apply_mixed_precision
from vfs_tpu_torch.checkpoint import flax_resnet_to_torch
from vfs_tpu_torch.models.backbones import ResNet
from vfs_tpu_torch.models.common.norm import BatchNorm2d
from vfs_tpu_torch.utils import Config

from test_torch_train_step import (MODEL_CFG, randomize_bn_params,
                                   smooth_frames)

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def frames():
    return smooth_frames(np.random.RandomState(0), 8, 32)


@pytest.fixture(scope='module')
def weights(frames):
    v = JaxResNet(depth=18, out_indices=(3,)).init(
        jax.random.PRNGKey(0), jnp.asarray(frames), train=True)
    params = randomize_bn_params(v['params'], np.random.RandomState(0))
    return params, jax.tree.map(np.asarray, v['batch_stats'])


def _port(weights, **kw):
    model = ResNet(depth=18, **kw)
    missing, unexpected = model.load_state_dict(
        flax_resnet_to_torch(*weights), strict=False)
    assert not unexpected
    assert all(k.endswith('num_batches_tracked') for k in missing)
    return model.train()


# (ResNet arguments, BatchNorms that train): r18 has 20 (the stem's, 16 in
# the blocks, 3 in the downsamples); frozen_stages=2 freezes the stem and
# layers 1-2 (1 + 4 + 5); partial_bn trains the stem's alone, unless the
# stem is frozen
MODES = [(dict(out_indices=(3,)), 20),
         (dict(out_indices=(3,), norm_eval=True), 0),
         (dict(out_indices=(3,), frozen_stages=2), 10),
         (dict(out_indices=(3,), partial_bn=True), 1),
         (dict(out_indices=(1, 3), frozen_stages=0, partial_bn=True), 0)]


@pytest.mark.parametrize('kw,trained', MODES,
                         ids=['plain', 'norm_eval', 'frozen2', 'partial_bn',
                              'frozen0_partial'])
def test_train_forward_and_running_stats_match_jax(weights, frames, kw,
                                                   trained):
    params, stats = weights
    out, mut = JaxResNet(depth=18, **kw).apply(
        {'params': params, 'batch_stats': stats}, jnp.asarray(frames),
        train=True, mutable=['batch_stats'])
    model = _port(weights, **kw)
    with torch.no_grad():
        port_out = model(torch.from_numpy(frames))
    out = out if isinstance(out, tuple) else (out,)
    port_out = port_out if isinstance(port_out, tuple) else (port_out,)
    assert len(out) == len(port_out) == len(kw['out_indices'])
    for a, b in zip(port_out, out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    start = flax_resnet_to_torch(*weights)
    new = flax_resnet_to_torch(params,
                               jax.tree.map(np.asarray, mut['batch_stats']))
    sd = model.state_dict()
    moved = 0
    for k, v in new.items():
        if 'running' in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
            moved += not torch.equal(v, start[k])
    assert moved == 2 * trained


def test_zero_init_residual_matches_jax_init(frames):
    """The last BN of every block starts at scale 0 in both packages (the
    tracker's init follows flax's defaults)."""
    from vfs_tpu_torch.models import build_model
    v = JaxResNet(depth=18, out_indices=(3,), zero_init_residual=True).init(
        jax.random.PRNGKey(0), jnp.asarray(frames[:1]), train=True)
    jax_sd = flax_resnet_to_torch(v['params'], v['batch_stats'])
    tracker = build_model(MODEL_CFG)
    tracker.init_weights(torch.Generator().manual_seed(0))
    sd = tracker.backbone.state_dict()
    zero = {k for k, t in jax_sd.items()
            if k.endswith('weight') and t.dim() == 1 and not t.any()}
    assert zero == {k for k in jax_sd if k.endswith('weight')
                    and sd[k].dim() == 1 and not sd[k].any()}
    assert len(zero) == 8
    # flax's lecun-normal kernels: std sqrt(1 / fan_in), within 2 std
    w = sd['layer3.0.conv1.weight']
    assert abs(float(w.std()) * np.sqrt(128 * 9) - 1) < 0.05
    assert float(w.abs().max()) <= 2 * np.sqrt(1 / (128 * 9)) / .8796 + 1e-6


def test_with_cp_equal_outputs_gradients_and_once_updated_stats(weights,
                                                                frames):
    """Checkpointed blocks recompute their forward in the backward pass;
    the outputs, the gradients and the running statistics (updated once,
    as by the JAX package's remat) equal those without checkpointing."""
    runs = []
    for with_cp in (False, True):
        model = _port(weights, out_indices=(3,), with_cp=with_cp)
        x = torch.from_numpy(frames).requires_grad_()
        out = model(x)
        (out * torch.linspace(-1, 1, out.numel()).view_as(out)).sum() \
            .backward()
        runs.append((out.detach(), x.grad,
                     {n: p.grad for n, p in model.named_parameters()},
                     model.state_dict()))
    (out0, gx0, g0, sd0), (out1, gx1, g1, sd1) = runs
    assert torch.equal(out0, out1)
    assert torch.equal(gx0, gx1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    assert int(sd1['layer2.0.bn1.num_batches_tracked']) == 1
    # the recomputation did run: no checkpointing without grad or in eval
    assert not torch.equal(sd1['layer2.0.bn1.running_var'],
                           _port(weights).state_dict()[
                               'layer2.0.bn1.running_var'])


def test_bf16_backbone_autocasts_and_keeps_fp32_statistics(weights, frames):
    cfg = Config.fromdict(dict(model=dict(MODEL_CFG), fp16=dict()))
    assert apply_mixed_precision(cfg)
    assert cfg.model['backbone']['dtype'] == 'bfloat16'
    ref_cfg = JaxConfig.fromdict(dict(model=dict(MODEL_CFG), bf16=True))
    assert jax_apply_mp(ref_cfg)
    assert not apply_mixed_precision(Config.fromdict(dict(model={})))
    fp32 = _port(weights, out_indices=(3,))
    bf16 = _port(weights, out_indices=(3,), dtype='bfloat16')
    x = torch.from_numpy(frames)
    with torch.no_grad():
        a, b = fp32(x), bf16(x)
    assert b.dtype == torch.float32
    # bf16 stores 8 significant bits (steps of 2^-8 = 0.4%) after each of
    # the 18 convolutions: ~4% relative L2 at the output
    assert float((a - b).norm() / a.norm()) < 0.1
    assert not torch.equal(a, b)
    for m in bf16.modules():
        if isinstance(m, BatchNorm2d):
            assert m.running_var.dtype == torch.float32
            assert m.weight.dtype == torch.float32
    with pytest.raises(ValueError, match='bfloat16'):
        ResNet(depth=18, dtype='float16')


# the stages of r18 held one by one in bf16: the stem, then each block as
# (name, planes, stride, downsample)
BF16_STAGES = ['stem'] + [
    (f'layer{i + 1}_{j}', 64 * 2**i, 2 if i and not j else 1, i and not j)
    for i in range(4) for j in range(2)]


def _jax_stage(stage, weights, x, dtype):
    """One JAX stage in train mode: (output, updated batch_stats)."""
    params, stats = weights
    if stage == 'stem':
        out, mut = JaxConvBN(64, (7, 7), (2, 2), (3, 3), (1, 1), act=True,
                             dtype=dtype).apply(
            {'params': params['conv1'], 'batch_stats': stats['conv1']}, x,
            False, mutable=['batch_stats'])
        return max_pool_3x3_s2(out), mut['batch_stats']
    name, planes, stride, ds = stage
    out, mut = JaxBasicBlock(planes=planes, stride=stride,
                             with_downsample=bool(ds), dtype=dtype).apply(
        {'params': params[name], 'batch_stats': stats[name]}, x, False,
        mutable=['batch_stats'])
    return out, mut['batch_stats']


def _stage_key(stage):
    return 'conv1' if stage == 'stem' else stage[0]


@pytest.fixture(scope='module')
def bf16_inputs(weights, frames):
    """Each stage's input: the JAX bf16 chain's activations."""
    x, inputs = jnp.asarray(frames), {}
    for stage in BF16_STAGES:
        inputs[_stage_key(stage)] = x
        x, _ = _jax_stage(stage, weights, x, jnp.bfloat16)
    return inputs


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize('stage', BF16_STAGES,
                         ids=[_stage_key(s) for s in BF16_STAGES])
def test_bf16_stage_matches_jax_bf16_forward_and_backward(weights,
                                                          bf16_inputs,
                                                          stage):
    """The bf16 backbone's casts are the JAX package's: each stage on the
    JAX chain's bf16 input gives the JAX bf16 output, running-statistic
    update and gradients, well inside the gap to fp32; parameters,
    gradients and statistics stay fp32."""
    params, stats = weights
    key = _stage_key(stage)
    x = bf16_inputs[key]
    out, vjp, new_stats = jax.vjp(
        lambda p, xx: _jax_stage(stage, (dict(params, **{key: p}), stats),
                                 xx, jnp.bfloat16),
        params[key], x, has_aux=True)
    out32, vjp32, new_stats32 = jax.vjp(
        lambda p, xx: _jax_stage(stage, (dict(params, **{key: p}), stats),
                                 xx, jnp.float32),
        params[key], x.astype(jnp.float32), has_aux=True)
    ct = np.random.RandomState(len(key)).randn(*out.shape).astype(
        np.float32)
    gp, gx = vjp(jnp.asarray(ct).astype(jnp.bfloat16))
    gp32, gx32 = vjp32(jnp.asarray(ct))

    model = _port(weights, out_indices=(3,), dtype='bfloat16')
    if stage == 'stem':
        xt = torch.from_numpy(np.asarray(x))
        module, prefixes = model._stem, ('conv1.', 'bn1.')
    else:
        xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        layer, j = key[5:].split('_')
        module = getattr(model, f'layer{layer}')[int(j)]
        prefixes = (f'layer{layer}.{j}.',)
    with torch.autocast('cpu', dtype=torch.bfloat16):
        y = module(xt)
    assert y.dtype == torch.bfloat16 and out.dtype == jnp.bfloat16
    y.backward(torch.from_numpy(ct).permute(0, 3, 1, 2).to(y.dtype))
    nhwc = y.detach().float().permute(0, 2, 3, 1).numpy()

    def part(sd):
        return {k: v for k, v in sd.items() if k.startswith(prefixes)}

    def tree(p, s):
        return part(flax_resnet_to_torch(
            jax.tree.map(np.asarray, dict(params, **{key: p})),
            jax.tree.map(np.asarray, dict(stats, **{key: s}))))

    def cat(sd, names):
        return np.concatenate([sd[n].float().numpy().ravel()
                               for n in names])

    # forward
    f32 = np.asarray(out.astype(jnp.float32))
    assert _rel(nhwc, f32) < 1e-3 < _rel(f32, out32) / 2
    # running-statistic update
    start, sd = part(flax_resnet_to_torch(params, stats)), model.state_dict()
    jax_sd, jax_sd32 = tree(params[key], new_stats), tree(params[key],
                                                          new_stats32)
    running = [k for k in jax_sd if 'running' in k]
    assert all(sd[k].dtype == torch.float32 for k in running)
    upd = cat({k: sd[k] - start[k] for k in running}, running)
    jax_upd = cat({k: jax_sd[k] - start[k] for k in running}, running)
    jax_upd32 = cat({k: jax_sd32[k] - start[k] for k in running}, running)
    assert _rel(upd, jax_upd) < 1e-4 < _rel(jax_upd, jax_upd32) / 2
    # backward: parameter gradients (fp32 on fp32 weights), input gradient
    grads = {name: p.grad for name, p in model.named_parameters()
             if name.startswith(prefixes)}
    assert grads and all(g.dtype == torch.float32 for g in grads.values())
    names = sorted(grads)
    jax_g, jax_g32 = tree(gp, stats[key]), tree(gp32, stats[key])
    gap = _rel(cat(jax_g, names), cat(jax_g32, names))
    assert _rel(cat(grads, names), cat(jax_g, names)) < gap / 4
    assert gap > 2e-2
    if stage != 'stem':
        assert xt.grad.dtype == torch.bfloat16
        gxt = xt.grad.float().permute(0, 2, 3, 1).numpy()
        gap = _rel(gx.astype(jnp.float32), gx32)
        assert _rel(gxt, gx.astype(jnp.float32)) < gap / 4
        assert gap > 2e-2



def test_frozen_stages_two_steps_match_jax():
    """``frozen_stages=1`` trains as in the JAX package: the stem and
    ``layer1`` run their BatchNorm on the running statistics, which stay
    put, while their weights take gradients and updates. Two steps of the
    r18 optimizer from the same weights, in float64 in both packages:
    with the stem's BatchNorm on its initial statistics, the frozen
    stages do not normalise, and the train-mode BatchNorms after them
    amplify fp32 rounding until two fp32 runs part by 35% at step 2. So
    the stem and ``layer1`` updates and statistics are held at
    ``test_torch_train_step``'s float64 tolerance (1e-9 relative L2), and
    each weight must have moved, so a port that stops their gradients
    fails."""
    from vfs_tpu.apis.train import TrainState as JaxTrainState
    from vfs_tpu.apis.train import make_train_step as jax_make_train_step
    from vfs_tpu.core.optimizer.builder import \
        build_optimizer as jax_build_optimizer
    from vfs_tpu.models import build_model as jax_build_model
    from vfs_tpu_torch.apis.train import make_train_step
    from vfs_tpu_torch.core.optimizer import build_optimizer

    from test_torch_train_step import (ITERS_PER_EPOCH, LR_CFG, OPT_CFG,
                                       TOTAL_ITERS, TRAIN_CFG, jax_variables,
                                       port_model, to_torch_tree64,
                                       train_batch)
    cfg = dict(MODEL_CFG, backbone=dict(MODEL_CFG['backbone'],
                                        frozen_stages=1))
    batches = [train_batch(1).astype(np.float64),
               train_batch(2).astype(np.float64)]
    params, stats = jax_variables(jax_build_model(cfg, train_cfg=TRAIN_CFG),
                                  batches[0].astype(np.float32))
    tx, _ = jax_build_optimizer(OPT_CFG, LR_CFG, TOTAL_ITERS,
                                ITERS_PER_EPOCH)
    with jax.enable_x64(True):
        cfg64 = dict(cfg, backbone=dict(cfg['backbone'], dtype=jnp.float64))
        f64 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                           (params, stats))
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=f64[0],
                              batch_stats=f64[1], opt_state=tx.init(f64[0]))
        step = jax.jit(jax_make_train_step(
            jax_build_model(cfg64, train_cfg=TRAIN_CFG), tx))
        for x in batches:
            state, _ = step(state, jnp.asarray(x))
        state = jax.tree.map(np.asarray, state)
    jax_sd = to_torch_tree64(state.params, state.batch_stats)

    model = port_model(params, stats, cfg=cfg).double()
    optimizer, _ = build_optimizer(model.parameters(), OPT_CFG, LR_CFG,
                                   TOTAL_ITERS, ITERS_PER_EPOCH)
    port_step = make_train_step(model, optimizer)
    for x in batches:
        port_step(x)
    start = to_torch_tree64(*f64)
    sd = model.state_dict()
    frozen = [k for k in jax_sd if k.startswith(
        ('backbone.conv1.', 'backbone.bn1.', 'backbone.layer1.'))]
    assert len(frozen) == 5 * 5  # conv weight + 4 BN tensors, 5 pairs
    for k in frozen:
        upd, jax_upd = sd[k] - start[k], jax_sd[k] - start[k]
        if 'running' in k:  # frozen BatchNorm: statistics unchanged
            assert not upd.any() and not jax_upd.any(), k
            continue
        assert float(jax_upd.norm()) > 1e-3 * float(start[k].norm()), k
        assert float((upd - jax_upd).norm()) <= \
            1e-9 * float(jax_upd.norm()) + 1e-12, k
