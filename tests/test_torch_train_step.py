"""The port's SimSiam train step against the JAX package's, with the JAX
weights carried over by ``flax_simsiam_to_torch``.

Model: the r18 config's tracker (ResNet-18, ``out_indices=(3,)``,
``zero_init_residual``, ``intra_video``) with a narrow head (512 -> 32 ->
32 projection, 32 -> 16 -> 32 predictor). BatchNorm scales and shifts are
randomised so that every gradient is non-zero (the zero-init scales
would zero the residual branches' gradients at step 0). Input: B=2 samples
of two T=4 clips of 32x32 frames, smooth random images with a gain and
offset of their own, as real frames differ from sample to sample. (With
i.i.d. pixel noise every sample's deep features are nearly equal, and
BatchNorm's ``E[x^2] - E[x]^2`` over 8 values cancels to rounding noise in
both packages alike.)

Tolerances (fp32): the packages sum convolutions and reductions in other
orders (~6e-8 relative per operation), and BatchNorm over 8 samples, with
``E[x^2] - E[x]^2`` and its ``1 / sigma``, amplifies that to ~4e-5 in the
gradients. So: loss rtol 1e-5; each gradient, step-1 parameter update and
running statistic within 2e-4 of the JAX one in relative L2 norm, plus
1e-6 absolute, which covers the gradients that are zero in exact
arithmetic (a Linear bias before a BatchNorm), where both packages give
rounding noise of ~1e-8. Over two steps the step-1 differences (~5e-7 in
the weights) move the step-2 gradients by ~1%: the loss's sensitivity to
the weights at this size, not a difference of the algorithm (the port on
the JAX package's step-1 weights gives its step-2 loss bit for bit). So
the fp32 trajectory holds the loss at rtol 2e-5 and the parameters and
statistics after two steps at 3e-3 relative L2 (measured: 1e-3 at most,
in layer1); the same two steps in float64 (both packages, the JAX
backbone built with ``dtype=float64``) hold every update and statistic
at 1e-9.

The bf16 step (``fp16`` / ``bf16`` in the config) is held in two parts.
Its backbone is held stage by stage against the JAX package's bf16
ConvBN in ``test_torch_resnet_train.py``. Here the step's wiring is
held: the backbone's convolutions and BatchNorms take bf16, the head
takes fp32, and the head, loss and feature gradients of the step equal
the JAX package's fp32 head run on the features the bf16 backbone gave
(the fp32 tolerances above). A whole bf16 step cannot be held to the
JAX one at this size: rounding that falls the other way in either
package moves the step-0 gradients 42-70% in relative L2, as far as
bf16 moves them from fp32 (51-53%), and the loss (2.05 in both, 2.04
in fp32) cannot tell them apart.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.apis.train import TrainState as JaxTrainState
from vfs_tpu.apis.train import make_train_step as jax_make_train_step
from vfs_tpu.core.optimizer.builder import \
    build_optimizer as jax_build_optimizer
from vfs_tpu.models import build_model as jax_build_model
from vfs_tpu.models.trackers.sim_siam_tracker import \
    parse_losses as jax_parse_losses
from vfs_tpu_torch.apis.train import apply_mixed_precision, make_train_step
from vfs_tpu_torch.checkpoint import flax_simsiam_to_torch
from vfs_tpu_torch.core.optimizer import build_optimizer
from vfs_tpu_torch.models import build_model
from vfs_tpu_torch.models.trackers import parse_losses
from vfs_tpu_torch.utils import Config

torch.set_num_threads(1)

RTOL = 2e-4
ATOL = 1e-6
MODEL_CFG = dict(
    type='SimSiamBaseTracker',
    backbone=dict(type='ResNet', depth=18, pretrained=None,
                  out_indices=(3,), norm_eval=False,
                  zero_init_residual=True),
    img_head=dict(
        type='SimSiamHead', in_channels=512, num_projection_fcs=3,
        projection_mid_channels=32, projection_out_channels=32,
        num_predictor_fcs=2, predictor_mid_channels=16,
        predictor_out_channels=32, with_norm=True,
        loss_feat=dict(type='CosineSimLoss', negative=False),
        spatial_type='avg'))
TRAIN_CFG = dict(intra_video=True)
# the r18 config's optimizer and schedule, over a run of 10 steps
OPT_CFG = dict(type='SGD', lr=0.05, momentum=0.9, weight_decay=0.0001)
LR_CFG = dict(policy='CosineAnnealing', min_lr=0, by_epoch=False)
TOTAL_ITERS, ITERS_PER_EPOCH = 10, 5
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])


def smooth_frames(rs, n, hw):
    """n float32 (hw, hw, 3) frames: cubic-upsampled 4x4 random images,
    each with a gain and an offset of its own, plus a little noise."""
    frames = []
    for _ in range(n):
        img = cv2.resize(rs.randn(4, 4, 3).astype(np.float32), (hw, hw),
                         interpolation=cv2.INTER_CUBIC)
        frames.append(img * rs.uniform(0.5, 2.0) + rs.uniform(-1, 1)
                      + 0.1 * rs.randn(hw, hw, 3))
    return np.stack(frames).astype(np.float32)


def train_batch(seed, b=2, t=4, hw=32):
    rs = np.random.RandomState(seed)
    return smooth_frames(rs, b * 2 * t, hw).reshape(b, 2, t, hw, hw, 3)


def randomize_bn_params(tree, rng):
    """BN scales ~ 1 + 0.1 N(0, 1), BN and Dense biases ~ 0.1 N(0, 1)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out[k] = randomize_bn_params(v, rng)
        elif k == 'scale':
            out[k] = (rng.randn(*v.shape) * .1 + 1).astype(np.float32)
        elif k == 'bias':
            out[k] = (rng.randn(*v.shape) * .1).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def jax_variables(model, x, seed=0):
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                           train=True)
    params = randomize_bn_params(variables['params'],
                                 np.random.RandomState(seed))
    return params, jax.tree.map(np.asarray, variables['batch_stats'])


def load_jax_weights(model, params, batch_stats):
    """Load JAX trees into a port model; every key but the BatchNorm
    counters must be there."""
    missing, unexpected = model.load_state_dict(
        flax_simsiam_to_torch(params, batch_stats), strict=False)
    assert not unexpected, unexpected
    assert all(k.endswith('num_batches_tracked') for k in missing), missing
    return model


def port_model(params, batch_stats, cfg=MODEL_CFG, train_cfg=TRAIN_CFG):
    model = build_model(cfg, train_cfg=train_cfg)
    return load_jax_weights(model, params, batch_stats).train()


def assert_tree_close(port_sd, jax_sd, what, names=None):
    """Relative-L2 agreement of every (named) tensor."""
    for name in names or jax_sd:
        a = port_sd[name].detach().numpy().astype(np.float64)
        b = jax_sd[name].numpy().astype(np.float64)
        err = np.linalg.norm(a - b)
        assert err <= RTOL * np.linalg.norm(b) + ATOL, \
            f'{what} {name}: |diff| {err} vs |jax| {np.linalg.norm(b)}'


def to_torch_tree(params, stats):
    return flax_simsiam_to_torch(jax.tree.map(np.asarray, params),
                                 jax.tree.map(np.asarray, stats))


def to_torch_tree64(params, stats):
    """``to_torch_tree`` in float64: the bridge keeps fp32, so the trees go
    through it as two fp32 parts (value, remainder) summed again."""
    hi = jax.tree.map(lambda a: np.asarray(a, np.float32), (params, stats))
    lo = jax.tree.map(lambda a, h: np.asarray(a - h.astype(np.float64),
                                              np.float32), (params, stats),
                      hi)
    sd_hi, sd_lo = to_torch_tree(*hi), to_torch_tree(*lo)
    return {k: sd_hi[k].double() + sd_lo[k].double() for k in sd_hi}


@pytest.fixture(scope='module')
def jax_run():
    """The JAX side, compiled once: step-0 loss, gradients and updated
    statistics, and two steps of ``make_train_step`` on float frames and
    on uint8 frames normalised in the step."""
    model = jax_build_model(MODEL_CFG, train_cfg=TRAIN_CFG)
    x0, x1 = train_batch(1), train_batch(2)
    params, stats = jax_variables(model, x0)

    def loss_fn(p, imgs):
        out, mut = model.apply({'params': p, 'batch_stats': stats}, imgs,
                               train=True, mutable=['batch_stats'])
        total, log_vars = jax_parse_losses(out)
        return total, (log_vars, mut['batch_stats'])

    (loss, (log_vars, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, jnp.asarray(x0))

    tx, _ = jax_build_optimizer(OPT_CFG, LR_CFG, TOTAL_ITERS,
                                ITERS_PER_EPOCH)
    state0 = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats, opt_state=tx.init(params))
    step = jax.jit(jax_make_train_step(model, tx))
    traj = []
    state = state0
    for x in (x0, x1):
        state, lv = step(state, jnp.asarray(x))
        traj.append((float(lv['loss']), state))
    # uint8 frames, normalised inside the step with the pipeline's numbers
    u8 = np.clip(train_batch(3) * 40 + 128, 0, 255).astype(np.uint8)
    step_u8 = jax.jit(jax_make_train_step(model, tx, norm_cfg=NORM))
    state_u8, lv_u8 = step_u8(state0, jnp.asarray(u8))
    with jax.enable_x64(True):
        # the backbone's ConvBN computes in its dtype (fp32 by default)
        cfg64 = dict(MODEL_CFG, backbone=dict(MODEL_CFG['backbone'],
                                              dtype=jnp.float64))
        model64 = jax_build_model(cfg64, train_cfg=TRAIN_CFG)
        f64 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                           (params, stats))
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=f64[0],
                              batch_stats=f64[1],
                              opt_state=tx.init(f64[0]))
        step = jax.jit(jax_make_train_step(model64, tx))
        for x in (x0, x1):
            state, _ = step(state, jnp.asarray(x, jnp.float64))
        state_f64 = jax.tree.map(np.asarray, state)
    return dict(params=params, stats=stats, x=(x0, x1), loss=float(loss),
                log_vars={k: float(v) for k, v in log_vars.items()},
                grads=to_torch_tree(grads, stats),
                new_stats=to_torch_tree(params, new_stats), traj=traj,
                u8=u8, u8_result=(float(lv_u8['loss']), state_u8),
                f64=(f64, state_f64))


def test_step0_loss_and_every_gradient_match_jax(jax_run):
    model = port_model(jax_run['params'], jax_run['stats'])
    total, log_vars = parse_losses(model(torch.from_numpy(jax_run['x'][0])))
    total.backward()
    assert set(log_vars) == set(jax_run['log_vars'])
    for k, v in log_vars.items():
        np.testing.assert_allclose(float(v.detach()), jax_run['log_vars'][k],
                                   rtol=1e-5)
    np.testing.assert_allclose(float(total), jax_run['loss'], rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) <= set(jax_run['grads'])
    assert all(g is not None for g in grads.values())
    assert_tree_close(grads, jax_run['grads'], 'gradient', names=grads)


def test_step0_running_stats_match_jax(jax_run):
    """One train-mode forward updates each BatchNorm once per view, with
    flax's biased variance and momentum."""
    model = port_model(jax_run['params'], jax_run['stats'])
    with torch.no_grad():
        model(torch.from_numpy(jax_run['x'][0]))
    sd = model.state_dict()
    names = [k for k in jax_run['new_stats'] if 'running' in k]
    assert len(names) == 2 * (20 + 4)  # r18's 20 BNs + the head's 4
    assert_tree_close(sd, jax_run['new_stats'], 'running stat', names=names)
    assert int(sd['backbone.bn1.num_batches_tracked']) == 2


def _port_steps(jax_run, batches, norm_cfg=None, dtype=torch.float32):
    model = port_model(jax_run['params'], jax_run['stats']).to(dtype)
    optimizer, _ = build_optimizer(model.parameters(), OPT_CFG, LR_CFG,
                                   TOTAL_ITERS, ITERS_PER_EPOCH)
    step = make_train_step(model, optimizer, norm_cfg)
    losses = [float(step(x)['loss']) for x in batches]
    return model, losses


def _updates(model, jax_state, start_sd):
    """(port, JAX) parameter updates from the shared start."""
    jax_sd = to_torch_tree(jax_state.params, jax_state.batch_stats)
    sd = model.state_dict()
    params = [n for n, _ in model.named_parameters()]
    return ({n: sd[n] - start_sd[n] for n in params},
            {n: jax_sd[n] - start_sd[n] for n in params})


def test_step1_update_matches_jax(jax_run):
    """One step of the r18 optimizer (SGD, momentum 0.9, coupled decay
    1e-4, cosine schedule): the update and the running statistics."""
    model, (loss,) = _port_steps(jax_run, jax_run['x'][:1])
    jax_loss, jax_state = jax_run['traj'][0]
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-5)
    start = to_torch_tree(jax_run['params'], jax_run['stats'])
    delta, jax_delta = _updates(model, jax_state, start)
    assert_tree_close(delta, jax_delta, 'step-1 update', names=delta)
    jax_sd = to_torch_tree(jax_state.params, jax_state.batch_stats)
    stats = [k for k in jax_sd if 'running' in k]
    assert_tree_close(model.state_dict(), jax_sd, 'step-1 running stat',
                      names=stats)


def test_two_step_trajectory_matches_jax(jax_run):
    """Loss at each step, parameters and running statistics after two
    steps (fp32)."""
    model, losses = _port_steps(jax_run, jax_run['x'])
    for (jax_loss, _), loss in zip(jax_run['traj'], losses):
        np.testing.assert_allclose(loss, jax_loss, rtol=2e-5)
    jax_state = jax_run['traj'][-1][1]
    jax_sd = to_torch_tree(jax_state.params, jax_state.batch_stats)
    sd = model.state_dict()
    for name in jax_sd:
        a, b = sd[name].numpy(), jax_sd[name].numpy()
        assert np.linalg.norm(a - b) <= 3e-3 * np.linalg.norm(b) + 1e-7, \
            name


def test_two_step_trajectory_matches_jax_in_float64(jax_run):
    """The same two steps in float64: the updates agree to 1e-9, so the
    algorithm (BatchNorm statistics and update, loss, gradient, optax
    chain, schedule) is the JAX package's."""
    (params, stats), jax_state = jax_run['f64']
    model = load_jax_weights(build_model(MODEL_CFG, train_cfg=TRAIN_CFG),
                             params, stats).double().train()
    optimizer, _ = build_optimizer(model.parameters(), OPT_CFG, LR_CFG,
                                   TOTAL_ITERS, ITERS_PER_EPOCH)
    step = make_train_step(model, optimizer)
    for x in jax_run['x']:
        step(x.astype(np.float64))
    start = to_torch_tree64(params, stats)
    jax_sd = to_torch_tree64(jax_state.params, jax_state.batch_stats)
    sd = model.state_dict()
    for name in jax_sd:
        a, b = sd[name] - start[name], jax_sd[name] - start[name]
        if name.endswith('num_batches_tracked'):
            continue
        err = float(torch.linalg.norm(a - b))
        assert err <= 1e-9 * float(torch.linalg.norm(b)) + 1e-12, \
            (name, err)


def test_uint8_frames_normalised_in_the_step_match_jax(jax_run):
    model, (loss,) = _port_steps(jax_run, [jax_run['u8']], norm_cfg=NORM)
    jax_loss, jax_state = jax_run['u8_result']
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-5)
    start = to_torch_tree(jax_run['params'], jax_run['stats'])
    delta, jax_delta = _updates(model, jax_state, start)
    assert_tree_close(delta, jax_delta, 'uint8 step update', names=delta)
    with pytest.raises(ValueError, match='img_norm_cfg'):
        _port_steps(jax_run, [jax_run['u8']])


def test_bf16_step_casts_and_head_matches_jax_on_its_features(jax_run):
    """The bf16 step autocasts the backbone alone: its convolutions and
    BatchNorms take bf16, the head takes fp32, and the loss, the head's
    gradients and the features' gradients equal those of the JAX package's
    head on the features the bf16 backbone gave. Parameters, gradients and
    running statistics stay fp32."""
    cfg = Config.fromdict(dict(model=dict(MODEL_CFG), bf16=True))
    assert apply_mixed_precision(cfg)
    model = port_model(jax_run['params'], jax_run['stats'],
                       cfg=cfg.to_dict()['model'])
    seen, feats = {}, []

    def record(name):
        # the type a product computed in (its output's), the type a
        # BatchNorm was given
        def hook(module, args, out):
            seen.setdefault(name, set()).add(
                args[0].dtype if 'BatchNorm' in type(module).__name__
                else out.dtype)
        return hook

    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear,
                          torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
            m.register_forward_hook(record(name))

    def keep(module, args, out):
        out.retain_grad()
        feats.append(out)

    model.backbone.register_forward_hook(keep)
    optimizer, _ = build_optimizer(model.parameters(), OPT_CFG, LR_CFG,
                                   TOTAL_ITERS, ITERS_PER_EPOCH)
    x0 = jax_run['x'][0]
    loss = float(make_train_step(model, optimizer)(x0)['loss'])
    assert np.isfinite(loss)
    assert {n for n, d in seen.items() if d == {torch.bfloat16}} == {
        n for n in seen if n.startswith('backbone.')}
    assert {n for n, d in seen.items() if d == {torch.float32}} == {
        n for n in seen if n.startswith('img_head.')}
    assert all(f.dtype == torch.float32 for f in feats) and len(feats) == 2
    assert all(p.dtype == p.grad.dtype == torch.float32
               for p in model.parameters())
    assert all(v.dtype == torch.float32 for k, v in model.state_dict().items()
               if 'running' in k)

    model_j = jax_build_model(MODEL_CFG, train_cfg=TRAIN_CFG)
    stats = jax_run['stats']

    def head_loss(p, f1, f2):
        out, mut = model_j.apply({'params': p, 'batch_stats': stats}, f1, f2,
                                 x0.shape[2], method='forward_img_head',
                                 mutable=['batch_stats'])
        return jax_parse_losses(out)[0], mut['batch_stats']

    f1, f2 = (jnp.asarray(f.detach().numpy()) for f in feats)
    (jax_loss, new_stats), (gp, g1, g2) = jax.value_and_grad(
        head_loss, argnums=(0, 1, 2), has_aux=True)(jax_run['params'], f1,
                                                    f2)
    np.testing.assert_allclose(loss, float(jax_loss), rtol=1e-5)
    jax_grads = to_torch_tree(gp, stats)
    grads = {n: p.grad for n, p in model.named_parameters()
             if n.startswith('img_head.')}
    assert grads
    assert_tree_close(grads, jax_grads, 'bf16-step head gradient',
                      names=grads)
    assert_tree_close({'f1': feats[0].grad, 'f2': feats[1].grad},
                      {'f1': torch.from_numpy(np.array(g1)),
                       'f2': torch.from_numpy(np.array(g2))},
                      'bf16-step feature gradient')
    jax_sd = to_torch_tree(jax_run['params'], new_stats)
    assert_tree_close(model.state_dict(), jax_sd, 'bf16-step head statistic',
                      names=[k for k in jax_sd if k.startswith('img_head.')
                             and 'running' in k])
