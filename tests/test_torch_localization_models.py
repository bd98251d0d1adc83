"""The port's localizers, their losses and SSN's head against the JAX
package's (``vfs_tpu/models/{localizers,losses/bmn_loss,losses/ssn_loss,
heads/ssn_head}.py``), with the JAX parameters carried over by
``flax_localizer_to_torch``: BMN, TEM and PEM forwards, SSN's features,
head and loss (a ResNet-18 at 32x32), the label maps, the sampling mask,
every loss with the same uniform draws, the OHEM hinge loss and its
hand-written gradient on inputs with ties, ``STPPTrain`` / ``STPPTest``
and BMN's proposal decode.

The JAX variables are seeded draws of the init's shapes
(``test_torch_recognition.jax_variables``). Tolerances: fp32 against
fp32 rtol / atol 1e-5; the port in fp64 against the JAX package's fp32
(where the JAX module computes in fp32 only) within 1e-4; host numpy
exactly. Sizes: T=20, 8 features, 8 samples a bin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.models import build_model as jax_build_model
from vfs_tpu.models.heads import ssn_head as jax_ssn_head
from vfs_tpu.models.localizers.bmn import \
    get_interp1d_mask as jax_interp1d_mask
from vfs_tpu.models.losses import ssn_loss as jax_ssn_loss
from vfs_tpu_torch.checkpoint import flax_localizer_to_torch
from vfs_tpu_torch.models import build_model
from vfs_tpu_torch.models.heads import ssn_head
from vfs_tpu_torch.models.localizers import get_interp1d_mask
from vfs_tpu_torch.models.losses import ohem_hinge_loss

from test_data.test_ssn import TRAIN_CFG
from test_torch_recognition import jax_apply, jax_variables

torch.set_num_threads(1)

T, FEAT = 20, 8
BMN_CFG = dict(type='BMN', temporal_dim=T, boundary_ratio=0.5,
               num_samples=8, num_samples_per_bin=3, feat_dim=FEAT,
               soft_nms_alpha=0.4, soft_nms_low_threshold=0.5,
               soft_nms_high_threshold=0.9, post_process_top_k=100,
               hidden_dim_1d=16, hidden_dim_2d=8, hidden_dim_3d=24)
TEM_CFG = dict(type='TEM', temporal_dim=T, boundary_ratio=0.1,
               tem_feat_dim=FEAT, tem_hidden_dim=32,
               tem_match_threshold=0.5)
PEM_CFG = dict(type='PEM', pem_feat_dim=32, pem_hidden_dim=64,
               pem_u_ratio_m=1.0, pem_u_ratio_l=2.0,
               pem_high_temporal_iou_threshold=0.6,
               pem_low_temporal_iou_threshold=0.2, soft_nms_alpha=0.75,
               soft_nms_low_threshold=0.65, soft_nms_high_threshold=0.9,
               post_process_top_k=100)
SSN_CFG = dict(type='SSN',
               backbone=dict(type='ResNet', depth=18, out_indices=(3,)),
               cls_head=dict(type='SSNHead', dropout_ratio=0.0,
                             in_channels=512, num_classes=3,
                             consensus=dict(type='STPPTrain',
                                            stpp_cfg=(1, (1, 2), 1),
                                            num_seg=(2, 5, 2))))
RTOL = ATOL = 1e-5
F64_TOL = 1e-4


def close(port, ref, tol=RTOL, what=''):
    port = port.detach().numpy() if torch.is_tensor(port) else port
    np.testing.assert_allclose(port, np.asarray(ref), rtol=tol, atol=tol,
                               err_msg=what)


def carried(cfg, variables, dtype=torch.float32, **kwargs):
    """The port's model with the JAX variables, in eval mode."""
    model = build_model(dict(cfg), **kwargs)
    missing, unexpected = model.load_state_dict(flax_localizer_to_torch(
        variables['params'], variables['batch_stats']), strict=False)
    assert not unexpected, unexpected
    assert all(k.endswith('num_batches_tracked') for k in missing), missing
    return model.to(dtype).eval()


def features(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def gt_boxes(n, seed=1):
    rng = np.random.RandomState(seed)
    boxes = []
    for _ in range(n):
        s = np.sort(rng.rand(2, 2), axis=1) * [[0.5, 1.0]]
        boxes.append(s)
    return boxes


@pytest.mark.parametrize('args', [(T, 8, 3, 0.5), (12, 4, 2, 0.3),
                                  (7, 5, 1, 0.0)])
def test_interp1d_mask_bit_equal_to_jax(args):
    mask = get_interp1d_mask(*args)
    assert mask.shape == (args[0], args[1] * args[0] * args[0])
    np.testing.assert_array_equal(mask, jax_interp1d_mask(*args))
    assert get_interp1d_mask(*args) is mask  # built once a configuration
    assert not mask.flags.writeable


@pytest.mark.parametrize('name,cfg,shape', [
    ('BMN', BMN_CFG, (3, T, FEAT)), ('TEM', TEM_CFG, (3, T, FEAT)),
    ('PEM', PEM_CFG, (50, 32))])
def test_forward_matches_jax(name, cfg, shape):
    """fp32 against fp32, and the port in fp64 against it."""
    x = features(*shape)
    model = jax_build_model(cfg)
    variables = jax_variables(model, x, train=True)
    ref = jax_apply(model, variables, x, train=False)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for dtype, tol in ((torch.float32, RTOL), (torch.float64, F64_TOL)):
        port = carried(cfg, variables, dtype)
        with torch.no_grad():
            out = port(torch.from_numpy(x).to(dtype))
        out = out if isinstance(out, tuple) else (out,)
        assert len(out) == len(ref)
        for i, (a, b) in enumerate(zip(out, ref)):
            assert a.shape == b.shape
            close(a, b, tol, f'{name} output {i} {dtype}')


@pytest.mark.parametrize('name,cfg', [('BMN', BMN_CFG), ('TEM', TEM_CFG)])
def test_generate_labels_equal_jax(name, cfg):
    boxes = gt_boxes(3)
    ours = build_model(cfg).generate_labels(boxes)
    ref = jax_build_model(cfg).generate_labels(boxes)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def _bmn_case():
    x = features(2, T, FEAT)
    model = jax_build_model(BMN_CFG)
    variables = jax_variables(model, x, train=True)
    cm, start, end = jax_apply(model, variables, x, train=False)
    labels = model.generate_labels(gt_boxes(2))
    return model, variables, (cm, start, end), labels


def test_bmn_loss_with_the_same_draws_matches_jax():
    """``BMN.loss`` on the JAX forward's maps, the PEM regression sampling
    fed the uniform draws that ``jax.random`` makes from the JAX loss's
    key: every term equal within fp32 rounding, and the draws matter (a
    different pair changes the regression term)."""
    model, variables, maps, labels = _bmn_case()
    rng = jax.random.PRNGKey(3)
    ref = model.apply(variables, *maps, *labels, rng=rng, method=model.loss)
    rng_m, rng_l = jax.random.split(rng)
    draws = [np.asarray(jax.random.uniform(k, labels[0].shape))
             for k in (rng_m, rng_l)]
    port = build_model(BMN_CFG)
    args = [torch.from_numpy(np.array(a)) for a in (*maps, *labels)]
    ours = port.loss(*args, draws=draws)
    assert ours.keys() == ref.keys()
    for k in ref:
        close(ours[k], ref[k], what=k)
    other = port.loss(*args, generator=torch.Generator().manual_seed(9))
    assert float(other['pem_reg_loss']) != float(ours['pem_reg_loss'])


def test_pem_reg_loss_classes_an_iou_at_the_threshold_as_jax():
    """An IoU label just above 0.3 in fp64 rounds to 0.3 in fp32, where
    ``<= 0.3`` puts it in the low class, as in the JAX package's fp32
    loss (ROADMAP Queue 3); in fp64 the port keeps it medium. With
    medium draws all kept and low ones all dropped, the cell's weight
    shows the class."""
    from vfs_tpu.models.losses.bmn_loss import BMNLoss as JaxBMNLoss
    from vfs_tpu_torch.models.losses.bmn_loss import BMNLoss
    iou = np.array([[[0.8, np.nextafter(0.3, 1.0)], [0.1, 0.0]]])
    assert iou[0, 0, 1] > 0.3 and np.float32(iou[0, 0, 1]) == np.float32(0.3)
    pred = np.array([[[0.6, 0.9], [0.4, 0.2]]])
    mask = np.ones_like(iou)
    rng = jax.random.PRNGKey(7)
    ref = JaxBMNLoss.pem_reg_loss(jnp.asarray(pred, jnp.float32),
                                  jnp.asarray(iou, jnp.float32),
                                  jnp.asarray(mask, jnp.float32), rng)
    draws = [np.asarray(jax.random.uniform(k, iou.shape))
             for k in jax.random.split(rng)]
    f32 = [torch.tensor(a, dtype=torch.float32) for a in (pred, iou, mask)]
    close(BMNLoss.pem_reg_loss(*f32, draws=draws), ref)
    keep_m = [np.ones(iou.shape), np.zeros(iou.shape)]
    low = BMNLoss.pem_reg_loss(*f32, draws=keep_m)
    medium = BMNLoss.pem_reg_loss(*[torch.from_numpy(a) for a in
                                    (pred, iou, mask)], draws=keep_m)
    np.testing.assert_allclose(float(low), 0.5 * 0.2 ** 2, rtol=1e-6)
    np.testing.assert_allclose(
        float(medium), 0.5 * (0.2 ** 2 + (0.9 - iou[0, 0, 1]) ** 2) / 2,
        rtol=1e-12)


def test_tem_and_pem_losses_match_jax():
    x = features(3, T, FEAT)
    tem = jax_build_model(TEM_CFG)
    variables = jax_variables(tem, x, train=True)
    out = jax_apply(tem, variables, x, train=False)
    labels = tem.generate_labels(gt_boxes(3))
    ref = tem.apply(variables, out, *labels, method=tem.loss)
    ours = build_model(TEM_CFG).loss(
        torch.from_numpy(np.asarray(out)),
        *[torch.from_numpy(a) for a in labels])
    for k in ref:
        close(ours[k], ref[k], what=k)

    bsp = features(60, 32, seed=2)
    pem = jax_build_model(PEM_CFG)
    variables = jax_variables(pem, bsp, train=True)
    scores = jax_apply(pem, variables, bsp, train=False)
    iou = np.random.RandomState(4).rand(60).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    ref = pem.apply(variables, scores, iou, rng=rng, method=pem.loss)
    draws = [np.asarray(jax.random.uniform(k, iou.shape))
             for k in jax.random.split(rng)]
    ours = build_model(PEM_CFG).loss(torch.from_numpy(np.asarray(scores)),
                                     torch.from_numpy(iou), draws=draws)
    close(ours['temporal_iou_loss'], ref['temporal_iou_loss'])


def _ohem_inputs():
    """Rows of 3 classes in groups of 4: hinge losses with ties (rows at
    exactly 0 and repeated values) and labels 1..3."""
    pred = np.array([[0.5, 2.0, -1.0], [0.5, 0.1, 0.3], [1.5, 0.0, 0.2],
                     [0.5, 0.5, 0.5], [0.2, 0.2, 0.2], [1.2, 0.9, -0.3],
                     [0.2, 0.4, 0.6], [3.0, 3.0, 3.0]], np.float32)
    labels = np.array([1, 1, 1, 2, 3, 2, 1, 3], np.int32)
    return pred, labels


@pytest.mark.parametrize('is_positive,ratio', [(1, 1.0), (-1, 0.5),
                                               (1, 0.5), (-1, 0.25)])
def test_ohem_hinge_loss_and_gradient_match_jax(is_positive, ratio):
    pred, labels = _ohem_inputs()
    ref, ref_grad = jax.value_and_grad(
        lambda p: jax_ssn_loss.ohem_hinge_loss(
            p, jnp.asarray(labels), is_positive, ratio, 4))(
                jnp.asarray(pred))
    for dtype in (torch.float32, torch.float64):
        p = torch.tensor(pred, dtype=dtype, requires_grad=True)
        loss = ohem_hinge_loss(p, torch.from_numpy(labels).long(),
                               is_positive, ratio, 4)
        (loss * 3.0).backward()  # the backward scales by the incoming g
        close(loss, ref)
        close(p.grad, 3.0 * np.asarray(ref_grad))


def _ssn_inputs(n_videos=2, hw=32):
    rng = np.random.RandomState(8)
    per = TRAIN_CFG['ssn']['sampler']['num_per_video']
    imgs = rng.randn(n_videos, per * 9, hw, hw, 3).astype(np.float32)
    scale = rng.rand(n_videos, per, 2).astype(np.float32) + 0.5
    # the sampler's layout a video: 1 positive, 6 incomplete, 1 background
    ptype = np.tile(np.array([0, 1, 1, 1, 1, 1, 1, 2]), (n_videos, 1))
    labels = np.where(ptype == 2, 0, rng.randint(1, 4, size=ptype.shape))
    reg = rng.randn(n_videos, per, 2).astype(np.float32) * 0.3
    return imgs, scale, ptype, labels, reg


def test_ssn_features_head_and_loss_match_jax():
    """SSN in eval mode (running statistics): the pooled features, the
    head's three outputs and the loss terms; fp32 within 1e-5, the port
    in fp64 within 1e-4 of the JAX fp32."""
    inputs = _ssn_inputs()
    jax_inputs = [jnp.asarray(a) for a in inputs]
    model = jax_build_model(SSN_CFG, train_cfg=TRAIN_CFG)
    # the backbone's variables from the features-only path, the head's
    # from its own init: the loss's OHEM (a custom_vjp with Python-number
    # arguments) runs eagerly only, so the whole tree is not traced
    variables = jax_variables(model, jax_inputs[0], train=True,
                              return_loss=False)
    feats = jax_apply(model, variables, jax_inputs[0], train=False,
                      return_loss=False)
    head = jax_ssn_head.SSNHead(**{k: v for k, v in
                                   SSN_CFG['cls_head'].items()
                                   if k != 'type'})
    head_vars = jax_variables(head, feats, jax_inputs[1], train=False,
                              seed=1)
    variables['params'] = dict(variables['params'],
                               _cls_head=head_vars['params'])
    ref_head = head.apply(head_vars, feats, jax_inputs[1], train=False)
    ref_loss = model.apply(variables, *jax_inputs, train=False)
    for dtype, tol in ((torch.float32, RTOL), (torch.float64, F64_TOL)):
        port = carried(SSN_CFG, variables, dtype, train_cfg=TRAIN_CFG)
        t = [torch.from_numpy(a) for a in inputs]
        t[0], t[1], t[4] = (t[i].to(dtype) for i in (0, 1, 4))
        with torch.no_grad():
            ours = port(t[0], return_loss=False)
            close(ours, feats, tol, 'features')
            for a, b in zip(port.cls_head(ours, t[1]), ref_head):
                close(a, b, tol, 'head')
            losses = port(*t[:3], t[3].long(), t[4])
        assert losses.keys() == ref_loss.keys()
        for k in ref_loss:
            close(losses[k], ref_loss[k], tol, k)


@pytest.mark.parametrize('stpp', [(1, 1, 1), (1, (1, 2), 1), (2, 3, 1)])
def test_stpp_train_and_test_match_jax(stpp):
    rng = np.random.RandomState(10)
    x = rng.randn(4 * 9, 16).astype(np.float32)
    scale = rng.rand(4, 2).astype(np.float32)
    ours = ssn_head.STPPTrain(stpp, (2, 5, 2))(torch.from_numpy(x),
                                                torch.from_numpy(scale))
    ref = jax_ssn_head.STPPTrain(stpp, (2, 5, 2))(jnp.asarray(x),
                                                  jnp.asarray(scale))
    for a, b in zip(ours, ref):
        close(a, b)
    stpp_test = ssn_head.STPPTest(3, True, stpp)
    scores = rng.randn(30, stpp_test.feat_dim).astype(np.float32)
    ticks = np.array([[0, 3, 10, 14], [5, 6, 6, 9], [20, 24, 29, 30],
                      [-2, 0, 4, 6]], np.int32)
    factors = rng.rand(4, 2).astype(np.float32)
    for a, b in zip(stpp_test(scores, ticks, factors),
                    jax_ssn_head.STPPTest(3, True, stpp)(scores, ticks,
                                                         factors)):
        np.testing.assert_array_equal(a, b)


def test_test_fc_and_stpp_test_give_the_train_head_scores():
    """``SSNHead.test_fc`` (the reference's ``prepare_test_fc``) scores a
    frame for every STPP part; pooled by ``STPPTest`` over ticks that
    cover each stage's segments, they are the train head's scores on
    those segments where the two paths compute one linear function: one
    part a stage (STPP (1, 1, 1), no stage divides its parts) and unit
    scale factors (the test path shares the bias out over the parts
    before the scales apply)."""
    torch.manual_seed(0)
    head = build_model(dict(SSN_CFG['cls_head'], in_channels=16,
                            consensus=dict(type='STPPTrain',
                                           stpp_cfg=(1, 1, 1),
                                           num_seg=(2, 5, 2)))).double()
    for fc in head.fcs():
        torch.nn.init.normal_(fc.weight)
        torch.nn.init.normal_(fc.bias)
    segs = torch.randn(9, 16, dtype=torch.float64)  # one proposal
    scale = torch.ones(1, 2, dtype=torch.float64)
    act, com, reg = head.eval()(segs, scale)
    stpp = ssn_head.STPPTest(3, True, head.stpp_cfg)
    out = stpp(head.test_fc(segs).detach().numpy(),
               np.array([[0, 2, 7, 9]]), scale.numpy())
    close(out[0], act.detach().numpy(), 1e-12)
    close(out[1], com.detach().numpy(), 1e-12)
    close(out[2], reg.detach().numpy().reshape(1, -1), 1e-12)


def test_bmn_decode_proposals_equals_jax():
    """The decode reads the same maps (the JAX forward's) the same way:
    the proposals after soft NMS are equal."""
    model, _, maps, _ = _bmn_case()
    meta = [dict(video_name='v_x', duration_frame=3000,
                 duration_second=100.0)]
    ref = model.decode_proposals(*maps, meta)
    ours = build_model(BMN_CFG).decode_proposals(
        *[torch.from_numpy(np.asarray(m)) for m in maps], meta)
    assert ours == ref
    assert len(ours[0]['proposal_list']) > 1
