"""The port's SiamFC pieces (``projects/siamfc/siamfc_tpu_torch``) against
the JAX package's (``siamfc_tpu``), on the same seeded numpy inputs.

Tolerances: ``fast_xcorr`` and ``SiamConvFC`` with carried weights rtol /
atol 1e-5 (the convolutions sum in another order); every loss and its
gradient 1e-5; the host helpers, ``create_labels``, the device crops and
the response peaks exactly; one probe step's loss and head gradients 1e-5
in fp32 and 1e-9 in fp64, two optimizer steps 1e-9 in fp64; the pair
sampler's crops exactly. Shapes are small: the probe step runs at
``exemplar_sz`` 32 / ``instance_sz`` 64 (the default config's 120 / 255
stands only on the card).
"""

import os
import os.path as osp
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, osp.join(osp.dirname(__file__), '../projects/siamfc'))

import siamfc_tpu as J  # noqa: E402
import siamfc_tpu_torch as P  # noqa: E402
from siamfc_tpu import device_crops as jdc  # noqa: E402
from siamfc_tpu import losses as jlosses  # noqa: E402
from siamfc_tpu import ops as jops  # noqa: E402
from siamfc_tpu_torch import device_crops as pdc  # noqa: E402
from siamfc_tpu_torch import losses as plosses  # noqa: E402
from siamfc_tpu_torch import ops as pops  # noqa: E402

torch.set_num_threads(1)

BACKBONE = dict(type='ResNet', depth=18, frozen_stages=4,
                dilations=(1, 1, 2, 4), strides=(1, 2, 1, 1),
                out_indices=(3,), norm_eval=True)


def small_cfg(**kw):
    cfg = dict(J.default_cfg, exemplar_sz=32, instance_sz=64,
               model={'backbone': dict(BACKBONE)})
    cfg.update(kw)
    return cfg


def nhwc(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize('nz,nx', [(1, 1), (1, 3), (2, 6), (4, 4), (3, 9)])
def test_fast_xcorr_matches_jax(nz, nx):
    rng = np.random.RandomState(nz * 10 + nx)
    z, x = nhwc(rng, nz, 5, 6, 16), nhwc(rng, nx, 13, 12, 16)
    want = np.asarray(J.fast_xcorr(jnp.asarray(z), jnp.asarray(x), 0.001))
    got = P.fast_xcorr(torch.from_numpy(z), torch.from_numpy(x), 0.001)
    assert got.shape == want.shape == (nx, 9, 7, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def jax_head(rng, cin, cout, z, x):
    head = J.SiamConvFC(cin, cout, out_scale=0.001)
    params = head.init(jax.random.PRNGKey(int(rng.randint(1000))),
                       jnp.asarray(z), jnp.asarray(x))
    # non-zero biases, so the bias layout is checked too
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32), params)
    return head, params


@pytest.mark.parametrize('nz,nx', [(1, 3), (2, 6), (3, 3)])
def test_siam_conv_fc_with_carried_weights(nz, nx):
    rng = np.random.RandomState(7 + nz)
    z, x = nhwc(rng, nz, 4, 4, 24), nhwc(rng, nx, 10, 11, 24)
    head, params = jax_head(rng, 24, 16, z, x)
    want = np.asarray(head.apply(params, jnp.asarray(z), jnp.asarray(x)))
    port = P.SiamConvFC(24, 16, out_scale=0.001)
    port.load_state_dict(P.checkpoint.flax_head_to_torch(params['params'],
                                                         {}))
    got = port(torch.from_numpy(z), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_siamfc_head_and_conv_init():
    """The parameter-free head is ``fast_xcorr``; SiamConvFC's init draws
    flax ``nn.Conv``'s distribution: a normal of std sqrt(1/fan_in)
    truncated at two deviations (scaled to that std), zero bias."""
    rng = np.random.RandomState(0)
    z, x = nhwc(rng, 2, 3, 3, 8), nhwc(rng, 4, 7, 7, 8)
    np.testing.assert_array_equal(
        P.SiamFC(0.01)(torch.from_numpy(z), torch.from_numpy(x)).numpy(),
        P.fast_xcorr(torch.from_numpy(z), torch.from_numpy(x), 0.01))
    head = P.SiamConvFC(512, 512)
    head.init_weights(torch.Generator().manual_seed(0))
    w = head.z_conv0.weight.detach().numpy()
    fan_std = np.sqrt(1 / 512)
    assert abs(w.std() / fan_std - 1) < 0.01
    assert np.abs(w).max() <= 2 * fan_std / .87962566103423978
    assert not head.x_conv0.bias.detach().any()
    assert not np.array_equal(w, head.x_conv0.weight.detach().numpy())


def loss_inputs(seed, with_half=False):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(3, 9, 9) * 2).astype(np.float32)
    target = (rng.rand(3, 9, 9) > 0.8).astype(np.float32)
    if with_half:
        target[:, 0, :4] = 0.5
    return logits, target


LOSSES = [('balanced_loss', {}), ('balanced_loss', {'neg_weight': 2.0}),
          ('focal_loss', {}), ('focal_loss', {'gamma': 1.5}),
          ('ohnm_loss', {}), ('ohnm_loss', {'neg_ratio': 1.0}),
          ('ghmc_loss', {}), ('ghmc_loss', {'bins': 10})]


@pytest.mark.parametrize('name,kw', LOSSES)
@pytest.mark.parametrize('with_half', [False, True])
def test_losses_and_gradients_match_jax(name, kw, with_half):
    logits, target = loss_inputs(len(name) + len(kw), with_half)
    jfn = getattr(jlosses, name)
    want, want_g = jax.value_and_grad(
        lambda lg: jfn(lg, jnp.asarray(target), **kw))(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    got = getattr(plosses, name)(lg, torch.from_numpy(target), **kw)
    got.backward()
    assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-7)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('hw,r_pos,r_neg', [((17, 17), 16, 0),
                                             ((9, 11), 16, 32),
                                             ((8, 8), 8, 24)])
def test_create_labels_equal(hw, r_pos, r_neg):
    np.testing.assert_array_equal(
        plosses.create_labels(hw, r_pos, r_neg, 8),
        jlosses.create_labels(hw, r_pos, r_neg, 8))


def test_host_helpers_equal(tmp_path):
    """The copied numpy/cv2 helpers give the JAX package's values exactly:
    crops, boxes, regions, taps, resize matrices, OTB metrics, image
    reads."""
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (90, 130, 3), np.uint8)
    path = str(tmp_path / 'a.jpg')
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(pops.read_image(path),
                                  jops.read_image(path))
    avg = img.mean(axis=(0, 1))
    for center, size, out in (((40.3, 60.8), 77.2, 33), ((5., 120.), 150.,
                                                         64),
                              ((80., 2.), 20.6, 40)):
        for interp in (cv2.INTER_LINEAR, cv2.INTER_CUBIC):
            np.testing.assert_array_equal(
                pops.crop_and_resize(img, center, size, out,
                                     border_value=avg, interp=interp),
                jops.crop_and_resize(img, center, size, out,
                                     border_value=avg, interp=interp))
    np.testing.assert_array_equal(pops.xywh_to_xyxy([10, 20, 7, 9]),
                                  jops.xywh_to_xyxy([10, 20, 7, 9]))
    for s in (1, 63, 64, 65, 300):
        assert pdc.bucket_of(s) == jdc.bucket_of(s)
    for n, m in ((17, 272), (9, 272), (5, 13)):
        np.testing.assert_array_equal(pdc.cubic_resize_matrix(n, m),
                                      jdc.cubic_resize_matrix(n, m))
    for src, dst in ((200, 127), (64, 127), (300, 300), (17, 5)):
        for a, b in zip(pdc.cv2_linear_taps(src, dst),
                        jdc.cv2_linear_taps(src, dst)):
            np.testing.assert_array_equal(a, b)
    center = np.array([30.5, 100.2], np.float32)
    sizes = [60.2, 70.0, 81.9]
    pr, jr = (m.make_region(img, center, sizes, avg) for m in (pdc, jdc))
    for a, b in zip(pr, jr):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pdc.make_taps(pr[1], pr[2], 64),
                                  jdc.make_taps(jr[1], jr[2], 64))
    boxes = rng.rand(20, 4) * 50 + 1
    anno = boxes + rng.randn(20, 4) * 4
    for fn in ('rect_iou', 'center_error'):
        np.testing.assert_array_equal(getattr(P, fn)(boxes, anno),
                                      getattr(J, fn)(boxes, anno))
    for a, b in zip(P.eval_metrics(boxes, anno), J.eval_metrics(boxes,
                                                                anno)):
        np.testing.assert_array_equal(a, b)


def crop_case(sizes):
    """``test_siamfc.py``'s bit-exactness case: a 360x640 noise image, a
    centre, three scale sizes."""
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (360, 640, 3), np.uint8)
    center = np.array([181.3, 322.8], np.float32)
    avg = img.mean(axis=(0, 1))
    host = np.stack([
        pops.crop_and_resize(img, center, s, 255, border_value=avg)
        for s in sizes]).astype(np.float32)
    region, offs, sz = pdc.make_region(img, center, sizes, avg)
    return host, region, pdc.make_taps(offs, sz, 255)


@pytest.mark.parametrize('sizes,upscale', [([258.9, 280.0, 310.2], False),
                                           ([96.0, 140.5, 200.9], True)])
def test_device_scale_crops_bit_equal_to_jax_and_cv2(sizes, upscale):
    """Bit-equal to the JAX package's crops; against cv2's host crops
    bit-equal downscale, and upscale at most one LSB on < 0.3% of values
    (cv2 runs another SIMD kernel there), as ``test_siamfc.py`` holds the
    JAX package."""
    host, region, taps = crop_case(sizes)
    got = pdc.device_scale_crops(torch.from_numpy(region),
                                 torch.from_numpy(taps)).numpy()
    want = np.asarray(jdc.device_scale_crops(jnp.asarray(region),
                                             jnp.asarray(taps)))
    assert got.dtype == np.float32 and got.shape == (3, 255, 255, 3)
    np.testing.assert_array_equal(got, want)
    d = np.abs(got - host)
    if upscale:
        assert d.max() <= 1.0 and (d > 0).mean() < 3e-3
    else:
        assert d.max() == 0.0
    # the batched form: each sequence's crops, in its own padded region
    big = np.zeros((2, region.shape[0] + 64, region.shape[1] + 64, 3),
                   np.uint8)
    big[0, :region.shape[0], :region.shape[1]] = region
    big[1, :region.shape[0], :region.shape[1]] = region[::-1, ::-1]
    taps2 = np.stack([taps, taps])
    both = pdc.device_scale_crops(torch.from_numpy(big),
                                  torch.from_numpy(taps2)).numpy()
    np.testing.assert_array_equal(both[0], got)
    np.testing.assert_array_equal(both[1], pdc.device_scale_crops(
        torch.from_numpy(np.ascontiguousarray(region[::-1, ::-1])),
        torch.from_numpy(taps)).numpy())


@pytest.mark.parametrize('seed', range(4))
def test_device_response_post_peaks_equal(seed):
    """Equal (scale_id, y, x) peaks, one sequence and a batch of four;
    seed 3 plants the peak scale's maximum on two scales (a tie: both
    argmaxes take the first)."""
    rng = np.random.RandomState(seed)
    resp = rng.randn(4, 3, 9, 9).astype(np.float32) * 0.01
    if seed == 3:
        resp[:, 0] = resp[:, 2]
    up = jdc.cubic_resize_matrix(9, 272)
    win = np.outer(np.hanning(272), np.hanning(272))
    hann = (win / win.sum()).astype(np.float32)
    got = pdc.device_response_post(torch.from_numpy(resp),
                                   torch.from_numpy(up),
                                   torch.from_numpy(hann), 0.9745, 0.176)
    for k in range(4):
        want = jdc.device_response_post(jnp.asarray(resp[k]),
                                        jnp.asarray(up), jnp.asarray(hann),
                                        0.9745, 0.176)
        assert [int(g[k]) for g in got] == [int(w) for w in want]
        one = pdc.device_response_post(torch.from_numpy(resp[k]),
                                       torch.from_numpy(up),
                                       torch.from_numpy(hann), 0.9745,
                                       0.176)
        assert [int(o) for o in one] == [int(w) for w in want]


def test_bilinear_sample_matrix_matches_jax_and_cv2():
    rng = np.random.RandomState(0)
    img = rng.rand(50, 60).astype(np.float32)
    corner_y, corner_x, size, out = 3, 7, 17, 29
    want = cv2.resize(img[corner_y:corner_y + size,
                          corner_x:corner_x + size],
                      (out, out), interpolation=cv2.INTER_LINEAR)
    wy = pdc.bilinear_sample_matrix(50, out, corner_y, size)
    wx = pdc.bilinear_sample_matrix(60, out, corner_x, size)
    np.testing.assert_allclose(
        wy.numpy(), np.asarray(jdc.bilinear_sample_matrix(
            50, out, jnp.asarray(corner_y), jnp.asarray(size))),
        rtol=1e-6, atol=1e-6)
    got = (wy @ torch.from_numpy(img) @ wx.t()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# the linear probe
# ---------------------------------------------------------------------------

def jax_variables(cfg, seed=0):
    """The JAX tracker's variable tree for ``cfg`` (its shapes from
    ``jax.eval_shape`` of the tracker's init: nothing compiles), every
    leaf drawn from a seeded numpy stream: conv kernels N(0, 1 / fan_in),
    BatchNorm scales 1 +- 0.1, shifts, means and head biases +- 0.05,
    variances in [0.5, 1.5], so that every term is live."""
    jt = J.TrackerSiamFC(cfg)
    e, i = cfg['exemplar_sz'], cfg['instance_sz']
    shapes = jax.eval_shape(
        jt.net.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, e, e, 3), jnp.float32),
        jax.ShapeDtypeStruct((1, i, i, 3), jnp.float32))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == 'kernel':
            a = rng.randn(*shape) * np.sqrt(1.0 / np.prod(shape[:-1]))
        elif name == 'scale':
            a = 1 + 0.1 * rng.randn(*shape)
        elif name == 'var':
            a = 0.5 + rng.rand(*shape)
        else:
            a = 0.05 * rng.randn(*shape)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_tracker(cfg, variables):
    jt = J.TrackerSiamFC(cfg)
    jt.variables = variables
    return jt


def port_tracker(cfg, variables):
    pt = P.TrackerSiamFC(cfg, device='cpu')
    pt.net.load_state_dict(P.flax_siamfc_to_torch(variables))
    return pt


@pytest.fixture(scope='module')
def probe():
    """The small config, seeded variables, and two batches of float crops
    (exemplar 32, search 48: ``SiamFCTransforms``' output sizes)."""
    cfg = small_cfg(batch_size=2)
    rng = np.random.RandomState(11)
    batches = [(rng.rand(2, 32, 32, 3).astype(np.float32) * 255,
                rng.rand(2, 48, 48, 3).astype(np.float32) * 255)
               for _ in range(2)]
    return cfg, jax_variables(cfg, 1), batches


def jax_inputs(batch, dtype):
    z, x = ((a - P.tracker.IMG_MEAN) / P.tracker.IMG_STD for a in batch)
    return jnp.asarray(z.astype(dtype)), jnp.asarray(x.astype(dtype))


def jax_labels(cfg, n, dtype):
    lab = jlosses.create_labels((3, 3), cfg['r_pos'], cfg['r_neg'],
                                cfg['total_stride'])
    return jnp.asarray(np.tile(lab[None], (n, 1, 1)).astype(dtype))


def jax_grad_fn(jt, variables):
    """The JAX ``train_over``'s gradient: ``value_and_grad`` of
    ``_loss_fn`` in the head's parameters."""
    head_extra = {k: v for k, v in variables['head'].items()
                  if k != 'params'}
    return jax.jit(jax.value_and_grad(lambda hp, z, x, labels: jt._loss_fn(
        hp, variables['backbone'], head_extra, z, x, labels)))


def head_grads(pt):
    return {n: p.grad.detach().numpy() for n, p in
            pt.net.head.named_parameters()}


def head_sd(tree):
    """A head tree (gradients or parameters) in the port's names and
    layout, keeping its dtype."""
    out = {}
    for conv, leaves in tree.items():
        out[f'{conv}.weight'] = np.transpose(np.asarray(leaves['kernel']),
                                             (3, 2, 0, 1))
        out[f'{conv}.bias'] = np.asarray(leaves['bias'])
    return out


def to64(v):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), v)


@pytest.mark.parametrize('loss', ['focal', 'balanced'])
def test_probe_step_loss_and_grads_match_jax_fp32(probe, loss):
    cfg, v, batches = probe
    cfg = dict(cfg, loss=loss)
    z, x = jax_inputs(batches[0], np.float32)
    want, want_g = jax_grad_fn(jax_tracker(cfg, v), v)(
        v['head']['params'], z, x, jax_labels(cfg, 2, np.float32))
    pt = port_tracker(cfg, v)
    zt, xt = (torch.from_numpy(np.array(a)) for a in (z, x))
    got = pt._loss(zt, xt, pt._labels(2, zt, xt))
    got.backward()
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    want_sd = head_sd(want_g)
    for name, g in head_grads(pt).items():
        np.testing.assert_allclose(g, want_sd[name], rtol=1e-5,
                                   atol=1e-5 * np.abs(want_sd[name]).max())


def xcorr64(z, x, out_scale):
    """``siamfc_tpu.heads.fast_xcorr`` without its
    ``preferred_element_type=float32``, which lax refuses on fp64
    operands: the same grouped convolution, in the operands' type."""
    from jax import lax
    nz, hz, wz, c = z.shape
    nx, hx, wx, _ = x.shape
    lhs = jnp.moveaxis(x.reshape(nx // nz, nz, hx, wx, c), 1, 3).reshape(
        nx // nz, hx, wx, nz * c)
    out = lax.conv_general_dilated(
        lhs, jnp.moveaxis(z, 0, -1), window_strides=(1, 1), padding='VALID',
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'), feature_group_count=nz)
    out = jnp.moveaxis(out, 3, 1).reshape(nx, out.shape[1], out.shape[2], 1)
    return out * out_scale


@pytest.fixture(scope='module')
def jax64(probe):
    """The JAX probe in float64 (the backbone built with
    ``dtype=float64``, the xcorr by ``xcorr64``): ``value_and_grad`` of
    ``_loss_fn`` at the initial head on batch 1, each batch's backbone
    features, and the head-and-loss gradient on given features (the part
    of ``_loss_fn`` the gradient runs through: XLA's fp64 convolutions
    on the CPU take a second a backbone pass). Call under
    ``jax.enable_x64``."""
    from siamfc_tpu import heads as jheads
    cfg, v, batches = probe
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jheads, 'fast_xcorr', xcorr64)
        jt = J.TrackerSiamFC(dict(cfg, model={'backbone': dict(
            cfg['model']['backbone'], dtype=jnp.float64)}))
        v64 = to64(v)
        labels = jax_labels(cfg, 2, np.float64)
        inputs = [jax_inputs(b, np.float64) for b in batches]
        full = jax_grad_fn(jt, v64)(v64['head']['params'], *inputs[1],
                                    labels)
        backbone = jax.jit(lambda z: jt.backbone.apply(
            v64['backbone'], z, train=False))
        feats = [tuple(backbone(a) for a in pair) for pair in inputs]
        head_grad = jax.jit(jax.value_and_grad(
            lambda hp, zf, xf: jlosses.focal_loss(
                jt.head.apply({'params': hp}, zf, xf)[..., 0], labels)))
        yield jt, v64, full, feats, head_grad


def test_probe_step_fp64_loss_and_grads_match_jax(probe, jax64):
    cfg, v, batches = probe
    _, v64, (want, want_g), feats, head_grad = jax64
    with jax.enable_x64(True):
        z, x = jax_inputs(batches[1], np.float64)
        again, again_g = head_grad(v64['head']['params'], *feats[1])
    want, want_g = float(want), head_sd(to64(want_g))
    # the features route gives _loss_fn's numbers
    assert abs(float(again) - want) <= 1e-12 * abs(want)
    for name, g in head_sd(to64(again_g)).items():
        assert np.abs(g - want_g[name]).max() <= \
            1e-12 * np.abs(want_g[name]).max()
    pt = port_tracker(cfg, v)
    pt.net.double()
    zt, xt = (torch.from_numpy(np.array(a)) for a in (z, x))
    got = pt._loss(zt, xt, pt._labels(2, zt, xt))
    got.backward()
    assert abs(float(got) - want) <= 1e-9 * abs(want)
    for name, g in head_grads(pt).items():
        assert np.abs(g - want_g[name]).max() <= \
            1e-9 * np.abs(want_g[name]).max()


OPTIMS = [dict(optimizer='Adam', lr_schedule='exp', epoch_num=3),
          dict(optimizer='SGD', lr_schedule='step', lr_step_size=1,
               force_wd=True),
          dict(optimizer='Adam', lr_schedule='fixed', force_wd=True)]


@pytest.mark.parametrize('opt_cfg', OPTIMS)
def test_two_probe_steps_match_optax_fp64(probe, jax64, opt_cfg):
    """Two probe steps (loss, head gradients, update) in float64 on both
    sides, the JAX side through ``_build_optimizer``'s optax chain: each
    step's loss and gradients, and the head after each update, within
    1e-9. One iteration an epoch, so the staircase schedules step between
    the two updates; ``force_wd`` puts the decay into the chains (before
    SGD's momentum trace, after Adam's scaling). optax computes a
    schedule's rate from its int32 step count in float32, also under
    x64; the port's schedule gives it in float64, so the two must agree
    to float32's roundings, and the port's steps here take the rates
    optax hands out."""
    cfg, v, batches = probe
    cfg = dict(cfg, **opt_cfg)
    jt, v64, _, feats, head_grad = jax64
    saved, jt.cfg = jt.cfg, dict(jt.cfg, **opt_cfg)
    try:
        with jax.enable_x64(True):
            tx, jax_sched = jt._build_optimizer(1)
            if callable(jax_sched):
                rates = [jax_sched(jnp.asarray(c, jnp.int32))
                         for c in range(3)]
                assert all(r.dtype == jnp.float32 for r in rates)
            hp = v64['head']['params']
            state = tx.init(hp)
            traj = []
            for zf, xf in feats:
                loss, g = head_grad(hp, zf, xf)
                updates, state = tx.update(g, state, hp)
                hp = optax.apply_updates(hp, updates)
                traj.append((float(loss), head_sd(to64(g)),
                             head_sd(to64(hp))))
    finally:
        jt.cfg = saved
    pt = port_tracker(cfg, v)
    pt.net.double()
    opt, sched = pt._build_optimizer(1)
    if callable(jax_sched):
        np.testing.assert_allclose([sched(c) for c in range(3)],
                                   np.asarray(rates, np.float64),
                                   rtol=2.0**-22, atol=0)
        opt.schedule = lambda count: float(rates[count])
    else:
        assert [sched(c) for c in range(3)] == [jax_sched] * 3
    for (want, want_g, want_hp), batch in zip(traj, batches):
        got = pt.probe_step(opt, *batch)
        assert abs(float(got) - want) <= 1e-9 * abs(want)
        params = {n: p.detach().numpy()
                  for n, p in pt.net.head.named_parameters()}
        for ref, port in ((want_g, head_grads(pt)), (want_hp, params)):
            for name, a in port.items():
                err = np.abs(a - ref[name]).max()
                assert err <= 1e-9 * np.abs(ref[name]).max(), (name, err)


# ---------------------------------------------------------------------------
# the pair sampler
# ---------------------------------------------------------------------------

def make_got10k(root, n_seqs=3, n_frames=6, hw=(72, 96), seed=5):
    """GOT-10k layout: ``root/<seq>/%08d.jpg`` + ``groundtruth.txt``
    (1-indexed ltwh rows), a moving box on noise."""
    rng = np.random.RandomState(seed)
    h, w = hw
    for s in range(n_seqs):
        d = osp.join(root, f'GOT-10k_Train_{s:06d}')
        os.makedirs(d, exist_ok=True)
        base = rng.randint(0, 80, (h, w, 3), np.uint8)
        color = rng.randint(150, 255, 3).tolist()
        rows = []
        for t in range(n_frames):
            img = base.copy()
            x0, y0 = 10 + 3 * t + s, 12 + t
            bw, bh = 22 + s, 24
            img[y0:y0 + bh, x0:x0 + bw] = color
            cv2.imwrite(osp.join(d, f'{t + 1:08d}.jpg'), img)
            rows.append([x0 + 1, y0 + 1, bw, bh])
        np.savetxt(osp.join(d, 'groundtruth.txt'), np.array(rows),
                   fmt='%d', delimiter=',')


def test_pair_transforms_equal_jax_under_same_seed(tmp_path):
    """The port's ``Pair`` over a state seeded s gives the JAX ``Pair``'s
    crops after ``np.random.seed(s)``, bit for bit, over two passes (each
    item draws a pair, two crops' interpolations, two stretches and two
    random crops)."""
    make_got10k(str(tmp_path))
    kw = dict(exemplar_sz=32, instance_sz=64, context=0.5)
    saved = np.random.get_state()
    try:
        np.random.seed(123)
        jp = J.Pair(J.SequenceDataset(str(tmp_path)),
                    J.SiamFCTransforms(**kw))
        want = [jp[i] for i in list(range(len(jp))) * 2]
    finally:
        np.random.set_state(saved)
    pp = P.Pair(P.SequenceDataset(str(tmp_path)), P.SiamFCTransforms(**kw),
                rng=np.random.RandomState(123))
    got = [pp[i] for i in list(range(len(pp))) * 2]
    np.testing.assert_array_equal(pp.indices, jp.indices)
    for g, w in zip(got, want):
        assert g['z'].shape == (32, 32, 3) and g['x'].shape == (48, 48, 3)
        np.testing.assert_array_equal(g['z'], w['z'])
        np.testing.assert_array_equal(g['x'], w['x'])
    # untransformed items carry the boxes
    raw = P.Pair(P.SequenceDataset(str(tmp_path)))[0]
    assert set(raw) == {'z', 'x', 'box_z', 'box_x'}


def test_loader_worker_seeds_the_pair(tmp_path):
    """A loader process worker hands its seed (seed + ordinal) to the
    dataset's ``seed_worker``: the pair's stream restarts from it."""
    import multiprocessing
    import random

    from vfs_tpu_torch.datasets import builder
    make_got10k(str(tmp_path), n_seqs=2)
    pair = P.Pair(P.SequenceDataset(str(tmp_path)),
                  P.SiamFCTransforms(32, 64), rng=np.random.RandomState(9))
    counter = multiprocessing.Value('i', 3)
    saved = np.random.get_state(), random.getstate()
    try:
        builder._proc_init(pair, 40, counter)
    finally:
        np.random.set_state(saved[0])
        random.setstate(saved[1])
    assert builder._WORKER_DATASET is pair
    builder._WORKER_DATASET = None
    np.testing.assert_array_equal(
        pair.rng.randint(0, 1 << 30, 4),
        np.random.RandomState(43).randint(0, 1 << 30, 4))
