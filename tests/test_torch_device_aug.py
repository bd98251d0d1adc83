"""The port's on-device augmentation (``vfs_tpu_torch/ops/device_aug.py``)
against ``vfs_tpu/ops/device_aug.py`` on the same numpy inputs and the same
parameters, the host side (``DeviceAug`` and ``collate``) against the JAX
package's, and the ``_deviceaug`` config through ``train_model`` on the
CPU.

The two packages draw from different generators, so each op takes
parameters that JAX drew (or fixed ones), and the whole chain takes the
parameters that ``build_device_aug(...)(x, orig_hw, key)`` draws, found
by replaying its key splits (``jax_chain_params``).

Tolerances, on the [0, 255] scale before normalisation: crop-resize,
grayscale and blur sum a few fp32 products in another order (measured
at most 6.1e-5), so atol 1e-3. The HSV conversions divide by max - min
and take a remainder, which amplifies rounding near grey pixels: the hsv
round trip, the jitter chains and the whole chain are held at atol 2e-3
(measured at most 1.7e-4). The crop sampler is exact: both packages take
the same float32 operations on the same draws.
"""

import itertools
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.datasets.builder import collate as jax_collate
from vfs_tpu.datasets.pipelines.augmentations import DeviceAug as JaxDeviceAug
from vfs_tpu.ops import device_aug as jda
from vfs_tpu_torch.apis.train import train_model
from vfs_tpu_torch.datasets import build_dataset
from vfs_tpu_torch.datasets.builder import collate
from vfs_tpu_torch.datasets.pipelines import DeviceAug
from vfs_tpu_torch.models import build_model
from vfs_tpu_torch.ops import device_aug as tda
from vfs_tpu_torch.utils import Config

from test_models.test_simsiam_train import make_video_dataset
from test_torch_train_step import MODEL_CFG, TRAIN_CFG

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, 'configs',
                  'r18_sgd_cos_100e_r2_1xNx8_k400_deviceaug.py')
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])
ATOL, HSV_ATOL = 1e-3, 2e-3


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _frames(seed, f=6, h=20, w=24):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (f, h, w, 3)).astype(np.float32)


def test_crop_resize_matches_jax():
    x = _frames(0, f=3, h=30, w=40)
    rects = [np.asarray(v, np.float32) for v in
             ([0, 5, 11.5], [0, 9, 3.25], [30, 12, 17.5], [40, 20, 31.0])]
    ref = jda.crop_resize(jnp.asarray(x), tuple(map(jnp.asarray, rects)),
                          (12, 16))
    out = tda.crop_resize(_t(x), tuple(map(_t, rects)), (12, 16))
    assert out.shape == (3, 12, 16, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_hsv_round_trip_matches_jax():
    x = _frames(1, f=2)
    x[0, :4] = 128.0  # grey pixels: d = 0
    x[1, :2, :, 0] = x[1, :2, :, 1]  # max shared by two channels
    h, s, v = tda.rgb_to_hsv(_t(x))
    jh, js, jv = jda.rgb_to_hsv(jnp.asarray(x))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=HSV_ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    back = tda.hsv_to_rgb(h, s, v)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jda.hsv_to_rgb(jh, js, jv)), atol=HSV_ATOL)
    np.testing.assert_allclose(back.numpy(), x, atol=HSV_ATOL)


@pytest.mark.parametrize('first_op', range(4),
                         ids=['brightness', 'contrast', 'saturation', 'hue'])
def test_color_jitter_matches_jax_under_every_order(first_op):
    """The six orders that start with ``first_op``, one a frame, with
    JAX-drawn factors; two of the eight frames skip the jitter."""
    orders = [o for o in itertools.permutations(range(4))
              if o[0] == first_op] + [(0, 1, 2, 3), (3, 2, 1, 0)]
    f = len(orders)
    x = _frames(2 + first_op, f=f)
    ks = jax.random.split(jax.random.PRNGKey(first_op), 4)
    p = [np.asarray(jax.random.uniform(k, (f,), minval=lo, maxval=hi))
         for k, (lo, hi) in zip(ks, [(0.6, 1.4)] * 3 + [(-0.1, 0.1)])]
    apply = np.ones(f, bool)
    apply[-2:] = False
    order = np.asarray(orders, np.int32)
    ref = jda.color_jitter(jnp.asarray(x), *map(jnp.asarray, p),
                           jnp.asarray(apply), jnp.asarray(order))
    out = tda.color_jitter(_t(x), *map(_t, p), _t(apply), _t(order))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=HSV_ATOL)
    np.testing.assert_array_equal(out[-2:].numpy(), x[-2:])


def test_grayscale_matches_jax():
    x = _frames(3, f=4)
    apply = np.array([True, False, True, False])
    ref = jda.grayscale(jnp.asarray(x), jnp.asarray(apply))
    out = tda.grayscale(_t(x), _t(apply))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize('sigma_range', [(0.1, 2.0), (1.5, 3.0)])
def test_gaussian_blur_matches_jax(sigma_range):
    x = _frames(4, f=5, h=16, w=20)
    lo, hi = sigma_range
    sigma = np.linspace(lo, hi, 5).astype(np.float32)
    apply = np.array([True, True, False, True, True])
    radius = max(1, int(round(3 * hi)))
    ref = jda.gaussian_blur(jnp.asarray(x), jnp.asarray(sigma),
                            jnp.asarray(apply), max_radius=radius)
    out = tda.gaussian_blur(_t(x), _t(sigma), _t(apply), max_radius=radius)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_array_equal(out[2].numpy(), x[2])
    none = tda.gaussian_blur(_t(x), _t(sigma), _t(np.zeros(5, bool)), radius)
    np.testing.assert_array_equal(none.numpy(), x)


def _jax_crop_draws(key, lead, area_range, aspect_ratio_range):
    """The uniforms ``vfs_tpu``'s ``sample_crop_rects`` draws from
    ``key``, as the port's sampler takes them."""
    k_ar, k_area, k_xy = jax.random.split(key, 3)
    min_ar, max_ar = aspect_ratio_range
    log_ar = jax.random.uniform(k_ar, lead + (10,), minval=float(
        np.log(min_ar)), maxval=float(np.log(max_ar)))
    area = jax.random.uniform(k_area, lead + (10,), minval=area_range[0],
                              maxval=area_range[1])
    return [np.asarray(v) for v in
            (log_ar, area, jax.random.uniform(k_xy, lead + (2,)))]


@pytest.mark.parametrize('area_range,hw', [
    ((0.2, 1.0), (240.0, 320.0)), ((0.08, 1.0), (64.0, 480.0)),
    ((1.5, 2.0), (100.0, 90.0))], ids=['k400', 'wide', 'fallback'])
def test_sample_crop_rects_from_jax_uniforms(area_range, hw):
    """From the uniforms JAX draws, the rects equal JAX's exactly; the
    impossible area range takes the centred square."""
    key = jax.random.PRNGKey(7)
    hw_a = np.tile(np.asarray([hw], np.float32), (300, 1))
    ar = (3 / 4, 4 / 3)
    ref = jda.sample_crop_rects(key, jnp.asarray(hw_a), area_range, ar)
    out = tda.sample_crop_rects(
        _t(hw_a), *map(_t, _jax_crop_draws(key, (300,), area_range, ar)))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    y, x, ch, cw = (v.numpy() for v in out)
    assert (y >= 0).all() and (y + ch <= hw[0]).all()
    assert (x >= 0).all() and (x + cw <= hw[1]).all()
    if area_range[0] > 1:
        assert (ch == min(hw)).all() and (cw == min(hw)).all()


def jax_chain_params(chain, shape, orig_hw, key):
    """The per-frame parameters ``vfs_tpu``'s ``build_device_aug`` chain
    draws from ``key`` (its key splits replayed), in the port's format."""
    b, n, t, hs, ws, _ = shape
    params = []
    for typ, cfg in chain.spec:
        key, sub = jax.random.split(key)
        g = jda._param_shape(b, n, t, cfg.get('same_on_clip', True),
                             cfg.get('same_across_clip', True))

        def frames(v):
            return _t(jda._bcast(v, b, n, t))
        if typ == 'RandomResizedCrop':
            ohw = jnp.broadcast_to(jnp.asarray(orig_hw, jnp.float32)[
                :, None, None, :], g + (2,))
            y, x, ch, cw = jda.sample_crop_rects(
                sub, ohw, tuple(cfg.get('area_range', (0.08, 1.0))),
                tuple(cfg.get('aspect_ratio_range', (3 / 4, 4 / 3))))
            sy, sx = hs / ohw[..., 0], ws / ohw[..., 1]
            params.append((typ, dict(rects=tuple(frames(v) for v in (
                y * sy, x * sx, ch * sy, cw * sx)))))
        elif typ == 'Flip':
            axis = 2 if cfg.get('direction', 'horizontal') == 'horizontal' \
                else 1
            params.append((typ, dict(axis=axis, flip=frames(
                jax.random.uniform(sub, g) < cfg.get('flip_ratio', 0.5)))))
        elif typ == 'ColorJitter':
            ks = jax.random.split(sub, 6)
            vals = []
            for k, name in zip(ks[:3], ('brightness', 'contrast',
                                        'saturation')):
                r = cfg.get(name, 0)
                vals.append(jax.random.uniform(k, g, minval=max(0.0, 1 - r),
                                               maxval=1 + r))
            hu = cfg.get('hue', 0)
            vals.append(jax.random.uniform(ks[3], g, minval=-hu, maxval=hu))
            vals.append(jax.random.uniform(ks[4], g) < cfg.get('p', 1.0))
            perm = jnp.argsort(jax.random.uniform(ks[5], g + (4,)), axis=-1)
            p = dict(zip(('bright', 'contrast', 'sat', 'hue', 'apply'),
                         map(frames, vals)))
            p['order'] = torch.stack([frames(perm[..., i]) for i in
                                      range(4)], -1)
            params.append((typ, p))
        elif typ == 'RandomGrayScale':
            params.append((typ, dict(apply=frames(
                jax.random.uniform(sub, g) < cfg.get('p', 0.2)))))
        elif typ == 'RandomGaussianBlur':
            ks = jax.random.split(sub, 2)
            lo, hi = cfg.get('sigma_range', (0.1, 2.0))
            params.append((typ, dict(
                sigma=frames(jax.random.uniform(ks[0], g, minval=lo,
                                                maxval=hi)),
                apply=frames(jax.random.uniform(ks[1], g)
                             < cfg.get('p', 0.5)),
                max_radius=max(1, int(round(3 * hi))))))
    return params


def _config_chain(out_hw=None):
    cfg = Config.fromfile(CONFIG)
    transforms = [dict(t) for t in cfg.device_aug['transforms']]
    if out_hw is not None:
        transforms = [dict(t, scale=out_hw[::-1]) if t['type'] == 'Resize'
                      else t for t in transforms]
    return transforms, dict(cfg.img_norm_cfg)


@pytest.mark.parametrize('seed', [0, 1])
def test_whole_chain_matches_jax_on_its_draws(seed):
    """The ``_deviceaug`` config's chain (crop to 20x24) on uint8 staging
    frames, with the parameters the JAX chain draws from its key."""
    transforms, norm = _config_chain(out_hw=(20, 24))
    chain = tda.build_device_aug(transforms, norm)
    jax_fn = jda.build_device_aug(transforms, norm)
    assert chain.out_hw == tuple(jax_fn.out_hw) == (20, 24)
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 256, (2, 2, 3, 32, 40, 3)).astype(np.uint8)
    orig_hw = np.array([[240, 320], [100, 170]], np.int32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(orig_hw), key))
    out = chain.apply(_t(x), jax_chain_params(chain, x.shape, orig_hw, key))
    assert out.shape == ref.shape == (2, 2, 3, 20, 24, 3)
    std = np.asarray(norm['std'], np.float32)
    np.testing.assert_allclose(out.numpy() * std, ref * std, atol=HSV_ATOL)


def test_draws_broadcast_per_clip_and_per_sample():
    """``same_on_clip`` gives the frames of a clip one draw;
    ``same_across_clip`` gives a sample's clips one draw too; the default
    ``False`` / ``False`` a draw per frame."""
    flags = [(False, False), (True, False), (True, True)]
    chain = tda.build_device_aug(
        [dict(type='RandomGaussianBlur', p=0.5, same_on_clip=on,
              same_across_clip=across) for on, across in flags], NORM)
    g = torch.Generator().manual_seed(0)
    params = chain.draw((3, 2, 4, 8, 8, 3), torch.tensor([[8, 8]] * 3), g)
    per_frame, per_clip, per_sample = (
        p['sigma'].reshape(3, 2, 4) for _, p in params)
    assert len(set(per_frame.flatten().tolist())) == 24
    assert (per_clip == per_clip[..., :1]).all()
    assert len(set(per_clip.flatten().tolist())) == 6
    assert (per_sample == per_sample[:, :1, :1]).all()
    assert len(set(per_sample.flatten().tolist())) == 3
    # the per-clip crops of identical frames give identical outputs
    chain = tda.build_device_aug(
        [dict(type='RandomResizedCrop', area_range=(0.3, 0.9),
              same_across_clip=False),
         dict(type='Resize', scale=(8, 8), keep_ratio=False)],
        dict(mean=[0.0] * 3, std=[1.0] * 3))
    frame = np.random.RandomState(5).randint(0, 256, (24, 24, 3), np.uint8)
    imgs = _t(np.broadcast_to(frame, (1, 2, 4, 24, 24, 3)).copy())
    out = chain(imgs, torch.tensor([[24, 24]]),
                torch.Generator().manual_seed(2))
    assert (out == out[:, :, :1]).all() and not (out[:, 0] == out[:, 1]).all()


@pytest.mark.parametrize('transforms,norm,match', [
    ([dict(type='RandomErasing')], NORM, 'RandomErasing'),
    ([dict(type='Flip', flip_ratio=0.5, same_clip_indices=(0,))], NORM,
     'same_clip_indices'),
    ([dict(type='Flip', flip_ration=0.5)], NORM, 'flip_ration'),
    ([dict(type='Resize', scale=(32, 32))], NORM, 'keep_ratio=False'),
    ([dict(type='Resize', keep_ratio=False)], NORM, 'keep_ratio=False'),
    ([dict(type='Flip')], None, 'img_norm_cfg'),
    ([dict(type='Flip')], dict(mean=[0.0] * 3), 'img_norm_cfg'),
    ([dict(type='Flip')], dict(NORM, to_bgr=True), 'to_bgr'),
], ids=['type', 'host_kwarg', 'typo', 'keep_ratio', 'no_scale', 'no_norm',
        'no_std', 'to_bgr'])
def test_build_device_aug_raises_as_jax(transforms, norm, match):
    for build in (tda.build_device_aug, jda.build_device_aug):
        with pytest.raises(ValueError, match=match):
            build(transforms, norm)


def test_staging_must_equal_output_without_a_crop():
    chain = tda.build_device_aug([dict(type='Flip')], NORM, out_hw=(8, 8))
    imgs = torch.zeros((1, 1, 1, 8, 10, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match='staging == out size'):
        chain(imgs, torch.tensor([[8, 10]]), torch.Generator())
    out = chain(imgs[..., :8, :], torch.tensor([[8, 8]]), torch.Generator())
    assert out.shape == (1, 1, 1, 8, 8, 3)
    chain = tda.build_device_aug(
        [dict(type='RandomResizedCrop'),
         dict(type='Resize', scale=(112, 96), keep_ratio=False)], NORM)
    assert chain.out_hw == (96, 112)


def test_device_aug_transform_and_collate_match_jax():
    """``DeviceAug`` (cv2 INTER_LINEAR to the staging size) and
    ``collate`` give the JAX package's uint8 frames and (B, 2) int32
    ``orig_hw``."""
    rs = np.random.RandomState(8)
    samples, jax_samples = [], []
    for hw in [(48, 64), (40, 30)]:
        imgs = [rs.randint(0, 256, hw + (3,)).astype(np.uint8)
                for _ in range(4)]
        res = dict(imgs=list(imgs), num_clips=2)
        samples.append(DeviceAug(scale=(20, 16))(dict(res)))
        jax_samples.append(JaxDeviceAug(scale=(20, 16))(dict(res)))
    for s, j in zip(samples, jax_samples):
        assert s['imgs'].shape == (2, 2, 16, 20, 3)
        assert s['imgs'].dtype == np.uint8
        np.testing.assert_array_equal(s['imgs'], j['imgs'])
    keys = ('imgs', 'orig_hw')
    batch = collate([{k: s[k] for k in keys} for s in samples])
    ref = jax_collate([{k: s[k] for k in keys} for s in jax_samples])
    assert batch['orig_hw'].dtype == np.int32
    np.testing.assert_array_equal(batch['orig_hw'], [[48, 64], [40, 30]])
    for k in keys:
        np.testing.assert_array_equal(batch[k], ref[k])
    same = DeviceAug(scale=(64, 48))(dict(imgs=[imgs[0]] * 2, num_clips=1))
    assert same['imgs'].shape == (1, 2, 48, 64, 3)


def test_step_seed_depends_on_seed_rank_and_step():
    base = tda.step_seed(0, 0, 5)
    assert base == tda.step_seed(0, 0, 5)
    others = {tda.step_seed(1, 0, 5), tda.step_seed(0, 1, 5),
              tda.step_seed(0, 0, 6), tda.step_seed(0, 0, 4)}
    assert base not in others and len(others) == 4
    assert all(0 <= s < 2 ** 63 for s in others)
    transforms, norm = _config_chain(out_hw=(8, 8))
    chain = tda.build_device_aug(transforms, norm)

    def draws(seed):
        g = torch.Generator().manual_seed(seed)
        return chain.draw((2, 2, 2, 12, 12, 3), torch.tensor(
            [[30, 40], [50, 20]]), g)[0][1]['rects'][0]
    assert torch.equal(draws(base), draws(tda.step_seed(0, 0, 5)))
    assert not torch.equal(draws(base), draws(tda.step_seed(0, 1, 5)))


@pytest.fixture(scope='module')
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp('deviceaug_videos')
    return make_video_dataset(str(root / 'videos'), num_videos=4,
                              num_frames=8, hw=(48, 64))


def _deviceaug_cfg(ann, work_dir, total_epochs):
    """The ``_deviceaug`` config at a test size: its chain and pipeline
    with 24x32 staging frames cropped to 16x16, the narrow head of
    ``test_torch_train_step``, 4 samples of two 2-frame clips."""
    cfg = Config.fromfile(CONFIG).to_dict()
    pipeline = cfg['data']['train']['dataset']['pipeline']
    types = [t['type'] for t in pipeline]
    pipeline[0] = dict(type='OpenCVInit')
    pipeline[types.index('SampleFrames')]['num_clips'] = 4
    pipeline[types.index('Clip2Frame')]['clip_len'] = 2
    pipeline[types.index('DecordDecode')] = dict(type='OpenCVDecode')
    pipeline[types.index('DeviceAug')]['scale'] = (32, 24)
    transforms, _ = _config_chain(out_hw=(16, 16))
    cfg.update(
        model=MODEL_CFG, train_cfg=TRAIN_CFG, work_dir=str(work_dir),
        seed=0, total_epochs=total_epochs, log_config=dict(interval=1),
        device_aug=dict(cfg['device_aug'], out_hw=(16, 16),
                        transforms=transforms))
    cfg['data'].update(videos_per_gpu=4, workers_per_gpu=1)
    cfg['data']['train']['dataset'].update(ann_file=ann,
                                           data_prefix=osp.dirname(ann))
    return Config.fromdict(cfg)


def test_deviceaug_config_trains_two_steps_on_the_cpu(videos, tmp_path,
                                                     monkeypatch):
    """Two steps of the ``_deviceaug`` config: the loader ships uint8
    staging clips and ``orig_hw``, the chain runs in the step, the loss is
    finite; each step's draws come from (seed, rank, step), so a run
    resumed after step 1 draws at step 2 what the whole run drew."""
    cfg = _deviceaug_cfg(videos, tmp_path / 'work', total_epochs=2)
    dataset = build_dataset(cfg.data.train)
    sample = dataset[0]
    assert sample['imgs'].shape == (2, 2, 24, 32, 3)
    assert sample['imgs'].dtype == np.uint8
    assert tuple(sample['orig_hw']) == (48, 64)
    cfg.data.train.times = 1  # 4 samples: one step an epoch

    seen = []
    real = tda.DeviceAugChain.draw

    def record(self, shape, orig_hw, generator):
        params = real(self, shape, orig_hw, generator)
        seen.append(params[0][1]['rects'][0].clone())
        return params
    monkeypatch.setattr(tda.DeviceAugChain, 'draw', record)
    model = build_model(cfg.model, train_cfg=cfg.train_cfg)
    state = train_model(model, build_dataset(cfg.data.train), cfg,
                        device='cpu')
    assert state.step == 2
    lines = (tmp_path / 'work' / 'train_log.jsonl').read_text()
    assert lines.count('"mode": "train"') == 2
    # resume from epoch 1: step 2 draws what the whole run drew
    (tmp_path / 'work' / 'checkpoints' / 'latest').write_text('epoch_1')
    model = build_model(cfg.model, train_cfg=cfg.train_cfg)
    state = train_model(model, build_dataset(cfg.data.train), cfg,
                        device='cpu')
    assert state.step == 2 and len(seen) == 3
    assert torch.equal(seen[2], seen[1])
    assert not torch.equal(seen[0], seen[1])
