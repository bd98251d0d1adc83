"""The port's mask-propagation demo (``python -m vfs_tpu_torch.tools.demo``)
against the JAX package's ``demo/demo.py`` on the CPU, mirroring
tests/test_core/test_tools.py::test_demo_mask_propagation: an 8-frame
64x96 mp4v video of a moving square, a two-object palette mask and a
fabricated torchvision r18 ``.pth``. ``propagate`` must give the masks of
the JAX demo's own steps (``build_model`` -> ``init_weights`` ->
``forward_test``) pixel for pixel; the CLI writes every frame with the
palette colours, and exits non-zero where the output cannot be written."""

import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

from vfs_tpu_torch.tools import demo
from vfs_tpu_torch.utils import Config

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, 'configs', 'r18_nc_sgd_cos_100e_r2_1xNx8_k400.py')
H, W, T = 64, 96, 8


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """(video path, mask png, r18 .pth): the JAX demo test's inputs."""
    import cv2
    from PIL import Image

    from test_parity_torch import _fabricated_tv_state_dict
    d = tmp_path_factory.mktemp('demo')
    vid = str(d / 'in.mp4')
    writer = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*'mp4v'), 24,
                             (W, H))
    rng = np.random.RandomState(0)
    base = rng.randint(60, 190, (H, W, 3), np.uint8)
    for i in range(T):
        frame = base.copy()
        frame[20:36, 10 + 2 * i:26 + 2 * i] = (220, 40, 40)
        writer.write(frame)
    writer.release()
    mask = np.zeros((H, W), np.uint8)
    mask[20:36, 10:26] = 1
    mask[44:56, 60:80] = 2
    mask_png = str(d / 'mask.png')
    Image.fromarray(mask).save(mask_png)
    ckpt = str(d / 'r18.pth')
    torch.save(_fabricated_tv_state_dict(18), ckpt)
    return vid, mask_png, ckpt


def jax_demo_preds(frames, mask, checkpoint, height):
    """``demo/demo.py``'s steps from the decoded frames on, in the JAX
    package: resize, mask resize, ``build_model`` -> ``init_weights`` ->
    ``forward_test``."""
    import cv2
    from PIL import Image

    from vfs_tpu.datasets.pipelines.augmentations import _rescale_size
    from vfs_tpu.models import build_model
    from vfs_tpu.utils import Config as JaxConfig

    cfg = JaxConfig.fromfile(CONFIG)
    oh, ow = frames[0].shape[:2]
    new_w, new_h = _rescale_size((ow, oh), (np.inf, height))
    frames_rs = [cv2.resize(f, (new_w, new_h)) for f in frames]
    if mask.shape != (new_h, new_w):
        mask = np.asarray(Image.fromarray(mask).resize((new_w, new_h),
                                                       Image.NEAREST))
    mean = np.array([123.675, 116.28, 103.53], np.float32)
    std = np.array([58.395, 57.12, 57.375], np.float32)
    meta = [dict(original_shape=(new_h, new_w),
                 img_norm_cfg=dict(mean=mean, std=std))]
    model_cfg = dict(type='VanillaTracker', backbone=dict(cfg.model.backbone))
    model_cfg['backbone']['pretrained'] = checkpoint
    model = build_model(model_cfg, test_cfg=cfg.test_cfg)
    model.init_weights()
    return frames_rs, model.forward_test(
        np.stack(frames_rs).astype(np.uint8), mask.astype(np.uint8),
        meta)[0]


@pytest.mark.parametrize('height', [64, 48], ids=['native', 'resized'])
def test_propagate_equals_jax_demo(inputs, height):
    from PIL import Image
    vid, mask_png, ckpt = inputs
    frames, fps = demo.read_video(vid)
    assert len(frames) == T and fps == pytest.approx(24.0)
    mask = np.asarray(Image.open(mask_png))
    frames_rs, preds = demo.propagate(frames, mask, Config.fromfile(CONFIG),
                                      ckpt, height, device='cpu')
    ref_frames, ref = jax_demo_preds(frames, mask, ckpt, height)
    assert preds.shape == (T, height, height * 3 // 2)
    assert preds.dtype == np.uint8
    for a, b in zip(frames_rs, ref_frames):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(preds, np.asarray(ref))  # exact
    assert set(np.unique(preds[1:])) <= {0, 1, 2}
    assert (preds[-1] == 1).any() and (preds[-1] == 2).any()


def test_overlay_paints_the_palette():
    frame = np.full((4, 4, 3), 100, np.uint8)
    pred = np.zeros((4, 4), np.uint8)
    pred[1, 1], pred[2, 2] = 1, 30  # 30: past the palette, clipped
    out = demo.overlay(frame, pred, 0.5)
    assert out[1, 1].tolist() == [114, 50, 50]  # 0.5 * (128,0,0) + 50
    assert out[2, 2].tolist() == [114, 82, 114]  # the last, (128, 64, 128)
    np.testing.assert_array_equal(out[0, 0], frame[0, 0])


def _run_cli(args):
    env = dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='1')
    return subprocess.run([sys.executable, '-m', 'vfs_tpu_torch.tools.demo',
                           *args, '--device', 'cpu'], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def test_cli_writes_the_overlay(inputs, tmp_path):
    import cv2
    vid, mask_png, ckpt = inputs
    out = str(tmp_path / 'out.mp4')
    r = _run_cli([CONFIG, ckpt, vid, mask_png, out, '--height', '64',
                  '--alpha', '1.0'])
    assert r.returncode == 0, r.stderr
    assert f'wrote {out} ({T} frames @ 24.0 fps)' in r.stdout
    cap = cv2.VideoCapture(out)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    cap.release()
    assert len(frames) == T
    # frame 0 is the input mask; alpha 1 paints the DAVIS palette colours
    # (1 -> (128, 0, 0), 2 -> (0, 128, 0)) up to mp4 loss
    f0 = frames[0].astype(np.int32)
    obj1 = f0[22:34, 12:24].mean(axis=(0, 1))
    obj2 = f0[46:54, 62:78].mean(axis=(0, 1))
    assert abs(obj1[0] - 128) < 40 and obj1[1] < 60 and obj1[2] < 60, obj1
    assert abs(obj2[1] - 128) < 40 and obj2[0] < 60 and obj2[2] < 60, obj2


def test_cli_fails_when_the_output_cannot_be_written(inputs, tmp_path):
    """The JAX script prints ``wrote`` and exits 0 with nothing written
    (ROADMAP Queue 3); the port exits non-zero."""
    vid, mask_png, ckpt = inputs
    out = str(tmp_path / 'no_such_dir' / 'out.mp4')
    r = _run_cli([CONFIG, ckpt, vid, mask_png, out, '--height', '32'])
    assert r.returncode != 0
    assert 'cannot write' in r.stderr
    assert not osp.exists(out)
