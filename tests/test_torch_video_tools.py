"""The port's video helpers against the JAX package's on the CPU: the five
tensor helpers of ``models/common/utils.py`` (``video2images``,
``images2video``, ``mean_list``, ``unmap``, ``clamp``: exact), and
``python -m vfs_tpu_torch.tools.data.build_rawframes`` against
``tools/data/build_rawframes.py`` on a tree of two tiny mp4v videos: the
same file names and the same JPEG bytes, under ``--level 1/2``,
``--new-short``, ``--new-width/--new-height`` and ``--resume``. The JAX
tool's loader builds its library into a temporary directory here
(``test_torch_native_loader.jax_loader``)."""

import os
import os.path as osp
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.models.common import utils as jax_utils
from vfs_tpu_torch.models.common import utils

from test_torch_native_loader import jax_loader  # noqa: F401  (fixture)

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_video2images_images2video_equal_jax():
    x = _rand(2, 3, 4, 5, 6)
    ours = utils.video2images(torch.from_numpy(x))
    ref = jax_utils.video2images(jnp.asarray(x))
    assert ours.shape == (6, 4, 5, 6)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    back = utils.images2video(ours, 3)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_utils.images2video(ref, 3)))
    np.testing.assert_array_equal(back.numpy(), x)


def test_mean_list_equals_jax():
    xs = [_rand(3, 4, seed=s) for s in range(5)]
    ours = utils.mean_list([torch.from_numpy(x) for x in xs])
    ref = jax_utils.mean_list([jnp.asarray(x) for x in xs])
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))  # exact


@pytest.mark.parametrize('fill', [0, -1.5])
def test_unmap_equals_jax(fill):
    data = _rand(3, 2, 4)
    inds = np.array([0, 1, 1, 0, 0, 1, 0], np.int64)
    ours = utils.unmap(torch.from_numpy(data), 7, torch.from_numpy(inds),
                       fill)
    ref = jax_utils.unmap(jnp.asarray(data), 7, jnp.asarray(inds), fill)
    assert ours.shape == (7, 2, 4) and ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize('lo,hi', [(-0.5, 0.5), (None, 0.25), (0.0, None)])
def test_clamp_equals_jax(lo, hi):
    x = _rand(4, 6)
    ours = utils.clamp(torch.from_numpy(x), min=lo, max=hi)
    ref = jax_utils.clamp(jnp.asarray(x), min=lo, max=hi)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    with pytest.raises(AssertionError):
        utils.clamp(torch.from_numpy(x))


@pytest.fixture(scope='module')
def video_tree(tmp_path_factory):
    """Two mp4v videos, 6 and 9 frames of 48x64 with texture, under a
    class directory (``--level 2``) and at the top (``--level 1``)."""
    import cv2
    root = tmp_path_factory.mktemp('videos')
    (root / 'cls_a').mkdir()
    rng = np.random.RandomState(3)
    for rel, n in (('cls_a/v0.mp4', 6), ('v1.mp4', 9)):
        writer = cv2.VideoWriter(str(root / rel),
                                 cv2.VideoWriter_fourcc(*'mp4v'), 25,
                                 (64, 48))
        base = rng.randint(0, 255, (48, 64, 3), np.uint8)
        for t in range(n):
            writer.write(np.roll(base, 3 * t, axis=1))
        writer.release()
    return str(root)


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(osp.join(d, f), 'rb') as fh:
                out[osp.relpath(osp.join(d, f), root)] = fh.read()
    return out


def _jax_tool(video_tree, out_dir, level, extra):
    """The JAX tool's ``extract_one`` over its own video list (in this
    process, so its loader is the fixture's)."""
    import glob
    sys.path.insert(0, ROOT)
    from tools.data import build_rawframes as jax_tool
    argv = sys.argv
    sys.argv = ['build_rawframes.py', video_tree, out_dir, '--level',
                str(level), *extra]
    try:
        args = jax_tool.parse_args()
    finally:
        sys.argv = argv
    videos = sorted(glob.glob(osp.join(
        args.src_dir, *(['*'] * (args.level - 1)), f'*.{args.ext}')))
    opts = dict(out_dir=args.out_dir, new_width=args.new_width,
                new_height=args.new_height, new_short=args.new_short,
                filename_tmpl=args.filename_tmpl,
                start_index=args.start_index, resume=args.resume)
    return [jax_tool.extract_one((v, osp.relpath(v, args.src_dir), opts))
            for v in videos]


@pytest.mark.parametrize('level,extra', [
    (2, []),
    (1, ['--new-short', '32', '--start-index', '0']),
    (2, ['--new-width', '40', '--new-height', '30', '--filename-tmpl',
         'f_{:04d}.jpg']),
], ids=['level2', 'level1_new_short', 'level2_new_size'])
def test_build_rawframes_equals_jax_tool(video_tree, tmp_path, jax_loader,
                                         level, extra):
    from vfs_tpu_torch.tools.data import build_rawframes
    ours, ref = str(tmp_path / 'ours'), str(tmp_path / 'ref')
    assert build_rawframes.main([video_tree, ours, '--level', str(level),
                                 '--num-worker', '2', *extra]) == 0
    done = _jax_tool(video_tree, ref, level, extra)
    assert all(n > 0 for _, n in done)
    a, b = _tree(ours), _tree(ref)
    assert sorted(a) == sorted(b) and a == b  # names and bytes
    assert len({osp.dirname(k) for k in a}) == 1  # one video a level
    if '--new-short' in extra:
        import cv2
        img = cv2.imread(osp.join(ours, 'v1', 'img_00000.jpg'))
        assert img.shape == (32, 43, 3)


def test_build_rawframes_resume_and_cli(video_tree, tmp_path):
    """``--resume`` skips a video whose directory holds files; the module
    runs from the command line and exits 0."""
    out = tmp_path / 'out'
    (out / 'cls_a' / 'v0').mkdir(parents=True)
    (out / 'cls_a' / 'v0' / 'keep.txt').write_text('x')
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    r = subprocess.run([sys.executable, '-m',
                        'vfs_tpu_torch.tools.data.build_rawframes',
                        video_tree, str(out), '--level', '2', '--resume',
                        '--num-worker', '1'], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert '1 videos under' in r.stdout and 'done; 0 failures' in r.stdout
    assert os.listdir(out / 'cls_a' / 'v0') == ['keep.txt']
    r = subprocess.run([sys.executable, '-m',
                        'vfs_tpu_torch.tools.data.build_rawframes',
                        video_tree, str(tmp_path / 'all'), '--level', '1',
                        '--num-worker', '1'], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert len(os.listdir(tmp_path / 'all' / 'v1')) == 9


def test_build_rawframes_reports_a_failed_video(tmp_path):
    from vfs_tpu_torch.tools.data import build_rawframes
    src = tmp_path / 'src'
    src.mkdir()
    (src / 'broken.mp4').write_bytes(b'not a video')
    assert build_rawframes.main([str(src), str(tmp_path / 'out'),
                                 '--level', '1', '--num-worker', '1']) == 1
