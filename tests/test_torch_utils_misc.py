"""The last small modules of ROADMAP item 7c and the package's remainder in
vfs_tpu_torch against the JAX package on the CPU: ``utils.ZipReader``,
``utils.misc.add_suffix`` and ``terminal_is_available``,
``core.optimizer.CopyOfSGD`` and ``version.__version__``."""

import io
import os
import zipfile

import numpy as np
import pytest
import torch

import vfs_tpu
import vfs_tpu_torch
from vfs_tpu.utils import misc as jax_misc
from vfs_tpu.utils.zip_reader import ZipReader as JaxZipReader
from vfs_tpu_torch.core.optimizer import CopyOfSGD, build_optimizer
from vfs_tpu_torch.utils import ZipReader, add_suffix, terminal_is_available
from vfs_tpu_torch.version import __version__

torch.set_num_threads(1)


@pytest.fixture
def bundle(tmp_path):
    """A zip bundle of two PNG frames and a text file under ``vid/``."""
    import cv2
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 255, (8, 12, 3), np.uint8) for _ in range(2)]
    path = str(tmp_path / 'frames.zip')
    with zipfile.ZipFile(path, 'w') as zf:
        for i, img in enumerate(frames):
            ok, buf = cv2.imencode('.png', img)
            assert ok
            zf.writestr(f'vid/{i:03d}.png', buf.tobytes())
        zf.writestr('vid/info.txt', b'two frames')
    yield path, frames
    ZipReader.close()
    JaxZipReader.close()


def test_zip_reader_matches_jax(bundle):
    path, frames = bundle
    for name in ('vid/000.png', 'vid/001.png', 'vid/info.txt'):
        for style in (f'{path}@{name}', f'{path}@/{name}', f'{path}/{name}'):
            assert ZipReader.read(style) == JaxZipReader.read(style)
            assert ZipReader.split_zip_style_path(style) == \
                JaxZipReader.split_zip_style_path(style)
    for i, img in enumerate(frames):
        out = ZipReader.imread(f'{path}@vid/{i:03d}.png')
        np.testing.assert_array_equal(
            out, JaxZipReader.imread(f'{path}@vid/{i:03d}.png'))
        np.testing.assert_array_equal(out, img[..., ::-1])  # BGR -> RGB
        np.testing.assert_array_equal(
            ZipReader.imread(f'{path}@vid/{i:03d}.png', flag='unchanged'),
            img)
    assert ZipReader.get_zipfile(path) is ZipReader.get_zipfile(path)
    ZipReader.close()
    assert not ZipReader.zip_bank
    with pytest.raises(FileNotFoundError):
        ZipReader.read(path.replace('.zip', '_missing.zip') + '/vid/000.png')


def test_add_suffix_matches_jax():
    inputs = {'loss': 1.0, 'acc.top1': 0.5}
    assert add_suffix(inputs, 'val') == jax_misc.add_suffix(inputs, 'val') \
        == {'loss.val': 1.0, 'acc.top1.val': 0.5}


@pytest.mark.parametrize('tty', [False, True])
@pytest.mark.parametrize('kubernetes', [False, True])
def test_terminal_is_available_matches_jax(monkeypatch, tty, kubernetes):
    if kubernetes:
        monkeypatch.setenv('KUBERNETES_SERVICE_HOST', '10.0.0.1')
    else:
        for key in [k for k in list(os.environ)
                    if k.startswith('KUBERNETES')]:
            monkeypatch.delenv(key)
    stdout = io.StringIO()
    stdout.isatty = lambda: tty
    monkeypatch.setattr('sys.stdout', stdout)
    assert terminal_is_available() == jax_misc.terminal_is_available() \
        == (tty and not kubernetes)


@pytest.mark.parametrize('nesterov', [False, True])
def test_copy_of_sgd_is_sgd(nesterov):
    """Two steps of ``CopyOfSGD`` equal two of the port's SGD built from
    a config (the reference's clone of SGD under another name)."""
    rng = np.random.RandomState(3)
    start, grads = rng.randn(4, 3), [rng.randn(4, 3) for _ in range(2)]
    params = [torch.tensor(start, requires_grad=True) for _ in range(2)]
    optimizers = [
        CopyOfSGD([params[0]], 0.05, momentum=0.9, weight_decay=1e-3,
                  nesterov=nesterov),
        build_optimizer([params[1]], dict(type='SGD', lr=0.05, momentum=0.9,
                                          weight_decay=1e-3,
                                          nesterov=nesterov))[0]]
    for g in grads:
        for p, opt in zip(params, optimizers):
            p.grad = torch.from_numpy(g)
            opt.step()
    assert not torch.equal(params[0], torch.from_numpy(start))
    assert torch.equal(params[0], params[1])


def test_version_matches_jax():
    assert __version__ == vfs_tpu_torch.__version__ == vfs_tpu.__version__
