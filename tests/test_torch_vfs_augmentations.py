"""The eight VFS host augmentations of ROADMAP item 7c in vfs_tpu_torch
against the JAX package's on the CPU: ``RGB2LAB``,
``PhotoMetricDistortion``, ``RandomErasing``, ``Grid``, ``Image2Patch``,
``HidePatch``, ``RandomAffine`` and ``RandomChoiceRotate``
(``vfs_tpu/datasets/pipelines/augmentations.py:524-752``).

Each step is built from the same config through each package's
``Compose``, given the same frames, and run after the same
``np.random.seed``: the outputs must be equal (they draw from ``np.random``
in the JAX package's order; host numpy and cv2 on both sides). The
per-frame gates of ``RandomAffine`` and ``RandomChoiceRotate``
(``same_on_clip`` / ``same_across_clip``) are the port's
``_should_generate_new``. Every transform that the JAX test suite lists
from the reference's registry (``tests/test_config.py``) resolves in the
port's ``PIPELINES``; ``DeviceAugChain`` keeps refusing ``RandomErasing``,
a host step (``tests/test_torch_device_aug.py``).
"""

import numpy as np
import pytest
import torch

from vfs_tpu.datasets.pipelines import Compose as JaxCompose
from vfs_tpu_torch.datasets.pipelines import Compose
from vfs_tpu_torch.datasets.registry import PIPELINES

torch.set_num_threads(1)

# the reference's pipeline exports, as tests/test_config.py freezes them
REFERENCE_TRANSFORMS = [
    'AppendFrames', 'CenterCrop', 'Clip2Frame', 'Collect', 'ColorJitter',
    'Compose', 'DecordDecode', 'DecordInit', 'DenseSampleFrames',
    'DuplicateFrames', 'Flip', 'FormatShape', 'Frame2Clip', 'FrameSelector',
    'Fuse', 'GenerateLocalizationLabels', 'Grid', 'HidePatch', 'Image2Patch',
    'ImageToTensor', 'LoadLocalizationFeature', 'LoadProposals',
    'MultiGroupCrop', 'MultiScaleCrop', 'Normalize', 'OpenCVDecode',
    'OpenCVInit', 'PhotoMetricDistortion', 'PyAVDecode', 'PyAVInit',
    'RGB2LAB', 'RandomAffine', 'RandomChoiceRotate', 'RandomCrop',
    'RandomErasing', 'RandomGaussianBlur', 'RandomGrayScale',
    'RandomResizedCrop', 'RawFrameDecode', 'RawImageDecode', 'Resize',
    'SampleFrames', 'SampleProposalFrames', 'SequentialSampleFrames',
    'TenCrop', 'ThreeCrop', 'ToDataContainer', 'ToTensor', 'Transpose',
    'UntrimmedSampleFrames']

STEPS = [
    dict(type='RGB2LAB'),
    dict(type='PhotoMetricDistortion'),
    dict(type='PhotoMetricDistortion', brightness_delta=8,
         contrast_range=(0.8, 1.2), saturation_range=(0.7, 1.3),
         hue_delta=5),
    dict(type='RandomErasing', p=0.8),
    dict(type='RandomErasing', p=1.0, area_range=(0.1, 0.2), fill=128),
    dict(type='Grid'),
    dict(type='Grid', normalize=True),
    dict(type='Image2Patch', patch_size=8),
    dict(type='Image2Patch', patch_size=8, stride=4),
    dict(type='HidePatch', patch_size=4, hide_prob=0.4),
    dict(type='HidePatch', patch_size=[0, 4, 8], hide_prob=0.5),
    dict(type='RandomAffine'),
    dict(type='RandomAffine', degrees=30, same_on_clip=False),
    dict(type='RandomAffine', same_across_clip=False),
    dict(type='RandomChoiceRotate', p=0.7),
    dict(type='RandomChoiceRotate', p=0.9, same_on_clip=False),
    dict(type='RandomChoiceRotate', p=1.0, degrees=(90, 270),
         same_across_clip=False),
]


def _results(seed):
    """Two clips of three 20x24 frames, with the keys the steps read."""
    rng = np.random.RandomState(seed)
    imgs = [rng.randint(0, 256, (20, 24, 3)).astype(np.uint8)
            for _ in range(6)]
    return dict(imgs=imgs, img_shape=(20, 24), original_shape=(20, 24),
                clip_len=3, num_clips=2)


def _equal(a, b):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize('seed', [0, 7])
@pytest.mark.parametrize('step', STEPS, ids=[
    f'{s["type"]}-{i}' for i, s in enumerate(STEPS)])
def test_step_matches_jax(step, seed):
    outs = []
    for compose in (JaxCompose, Compose):
        np.random.seed(seed)
        results = compose([dict(step)])(_results(seed))
        outs.append((results, np.random.randint(1 << 30)))
    (ref, ref_next), (out, out_next) = outs
    assert ref_next == out_next  # the same draws, in the same number
    assert sorted(ref) == sorted(out)
    for key in ref:
        assert _equal(ref[key], out[key]), key


def test_steps_change_their_frames():
    """The random steps draw: over the two clips some frame changes, and
    the per-frame gates give frames of one clip different parameters."""
    np.random.seed(3)
    out = Compose([dict(type='RandomChoiceRotate', p=0.9,
                        same_on_clip=False)])(_results(3))
    assert len(set(out['rotation_labels'].tolist())) > 1
    np.random.seed(3)
    base = _results(3)
    out = Compose([dict(type='RandomErasing', p=1.0)])(_results(3))
    assert not any(np.array_equal(a, b)
                   for a, b in zip(out['imgs'], base['imgs']))
    out = Compose([dict(type='Image2Patch', patch_size=8)])(_results(3))
    assert out['num_clips'] == 2 * 2 * 3 and len(out['imgs']) == 36


def test_reference_transforms_resolve_in_the_port():
    missing = [n for n in REFERENCE_TRANSFORMS
               if n != 'Compose' and PIPELINES.get(n) is None]
    assert not missing, missing


def test_device_aug_chain_still_refuses_random_erasing():
    """``RandomErasing`` is a host step: ``build_device_aug`` refuses
    it, as the JAX package's does, now that the host step exists."""
    from vfs_tpu_torch.ops.device_aug import build_device_aug
    assert PIPELINES.get('RandomErasing') is not None
    with pytest.raises(ValueError, match='RandomErasing'):
        build_device_aug([dict(type='RandomErasing')],
                         dict(mean=[0.0] * 3, std=[1.0] * 3))
