"""vfs_tpu_torch and the SiamFC port (projects/siamfc/siamfc_tpu_torch,
train_siamfc_torch.py) stand alone: they import neither jax/flax/optax
nor vfs_tpu nor siamfc_tpu, their entry points never drop to the CPU
quietly, and importing the kernel module needs neither nvcc nor a GPU
(kernels build at their first CUDA call)."""

import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

import vfs_tpu_torch
from vfs_tpu_torch.ops import _build
from vfs_tpu_torch.ops.local_attention import (local_topk_attend_cuda,
                                               local_topk_attend_wide_cuda)
from vfs_tpu_torch.ops.local_attention_v2 import local_topk_attend_v2_cuda
from vfs_tpu_torch.ops.video_affinity import (video_topk_affinity_cuda,
                                              video_topk_affinity_wide_cuda)
from vfs_tpu_torch.ops.video_affinity_v1 import video_topk_affinity_v1_cuda

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))

_BLOCKED_IMPORT = r'''
import importlib.abc, pkgutil, sys

BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vfs_tpu',
           'siamfc_tpu')

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError(f'{name} is blocked in this test')
        return None

sys.meta_path.insert(0, Refuse())
import vfs_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vfs_tpu_torch.__path__,
                                                'vfs_tpu_torch.')]
for name in names:
    __import__(name)
# the slices' modules, the eval CLI among them, are all walked
for name in ('vfs_tpu_torch.tools.test', 'vfs_tpu_torch.apis.test',
             'vfs_tpu_torch.datasets.davis_dataset',
             'vfs_tpu_torch.datasets.pipelines.loading',
             'vfs_tpu_torch.utils.config', 'vfs_tpu_torch.ops.local_attention',
             'vfs_tpu_torch.ops.video_affinity_v1',
             'vfs_tpu_torch.ops.local_attention_v2',
             'vfs_tpu_torch.ops.window_geometry',
             'vfs_tpu_torch.datasets.jhmdb_dataset',
             'vfs_tpu_torch.datasets.vip_dataset',
             'vfs_tpu_torch.core.evaluation.accuracy',
             'vfs_tpu_torch.tools.train', 'vfs_tpu_torch.apis.train',
             'vfs_tpu_torch.models.common.norm',
             'vfs_tpu_torch.models.heads.sim_siam_head',
             'vfs_tpu_torch.models.losses.sim_loss',
             'vfs_tpu_torch.models.trackers.sim_siam_tracker',
             'vfs_tpu_torch.core.optimizer.builder',
             'vfs_tpu_torch.core.evaluation.eval_hooks',
             'vfs_tpu_torch.datasets.video_dataset',
             'vfs_tpu_torch.datasets.dataset_wrappers',
             'vfs_tpu_torch.datasets.builder',
             'vfs_tpu_torch.parallel.dist', 'vfs_tpu_torch.ops.device_aug',
             'vfs_tpu_torch.ops.attention',
             'vfs_tpu_torch.utils.wandb_logger',
             'vfs_tpu_torch.tools.learning_loop', 'vfs_tpu_torch.ops.yuv',
             'vfs_tpu_torch.tools.demo', 'vfs_tpu_torch.tools.publish_model',
             'vfs_tpu_torch.tools.convert_to_pretrained',
             'vfs_tpu_torch.tools.data.build_rawframes',
             'vfs_tpu_torch.datasets.native_loader',
             # slice 13: temporal action localization (ROADMAP item 7b)
             *(f'vfs_tpu_torch.localization.{m}' for m in (
                 'proposal_utils', 'bsn_utils', 'ssn_utils')),
             'vfs_tpu_torch.localization',
             'vfs_tpu_torch.core.evaluation.proposal',
             'vfs_tpu_torch.datasets.activitynet_dataset',
             'vfs_tpu_torch.datasets.ssn_dataset',
             'vfs_tpu_torch.models.losses.bmn_loss',
             'vfs_tpu_torch.models.losses.ssn_loss',
             'vfs_tpu_torch.models.heads.ssn_head',
             *(f'vfs_tpu_torch.models.localizers.{m}' for m in (
                 'bmn', 'bsn', 'ssn')),
             'vfs_tpu_torch.apis.train_localizer',
             'vfs_tpu_torch.tools.bsn_proposal_generation',
             *(f'vfs_tpu_torch.tools.data.{m}' for m in (
                 'denormalize_proposal_file', 'file_lists',
                 'tsn_feature_extraction')),
             # slice 14: the wide kernel's op, the last modules
             'vfs_tpu_torch.ops.local_attention_tiled',
             'vfs_tpu_torch.parallel.comm', 'vfs_tpu_torch.utils.zip_reader',
             'vfs_tpu_torch.version',
             *(f'vfs_tpu_torch.tools.analysis.{m}' for m in (
                 'bench_kernel', 'profile_kernel', 'bench_extract',
                 'benchmark', 'get_flops', 'bench_processing',
                 'bench_pretrain', 'bench_track', 'analyze_logs',
                 'common', 'fixtures'))):
    assert name in names, name
# the SiamFC port and its CLI are walked the same way
sys.path.insert(0, 'projects/siamfc')
import siamfc_tpu_torch
siamfc = [m.name for m in pkgutil.walk_packages(siamfc_tpu_torch.__path__,
                                                 'siamfc_tpu_torch.')]
for name in siamfc:
    __import__(name)
for name in ('checkpoint', 'datasets', 'default_config', 'device_crops',
             'fixtures', 'heads', 'losses', 'ops', 'otb', 'tracker'):
    assert f'siamfc_tpu_torch.{name}' in siamfc, name
import train_siamfc_torch
assert callable(train_siamfc_torch.main)
names += siamfc
import ab_eval, ab_kernels, chip_smoke, loader_probe, precision_probe
assert callable(chip_smoke.main) and callable(ab_eval.main)
assert callable(ab_kernels.main) and callable(loader_probe.main)
assert callable(precision_probe.main)
from vfs_tpu_torch.ops import _build
assert not _build._LIBS, 'a kernel was built at import'
leaked = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
'''


def test_imports_without_jax_or_reference_package():
    proc = subprocess.run([sys.executable, '-c', _BLOCKED_IMPORT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 67 + 9 + 13 + 19 + 4


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vfs_tpu_torch.resolve_device()
    from vfs_tpu_torch.models import build_model
    model = build_model(
        dict(type='VanillaTracker', backbone=dict(type='ResNet', depth=18)),
        test_cfg=dict(neighbor_range=6, strides=(1, 2, 1, 1),
                      out_indices=(2,)))
    imgs = np.zeros((2, 32, 32, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.forward_test(imgs, np.zeros((32, 32), np.int64),
                           [dict(original_shape=(32, 32))])
    assert vfs_tpu_torch.resolve_device('cpu') == torch.device('cpu')


CONFIG = osp.join(ROOT, 'configs', 'r18_nc_sgd_cos_100e_r2_1xNx8_k400.py')


@pytest.mark.parametrize('name,argv', [
    ('bench_kernel', []), ('profile_kernel', []), ('bench_extract', []),
    ('benchmark', [CONFIG, 'no_such.pth']), ('get_flops', [CONFIG]),
    ('bench_pretrain', [CONFIG]), ('bench_track', ['--root', 'no_such_dir']),
])
def test_analysis_clis_raise_without_gpu(name, argv, monkeypatch):
    """Each analysis CLI with a device runs on the card unless given
    ``--device cpu``; with no GPU it raises before any work."""
    import importlib
    cli = importlib.import_module(f'vfs_tpu_torch.tools.analysis.{name}')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    assert cli.parse_args(argv + ['--device', 'cpu']).device == 'cpu'


def test_siamfc_tracker_raises_without_gpu(monkeypatch):
    """``TrackerSiamFC`` and the SiamFC CLI take the card unless told
    ``device='cpu'``; with no GPU they raise, and never track on the CPU
    quietly."""
    sys.path.insert(0, osp.join(ROOT, 'projects', 'siamfc'))
    from siamfc_tpu_torch import TrackerSiamFC, default_cfg

    import train_siamfc_torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrackerSiamFC(dict(default_cfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_siamfc_torch.main([osp.join(
            ROOT, 'configs', 'r18_nc_sgd_cos_100e_r2_1xNx8_k400.py'),
            '--otb-root', osp.join(ROOT, 'no_such_dir')])
    assert TrackerSiamFC(dict(default_cfg), device='cpu').device == \
        torch.device('cpu')


def test_kernel_wrapper_refuses_cpu_tensors_without_building():
    feats = torch.zeros(3, 4, 5, 8)
    with pytest.raises(ValueError, match='CUDA tensor'):
        video_topk_affinity_cuda(feats, 3.0, 0.07, 4, 2)
    assert video_topk_affinity_cuda.launches == 0
    with pytest.raises(ValueError, match='CUDA tensors'):
        local_topk_attend_cuda(feats[0], feats, torch.zeros(3, 4, 5, 2),
                               torch.ones(3, dtype=torch.bool), 3.0, 0.07, 4)
    assert local_topk_attend_cuda.launches == 0
    with pytest.raises(ValueError, match='CUDA tensor'):
        video_topk_affinity_v1_cuda(feats, 3.0, 0.07, 4, 2,
                                    extract='perframe')
    assert video_topk_affinity_v1_cuda.launches == 0
    with pytest.raises(ValueError, match='CUDA tensors'):
        local_topk_attend_v2_cuda(feats[0], feats, torch.zeros(3, 4, 5, 2),
                                  torch.ones(3, dtype=torch.bool), 3.0, 0.07,
                                  4)
    assert local_topk_attend_v2_cuda.launches == 0
    # the wide kernel's ops, and the wrappers at sizes only it takes
    with pytest.raises(ValueError, match='CUDA tensor'):
        video_topk_affinity_wide_cuda(feats, 3.0, 0.07, 4, 2)
    with pytest.raises(ValueError, match='CUDA tensor'):
        video_topk_affinity_cuda(feats, 40.0, 0.07, 48, 2)
    with pytest.raises(ValueError, match='CUDA tensors'):
        local_topk_attend_wide_cuda(feats[0], feats, torch.zeros(3, 4, 5, 2),
                                    torch.ones(3, dtype=torch.bool), 3.0,
                                    0.07, 4)
    with pytest.raises(ValueError, match='CUDA tensors'):
        local_topk_attend_cuda(feats[0], feats, torch.zeros(3, 4, 5, 2),
                               torch.ones(3, dtype=torch.bool), 40.0, 0.07,
                               48)
    assert video_topk_affinity_wide_cuda.launches == 0
    assert local_topk_attend_wide_cuda.launches == 0
    assert video_topk_affinity_cuda.wide_launches == 0
    assert local_topk_attend_cuda.wide_launches == 0
    assert not _build._LIBS


def test_eval_loop_raises_for_later_slices():
    """Recognition metrics, refused before slice 12 ported them (ROADMAP
    Queue 1 item 7a), score a dataset's labels. The native decoders,
    refused before slice 11 ported them, build at their first decode:
    their steps construct without a compiler. Eval over several devices
    and processes, refused before slice 8 ported it, runs: on an empty
    dataset it returns nothing, after replicating the weights per device,
    without a process group."""
    from vfs_tpu_torch.apis import multi_process_test, single_process_test

    class Tracker:
        def distribute(self, devices):
            self.devices = list(devices)
            return self.devices

    tracker = Tracker()
    assert single_process_test(tracker, [], devices=['cpu', 'cpu']) == []
    assert tracker.devices == ['cpu', 'cpu']
    assert multi_process_test(tracker, [], device='cpu') == []
    from vfs_tpu_torch.datasets import VideoDataset
    from vfs_tpu_torch.datasets.pipelines import (RawFrameDecode,
                                                  RawFrameDecodeYUV420)
    for cls in (RawFrameDecode, RawFrameDecodeYUV420):
        assert cls(decoding_backend='native').decoding_backend == 'native'
    dataset = type('Labels', (), dict(video_infos=[dict(label=0),
                                                    dict(label=1)]))
    scores = [np.array([0.9, 0.1]), np.array([0.6, 0.4])]
    assert VideoDataset.evaluate(dataset, scores, topk=(1, 2)) == dict(
        top1_acc=0.5, top2_acc=1.0)
