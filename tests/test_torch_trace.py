"""The program's tracer (``vfs_tpu_torch.utils.trace``) on the CPU:

- off: a span records nothing and is the same null context every time;
- on: nesting, parents, keys (given or inherited), threads, counters, and
  one recording at a time;
- ``single_process_test`` over two videos: ``test.decode`` and
  ``test.preload`` on the prefetch thread, ``test.wait_input``,
  ``test.video``, ``tracker.*`` and ``propagation.*`` on the caller's,
  keyed by the video;
- ``make_train_step`` with and without a ``DeviceAugChain``: ``train.*``
  and ``aug.*`` in order, keyed by the optimizer's update count.
"""

import threading

import numpy as np
import pytest
import torch

from vfs_tpu_torch.apis import single_process_test
from vfs_tpu_torch.apis.train import make_train_step
from vfs_tpu_torch.core.optimizer import build_optimizer
from vfs_tpu_torch.datasets import build_dataset
from vfs_tpu_torch.models import build_model
from vfs_tpu_torch.ops.device_aug import build_device_aug
from vfs_tpu_torch.utils import trace

from test_data.test_davis_e2e import VAL_PIPELINE, make_mini_davis
from test_torch_train_step import MODEL_CFG, NORM, TRAIN_CFG, train_batch

torch.set_num_threads(1)

TEST_CFG = dict(precede_frames=3, topk=5, temperature=0.07,
                strides=(1, 2, 1, 1), out_indices=(2,), neighbor_range=12,
                batch_step=3)


def test_off_records_nothing_and_allocates_no_context():
    first = trace.span('a')
    assert trace.span('b', key=3) is first
    with first:
        trace.count('c')
    with trace.recording() as rec:
        pass
    assert rec.spans == [] and rec.counts == {}
    assert trace.span('a') is first


def test_nesting_parent_key_thread_and_counters():
    with trace.recording() as rec:
        with trace.span('outer', key=7):
            with trace.span('inner'):
                trace.count('n')
                trace.count('n', 2)
            with trace.span('other', key=8):
                pass

        def worker():
            with trace.span('thread'):
                trace.count('n')
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ['inner', 'other', 'outer',
                                           'thread']
    outer = by['outer']
    assert outer.parent is None and outer.key == 7
    assert by['inner'].parent == outer.id and by['inner'].key == 7
    assert by['other'].parent == outer.id and by['other'].key == 8
    assert by['thread'].parent is None and by['thread'].key is None
    assert by['thread'].thread != outer.thread == threading.get_ident()
    assert outer.start_ns <= by['inner'].start_ns <= by['inner'].end_ns \
        <= by['other'].start_ns <= outer.end_ns
    assert rec.counts == {'n': 4}


def test_one_recording_at_a_time():
    with trace.recording():
        with pytest.raises(RuntimeError, match='already open'):
            with trace.recording():
                pass
    with trace.recording() as rec:
        with trace.span('again'):
            pass
    assert [s.name for s in rec.spans] == ['again']


def test_counters_from_many_threads():
    def worker():
        for _ in range(500):
            trace.count('hits')
    with trace.recording() as rec:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert rec.counts == {'hits': 4000}


@pytest.fixture(scope='module')
def two_videos(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('davis'))
    ann, img_root, ann_root = make_mini_davis(root, num_videos=2,
                                              num_frames=5)
    dataset = build_dataset(dict(
        type='DavisDataset', ann_file=ann, data_prefix=img_root,
        anno_prefix=ann_root, data_root=root, pipeline=VAL_PIPELINE,
        test_mode=True), dict(test_mode=True))
    model = build_model(dict(type='VanillaTracker', backbone=dict(
        type='ResNet', depth=18, pretrained=None)), test_cfg=TEST_CFG)
    model.init_weights(torch.Generator().manual_seed(0))
    return model, dataset


def test_eval_loop_spans_by_thread_and_video(two_videos):
    model, dataset = two_videos
    off = single_process_test(model, dataset, device='cpu')
    with trace.recording() as rec:
        on = single_process_test(model, dataset, device='cpu')
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    main = threading.get_ident()
    by_thread = {}
    for s in rec.spans:
        by_thread.setdefault(s.thread == main, set()).add(s.name)
    assert by_thread[False] == {'test.decode', 'test.preload'}
    assert by_thread[True] == {
        'test.wait_input', 'test.video', 'tracker.extract',
        'tracker.labels', 'tracker.propagate', 'tracker.readback',
        'propagation.affinity', 'propagation.labels'}
    ids = {s.id: s for s in rec.spans}
    for video in (0, 1):
        names = [s.name for s in sorted(rec.spans, key=lambda s: s.start_ns)
                 if s.key == video and s.thread == main]
        assert names == [
            'test.wait_input', 'test.video', 'tracker.extract',
            'tracker.labels', 'tracker.propagate', 'propagation.affinity',
            'propagation.labels', 'tracker.readback']
        assert sum(s.key == video for s in rec.spans
                   if s.thread != main) == 2
    for s in rec.spans:
        if s.name.startswith('propagation.'):
            assert ids[s.parent].name == 'tracker.propagate'
        elif s.name.startswith('tracker.'):
            assert ids[s.parent].name == 'test.video'
    assert rec.counts == {'tracker.blocks': 2}


def _train_parts(device_aug):
    torch.manual_seed(0)
    model = build_model(dict(MODEL_CFG), train_cfg=dict(TRAIN_CFG))
    model.train()
    optimizer, _ = build_optimizer(model.parameters(), dict(
        type='SGD', lr=0.05, momentum=0.9, weight_decay=1e-4), dict(
            policy='CosineAnnealing', min_lr=0, by_epoch=False), 10, 5)
    chain = None
    if device_aug:
        chain = build_device_aug([
            dict(type='RandomResizedCrop', area_range=(0.2, 1.0)),
            dict(type='Resize', scale=(32, 32), keep_ratio=False),
            dict(type='Flip', flip_ratio=0.5),
            dict(type='ColorJitter', brightness=0.4, contrast=0.4,
                 saturation=0.4, hue=0.1, p=0.8),
            dict(type='RandomGrayScale', p=0.2),
            dict(type='RandomGaussianBlur', p=0.5)], NORM)
    return model, optimizer, chain


@pytest.mark.parametrize('device_aug', [False, True],
                         ids=['plain', 'device_aug'])
def test_train_step_spans_in_order_by_update(device_aug):
    model, optimizer, chain = _train_parts(device_aug)
    step = make_train_step(model, optimizer, device_aug=chain)
    if device_aug:
        rs = np.random.RandomState(0)
        batch = dict(imgs=torch.from_numpy(rs.randint(
            0, 256, (2, 2, 2, 40, 48, 3)).astype(np.uint8)),
            orig_hw=torch.tensor([[60, 72], [40, 48]]))
    else:
        batch = dict(imgs=torch.from_numpy(train_batch(0, t=2)))
    step(**batch)
    with trace.recording() as rec:
        for _ in range(2):
            assert torch.isfinite(step(**batch)['loss'])
    aug = ['aug.draw', 'aug.RandomResizedCrop', 'aug.Flip',
           'aug.ColorJitter', 'aug.RandomGrayScale',
           'aug.RandomGaussianBlur', 'aug.normalise']
    want = ['train.step', 'train.h2d'] + (
        ['train.device_aug'] + aug if device_aug else []) + [
        'train.forward', 'train.backward', 'train.optimizer']
    ids = {s.id: s for s in rec.spans}
    for count in (1, 2):
        spans = sorted((s for s in rec.spans if s.key == count),
                       key=lambda s: s.start_ns)
        assert [s.name for s in spans] == want
        top = spans[0]
        for s in spans[1:]:
            parent = ids[s.parent]
            assert parent.name == ('train.device_aug' if s.name in aug
                                   else 'train.step')
            assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
    assert optimizer.count == 3
