"""The port's temporal-localization host code against the JAX package's:
the proposal utilities, the proposal metrics, the four localization
pipeline steps, ``ActivityNetDataset`` and ``SSNDataset``, BSN's proposal
generation and the two host tools (``bsn_proposal_generation``,
``denormalize_proposal_file``). Everything here is host numpy in both
packages, so every comparison is exact. The random steps (SSN's sampling,
``SampleProposalFrames``) draw the JAX package's global numpy stream in
the port from an explicit ``np.random.RandomState`` seeded alike.

The fixtures are the JAX tests' (``make_activitynet``,
``make_pgm_fixture``, ``make_proposal_file``), at T=20 and 8 features;
``make_tem_results`` writes TEM result CSVs as TEM's inference dumps
them.
"""

import copy
import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

import vfs_tpu.localization as jax_loc
from vfs_tpu.core.evaluation import proposal as jax_proposal
from vfs_tpu.datasets import build_dataset as jax_build_dataset
from vfs_tpu.datasets.pipelines import loading as jax_loading
from vfs_tpu_torch import localization as loc
from vfs_tpu_torch.core.evaluation import proposal
from vfs_tpu_torch.datasets import build_dataset
from vfs_tpu_torch.datasets.pipelines import loading

from test_core.test_localization_train import (FEAT_DIM, T_SCALE,
                                               make_activitynet,
                                               make_pgm_fixture)
from test_data.test_ssn import TEST_CFG, TRAIN_CFG, make_proposal_file

torch.set_num_threads(1)


def equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def make_tem_results(root, names, tscale=T_SCALE, seed=3):
    """TEM result CSVs (action, start, end, tmin, tmax) as
    ``ActivityNetDataset.dump_results(..., 'csv')`` writes them: smooth
    curves with a few peaks, so that the peak picking keeps some
    positions and drops others."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    t = np.arange(tscale)
    for name in names:
        curves = [np.clip(0.2 + 0.6 * np.exp(-(t - c)**2 / 4.0)
                          + 0.05 * rng.rand(tscale), 0, 1)
                  for c in rng.randint(2, tscale - 2, size=3)]
        tmin = t / tscale
        rows = np.stack([*curves, tmin, tmin + 1.0 / tscale], axis=1)
        np.savetxt(osp.join(root, name + '.csv'), rows,
                   header='action,start,end,tmin,tmax', delimiter=',',
                   comments='')
    return root


# ------------------------------------------------------------- utilities

def test_temporal_iou_iop_soft_nms_post_processing_equal_jax():
    rng = np.random.RandomState(0)
    starts = rng.rand(40)
    ends = starts + rng.rand(40) * 0.5
    for fn in ('temporal_iou', 'temporal_iop'):
        equal(getattr(loc, fn)(starts, ends, 0.3, 0.6),
              getattr(jax_loc, fn)(starts, ends, 0.3, 0.6))
    props = np.stack([starts, ends, rng.rand(40)], axis=1)
    for args in ((0.4, 0.5, 0.9, 20), (0.75, 0.0, 0.0, 100)):
        equal(loc.soft_nms(props, *args), jax_loc.soft_nms(props, *args))
    info = dict(duration_frame=3001, duration_second=100.1)
    assert loc.post_processing(props, info, 0.4, 0.5, 0.9, 10) == \
        jax_loc.post_processing(props, info, 0.4, 0.5, 0.9, 10)


def test_pairwise_iou_and_average_recall_equal_jax():
    rng = np.random.RandomState(1)
    gt, props = {}, {}
    for i in range(3):
        s = rng.rand(2) * 50
        gt[f'v{i}'] = np.stack([s, s + 20, np.zeros(2)], axis=1)
        p = rng.rand(30) * 60
        props[f'v{i}'] = np.stack([p, p + rng.rand(30) * 30,
                                   rng.rand(30)], axis=1)
    equal(proposal.pairwise_temporal_iou(props['v0'][:, :2],
                                         gt['v0'][:, :2]),
          jax_proposal.pairwise_temporal_iou(props['v0'][:, :2],
                                             gt['v0'][:, :2]))
    for max_avg in (None, 10):
        ours = proposal.average_recall_at_avg_proposals(
            gt, props, 90, max_avg_proposals=max_avg)
        ref = jax_proposal.average_recall_at_avg_proposals(
            gt, props, 90, max_avg_proposals=max_avg)
        for a, b in zip(ours, ref):
            equal(a, b)
    assert proposal.get_weighted_score is \
        __import__('vfs_tpu_torch.core.evaluation.accuracy',
                   fromlist=['x']).get_weighted_score


def test_temporal_nms_perform_regression_eval_ap_equal_jax():
    rng = np.random.RandomState(2)
    dets = np.concatenate([np.sort(rng.rand(25, 2), axis=1),
                           rng.rand(25, 1), rng.randn(25, 2) * 0.1], axis=1)
    for thr in (0.2, 0.5):
        equal(loc.temporal_nms(dets, thr), jax_loc.temporal_nms(dets, thr))
    equal(loc.perform_regression(dets), jax_loc.perform_regression(dets))
    gts = {c: {f'v{i}': np.sort(rng.rand(2, 2), axis=1).tolist()
               for i in range(3)} for c in range(2)}
    preds = {c: [[f'v{rng.randint(3)}', c, *np.sort(rng.rand(2)),
                  rng.rand()] for _ in range(12)] for c in range(2)}
    iou_range = np.arange(0.1, 1.0, 0.1)
    equal(loc.eval_ap(preds, gts, iou_range),
          jax_loc.eval_ap(preds, gts, iou_range))


def test_load_localize_proposal_file_equals_jax(tmp_path):
    path = str(tmp_path / 'proposals.txt')
    make_proposal_file(path)
    assert loc.load_localize_proposal_file(path) == \
        jax_loc.load_localize_proposal_file(path)


# ------------------------------------------------------- pipeline steps

def _anet(root):
    ann = make_activitynet(str(root))
    with open(ann) as f:
        infos = json.load(f)
    return ann, [dict(info, video_name=name, data_prefix=str(root))
                 for name, info in infos.items()]


def test_feature_and_label_steps_equal_jax(tmp_path):
    _, infos = _anet(tmp_path)
    for info in infos:
        ours = loading.GenerateLocalizationLabels()(
            loading.LoadLocalizationFeature()(copy.deepcopy(info)))
        ref = jax_loading.GenerateLocalizationLabels()(
            jax_loading.LoadLocalizationFeature()(copy.deepcopy(info)))
        assert ours['raw_feature'].shape == (FEAT_DIM, T_SCALE)
        equal(ours['raw_feature'], ref['raw_feature'])
        equal(ours['gt_bbox'], ref['gt_bbox'])


def test_load_proposals_equals_jax(tmp_path):
    _, infos = _anet(tmp_path)
    pdir, fdir = make_pgm_fixture(str(tmp_path))
    for top_k in (5, 16):
        ours = loading.LoadProposals(top_k, pdir, fdir)(
            copy.deepcopy(infos[0]))
        ref = jax_loading.LoadProposals(top_k, pdir, fdir)(
            copy.deepcopy(infos[0]))
        for key in ('bsp_feature', 'tmin', 'tmax', 'tmin_score',
                    'tmax_score', 'reference_temporal_iou'):
            equal(ours[key], ref[key])


@pytest.mark.parametrize('mode,jitter', [('train', False), ('train', True),
                                         ('val', False), ('test', False)])
def test_sample_proposal_frames_equals_jax(mode, jitter):
    from vfs_tpu.datasets.ssn_dataset import SSNInstance
    props = [(('v', SSNInstance(s, e, 300)), t) for s, e, t in (
        (30, 90, 0), (5, 40, 1), (250, 299, 2), (100, 103, 1))]
    results = dict(total_frames=300, start_index=1, out_proposals=props)
    kwargs = dict(clip_len=2, body_segments=5, aug_segments=(2, 2),
                  aug_ratio=(0.5, 0.3), frame_interval=2,
                  temporal_jitter=jitter, mode=mode)
    np.random.seed(7)
    ref = jax_loading.SampleProposalFrames(**kwargs)(dict(results))
    ours = loading.SampleProposalFrames(
        rng=np.random.RandomState(7), **kwargs)(dict(results))
    for key in ('frame_inds', 'clip_len', 'frame_interval', 'num_clips'):
        equal(ours[key], ref[key])
    assert ours.get('num_proposals') == ref.get('num_proposals')


# -------------------------------------------------------------- datasets

def test_activitynet_dataset_loads_dumps_and_evaluates_as_jax(tmp_path):
    ann, _ = _anet(tmp_path)
    cfg = dict(type='ActivityNetDataset', ann_file=ann,
               data_prefix=str(tmp_path), pipeline=[
                   dict(type='LoadLocalizationFeature'),
                   dict(type='GenerateLocalizationLabels')])
    ours, ref = build_dataset(cfg), jax_build_dataset(cfg)
    assert ours.video_infos == ref.video_infos
    for i in range(len(ours)):
        equal(ours[i]['raw_feature'], ref[i]['raw_feature'])
        equal(ours[i]['gt_bbox'], ref[i]['gt_bbox'])
    rng = np.random.RandomState(4)
    results = []
    for info in ours.video_infos:
        s = rng.rand(20) * 80
        results.append(dict(video_name=info['video_name'], proposal_list=[
            dict(score=float(sc), segment=[float(a), float(a + d)])
            for a, d, sc in zip(s, rng.rand(20) * 40, rng.rand(20))]))
    assert ours.evaluate(results) == ref.evaluate(results)
    ours.dump_results(results, str(tmp_path / 'a.json'))
    ref.dump_results(results, str(tmp_path / 'b.json'))
    assert (tmp_path / 'a.json').read_text() == \
        (tmp_path / 'b.json').read_text()
    tem = [(info['video_name'], rng.rand(T_SCALE, 5))
           for info in ours.video_infos]
    ours.dump_results(tem, str(tmp_path / 'csv_a'), 'csv')
    ref.dump_results(tem, str(tmp_path / 'csv_b'), 'csv')
    for name, _ in tem:
        assert (tmp_path / 'csv_a' / f'{name}.csv').read_text() == \
            (tmp_path / 'csv_b' / f'{name}.csv').read_text()


SSN_PIPELINE = [dict(type='SampleProposalFrames', clip_len=1,
                     body_segments=5, aug_segments=(2, 2), aug_ratio=0.5)]


def _ssn_datasets(tmp_path, pipeline=()):
    ann = str(tmp_path / 'proposals.txt')
    make_proposal_file(ann)
    cfg = dict(type='SSNDataset', ann_file=ann, pipeline=list(pipeline),
               train_cfg=TRAIN_CFG, test_cfg=TEST_CFG,
               data_prefix=str(tmp_path), body_segments=5,
               aug_segments=(2, 2), aug_ratio=0.5)
    return build_dataset(cfg), jax_build_dataset(cfg)


def _instances(pool):
    return [(vid, p.start_frame, p.end_frame, p.label, p.best_iou,
             p.overlap_self, list(p.regression_targets)) for vid, p in pool]


def test_ssn_dataset_pools_equal_jax(tmp_path):
    ours, ref = _ssn_datasets(tmp_path)
    for pool in ('positive_pool', 'incomplete_pool', 'background_pool'):
        assert _instances(getattr(ours, pool)) == \
            _instances(getattr(ref, pool))
    equal(ours.reg_norm_consts, ref.reg_norm_consts)
    assert (ours.positive_per_video, ours.incomplete_per_video,
            ours.background_per_video) == (ref.positive_per_video,
                                           ref.incomplete_per_video,
                                           ref.background_per_video)
    assert ours.get_all_gts() == ref.get_all_gts()


def test_ssn_prepare_train_frames_under_the_same_seed(tmp_path):
    """The proposal sampling and the frame offsets: the port's explicit
    stream (the dataset's and the step's one ``RandomState``) draws what
    the JAX package draws from the global one."""
    ours, ref = _ssn_datasets(tmp_path, SSN_PIPELINE)
    ours.rng = ours.pipeline.transforms[0].rng = np.random.RandomState(5)
    np.random.seed(5)
    for idx in (0, 1, 0):
        a, b = ours.prepare_train_frames(idx), ref.prepare_train_frames(idx)
        for key in ('frame_inds', 'reg_targets', 'proposal_scale_factor',
                    'proposal_labels', 'proposal_type'):
            equal(a[key], b[key])
        assert [(v, p.start_frame, p.end_frame, t)
                for (v, p), t in a['out_proposals']] == \
            [(v, p.start_frame, p.end_frame, t)
             for (v, p), t in b['out_proposals']]


def test_ssn_test_frames_and_evaluate_equal_jax(tmp_path):
    ours, ref = _ssn_datasets(tmp_path)
    for idx in range(len(ours)):
        a, b = ours.prepare_test_frames(idx), ref.prepare_test_frames(idx)
        for key in ('relative_proposal_list', 'scale_factor_list',
                    'proposal_tick_list', 'reg_norm_consts'):
            equal(a[key], b[key])
    rng = np.random.RandomState(6)
    results = []
    for vi in ours.video_infos:
        n = len(vi['proposals']) + 3
        rel = np.sort(rng.rand(n, 2), axis=1).astype(np.float32)
        results.append((rel, rng.randn(n, 4).astype(np.float32),
                        rng.randn(n, 3).astype(np.float32),
                        rng.randn(n, 3, 2).astype(np.float32) * 0.1))
    assert ours.evaluate(results) == ref.evaluate(results)


# ---------------------------------------------------------- BSN and tools

def test_bsn_proposals_and_bsp_features_equal_jax(tmp_path):
    _, infos = _anet(tmp_path)
    tem = make_tem_results(str(tmp_path / 'tem'),
                           [i['video_name'] for i in infos])
    videos = list(range(len(infos)))
    ours = loc.generate_candidate_proposals(videos, infos, tem, T_SCALE, 0.5)
    ref = jax_loc.generate_candidate_proposals(videos, infos, tem, T_SCALE,
                                               0.5)
    assert ours.keys() == ref.keys()
    pdir = tmp_path / 'pgm'
    pdir.mkdir()
    for name in ours:
        equal(ours[name], ref[name])
        np.savetxt(str(pdir / f'{name}.csv'), ours[name], delimiter=',',
                   header='h', comments='')
    kwargs = dict(top_k=12, num_sample_start=4, num_sample_end=4,
                  num_sample_action=8, num_sample_interp=3)
    ours = loc.generate_bsp_feature(videos, infos, tem, str(pdir), **kwargs)
    ref = jax_loc.generate_bsp_feature(videos, infos, tem, str(pdir),
                                       **kwargs)
    for name in ref:
        assert ours[name].shape == (min(12, len(ref[name])), 16)
        equal(ours[name], ref[name])


def test_bsn_proposal_generation_tool_writes_jax_results(tmp_path):
    """``tools.bsn_proposal_generation`` over two worker processes writes
    the JAX package's proposals and features."""
    from vfs_tpu_torch.tools import bsn_proposal_generation
    ann, infos = _anet(tmp_path)
    tem = make_tem_results(str(tmp_path / 'tem'),
                           [i['video_name'] for i in infos])
    config = tmp_path / 'bsn.py'
    config.write_text('\n'.join([
        f"tem_results_dir = {tem!r}",
        f"pgm_proposals_dir = {str(tmp_path / 'pgm')!r}",
        f"pgm_features_dir = {str(tmp_path / 'feat')!r}",
        'temporal_proposal_generation = dict(temporal_scale=20, '
        'peak_threshold=0.5)',
        'pgm_features_cfg = dict(top_k=10, num_sample_start=4, '
        'num_sample_end=4, num_sample_action=8, num_sample_interp=3, '
        'bsp_boundary_ratio=0.2, feature_extraction_thread=8)',
        f"data = dict(train=dict(ann_file={ann!r}))", '']))
    assert bsn_proposal_generation.main(
        [str(config), '--mode', 'train', '--num-workers', '2']) == len(infos)
    videos = list(range(len(infos)))
    ref = jax_loc.generate_candidate_proposals(videos, infos, tem, 20, 0.5)
    for name, rows in ref.items():
        written = np.loadtxt(str(tmp_path / 'pgm' / f'{name}.csv'),
                             delimiter=',', skiprows=1)
        np.testing.assert_allclose(written, rows, rtol=1e-15)
    feats = jax_loc.generate_bsp_feature(
        videos, infos, tem, str(tmp_path / 'pgm'), top_k=10,
        num_sample_start=4, num_sample_end=4, num_sample_action=8,
        num_sample_interp=3)
    for name, feat in feats.items():
        equal(np.load(str(tmp_path / 'feat' / f'{name}.npy')), feat)


def test_denormalize_proposal_file_equals_jax(tmp_path):
    from tools.data.denormalize_proposal_file import denormalize as jax_den
    from tools.data.file_lists import parse_directory as jax_parse
    from vfs_tpu_torch.tools.data import denormalize_proposal_file as den
    from vfs_tpu_torch.tools.data.file_lists import parse_directory
    from test_data.test_data_tools import make_rawframes
    frames = tmp_path / 'rawframes'
    make_rawframes(str(frames), ['video_x', 'video_y'], n_frames=100)
    norm = tmp_path / 'normalized_props.txt'
    norm.write_text('# 0\nvideo_x\n1\n1\n1\n3 0.25 0.75\n2\n'
                    '3 0.9000 0.8000 0.2 0.5\n0 0.1 0.2 0.6 0.95\n'
                    '# 1\nvideo_y\n1\n1\n1\n1 0.1 0.3\n0\n')
    assert parse_directory(str(frames)) == jax_parse(str(frames))
    ref = jax_den(str(norm), jax_parse(str(frames)),
                  out_file=str(tmp_path / 'ref.txt'))
    out = den.main(['thumos14', '--norm-proposal-file', str(norm),
                    '--data-prefix', str(frames)])
    assert out == str(tmp_path / 'props.txt')
    assert open(out).read() == open(ref).read()
