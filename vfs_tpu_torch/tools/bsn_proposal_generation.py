"""BSN's second stage: candidate proposals and BSP features from TEM's
result CSVs (counterpart of ``tools/bsn_proposal_generation.py``;
reference: tools/bsn_proposal_generation.py). Host-side numpy, no
device.

    python -m vfs_tpu_torch.tools.bsn_proposal_generation CONFIG \\
        [--mode train|test] [--num-workers 8]

Reads ``cfg.tem_results_dir/{video}.csv`` (columns action, start, end,
tmin, tmax) for the videos of ``cfg.data[mode].ann_file``; writes the
PGM proposals to ``cfg.pgm_proposals_dir`` and the BSP features to
``cfg.pgm_features_dir``, with the videos split into ``--num-workers``
chunks for each of the two stages, as the JAX tool splits them, over one
pool of as many processes (spawned, not forked: a forked child of a
threaded process can deadlock; started once for both stages).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import os.path as osp
from concurrent.futures import ProcessPoolExecutor
from typing import Optional, Sequence

import numpy as np

from ..localization.bsn_utils import (generate_bsp_feature,
                                      generate_candidate_proposals)
from ..utils import Config

PROPOSAL_HEADER = ('tmin,tmax,tmin_score,tmax_score,score,match_iou,'
                   'match_ioa')


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='BSN proposal generation')
    parser.add_argument('config')
    parser.add_argument('--mode', choices=['train', 'test'],
                        default='test')
    parser.add_argument('--num-workers', type=int, default=8)
    return parser.parse_args(argv)


def dump_results(result_dict, out_dir, header):
    os.makedirs(out_dir, exist_ok=True)
    for video_name, result in result_dict.items():
        np.savetxt(osp.join(out_dir, video_name + '.csv'), result,
                   header=header, delimiter=',', comments='')


def _run_pool(pool, target, chunks, args_of, kwargs):
    """``target`` over each chunk of videos in ``pool``; their result
    dicts merged. A worker's exception raises here."""
    results = {}
    for future in [pool.submit(target, *args_of(chunk), **kwargs)
                   for chunk in chunks]:
        results.update(future.result())
    return results


def main(argv: Optional[Sequence[str]] = None):
    """Generate; returns the number of videos."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    pgm_cfg = cfg.temporal_proposal_generation \
        if 'temporal_proposal_generation' in cfg else cfg.pgm_proposals_cfg
    # *_thread keys size the reference's worker pools, not the math
    feat_cfg = {k: v for k, v in dict(cfg.get('pgm_features_cfg', {})).items()
                if not k.endswith('_thread')}
    with open(cfg.data[args.mode].ann_file) as f:
        anno = json.load(f)
    video_infos = []
    for name, info in anno.items():
        info['video_name'] = name
        video_infos.append(info)

    n = len(video_infos)
    chunks = np.array_split(np.arange(n), max(1, min(args.num_workers, n)))
    with ProcessPoolExecutor(
            len(chunks),
            mp_context=multiprocessing.get_context('spawn')) as pool:
        proposals = _run_pool(
            pool, generate_candidate_proposals, chunks,
            lambda c: (list(c), video_infos, cfg.tem_results_dir,
                       pgm_cfg['temporal_scale'], pgm_cfg['peak_threshold']),
            {})
        dump_results(proposals, cfg.pgm_proposals_dir, PROPOSAL_HEADER)
        print(f'proposals written to {cfg.pgm_proposals_dir}')

        features = _run_pool(
            pool, generate_bsp_feature, chunks,
            lambda c: (list(c), video_infos, cfg.tem_results_dir,
                       cfg.pgm_proposals_dir), feat_cfg)
    os.makedirs(cfg.pgm_features_dir, exist_ok=True)
    for video_name, feature in features.items():
        np.save(osp.join(cfg.pgm_features_dir, video_name + '.npy'),
                feature)
    print(f'BSP features written to {cfg.pgm_features_dir}')
    return n


if __name__ == '__main__':
    main()
