"""BSN proposal-generation utilities (host-side numpy; counterpart of
``vfs_tpu/localization/bsn_utils.py``).

Reference: mmaction/localization/bsn_utils.py:8-267. Pure numeric host
plumbing between the TEM and PEM stages: peak-picking candidate proposals
from TEM start/end curves, and boundary-sensitive proposal (BSP) features
by interpolated actionness sampling.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from .proposal_utils import temporal_iop, temporal_iou


def generate_candidate_proposals(video_list, video_infos, tem_results_dir,
                                 temporal_scale, peak_threshold,
                                 tem_results_ext='.csv', result_dict=None):
    """Peak-pick start/end candidates and pair them into proposals with
    tmin,tmax,tmin_score,tmax_score,score,match_iou,match_ioa rows."""
    if tem_results_ext != '.csv':
        raise NotImplementedError
    tscale = temporal_scale
    tgap = 1.0 / tscale
    proposal_dict = {}
    for video_index in video_list:
        video_info = video_infos[video_index]
        video_name = video_info['video_name']
        tem_results = np.loadtxt(
            osp.join(tem_results_dir, video_name + tem_results_ext),
            dtype=np.float32, delimiter=',', skiprows=1)
        start_scores = tem_results[:, 1]
        end_scores = tem_results[:, 2]
        max_start = start_scores.max()
        max_end = end_scores.max()
        start_bins = np.zeros(len(start_scores))
        start_bins[[0, -1]] = 1
        end_bins = np.zeros(len(end_scores))
        end_bins[[0, -1]] = 1
        for idx in range(1, tscale - 1):
            if (start_scores[idx] > start_scores[idx + 1]
                    and start_scores[idx] > start_scores[idx - 1]):
                start_bins[idx] = 1
            elif start_scores[idx] > peak_threshold * max_start:
                start_bins[idx] = 1
            if (end_scores[idx] > end_scores[idx + 1]
                    and end_scores[idx] > end_scores[idx - 1]):
                end_bins[idx] = 1
            elif end_scores[idx] > peak_threshold * max_end:
                end_bins[idx] = 1
        tmins, tmin_scores, tmaxs, tmax_scores = [], [], [], []
        for idx in range(tscale):
            if start_bins[idx] == 1:
                tmins.append(tgap / 2 + tgap * idx)
                tmin_scores.append(start_scores[idx])
            if end_bins[idx] == 1:
                tmaxs.append(tgap / 2 + tgap * idx)
                tmax_scores.append(end_scores[idx])
        new_props = []
        for tmax, tmax_score in zip(tmaxs, tmax_scores):
            for tmin, tmin_score in zip(tmins, tmin_scores):
                if tmin >= tmax:
                    break
                new_props.append([tmin, tmax, tmin_score, tmax_score])
        new_props = np.stack(new_props)
        score = (new_props[:, 2] * new_props[:, 3]).reshape(-1, 1)
        new_props = np.concatenate((new_props, score), axis=1)
        new_props = new_props[new_props[:, -1].argsort()[::-1]]
        corrected_second = (float(video_info['feature_frame']) /
                            video_info['duration_frame'] *
                            video_info['duration_second'])
        gt_tmins = [ann['segment'][0] / corrected_second
                    for ann in video_info['annotations']]
        gt_tmaxs = [ann['segment'][1] / corrected_second
                    for ann in video_info['annotations']]
        ious, ioas = [], []
        for prop in new_props:
            ious.append(max(temporal_iou(prop[0], prop[1],
                                         np.array(gt_tmins),
                                         np.array(gt_tmaxs))))
            ioas.append(max(temporal_iop(prop[0], prop[1],
                                         np.array(gt_tmins),
                                         np.array(gt_tmaxs))))
        new_props = np.concatenate(
            (new_props, np.array(ious).reshape(-1, 1),
             np.array(ioas).reshape(-1, 1)), axis=1)
        proposal_dict[video_name] = new_props
        if result_dict is not None:
            result_dict[video_name] = new_props
    return proposal_dict


def generate_bsp_feature(video_list, video_infos, tem_results_dir,
                         pgm_proposals_dir, top_k=1000,
                         bsp_boundary_ratio=0.2, num_sample_start=8,
                         num_sample_end=8, num_sample_action=16,
                         num_sample_interp=3, tem_results_ext='.csv',
                         pgm_proposal_ext='.csv', result_dict=None):
    """Boundary-sensitive proposal features: interpolated actionness
    samples over start / action / end regions of each proposal."""
    if tem_results_ext != '.csv' or pgm_proposal_ext != '.csv':
        raise NotImplementedError
    bsp_feature_dict = {}

    def region_feature(t0, t1, num_sample, t_points, score_action):
        tlen = (t1 - t0) / (num_sample - 1)
        tlen_sample = tlen / num_sample_interp
        t_new = [t0 - tlen / 2 + tlen_sample * i
                 for i in range(num_sample * num_sample_interp + 1)]
        y_new = np.interp(t_new, t_points, score_action)
        return [np.mean(y_new[i * num_sample_interp:
                              (i + 1) * num_sample_interp + 1])
                for i in range(num_sample)]

    for video_index in video_list:
        video_name = video_infos[video_index]['video_name']
        tem_results = np.loadtxt(
            osp.join(tem_results_dir, video_name + tem_results_ext),
            dtype=np.float32, delimiter=',', skiprows=1)
        score_action = tem_results[:, 0]
        seg_tmins = tem_results[:, 3]
        seg_tmaxs = tem_results[:, 4]
        video_scale = len(tem_results)
        video_gap = seg_tmaxs[0] - seg_tmins[0]
        video_extend = int(video_scale / 4 + 10)
        pgm_proposals = np.loadtxt(
            osp.join(pgm_proposals_dir, video_name + pgm_proposal_ext),
            dtype=np.float32, delimiter=',', skiprows=1)[:top_k]
        boundary_zeros = np.zeros([video_extend])
        score_action = np.concatenate(
            (boundary_zeros, score_action, boundary_zeros))
        begin_tp = [-video_gap / 2 - (video_extend - 1 - i) * video_gap
                    for i in range(video_extend)]
        middle_tp = [video_gap / 2 + i * video_gap
                     for i in range(video_scale)]
        end_tp = [video_gap / 2 + seg_tmaxs[-1] + i * video_gap
                  for i in range(video_extend)]
        t_points = begin_tp + middle_tp + end_tp
        bsp_feature = []
        for prop in pgm_proposals:
            tmin, tmax = prop[0], prop[1]
            tlen = tmax - tmin
            y_start = region_feature(
                tmin - tlen * bsp_boundary_ratio,
                tmin + tlen * bsp_boundary_ratio, num_sample_start,
                t_points, score_action)
            y_end = region_feature(
                tmax - tlen * bsp_boundary_ratio,
                tmax + tlen * bsp_boundary_ratio, num_sample_end,
                t_points, score_action)
            y_action = region_feature(tmin, tmax, num_sample_action,
                                      t_points, score_action)
            bsp_feature.append(
                np.concatenate([y_action, y_start, y_end]))
        bsp_feature = np.array(bsp_feature)
        bsp_feature_dict[video_name] = bsp_feature
        if result_dict is not None:
            result_dict[video_name] = bsp_feature
    return bsp_feature_dict
