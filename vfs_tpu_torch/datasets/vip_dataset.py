"""VIP human-part segmentation propagation dataset + mIoU evaluation
(counterpart of ``vfs_tpu/datasets/vip_dataset.py``).

Reference: mmaction/datasets/vip_dataset.py:17-184. Frames and
annotations are listed in sorted order; the first annotation is the
first-frame label map.
"""

from __future__ import annotations

import copy
import os
import os.path as osp

import numpy as np

from ..core.evaluation.accuracy import mean_iou
from ..utils import add_prefix, get_root_logger
from .davis_dataset import PALETTE
from .rawframe_dataset import RawframeDataset
from .registry import DATASETS


@DATASETS.register_module()
class VIPDataset(RawframeDataset):

    PALETTE = PALETTE
    CLASSES = [
        'background', 'hat', 'hair', 'sun-glasses', 'upper-clothes',
        'dress', 'coat', 'socks', 'pants', 'gloves', 'scarf', 'skirt',
        'torso-skin', 'face', 'right-arm', 'left-arm', 'right-leg',
        'left-leg', 'right-shoe', 'left-shoe'
    ]

    def __init__(self, ann_file, pipeline, data_prefix=None,
                 anno_prefix=None, test_mode=False, split='val',
                 data_root='data/vip'):
        assert split in ('train', 'val')
        self.split = split
        self.data_root = data_root
        self.anno_prefix = anno_prefix
        super().__init__(
            ann_file, pipeline, data_prefix, test_mode,
            filename_tmpl='{:012}.jpg', with_offset=False,
            multi_class=False, num_classes=None, start_index=0,
            modality='RGB')

    def prepare_test_frames(self, idx):
        results = copy.deepcopy(self.video_infos[idx])
        results['filename_tmpl'] = self.filename_tmpl
        results['modality'] = self.modality
        results['start_index'] = self.start_index
        ann_frame_dir = results['frame_dir'].replace(self.data_prefix,
                                                     self.anno_prefix)
        frame_list = sorted(os.listdir(results['frame_dir']))
        ann_list = sorted(os.listdir(ann_frame_dir))
        results['frame_list'] = frame_list
        results['seg_map'] = osp.join(ann_frame_dir, ann_list[0])
        return self.pipeline(results)

    def vip_evaluate(self, results, output_dir=None, logger=None):
        """mIoU, mAcc and aAcc over every frame of every video against the
        annotation PNGs; with ``output_dir``, the predictions are saved as
        palette PNGs under it."""
        from PIL import Image
        assert len(results) == len(self)
        preds, gts = [], []
        for vid_idx in range(len(results)):
            cur = results[vid_idx]
            if isinstance(cur, str):  # save_np spill path
                path = cur
                cur = np.load(path)
                os.remove(path)
            frame_dir = self.video_infos[vid_idx]['frame_dir']
            ann_frame_dir = frame_dir.replace(self.data_prefix,
                                              self.anno_prefix)
            ann_list = sorted(os.listdir(ann_frame_dir))
            frame_list = sorted(os.listdir(frame_dir))
            for img_idx in range(
                    self.video_infos[vid_idx]['total_frames']):
                preds.append(cur[img_idx].astype(np.uint8))
                gts.append(np.asarray(
                    Image.open(osp.join(ann_frame_dir,
                                        ann_list[img_idx]))))
                if output_dir is not None:
                    img = Image.fromarray(cur[img_idx].astype(np.uint8))
                    img.putpalette(np.asarray(self.PALETTE,
                                              np.uint8).ravel())
                    save_path = osp.join(
                        output_dir, osp.relpath(frame_dir,
                                                self.data_prefix),
                        frame_list[img_idx].replace('.jpg', '.png'))
                    os.makedirs(osp.dirname(save_path), exist_ok=True)
                    img.save(save_path)
        all_acc, acc, iou = mean_iou(preds, gts, len(self.CLASSES),
                                     ignore_index=255)
        eval_results = {
            'mIoU': float(np.nanmean(iou)),
            'mAcc': float(np.nanmean(acc)),
            'aAcc': float(all_acc),
        }
        log = get_root_logger() if logger is None else logger
        log.info(' '.join(f'{k}={v:.4f}' for k, v in eval_results.items()))
        return eval_results

    def evaluate(self, results, metrics='mIoU', output_dir=None,
                 logger=None):
        """Multi-feat results get ``feat_{i}.`` prefixes."""
        metrics = metrics if isinstance(metrics, (list, tuple)) else [metrics]
        for metric in metrics:
            if metric != 'mIoU':
                raise KeyError(f'metric {metric} is not supported')
        eval_results = {}
        is_multi = (isinstance(results[0], np.ndarray)
                    and results[0].ndim == 4) or isinstance(results[0], list)
        if is_multi:
            num_feats = len(results[0])
            for feat_idx in range(num_feats):
                cur = [r[feat_idx] for r in results]
                eval_results.update(add_prefix(
                    self.vip_evaluate(cur, output_dir, logger),
                    prefix=f'feat_{feat_idx}'))
        else:
            eval_results.update(
                self.vip_evaluate(results, output_dir, logger))
        copypaste = [f'{float(v) * 100:.2f}'
                     for k, v in eval_results.items() if 'mIoU' in k]
        get_root_logger().info(
            f'Results copypaste  {",".join(copypaste)}')
        return eval_results
