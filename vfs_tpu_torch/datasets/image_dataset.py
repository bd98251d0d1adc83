"""Still images as 1-frame videos (counterpart of
``vfs_tpu/datasets/image_dataset.py``; reference:
mmaction/datasets/image_dataset.py:11-57)."""

from __future__ import annotations

import os
import os.path as osp

from .registry import DATASETS
from .video_dataset import VideoDataset

IMG_EXTENSIONS = ('.jpg', '.jpeg', '.png', '.bmp', '.webp')


@DATASETS.register_module()
class ImageDataset(VideoDataset):
    """``ann_file`` lines ``image_path label``, or, when ``ann_file`` is a
    directory, one class a subdirectory (sorted; torchvision's
    ImageFolder layout) and the images in it."""

    def __init__(self, ann_file, pipeline, **kwargs):
        self._scan_root = ann_file if osp.isdir(ann_file) else None
        super().__init__(ann_file, pipeline, start_index=0, **kwargs)

    def load_annotations(self):
        if self._scan_root is None:
            return super().load_annotations()
        classes = sorted(d for d in os.listdir(self._scan_root)
                         if osp.isdir(osp.join(self._scan_root, d)))
        video_infos = []
        for label, cls in enumerate(classes):
            cls_dir = osp.join(self._scan_root, cls)
            for fname in sorted(os.listdir(cls_dir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    video_infos.append(dict(
                        filename=osp.join(cls_dir, fname), label=label))
        return video_infos
