"""Host-side image ops for SiamFC (copy of ``siamfc_tpu/ops.py``;
reference: projects/siamfc-pytorch/siamfc/ops.py:87-124, image crop
helpers)."""

from __future__ import annotations

import cv2
import numpy as np


def read_image(img_file, cvt_code=cv2.COLOR_BGR2RGB):
    img = cv2.imread(img_file, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f'cannot read image {img_file}')
    if cvt_code is not None:
        img = cv2.cvtColor(img, cvt_code)
    return img


def crop_and_resize(img, center, size, out_size,
                    border_type=cv2.BORDER_CONSTANT,
                    border_value=(0, 0, 0),
                    interp=cv2.INTER_LINEAR):
    """Square crop centered at ``center`` (y, x) of side ``size``, padded
    with ``border_value`` outside the image, resized to ``out_size``
    (reference ops.py crop_and_resize, non-'faster' branch — integer-rounded
    corners, the original SiamFC protocol)."""
    size = round(float(size))
    center = np.asarray(center, np.float32)
    corners = np.concatenate((np.round(center - (size - 1) / 2),
                              np.round(center - (size - 1) / 2) + size))
    corners = np.round(corners).astype(int)
    pads = np.concatenate((-corners[:2], corners[2:] - img.shape[:2]))
    npad = max(0, int(pads.max()))
    if npad > 0:
        img = cv2.copyMakeBorder(img, npad, npad, npad, npad, border_type,
                                 value=border_value)
    corners = (corners + npad).astype(int)
    patch = img[corners[0]:corners[2], corners[1]:corners[3]]
    patch = cv2.resize(patch, (out_size, out_size), interpolation=interp)
    return patch


def xywh_to_xyxy(box):
    cx, cy, w, h = box
    return np.array([cx - (w - 1) / 2, cy - (h - 1) / 2,
                     cx + (w - 1) / 2, cy + (h - 1) / 2])
