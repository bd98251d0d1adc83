"""Rawframe-tree scanning (counterpart of ``parse_directory`` in
``tools/data/file_lists.py``; reference:
tools/data/parse_file_list.py:10-82). Standard library only."""

from __future__ import annotations

import fnmatch
import glob
import os
import os.path as osp


def parse_directory(path, rgb_prefix='img_', flow_x_prefix='flow_x_',
                    flow_y_prefix='flow_y_', level=1):
    """Scan a rawframes tree: ``{video_id: (dir, num_rgb, num_flow)}``.

    Counts files by prefix; level 1 = flat dirs, level 2 = class/video
    dirs; raises when the x/y flow counts disagree.
    """
    assert level in (1, 2), 'level must be 1 or 2'
    pattern = osp.join(path, *(['*'] * level))
    info = {}
    for frame_dir in sorted(glob.glob(pattern)):
        if not osp.isdir(frame_dir):
            continue
        names = os.listdir(frame_dir)
        n_rgb = len(fnmatch.filter(names, rgb_prefix + '*'))
        n_x = len(fnmatch.filter(names, flow_x_prefix + '*'))
        n_y = len(fnmatch.filter(names, flow_y_prefix + '*'))
        if n_x != n_y:
            raise ValueError(
                f'flow x/y counts differ ({n_x} vs {n_y}) in {frame_dir}')
        vid = osp.relpath(frame_dir, path)
        info[vid] = (frame_dir, n_rgb, n_x)
    return info
