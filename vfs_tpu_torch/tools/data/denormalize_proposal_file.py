"""Denormalize an SSN/TAG proposal file: fractional start and end times
become frame indices against the extracted rawframes (counterpart of
``tools/data/denormalize_proposal_file.py``; reference:
tools/data/denormalize_proposal_file.py:1-82, the THUMOS14 step).

    python -m vfs_tpu_torch.tools.data.denormalize_proposal_file thumos14 \\
        --norm-proposal-file PROPOSALS_normalized_....txt \\
        --data-prefix RAWFRAMES_DIR

Writes the file without ``normalized_`` in its name beside the input.
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import Optional, Sequence

from ...localization import load_localize_proposal_file
from .file_lists import parse_directory


def denormalize(norm_proposal_file, frame_dict, out_file=None):
    """Rewrite a normalized proposal file with absolute frame numbers.

    Block format a video (``SSNDataset``'s loader reads it): ``# idx /
    frame_dir / num_frames / fps(1) / n_gt / gt lines / n_proposals /
    proposal lines``, a gt ``label start end``, a proposal ``label
    best_iou overlap_self start end``. Returns the written path.
    """
    out_file = out_file or norm_proposal_file.replace('normalized_', '')
    blocks = []
    for idx, video in enumerate(load_localize_proposal_file(
            norm_proposal_file)):
        video_id = video[0]
        frame_dir, num_frames, _ = frame_dict[video_id]
        gts = [(int(x[0]), int(float(x[1]) * num_frames),
                int(float(x[2]) * num_frames)) for x in video[2]]
        props = [(int(x[0]), float(x[1]), float(x[2]),
                  int(float(x[3]) * num_frames),
                  int(float(x[4]) * num_frames)) for x in video[3]]
        lines = [f'# {idx}', osp.basename(frame_dir), str(num_frames), '1',
                 str(len(gts))]
        lines += ['{} {} {}'.format(*g) for g in gts]
        lines += [str(len(props))]
        lines += ['{} {:.04f} {:.04f} {} {}'.format(*p) for p in props]
        blocks.append('\n'.join(lines) + '\n')
    with open(out_file, 'w') as f:
        f.writelines(blocks)
    return out_file


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Denormalize proposals')
    parser.add_argument('dataset', choices=['thumos14'])
    parser.add_argument('--norm-proposal-file', required=True)
    parser.add_argument('--data-prefix', required=True,
                        help='rawframes directory the proposals refer to')
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = parse_args(argv)
    out = denormalize(args.norm_proposal_file,
                      parse_directory(args.data_prefix))
    print(f'wrote {out}')
    return out


if __name__ == '__main__':
    main()
