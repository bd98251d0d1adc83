"""Score-fusion accuracy report (counterpart of
``tools/analysis/report_accuracy.py``): the weighted sum of several
models' score files, and its top-1, top-5 and mean class accuracy against
an annotation list. Host-only: it runs no model.

    python -m vfs_tpu_torch.tools.analysis.report_accuracy \\
        --scores a.npz b.npz --coefficients 1.0 1.0 --annotation list.txt

A score file is a ``.npy`` array (samples x classes) or a ``.npz`` whose
arrays are the samples' score vectors, in order; the annotation list has
one ``path ... label`` line a sample, the label last.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from ...core.evaluation import (get_weighted_score, mean_class_accuracy,
                                top_k_accuracy)


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='score-fusion accuracy')
    parser.add_argument('--scores', nargs='+', required=True,
                        help='npz/npy score files (samples x classes)')
    parser.add_argument('--coefficients', nargs='+', type=float,
                        required=True)
    parser.add_argument('--annotation', required=True,
                        help='label list: one "path label" a line')
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Print the JAX tool's line; return its three numbers."""
    args = parse_args(argv)
    score_list = []
    for path in args.scores:
        data = np.load(path, allow_pickle=True)
        if hasattr(data, 'files'):
            data = np.stack([data[f] for f in data.files])
        score_list.append(list(data))
    labels = []
    with open(args.annotation) as f:
        for line in f:
            parts = line.strip().split()
            if parts:
                labels.append(int(parts[-1]))
    weighted = get_weighted_score(score_list, args.coefficients)
    top1, top5 = top_k_accuracy(weighted, labels, (1, 5))
    mca = mean_class_accuracy(weighted, labels)
    print(f'top1: {top1:.4f} top5: {top5:.4f} mean_class_acc: {mca:.4f}')
    return dict(top1=float(top1), top5=float(top5),
                mean_class_acc=float(mca))


if __name__ == '__main__':
    main()
