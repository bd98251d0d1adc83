"""Action-recognition demo (counterpart of ``demo/demo_recognition.py``;
reference demo/demo.py:1-124): run a recognizer over one video, print the
top-5 classes and, with ``--out-filename``, write the video with the top
label drawn on every frame.

    python -m vfs_tpu_torch.tools.demo_recognition CONFIG CHECKPOINT VIDEO \\
        LABEL_FILE [--use-frames] [--out-filename out.mp4] [--fps 30] \\
        [--device cpu]

CHECKPOINT is a ``tools.train`` checkpoint or a recognizer state dict, or
``random`` for seeded random weights. The model runs on the card unless
``--device cpu``. Unlike the JAX script, an output that
``cv2.VideoWriter`` cannot open raises instead of writing nothing.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

from .analysis.common import add_device_arg


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='recognition demo')
    parser.add_argument('config', help='test config file path')
    parser.add_argument('checkpoint', help='checkpoint file, or "random" '
                        'for seeded random weights')
    parser.add_argument('video', help='video file or rawframes directory')
    parser.add_argument('label', help='label file, one class name a line')
    parser.add_argument('--use-frames', action='store_true',
                        help='treat VIDEO as a rawframes directory')
    parser.add_argument('--out-filename', default=None,
                        help='write the video with the top label drawn')
    parser.add_argument('--fps', type=int, default=30)
    parser.add_argument('--font-scale', type=float, default=0.7)
    add_device_arg(parser)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[Tuple]:
    """Print and return the top-5 (label, score) pairs."""
    args = parse_args(argv)
    from ..apis.inference import inference_recognizer, init_recognizer

    ckpt = None if args.checkpoint == 'random' else args.checkpoint
    model = init_recognizer(args.config, ckpt, device=args.device)
    results = inference_recognizer(model, args.video, args.label,
                                   use_frames=args.use_frames)
    print('The top-5 labels with corresponding scores are:')
    for label, score in results:
        print(f'{label}: {float(score):.4f}')
    if args.out_filename:
        write_labelled(args.video, args.out_filename, str(results[0][0]),
                       args.fps, args.font_scale)
        print(f'wrote {args.out_filename}')
    return results


def write_labelled(video: str, out: str, label: str, fps: int,
                   font_scale: float) -> None:
    """Copy ``video`` to ``out`` (mp4v) with ``label`` on every frame."""
    import cv2
    cap = cv2.VideoCapture(video)
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = cv2.VideoWriter(out, cv2.VideoWriter_fourcc(*'mp4v'), fps,
                             (w, h))
    if not writer.isOpened():
        cap.release()
        raise IOError(f'cv2.VideoWriter cannot open {out}')
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            cv2.putText(frame, label, (10, 30), cv2.FONT_HERSHEY_SIMPLEX,
                        font_scale, (255, 255, 255), 2, cv2.LINE_AA)
            writer.write(frame)
    finally:
        cap.release()
        writer.release()


if __name__ == '__main__':
    main()
