"""Recognizer inference (counterpart of ``vfs_tpu/apis/inference.py``;
reference: mmaction/apis/inference.py:14-124, the recognition demo's
``init_recognizer`` / ``inference_recognizer``).

The model holds its weights and runs on ``device``: CUDA unless the
caller asks for the CPU, and a raise when there is no GPU and no such
request."""

from __future__ import annotations

from operator import itemgetter
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..datasets.pipelines.compose import Compose
from ..device import DeviceLike, exact_fp32, resolve_device
from ..models import build_model
from ..utils import Config, get_root_logger


def init_recognizer(config, checkpoint: Optional[str] = None,
                    device: DeviceLike = None) -> nn.Module:
    """Build the config's recognizer in eval mode on ``device``, with the
    weights of ``checkpoint`` (a train checkpoint of ``tools.train``, a
    ``{'state_dict': ...}`` file or a bare state dict) or, without one,
    seeded random weights (seed 0). The config rides along as
    ``model.cfg``."""
    if isinstance(config, str):
        config = Config.fromfile(config)
    device = resolve_device(device)
    model = build_model(config.model, train_cfg=None,
                        test_cfg=config.get('test_cfg'))
    if checkpoint is None:
        model.init_weights(torch.Generator().manual_seed(0))
    else:
        state = torch.load(checkpoint, map_location='cpu', weights_only=True)
        for key in ('model', 'state_dict'):
            if isinstance(state, dict) and key in state:
                state = state[key]
        model.load_state_dict(state)
    model.cfg = config
    return model.to(device).eval()


def inference_recognizer(model: nn.Module, video_path: str,
                         label_path: Optional[str] = None,
                         use_frames: bool = False,
                         topk: int = 5) -> List[Tuple]:
    """Run the config's test pipeline on one video and the recognizer on
    its clips; the top-k (label or class index, score) pairs. A label file
    shorter than the class count is padded with ``class_{i}`` names (with
    a warning), so that no class drops out of the ranking."""
    cfg = model.cfg
    test_pipeline = Compose(cfg.data.test.pipeline)
    data = dict(filename=video_path, label=-1,
                start_index=cfg.data.test.get('start_index', 0),
                modality='RGB')
    data = test_pipeline(data)
    device = next(model.parameters()).device
    imgs = torch.as_tensor(np.asarray(data['imgs'])[None]).to(device)
    with torch.no_grad(), exact_fp32():
        scores = model(imgs, return_loss=False)
    scores = scores[0].cpu().numpy()
    if label_path is not None:
        with open(label_path) as f:
            labels = [line.strip() for line in f]
        if len(labels) < len(scores):
            get_root_logger().warning(
                f'label file has {len(labels)} entries but the model '
                f'outputs {len(scores)} classes; padding with indices')
            labels += [f'class_{i}' for i in range(len(labels),
                                                   len(scores))]
        score_pairs = list(zip(labels, scores))
    else:
        score_pairs = list(enumerate(scores))
    score_pairs = sorted(score_pairs, key=itemgetter(1), reverse=True)
    return score_pairs[:topk]
