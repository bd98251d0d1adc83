"""Small shared utilities (counterpart of ``vfs_tpu/utils/misc.py``;
reference: mmaction/utils/misc.py)."""

from __future__ import annotations

import os
import platform
import random
import sys
from typing import Dict

import numpy as np


def add_prefix(inputs: Dict, prefix: str) -> Dict:
    """Prefix every key of a dict with ``f'{prefix}.'``."""
    return {f'{prefix}.{k}': v for k, v in inputs.items()}


def add_suffix(inputs: Dict, suffix: str) -> Dict:
    """Suffix every key of a dict with ``f'.{suffix}'``."""
    return {f'{k}.{suffix}': v for k, v in inputs.items()}


def set_random_seed(seed: int):
    """Seed Python's, numpy's and torch's generators."""
    import torch
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def terminal_is_available() -> bool:
    """Whether progress bars may draw: not under Kubernetes (reference:
    mmaction/utils/misc.py:66-70) and only on a terminal."""
    if any(k.startswith('KUBERNETES') for k in os.environ):
        return False
    return sys.stdout.isatty()


def collect_env() -> Dict[str, str]:
    """Versions and devices, for the head of a training log."""
    import torch
    env = {'sys.platform': sys.platform,
           'Python': sys.version.replace('\n', ''),
           'platform': platform.platform(), 'PyTorch': torch.__version__,
           'CUDA': str(torch.version.cuda)}
    if torch.cuda.is_available():
        env['GPUs'] = ', '.join(torch.cuda.get_device_name(i) for i in
                                range(torch.cuda.device_count()))
    return env
