"""Small shared utilities (the part of ``vfs_tpu/utils/misc.py`` the eval
path calls; reference: mmaction/utils/misc.py)."""

from __future__ import annotations

from typing import Dict


def add_prefix(inputs: Dict, prefix: str) -> Dict:
    """Prefix every key of a dict with ``f'{prefix}.'``."""
    return {f'{prefix}.{k}': v for k, v in inputs.items()}
