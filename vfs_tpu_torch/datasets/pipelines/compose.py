"""Pipeline composition (counterpart of
``vfs_tpu/datasets/pipelines/compose.py``; reference:
mmaction/datasets/pipelines/compose.py)."""

from __future__ import annotations

from ...utils import build_from_cfg
from ..registry import PIPELINES


@PIPELINES.register_module()
class Compose:
    """Compose a list of transforms; each is a dict cfg or a callable."""

    def __init__(self, transforms):
        self.transforms = []
        for transform in transforms:
            if isinstance(transform, dict):
                self.transforms.append(build_from_cfg(transform, PIPELINES))
            elif callable(transform):
                self.transforms.append(transform)
            else:
                raise TypeError(f'transform must be callable or dict, '
                                f'got {type(transform)}')

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results

    def __repr__(self):
        return (self.__class__.__name__ + '(' +
                ', '.join(repr(t) for t in self.transforms) + ')')
