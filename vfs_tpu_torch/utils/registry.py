"""Minimal registry + build-from-config machinery (a copy of
``vfs_tpu/utils/registry.py``: the port needs nothing of the JAX package).

Replicates the capability surface of mmcv's ``Registry``/``build_from_cfg``
(reference: mmaction/models/registry.py, mmaction/models/builder.py) without
depending on mmcv. A registry maps a string ``type`` name to a class or
callable; ``build_from_cfg`` instantiates it from a plain-dict config.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A string -> class registry.

    Example:
        BACKBONES = Registry('backbone')

        @BACKBONES.register_module()
        class ResNet: ...

        model = build_from_cfg(dict(type='ResNet', depth=18), BACKBONES)
    """

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Callable] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Callable]:
        return self._module_dict

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return (f'{self.__class__.__name__}(name={self._name}, '
                f'items={list(self._module_dict)})')

    def get(self, key: str) -> Optional[Callable]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None,
                        module: Optional[Callable] = None,
                        force: bool = False):
        """Register a class. Usable as decorator (with or without args) or
        called directly with ``module=``."""
        if module is not None:
            self._register(module, name=name, force=force)
            return module

        def _decorator(cls):
            self._register(cls, name=name, force=force)
            return cls

        return _decorator

    def _register(self, module: Callable, name: Optional[str] = None,
                  force: bool = False):
        if not callable(module):
            raise TypeError(f'module must be callable, got {type(module)}')
        key = name if name is not None else module.__name__
        if not force and key in self._module_dict:
            raise KeyError(f'{key} is already registered in {self._name}')
        self._module_dict[key] = module


def build_from_cfg(cfg: Dict[str, Any], registry: Registry,
                   default_args: Optional[Dict[str, Any]] = None) -> Any:
    """Instantiate ``cfg['type']`` from ``registry`` with remaining keys as
    kwargs (mirrors mmcv build_from_cfg semantics)."""
    if not isinstance(cfg, dict) or 'type' not in cfg:
        raise TypeError(f'cfg must be a dict with key "type", got {cfg!r}')
    args = dict(cfg)
    obj_type = args.pop('type')
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f'{obj_type} is not in the {registry.name} '
                           f'registry. Available: {list(registry.module_dict)}')
    elif inspect.isclass(obj_type) or callable(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f'type must be a str or class, got {type(obj_type)}')
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return obj_cls(**args)
