"""Python-file config system with dotted-key CLI overrides (a copy of
``vfs_tpu/utils/config.py``: the port needs nothing of the JAX package).

Mirrors the capability of ``mmcv.Config.fromfile`` + ``DictAction``
(reference: tools/train.py:70-72, tools/test.py:44-45): configs are plain
Python files whose module-level names become config entries; nested dicts are
wrapped for attribute access; ``merge_from_dict`` applies dotted-key
overrides like ``test_cfg.save_np=True``.
"""

from __future__ import annotations

import ast
import importlib.util
import os
import sys
import types
from typing import Any, Dict, Optional


class ConfigDict(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError:
            raise AttributeError(name)
        return value

    def __setattr__(self, name: str, value: Any):
        self[name] = _wrap(value)

    def __setitem__(self, name, value):
        super().__setitem__(name, _wrap(value))

    def get(self, key, default=None):
        return super().get(key, default)

    def copy(self):
        return ConfigDict({k: v for k, v in self.items()})


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigDict):
        return value
    if isinstance(value, dict):
        return ConfigDict({k: _wrap(v) for k, v in value.items()})
    if isinstance(value, (list, tuple)):
        return type(value)(_wrap(v) for v in value)
    return value


class Config:
    """Config loaded from a python file (or a dict)."""

    def __init__(self, cfg_dict: Optional[Dict[str, Any]] = None,
                 filename: Optional[str] = None, text: str = ''):
        cfg_dict = cfg_dict or {}
        object.__setattr__(self, '_cfg_dict', _wrap(dict(cfg_dict)))
        object.__setattr__(self, '_filename', filename)
        object.__setattr__(self, '_text', text)

    # -- loading ----------------------------------------------------------
    @staticmethod
    def fromfile(filename: str) -> 'Config':
        filename = os.path.abspath(os.path.expanduser(filename))
        if not os.path.isfile(filename):
            raise FileNotFoundError(filename)
        if not filename.endswith('.py'):
            raise ValueError('only .py config files are supported')
        with open(filename) as f:
            text = f.read()
        # validate syntax early with a clear error
        ast.parse(text)
        module_name = '_vfs_torch_cfg_' + os.path.splitext(
            os.path.basename(filename))[0]
        spec = importlib.util.spec_from_file_location(module_name, filename)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = mod
        try:
            spec.loader.exec_module(mod)
            cfg_dict = {
                k: v for k, v in vars(mod).items()
                if not k.startswith('__')
                and not isinstance(v, (types.ModuleType, types.FunctionType,
                                       type))
            }
        finally:
            sys.modules.pop(module_name, None)
        return Config(cfg_dict, filename=filename, text=text)

    @staticmethod
    def fromdict(cfg_dict: Dict[str, Any]) -> 'Config':
        return Config(cfg_dict)

    # -- access -----------------------------------------------------------
    @property
    def filename(self) -> Optional[str]:
        return self._filename

    @property
    def text(self) -> str:
        return self._text

    def __getattr__(self, name: str) -> Any:
        try:
            return self._cfg_dict[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any):
        self._cfg_dict[name] = value

    def __getitem__(self, name: str) -> Any:
        return self._cfg_dict[name]

    def __setitem__(self, name: str, value: Any):
        self._cfg_dict[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._cfg_dict

    def get(self, name: str, default=None) -> Any:
        return self._cfg_dict.get(name, default)

    def keys(self):
        return self._cfg_dict.keys()

    def to_dict(self) -> Dict[str, Any]:
        return _unwrap(self._cfg_dict)

    def __repr__(self) -> str:
        return f'Config(file={self._filename}): {dict(self._cfg_dict)!r}'

    # -- overrides ----------------------------------------------------------
    def merge_from_dict(self, options: Dict[str, Any]):
        """Apply dotted-key overrides, e.g. {'test_cfg.save_np': True}."""
        for full_key, value in options.items():
            d = self._cfg_dict
            keys = full_key.split('.')
            for k in keys[:-1]:
                if k not in d or not isinstance(d[k], dict):
                    d[k] = ConfigDict()
                d = d[k]
            d[keys[-1]] = value

    def dump(self, path: str):
        with open(path, 'w') as f:
            if self._text:
                f.write(self._text)
            else:
                f.write(repr(self.to_dict()))


def _unwrap(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_unwrap(v) for v in value)
    return value


def parse_option_value(text: str) -> Any:
    """Parse a CLI override value: try python literal, fall back to str.

    Matches mmcv DictAction semantics for ``--options k=v`` pairs.
    """
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        lowered = text.lower()
        if lowered == 'true':
            return True
        if lowered == 'false':
            return False
        if lowered in ('none', 'null'):
            return None
        return text


def parse_options(pairs) -> Dict[str, Any]:
    """Parse ['a.b=1', 'c=x'] into {'a.b': 1, 'c': 'x'}."""
    out: Dict[str, Any] = {}
    for pair in pairs or []:
        if '=' not in pair:
            raise ValueError(f'option {pair!r} must be key=value')
        key, value = pair.split('=', 1)
        out[key] = parse_option_value(value)
    return out
