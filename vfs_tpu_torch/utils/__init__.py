from .registry import Registry, build_from_cfg

__all__ = ['Registry', 'build_from_cfg']
