from .config import Config, ConfigDict, parse_option_value, parse_options
from .logging import get_root_logger
from .misc import add_prefix
from .registry import Registry, build_from_cfg

__all__ = [
    'Config', 'ConfigDict', 'parse_option_value', 'parse_options',
    'get_root_logger', 'add_prefix', 'Registry', 'build_from_cfg'
]
