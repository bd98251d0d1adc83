from .config import Config, ConfigDict, parse_option_value, parse_options
from .logging import JsonlLogger, get_root_logger
from .misc import (add_prefix, add_suffix, collect_env, set_random_seed,
                   terminal_is_available)
from .registry import Registry, build_from_cfg
from .wandb_logger import WandbLogger, build_wandb_logger
from .zip_reader import ZipReader

__all__ = [
    'Config', 'ConfigDict', 'parse_option_value', 'parse_options',
    'JsonlLogger', 'get_root_logger', 'add_prefix', 'add_suffix',
    'collect_env', 'set_random_seed', 'terminal_is_available', 'Registry',
    'build_from_cfg', 'WandbLogger', 'build_wandb_logger', 'ZipReader'
]
