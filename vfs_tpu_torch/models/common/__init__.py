from .norm import BatchNorm1d, BatchNorm2d, set_sync_group
from .utils import flax_default_init, normalize_logit

__all__ = ['BatchNorm1d', 'BatchNorm2d', 'flax_default_init',
           'normalize_logit', 'set_sync_group']
