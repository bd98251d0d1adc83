from .norm import BatchNorm1d, BatchNorm2d, BatchNorm3d, set_sync_group
from .utils import (clamp, flax_default_init, flax_module_init, images2video,
                    mean_list, normalize_logit, unmap, video2images)

__all__ = ['BatchNorm1d', 'BatchNorm2d', 'BatchNorm3d', 'clamp',
           'flax_default_init', 'flax_module_init', 'images2video',
           'mean_list', 'normalize_logit', 'set_sync_group', 'unmap',
           'video2images']
