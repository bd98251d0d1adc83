from .builder import ChainedOptimizer, build_lr_schedule, build_optimizer
from .tsm_optimizer_constructor import (CopyOfSGD, build_tsm_optimizer,
                                        tsm_param_labels)

__all__ = ['ChainedOptimizer', 'build_lr_schedule', 'build_optimizer',
           'CopyOfSGD', 'build_tsm_optimizer', 'tsm_param_labels']
