from .builder import ChainedOptimizer, build_lr_schedule, build_optimizer

__all__ = ['ChainedOptimizer', 'build_lr_schedule', 'build_optimizer']
