from .dist import (get_rank, get_world_size, init_dist, reduce_log_vars,
                   wrap_distributed)

__all__ = ['get_rank', 'get_world_size', 'init_dist', 'reduce_log_vars',
           'wrap_distributed']
