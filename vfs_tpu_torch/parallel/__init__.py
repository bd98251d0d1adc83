from .comm import (allreduce_grads, batch_shuffle, batch_unshuffle,
                   concat_all_gather, concat_all_gather_sharded)
from .dist import (get_rank, get_world_size, init_dist, reduce_log_vars,
                   wrap_distributed)

__all__ = ['get_rank', 'get_world_size', 'init_dist', 'reduce_log_vars',
           'wrap_distributed', 'concat_all_gather', 'batch_shuffle',
           'batch_unshuffle', 'allreduce_grads', 'concat_all_gather_sharded']
