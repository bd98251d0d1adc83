from .affinity import NEG_INF, l2_normalize, spatial_neighbor
from .local_attention import (local_topk_attend, local_topk_attend_cuda,
                              local_topk_attend_reference)
from .propagation import (PropagationConfig, propagate_labels,
                          propagate_video)
from .resize import pil_nearest_resize, resize_bilinear, resize_nearest
from .video_affinity import (video_topk_affinity, video_topk_affinity_cuda,
                             video_topk_affinity_reference)

__all__ = [
    'NEG_INF', 'l2_normalize', 'spatial_neighbor', 'local_topk_attend',
    'local_topk_attend_cuda', 'local_topk_attend_reference',
    'PropagationConfig',
    'propagate_labels', 'propagate_video', 'pil_nearest_resize',
    'resize_bilinear', 'resize_nearest', 'video_topk_affinity',
    'video_topk_affinity_cuda', 'video_topk_affinity_reference'
]
