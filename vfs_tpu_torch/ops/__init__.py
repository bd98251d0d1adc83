from .affinity import NEG_INF, l2_normalize, spatial_neighbor
from .local_attention import (local_topk_attend, local_topk_attend_cuda,
                              local_topk_attend_reference)
from .local_attention_v2 import (local_topk_attend_v2,
                                 local_topk_attend_v2_cuda)
from .propagation import (PropagationConfig, propagate_labels,
                          propagate_video)
from .resize import pil_nearest_resize, resize_bilinear, resize_nearest
from .video_affinity import (video_topk_affinity, video_topk_affinity_cuda,
                             video_topk_affinity_reference)
from .video_affinity_v1 import (video_topk_affinity_v1,
                                video_topk_affinity_v1_cuda)

__all__ = [
    'NEG_INF', 'l2_normalize', 'spatial_neighbor', 'local_topk_attend',
    'local_topk_attend_cuda', 'local_topk_attend_reference',
    'local_topk_attend_v2', 'local_topk_attend_v2_cuda', 'PropagationConfig',
    'propagate_labels', 'propagate_video', 'pil_nearest_resize',
    'resize_bilinear', 'resize_nearest', 'video_topk_affinity',
    'video_topk_affinity_cuda', 'video_topk_affinity_reference',
    'video_topk_affinity_v1', 'video_topk_affinity_v1_cuda'
]
