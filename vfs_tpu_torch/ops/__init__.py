from .affinity import (NEG_INF, compute_affinity, grid_mask, l2_normalize,
                       propagate, propagate_temporal, spatial_neighbor,
                       topk_first_index)
from .attention import local_square_attention, masked_attention_efficient
from .local_attention import (local_topk_attend, local_topk_attend_cuda,
                              local_topk_attend_reference,
                              local_topk_attend_wide_cuda)
from .local_attention_tiled import local_masked_topk_attend
from .local_attention_v2 import (local_topk_attend_v2,
                                 local_topk_attend_v2_cuda)
from .propagation import (PropagationConfig, attend_one_frame,
                          propagate_labels, propagate_video)
from .resize import pil_nearest_resize, resize_bilinear, resize_nearest
from .video_affinity import (video_topk_affinity, video_topk_affinity_cuda,
                             video_topk_affinity_reference,
                             video_topk_affinity_wide_cuda)
from .video_affinity_v1 import (video_topk_affinity_v1,
                                video_topk_affinity_v1_cuda)

__all__ = [
    'NEG_INF', 'compute_affinity', 'grid_mask', 'l2_normalize', 'propagate',
    'propagate_temporal', 'spatial_neighbor', 'topk_first_index',
    'local_square_attention', 'masked_attention_efficient',
    'local_topk_attend', 'local_topk_attend_cuda',
    'local_topk_attend_reference', 'local_topk_attend_wide_cuda',
    'local_masked_topk_attend', 'local_topk_attend_v2',
    'local_topk_attend_v2_cuda', 'PropagationConfig', 'attend_one_frame',
    'propagate_labels', 'propagate_video', 'pil_nearest_resize',
    'resize_bilinear', 'resize_nearest', 'video_topk_affinity',
    'video_topk_affinity_cuda', 'video_topk_affinity_reference',
    'video_topk_affinity_wide_cuda',
    'video_topk_affinity_v1', 'video_topk_affinity_v1_cuda'
]
