"""Temporal-localization host utilities (counterpart of
``vfs_tpu/localization``): proposal IoU and NMS, BSN proposal generation,
SSN proposal files and AP. Host-side numpy, copied so that the port
imports nothing of the JAX package."""

from .bsn_utils import generate_bsp_feature, generate_candidate_proposals
from .proposal_utils import (post_processing, soft_nms, temporal_iop,
                             temporal_iou)
from .ssn_utils import (average_precision_at_temporal_iou, eval_ap,
                        load_localize_proposal_file, perform_regression,
                        temporal_nms)

__all__ = [
    'generate_bsp_feature', 'generate_candidate_proposals',
    'post_processing', 'soft_nms', 'temporal_iop', 'temporal_iou',
    'average_precision_at_temporal_iou', 'eval_ap',
    'load_localize_proposal_file', 'perform_regression', 'temporal_nms'
]
