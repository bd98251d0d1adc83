"""siamfc_tpu_torch: the PyTorch port of ``siamfc_tpu`` (SiamFC tracking on
OTB and its linear probe). Imports ``torch`` and ``vfs_tpu_torch``, never
``jax``, ``vfs_tpu`` or ``siamfc_tpu``."""

from .checkpoint import flax_siamfc_to_torch
from .datasets import Pair, SequenceDataset, SiamFCTransforms
from .default_config import default_cfg
from .heads import SiamConvFC, SiamFC, fast_xcorr
from .losses import (balanced_loss, create_labels, focal_loss, ghmc_loss,
                     ohnm_loss)
from .otb import ExperimentOTB, center_error, eval_metrics, rect_iou
from .tracker import Net, TrackerSiamFC

__all__ = [
    'flax_siamfc_to_torch', 'Pair', 'SequenceDataset', 'SiamFCTransforms',
    'default_cfg', 'SiamConvFC', 'SiamFC', 'fast_xcorr', 'balanced_loss',
    'create_labels', 'focal_loss', 'ghmc_loss', 'ohnm_loss', 'ExperimentOTB',
    'center_error', 'eval_metrics', 'rect_iou', 'Net', 'TrackerSiamFC'
]
