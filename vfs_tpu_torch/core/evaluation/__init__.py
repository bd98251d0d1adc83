from .accuracy import mean_iou
from .davis import aggregate_metrics, evaluate_semisupervised

__all__ = ['aggregate_metrics', 'evaluate_semisupervised', 'mean_iou']
