from .accuracy import (binary_precision_recall_curve, confusion_matrix,
                       get_weighted_score, mean_average_precision,
                       mean_class_accuracy, mean_iou, top_k_accuracy)
from .davis import aggregate_metrics, evaluate_semisupervised
from .eval_hooks import EvalHook
from .proposal import (average_recall_at_avg_proposals,
                       pairwise_temporal_iou)

__all__ = ['aggregate_metrics', 'average_recall_at_avg_proposals',
           'binary_precision_recall_curve', 'confusion_matrix',
           'evaluate_semisupervised', 'EvalHook',
           'get_weighted_score', 'mean_average_precision',
           'mean_class_accuracy', 'mean_iou', 'pairwise_temporal_iou',
           'top_k_accuracy']
