from .accuracy import (binary_precision_recall_curve, confusion_matrix,
                       get_weighted_score, mean_average_precision,
                       mean_class_accuracy, mean_iou, top_k_accuracy)
from .davis import aggregate_metrics, evaluate_semisupervised
from .eval_hooks import EvalHook

__all__ = ['aggregate_metrics', 'binary_precision_recall_curve',
           'confusion_matrix', 'evaluate_semisupervised', 'EvalHook',
           'get_weighted_score', 'mean_average_precision',
           'mean_class_accuracy', 'mean_iou', 'top_k_accuracy']
