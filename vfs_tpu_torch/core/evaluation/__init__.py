from .accuracy import mean_iou
from .davis import aggregate_metrics, evaluate_semisupervised
from .eval_hooks import EvalHook

__all__ = ['aggregate_metrics', 'evaluate_semisupervised', 'EvalHook',
           'mean_iou']
