from .davis import aggregate_metrics, evaluate_semisupervised

__all__ = ['aggregate_metrics', 'evaluate_semisupervised']
