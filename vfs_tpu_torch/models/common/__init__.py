from .utils import normalize_logit

__all__ = ['normalize_logit']
