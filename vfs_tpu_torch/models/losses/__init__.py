from .sim_loss import CosineSimLoss, DotSimLoss

__all__ = ['CosineSimLoss', 'DotSimLoss']
