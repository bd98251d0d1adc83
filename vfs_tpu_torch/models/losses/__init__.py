from .regression import (BCELossWithLogits, CrossEntropyLoss, L1Loss,
                         MSELoss, NLLLoss, SmoothL1Loss)
from .sim_loss import CosineSimLoss, DotSimLoss

__all__ = ['BCELossWithLogits', 'CosineSimLoss', 'CrossEntropyLoss',
           'DotSimLoss', 'L1Loss', 'MSELoss', 'NLLLoss', 'SmoothL1Loss']
