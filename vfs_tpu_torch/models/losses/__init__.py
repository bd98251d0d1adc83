from .bmn_loss import (BinaryLogisticRegressionLoss, BMNLoss,
                       binary_logistic_regression_loss)
from .regression import (BCELossWithLogits, CrossEntropyLoss, L1Loss,
                         MSELoss, NLLLoss, SmoothL1Loss)
from .sim_loss import CosineSimLoss, DotSimLoss
from .ssn_loss import OHEMHingeLoss, SSNLoss, ohem_hinge_loss

__all__ = ['BCELossWithLogits', 'binary_logistic_regression_loss',
           'BinaryLogisticRegressionLoss', 'BMNLoss', 'CosineSimLoss',
           'CrossEntropyLoss', 'DotSimLoss', 'L1Loss', 'MSELoss', 'NLLLoss',
           'ohem_hinge_loss', 'OHEMHingeLoss', 'SmoothL1Loss', 'SSNLoss']
