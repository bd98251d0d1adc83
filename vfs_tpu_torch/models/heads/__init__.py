from .recognition_heads import (I3DHead, SlowFastHead, TSMHead, TSNHead,
                                dropout, head_loss)
from .sim_siam_head import DenseSimSiamHead, MLPBlock, SimSiamHead
from .ssn_head import SSNHead, STPPTest, STPPTrain

__all__ = ['DenseSimSiamHead', 'dropout', 'head_loss', 'I3DHead', 'MLPBlock',
           'SimSiamHead', 'SlowFastHead', 'SSNHead', 'STPPTest', 'STPPTrain',
           'TSMHead', 'TSNHead']
