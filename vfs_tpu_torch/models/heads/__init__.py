from .sim_siam_head import DenseSimSiamHead, MLPBlock, SimSiamHead

__all__ = ['DenseSimSiamHead', 'MLPBlock', 'SimSiamHead']
