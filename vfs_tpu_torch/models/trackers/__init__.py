from .sim_siam_tracker import SimSiamBaseTracker, parse_losses
from .vanilla_tracker import VanillaTracker, make_propagation_config

__all__ = ['SimSiamBaseTracker', 'VanillaTracker', 'make_propagation_config',
           'parse_losses']
