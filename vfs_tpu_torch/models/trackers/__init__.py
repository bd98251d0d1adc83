from .vanilla_tracker import VanillaTracker, make_propagation_config

__all__ = ['VanillaTracker', 'make_propagation_config']
