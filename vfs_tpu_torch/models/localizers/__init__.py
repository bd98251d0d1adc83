"""Temporal action localizers (counterpart of
``vfs_tpu/models/localizers``): ``BMN`` scores every (start, duration)
proposal at once with a boundary-matching confidence map; ``TEM`` and
``PEM`` are BSN's two stages (start / end / actionness curves, then BSP
features scored a proposal); ``SSN`` classifies and regresses staged
temporal pools around each proposal."""

from .bmn import BMN, get_interp1d_mask
from .bsn import PEM, TEM
from .ssn import SSN

__all__ = ['BMN', 'get_interp1d_mask', 'PEM', 'TEM', 'SSN']
