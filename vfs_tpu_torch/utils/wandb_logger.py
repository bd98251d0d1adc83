"""Optional Weights & Biases mirroring of the JSONL train log (counterpart
of ``vfs_tpu/utils/wandb_logger.py``).

``WandbLoggerHook`` entries in ``log_config.hooks`` (the reference's config
idiom; ``--disable-wandb`` and ``--suffix`` edit them) turn it on. wandb is
not a dependency: without the package the logger warns and does nothing,
so configs written for machines with wandb still run, logging to the
JSONL file only.
"""

from __future__ import annotations

from typing import Optional

from .logging import get_root_logger

__all__ = ['WandbLogger', 'build_wandb_logger']


class WandbLogger:
    """A ``wandb.log`` wrapper that inits on construction and does nothing
    when the package is missing."""

    def __init__(self, init_kwargs: Optional[dict] = None, **_ignored):
        self._run = None
        self._wandb = None
        try:
            import wandb
        except ImportError:
            get_root_logger().warning(
                'WandbLoggerHook configured but the wandb package is not '
                'installed; metrics go to the JSONL log only')
            return
        self._wandb = wandb
        self._run = wandb.init(**(init_kwargs or {}))

    @property
    def active(self) -> bool:
        return self._run is not None

    def log(self, metrics: dict, step: Optional[int] = None):
        """Log the numeric entries of ``metrics`` at ``step``."""
        if self._run is not None:
            payload = {k: v for k, v in metrics.items()
                       if isinstance(v, (int, float))}
            self._wandb.log(payload, step=step)

    def finish(self):
        if self._run is not None:
            self._run.finish()
            self._run = None


def build_wandb_logger(log_config) -> Optional[WandbLogger]:
    """A ``WandbLogger`` if ``log_config.hooks`` lists a ``WandbLoggerHook``
    (its keys but ``type`` are the logger's arguments), else None."""
    if not log_config:
        return None
    for hook in log_config.get('hooks', []) or []:
        if isinstance(hook, dict) and hook.get('type') == 'WandbLoggerHook':
            return WandbLogger(**{k: v for k, v in hook.items()
                                  if k != 'type'})
    return None
