"""Weights carried across from the JAX package's SiamFC tracker.

``flax_siamfc_to_torch`` maps ``siamfc_tpu.TrackerSiamFC.variables``
(``{'backbone': {'params', 'batch_stats'}, 'head': {'params'}}``, leaves
as numpy arrays) to a state dict of this package's ``Net``: the backbone
through ``vfs_tpu_torch.checkpoint.flax_resnet_to_torch`` under
``backbone.``, the head's ``z_conv{i}`` / ``x_conv{i}`` kernels HWIO ->
OIHW under ``head.``. Checkpoints of ``train_over`` are
``vfs_tpu_torch.checkpoint.save_checkpoint``'s (``model``, ``optimizer``,
``step``, ``epoch``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from vfs_tpu_torch.checkpoint import flax_head_to_torch, flax_resnet_to_torch


def flax_siamfc_to_torch(variables: Mapping) -> Dict[str, torch.Tensor]:
    backbone = variables['backbone']
    sd = {f'backbone.{k}': v for k, v in flax_resnet_to_torch(
        backbone['params'], backbone['batch_stats']).items()}
    head = variables.get('head', {}).get('params', {})
    sd.update({f'head.{k}': v
               for k, v in flax_head_to_torch(head, {}).items()})
    return sd
