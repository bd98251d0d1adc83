"""Circle-masked top-k attention of one query frame (PyTorch counterpart
of ``vfs_tpu/ops/local_attention_tiled.py``, ``local_masked_topk_attend``).

The JAX function is XLA's tiled form of the scan kernel's function: for
every query cell, the top-k of ``dot(q, key) / temperature`` over the
valid bank slots and the keys inside the circle of ``radius`` cells and
inside the map, ties to the lowest ``(slot, ky, kx)``, then the softmax and
the weighted sum of the selected values. That is row 3's exact mode, so it
goes through row 3's wrapper (``local_attention.local_topk_attend``): the
plain version for CPU tensors; for CUDA tensors the core, or the wide
kernel where the radius or top-k exceed the core's limits (the JAX
function takes any). ``tile`` is a TPU layout key with no effect.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .local_attention import local_topk_attend


def local_masked_topk_attend(query: torch.Tensor, bank_feats: torch.Tensor,
                             bank_vals: torch.Tensor,
                             bank_valid: torch.Tensor, radius: float,
                             temperature: float, topk: int,
                             tile: Tuple[int, int] = (10, 16)
                             ) -> torch.Tensor:
    """Circle-masked top-k attention.

    Args:
        query: (H, W, C), L2-normalised already.
        bank_feats: (F, H, W, C) normalised; bank_vals: (F, H, W, K).
        bank_valid: (F,) bool.
        radius: circle radius in cells (keys with distance < radius
            attend).
        temperature, topk: as in ``masked_attention_efficient``.
        tile: the JAX function's query tile; no effect here.
    Returns:
        (H, W, K) propagated logits.
    """
    del tile
    return local_topk_attend(query, bank_feats, bank_vals, bank_valid,
                             float(radius), temperature, topk)[0]
