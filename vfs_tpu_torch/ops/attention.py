"""Masked top-k attention over a feature bank (PyTorch counterpart of
``vfs_tpu/ops/attention.py``; reference: mmaction/models/common/
local_attention.py).

Plain PyTorch on every device (the JAX package has no kernel here):
normalise query and keys, scores ``K.Q / tau``, the radius mask to
``NEG_INF`` (the first ``non_mask_len`` key frames exempt), top-k over the
keys with ties to the lowest index (``topk_first_index``), softmax or
clamped cosine squared over the kept keys, and the weighted sum of the
values. Channels-last: query ``(N, Hq, Wq, C)``, key and value
``(N, T, H, W, C*)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .affinity import NEG_INF, l2_normalize, topk_first_index


def masked_attention_efficient(query: torch.Tensor, key: torch.Tensor,
                               value: torch.Tensor,
                               mask: Optional[torch.Tensor] = None,
                               temperature: float = 1.0,
                               topk: Optional[int] = None,
                               normalize: bool = True,
                               step: Optional[int] = None,
                               non_mask_len: int = 0,
                               mode: str = 'softmax') -> torch.Tensor:
    """Masked top-k attention in query chunks of ``step`` (None: one).

    Args:
        query: ``(N, Hq, Wq, C)``.
        key: ``(N, T, H, W, C)`` (or ``(N, H, W, C)``, T = 1).
        value: ``(N, T, H, W, Cv)``.
        mask: bool ``(H*W, Hq*Wq)`` indexed [key_pos, query_pos], or None.
        temperature: the affinity temperature.
        topk: keys kept per query (None: all).
        normalize: L2-normalise query and keys over channels.
        non_mask_len: leading key frames exempt from the mask.
        mode: ``'softmax'`` or ``'cosine'`` (``clamp(min=0) ** 2``).

    Returns:
        ``(N, Hq, Wq, Cv)``.
    """
    assert mode in ('softmax', 'cosine')
    if key.ndim == 4:
        key = key[:, None]
        value = value[:, None]
    n, t, h, w, c = key.shape
    _, hq, wq, _ = query.shape
    cv = value.shape[-1]
    assert 0 <= non_mask_len < t
    if normalize:
        query = l2_normalize(query, dim=-1)
        key = l2_normalize(key, dim=-1)
    key_flat = key.reshape(n, t * h * w, c)
    value_flat = value.reshape(n, t * h * w, cv)
    query_flat = query.reshape(n, hq * wq, c)
    num_queries = hq * wq
    step = num_queries if step is None else step
    outs = [_attend_chunk(query_flat[:, s:s + step], key_flat, value_flat,
                          None if mask is None else mask[:, s:s + step],
                          temperature, topk, non_mask_len, mode, t, h, w)
            for s in range(0, num_queries, step)]
    return torch.cat(outs, 1).reshape(n, hq, wq, cv)


def _attend_chunk(query: torch.Tensor, key_flat: torch.Tensor,
                  value_flat: torch.Tensor, mask: Optional[torch.Tensor],
                  temperature: float, topk: Optional[int], non_mask_len: int,
                  mode: str, t: int, h: int, w: int) -> torch.Tensor:
    """One query chunk: (n, q, c) against (n, K, c) -> (n, q, cv)."""
    n, q, _ = query.shape
    scores = torch.einsum('nkc,nqc->nqk', key_flat, query) / temperature
    if mask is not None:
        # (h*w, q) [key_pos, query_pos] per key frame, the first
        # non_mask_len frames exempt (reference :307-312)
        m = mask.T[None].expand(t - non_mask_len, q, h * w)
        if non_mask_len > 0:
            m = torch.cat([m.new_ones((non_mask_len, q, h * w)), m], 0)
        m = m.permute(1, 0, 2).reshape(1, q, t * h * w)
        scores = torch.where(m, scores, NEG_INF)
    if topk is None:
        weights = torch.softmax(scores, dim=-1) if mode == 'softmax' \
            else torch.clamp(scores, min=0.0) ** 2
        return torch.einsum('nqk,nkc->nqc', weights, value_flat)
    top_scores, top_idx = topk_first_index(scores, topk)  # (n, q, k)
    weights = torch.softmax(top_scores, dim=-1) if mode == 'softmax' \
        else torch.clamp(top_scores, min=0.0) ** 2
    batch = torch.arange(n, device=query.device)[:, None, None]
    return torch.einsum('nqk,nqkc->nqc', weights,
                        value_flat[batch, top_idx])


def local_square_attention(query: torch.Tensor, key: torch.Tensor,
                           value: torch.Tensor, kernel_size,
                           temperature: float = 1.0,
                           topk: Optional[int] = None,
                           batch_as_context: bool = False) -> torch.Tensor:
    """Attention within the (odd) ``kernel_size`` window around each query
    position, zero-padded (reference local_attention.py:8-84).
    Channels-last ``(N, H, W, C*)``. With ``batch_as_context`` and N > 1,
    the windows of the whole batch form one context, laid out as the JAX
    package reshapes them. The kept scores weight the values directly (no
    softmax), as in the reference."""
    n, hh, ww, c = query.shape
    cv = value.shape[-1]
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size, kernel_size)
    kh, kw = kernel_size

    def unfold(x):
        # (N, H, W, C) -> (N, H, W, kh*kw, C) zero-padded patches
        cx = x.shape[-1]
        patches = F.unfold(x.permute(0, 3, 1, 2), (kh, kw),
                           padding=(kh // 2, kw // 2))
        return patches.reshape(n, cx, kh * kw, hh, ww).permute(0, 3, 4, 2, 1)

    key_p = unfold(key)
    value_p = unfold(value)
    if batch_as_context and n > 1:
        key_p = key_p.reshape(1, hh, ww, n * kh * kw, c)
        value_p = value_p.reshape(1, hh, ww, n * kh * kw, cv)
    scores = torch.einsum('nhwc,nhwkc->nhwk', query,
                          key_p.expand(n, -1, -1, -1, -1)) / temperature
    value_p = value_p.expand(n, -1, -1, -1, -1)
    if topk is None:
        return torch.einsum('nhwk,nhwkc->nhwc', scores, value_p)
    top_scores, top_idx = topk_first_index(scores, topk)
    top_values = torch.gather(
        value_p, 3, top_idx[..., None].expand(-1, -1, -1, -1, cv))
    return torch.einsum('nhwk,nhwkc->nhwc', top_scores, top_values)
