"""Affinity helpers (PyTorch counterpart of ``vfs_tpu/ops/affinity.py``).

Layouts follow the JAX package: feature maps are channels-last
``(..., H, W, C)``, affinities ``(N, src_HW, dst_HW)``. Plain PyTorch on
every device: the JAX package has no kernel here. Selections use
``topk_first_index``, which breaks ties to the lowest index as
``jax.lax.top_k`` does (``torch.topk``'s tie order is unspecified).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

# the masked-score fill: finite, so softmax gives masked keys weight 0
# without producing NaN rows
NEG_INF = -1e30


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``x / max(||x||, eps)`` along ``dim`` (torch F.normalize semantics,
    written out so the arithmetic matches the JAX package's)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def topk_first_index(scores: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries along the last dim, ties to the lowest
    index: (values, indices), in index order. ``torch.topk`` gives the
    entries above the k-th largest value (its values and that set do not
    depend on its tie order); the places left go to the first entries
    equal to the k-th value."""
    n = scores.shape[-1]
    vals, idx = torch.topk(scores, k, dim=-1)
    kth = vals[..., -1:]
    need = (vals == kth).sum(-1, keepdim=True)
    # the first k entries equal to the k-th value, in index order
    rank = torch.arange(n, 0, -1, dtype=torch.float32, device=scores.device)
    first_tied = torch.topk(torch.where(scores == kth, rank, 0.0), k,
                            dim=-1).indices
    slot = torch.arange(k, device=scores.device)
    # k candidates of 2k: those above the k-th value and the first `need`
    # tied ones; order the k by index
    cand = torch.cat([idx, first_tied], -1)
    keep = torch.cat([vals > kth, slot < need], -1)
    sel = torch.topk(torch.where(keep, n - cand, 0), k, dim=-1).indices
    idx = torch.gather(cand, -1, sel)
    return torch.gather(scores, -1, idx), idx


def compute_affinity(src: torch.Tensor, dst: torch.Tensor,
                     temperature: float = 1.0, normalize: bool = True,
                     softmax_axis: Optional[int] = None,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense affinity ``(N, src_HW, dst_HW)`` of two ``(N, H, W, C)`` maps
    (reference affinity_utils.py:6-30): ``softmax_axis`` 1 (over src), 2
    (over dst) or None; ``mask`` bool, broadcastable to the affinity,
    fills with ``NEG_INF`` (NaNs of fully masked softmax rows become 0)."""
    n, hs, ws, c = src.shape
    _, hd, wd, _ = dst.shape
    src_flat = src.reshape(n, hs * ws, c)
    dst_flat = dst.reshape(n, hd * wd, c)
    if normalize:
        src_flat = l2_normalize(src_flat, dim=-1)
        dst_flat = l2_normalize(dst_flat, dim=-1)
    affinity = torch.einsum('nic,njc->nij', src_flat, dst_flat) / temperature
    if mask is not None:
        affinity = torch.where(mask, affinity, NEG_INF)
    if softmax_axis is not None:
        affinity = torch.softmax(affinity, dim=softmax_axis)
    if mask is not None:
        affinity = torch.nan_to_num(affinity, nan=0.0)
    return affinity


def _topk_renormalize(affinity: torch.Tensor, topk: int) -> torch.Tensor:
    """UVC's top-k scheme over the src axis (dim 1): subtract each dst
    column's k-th largest value, clamp at 0, renormalise the column."""
    kth = torch.topk(affinity.transpose(1, 2), topk, dim=-1).values[..., -1]
    affinity = torch.clamp(affinity - kth[:, None, :], min=0.0)
    return affinity / torch.clamp(affinity.sum(dim=1, keepdim=True),
                                  min=1e-12)


def propagate(img: torch.Tensor, affinity: torch.Tensor,
              topk: Optional[int] = None) -> torch.Tensor:
    """Propagate ``img`` (N, H, W, C) through ``affinity`` (N, HW, HW)
    (reference affinity_utils.py:33-50): (N, H, W, C)."""
    n, h, w, c = img.shape
    if topk is not None:
        affinity = _topk_renormalize(affinity, topk)
    out = torch.einsum('nij,nic->njc', affinity, img.reshape(n, h * w, c))
    return out.reshape(n, h, w, c)


def propagate_temporal(imgs: torch.Tensor, affinities: torch.Tensor,
                       topk: Optional[int] = None) -> torch.Tensor:
    """The temporal variant (reference affinity_utils.py:53-73): ``imgs``
    (N, T, H, W, C), ``affinities`` (N, T, HW, HW) indexed (key frame, key
    position, query position). Returns (N, H, W, C)."""
    n, t, h, w, c = imgs.shape
    affinities = affinities.reshape(n, t * h * w, h * w)
    if topk is not None:
        affinities = _topk_renormalize(affinities, topk)
    out = torch.einsum('nij,nic->njc', affinities,
                       imgs.reshape(n, t * h * w, c))
    return out.reshape(n, h, w, c)


def spatial_neighbor(height: int,
                     width: int,
                     neighbor_range: Union[int, Tuple[int, int]],
                     mode: str = 'circle',
                     transpose: bool = False,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """Boolean spatial-neighbourhood mask ``(H*W, H*W)`` indexed
    ``[key_pos, query_pos]``. ``'circle'``: Euclidean distance (fp32)
    ``< neighbor_range // 2``; ``'square'``: ``|dy| <= nr_h // 2`` and
    ``|dx| <= nr_w // 2``."""
    assert mode in ('circle', 'square')
    ky, kx = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device),
                            indexing='ij')
    ky = ky.reshape(-1)
    kx = kx.reshape(-1)
    dy = ky[:, None] - ky[None, :]
    dx = kx[:, None] - kx[None, :]
    if mode == 'circle':
        radius = neighbor_range // 2
        dist = torch.sqrt(dy.float()**2 + dx.float()**2)
        mask = dist < radius
    else:
        if isinstance(neighbor_range, int):
            nr_h = nr_w = neighbor_range
        else:
            nr_h, nr_w = neighbor_range
        mask = (dy.abs() <= nr_h // 2) & (dx.abs() <= nr_w // 2)
    if transpose:
        mask = mask.T
    return mask


def grid_mask(grid1: torch.Tensor, grid2: torch.Tensor, radius: float,
              diag_norm: float = 224.0) -> torch.Tensor:
    """Distance mask ``(N, H1*W1, H2*W2)`` between two ``(N, H, W, 2)``
    coordinate grids (reference affinity_utils.py:167-174, there
    ``(N, 2, H, W)``)."""
    n, h1, w1, _ = grid1.shape
    _, h2, w2, _ = grid2.shape
    g1 = grid1.reshape(n, h1 * w1, 1, 2)
    g2 = grid2.reshape(n, 1, h2 * w2, 2)
    dist = torch.sqrt(torch.sum((g1 - g2) ** 2, dim=-1))
    scale = (h2 ** 2 + w2 ** 2) ** 0.5 / (diag_norm * 2 ** 0.5)
    return dist * scale < radius
