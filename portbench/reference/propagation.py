"""Plain label propagation of VFS's DAVIS eval (Xu & Wang, ICCV 2021, the
semi-supervised protocol of Jabri et al. 2020), the reference of the
eval cells.

For each frame ``t >= 1`` and each query cell of its (h, w) feature map
(features L2-normalised), the candidates are the cells of frame 0 and of
the ``P`` frames before ``t`` (while ``t <= P``, frames 0..t-1, so frame
0 is a candidate twice: as the first frame and as a ring slot) that lie
at a distance ``< radius`` (``radius = neighbor_range // 2``) from the
query's position; their scores are ``q . k / temperature``. The ``topk``
best candidates' softmax weights average the candidates' labels: frame
0's one-hot labels, later frames' propagated ones. A frame's mask is the
argmax over the classes of its labels upsampled bilinearly (half-pixel
centres) to the frame size and min-max normalised per class where the
class's maximum is positive; padding classes take -1. Frame 0's mask is
the given annotation.

Scores are computed in strips of query rows against the key rows within
the radius: the same numbers as the full product, a part of its work.
``propagate`` also returns each query's ``topk`` best scores, which the
eval holds the program's windowed top-k (row 1) to.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG = float('-inf')


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.sqrt((x * x).sum(-1, keepdim=True)),
                           min=1e-12)


def bank(t: int, precede: int):
    """The candidate frames of query frame ``t``, frame 0 first (twice
    while ``t <= precede``)."""
    return [0] + list(range(max(0, t - precede), t))


def _strip_mask(y0: int, y1: int, k0: int, k1: int, w: int, radius: float,
                device) -> torch.Tensor:
    """(queries of rows [y0, y1), keys of rows [k0, k1)) bool: key within
    ``radius`` of the query."""
    qy = torch.arange(y0, y1, device=device).repeat_interleave(w)
    qx = torch.arange(w, device=device).repeat(y1 - y0)
    ky = torch.arange(k0, k1, device=device).repeat_interleave(w)
    kx = torch.arange(w, device=device).repeat(k1 - k0)
    d2 = (qy[:, None] - ky[None]) ** 2 + (qx[:, None] - kx[None]) ** 2
    return d2.to(torch.float32) < radius * radius


def propagate(feats: torch.Tensor, seg_first: torch.Tensor, precede: int,
              topk: int, temperature: float, neighbor_range: int,
              rows: int = 12) -> Tuple[torch.Tensor, torch.Tensor]:
    """``feats`` (T, h, w, C) fp32, ``seg_first`` (h, w, K) -> (T, h, w, K)
    propagated labels (frame 0 = ``seg_first``) and the (T, h, w, topk)
    best scores of each query, in descending order (frame 0's are 0)."""
    t_total, h, w, c = feats.shape
    k_cls = seg_first.shape[-1]
    radius = float(neighbor_range // 2)
    r = int(np.ceil(radius - 1))
    fn = l2_normalize(feats.float())
    seg = torch.zeros((t_total, h * w, k_cls), dtype=torch.float32,
                      device=feats.device)
    seg[0] = seg_first.reshape(h * w, k_cls).float()
    best = torch.zeros((t_total, h * w, topk), dtype=torch.float32,
                       device=feats.device)
    strips = []
    for y0 in range(0, h, rows):
        y1 = min(h, y0 + rows)
        k0, k1 = max(0, y0 - r), min(h, y1 + r)
        strips.append((y0, y1, k0, k1,
                       _strip_mask(y0, y1, k0, k1, w, radius, feats.device)))
    for t in range(1, t_total):
        frames = bank(t, precede)
        idx = torch.tensor(frames, device=feats.device)
        for y0, y1, k0, k1, allowed in strips:
            q = fn[t, y0:y1].reshape(-1, c)                   # (nq, C)
            keys = fn[idx, k0:k1].reshape(len(frames), -1, c)  # (F, nk, C)
            s = torch.matmul(q, keys.transpose(1, 2)) / temperature
            s = s.masked_fill(~allowed, NEG)                   # (F, nq, nk)
            s = s.permute(1, 0, 2).reshape(q.shape[0], -1)     # (nq, F*nk)
            top, pick = torch.topk(s, topk, dim=1)
            best[t, y0 * w:y1 * w] = top
            nk = (k1 - k0) * w
            frame = idx[pick // nk]
            cell = k0 * w + pick % nk
            vals = seg[frame, cell]                            # (nq, k, K)
            wts = torch.softmax(top, dim=1)
            seg[t, y0 * w:y1 * w] = (wts[..., None] * vals).sum(1)
    return (seg.reshape(t_total, h, w, k_cls),
            best.reshape(t_total, h, w, topk))


def decode(labels: torch.Tensor, out_hw: Tuple[int, int],
           num_classes: int) -> torch.Tensor:
    """(T, h, w, K) labels -> (T, H, W) uint8 masks."""
    preds = []
    for i in range(labels.shape[0]):
        x = labels[i:i + 1].permute(0, 3, 1, 2)
        up = F.interpolate(x, size=out_hw, mode='bilinear',
                           align_corners=False)[0]           # (K, H, W)
        lo = up.amin(dim=(1, 2), keepdim=True)
        hi = up.amax(dim=(1, 2), keepdim=True)
        up = torch.where(hi > 0, (up - lo) / (hi - lo + 1e-12), up)
        up[num_classes:] = -1.0
        preds.append(torch.argmax(up, dim=0).to(torch.uint8))
    return torch.stack(preds)


def first_labels(annotation: np.ndarray, hw: Tuple[int, int]
                 ) -> Tuple[torch.Tensor, int]:
    """Frame 0's annotation (H, W) int -> its one-hot (h, w, K) labels at
    the feature size (PIL's nearest resampling, as DAVIS evaluations
    take it) with K the classes rounded up to 4 (at least 2), and the
    number of classes."""
    from PIL import Image
    small = np.asarray(Image.fromarray(annotation.astype(np.float32)).resize(
        (hw[1], hw[0]), resample=Image.NEAREST)).astype(np.int64)
    num_classes = int(annotation.max()) + 1
    k_pad = -(-max(num_classes, 2) // 4) * 4
    return torch.from_numpy(np.eye(k_pad, dtype=np.float32)[small]), \
        num_classes
