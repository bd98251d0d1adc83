"""Whole-video label propagation (PyTorch counterpart of
``vfs_tpu/ops/propagation.py``).

Two engines of the local configuration (``neighbor_range`` set,
``with_first``, ``with_first_neighbor`` and ``with_norm`` True), which
every eval config of the repo takes:

- the decoupled two-phase engine (``backend='pallas_video'`` or
  ``'tiled'``):

  - phase 1, ``video_topk_affinity``: for every frame at once, the top-k
    scores and source cells over the bank (frame 0 plus the ``P``
    preceding frames, circle-masked). Selection depends only on features,
    so it needs no frame loop. ``backend='pallas_video'`` with
    ``video_engine`` other than ``'v2'`` runs it through the v1 engine,
    ``video_topk_affinity_v1`` (the same function), as the JAX package
    does;
  - phase 2, ``propagate_labels``: the softmax-weighted label gather, the
    only sequential part (frame ``t`` reads labels propagated to earlier
    frames);

- the per-step scan (``backend='pallas'``): a frame loop over a bank of
  ``P + 1`` slots, each step one ``local_topk_attend`` (selection, softmax
  and gather fused), in the mode ``pallas_scores`` and ``pallas_extract``
  give (the exact one by default; ``'bfloat16'`` scores and ``'packed'``
  select by a coarser key, as the JAX package's scan does).

The other configurations take the dense scan (``_propagate_video_dense``,
plain PyTorch, as in the JAX package): the non-local masked path
(``neighbor_range`` None, or ``with_first_neighbor=False``, which exempts
the first slot from the mask), ``with_first=False`` and ``with_norm=False``;
each step is ``attend_one_frame``, per-frame top-k candidates merged
across the bank.

Results match the JAX package's scan tiers, including the reference's
frame-0 duplication while ``t <= precede_frames`` and its tie order.

Every radius and top-k that the JAX package takes runs here too: on the
card each of the local engines' kernels (``video_topk_affinity``, its v1
engine and ``local_topk_attend``) launches its tuned core where the core
takes the radius and top-k (``neighbor_range <= 65``, i.e. ``r <= 31``,
and ``topk <= 32``) and the wide kernel (``csrc/window_topk_wide.cu``)
otherwise; no path here chooses. The one size the JAX package refuses, the packed scan
(``pallas_extract='packed'``) with more than 65536 keys in a TPU tile's
bank (``pallas_attention.py:471-475``: its 16-bit key index), raises
``ValueError`` here as well (``packed_keys``), so that a config runs under
both packages or neither.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import trace
from .affinity import NEG_INF, l2_normalize, spatial_neighbor, \
    topk_first_index
from .local_attention import check_mode, local_topk_attend
from .video_affinity import video_topk_affinity
from .video_affinity_v1 import video_topk_affinity_v1
from .window_geometry import window_offset

# the packed scan's key index is 16 bits in the JAX package
PACKED_MAX_KEYS = 65536


class PropagationConfig(NamedTuple):
    """The JAX package's fields and defaults, so one ``test_cfg`` drives
    both packages. In the local configuration, ``backend``
    ``'pallas_video'``, ``'tiled'`` and ``'dense'`` run the decoupled
    engine (their results are identical in the JAX package, where
    ``'dense'`` and ``'tiled'`` are one path); ``'pallas'`` runs the
    per-step scan. ``query_chunk`` sets the dense scan's query chunk.

    With ``backend='pallas_video'``, ``video_engine`` picks phase 1's
    kernel: ``'v2'`` the v2 engine, any other value the v1 engine, whose
    ``video_extract`` (``'sweep'`` or ``'perframe'``, else ``ValueError``)
    and ``video_early_exit`` reach its kernel; an explicit
    ``video_bank_splits > 1`` with ``'perframe'`` raises ``ValueError``,
    as in the JAX package. With ``backend='pallas'``, ``pallas_scores``
    (``'float32'`` or ``'bfloat16'``) and ``pallas_extract`` (``'mask'``,
    ``'descent'`` or ``'packed'``) pick the scan kernel's mode
    (``local_attention``'s ``scores`` and ``extract``; ``'mask'`` and
    ``'descent'`` are both exact); other values, and ``'packed'`` with
    ``'bfloat16'`` scores, raise ``ValueError`` as in the JAX package. The
    other backends ignore them, as the JAX package's do. The rest are TPU
    layout keys, exact either way in the JAX package, accepted here with
    no effect: ``pallas_tile``, ``pallas_fetch``, ``pallas_store``,
    ``pallas_matmul``, ``pallas_group_frames``, ``pallas_interpret``,
    ``tile``, ``video_bank_splits``,
    ``video_sweep_rows``, ``video_pass_mode``, ``video_qpair`` and
    ``video_compact``. ``pallas_precision`` (``'float32'`` or
    ``'bfloat16'``) sets the feature type of the ``'pallas'`` and
    ``'pallas_video'`` paths (module docstring)."""
    precede_frames: int = 20
    topk: int = 10
    temperature: float = 0.07
    with_first: bool = True
    with_first_neighbor: bool = True
    with_norm: bool = True
    query_chunk: int = 1284
    neighbor_range: Optional[int] = None
    tile: tuple = (12, 16)
    backend: str = 'tiled'
    pallas_tile: tuple = (8, 8)
    pallas_scores: str = 'float32'
    pallas_fetch: str = 'perframe'
    pallas_precision: str = 'float32'
    pallas_store: str = 'concat'
    pallas_matmul: str = 'perframe'
    pallas_group_frames: Optional[int] = None
    pallas_extract: str = 'mask'
    pallas_interpret: bool = False
    video_early_exit: bool = True
    video_extract: str = 'sweep'
    video_bank_splits: Optional[int] = None
    video_sweep_rows: int = 1
    video_pass_mode: str = 'maxfirst'
    video_engine: str = 'v2'
    video_qpair: int = 0
    video_compact: bool = True


# the paths on which pallas_precision casts the features
PALLAS_BACKENDS = ('pallas', 'pallas_video')


def _check_supported(cfg: PropagationConfig) -> None:
    """Raise ``ValueError`` for an unknown backend, feature type or scan
    kernel mode."""
    if cfg.backend not in ('pallas', 'pallas_video', 'tiled', 'dense'):
        raise ValueError(f'unknown backend {cfg.backend!r}; use '
                         "'pallas', 'pallas_video', 'tiled' or 'dense'")
    if cfg.backend in PALLAS_BACKENDS and cfg.pallas_precision not in (
            'float32', 'bfloat16'):
        raise ValueError("pallas_precision must be 'float32' or "
                         f"'bfloat16', got {cfg.pallas_precision!r}")
    if cfg.backend == 'pallas':
        check_mode(cfg.pallas_scores, cfg.pallas_extract)


def packed_keys(cfg: PropagationConfig) -> int:
    """The keys of the JAX package's packed scan kernel a query tile: the
    ``P + 1`` slots' key blocks of ``(th + 2r) x (tw + 2 rw)`` cells,
    ``rw`` = r rounded up to 8, each rounded up to 128
    (``pallas_attention.py:236-241``, ``total_k``), for the config's
    ``pallas_tile`` ``(th, tw)`` and ``r = ceil(neighbor_range // 2 - 1)``."""
    th, tw = cfg.pallas_tile
    r = window_offset(cfg.neighbor_range // 2)
    rw = -(-r // 8) * 8
    block = -(-(th + 2 * r) * (tw + 2 * rw) // 128) * 128
    return (cfg.precede_frames + 1) * block


def propagate_labels(scores: torch.Tensor, src: torch.Tensor,
                     seg_first: torch.Tensor) -> torch.Tensor:
    """Phase 2: ``seg[t] = sum_k softmax(scores[t])_k * seg[src[t]_k]``
    frame by frame. ``scores``/``src`` ``(T, h, w, k)``; ``seg_first``
    ``(h, w, K)``. Returns ``(T, h, w, K)`` logits, frame 0 = seg_first."""
    t_total, h, w, _ = scores.shape
    k_classes = seg_first.shape[-1]
    weights = torch.softmax(scores, dim=-1)
    seg_all = torch.zeros((t_total * h * w, k_classes), dtype=torch.float32,
                          device=scores.device)
    seg_all[:h * w] = seg_first.reshape(h * w, k_classes)
    for t in range(1, t_total):
        vals = seg_all[src[t]]                       # (h, w, k, K)
        out = (weights[t][..., None] * vals).sum(-2)  # (h, w, K)
        seg_all[t * h * w:(t + 1) * h * w] = out.reshape(h * w, k_classes)
    return seg_all.view(t_total, h, w, k_classes)


def propagate_video(feats: torch.Tensor, seg_first: torch.Tensor,
                    mask: Optional[torch.Tensor],
                    cfg: PropagationConfig) -> torch.Tensor:
    """Propagate first-frame labels through a video.

    Args:
        feats: (T, H, W, C) backbone features (frame 0 first), on the
            device the work runs on.
        seg_first: (H, W, K) one-hot (or soft) frame-0 labels at feature
            resolution.
        mask: (HW, HW) bool [key_pos, query_pos] spatial mask of the dense
            scan, or None; unused by the local engines. With
            ``neighbor_range`` set and ``with_first=False`` the dense scan
            builds the circle mask itself.
        cfg: PropagationConfig.

    Returns:
        (T, H, W, K) label logits; frame 0 is ``seg_first``.

    The decoupled engines run in two spans (``utils.trace``):
    ``propagation.affinity`` (the windowed top-k: row 1, row 2 or the
    wide entry) and ``propagation.labels`` (``propagate_labels``).
    """
    _check_supported(cfg)
    seg_first = seg_first.to(torch.float32)
    if feats.shape[0] < 2:
        return seg_first[None][:feats.shape[0]]
    feats = feats.to(torch.float32)
    use_local = (cfg.neighbor_range is not None and cfg.with_first_neighbor
                 and cfg.with_norm)
    if not (use_local and cfg.with_first):
        if use_local:
            mask = spatial_neighbor(feats.shape[1], feats.shape[2],
                                    cfg.neighbor_range, device=feats.device)
        elif mask is not None:
            mask = mask.to(feats.device)
        return _propagate_video_dense(feats, seg_first, mask, cfg)
    feats = l2_normalize(feats, dim=-1)
    if cfg.backend in PALLAS_BACKENDS and cfg.pallas_precision == 'bfloat16':
        feats = feats.to(torch.bfloat16)
    feats = feats.contiguous()
    if cfg.backend == 'pallas':
        return _propagate_video_scan(feats, seg_first, cfg)
    radius = float(cfg.neighbor_range // 2)
    with trace.span('propagation.affinity'):
        if cfg.backend == 'pallas_video' and cfg.video_engine != 'v2':
            scores, src = video_topk_affinity_v1(
                feats, radius, cfg.temperature, cfg.topk,
                cfg.precede_frames, early_exit=cfg.video_early_exit,
                extract=cfg.video_extract, bank_splits=cfg.video_bank_splits)
        else:
            scores, src = video_topk_affinity(
                feats, radius, cfg.temperature, cfg.topk, cfg.precede_frames)
    with trace.span('propagation.labels'):
        return propagate_labels(scores, src, seg_first)


def _propagate_video_scan(feats: torch.Tensor, seg_first: torch.Tensor,
                          cfg: PropagationConfig) -> torch.Tensor:
    """The per-step scan over normalised ``feats`` (``backend='pallas'``),
    in the JAX package's bank layout: slot 0 holds frame 0; slots 1..P are
    the ring, frame ``f`` in slot ``1 + f % P`` (slot 1 starts as frame 0,
    so frame 0 is a key twice while ``t <= P``); slot ``1 + j`` is valid
    iff ``j < t``. Each step attends, then its slot takes the query's
    features and logits. The bank is updated in place; its features have
    ``feats``' type (bf16 under ``pallas_precision='bfloat16'``), its
    values are fp32. The packed mode raises ``ValueError`` where the JAX
    package's does (``packed_keys`` > ``PACKED_MAX_KEYS``)."""
    if cfg.pallas_extract == 'packed' and \
            packed_keys(cfg) > PACKED_MAX_KEYS:
        raise ValueError(
            "pallas_extract='packed' packs the flat key index into 16 bits "
            f'in the JAX package: {packed_keys(cfg)} keys a tile > '
            f"{PACKED_MAX_KEYS} (use 'mask')")
    t_total, h, w, _ = feats.shape
    p = cfg.precede_frames
    dev = feats.device
    bank_feats = feats.new_zeros((p + 1,) + tuple(feats.shape[1:]))
    bank_feats[0] = bank_feats[1] = feats[0]
    bank_vals = seg_first.new_zeros((p + 1,) + tuple(seg_first.shape))
    bank_vals[0] = bank_vals[1] = seg_first
    # row t: the slots live for query frame t
    steps = torch.arange(t_total, device=dev)[:, None]
    valid = torch.cat([torch.ones((t_total, 1), dtype=torch.bool,
                                  device=dev),
                       torch.arange(p, device=dev)[None] < steps], 1)
    valid = valid.to(torch.int32)
    out = seg_first.new_empty((t_total,) + tuple(seg_first.shape))
    out[0] = seg_first
    radius = float(cfg.neighbor_range // 2)
    for t in range(1, t_total):
        seg = local_topk_attend(feats[t], bank_feats, bank_vals, valid[t],
                                radius, cfg.temperature, cfg.topk,
                                cfg.pallas_scores, cfg.pallas_extract)[0]
        slot = 1 + t % p
        bank_feats[slot] = feats[t]
        bank_vals[slot] = seg
        out[t] = seg
    return out


def _frame_topk(q_chunk: torch.Tensor, feat: torch.Tensor, seg: torch.Tensor,
                mask_chunk: Optional[torch.Tensor], valid: torch.Tensor,
                temperature: float, topk: int):
    """Top-k candidates of one key frame: ``q_chunk`` (Q, C) and ``feat``
    (HW, C) (normalised as the config says), ``seg`` (HW, K) values,
    ``mask_chunk`` (HW, Q) bool or None, ``valid`` () bool. Returns (Q, topk)
    scores and (Q, topk, K) values, ties to the lowest position."""
    scores = (q_chunk @ feat.T) / temperature
    if mask_chunk is not None:
        scores = torch.where(mask_chunk.T, scores, NEG_INF)
    scores = torch.where(valid, scores, NEG_INF)
    top_scores, top_idx = topk_first_index(scores, topk)
    return top_scores, seg[top_idx]


def attend_one_frame(query_feat: torch.Tensor, bank_feats: torch.Tensor,
                     bank_segs: torch.Tensor, bank_valid: torch.Tensor,
                     bank_masked: torch.Tensor, mask: Optional[torch.Tensor],
                     cfg: PropagationConfig) -> torch.Tensor:
    """Masked top-k attention of one query frame against the bank, in
    chunks of ``cfg.query_chunk`` queries: each bank slot's top-k
    candidates merge into a running list (slot order first, so ties go to
    the lowest (slot, position)), then softmax and the weighted sum.

    Args:
        query_feat: (H, W, C).
        bank_feats: (F, H, W, C); bank_segs: (F, H, W, K).
        bank_valid: (F,) bool, whether each slot holds a live frame.
        bank_masked: (F,) bool, whether the spatial mask applies to the
            slot (False: the reference's ``non_mask_len`` exemption).
        mask: (HW, HW) bool [key_pos, query_pos] or None.
    Returns:
        (H, W, K) propagated logits.
    """
    f, h, w, c = bank_feats.shape
    k_classes = bank_segs.shape[-1]
    hw = h * w
    q = query_feat.reshape(hw, c)
    feats = bank_feats.reshape(f, hw, c)
    segs = bank_segs.reshape(f, hw, k_classes)
    if cfg.with_norm:
        q = l2_normalize(q, dim=-1)
        feats = l2_normalize(feats, dim=-1)
    chunk = cfg.query_chunk
    outs = []
    for start in range(0, hw, chunk):
        q_c = q[start:start + chunk]
        m_c = None if mask is None else mask[:, start:start + chunk]
        best_s = q_c.new_full((q_c.shape[0], cfg.topk), NEG_INF)
        best_v = q_c.new_zeros((q_c.shape[0], cfg.topk, k_classes))
        for j in range(f):
            mc = None if m_c is None else torch.where(bank_masked[j], m_c,
                                                      True)
            s, v = _frame_topk(q_c, feats[j], segs[j], mc, bank_valid[j],
                               cfg.temperature, cfg.topk)
            best_s, sel = topk_first_index(torch.cat([best_s, s], 1),
                                           cfg.topk)
            best_v = torch.gather(torch.cat([best_v, v], 1), 1,
                                  sel[..., None].expand(-1, -1, k_classes))
        weights = torch.softmax(best_s, dim=-1)
        outs.append(torch.einsum('qk,qkc->qc', weights, best_v))
    return torch.cat(outs, 0).reshape(h, w, k_classes)


def _propagate_video_dense(feats: torch.Tensor, seg_first: torch.Tensor,
                           mask: Optional[torch.Tensor],
                           cfg: PropagationConfig) -> torch.Tensor:
    """The JAX package's dense scan: a window ring of ``P`` slots, frame
    ``f`` in slot ``f % P`` (slot 0 starts as frame 0; slot ``j`` is live
    for query frame ``t`` iff ``j < t``), with frame 0 prepended as an
    extra slot under ``with_first`` (its mask waived unless
    ``with_first_neighbor``). Each step attends (``attend_one_frame``),
    then the query's slot takes its features and logits.

    Slots not yet live are left out of the bank: their keys score
    ``NEG_INF`` in the JAX package, which take weight 0 beside any finite
    score, and every query has one (no mask, the first slot unmasked, or
    a circle mask that holds the query's own cell)."""
    t_total, h, w, c = feats.shape
    p = cfg.precede_frames
    dev = feats.device
    if cfg.with_norm:  # normalising once equals normalising each step
        feats = l2_normalize(feats, dim=-1)
        cfg = cfg._replace(with_norm=False)
    ring_feat = feats.new_zeros((p, h, w, c))
    ring_seg = seg_first.new_zeros((p,) + tuple(seg_first.shape))
    ring_feat[0] = feats[0]
    ring_seg[0] = seg_first
    out = seg_first.new_empty((t_total,) + tuple(seg_first.shape))
    out[0] = seg_first
    ones = torch.ones((p,), dtype=torch.bool, device=dev)
    for t in range(1, t_total):
        live = min(t, p)
        bank_feats, bank_segs = ring_feat[:live], ring_seg[:live]
        valid = torch.arange(live, device=dev) < t
        masked = ones[:live]
        if cfg.with_first:
            bank_feats = torch.cat([feats[:1], bank_feats], 0)
            bank_segs = torch.cat([seg_first[None], bank_segs], 0)
            valid = torch.cat([ones[:1], valid], 0)
            masked = torch.cat([torch.full((1,), cfg.with_first_neighbor,
                                           device=dev), masked], 0)
        seg = attend_one_frame(feats[t], bank_feats, bank_segs, valid,
                               masked, mask, cfg)
        ring_feat[t % p] = feats[t]
        ring_seg[t % p] = seg
        out[t] = seg
    return out
