"""Masked top-k local attention of one query frame: the per-step attention
of the scan-tier propagation (``backend='pallas'``).

PyTorch counterpart of ``vfs_tpu/ops/pallas_attention.py``
(``pallas_local_topk_attend``) and of its XLA twin
``vfs_tpu/ops/local_attention_tiled.py`` (``local_masked_topk_attend``).
The TPU kernel's padded layout (``pad_for_pallas``), tiles, 128-lane
padding and copy modes are not part of the contract; the results are:

- ``query`` (h, w, C) and ``bank_feats`` (F, h, w, C) fp32, or both bf16
  (``pallas_precision='bfloat16'``: products summed in fp32),
  L2-normalised; ``bank_vals`` (F, h, w, K) fp32; ``bank_valid`` (F,) bool
  or int.
- For every query cell, the exact top-k of ``dot(q, key) *
  float32(1 / temperature)`` over the valid slots and the keys inside the
  circle ``float(dy^2 + dx^2) < radius^2`` and inside the map. Ties go to
  the lowest ``(slot, ky, kx)``.
- Returns ``out`` (h, w, K), the softmax-weighted sum of the selected
  values, and for the checks ``scores`` (h, w, k) fp32 and ``src``
  (h, w, k) int64, ``src = slot*h*w + ky*w + kx``. Where a query has fewer
  than ``k`` valid keys the rest are filler: score ``NEG_INF`` (softmax
  weight 0) and ``src`` = the query's own cell in slot 0.

Two inexact modes of the TPU kernel select by a coarser key
(``pallas_attention.py:46-83``, ``:314-340``, ``:553-568``):

- ``scores='bfloat16'`` (``scores_dtype``): the scores rounded to bf16
  (round to nearest even) are selected by and softmaxed, and returned.
- ``extract='packed'`` (``extract_mode``): selection by the scores
  quantised to ``round(clip(s, -15, 15) * 65536 / 30)`` (half to even),
  ties to the lowest ``(slot, ky, kx)``; then the ``k`` picks are
  re-scored exactly, and the softmax takes, and ``scores`` returns, the
  exact scores (no longer sorted). JAX packs the quantised score and the
  flat key index into one int32 and so refuses more than 65536 keys a
  TPU tile; this op does not pack and has no such limit, while the scan
  (``propagation.propagate_video``) refuses what JAX's refuses. JAX's pack
  wraps at ``s >= 14.99977``, which unit features at ``temperature=0.07``
  (``|s| <= 14.29``) never reach; the port does not emulate the wrap.
  Where a query has fewer than ``k`` valid keys JAX's packed mode picks
  masked keys at coordinates clipped in its tile layout; the port keeps
  its filler.

``extract='mask'`` and ``'descent'`` are exact (TPU layout choices).
Packed with bf16 scores raises ``ValueError``, as in the JAX package.

A CPU tensor takes the plain version, ``local_topk_attend_reference``; a
CUDA tensor launches a hand-written kernel or raises: the tuned core
(``vfs_tpu_torch/csrc/local_topk_attend.cu``: one entry per mode and
feature type) where it takes the radius and top-k
(``window_geometry.core_takes``: r <= 31, topk <= 32), else the wide
kernel (``csrc/window_topk_wide.cu``, the same entries), which takes any,
as the JAX package does. The plain version widens bf16 features to fp32
and runs the fp32 path, which gives the kernel's bf16 scores.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .affinity import NEG_INF
from .video_affinity import check_feature_dtype, circle_offsets
from .window_geometry import (WIDE_KERNEL_NAME, band_tensor, core_takes,
                              data_ptr, plan_args, wide_lists, wide_plan,
                              window_plan)

KERNEL_NAME = 'local_topk_attend'

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

SCORES = ('float32', 'bfloat16')
EXTRACTS = ('mask', 'descent', 'packed')
# pallas_attention.PACKED_SCALE; score_key rounds it to fp32 as JAX does
PACKED_SCALE = 65536.0 / 30.0


def check_mode(scores: str, extract: str) -> None:
    """Raise ``ValueError`` on a mode the TPU kernel refuses."""
    if extract not in EXTRACTS:
        raise ValueError(f"extract must be 'mask', 'descent' or 'packed', "
                         f'got {extract!r}')
    if scores not in SCORES:
        raise ValueError(f"scores must be 'float32' or 'bfloat16', got "
                         f'{scores!r}')
    if extract == 'packed' and scores != 'float32':
        raise ValueError("extract='packed' requires scores='float32'")


def score_key(s: torch.Tensor, scores: str, extract: str) -> torch.Tensor:
    """The fp32 key the selection sorts by (window_topk.cuh's
    ``score_key``): the score, its bf16 rounding, or its packed
    quantisation held as a float."""
    if extract == 'packed':
        scale = torch.tensor(PACKED_SCALE, dtype=torch.float32,
                             device=s.device)
        return torch.round(torch.clamp(s, -15.0, 15.0) * scale)
    if scores == 'bfloat16':
        return s.to(torch.bfloat16).to(torch.float32)
    return s


def local_topk_attend_reference(query: torch.Tensor, bank_feats: torch.Tensor,
                                bank_vals: torch.Tensor,
                                bank_valid: torch.Tensor, radius: float,
                                temperature: float, topk: int,
                                scores: str = 'float32',
                                extract: str = 'mask') -> Result:
    """Plain PyTorch version of the kernel: dense per-slot score matrices
    (fp32, bf16 features widened first; on CUDA call it under
    ``exact_fp32``), the window gathered in ``(slot, dy, dx)`` order,
    selection by a stable descending sort of the mode's key (``torch.topk``'s
    tie order is unspecified), softmax and the weighted sum of the
    gathered values. Packed re-scores its picks by a gathered dot."""
    check_mode(scores, extract)
    query, bank_feats = query.float(), bank_feats.float()
    f_total, h, w, c = bank_feats.shape
    k_classes = bank_vals.shape[-1]
    dev = query.device
    hw = h * w
    _, dy, dx = circle_offsets(radius, dev)
    ky = torch.arange(h, device=dev).view(h, 1, 1) + dy
    kx = torch.arange(w, device=dev).view(1, w, 1) + dx
    inb = ((ky >= 0) & (ky < h) & (kx >= 0) & (kx < w)).reshape(hw, -1)
    key_pos = (ky.clamp(0, h - 1) * w + kx.clamp(0, w - 1)).reshape(hw, -1)
    own = torch.arange(hw, device=dev)[:, None]
    inv_tau = torch.tensor(1.0 / temperature, dtype=torch.float32,
                           device=dev)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(bank_valid, device=dev).to(torch.bool)

    q = query.reshape(hw, c)
    cand, cand_src, ok = [], [], []
    for f in range(f_total):
        s = (q @ bank_feats[f].reshape(hw, c).T) * inv_tau
        cand.append(s.gather(1, key_pos))
        cand_src.append(f * hw + key_pos)
        ok.append(inb & valid[f])
    ok = torch.cat(ok, 1)
    cand = torch.where(ok, score_key(torch.cat(cand, 1), scores, extract),
                       neg)
    order = torch.sort(cand, dim=1, descending=True,
                       stable=True).indices[:, :topk]
    sel_ok = ok.gather(1, order)
    top_src = torch.where(sel_ok, torch.cat(cand_src, 1).gather(1, order),
                          own)
    if extract == 'packed':
        keys = bank_feats.reshape(f_total * hw, c)[top_src]  # (hw, k, C)
        cand = (keys @ q[:, :, None])[..., 0] * inv_tau
        order = torch.arange(topk, device=dev).expand(hw, topk)
    top_s = torch.where(sel_ok, cand.gather(1, order), neg)
    weights = torch.softmax(top_s, dim=-1)
    vals = bank_vals.reshape(f_total * hw, k_classes)[top_src]
    out = (weights[..., None] * vals).sum(1)
    return (out.view(h, w, k_classes), top_s.view(h, w, topk),
            top_src.view(h, w, topk))


def entry_name(scores: str, extract: str, feat_dtype: torch.dtype) -> str:
    """The C entry of a mode and feature type."""
    mode = ('_packed' if extract == 'packed' else
            '_scores_bf16' if scores == 'bfloat16' else '')
    feat = '_bf16' if feat_dtype == torch.bfloat16 else ''
    return f'vfs_local_topk_attend{mode}{feat}'


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL_NAME)
    for scores, extract in (('float32', 'mask'), ('bfloat16', 'mask'),
                            ('float32', 'packed')):
        for dtype in (torch.float32, torch.bfloat16):
            fn = getattr(lib, entry_name(scores, extract, dtype))
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
                ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def wide_entry_name(scores: str, extract: str,
                    feat_dtype: torch.dtype) -> str:
    """The wide kernel's C entry of a mode and feature type."""
    return entry_name(scores, extract, feat_dtype).replace(
        'vfs_local_topk_attend', 'vfs_local_topk_wide')


def _wide_library() -> ctypes.CDLL:
    lib = _build.load(WIDE_KERNEL_NAME)
    for scores, extract in (('float32', 'mask'), ('bfloat16', 'mask'),
                            ('float32', 'packed')):
        for dtype in (torch.float32, torch.bfloat16):
            fn = getattr(lib, wide_entry_name(scores, extract, dtype))
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def launch_wide(query: torch.Tensor, bank_feats: torch.Tensor,
                bank_vals: torch.Tensor, bank_valid: torch.Tensor,
                radius: float, temperature: float, topk: int,
                scores: str = 'float32', extract: str = 'mask',
                epilogue: bool = True,
                feat_dtypes=(torch.float32, torch.bfloat16)) -> Result:
    """Rows 3 and 4's function by the wide kernel, on ``query``'s device
    and current stream, for any ``radius`` and ``topk``; counts nothing
    (its callers do). Without ``epilogue`` (row 4) the kernel selects only
    and ``out`` is None. Raises ValueError for ``r < 0`` or ``topk < 1``,
    then on operands (``check_operands``, features of a type in
    ``feat_dtypes``)."""
    check_mode(scores, extract)
    plan = wide_plan(radius, topk)
    check_operands(query, bank_feats, bank_vals, bank_valid, feat_dtypes)
    f_total, h, w, c = bank_feats.shape
    if f_total < 1:
        raise ValueError('the bank holds no slot')
    k_classes = bank_vals.shape[-1]
    dev = query.device
    valid = bank_valid.to(torch.int32).contiguous()
    out = (torch.empty((h, w, k_classes), dtype=torch.float32, device=dev)
           if epilogue else None)
    top_s = torch.empty((h, w, topk), dtype=torch.float32, device=dev)
    src = torch.empty((h, w, topk), dtype=torch.int64, device=dev)
    # scratch: each slot's partial list and a spare buffer a query
    list_s, list_o = wide_lists(plan.local_lists(f_total, h, w), dev)
    band = band_tensor(plan.band, dev)
    fn = getattr(_wide_library(), wide_entry_name(scores, extract,
                                                  query.dtype))
    with torch.cuda.device(dev):
        err = fn(query.data_ptr(), bank_feats.data_ptr(),
                 bank_vals.data_ptr() if epilogue else None,
                 valid.data_ptr(), data_ptr(out), top_s.data_ptr(),
                 src.data_ptr(), data_ptr(list_s), data_ptr(list_o), f_total,
                 h, w, c, k_classes, plan.r, band.data_ptr(),
                 1.0 / temperature, topk, plan.pass_group, plan.key_rows,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{WIDE_KERNEL_NAME} kernel launch failed: CUDA '
                           f'error {err}')
    return out, top_s, src


def local_topk_attend_wide_cuda(query: torch.Tensor,
                                bank_feats: torch.Tensor,
                                bank_vals: torch.Tensor,
                                bank_valid: torch.Tensor, radius: float,
                                temperature: float, topk: int,
                                scores: str = 'float32',
                                extract: str = 'mask') -> Result:
    """The wide kernel at any radius and top-k, core sizes included (where
    its outputs equal the core's bit for bit): an op, for checks and
    timing. ``local_topk_attend_wide_cuda.launches`` counts its
    launches."""
    out = launch_wide(query, bank_feats, bank_vals, bank_valid, radius,
                      temperature, topk, scores, extract)
    local_topk_attend_wide_cuda.launches += 1
    return out


local_topk_attend_wide_cuda.launches = 0


def check_operands(query, bank_feats, bank_vals, bank_valid,
                   feat_dtypes=(torch.float32,)):
    """Raise on operands the CUDA kernels of this contract do not take:
    ``query`` and ``bank_feats`` of one type in ``feat_dtypes``,
    ``bank_vals`` fp32."""
    dev = query.device
    if dev.type != 'cuda':
        raise ValueError(f'expected CUDA tensors, got {dev}')
    for name, t in (('bank_feats', bank_feats), ('bank_vals', bank_vals),
                    ('bank_valid', bank_valid)):
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, query on {dev}')
    if query.dtype not in feat_dtypes or bank_feats.dtype != query.dtype:
        raise TypeError(f'expected query and bank_feats of one type in '
                        f'{feat_dtypes}, got {query.dtype} and '
                        f'{bank_feats.dtype}')
    if bank_vals.dtype != torch.float32:
        raise TypeError(f'expected float32 bank_vals, got {bank_vals.dtype}')
    for name, t in (('query', query), ('bank_feats', bank_feats),
                    ('bank_vals', bank_vals)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous, got strides '
                             f'{t.stride()}')
    if bank_feats.dim() != 4 or query.dim() != 3 \
            or query.shape != bank_feats.shape[1:]:
        raise ValueError('expected query (h, w, C) and bank_feats '
                         f'(F, h, w, C), got {tuple(query.shape)} and '
                         f'{tuple(bank_feats.shape)}')
    if bank_vals.dim() != 4 or bank_vals.shape[:3] != bank_feats.shape[:3]:
        raise ValueError(f'expected bank_vals (F, h, w, K), got '
                         f'{tuple(bank_vals.shape)}')
    if bank_valid.shape != bank_feats.shape[:1]:
        raise ValueError(f'expected bank_valid (F,), got '
                         f'{tuple(bank_valid.shape)}')
    check_feature_dtype('query', query)
    check_feature_dtype('bank_feats', bank_feats)


def local_topk_attend_cuda(query: torch.Tensor, bank_feats: torch.Tensor,
                           bank_vals: torch.Tensor, bank_valid: torch.Tensor,
                           radius: float, temperature: float,
                           topk: int, scores: str = 'float32',
                           extract: str = 'mask') -> Result:
    """Launch a CUDA kernel on ``query``'s device and current stream: the
    core's entry of the mode and of the feature type (bf16 for a bf16 query
    and bank) where the core takes the radius and top-k, else the wide
    kernel's. ``local_topk_attend_cuda.launches`` counts the core's
    launches, ``.bf16_launches`` those with bf16 features,
    ``.scores_bf16_launches`` those with bf16 scores and
    ``.packed_launches`` the packed ones; ``.wide_launches`` counts the
    wide kernel's, in every mode. Raises on a mode the kernels do not take
    before anything else; then chooses the path."""
    check_mode(scores, extract)
    if not core_takes(radius, topk):
        out = launch_wide(query, bank_feats, bank_vals, bank_valid, radius,
                          temperature, topk, scores, extract)
        local_topk_attend_cuda.wide_launches += 1
        return out
    plan = window_plan(radius, topk)
    check_operands(query, bank_feats, bank_vals, bank_valid,
                   (torch.float32, torch.bfloat16))
    f_total, h, w, c = bank_feats.shape
    k_classes = bank_vals.shape[-1]
    if not 1 <= f_total <= 65535:
        raise ValueError(f'{f_total} bank slots: the kernel takes 1..65535')
    valid = bank_valid.to(torch.int32).contiguous()
    out = torch.empty((h, w, k_classes), dtype=torch.float32,
                      device=query.device)
    top_s = torch.empty((h, w, topk), dtype=torch.float32,
                        device=query.device)
    src = torch.empty((h, w, topk), dtype=torch.int64, device=query.device)
    # scratch: each slot's top-k lists, merged by the kernel's second stage
    part_s = torch.empty((f_total, h, w, topk), dtype=torch.float32,
                         device=query.device)
    part_o = torch.empty((f_total, h, w, topk), dtype=torch.int32,
                         device=query.device)
    fn = getattr(_library(), entry_name(scores, extract, query.dtype))
    with torch.cuda.device(query.device):
        err = fn(query.data_ptr(), bank_feats.data_ptr(),
                 bank_vals.data_ptr(), valid.data_ptr(), out.data_ptr(),
                 top_s.data_ptr(), src.data_ptr(), part_s.data_ptr(),
                 part_o.data_ptr(), f_total, h, w, c, k_classes,
                 *plan_args(plan), 1.0 / temperature, topk,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{KERNEL_NAME} kernel launch failed: CUDA '
                           f'error {err}')
    local_topk_attend_cuda.launches += 1
    local_topk_attend_cuda.bf16_launches += query.dtype == torch.bfloat16
    local_topk_attend_cuda.scores_bf16_launches += scores == 'bfloat16'
    local_topk_attend_cuda.packed_launches += extract == 'packed'
    return out, top_s, src


local_topk_attend_cuda.launches = 0
local_topk_attend_cuda.bf16_launches = 0
local_topk_attend_cuda.scores_bf16_launches = 0
local_topk_attend_cuda.packed_launches = 0
local_topk_attend_cuda.wide_launches = 0


def local_topk_attend(query: torch.Tensor, bank_feats: torch.Tensor,
                      bank_vals: torch.Tensor, bank_valid: torch.Tensor,
                      radius: float, temperature: float, topk: int,
                      scores: str = 'float32',
                      extract: str = 'mask') -> Result:
    """Masked top-k local attention (module docstring). CPU tensors take
    the plain version; CUDA tensors the kernel."""
    fn = (local_topk_attend_reference if query.device.type == 'cpu'
          else local_topk_attend_cuda)
    return fn(query, bank_feats, bank_vals, bank_valid, radius, temperature,
              topk, scores, extract)
