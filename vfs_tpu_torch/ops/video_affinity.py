"""Masked top-k video affinity: phase 1 of label propagation.

PyTorch counterpart of ``vfs_tpu/ops/pallas_affinity_video.py``
(``video_topk_affinity2``, the default engine of the decoupled path). The
TPU kernel's layout tricks (VMEM key ring, query-frame pairing, compact
lanes, bank splits, 128-lane padding) are not part of the contract; the
results are:

- ``feats`` is ``(T, h, w, C)`` fp32 or bf16 (the JAX package's
  ``pallas_precision='bfloat16'``: bf16 features, products summed in
  fp32), contiguous and already L2-normalised.
- For every frame ``t >= 1`` and query cell, the exact top-k of
  ``dot(q, key) * float32(1 / temperature)`` over the bank positions
  ``j = 0..P``: ``j = 0`` is frame 0; ``j = s + 1`` is ring slot ``s``,
  holding frame ``t-1 - ((t-1-s) mod P)`` and live iff ``s <= t-1`` (so
  frame 0 is a key twice while ``t <= P``). Keys lie inside the circle
  ``float(dy^2 + dx^2) < radius^2`` and inside the map.
- Ties go to the lowest ``(j, ky, kx)``.
- Returns ``scores`` ``(T, h, w, k)`` fp32 and ``src`` ``(T, h, w, k)``
  int64, ``src = f*h*w + ky*w + kx``. Where a query has fewer than ``k``
  valid keys, the rest are filler: score ``NEG_INF`` (softmax weight 0)
  and ``src`` = the query's own cell in frame 0. Row 0 is zero.

A CPU tensor takes the plain version, ``video_topk_affinity_reference``;
a CUDA tensor launches a hand-written kernel or raises: where the core's
limits hold (``window_geometry.core_takes``: r <= 31, topk <= 32), fp32
features of ``C >= TC_MIN_CHANNELS`` channels take the tensor-core path
(``csrc/video_topk_tc.cu``: a TF32 pre-score picks candidates, the fmaf
chain re-ranks them; ``window_geometry.tc_takes``) and the rest the tuned
FFMA core (``csrc/video_topk_affinity.cu``, its bf16 entry for bf16
features), both with the same outputs bit for bit; past those limits the
wide kernel (``csrc/window_topk_wide.cu``), which takes any, as the JAX
package does. While a ``utils.trace`` recording is open, the tensor-core
path counts the keys it re-scored and the queries its list could not
settle, read at the tracker's readback (``flush_counts``:
``row1.rescored_pairs``, ``row1.overflow_queries``). The plain version widens bf16 features to fp32 and
runs the fp32 path: a bf16 product is exact in fp32, so the kernel's bf16
scores are its fp32 scores on the widened features.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from ..utils import trace
from . import _build
from .affinity import NEG_INF
from .window_geometry import (WIDE_KERNEL_NAME, band_tensor, core_takes,
                              data_ptr, norm_grow, plan_args,
                              prescore_margin, tc_takes, tc_workspace_ints,
                              wide_lists, wide_plan, window_plan)

KERNEL_NAME = 'video_topk_affinity'
TC_KERNEL_NAME = 'video_topk_tc'
# the tensor-core path's counters, in the order of its C entry's stats
TC_COUNTS = ('row1.rescored_pairs', 'row1.overflow_queries')


def circle_offsets(radius: float, device=None):
    """Window offsets ``(dy, dx)`` in row-major order with
    ``float(dy^2 + dx^2) < radius^2``; ``r = ceil(radius - 1)`` is the
    largest offset. Returns ``(r, dy, dx)``."""
    r = int(math.ceil(radius - 1))
    d = torch.arange(-r, r + 1, device=device)
    dy, dx = torch.meshgrid(d, d, indexing='ij')
    dy, dx = dy.reshape(-1), dx.reshape(-1)
    keep = (dy.float()**2 + dx.float()**2) < radius * radius
    return r, dy[keep], dx[keep]


def bank_frame(t: int, j: int, precede_frames: int) -> Optional[int]:
    """Source frame of bank position ``j`` for query frame ``t``, or None
    while the ring slot is not live."""
    if j == 0:
        return 0
    s = j - 1
    if s > t - 1:
        return None
    return t - 1 - ((t - 1 - s) % precede_frames)


def video_topk_affinity_reference(feats: torch.Tensor, radius: float,
                                  temperature: float, topk: int,
                                  precede_frames: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: dense per-frame score matrices
    (bf16 features widened to fp32 first), the window gathered in ``(j,
    dy, dx)`` order, selection by a stable descending sort
    (``torch.topk``'s tie order is unspecified)."""
    feats = feats.float()
    t_total, h, w, c = feats.shape
    dev = feats.device
    hw = h * w
    p = precede_frames
    _, dy, dx = circle_offsets(radius, dev)
    ky = torch.arange(h, device=dev).view(h, 1, 1) + dy
    kx = torch.arange(w, device=dev).view(1, w, 1) + dx
    inb = ((ky >= 0) & (ky < h) & (kx >= 0) & (kx < w)).reshape(hw, -1)
    key_pos = (ky.clamp(0, h - 1) * w + kx.clamp(0, w - 1)).reshape(hw, -1)
    own = torch.arange(hw, device=dev)[:, None]
    inv_tau = torch.tensor(1.0 / temperature, dtype=torch.float32,
                           device=dev)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)

    scores = torch.zeros((t_total, h, w, topk), dtype=torch.float32,
                         device=dev)
    src = torch.zeros((t_total, h, w, topk), dtype=torch.int64, device=dev)
    for t in range(1, t_total):
        q = feats[t].reshape(hw, c)
        cand, cand_src, valid = [], [], []
        for j in range(p + 1):
            f = bank_frame(t, j, p)
            if f is None:
                cand.append(neg.expand(key_pos.shape))
                cand_src.append(key_pos)
                valid.append(torch.zeros_like(inb))
                continue
            s = (q @ feats[f].reshape(hw, c).T) * inv_tau
            cand.append(torch.where(inb, s.gather(1, key_pos), neg))
            cand_src.append(f * hw + key_pos)
            valid.append(inb)
        cand = torch.cat(cand, 1)
        order = torch.sort(cand, dim=1, descending=True,
                           stable=True).indices[:, :topk]
        ok = torch.cat(valid, 1).gather(1, order)
        top_s = torch.where(ok, cand.gather(1, order), neg)
        top_src = torch.where(ok, torch.cat(cand_src, 1).gather(1, order),
                              own)
        scores[t] = top_s.view(h, w, topk)
        src[t] = top_src.view(h, w, topk)
    return scores, src


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL_NAME)
    for fn in (lib.vfs_video_topk_affinity, lib.vfs_video_topk_affinity_bf16):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


# channels of one 16-byte vector: the kernels stage whole vectors, so C is
# a multiple of it
QUAD_CHANNELS = {torch.float32: 4, torch.bfloat16: 8}


def check_feature_dtype(name: str, t: torch.Tensor) -> None:
    """Raise ``TypeError`` unless ``t`` is fp32 or bf16, and
    ``ValueError`` unless C (its last dim) is a multiple of a 16-byte
    vector's channels (4 fp32, 8 bf16) and its data 16-byte aligned."""
    quad = QUAD_CHANNELS.get(t.dtype)
    if quad is None:
        raise TypeError(f'expected float32 or bfloat16 {name}, got '
                        f'{t.dtype}')
    if t.shape[-1] % quad or t.data_ptr() % 16:
        raise ValueError(f'the kernel reads 16-byte vectors: C of {name} '
                         f'must be a multiple of {quad} for {t.dtype} and '
                         'the data 16-byte aligned')


def check_features(feats: torch.Tensor, precede_frames: int) -> None:
    """Raise on features the CUDA kernels of this contract do not take."""
    if feats.device.type != 'cuda':
        raise ValueError(f'expected a CUDA tensor, got {feats.device}')
    if feats.dim() != 4 or not feats.is_contiguous():
        raise ValueError('expected contiguous (T, h, w, C) features, got '
                         f'shape {tuple(feats.shape)} strides '
                         f'{feats.stride()}')
    check_feature_dtype('features', feats)
    if precede_frames < 1:
        raise ValueError('precede_frames must be >= 1')


def _wide_library() -> ctypes.CDLL:
    lib = _build.load(WIDE_KERNEL_NAME)
    for fn in (lib.vfs_video_topk_wide, lib.vfs_video_topk_wide_bf16):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _tc_library() -> ctypes.CDLL:
    lib = _build.load(TC_KERNEL_NAME)
    lib.vfs_video_topk_tc.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int), ctypes.c_float,
                             ctypes.c_int, ctypes.c_int] + [
        ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]
    lib.vfs_video_topk_tc.restype = ctypes.c_int
    lib.vfs_video_topk_mma_check.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.vfs_video_topk_mma_check.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# counters of launches made while a trace records, read by flush_counts
_pending = []


def flush_counts() -> None:
    """Add the tensor-core path's counters of the launches made since the
    last call to the open ``utils.trace`` recording (``TC_COUNTS``). The
    tracker calls it after its readback, when the device is done, so the
    copy waits for nothing; outside a recording there is nothing to
    read."""
    while _pending:
        values = _pending.pop(0).tolist()
        if trace.active():
            for name, n in zip(TC_COUNTS, values):
                trace.count(name, int(n))


def _alloc_outputs(feats: torch.Tensor, topk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    t_total, h, w, _ = feats.shape
    scores = torch.empty((t_total, h, w, topk), dtype=torch.float32,
                         device=feats.device)
    src = torch.empty((t_total, h, w, topk), dtype=torch.int64,
                      device=feats.device)
    scores[0] = 0
    src[0] = 0
    return scores, src


def launch_tc(feats: torch.Tensor, radius: float, temperature: float,
              topk: int, precede_frames: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row 1's function on the tensor-core path (``csrc/video_topk_tc.cu``)
    for fp32 features at any C and the core's radii and top-k, on
    ``feats``' device and current stream; counts no launch but, while a
    trace records, its counters (``flush_counts``). Checks and timings call
    it to force the path."""
    plan = window_plan(radius, topk)
    check_features(feats, precede_frames)
    if feats.dtype != torch.float32:
        raise TypeError(f'the tensor-core path takes float32 features, got '
                        f'{feats.dtype}')
    scores, src = _alloc_outputs(feats, topk)
    t_total, h, w, c = feats.shape
    if t_total < 2:
        return scores, src
    dev = feats.device
    units_grid = _sm_count(dev.index if dev.index is not None
                          else torch.cuda.current_device())
    work = torch.empty(tc_workspace_ints(t_total, h, w, precede_frames,
                                         plan.r, units_grid),
                       dtype=torch.int32, device=dev)
    stats = None
    if trace.active():
        stats = torch.zeros(len(TC_COUNTS), dtype=torch.int64, device=dev)
        _pending.append(stats)
    inv_tau = 1.0 / temperature
    coef, absolute = prescore_margin(c, float(ctypes.c_float(inv_tau).value))
    with torch.cuda.device(dev):
        err = _tc_library().vfs_video_topk_tc(
            feats.data_ptr(), scores.data_ptr(), src.data_ptr(),
            work.data_ptr(), data_ptr(stats), t_total, h, w, c,
            *plan_args(plan), inv_tau, topk, precede_frames, coef, absolute,
            norm_grow(c), units_grid, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{TC_KERNEL_NAME} kernel launch failed: CUDA '
                           f'error {err}')
    return scores, src


def launch_core(feats: torch.Tensor, radius: float, temperature: float,
                topk: int, precede_frames: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row 1's function on the FFMA core (its bf16 entry for bf16
    features) at any C, on ``feats``' device and current stream; counts
    nothing. Checks and timings call it to force the path."""
    plan = window_plan(radius, topk)
    check_features(feats, precede_frames)
    scores, src = _alloc_outputs(feats, topk)
    t_total, h, w, c = feats.shape
    if t_total < 2:
        return scores, src
    lib = _library()
    fn = (lib.vfs_video_topk_affinity_bf16 if feats.dtype == torch.bfloat16
          else lib.vfs_video_topk_affinity)
    with torch.cuda.device(feats.device):
        err = fn(feats.data_ptr(), scores.data_ptr(), src.data_ptr(),
                 t_total, h, w, c, *plan_args(plan), 1.0 / temperature, topk,
                 precede_frames, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{KERNEL_NAME} kernel launch failed: CUDA '
                           f'error {err}')
    return scores, src


def launch_wide(feats: torch.Tensor, radius: float, temperature: float,
                topk: int, precede_frames: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows 1 and 2's function by the wide kernel, on ``feats``' device and
    current stream, for any ``radius`` and ``topk``; counts nothing (its
    callers do). Raises ValueError for ``r < 0`` or ``topk < 1``."""
    plan = wide_plan(radius, topk)
    check_features(feats, precede_frames)
    t_total, h, w, c = feats.shape
    dev = feats.device
    scores = torch.empty((t_total, h, w, topk), dtype=torch.float32,
                         device=dev)
    src = torch.empty((t_total, h, w, topk), dtype=torch.int64, device=dev)
    scores[0] = 0
    src[0] = 0
    if t_total < 2:
        return scores, src
    # scratch: two running lists a query and frame past topk = KMAX
    list_s, list_o = wide_lists(plan.video_lists(t_total, h, w), dev)
    band = band_tensor(plan.band, dev)
    lib = _wide_library()
    fn = (lib.vfs_video_topk_wide_bf16 if feats.dtype == torch.bfloat16
          else lib.vfs_video_topk_wide)
    with torch.cuda.device(dev):
        err = fn(feats.data_ptr(), scores.data_ptr(), src.data_ptr(),
                 data_ptr(list_s), data_ptr(list_o), t_total, h, w, c,
                 plan.r, band.data_ptr(), 1.0 / temperature, topk,
                 precede_frames, plan.pass_group, plan.key_rows,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{WIDE_KERNEL_NAME} kernel launch failed: CUDA '
                           f'error {err}')
    return scores, src


def video_topk_affinity_wide_cuda(feats: torch.Tensor, radius: float,
                                  temperature: float, topk: int,
                                  precede_frames: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wide kernel at any radius and top-k, core sizes included (where
    its outputs equal the core's bit for bit): an op, for checks and
    timing. ``video_topk_affinity_wide_cuda.launches`` counts its
    launches."""
    out = launch_wide(feats, radius, temperature, topk, precede_frames)
    video_topk_affinity_wide_cuda.launches += feats.shape[0] >= 2
    return out


video_topk_affinity_wide_cuda.launches = 0


def video_topk_affinity_cuda(feats: torch.Tensor, radius: float,
                             temperature: float, topk: int,
                             precede_frames: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch a CUDA kernel on ``feats``' device and current stream: the
    tensor-core path or the core where the core's limits hold
    (``tc_takes``), else the wide kernel.
    ``video_topk_affinity_cuda.launches`` counts the launches of the first
    two, ``.tc_launches`` those of the tensor-core path, ``.bf16_launches``
    those of the core's bf16 entry, ``.wide_launches`` the wide kernel's.
    The path is chosen before anything else."""
    if not core_takes(radius, topk):
        out = launch_wide(feats, radius, temperature, topk, precede_frames)
        video_topk_affinity_cuda.wide_launches += feats.shape[0] >= 2
        return out
    tc = tc_takes(feats.shape[-1], feats.dtype)
    out = (launch_tc if tc else launch_core)(feats, radius, temperature, topk,
                                              precede_frames)
    if feats.shape[0] >= 2:
        video_topk_affinity_cuda.launches += 1
        video_topk_affinity_cuda.tc_launches += tc
        video_topk_affinity_cuda.bf16_launches += (
            feats.dtype == torch.bfloat16)
    return out


video_topk_affinity_cuda.launches = 0
video_topk_affinity_cuda.tc_launches = 0
video_topk_affinity_cuda.bf16_launches = 0
video_topk_affinity_cuda.wide_launches = 0


def video_topk_affinity(feats: torch.Tensor, radius: float,
                        temperature: float, topk: int,
                        precede_frames: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k video affinity (module docstring). CPU tensors take
    the plain version; CUDA tensors the kernel."""
    if feats.device.type == 'cpu':
        return video_topk_affinity_reference(feats, radius, temperature,
                                             topk, precede_frames)
    return video_topk_affinity_cuda(feats, radius, temperature, topk,
                                    precede_frames)
