"""Masked top-k video affinity by the v1 engine (``video_engine='v1'``).

PyTorch counterpart of ``video_topk_affinity`` in
``vfs_tpu/ops/pallas_affinity_video.py`` (the v1 whole-video kernel). It
computes the function of ``video_affinity`` (the v2 engine), with the same
contract, ``(T, h, w, k)`` layout, filler convention and tie order, so its
plain version is ``video_affinity.video_topk_affinity_reference``. What
differs is the kernel's algorithm
(``vfs_tpu_torch/csrc/video_topk_affinity_v1.cu``): per bank frame, a
frame-local top-k by passes and a merge into each query's running list,
with the tau early exit.

Options, as in the JAX function:

- ``extract``: ``'perframe'`` takes the tau exit when ``early_exit`` is
  set; ``'sweep'`` (the TPU's extraction over every frame's stored
  segment, which has no exit) runs every pass. The lists are the same.
- ``bank_splits``: only bounded the TPU's VMEM ring. It has no effect,
  but an explicit ``bank_splits > 1`` with ``'perframe'`` raises
  ``ValueError`` where the JAX function raises.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build
from .video_affinity import check_features, video_topk_affinity_reference

KERNEL_NAME = 'video_topk_affinity_v1'


def check_v1_options(extract: str, bank_splits: Optional[int]) -> None:
    """The JAX function's argument checks
    (``pallas_affinity_video.py:558-562``)."""
    if extract not in ('sweep', 'perframe'):
        raise ValueError(f"extract must be 'sweep' or 'perframe', "
                         f'got {extract!r}')
    if bank_splits is not None and bank_splits > 1 and extract != 'sweep':
        raise ValueError("bank_splits > 1 requires extract='sweep'")


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL_NAME)
    fn = lib.vfs_video_topk_affinity_v1
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name in ('vfs_video_v1_max_topk', 'vfs_video_v1_max_offset'):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    return lib


def video_topk_affinity_v1_cuda(feats: torch.Tensor, radius: float,
                                temperature: float, topk: int,
                                precede_frames: int, early_exit: bool = True,
                                extract: str = 'sweep',
                                bank_splits: Optional[int] = None,
                                pass_count: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on ``feats``' device and current stream.
    ``video_topk_affinity_v1_cuda.launches`` counts the launches;
    ``pass_count``, a one-element int64 tensor on the same device, adds
    the extraction passes the kernel ran."""
    check_v1_options(extract, bank_splits)
    check_features(feats, precede_frames)
    t_total, h, w, c = feats.shape
    count = _build.counter_ptr(pass_count, feats.device)
    lib = _library()
    r = int(math.ceil(radius - 1))
    if not 0 <= r <= lib.vfs_video_v1_max_offset():
        raise ValueError(f'radius {radius} is outside what the kernel was '
                         f'compiled for (r <= '
                         f'{lib.vfs_video_v1_max_offset()})')
    if not 1 <= topk <= lib.vfs_video_v1_max_topk():
        raise ValueError(f'topk {topk} is outside 1..'
                         f'{lib.vfs_video_v1_max_topk()}')
    scores = torch.empty((t_total, h, w, topk), dtype=torch.float32,
                         device=feats.device)
    src = torch.empty((t_total, h, w, topk), dtype=torch.int64,
                      device=feats.device)
    scores[0] = 0
    src[0] = 0
    if t_total < 2:
        return scores, src
    with torch.cuda.device(feats.device):
        err = lib.vfs_video_topk_affinity_v1(
            feats.data_ptr(), scores.data_ptr(), src.data_ptr(), t_total, h,
            w, c, r, radius * radius, 1.0 / temperature, topk,
            precede_frames, int(early_exit and extract == 'perframe'), count,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{KERNEL_NAME} kernel launch failed: CUDA '
                           f'error {err}')
    video_topk_affinity_v1_cuda.launches += 1
    return scores, src


video_topk_affinity_v1_cuda.launches = 0


def video_topk_affinity_v1(feats: torch.Tensor, radius: float,
                           temperature: float, topk: int,
                           precede_frames: int, early_exit: bool = True,
                           extract: str = 'sweep',
                           bank_splits: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k video affinity, v1 engine (module docstring). CPU
    tensors take the plain version; CUDA tensors the kernel."""
    check_v1_options(extract, bank_splits)
    if feats.device.type == 'cpu':
        return video_topk_affinity_reference(feats, radius, temperature,
                                             topk, precede_frames)
    return video_topk_affinity_v1_cuda(feats, radius, temperature, topk,
                                       precede_frames, early_exit, extract,
                                       bank_splits)
