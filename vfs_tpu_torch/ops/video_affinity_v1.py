"""Masked top-k video affinity by the v1 engine (``video_engine='v1'``).

PyTorch counterpart of ``video_topk_affinity`` in
``vfs_tpu/ops/pallas_affinity_video.py`` (the v1 whole-video kernel). It
computes the function of ``video_affinity`` (the v2 engine), with the same
contract, ``(T, h, w, k)`` layout, filler convention and tie order, so its
plain version is ``video_affinity.video_topk_affinity_reference``. The
kernel (``vfs_tpu_torch/csrc/video_topk_affinity_v1.cu``) runs the
windowed top-k core of row 1 and walks each query frame's bank most
recent first, as the v1 TPU kernel does; its lists equal row 1's bit for
bit.

Options, as in the JAX function:

- ``extract``: ``'perframe'`` takes the tau exit when ``early_exit`` is
  set: a query's candidates of a key row are merged only if one beats
  its list's last entry. ``'sweep'`` (the TPU's extraction over every
  frame's stored segment, which has no exit) merges every query with
  candidates. The lists are the same.
- ``bank_splits``: only bounded the TPU's VMEM ring. It has no effect,
  but an explicit ``bank_splits > 1`` with ``'perframe'`` raises
  ``ValueError`` where the JAX function raises.

Features are fp32 or bf16 (``pallas_precision='bfloat16'``), as for
``video_affinity``. A CPU tensor takes the plain version; a CUDA tensor
launches a kernel or raises: the v1 kernel (its bf16 entry for bf16
features) where the core takes the radius and top-k
(``window_geometry.core_takes``), else row 1's wide kernel
(``csrc/window_topk_wide.cu``, the same function), where the options
change nothing: its lists do not depend on a walk order or an exit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .video_affinity import (check_features, launch_wide,
                             video_topk_affinity_reference)
from .window_geometry import core_takes, plan_args, window_plan

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
    for fn in (lib.vfs_video_topk_affinity_v1,
               lib.vfs_video_topk_affinity_v1_bf16):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_float] + [
                ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def video_topk_affinity_v1_cuda(feats: torch.Tensor, radius: float,
                                temperature: float, topk: int,
                                precede_frames: int, early_exit: bool = True,
                                extract: str = 'sweep',
                                bank_splits: Optional[int] = None,
                                merge_count: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch a CUDA kernel on ``feats``' device and current stream: the
    v1 kernel (its bf16 entry for bf16 features) where the core takes the
    radius and top-k, else the wide kernel.
    ``video_topk_affinity_v1_cuda.launches`` counts the v1 kernel's
    launches, ``.bf16_launches`` those of its bf16 entry and
    ``.wide_launches`` the wide kernel's; ``merge_count``, a one-element
    int64 tensor on the same device, adds the (query, key row) list merges
    the v1 kernel ran (the wide kernel adds none). The path is chosen
    after the options' checks and before anything else."""
    check_v1_options(extract, bank_splits)
    if not core_takes(radius, topk):
        out = launch_wide(feats, radius, temperature, topk, precede_frames)
        video_topk_affinity_v1_cuda.wide_launches += feats.shape[0] >= 2
        return out
    plan = window_plan(radius, topk)
    check_features(feats, precede_frames)
    t_total, h, w, c = feats.shape
    count = _build.counter_ptr(merge_count, feats.device)
    scores = torch.empty((t_total, h, w, topk), dtype=torch.float32,
                         device=feats.device)
    src = torch.empty((t_total, h, w, topk), dtype=torch.int64,
                      device=feats.device)
    scores[0] = 0
    src[0] = 0
    if t_total < 2:
        return scores, src
    lib = _library()
    bf16 = feats.dtype == torch.bfloat16
    fn = (lib.vfs_video_topk_affinity_v1_bf16 if bf16
          else lib.vfs_video_topk_affinity_v1)
    with torch.cuda.device(feats.device):
        err = fn(feats.data_ptr(), scores.data_ptr(), src.data_ptr(),
                 t_total, h, w, c, *plan_args(plan), 1.0 / temperature, topk,
                 precede_frames, int(early_exit and extract == 'perframe'),
                 count, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{KERNEL_NAME} kernel launch failed: CUDA '
                           f'error {err}')
    video_topk_affinity_v1_cuda.launches += 1
    video_topk_affinity_v1_cuda.bf16_launches += bf16
    return scores, src


video_topk_affinity_v1_cuda.launches = 0
video_topk_affinity_v1_cuda.bf16_launches = 0
video_topk_affinity_v1_cuda.wide_launches = 0


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
