"""Masked top-k local attention of one query frame, v2.

PyTorch counterpart of ``vfs_tpu/ops/pallas_attention_v2.py``
(``pallas_local_topk_attend_v2``, a drop-in replacement for
``pallas_local_topk_attend``). It computes the function of
``local_attention.local_topk_attend``, with the same signature, contract
and ``(out, scores, src)`` result, so its plain version is
``local_attention.local_topk_attend_reference``. The kernel
(``vfs_tpu_torch/csrc/local_topk_attend_v2.cu``) runs row 3's two stages
on the windowed top-k core, per-slot lists and their merge; the epilogue
(gather, softmax, weighted sum) is plain PyTorch after it, as the JAX
package leaves it to XLA. No propagation backend calls it, as in the JAX
package.

A CPU tensor takes the plain version; a CUDA tensor launches a kernel or
raises: the v2 kernel where the core takes the radius and top-k
(``window_geometry.core_takes``), else the wide kernel's exact selection
(``csrc/window_topk_wide.cu``), with the same epilogue after it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .local_attention import (Result, check_operands, launch_wide,
                              local_topk_attend_reference)
from .window_geometry import core_takes, plan_args, window_plan

KERNEL_NAME = 'local_topk_attend_v2'


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL_NAME)
    fn = lib.vfs_local_topk_attend_v2
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def attend_epilogue(scores: torch.Tensor, src: torch.Tensor,
                    bank_vals: torch.Tensor) -> torch.Tensor:
    """Softmax over each list and the weighted sum of the gathered value
    rows: ``(h, w, k)`` scores and sources -> ``(h, w, K)``."""
    k_classes = bank_vals.shape[-1]
    weights = torch.softmax(scores, dim=-1)
    vals = bank_vals.reshape(-1, k_classes)[src]
    return (weights[..., None] * vals).sum(-2)


def local_topk_attend_v2_cuda(query: torch.Tensor, bank_feats: torch.Tensor,
                              bank_vals: torch.Tensor,
                              bank_valid: torch.Tensor, radius: float,
                              temperature: float, topk: int,
                              merge_count: Optional[torch.Tensor] = None
                              ) -> Result:
    """Launch a CUDA kernel on ``query``'s device and current stream, then
    the epilogue: the v2 kernel where the core takes the radius and top-k,
    else the wide kernel's selection. ``local_topk_attend_v2_cuda.launches``
    counts the v2 kernel's launches and ``.wide_launches`` the wide
    kernel's; ``merge_count``, a one-element int64 tensor on the same
    device, adds the (query, key row) list merges the v2 kernel ran (the
    wide kernel adds none). The path is chosen before anything else."""
    if not core_takes(radius, topk):
        _, scores, src = launch_wide(query, bank_feats, bank_vals,
                                     bank_valid, radius, temperature, topk,
                                     epilogue=False,
                                     feat_dtypes=(torch.float32,))
        local_topk_attend_v2_cuda.wide_launches += 1
        return attend_epilogue(scores, src, bank_vals), scores, src
    plan = window_plan(radius, topk)
    check_operands(query, bank_feats, bank_vals, bank_valid)
    f_total, h, w, c = bank_feats.shape
    if not 1 <= f_total <= 65535:
        raise ValueError(f'{f_total} bank slots: the kernel takes 1..65535')
    count = _build.counter_ptr(merge_count, query.device)
    dev = query.device
    valid = bank_valid.to(torch.int32).contiguous()
    scores = torch.empty((h, w, topk), dtype=torch.float32, device=dev)
    src = torch.empty((h, w, topk), dtype=torch.int64, device=dev)
    # scratch: each slot's top-k lists, merged by the kernel's last stage
    part_s = torch.empty((f_total, h, w, topk), dtype=torch.float32,
                         device=dev)
    part_o = torch.empty((f_total, h, w, topk), dtype=torch.int32,
                         device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.vfs_local_topk_attend_v2(
            query.data_ptr(), bank_feats.data_ptr(), valid.data_ptr(),
            scores.data_ptr(), src.data_ptr(), part_s.data_ptr(),
            part_o.data_ptr(), f_total, h, w, c,
            *plan_args(plan), 1.0 / temperature, topk, count,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{KERNEL_NAME} kernel launch failed: CUDA '
                           f'error {err}')
    local_topk_attend_v2_cuda.launches += 1
    return attend_epilogue(scores, src, bank_vals), scores, src


local_topk_attend_v2_cuda.launches = 0
local_topk_attend_v2_cuda.wide_launches = 0


def local_topk_attend_v2(query: torch.Tensor, bank_feats: torch.Tensor,
                         bank_vals: torch.Tensor, bank_valid: torch.Tensor,
                         radius: float, temperature: float,
                         topk: int) -> Result:
    """Masked top-k local attention, v2 (module docstring). CPU tensors
    take the plain version; CUDA tensors the kernel."""
    if query.device.type == 'cpu':
        return local_topk_attend_reference(query, bank_feats, bank_vals,
                                           bank_valid, radius, temperature,
                                           topk)
    return local_topk_attend_v2_cuda(query, bank_feats, bank_vals,
                                     bank_valid, radius, temperature, topk)
