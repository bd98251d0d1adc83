"""Weight gradient of narrow 3-D convolutions on a hand-written kernel.

cuDNN computes the fp32 weight gradient of a narrow 3-D convolution (few
input and output channels, millions of output positions: SlowFast's fast
pathway and its two stems) with ``wgrad2d_grouped_direct_kernel``, at under
0.5% of the card's bound. ``conv3d(conv, x)`` runs an ``nn.Conv3d`` as its
own ``forward`` would, and through ``NarrowWgradConv3d`` where
``takes(conv, x)``: the forward (``F.conv3d``) and the data gradient
(``aten.convolution_backward``) stay on cuDNN, and the weight gradient is
``conv3d_weight``:

    dW[co, ci, dt, dh, dw] = sum over (n, t, h, w) of dY[n, co, t, h, w]
        * X[n, ci, t*st + dt - pt, h*sh + dh - ph, w*sw + dw - pw]

with zero padding. A CUDA tensor launches the kernel
(``csrc/conv3d_wgrad.cu``: a split-K pass over output positions, then a
sum of the partials in a fixed order, so the gradient repeats bit for bit)
or raises; a CPU tensor takes the plain version,
``conv3d_weight_reference``. X and dY are read through their strides
(16-byte copies where they are channels-last, as the training step keeps
them), and dW comes out in the weight's own memory format.

``takes`` holds for a CUDA fp32 input under no autocast, with gradients
on and a weight that wants one, and ``narrow(conv, dtype)``: groups 1,
dilation 1, no bias, zero padding, a tap width and w stride the kernel is
built for (``FAMILIES``), output channels in groups of 8, and the shape
rule on (Cin, Cout, kernel volume) that the per-shape A/B on the card set
(``narrow_shape``). ``conv3d_weight_cuda.launches`` counts the kernel's
launches; while a ``utils.trace`` recording is open each launch also adds
1 to the counter ``conv3d.narrow_wgrad``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..utils import trace
from . import _build

KERNEL_NAME = 'conv3d_wgrad'
TRACE_COUNT = 'conv3d.narrow_wgrad'
CO_TILE = 8             # output channels a thread holds
MAX_THREADS = 512       # a block
SMEM_BLOCK = 232448     # shared memory a block may use on Hopper (227 KB)
SMEM_PAIR = 113 * 1024  # a block's share when two fit on an SM
ROW_TILES = (8, 4, 2, 1)
# (tap width KW, w stride SW) pairs the kernel is instantiated for
FAMILIES = frozenset({(1, 1), (1, 2), (3, 1), (3, 2), (7, 2)})


def _triple(v) -> Tuple[int, int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3


def out_size(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def narrow_shape(cin: int, cout: int, kernel: Sequence[int]) -> bool:
    """The shape rule: Cin x Cout <= 4096 or Cin x Cout x kernel volume
    (the weight's entries) <= 32768. Set from the per-shape A/B on an H100
    (``ab_kernels.py --wgrad3d``) at every convolution of SlowFast-R50
    4x16 at 32 x 224 x 224: the kernel was faster than cuDNN's weight
    gradient at every shape the rule takes, and every shape where it was
    not (the slow pathway from its second stage on, 4 frames of 28 x 28
    or less) lies above both limits."""
    return cin * cout <= 4096 or cin * cout * math.prod(kernel) <= 32768


def narrow(conv: nn.Conv3d, dtype: torch.dtype) -> bool:
    """Whether the kernel computes ``conv``'s weight gradient for inputs of
    ``dtype`` and the shape rule routes it there."""
    kt, kh, kw = _triple(conv.kernel_size)
    return (dtype == torch.float32 and conv.weight.dtype == torch.float32
            and conv.groups == 1 and conv.bias is None
            and conv.padding_mode == 'zeros'
            and not isinstance(conv.padding, str)
            and _triple(conv.dilation) == (1, 1, 1)
            and (kw, _triple(conv.stride)[2]) in FAMILIES
            and conv.out_channels % CO_TILE == 0
            and narrow_shape(conv.in_channels, conv.out_channels,
                             (kt, kh, kw)))


def takes(conv: nn.Conv3d, x: torch.Tensor) -> bool:
    """Whether ``conv3d(conv, x)`` routes the weight gradient to the
    kernel: a CUDA input, a gradient wanted, no autocast, ``narrow`` and a
    plan for these sizes."""
    return (x.is_cuda and x.dim() == 5 and torch.is_grad_enabled()
            and conv.weight.requires_grad
            and not torch.is_autocast_enabled('cuda')
            and narrow(conv, x.dtype)
            and plan(tuple(x.shape), tuple(conv.weight.shape),
                     _triple(conv.stride), _triple(conv.padding)) is not None)


def conv3d(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)``, with the weight gradient on the kernel where
    ``takes(conv, x)`` (there the convolution is called as a function:
    ``conv``'s own forward hooks do not run; the FLOP counters that hook
    convolutions run under ``no_grad``, where nothing is routed)."""
    if not takes(conv, x):
        return conv(x)
    return NarrowWgradConv3d.apply(x, conv.weight, _triple(conv.stride),
                                   _triple(conv.padding))


class NarrowWgradConv3d(torch.autograd.Function):
    """``F.conv3d(x, weight, None, stride, padding)`` (groups 1, dilation
    1) whose weight gradient is ``conv3d_weight``; the data gradient is
    cuDNN's, as without it."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.padding = stride, padding
        return F.conv3d(x, weight, None, stride, padding)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, weight = ctx.saved_tensors
        grad_x = grad_w = None
        if ctx.needs_input_grad[0]:
            grad_x = torch.ops.aten.convolution_backward(
                grad_out, x, weight, None, ctx.stride, ctx.padding,
                (1, 1, 1), False, (0, 0, 0), 1, (True, False, False))[0]
        if ctx.needs_input_grad[1]:
            grad_w = conv3d_weight(x, grad_out, weight, ctx.stride,
                                   ctx.padding)
        return grad_x, grad_w, None, None


def conv3d_weight_reference(x: torch.Tensor, grad_out: torch.Tensor,
                            weight: torch.Tensor, stride: Sequence[int],
                            padding: Sequence[int]) -> torch.Tensor:
    """The plain version: for each tap, the padded input sliced at the
    output's positions, contracted with dY over (n, t, h, w). Returns dW
    in ``weight``'s shape, type and memory format."""
    cout, cin, kt, kh, kw = weight.shape
    st, sh, sw = stride
    pt, ph, pw = padding
    to, ho, wo = grad_out.shape[2:]
    xp = F.pad(x, (pw, pw, ph, ph, pt, pt))
    dw = torch.empty_like(weight)
    for dt in range(kt):
        for dh in range(kh):
            for dx in range(kw):
                xs = xp[:, :, dt:dt + st * (to - 1) + 1:st,
                        dh:dh + sh * (ho - 1) + 1:sh,
                        dx:dx + sw * (wo - 1) + 1:sw]
                dw[:, :, dt, dh, dx] = torch.einsum('nothw,nithw->oi',
                                                    grad_out, xs)
    return dw


class Sizes(NamedTuple):
    """The convolution's sizes: X (N, Cin, T, H, W), dY (N, Cout, To,
    Ho, Wo), the weight's KT, KH, the strides and paddings along t, h
    (and w's padding)."""
    N: int
    T: int
    H: int
    W: int
    Cin: int
    To: int
    Ho: int
    Wo: int
    Cout: int
    KT: int
    KH: int
    st: int
    sh: int
    pt: int
    ph: int
    pw: int


class Tiling(NamedTuple):
    """How the kernel cuts the work (``plan``): TH output rows a slab, a
    row in nseg segments of seg positions, groups of threads over the
    units (row, segment), entries (ci, dh, dt, group of 8 co) of the
    weight in chunks of ent_cta a block, slabs of (n, t, row tile) with
    n_ht row tiles; the staged window: lead zeros that align the first
    channel, rs floats a row, fs a frame, win_w padded columns, and a
    stage's x_floats and y_floats."""
    TH: int
    nseg: int
    seg: int
    groups: int
    entries: int
    ent_cta: int
    slabs: int
    n_ht: int
    lead: int
    rs: int
    fs: int
    win_w: int
    x_floats: int
    y_floats: int


class Plan(NamedTuple):
    """The kernel's launch for one shape: the sizes, the tiling, the
    family (tap width KW, w stride SW), threads and shared memory of a
    block."""
    sizes: Sizes
    tiling: Tiling
    kw: int
    sw: int
    threads: int
    smem_bytes: int


def _pad32(n: int) -> int:
    """``n`` (a multiple of 4) moved off a multiple of 32 floats, so rows
    and frames of the window start in different banks."""
    return n + 4 if n % 32 == 0 else n


@functools.lru_cache(maxsize=None)
def plan(x_shape: Tuple[int, ...], w_shape: Tuple[int, ...],
         stride: Tuple[int, int, int],
         padding: Tuple[int, int, int]) -> Optional[Plan]:
    """The kernel's tiling for X of ``x_shape`` (N, Cin, T, H, W) and a
    weight of ``w_shape``, or None where its families or shared memory do
    not take the shape. Rows a slab TH: the most of ``ROW_TILES`` whose two
    stages leave room for two blocks an SM, else for one; threads: the
    weight's entries (a chunk of at most ``MAX_THREADS`` of them) times a
    power-of-two number of position groups; a row is cut into segments so
    that a slab holds a multiple of the groups' units."""
    n, cin, t, h, w = x_shape
    cout, cin_w, kt, kh, kw = w_shape
    st, sh, sw = stride
    pt, ph, pw = padding
    if (cin_w != cin or cout % CO_TILE or (kw, sw) not in FAMILIES
            or min(padding) < 0):
        return None
    to, ho, wo = (out_size(t, kt, st, pt), out_size(h, kh, sh, ph),
                  out_size(w, kw, sw, pw))
    if min(n, to, ho, wo) < 1:
        return None
    entries = cin * kt * kh * (cout // CO_TILE)
    chunks = -(-entries // MAX_THREADS)
    ent_cta = -(-entries // chunks)
    groups = 1 << int(math.log2(MAX_THREADS // ent_cta))
    threads = ent_cta * groups
    win_w = (wo - 1) * sw + kw
    lead = -pw * cin % 4
    rs = _pad32(-(-(lead + win_w * cin) // 4) * 4)
    red_bytes = threads * kw * CO_TILE * 4

    def stage_bytes(th):
        fs = _pad32(((th - 1) * sh + kh) * rs)
        return 4 * (kt * fs + th * wo * cout), fs

    fits = [th for th in ROW_TILES if th <= ho]
    th = next((th for th in fits if 2 * stage_bytes(th)[0] <= SMEM_PAIR),
              next((th for th in fits
                    if 2 * stage_bytes(th)[0] <= SMEM_BLOCK), None))
    if th is None:
        return None
    sbytes, fs = stage_bytes(th)
    smem = max(2 * sbytes, red_bytes)
    if smem > SMEM_BLOCK:
        return None
    nseg = max(1, groups // th)
    seg = -(-wo // nseg)
    n_ht = -(-ho // th)
    slabs = n * to * n_ht
    sizes = Sizes(n, t, h, w, cin, to, ho, wo, cout, kt, kh, st, sh, pt,
                  ph, pw)
    tiling = Tiling(th, nseg, seg, groups, entries, ent_cta, slabs, n_ht,
                    lead, rs, fs, win_w, kt * fs, th * wo * cout)
    return Plan(sizes, tiling, kw, sw, threads, smem)


def _aligned(t: torch.Tensor) -> bool:
    """Whether the kernel stages ``t`` (N, C, T, H, W) in 16-byte copies:
    channels innermost, each (n, t, h) row contiguous and 16-byte
    aligned."""
    s = t.stride()
    return (s[1] == 1 and s[4] == t.shape[1] and s[0] % 4 == 0
            and s[2] % 4 == 0 and s[3] % 4 == 0 and t.data_ptr() % 16 == 0)


def geometry(p: Plan, x: torch.Tensor, grad_out: torch.Tensor,
             dw: torch.Tensor) -> Tuple[int, ...]:
    """The C entry's ``geo`` (47 int64, its ``Geometry`` in order): the
    sizes, the strides of X and dY, whether each is staged in 16-byte
    copies, the tiling, dW's strides. The C entry checks only that the
    kernel's accesses stay inside the tensors and shared memory; the
    tiling is this module's."""
    xs = x.stride()
    ys = grad_out.stride()
    return (p.sizes + xs + ys + (int(_aligned(x)), int(_aligned(grad_out)))
            + p.tiling + dw.stride())


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL_NAME)
    lib.vfs_narrow_wgrad3d.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.vfs_narrow_wgrad3d.restype = ctypes.c_int
    lib.vfs_narrow_wgrad3d_blocks_per_sm.argtypes = [ctypes.c_int] * 4
    lib.vfs_narrow_wgrad3d_blocks_per_sm.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _grid_x(p: Plan, index: int) -> int:
    """Persistent blocks: as many as the card holds at once, at most one a
    slab."""
    per_sm = _library().vfs_narrow_wgrad3d_blocks_per_sm(
        p.kw, p.sw, p.threads, p.smem_bytes)
    if per_sm < 1:
        raise RuntimeError(f'{KERNEL_NAME}: no block of {p.threads} threads '
                           f'and {p.smem_bytes} bytes fits an SM')
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return min(p.tiling.slabs, per_sm * sms)


def check_tensors(x: torch.Tensor, grad_out: torch.Tensor,
                  weight: torch.Tensor) -> None:
    """Raise unless X, dY and the weight are 5-D float32 CUDA tensors."""
    for name, t in (('x', x), ('grad_out', grad_out), ('weight', weight)):
        if t.device.type != 'cuda' or t.dtype != torch.float32 \
                or t.dim() != 5:
            raise ValueError(f'{KERNEL_NAME}: {name} must be a 5-D float32 '
                             f'CUDA tensor, got {t.dtype} '
                             f'{tuple(t.shape)} on {t.device}')


def conv3d_weight_cuda(x: torch.Tensor, grad_out: torch.Tensor,
                       weight: torch.Tensor, stride: Sequence[int],
                       padding: Sequence[int]) -> torch.Tensor:
    """dW by the kernel on ``x``'s device and current stream. Each launch
    adds 1 to ``conv3d_weight_cuda.launches`` and, while a trace records,
    to the program counter ``conv3d.narrow_wgrad``."""
    check_tensors(x, grad_out, weight)
    p = plan(tuple(x.shape), tuple(weight.shape), tuple(stride),
             tuple(padding))
    if p is None:
        raise ValueError(f'{KERNEL_NAME}: no plan for X {tuple(x.shape)}, '
                         f'weight {tuple(weight.shape)}, stride {stride}, '
                         f'padding {padding}')
    want = (x.shape[0], weight.shape[0], p.sizes.To, p.sizes.Ho, p.sizes.Wo)
    if tuple(grad_out.shape) != want:
        raise ValueError(f'{KERNEL_NAME}: grad_out {tuple(grad_out.shape)}, '
                         f'expected {want}')
    dev = x.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    grid_x = _grid_x(p, index)
    dw = torch.empty_like(weight)
    part = torch.empty(grid_x * dw.numel(), dtype=torch.float32, device=dev)
    geo = geometry(p, x, grad_out, dw)
    with torch.cuda.device(dev):
        err = _library().vfs_narrow_wgrad3d(
            x.data_ptr(), grad_out.data_ptr(), part.data_ptr(), dw.data_ptr(),
            (ctypes.c_longlong * len(geo))(*geo), len(geo), p.kw, p.sw,
            grid_x, p.smem_bytes, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{KERNEL_NAME} kernel launch failed: CUDA '
                           f'error {err}')
    conv3d_weight_cuda.launches += 1
    trace.count(TRACE_COUNT)
    return dw


conv3d_weight_cuda.launches = 0


def conv3d_weight(x: torch.Tensor, grad_out: torch.Tensor,
                  weight: torch.Tensor, stride: Sequence[int],
                  padding: Sequence[int]) -> torch.Tensor:
    """dW (module docstring): CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if x.device.type == 'cpu':
        return conv3d_weight_reference(x, grad_out, weight, stride, padding)
    return conv3d_weight_cuda(x, grad_out, weight, stride, padding)
