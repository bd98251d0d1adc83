"""Host-side geometry of the windowed top-k kernels.

``csrc/window_topk.cuh`` is the device core of all four kernels:
``video_topk_affinity.cu`` (row 1), ``video_topk_affinity_v1.cu`` (row
2), ``local_topk_attend.cu`` (row 3) and ``local_topk_attend_v2.cu`` (row
4). The wrappers compute here, once per (radius, topk), what the kernels
are given: the largest window offset r and the circle's dx half-extent
for each ``|dy|`` (the band). The core derives the rest of the launch
(passes, staged cells, threads, shared memory) from r, and refuses a band
that does not start at r or widens.

The wide path: the core keeps a fixed 32-entry band table and top-k
lists of at most 32 entries in shared memory, so it takes ``r <=
MAX_OFFSET`` and ``topk <= KMAX``. Every other ``(radius, topk)`` (any
``r >= 0``, ``topk >= 1``) goes to the wide kernel
(``csrc/window_topk_wide.cu``), whose plan (``wide_plan``) carries r, the
full band, top-k and the block's shape: the passes it covers at once
(``pass_group``, at most ``MAX_PASS_GROUP``) and the key rows it stages
together (``key_rows``). ``WidePlan`` also gives the block's shared-memory
bytes (``smem_bytes``, the kernel's own formula) and the scratch the
wrappers allocate for the running and the per-slot lists
(``video_lists``, ``local_lists``); its band is a device array
(``band_tensor``). ``core_takes`` says which path a ``(radius, topk)``
takes; the four wrappers ask it before anything else.

Row 1's tensor-core path (``csrc/video_topk_tc.cu``) pre-scores on TF32
``mma`` and re-ranks exactly; ``prescore_margin`` is the proven bound on
the gap between a pre-score and the exact score that it selects
candidates within, and ``tc_takes`` says which fp32 launches of the core
go there.

The tile: a block owns ``TILE_H x TILE_W`` query cells. A warp computes
4 query rows x 32 query columns x ``PASS_DX`` consecutive dx of one key
row: its pass. ``passes`` warps cover the window's ``2r + 1`` dx for each
group of 4 query rows. ``pass_starts`` and ``pair_counts`` follow the
core's pass rule so that the CPU tests and ``chip_smoke.py`` can count
the pairs the kernels compute.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

# the wide kernel's source, csrc/window_topk_wide.cu
WIDE_KERNEL_NAME = 'window_topk_wide'
TILE_H, TILE_W = 8, 32
ROW_GROUPS = TILE_H // 4
PASS_DX = 16
KMAX = 32
MAX_OFFSET = 31
# the wide kernel: passes a block covers at once, the bytes of a staged
# cell, and the H100's shared memory a block may take
MAX_PASS_GROUP = 6
CELL_BYTES = 128
SMEM_LIMIT = 232448


def window_offset(radius: float) -> int:
    """The largest window offset ``r = ceil(radius - 1)``."""
    return int(math.ceil(radius - 1))


def circle_band(radius: float) -> Tuple[int, ...]:
    """For ``|dy| = 0..r``, the largest ``dx`` with ``float32(dy^2 + dx^2)
    < float32(radius^2)``: the test of ``circle_offsets``, so the offsets
    ``|dx| <= band[|dy|]`` are exactly the circle's."""
    r = window_offset(radius)
    r2 = np.float32(radius * radius)
    band = []
    for dy in range(r + 1):
        inside = [dx for dx in range(r + 1)
                  if np.float32(dy * dy + dx * dx) < r2]
        band.append(max(inside) if inside else -1)
    return tuple(band)


@dataclass(frozen=True)
class WindowPlan:
    """What a launch of the windowed top-k core is given."""
    r: int
    band: Tuple[int, ...]

    @property
    def passes(self) -> int:
        """Warp passes over dx per group of 4 query rows (the core's
        ``passes(r)``)."""
        return -(-(2 * self.r + 1) // PASS_DX)


@functools.lru_cache(maxsize=None)
def window_plan(radius: float, topk: int) -> WindowPlan:
    """The launch plan for ``radius`` and ``topk``; raises ValueError for
    what the kernels do not take (``r > 31`` or ``topk`` outside
    ``1..32``). Cached: the scan tier asks once per step."""
    r = window_offset(radius)
    if not 0 <= r <= MAX_OFFSET:
        raise ValueError(f'radius {radius} gives window offset r = {r}; the '
                         f'kernels take 0 <= r <= {MAX_OFFSET}')
    if not 1 <= topk <= KMAX:
        raise ValueError(f'topk {topk} is outside 1..{KMAX}')
    return WindowPlan(r=r, band=circle_band(radius))


def core_takes(radius: float, topk: int) -> bool:
    """Whether the core takes ``(radius, topk)``: ``0 <= r <= MAX_OFFSET``
    and ``1 <= topk <= KMAX``; else the wrappers launch the wide kernel."""
    return 0 <= window_offset(radius) <= MAX_OFFSET and 1 <= topk <= KMAX


@dataclass(frozen=True)
class WidePlan:
    """What a launch of the wide kernel is given: r, the band of all
    ``r + 1`` rows and top-k, with no upper limit, and the block's shape
    derived from r, which the C entries take as given
    (``csrc/window_topk_wide.cu`` sizes its shared memory from it by
    ``smem_bytes``' formula)."""
    r: int
    band: Tuple[int, ...]
    topk: int

    @property
    def passes(self) -> int:
        """Warp passes of ``PASS_DX`` dx that cover the window's 2r + 1
        dx."""
        return -(-(2 * self.r + 1) // PASS_DX)

    @property
    def pass_groups(self) -> int:
        """Groups the passes are walked in: one while ``passes <=
        MAX_PASS_GROUP`` (r <= 47)."""
        return -(-self.passes // MAX_PASS_GROUP)

    @property
    def pass_group(self) -> int:
        """Passes a group: the passes spread evenly over the groups."""
        return -(-self.passes // self.pass_groups)

    @property
    def key_rows(self) -> int:
        """Key rows staged together, sharing each staged query chunk: as
        many as keep the block within 384 threads (170 registers a thread)
        and at most 4."""
        return min(4, 6 // self.pass_group)

    @property
    def threads(self) -> int:
        """Two row groups x ``pass_group`` x ``key_rows`` warps."""
        return 64 * self.pass_group * self.key_rows

    @property
    def key_cells(self) -> int:
        """Staged cells of a key row's window: the tile's 32 columns and
        the group's dx."""
        return TILE_W + PASS_DX * self.pass_group

    @property
    def shared_lists(self) -> bool:
        """Whether the running lists sit in shared memory (``topk <=
        KMAX``); else in global scratch."""
        return self.topk <= KMAX

    @property
    def smem_bytes(self) -> int:
        """Shared memory a block takes: the 2-stage ring of 128-byte cells
        (each key row's window and the tile's queries), the score slab of
        a row group's queries, then the lists (shared) or each query's
        tail and buffer index (global)."""
        queries = TILE_H * TILE_W
        stage = (self.key_rows * self.key_cells + queries) * CELL_BYTES
        slab = queries // 2 * (PASS_DX * self.pass_group + 4) * 4
        lists = (2 * queries * self.topk if self.shared_lists
                 else 3 * queries) * 4
        return 2 * stage + slab + lists

    def video_lists(self, t_total: int, h: int, w: int
                    ) -> Optional[Tuple[int, ...]]:
        """Rows 1/2's scratch: two buffers of ``topk`` entries a query and
        frame where the lists do not fit shared memory, else None."""
        if self.shared_lists:
            return None
        return (t_total - 1, h, w, 2, self.topk)

    def local_lists(self, f_total: int, h: int, w: int) -> Tuple[int, ...]:
        """Rows 3/4's scratch: each slot's partial list and a spare buffer
        a query (the slot split's first stage, the merge's second)."""
        return (f_total, h, w, 2, self.topk)


@functools.lru_cache(maxsize=None)
def wide_plan(radius: float, topk: int) -> WidePlan:
    """The wide kernel's plan for ``radius`` and ``topk``; raises
    ValueError for ``r < 0`` (radius <= 0) or ``topk < 1``. Cached."""
    r = window_offset(radius)
    if r < 0:
        raise ValueError(f'radius {radius} gives window offset r = {r} < 0')
    if topk < 1:
        raise ValueError(f'topk {topk} < 1')
    return WidePlan(r=r, band=circle_band(radius), topk=topk)


def wide_lists(shape: Optional[Tuple[int, ...]], device: torch.device
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The wide kernel's list scratch of ``shape``: keys (float32) and
    order keys (int32), or (None, None) for no scratch."""
    if shape is None:
        return None, None
    return (torch.empty(shape, dtype=torch.float32, device=device),
            torch.empty(shape, dtype=torch.int32, device=device))


def data_ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's address for a C entry, None (a null pointer) for
    None."""
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def band_tensor(band: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``band`` as an int32 tensor on ``device``, the wide kernel's band
    table; cached, so the scan tier copies it to the card once."""
    return torch.tensor(band, dtype=torch.int32, device=device)


def plan_args(plan: WindowPlan) -> tuple:
    """The plan as the C interfaces of the four kernels take it: r and the
    band (r + 1 host ints)."""
    return plan.r, (ctypes.c_int * len(plan.band))(*plan.band)


def pass_starts(plan: WindowPlan, e: int) -> Tuple[int, ...]:
    """The first dx of each warp pass that runs for a row group whose
    widest band half-extent over its rows is ``e`` (``-1``: none of its
    rows lies within r of the key row): the passes start at ``-e``
    rounded down to a multiple of 4 from ``-r`` and run while they start
    at or before ``e``. The CUDA core (``window_topk.cuh``) uses the same
    rule."""
    if e < 0:
        return ()
    lo = -plan.r + 4 * ((plan.r - e) // 4)
    return tuple(lo + PASS_DX * p for p in range(plan.passes)
                 if lo + PASS_DX * p <= e)


def pair_counts(h: int, w: int, radius: float) -> Tuple[int, int]:
    """(pairs needed, pairs computed) for one (h, w) query plane against
    one key frame: the (query, key) pairs in the circle and the map, and
    the pairs the kernels' warps compute (4 rows x 32 columns x PASS_DX dx
    a pass that runs, over every tile and key row in the map)."""
    plan = window_plan(radius, 1)
    r, band = plan.r, plan.band
    ys = np.arange(h)[:, None]
    needed = 0
    for dy in range(-r, r + 1):
        e = band[abs(dy)]
        dx = np.arange(-e, e + 1)
        xs = np.arange(w)[:, None] + dx
        needed += int(((ys + dy >= 0) & (ys + dy < h)).sum()
                      * ((xs >= 0) & (xs < w)).sum())
    computed = 0
    for y0 in range(0, h, TILE_H):
        for ky in range(max(0, y0 - r), min(h, y0 + TILE_H + r)):
            for rg in range(ROW_GROUPS):
                rows = [y0 + 4 * rg + m for m in range(4)]
                e = max((band[abs(ky - y)] for y in rows
                         if y < h and abs(ky - y) <= r), default=-1)
                computed += len(pass_starts(plan, e)) * 4 * TILE_W * PASS_DX
    return needed, computed * -(-w // TILE_W)


# Row 1's tensor-core path: the smallest C it takes (below it the core
# is as fast: ``tc_takes``), the channels its mma accumulators sum before
# they are added to a running sum in shared memory, and the accumulation
# model of one TF32 m16n8k8 mma (``prescore_margin``).
TC_MIN_CHANNELS = 512
TC_FLUSH_CHANNELS = 128
MMA_K = 8
MMA_RHO = 2.0 ** -21
UNIT = 2.0 ** -24


def tc_takes(c: int, dtype: torch.dtype) -> bool:
    """Whether row 1's fp32 launch of the core goes to the tensor-core
    path: fp32 features with ``C >= TC_MIN_CHANNELS`` (below it the FFMA
    core is as fast, ``ab_kernels.py``); the bf16 entry keeps the core."""
    return dtype == torch.float32 and c >= TC_MIN_CHANNELS


def prescore_margin(c: int, inv_tau: float, splits: int = 3
                    ) -> Tuple[float, float]:
    """``(coef, absolute)``: for fp32 features of C channels whose norms
    multiply to at most N^2, ``m = coef * N^2 + absolute`` bounds
    ``|fl(p * inv_tau) - fl(s * inv_tau)|``, p the kernel's TF32
    pre-score and s the fmaf chain over channels 0..C-1 (the exact score
    before scaling). ``splits`` 3: q k ~ qh kh + qh kl + ql kh, each of
    q, k split into hi = q with its low 13 mantissa bits cleared (exact
    TF32) and lo = q - hi, which the tensor cores read as a TF32 value
    within 2^-10 |lo| of it; 1: qh kh. The mmas sum
    ``TC_FLUSH_CHANNELS`` channels from zero, and those G = ceil(C / 128)
    partial sums are added in fp32. With D the exact dot and S = sum
    |q_i k_i| <= N^2:

    - the chain: |s - D| <= gamma_C S, gamma_C = C u / (1 - C u),
      u = 2^-24 (C roundings of fmaf);
    - the operands: |hi - q| <= 2^-10 |q| and |lo| <= 2^-10 |q|, so
      |qh kh + qh kl' + ql' kh - q k| <= 3 2^-20 (1 + 2^-9) |q k| (splits
      3; kl', ql' as the tensor cores read them) and |qh kh - q k| <=
      (2^-9 + 2^-20)(1 + 2^-9) |q k| (splits 1);
    - the accumulation: each k8 step returns c + the sum of its 8 exact
      products within rho = ``MMA_RHO`` of |c| + sum |a_i b_i|; over the
      n = splits * ceil(min(C, 128) / 8) steps of one partial sum, whose
      products' magnitudes add to S_g <= (1 + 2^-8) S_g' (S_g' its share
      of S), |c| never passes S_g plus the errors so far, so its errors
      add to at most rho (n + 1) S_g / (1 - rho (n + 1)), and over the
      partial sums to that with S;
    - the G additions of partial sums and the scaling: fl(x inv_tau) is
      within u |x| inv_tau of x inv_tau, for p and for s: (G + 2) u (1 +
      2^-8) S;
    - underflow (a flushed or subnormal product or sum) adds at most
      2^-126 a product and a chain step: 4 C 2^-126 before scaling.

    The kernel multiplies ``coef`` by its own bound on N^2 (the largest
    squared norm of the features, computed on the card).
    ``csrc/video_topk_tc.cu`` (Margin) says how it selects within m."""
    if splits not in (1, 3):
        raise ValueError(f'splits is 1 or 3, got {splits}')
    if c < 1:
        raise ValueError(f'C must be >= 1, got {c}')
    grow = 1 + 2.0 ** -8
    chain = c * UNIT / (1 - c * UNIT)
    operand = (3 * 2.0 ** -20 if splits == 3
               else 2.0 ** -9 + 2.0 ** -20) * (1 + 2.0 ** -9)
    n = splits * -(-min(c, TC_FLUSH_CHANNELS) // MMA_K)
    accum = MMA_RHO * (n + 1) * grow / (1 - MMA_RHO * (n + 1))
    adds = (-(-c // TC_FLUSH_CHANNELS) + 2) * UNIT * grow
    coef = inv_tau * (chain + operand + accum + adds)
    absolute = inv_tau * 4 * c * 2.0 ** -126
    return _up32(coef), _up32(absolute)


def tc_workspace_ints(t_total: int, h: int, w: int, precede: int, r: int,
                      units_grid: int) -> int:
    """int32 words of the tensor-core path's workspace
    (``csrc/video_topk_tc.cu``, Work): 8 control words, a threshold a
    query of frames 1..T-1, a queue slot a (frame, 4 query rows, 16
    columns), and the overflow kernel's scratch: for each of its
    ``units_grid`` blocks, room for 64 queries' whole windows, (P + 1)
    (2r + 1)^2 keys each."""
    return (8 + (t_total - 1) * h * w
            + (t_total - 1) * -(-h // 4) * -(-w // 16)
            + units_grid * 64 * (precede + 1) * (2 * r + 1) ** 2)


def norm_grow(c: int) -> float:
    """What the kernel multiplies its largest computed squared norm by to
    bound the exact one: a sum of C squares in fp32 is within gamma_C of
    it, and 1 + 4 C 2^-24 covers 1 / (1 - gamma_C)."""
    return _up32(1 + 4 * c * UNIT)


def _up32(x: float) -> float:
    """The smallest float32 at or above ``x``, as a Python float."""
    f = np.float32(x)
    if float(f) < x:
        f = np.nextafter(f, np.float32(np.inf))
    return float(f)
