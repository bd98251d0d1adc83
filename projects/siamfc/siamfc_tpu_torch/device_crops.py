"""On-device scale crops + response post-processing for SiamFC (PyTorch
counterpart of ``siamfc_tpu/device_crops.py``).

The host ships ONE integer-corner search region a sequence (a numpy slice
and a constant pad, no cv2) and a pack of cv2 INTER_LINEAR taps; the
device does the sub-pixel work:

  - the scale crops are 2-tap separable gathers that replicate cv2's
    uint8 INTER_LINEAR fixed-point pipeline in int32 arithmetic
    (``torch.int32``; ``>>`` on int32 is arithmetic), so they are
    bit-equal on the CPU, on the card and in the JAX package;
  - the response post-processing (reference siamfc_tracker_base.py:
    245-319) — x16 bicubic upsample (cv2.INTER_CUBIC kernel, A=-0.75) as
    two fp32 products without TF32, scale penalty, peak-scale selection,
    min/sum normalize, hann blend, argmax — returns only (scale_id, peak
    y, peak x) a sequence.

The host half (``bucket_of``, ``cubic_resize_matrix``, ``make_region``,
``cv2_linear_taps``, ``make_taps``) is a copy of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch


def bucket_of(s_max: int, step: int = 64) -> int:
    return int(-(-int(s_max) // step) * step)


def cubic_resize_matrix(in_size: int, out_size: int,
                        a: float = -0.75) -> np.ndarray:
    """(out_size, in_size) cv2.INTER_CUBIC-compatible resize matrix
    (Keys kernel with A=-0.75, pixel-center alignment, border clamp)."""
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), np.float64)
    for o in range(out_size):
        x = (o + 0.5) * scale - 0.5
        base = int(np.floor(x))
        for t in range(-1, 3):
            d = abs(x - (base + t))
            if d < 1:
                c = (a + 2) * d**3 - (a + 3) * d**2 + 1
            elif d < 2:
                c = a * d**3 - 5 * a * d**2 + 8 * a * d - 4 * a
            else:
                c = 0.0
            w[o, min(max(base + t, 0), in_size - 1)] += c
    return w.astype(np.float32)


def make_region(img: np.ndarray, center, sizes, avg_color,
                bucket_step: int = 64):
    """Host side: ONE padded integer-corner region covering every scale
    crop. Returns (region uint8 (bucket, bucket, 3), offs (S, 2) int32
    per-scale corner offsets inside the region, sizes (S,) int32)."""
    sizes = np.asarray([int(round(float(s))) for s in sizes], np.int64)
    s_max = int(sizes.max())
    center = np.asarray(center, np.float32)
    corners = np.stack([
        np.round(np.round(center - (s - 1) / 2)).astype(np.int64)
        for s in sizes])                       # (S, 2) — host-path corners
    c0 = corners[int(np.argmax(sizes))]
    bucket = bucket_of(s_max, bucket_step)
    region = np.empty((bucket, bucket, 3), img.dtype)
    fill = np.asarray(avg_color)
    if np.issubdtype(img.dtype, np.integer):
        fill = np.rint(fill)  # cv2.copyMakeBorder saturate_cast rounds
    region[:] = fill.astype(img.dtype)
    sy0, sx0 = int(c0[0]), int(c0[1])
    y0, y1 = max(sy0, 0), min(sy0 + s_max, img.shape[0])
    x0, x1 = max(sx0, 0), min(sx0 + s_max, img.shape[1])
    if y1 > y0 and x1 > x0:
        region[y0 - sy0:y1 - sy0, x0 - sx0:x1 - sx0] = img[y0:y1, x0:x1]
    offs = (corners - c0[None]).astype(np.int32)
    return region, offs, sizes.astype(np.int32)


_TAPS_CACHE = {}


def cv2_linear_taps(src: int, dst: int):
    """Host-side bit-replication of cv2 resizeGeneric's 8U INTER_LINEAR
    tap/coefficient build (opencv resize.cpp): the source position is
    computed in float32 — `fx = (float)((dx+0.5)*scale - 0.5)` — NOT
    double (replicating cv2's exact f32 rounding matters: the exact-
    rational formulation differs on ~4% of coefficient LSBs), edge taps
    snap to fx=0, and coefficients are `saturate_cast<short>(f * 2048)`
    with cvRound = rint, c0 rounded independently from its f32 `1.f-fx`
    (so c0+c1 != 2048 occasionally, as in cv2). Cached per (src, dst).
    Returns (lo, hi, c0, c1) int64 arrays of shape (dst,)."""
    key = (src, dst)
    if key not in _TAPS_CACHE:
        scale = src / dst
        dx = np.arange(dst)
        fx = ((dx + 0.5) * scale - 0.5).astype(np.float32)
        sx = np.floor(fx).astype(np.int64)
        fx = (fx - sx).astype(np.float32)
        left = sx < 0
        fx = np.where(left, np.float32(0), fx)
        sx = np.where(left, 0, sx)
        right = sx >= src - 1
        fx = np.where(right, np.float32(0), fx)
        sx = np.where(right, src - 1, sx)
        c0 = np.rint((np.float32(1.0) - fx) * np.float32(2048.0)
                     ).astype(np.int64)
        c1 = np.rint(fx * np.float32(2048.0)).astype(np.int64)
        _TAPS_CACHE[key] = (np.clip(sx, 0, src - 1),
                            np.clip(sx + 1, 0, src - 1), c0, c1)
    return _TAPS_CACHE[key]


def make_taps(offs, sizes, out_size: int) -> np.ndarray:
    """(S, 2) corner offsets + (S,) sizes -> (S, 8, out_size) int32 tap
    pack [lo_y, hi_y, cy0, cy1, lo_x, hi_x, cx0, cx1], with the tap
    indices pre-offset into the shared region. ~8 KB/frame host->device;
    the device side becomes pure integer gathers (no traced-scalar tap
    math, no MXU)."""
    s_num = len(sizes)
    taps = np.empty((s_num, 8, out_size), np.int32)
    for s in range(s_num):
        lo, hi, c0, c1 = cv2_linear_taps(int(sizes[s]), out_size)
        taps[s, 0] = lo + offs[s, 0]
        taps[s, 1] = hi + offs[s, 0]
        taps[s, 2] = c0
        taps[s, 3] = c1
        taps[s, 4] = lo + offs[s, 1]
        taps[s, 5] = hi + offs[s, 1]
        taps[s, 6] = c0
        taps[s, 7] = c1
    return taps


def bilinear_sample_matrix(bucket: int, out_size: int, corner, size,
                           device=None) -> torch.Tensor:
    """(out_size, bucket) fp32 matrix: sample the region's axis like the
    host path — crop [corner, corner+size) then cv2.INTER_LINEAR to
    ``out_size`` (pixel centers, clamped to the patch)."""
    o = torch.arange(out_size, dtype=torch.float32, device=device)[:, None]
    j = torch.arange(bucket, dtype=torch.float32, device=device)[None, :]
    size = torch.as_tensor(size, device=device).to(torch.float32)
    corner = torch.as_tensor(corner, device=device).to(torch.float32)
    x = corner + (o + 0.5) * size / out_size - 0.5
    x = torch.minimum(torch.maximum(x, corner), corner + size - 1)
    w = torch.clamp(1.0 - (j - x).abs(), min=0.0)
    # zero contributions from outside the patch (clamped x sits on the
    # boundary pixel -> that pixel's hat weight is exactly 1)
    inside = (j >= corner) & (j <= corner + size - 1)
    return torch.where(inside, w, torch.zeros_like(w))


def device_scale_crops(region: torch.Tensor,
                       taps: torch.Tensor) -> torch.Tensor:
    """(bucket, bucket, 3) uint8 + (S, 8, out) int32 taps -> (S, out, out,
    3) float32 crops; with a leading batch axis, (K, bucket, bucket, 3) +
    (K, S, 8, out) -> (K, S, out, out, 3). Bit-equal to the host path's cv2
    uint8 output (ops.crop_and_resize) for downscale crops and within
    +-1 LSB on a few pixels for upscale crops (cv2 runs another SIMD
    kernel there). cv2's 2048-fixed-point path in exact int32 arithmetic:
    horizontal X = c0*v0 + c1*v1 (<= 2^20), then the
    VResizeLinearVec_32s8u reduction — x = X >> 4, multiply-high
    truncation (x*b) >> 16, and the rounding descale (h0 + h1 + 2) >> 2."""
    single = region.dim() == 3
    if single:
        region, taps = region[None], taps[None]
    reg = region.to(torch.int32)
    taps = taps.to(torch.int32)
    k = torch.arange(reg.shape[0], device=reg.device)[:, None, None]
    s = torch.arange(taps.shape[1], device=reg.device)[None, :, None]

    def coef(c):  # (K, S, out) -> broadcast over (row, channel)
        return c[..., None, None]

    # columns: reg[k, :, lx[k, s, o]] -> (K, S, out_x, bucket_y, 3)
    x = ((reg[k, :, taps[:, :, 4].long()] * coef(taps[:, :, 6]) +
          reg[k, :, taps[:, :, 5].long()] * coef(taps[:, :, 7])) >> 4)
    # rows: x[k, s, :, ly[k, s, o]] -> (K, S, out_y, out_x, 3)
    r = (((x[k, s, :, taps[:, :, 0].long()] * coef(taps[:, :, 2])) >> 16) +
         ((x[k, s, :, taps[:, :, 1].long()] * coef(taps[:, :, 3])) >> 16) +
         2) >> 2
    crops = r.clamp(0, 255).to(torch.float32)
    return crops[0] if single else crops


def device_response_post(responses: torch.Tensor, up_mat: torch.Tensor,
                         hann: torch.Tensor, scale_penalty: float,
                         window_influence: float):
    """(S, r, r) raw responses -> (scale_id, loc_y, loc_x) exactly like
    the host _apply_response up to its argmax (reference
    siamfc_tracker_base.py:245-319); with a leading batch axis, (K, S, r,
    r) -> three (K,) int64 tensors. Both argmaxes take the first maximum
    (``torch.argmax``'s rule, as ``jnp.argmax``'s and numpy's). The caller
    keeps TF32 off (``exact_fp32``): the upsample's products are fp32."""
    single = responses.dim() == 3
    if single:
        responses = responses[None]
    n, s_num = responses.shape[:2]
    up = torch.matmul(torch.matmul(up_mat, responses), up_mat.t())
    pen = torch.full((s_num,), scale_penalty, dtype=up.dtype,
                     device=up.device)
    pen[s_num // 2] = 1.0
    up = up * pen[:, None, None]
    scale_id = torch.argmax(up.amax(dim=(2, 3)), dim=1)
    r = up[torch.arange(n, device=up.device), scale_id]
    r = r - r.amin(dim=(1, 2), keepdim=True)
    r = r / (r.sum(dim=(1, 2), keepdim=True) + 1e-16)
    r = (1 - window_influence) * r + window_influence * hann
    upscale = r.shape[-1]
    loc = torch.argmax(r.reshape(n, -1), dim=1)
    out = (scale_id, loc // upscale, loc % upscale)
    return tuple(o[0] for o in out) if single else out
