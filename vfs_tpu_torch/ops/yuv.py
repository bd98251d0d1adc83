"""YUV 4:2:0 transport for eval inputs (PyTorch counterpart of
``vfs_tpu/ops/yuv.py``).

The eval loop can ship a video's frames to the card as planar I420, 1.5
bytes a pixel, instead of RGB at 3 (``test_cfg.input_format='yuv420'``):

  host:   RGB uint8 -> flat planar I420 (cv2, or a numpy fallback of the
          same convention), or a decoder's own planes (``Yuv420Frames``);
  copy:   1.5 bytes a pixel, one flat uint8 buffer a frame;
  card:   nearest 2x chroma upsample, the BT.601 inverse, clip to
          [0, 255] and crop (``yuv420_to_rgb``, plain PyTorch on the
          frames' device: the JAX package computes it outside any Pallas
          kernel, in the extraction's XLA graph).

Conventions are the JAX package's: ``'studio'`` is BT.601 studio swing,
what ``cv2.COLOR_RGB2YUV_I420`` produces (chroma from the top-left pixel
of each 2x2 block); ``'jpeg'`` is full-range JFIF YCbCr. The constants are
written as the JAX package writes them (multiplications by
``1.0 / _Y_SCALE``): CUDA divides by a Python number through its
reciprocal, one ulp off the CPU's quotient, so no division is left.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# BT.601 studio-swing forward coefficients (the cv2 I420 convention)
_KR, _KG, _KB = 0.299, 0.587, 0.114
_Y_SCALE = 219.0 / 255.0
_C_SCALE = 224.0 / 255.0


def yuv420_shape(h: int, w: int) -> Tuple[int, int, int]:
    """(even h, even w, flat bytes a frame) after the even-size padding."""
    he = h + (h % 2)
    we = w + (w % 2)
    return he, we, he * we * 3 // 2


def rgb_to_yuv420(imgs: np.ndarray) -> np.ndarray:
    """Pack (T, H, W, 3) RGB uint8 into flat planar I420, (T, He*We*3/2).

    Odd H or W are edge-padded to even before subsampling; the unpack
    crops back. Uses cv2 when it imports, else a numpy fallback of the
    same convention (within one rounding step of cv2's fixed point)."""
    assert imgs.dtype == np.uint8 and imgs.ndim == 4 and imgs.shape[-1] == 3
    t, h, w = imgs.shape[:3]
    he, we, n = yuv420_shape(h, w)
    if (he, we) != (h, w):
        imgs = np.pad(imgs, ((0, 0), (0, he - h), (0, we - w), (0, 0)),
                      mode='edge')
    out = np.empty((t, n), np.uint8)
    try:
        import cv2
        for i in range(t):
            out[i] = cv2.cvtColor(imgs[i], cv2.COLOR_RGB2YUV_I420).reshape(-1)
        return out
    except ImportError:
        pass
    f = imgs.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 16.0 + (_KR * r + _KG * g + _KB * b) * _Y_SCALE
    # chroma from the top-left sample of each 2x2 block (cv2 convention)
    r2, g2, b2 = r[:, ::2, ::2], g[:, ::2, ::2], b[:, ::2, ::2]
    cb = 128.0 + (-0.168736 * r2 - 0.331264 * g2 + 0.5 * b2) * _C_SCALE
    cr = 128.0 + (0.5 * r2 - 0.418688 * g2 - 0.081312 * b2) * _C_SCALE
    hw = he * we
    out[:, :hw] = np.round(y).clip(0, 255).astype(np.uint8).reshape(t, -1)
    out[:, hw:hw + hw // 4] = np.round(cb).clip(0, 255).astype(
        np.uint8).reshape(t, -1)
    out[:, hw + hw // 4:] = np.round(cr).clip(0, 255).astype(
        np.uint8).reshape(t, -1)
    return out


def yuv420_planes_to_flat(y: np.ndarray, u: np.ndarray,
                          v: np.ndarray) -> np.ndarray:
    """Assemble decoder planes (T, He, We), (T, He/2, We/2) x 2 into the
    flat layout ``rgb_to_yuv420`` produces."""
    t = y.shape[0]
    return np.concatenate([y.reshape(t, -1), u.reshape(t, -1),
                           v.reshape(t, -1)], axis=1)


def yuv420_to_rgb(buf: torch.Tensor, h: int, w: int,
                  convention: str = 'studio') -> torch.Tensor:
    """Flat I420 (..., He*We*3/2) uint8 -> (..., H, W, 3) fp32 RGB in
    [0, 255] on ``buf``'s device. Chroma is nearest-upsampled (each 2x2
    block shares its stored sample). ``convention``: ``'studio'`` (what
    ``rgb_to_yuv420`` and cv2 produce) or ``'jpeg'`` (full-range
    JFIF)."""
    assert convention in ('studio', 'jpeg'), convention
    he, we, n = yuv420_shape(h, w)
    lead = tuple(buf.shape[:-1])
    assert buf.shape[-1] == n, (tuple(buf.shape), n)
    hw = he * we
    y = buf[..., :hw].reshape(*lead, he, we).to(torch.float32)
    u = buf[..., hw:hw + hw // 4].reshape(*lead, he // 2, we // 2).to(
        torch.float32)
    v = buf[..., hw + hw // 4:].reshape(*lead, he // 2, we // 2).to(
        torch.float32)

    def up2(c):  # nearest 2x upsample on the trailing two dims
        return c.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)

    if convention == 'studio':
        yp = (y - 16.0) * (1.0 / _Y_SCALE)
        cb = (up2(u) - 128.0) * (1.0 / _C_SCALE)
        cr = (up2(v) - 128.0) * (1.0 / _C_SCALE)
    else:
        yp = y
        cb = up2(u) - 128.0
        cr = up2(v) - 128.0
    r = yp + 1.402 * cr
    g = yp - 0.344136 * cb - 0.714136 * cr
    b = yp + 1.772 * cb
    rgb = torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)
    return rgb[..., :h, :w, :]


class Yuv420Frames(np.ndarray):
    """(T, He*We*3/2) packed I420 frames with their source geometry
    (``hw``) and ``convention``: an ndarray subclass, so pre-packed frames
    pass through dataset pipelines and ``Collect`` untouched, and
    ``VanillaTracker.preload`` ships them as they are. Made by
    ``RawFrameDecodeYUV420`` or by a caller as
    ``Yuv420Frames(rgb_to_yuv420(imgs), hw, 'studio')``."""

    def __new__(cls, buf, hw, convention='studio'):
        obj = np.asarray(buf, dtype=np.uint8).view(cls)
        obj.hw = tuple(int(x) for x in hw)
        obj.convention = convention
        return obj

    def __array_finalize__(self, obj):
        if obj is not None:
            self.hw = getattr(obj, 'hw', None)
            self.convention = getattr(obj, 'convention', 'studio')
