"""The on-device augmentation chain of VFS's device-aug pretraining,
written plainly from each transform's definition, frame by frame: the
train cells' reference for uint8 staging traffic.

Only the draws are the program's (``vfs_tpu_torch/ops/device_aug.py``):
the same generator calls in the same order and shapes (``_param_shape``,
``DeviceAugChain.draw``), so that both sides augment with the same
parameters. What the parameters do is written here from the transforms'
definitions:

- RandomResizedCrop (mmaction's 10-attempt sampler: the first attempt
  whose rounded size fits, else the centred min-side square; offsets
  ``floor(u * (range + 1))``), the rectangle mapped from the original
  frame to the staging frame, then a bilinear resize of the crop (cv2's
  half-pixel centres, border clamp): each output pixel mixes the two
  nearest source rows, then the two nearest columns;
- Flip: the frame reversed along its width;
- ColorJitter (torchvision): brightness ``b x``, contrast
  ``c x + (1 - c) mean(gray(x))``, saturation ``s x + (1 - s) gray(x)``,
  each clipped to [0, 255], and hue (RGB to HSV, the hue turned by
  ``hue`` of a turn, back to RGB), in the frame's drawn order;
- RandomGrayScale: ``gray(x) = 0.299 R + 0.587 G + 0.114 B`` (cv2) in
  every channel;
- RandomGaussianBlur: cv2's kernel of radius ``round(3 sigma)``,
  normalised, vertical then horizontal, borders reflected without the
  edge pixel (reflect-101);
- then ``(x - mean) / std``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .precision import matmul_precision

GRAY = (0.299, 0.587, 0.114)


# -- the draws: the program's order and shapes ----------------------------

def _param_shape(b: int, n: int, t: int, same_on_clip: bool,
                 same_across_clip: bool) -> Tuple[int, int, int]:
    """Shape of one op's draws: one per frame unless ``same_on_clip``,
    one per clip unless ``same_across_clip``, else one per sample."""
    if not same_on_clip:
        return (b, n, t)
    if not same_across_clip:
        return (b, n, 1)
    return (b, 1, 1)


def _bcast(p: torch.Tensor, b: int, n: int, t: int) -> torch.Tensor:
    """(b?, n?, t?) draws -> the flat (b*n*t,) per-frame vector."""
    return p.expand(b, n, t).reshape(-1)


def _uniform(shape, low: float, high: float,
             generator: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=generator,
                      device=generator.device) * (high - low) + low


def step_seed(seed: int, rank: int, step: int, *stream: int) -> int:
    """The seed of one train step's augmentation draws."""
    state = np.random.SeedSequence(
        [seed, rank, step, *stream]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def sample_crop_rects(hw: torch.Tensor, log_ar: torch.Tensor,
                      area_frac: torch.Tensor, u_xy: torch.Tensor):
    """mmaction's RandomResizedCrop sampler on given draws: ``hw`` (..., 2)
    image sizes, ``log_ar`` and ``area_frac`` (..., attempts), ``u_xy``
    (..., 2) uniforms. Returns (y, x, ch, cw) of the leading shape."""
    h, w = hw[..., 0], hw[..., 1]
    side = torch.minimum(h, w)
    ch, cw = side.clone(), side.clone()
    y, x = torch.floor((h - side) / 2), torch.floor((w - side) / 2)
    found = torch.zeros_like(h, dtype=torch.bool)
    for a in range(log_ar.shape[-1]):
        aspect = torch.exp(log_ar[..., a])
        area = area_frac[..., a] * (h * w)
        th = torch.round(torch.sqrt(area / aspect))
        tw = torch.round(torch.sqrt(area * aspect))
        take = ~found & (th <= h) & (tw <= w)
        ch, cw = torch.where(take, th, ch), torch.where(take, tw, cw)
        y = torch.where(take, torch.floor(u_xy[..., 0] * (h - th + 1.0)), y)
        x = torch.where(take, torch.floor(u_xy[..., 1] * (w - tw + 1.0)), x)
        found |= take
    return y, x, ch, cw


# -- the transforms, one frame (H, W, 3) float in [0, 255] at a time -------

def _taps(start: torch.Tensor, size: torch.Tensor, src: int, out: int):
    """The two source pixels and the second one's weight of each of
    ``out`` samples over [start, start + size) of a ``src``-pixel axis."""
    o = torch.arange(out, dtype=torch.float32, device=start.device)
    scale = size / torch.full_like(size, out)
    coord = torch.clamp(start + (o + 0.5) * scale - 0.5, 0.0, src - 1.0)
    lo = torch.floor(coord)
    i0 = lo.long()
    return i0, torch.clamp(i0 + 1, max=src - 1), coord - lo


def crop_resize(img: torch.Tensor, rect, out_hw) -> torch.Tensor:
    y, x, ch, cw = rect
    h, w, _ = img.shape
    r0, r1, fy = _taps(y, ch, h, out_hw[0])
    rows = img[r0] * (1 - fy)[:, None, None] + img[r1] * fy[:, None, None]
    c0, c1, fx = _taps(x, cw, w, out_hw[1])
    return rows[:, c0] * (1 - fx)[None, :, None] \
        + rows[:, c1] * fx[None, :, None]


def gray(img: torch.Tensor) -> torch.Tensor:
    return img[..., 0] * GRAY[0] + img[..., 1] * GRAY[1] \
        + img[..., 2] * GRAY[2]


def _blend(img: torch.Tensor, other, factor) -> torch.Tensor:
    return torch.clamp(factor * img + (1 - factor) * other, 0.0, 255.0)


def adjust_hue(img: torch.Tensor, turn) -> torch.Tensor:
    """torchvision's hue adjustment, on [0, 255] values."""
    r, g, b = img.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    flat = maxc == minc
    cr = maxc - minc
    s = cr / torch.where(flat, torch.ones_like(maxc), maxc)
    div = torch.where(flat, torch.ones_like(cr), cr)
    rc, gc, bc = (maxc - r) / div, (maxc - g) / div, (maxc - b) / div
    hr = (maxc == r) * (bc - gc)
    hg = ((maxc == g) & (maxc != r)) * (2.0 + rc - bc)
    hb = ((maxc != g) & (maxc != r)) * (4.0 + gc - rc)
    hue = torch.remainder((hr + hg + hb) / 6.0 + 1.0 + turn, 1.0)
    v = maxc
    i = torch.floor(hue * 6.0)
    f = hue * 6.0 - i
    i = i.long() % 6
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    table = torch.stack([torch.stack(c, -1) for c in (
        (v, q, p, p, t, v), (t, v, v, q, p, p), (p, p, t, v, v, q))], -2)
    return torch.gather(table, -1, i[..., None, None].expand(
        *i.shape, 3, 1))[..., 0]


def color_jitter(img: torch.Tensor, bright, contrast, sat, hue,
                 order: Sequence[int]) -> torch.Tensor:
    for op in order:
        if op == 0:
            img = torch.clamp(img * bright, 0.0, 255.0)
        elif op == 1:
            img = _blend(img, gray(img).mean(), contrast)
        elif op == 2:
            img = _blend(img, gray(img)[..., None], sat)
        else:
            img = adjust_hue(img, hue)
    return img


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    radius = int(torch.round(3.0 * torch.clamp(sigma, min=1e-6)))
    if radius == 0:
        return img
    i = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=img.device)
    k = torch.exp(-0.5 * (i / sigma) ** 2)
    k = k / k.sum()
    x = img.permute(2, 0, 1)[None]                       # (1, 3, H, W)
    x = F.conv2d(F.pad(x, (0, 0, radius, radius), mode='reflect'),
                 k.view(1, 1, -1, 1).expand(3, 1, -1, 1).contiguous(),
                 groups=3)
    x = F.conv2d(F.pad(x, (radius, radius, 0, 0), mode='reflect'),
                 k.view(1, 1, 1, -1).expand(3, 1, 1, -1).contiguous(),
                 groups=3)
    return x[0].permute(1, 2, 0)


Params = List[Tuple[str, Dict]]


class DeviceAugChain:
    """``chain(imgs_u8, orig_hw, generator)``: (B, N, T, Hs, Ws, 3) uint8
    staging frames and their (B, 2) original sizes -> normalised (B, N,
    T, out_h, out_w, 3) float32."""

    def __init__(self, spec: List[Tuple[str, Dict]], mean, std,
                 out_hw: Tuple[int, int], precision: str = 'fp32'):
        self.spec = spec
        self.precision = precision
        self.mean = [float(v) for v in mean]
        self.std = [float(v) for v in std]
        self.out_hw = out_hw

    def __call__(self, imgs: torch.Tensor, orig_hw: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
        return self.apply(imgs, self.draw(imgs.shape, orig_hw, generator))

    def draw(self, shape, orig_hw: torch.Tensor,
             generator: torch.Generator) -> Params:
        """Per-frame parameters of every op, flat over the (B*N*T) frames,
        drawn as the program draws them."""
        b, n, t, hs, ws, _ = shape
        params = []
        for typ, cfg in self.spec:
            g = _param_shape(b, n, t, cfg.get('same_on_clip', True),
                             cfg.get('same_across_clip', True))

            def uniform(low=0.0, high=1.0, extra=()):
                return _uniform(g + extra, low, high, generator)

            def frames(p):
                return _bcast(p, b, n, t)
            if typ == 'RandomResizedCrop':
                min_ar, max_ar = cfg.get('aspect_ratio_range',
                                         (3 / 4, 4 / 3))
                lo, hi = cfg.get('area_range', (0.08, 1.0))
                ohw = orig_hw.to(device=generator.device,
                                 dtype=torch.float32)[:, None, None, :]
                ohw = ohw.expand(g + (2,))
                y, x, ch, cw = sample_crop_rects(
                    ohw, uniform(math.log(min_ar), math.log(max_ar), (10,)),
                    uniform(lo, hi, (10,)), uniform(extra=(2,)))
                sy, sx = hs / ohw[..., 0], ws / ohw[..., 1]
                params.append((typ, dict(rects=tuple(
                    frames(v) for v in (y * sy, x * sx, ch * sy, cw * sx)))))
            elif typ == 'Flip':
                if cfg.get('direction', 'horizontal') != 'horizontal':
                    raise ValueError('the reference flips horizontally only')
                params.append((typ, dict(flip=frames(
                    uniform() < cfg.get('flip_ratio', 0.5)))))
            elif typ == 'ColorJitter':
                br, co, sa, hu = (cfg.get(k, 0) for k in (
                    'brightness', 'contrast', 'saturation', 'hue'))
                p = dict(bright=uniform(max(0.0, 1 - br), 1 + br),
                         contrast=uniform(max(0.0, 1 - co), 1 + co),
                         sat=uniform(max(0.0, 1 - sa), 1 + sa),
                         hue=uniform(-hu, hu),
                         apply=uniform() < cfg.get('p', 1.0))
                p = {k: frames(v) for k, v in p.items()}
                perm = torch.argsort(uniform(extra=(4,)), dim=-1)
                p['order'] = torch.stack(
                    [frames(perm[..., i]) for i in range(4)], -1)
                params.append((typ, p))
            elif typ == 'RandomGrayScale':
                params.append((typ, dict(apply=frames(
                    uniform() < cfg.get('p', 0.2)))))
            elif typ == 'RandomGaussianBlur':
                lo, hi = cfg.get('sigma_range', (0.1, 2.0))
                params.append((typ, dict(
                    sigma=frames(uniform(lo, hi)),
                    apply=frames(uniform() < cfg.get('p', 0.5)))))
            else:
                raise ValueError(f'no reference for {typ!r}')
        return params

    def apply(self, imgs: torch.Tensor, params: Params) -> torch.Tensor:
        b, n, t, hs, ws, c = imgs.shape
        frames = imgs.to(torch.float32).reshape(b * n * t, hs, ws, c)
        host = [(typ, {k: (tuple(x.cpu() for x in v) if k == 'rects'
                           else v.cpu()) for k, v in p.items()})
                for typ, p in params]
        mean = torch.tensor(self.mean, device=imgs.device)
        std = torch.tensor(self.std, device=imgs.device)
        out = []
        with matmul_precision(self.precision):
            for f, img in enumerate(frames):
                for typ, p in host:
                    if typ == 'RandomResizedCrop':
                        img = crop_resize(img, tuple(
                            v[f].to(img.device) for v in p['rects']),
                            self.out_hw)
                    elif typ == 'Flip' and p['flip'][f]:
                        img = img.flip(1)
                    elif typ == 'ColorJitter' and p['apply'][f]:
                        img = color_jitter(
                            img, float(p['bright'][f]),
                            float(p['contrast'][f]), float(p['sat'][f]),
                            float(p['hue'][f]), p['order'][f].tolist())
                    elif typ == 'RandomGrayScale' and p['apply'][f]:
                        img = gray(img)[..., None].expand(-1, -1, 3)
                    elif typ == 'RandomGaussianBlur' and p['apply'][f]:
                        img = gaussian_blur(img, p['sigma'][f].to(
                            img.device))
                out.append((img - mean) / std)
        return torch.stack(out).reshape(b, n, t, *self.out_hw, c)


def build_device_aug(transforms: Sequence[Dict], norm_cfg: Dict,
                     out_hw: Tuple[int, int] = (224, 224),
                     precision: str = 'fp32') -> DeviceAugChain:
    """The chain of pipeline-style transform dicts; a ``Resize`` sets the
    output size."""
    spec = []
    out_hw = tuple(out_hw)
    for t_cfg in transforms:
        t_cfg = dict(t_cfg)
        typ = t_cfg.pop('type')
        if typ == 'Resize':
            out_hw = (int(t_cfg['scale'][1]), int(t_cfg['scale'][0]))
            continue
        spec.append((typ, t_cfg))
    return DeviceAugChain(spec, norm_cfg['mean'], norm_cfg['std'], out_hw,
                          precision)
