"""On-device training augmentation (PyTorch counterpart of
``vfs_tpu/ops/device_aug.py``).

The loader ships uint8 frames at a fixed staging size (pipeline
``DeviceAug``: decode and one resize) and the whole chain runs in the
train step on the batch's device: crop sampling, a fused crop and
bilinear resize as two batched products, flip, colour jitter, grayscale,
gaussian blur and normalisation. Parameters are drawn per frame, per clip
or per sample (``same_on_clip`` / ``same_across_clip``) and broadcast to
the frames. Crop rectangles are sampled in original frame coordinates
(each sample carries ``orig_hw``) and mapped through the staging resize,
so the crop distribution is the host pipeline's.

Drawing and applying are separate: ``DeviceAugChain.draw`` turns a
``torch.Generator`` into per-frame parameters and ``DeviceAugChain.apply``
computes the chain from them, so the same parameters give the same frames
on the CPU and on the card. Every product and convolution runs in the
exact fp32 mode.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import exact_fp32
from ..utils import trace

_GRAY_W = (0.299, 0.587, 0.114)  # cv2 RGB2GRAY

Rects = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _param_shape(b: int, n: int, t: int, same_on_clip: bool,
                 same_across_clip: bool) -> Tuple[int, int, int]:
    """Shape of one op's draws (reference augmentations.py:285-300): one
    per frame unless ``same_on_clip``, one per clip unless
    ``same_across_clip``, else one per sample."""
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
    """The seed of one train step's augmentation draws: ranks draw apart,
    and a resumed run draws at step ``s`` what an uninterrupted one
    would (the JAX package folds the step into a per-process key).
    ``stream`` names another stream of the step (the heads' dropout)."""
    state = np.random.SeedSequence(
        [seed, rank, step, *stream]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def sample_crop_rects(hw: torch.Tensor, log_ar: torch.Tensor,
                      area_frac: torch.Tensor, u_xy: torch.Tensor
                      ) -> Rects:
    """The 10-attempt crop sampler (reference augmentations.py:196-236)
    on given draws: ``hw`` (..., 2) float image sizes; ``log_ar`` and
    ``area_frac`` (..., attempts) log aspect ratios and area fractions;
    ``u_xy`` (..., 2) uniforms in [0, 1) for the offset. Returns (y, x,
    ch, cw) of the leading shape: the first attempt that fits, else the
    centred min-side square."""
    h, w = hw[..., 0], hw[..., 1]
    aspect = torch.exp(log_ar)
    area = area_frac * (h * w)[..., None]
    cand_w = torch.round(torch.sqrt(area * aspect))
    cand_h = torch.round(torch.sqrt(area / aspect))
    ok = (cand_h <= h[..., None]) & (cand_w <= w[..., None])
    any_ok = ok.any(dim=-1)
    first = torch.argmax(ok.to(torch.uint8), dim=-1, keepdim=True)

    def pick(c):
        return torch.gather(c, -1, first)[..., 0]
    side = torch.minimum(h, w)
    ch = torch.where(any_ok, pick(cand_h), side)
    cw = torch.where(any_ok, pick(cand_w), side)
    # randint(0, W - cw) inclusive -> floor(u * (range + 1))
    y = torch.where(any_ok, torch.floor(u_xy[..., 0] * (h - ch + 1.0)),
                    torch.floor((h - side) / 2))
    x = torch.where(any_ok, torch.floor(u_xy[..., 1] * (w - cw + 1.0)),
                    torch.floor((w - side) / 2))
    return y, x, ch, cw


def _resize_weights(starts: torch.Tensor, sizes: torch.Tensor, src: int,
                    out: int) -> torch.Tensor:
    """(F,) crop starts and sizes in source pixels -> (F, out, src)
    bilinear sampling matrices (cv2 semantics: align_corners=False, border
    clamp)."""
    o = torch.arange(out, dtype=torch.float32, device=starts.device)
    # a tensor divisor: CUDA divides by a Python number through its
    # reciprocal, one ulp off the CPU's quotient, and one ulp of a
    # coordinate moves a pixel beside a sharp edge by ~0.01 of 255
    step = sizes / torch.full_like(sizes, out)
    coord = starts[:, None] + (o[None, :] + 0.5) * step[:, None] - 0.5
    coord = torch.clamp(coord, 0.0, src - 1.0)
    i = torch.arange(src, dtype=torch.float32, device=starts.device)
    return torch.clamp(1.0 - torch.abs(coord[..., None] - i), min=0.0)


def crop_resize(imgs: torch.Tensor, rects: Rects,
                out_hw: Tuple[int, int]) -> torch.Tensor:
    """Per-frame crop and bilinear resize as two batched products.
    ``imgs`` (F, H, W, C) float; ``rects`` (y, x, ch, cw), each (F,), in
    ``imgs`` coordinates. Returns (F, out_h, out_w, C)."""
    _, h, w, _ = imgs.shape
    y, x, ch, cw = rects
    wy = _resize_weights(y, ch, h, out_hw[0])        # (F, oh, H)
    wx = _resize_weights(x, cw, w, out_hw[1])        # (F, ow, W)
    tmp = torch.einsum('foh,fhwc->fowc', wy, imgs)
    return torch.einsum('fpw,fowc->fopc', wx, tmp)


def rgb_to_hsv(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """RGB [0, 255] -> (H degrees [0, 360), S [0, 1], V [0, 255])."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    safe_d = torch.where(d > 0, d, 1.0)
    hr = torch.remainder((g - b) / safe_d, 6.0)
    hg = (b - r) / safe_d + 2.0
    hb = (r - g) / safe_d + 4.0
    hch = torch.where(mx == r, hr, torch.where(mx == g, hg, hb))
    hdeg = torch.where(d > 0, 60.0 * hch, 0.0)
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, 1.0), 0.0)
    return hdeg, s, mx


def _select(conds: Sequence[torch.Tensor], vals: Sequence[torch.Tensor],
            default: torch.Tensor) -> torch.Tensor:
    """``jnp.select``: the value of the first true condition."""
    out = default
    for cond, val in zip(reversed(conds), reversed(vals)):
        out = torch.where(cond, val, out)
    return out


def hsv_to_rgb(hdeg: torch.Tensor, s: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    c = v * s
    hp = hdeg / 60.0
    xx = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    m = v - c
    z = torch.zeros_like(c)
    conds = [hp < 1, hp < 2, hp < 3, hp < 4, hp < 5]
    r = _select(conds, [c, xx, z, z, xx], c)
    g = _select(conds, [xx, c, c, xx, z], z)
    b = _select(conds, [z, z, xx, c, c], xx)
    return torch.stack([r + m, g + m, b + m], dim=-1)


def color_jitter(x: torch.Tensor, bright: torch.Tensor,
                 contrast: torch.Tensor, sat: torch.Tensor,
                 hue: torch.Tensor, apply: torch.Tensor,
                 order: torch.Tensor) -> torch.Tensor:
    """torchvision ColorJitter on (F, H, W, 3) float [0, 255] (reference
    augmentations.py:1280-1320): brightness, contrast (against the mean
    of the grayscale image), saturation (towards each pixel's grayscale)
    and hue, in the per-frame order ``order`` (F, 4), each step clipped to
    [0, 255]; frames whose ``apply`` is false pass unchanged. Params (F,).
    Each op runs on the frames that take it at that position (the JAX
    package evaluates all four on every frame and selects)."""
    gw = torch.tensor(_GRAY_W, dtype=x.dtype, device=x.device)

    def per_frame(p, idx):
        return p[idx][:, None, None, None]

    def brightness(y, idx):
        return torch.clamp(y * per_frame(bright, idx), 0.0, 255.0)

    def contrast_(y, idx):
        gm = (y * gw).sum(-1).mean(dim=(1, 2))[:, None, None, None]
        return torch.clamp((y - gm) * per_frame(contrast, idx) + gm,
                           0.0, 255.0)

    def saturation(y, idx):
        g = (y * gw).sum(-1, keepdim=True)
        return torch.clamp(g + (y - g) * per_frame(sat, idx), 0.0, 255.0)

    def hue_(y, idx):
        hdeg, s, v = rgb_to_hsv(y)
        hdeg = torch.remainder(hdeg + hue[idx][:, None, None] * 360.0,
                               360.0)
        return hsv_to_rgb(hdeg, s, v)

    ops = (brightness, contrast_, saturation, hue_)
    # the op each frame takes at each position, -1 where it takes none
    plan = torch.where(apply[:, None], order, -1).cpu()
    y = x.clone()
    for pos in range(4):
        for op_id, op in enumerate(ops):
            idx = torch.nonzero(plan[:, pos] == op_id).squeeze(1)
            if idx.numel():
                idx = idx.to(x.device)
                y[idx] = op(y[idx], idx)
    return y


def grayscale(x: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    gw = torch.tensor(_GRAY_W, dtype=x.dtype, device=x.device)
    g = (x * gw).sum(-1, keepdim=True)
    return torch.where(apply[:, None, None, None], g.expand_as(x), x)


def gaussian_blur(x: torch.Tensor, sigma: torch.Tensor, apply: torch.Tensor,
                  max_radius: int = 6) -> torch.Tensor:
    """Per-frame separable gaussian blur of (F, H, W, C) as two depthwise
    convolutions. Taps follow cv2's getGaussianKernel truncation (radius
    ``round(3 * sigma)``); taps past a frame's radius are zeroed before
    normalisation; ``max_radius`` must cover ``round(3 * max(sigma))``.
    Borders reflect-101 (cv2's default). Frames whose ``apply`` is false
    pass unchanged (the JAX package gives them an identity kernel, which
    returns them exactly)."""
    f, h, w, c = x.shape
    idx = torch.nonzero(apply.cpu()).squeeze(1).to(x.device)
    if not idx.numel():
        return x
    i = torch.arange(-max_radius, max_radius + 1, dtype=torch.float32,
                     device=x.device)
    sig = torch.clamp(sigma[idx], min=1e-6)[:, None]
    radius = torch.round(3.0 * sig)
    k = torch.exp(-0.5 * (i[None, :] / sig) ** 2)
    k = torch.where(torch.abs(i[None, :]) <= radius, k, 0.0)
    k = k / k.sum(dim=1, keepdim=True)                       # (S, taps)
    n = idx.numel()
    kf = k.repeat_interleave(c, dim=0)                       # (S*C, taps)
    xt = x[idx].permute(0, 3, 1, 2).reshape(1, n * c, h, w)
    xv = F.pad(xt, (0, 0, max_radius, max_radius), mode='reflect')
    out = F.conv2d(xv, kf[:, None, :, None], groups=n * c)
    xv = F.pad(out, (max_radius, max_radius, 0, 0), mode='reflect')
    out = F.conv2d(xv, kf[:, None, None, :], groups=n * c)
    y = x.clone()
    y[idx] = out.reshape(n, c, h, w).permute(0, 2, 3, 1)
    return y


# every kwarg each transform may carry on the device; anything else
# (same_clip_indices, typos, host-only features) raises rather than
# silently changing the augmentation distribution
_FLAGS = ('same_on_clip', 'same_across_clip')
_KNOWN = {
    'Resize': ('scale', 'keep_ratio'),
    'RandomResizedCrop': ('area_range', 'aspect_ratio_range') + _FLAGS,
    'Flip': ('flip_ratio', 'direction') + _FLAGS,
    'ColorJitter': ('brightness', 'contrast', 'saturation', 'hue',
                    'p') + _FLAGS,
    'RandomGrayScale': ('p',) + _FLAGS,
    'RandomGaussianBlur': ('p', 'sigma_range') + _FLAGS,
}

Params = List[Tuple[str, Dict]]


class DeviceAugChain:
    """The on-device chain ``build_device_aug`` compiles. Call it as
    ``chain(imgs_u8, orig_hw, generator)``: (B, N, T, Hs, Ws, 3) uint8
    staging frames and their (B, 2) original sizes -> normalised
    (B, N, T, out_h, out_w, 3) float32, drawing from ``generator`` (on the
    frames' device)."""

    def __init__(self, spec: List[Tuple[str, Dict]], mean, std,
                 out_hw: Tuple[int, int]):
        self.spec = spec
        self.mean = [float(v) for v in mean]
        self.std = [float(v) for v in std]
        self.out_hw = out_hw  # resolved output size (a Resize in the chain)

    def __call__(self, imgs: torch.Tensor, orig_hw: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
        return self.apply(imgs, self.draw(imgs.shape, orig_hw, generator))

    def draw(self, shape, orig_hw: torch.Tensor,
             generator: torch.Generator) -> Params:
        """Per-frame parameters of every op, flat over the (B*N*T) frames
        of a batch of ``shape`` (B, N, T, Hs, Ws, C), in the span
        ``aug.draw`` (``utils.trace``)."""
        with trace.span('aug.draw'):
            return self._draw(shape, orig_hw, generator)

    def _draw(self, shape, orig_hw: torch.Tensor,
              generator: torch.Generator) -> Params:
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
                # original -> staging coordinates (per-axis scale)
                sy, sx = hs / ohw[..., 0], ws / ohw[..., 1]
                params.append((typ, dict(rects=tuple(
                    frames(v) for v in (y * sy, x * sx, ch * sy, cw * sx)))))
            elif typ == 'Flip':
                axis = 2 if cfg.get('direction', 'horizontal') \
                    == 'horizontal' else 1
                params.append((typ, dict(axis=axis, flip=frames(
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
                # a random op order per draw (torchvision get_params)
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
                    apply=frames(uniform() < cfg.get('p', 0.5)),
                    max_radius=max(1, int(round(3 * hi))))))
        return params

    def apply(self, imgs: torch.Tensor, params: Params) -> torch.Tensor:
        """The chain on uint8 ``imgs`` (B, N, T, Hs, Ws, C) with drawn
        ``params``, in fp32 (TF32 off); each transform runs in a span
        ``aug.<type>``, the normalisation in ``aug.normalise``
        (``utils.trace``)."""
        b, n, t, hs, ws, c = imgs.shape
        x = imgs.to(torch.float32).reshape(b * n * t, hs, ws, c)
        cropped = False
        with exact_fp32():
            for typ, p in params:
                with trace.span('aug.' + typ):
                    if typ == 'RandomResizedCrop':
                        x = crop_resize(x, p['rects'], self.out_hw)
                        cropped = True
                    elif typ == 'Flip':
                        x = torch.where(p['flip'][:, None, None, None],
                                        x.flip(p['axis']), x)
                    elif typ == 'ColorJitter':
                        x = color_jitter(x, p['bright'], p['contrast'],
                                         p['sat'], p['hue'], p['apply'],
                                         p['order'])
                    elif typ == 'RandomGrayScale':
                        x = grayscale(x, p['apply'])
                    elif typ == 'RandomGaussianBlur':
                        x = gaussian_blur(x, p['sigma'], p['apply'],
                                          p['max_radius'])
        if not cropped and (hs, ws) != self.out_hw:
            raise ValueError('device aug without RandomResizedCrop needs '
                             f'staging == out size, got {(hs, ws)} vs '
                             f'{self.out_hw}')
        with trace.span('aug.normalise'):
            mean = torch.tensor(self.mean, dtype=torch.float32,
                                device=x.device)
            std = torch.tensor(self.std, dtype=torch.float32,
                               device=x.device)
            x = (x - mean) / std
        return x.reshape(b, n, t, self.out_hw[0], self.out_hw[1], c)


def build_device_aug(transforms: Sequence[Dict], norm_cfg: Dict,
                     out_hw: Tuple[int, int] = (224, 224)) -> DeviceAugChain:
    """Compile an on-device chain from pipeline-style transform dicts (the
    dicts a host ``train_pipeline`` uses).

    Types: RandomResizedCrop (fused with a following ``Resize(scale,
    keep_ratio=False)``, which sets ``out_hw``), Flip, ColorJitter,
    RandomGrayScale, RandomGaussianBlur. ``norm_cfg`` (mean / std) is
    applied last. An unknown type or kwarg, a keep-ratio ``Resize``,
    missing normalisation constants and ``to_bgr`` raise ``ValueError``.
    """
    spec = []
    out_hw = tuple(out_hw)
    for t_cfg in transforms:
        t_cfg = dict(t_cfg)
        typ = t_cfg.pop('type')
        if typ not in _KNOWN:
            raise ValueError(f'device aug does not support {typ!r}; keep '
                             f'it on the host pipeline')
        unknown = sorted(set(t_cfg) - set(_KNOWN[typ]))
        if unknown:
            raise ValueError(
                f'device aug {typ}: unsupported kwargs {unknown} (the host '
                f'transform may support them; keep such pipelines on the '
                f'host)')
        if typ == 'Resize':
            scale = t_cfg.get('scale')
            if t_cfg.get('keep_ratio', True) or scale is None:
                raise ValueError('device aug Resize must be '
                                 'keep_ratio=False with explicit scale')
            out_hw = (int(scale[1]), int(scale[0]))  # (W, H) -> (H, W)
            continue
        spec.append((typ, t_cfg))
    if norm_cfg is None or 'mean' not in norm_cfg or 'std' not in norm_cfg:
        raise ValueError(
            'device aug needs normalization constants: set img_norm_cfg '
            'at the config top level or inside cfg.device_aug')
    if norm_cfg.get('to_bgr'):
        raise ValueError('device aug: to_bgr unsupported (keep RGB)')
    return DeviceAugChain(spec, norm_cfg['mean'], norm_cfg['std'], out_hw)
