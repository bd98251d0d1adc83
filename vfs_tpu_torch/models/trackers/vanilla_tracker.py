"""VanillaTracker: inference-only label propagation (PyTorch counterpart of
``vfs_tpu/models/trackers/vanilla_tracker.py``).

The eval path of DAVIS semi-supervised VOS: the ResNet runs at test
strides over frame chunks of ``batch_step`` (BN is in eval mode, so the
chunking does not change the features), the first-frame labels propagate
through the whole video (``vfs_tpu_torch.ops.propagate_video``), and each
frame decodes by bilinear upsample, min-max normalisation, padded-class
masking and argmax.

``test_cfg`` keys are the JAX package's. Accepted with no effect, because
they only served the TPU host link or XLA's compile buckets:
``pack_preds``, ``input_format='rgb'``, ``extract_bulk_step``, and the T
padding of ``preload`` (frames only look backwards, so results on real
frames do not depend on it; eager PyTorch has no buckets to fill).
``preload`` copies a video to the card ahead of ``forward_test``; with
``input_format='yuv420'`` it packs uint8 RGB frames to flat planar I420
on the host first (a ``Yuv420Frames`` from ``RawFrameDecodeYUV420`` is
shipped as it is), 1.5 bytes a pixel, and ``_extract_feats`` unpacks them
on the card (``ops.yuv.yuv420_to_rgb``) ahead of the normalisation.
A bf16 backbone (``backbone.dtype='bfloat16'``) runs its convolutions
under bf16 autocast, also inside the exact fp32 mode of the eval, and its
features are cast to fp32 at the seam, as in the JAX package.
``distribute`` gives one backbone for each of several devices, which
``apis.single_process_test(devices=...)`` holds for one run and hands to
``forward_test``.
"""

from __future__ import annotations

import copy
import os
import os.path as osp
import tempfile
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ...checkpoint import load_backbone_state, load_torchvision_resnet
from ...device import DeviceLike, exact_fp32, resolve_device
from ...ops.affinity import spatial_neighbor
from ...ops.propagation import PropagationConfig, propagate_video
from ...ops.resize import pil_nearest_resize, resize_bilinear
from ...ops.video_affinity import flush_counts
from ...ops.yuv import Yuv420Frames, rgb_to_yuv420, yuv420_to_rgb
from ...utils import trace
from .. import builder
from ..backbones.resnet import ResNetBlockwise
from ..common.utils import normalize_logit
from ..registry import TRACKERS


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_propagation_config(test_cfg: Dict, h: int, w: int):
    """Resolve the ``PropagationConfig`` (and the dense mask where the
    local engine does not apply) from ``test_cfg`` at feature grid
    ``(h, w)``. ``backend`` defaults to ``'pallas_video'``; it and
    ``'tiled'`` run the same decoupled engine, which dispatches on the
    features' device (the kernel on CUDA, the plain version on the CPU)."""
    neighbor_range = test_cfg.get('neighbor_range', None)
    with_first_neighbor = bool(test_cfg.get('with_first_neighbor', True))
    with_norm = bool(test_cfg.get('with_norm', True))
    use_local = (neighbor_range is not None and with_first_neighbor
                 and with_norm)
    mask = None
    if neighbor_range is not None and not use_local:
        mask = spatial_neighbor(h, w, neighbor_range, mode='circle')
    cfg = PropagationConfig(
        precede_frames=int(test_cfg.get('precede_frames', 20)),
        topk=int(test_cfg.get('topk', 10)),
        temperature=float(test_cfg.get('temperature', 1.0)),
        with_first=bool(test_cfg.get('with_first', True)),
        with_first_neighbor=with_first_neighbor,
        with_norm=with_norm,
        neighbor_range=int(neighbor_range) if use_local else None,
        backend=test_cfg.get('backend', 'pallas_video'),
        pallas_tile=tuple(test_cfg.get(
            'pallas_tile', PropagationConfig._field_defaults['pallas_tile'])),
        pallas_scores=test_cfg.get('pallas_scores', 'float32'),
        pallas_fetch=test_cfg.get('pallas_fetch', 'perframe'),
        pallas_precision=test_cfg.get('pallas_precision', 'float32'),
        pallas_matmul=test_cfg.get('pallas_matmul', 'perframe'),
        pallas_group_frames=test_cfg.get('pallas_group_frames'),
        pallas_extract=test_cfg.get('pallas_extract', 'mask'),
        video_extract=test_cfg.get('video_extract', 'sweep'),
        video_early_exit=bool(test_cfg.get('video_early_exit', True)),
        video_bank_splits=test_cfg.get('video_bank_splits'),
        video_sweep_rows=int(test_cfg.get('video_sweep_rows', 1)),
        video_pass_mode=test_cfg.get('video_pass_mode', 'maxfirst'),
        video_engine=test_cfg.get('video_engine', 'v2'),
        video_qpair=int(test_cfg.get('video_qpair', 0)),
        video_compact=bool(test_cfg.get('video_compact', True)))
    return cfg, mask


class PackedFrames(NamedTuple):
    """A video as flat planar I420, ``frames`` (T, He*We*3/2) uint8 on its
    device, with the frames' ``hw`` and YUV ``convention``: what
    ``preload`` returns under ``input_format='yuv420'``."""
    frames: torch.Tensor
    hw: Tuple[int, int]
    convention: str


def decode_predictions(seg_logits: torch.Tensor, out_hw: Tuple[int, int],
                       class_valid: torch.Tensor,
                       chunk: int = 8) -> torch.Tensor:
    """(T, h, w, K) logits -> (T, *out_hw) uint8 labels: bilinear upsample,
    min-max normalise, padded classes to -1, argmax (first maximum)."""
    preds = []
    for i in range(0, seg_logits.shape[0], chunk):
        up = normalize_logit(resize_bilinear(seg_logits[i:i + chunk],
                                             out_hw))
        up = torch.where(class_valid, up, -1.0)
        preds.append(torch.argmax(up, dim=-1).to(torch.uint8))
    return torch.cat(preds, 0)


@TRACKERS.register_module()
class VanillaTracker(nn.Module):
    """Pixel tracker: propagate first-frame labels through a video."""

    def __init__(self, backbone: Dict, train_cfg: Optional[Dict] = None,
                 test_cfg: Optional[Dict] = None, **kwargs):
        super().__init__()
        test_cfg = dict(test_cfg or {})
        self.test_cfg = test_cfg
        self.train_cfg = train_cfg
        backbone = dict(backbone)
        self.pretrained = backbone.pop('pretrained', None)
        # the reference rebuilds the backbone with test-time strides and
        # out_indices (weights do not depend on them)
        if 'strides' in test_cfg:
            backbone['strides'] = tuple(test_cfg['strides'])
        if 'out_indices' in test_cfg:
            backbone['out_indices'] = tuple(test_cfg['out_indices'])
        self.backbone_cfg = backbone
        self.all_blocks = test_cfg.get('all_blocks', False)
        if self.all_blocks:
            cfg = dict(backbone)
            cfg.pop('type', None)
            self.backbone = ResNetBlockwise(**cfg)
        else:
            self.backbone = builder.build_backbone(backbone)
        self.save_np = test_cfg.get('save_np', False)

    # -- weights ----------------------------------------------------------
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Seeded random init (``generator``), then the ``pretrained``
        checkpoint when the config names one."""
        self.backbone.init_weights(generator)
        if self.pretrained:
            self.load_weights(self.pretrained)

    def load_weights(self, path_or_state: Union[str, Dict[str, Any]]):
        """Load a torchvision-layout ``.pth`` path or a state dict."""
        sd = (load_torchvision_resnet(path_or_state)
              if isinstance(path_or_state, str) else path_or_state)
        load_backbone_state(self.backbone, sd)

    @property
    def stride(self) -> int:
        """Total output stride of the eval feature."""
        end_index = self.backbone.out_indices[0]
        out = 4
        for s in self.backbone.strides[:end_index + 1]:
            out *= s
        return out

    def distribute(self, devices) -> List[nn.Module]:
        """One backbone for each entry of ``devices`` (JAX ``distribute``),
        to hand to ``forward_test`` as ``backbone`` so that worker threads
        of several devices share no module: the model's own backbone on the
        device it sits on, a copy of its current weights on each other
        device (a device named twice gets the same module). Nothing is kept
        on the model: the copies live as long as the caller holds them, so
        later weights are never shadowed by earlier ones."""
        own = next(self.backbone.parameters()).device
        by_device: Dict[torch.device, nn.Module] = {}
        out = []
        for d in devices:
            dev = resolve_device(d)
            if dev.type == 'cuda' and dev.index is None:
                dev = torch.device('cuda', torch.cuda.current_device())
            if dev not in by_device:
                by_device[dev] = self._prepare(
                    self.backbone if dev == own
                    else copy.deepcopy(self.backbone).to(dev), dev)
            out.append(by_device[dev])
        return out

    @staticmethod
    def _prepare(backbone: nn.Module, dev: torch.device) -> nn.Module:
        backbone.eval()
        if dev.type == 'cuda':
            backbone.to(memory_format=torch.channels_last)
        return backbone

    # -- stages -----------------------------------------------------------
    def _extract_feats(self, imgs: torch.Tensor, batch_step: int,
                       norm_mean: Optional[torch.Tensor] = None,
                       norm_std: Optional[torch.Tensor] = None,
                       yuv: Optional[Tuple[int, int, str]] = None,
                       backbone: Optional[nn.Module] = None
                       ) -> Tuple[torch.Tensor, ...]:
        """imgs (T, H, W, 3) -> tuple of (T, h, w, c) fp32 feature banks
        on imgs' device, ``batch_step`` frames per backbone call. uint8
        frames are normalised on the device; with ``yuv = (H, W,
        convention)``, imgs is flat planar I420 (T, He*We*3/2) uint8,
        unpacked to RGB on the device first. ``backbone``: a copy on imgs'
        device (``distribute``); the model's own, moved there, if None."""
        if backbone is None:
            self.to(imgs.device)
            backbone = self._prepare(self.backbone, imgs.device)
        banks = None
        with torch.no_grad(), exact_fp32():
            for i in range(0, imgs.shape[0], batch_step):
                chunk = imgs[i:i + batch_step]
                if yuv is not None:
                    chunk = (yuv420_to_rgb(chunk, *yuv) - norm_mean) / norm_std
                elif chunk.dtype == torch.uint8:
                    chunk = (chunk.to(torch.float32) - norm_mean) / norm_std
                outs = backbone(chunk)
                outs = outs if isinstance(outs, tuple) else (outs,)
                if banks is None:
                    # each bank is filled in place: no chunk list and no
                    # concatenated copy beside it (six r50 banks under
                    # all_blocks are 7.6 GB at 48x480x854)
                    banks = tuple(
                        torch.empty((imgs.shape[0], *o.shape[1:]),
                                    dtype=torch.float32, device=o.device)
                        for o in outs)
                for bank, o in zip(banks, outs):
                    bank[i:i + o.shape[0]].copy_(o)
                # the chunk's outputs go before the next chunk runs
                del outs, chunk
        return banks

    def _propagate_decode(self, feats: torch.Tensor, seg_first: torch.Tensor,
                          mask, class_valid: torch.Tensor,
                          cfg: PropagationConfig, out_hw: Tuple[int, int]):
        """Propagation and decode: returns (seg_preds uint8 (T, *out_hw),
        seg_logits (T, h, w, K))."""
        with torch.no_grad(), exact_fp32():
            seg_logits = propagate_video(feats, seg_first, mask, cfg)
            return (decode_predictions(seg_logits, out_hw, class_valid),
                    seg_logits)

    # -- orchestration ----------------------------------------------------
    def preload(self, imgs, device: DeviceLike = None
                ) -> Union[torch.Tensor, PackedFrames]:
        """Copy a video's frames ((T, H, W, 3) numpy or tensor) to
        ``device`` (CUDA unless the caller says otherwise) and return them;
        ``forward_test`` takes the result in place of the frames. Under
        ``input_format='yuv420'``, uint8 RGB frames on the host are packed
        to flat planar I420 first (``rgb_to_yuv420``, studio swing), and a
        ``Yuv420Frames`` is shipped as it is: the result is then a
        ``PackedFrames``. The copy is synchronous (from pageable host
        memory), so a prefetch thread that calls this hands over frames
        that are already on the device."""
        dev = resolve_device(device)
        if isinstance(imgs, PackedFrames):
            return imgs._replace(frames=imgs.frames.to(dev))
        if isinstance(imgs, Yuv420Frames):
            return PackedFrames(
                torch.as_tensor(np.ascontiguousarray(imgs.view(np.ndarray)))
                .to(dev), imgs.hw, imgs.convention)
        if self.test_cfg.get('input_format', 'rgb') == 'yuv420':
            host = (imgs.numpy() if torch.is_tensor(imgs)
                    and imgs.device.type == 'cpu' else imgs)
            if isinstance(host, np.ndarray) and host.dtype == np.uint8 \
                    and host.ndim == 4 and host.shape[-1] == 3:
                return PackedFrames(
                    torch.from_numpy(rgb_to_yuv420(host)).to(dev),
                    tuple(host.shape[1:3]), 'studio')
        host = imgs if torch.is_tensor(imgs) else torch.as_tensor(
            np.ascontiguousarray(imgs))
        return host.to(dev)

    def forward_test(self, imgs, ref_seg_map: np.ndarray,
                     img_meta: List[Dict[str, Any]],
                     defer_fetch: bool = False, device: DeviceLike = None,
                     backbone: Optional[nn.Module] = None):
        """Propagate ``ref_seg_map`` (H0, W0 int labels, or (H0, W0, K) soft
        labels) through ``imgs`` ((T, H, W, 3) normalised float RGB, or
        uint8 with ``img_norm_cfg`` in the meta; numpy, a tensor, a
        ``Yuv420Frames``, or what ``preload`` returns). Runs on CUDA unless
        ``device`` says otherwise. Returns the per-feature list of (T, H0,
        W0) uint8 predictions with frame 0 = the input labels (soft labels:
        (T, K, H0, W0) heatmaps); ``defer_fetch`` returns a thunk that
        gives the same list. ``backbone``: the weights to run, on
        ``device`` (an entry of ``distribute``'s list); the model's own
        if None. Spans (``utils.trace``): ``tracker.extract``, then for each
        feature bank (counter ``tracker.blocks``) ``tracker.labels`` (the
        first frame's labels at feature size, on the device),
        ``tracker.propagate`` and ``tracker.readback`` (the predictions'
        copy to the host)."""
        test_cfg = self.test_cfg
        yuv = None
        if isinstance(imgs, (PackedFrames, Yuv420Frames)) or test_cfg.get(
                'input_format', 'rgb') == 'yuv420':
            imgs = self.preload(imgs, device)
        if isinstance(imgs, PackedFrames):
            yuv = tuple(imgs.hw) + (imgs.convention,)
            imgs = imgs.frames
        imgs = torch.as_tensor(
            np.asarray(imgs) if not torch.is_tensor(imgs) else imgs).to(
                resolve_device(device))
        dev = imgs.device
        batch_step = int(test_cfg.get('batch_step', 20))

        norm_mean = norm_std = None
        if imgs.dtype == torch.uint8:
            norm_cfg = img_meta[0].get('img_norm_cfg',
                                       dict(mean=np.zeros(3),
                                            std=np.ones(3)))
            norm_mean = torch.as_tensor(
                np.asarray(norm_cfg['mean'], np.float32), device=dev)
            norm_std = torch.as_tensor(
                np.asarray(norm_cfg['std'], np.float32), device=dev)
        else:
            imgs = imgs.to(torch.float32)
        with trace.span('tracker.extract'):
            feats = self._extract_feats(imgs, batch_step, norm_mean,
                                        norm_std, yuv, backbone)

        original_shape = tuple(img_meta[0]['original_shape'][:2])
        input_onehot = ref_seg_map.ndim == 3  # (H, W, K) soft labels
        all_seg_preds = []
        for feat in feats:
            trace.count('tracker.blocks')
            h, w = feat.shape[1:3]
            cfg, mask = make_propagation_config(test_cfg, h, w)
            if not input_onehot:
                with trace.span('tracker.labels'):
                    # PIL-nearest downsample of int labels -> one-hot
                    resized = pil_nearest_resize(
                        ref_seg_map.astype(np.float32),
                        (h, w)).astype(np.int64)
                    num_classes = int(ref_seg_map.max()) + 1
                    k_pad = _round_up(max(num_classes, 2), 4)
                    seg_first = torch.as_tensor(
                        np.eye(k_pad, dtype=np.float32)[resized], device=dev)
                    class_valid = torch.as_tensor(
                        np.arange(k_pad) < num_classes, device=dev)
                    first_pred = ref_seg_map.astype(np.uint8)
                    if first_pred.shape != original_shape:
                        from PIL import Image
                        first_pred = np.asarray(
                            Image.fromarray(first_pred).resize(
                                (original_shape[1], original_shape[0]),
                                Image.NEAREST))
                with trace.span('tracker.propagate'):
                    seg_preds, _ = self._propagate_decode(
                        feat, seg_first, mask, class_valid, cfg,
                        original_shape)
                with trace.span('tracker.readback'):
                    seg_preds = seg_preds.cpu().numpy()
                flush_counts()  # row 1's counters, after the readback's sync
                seg_preds[0] = first_pred  # frame 0 = the input labels
                all_seg_preds.append(seg_preds[None])  # (1, T, H0, W0)
            else:
                # soft labels (JHMDB pose heatmaps): bilinear both ways;
                # per-frame heatmaps channel-first (T, K, H0, W0)
                with trace.span('tracker.labels'):
                    ref = torch.as_tensor(ref_seg_map, dtype=torch.float32,
                                          device=dev)[None]
                with torch.no_grad(), exact_fp32(), \
                        trace.span('tracker.propagate'):
                    seg_first = resize_bilinear(ref, (h, w))[0]
                    seg_logits = propagate_video(feat, seg_first, mask, cfg)
                    logits = resize_bilinear(seg_logits, original_shape)
                    logits[0] = resize_bilinear(ref, original_shape)[0]
                with trace.span('tracker.readback'):
                    logits = logits.permute(0, 3, 1, 2).cpu().numpy()
                flush_counts()
                all_seg_preds.append(logits[None])

        if self.save_np:
            eval_dir = '.eval'
            os.makedirs(eval_dir, exist_ok=True)
            paths = []
            for seg_preds in all_seg_preds:
                with tempfile.NamedTemporaryFile(
                        dir=eval_dir, suffix='.npy', delete=False) as tf:
                    np.save(tf, seg_preds[0])
                paths.append(osp.join(eval_dir, osp.basename(tf.name)))
            paths = [paths] if len(paths) > 1 else [paths[0]]
            return (lambda: paths) if defer_fetch else paths
        if len(all_seg_preds) > 1:
            out = list(np.stack(all_seg_preds, axis=1))
        else:
            out = list(all_seg_preds[0])
        return (lambda: out) if defer_fetch else out
