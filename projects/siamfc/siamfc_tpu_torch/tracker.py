"""SiamFC tracker: init/update inference loop + linear-probe training
(PyTorch counterpart of ``siamfc_tpu/tracker.py``).

Reference: projects/siamfc-pytorch/siamfc/siamfc_tracker_base.py:88-500.
The backbone + xcorr forward runs on the tracker's device (CUDA unless the
caller passes ``device='cpu'``) in exact fp32 (TF32 off for cuBLAS and
cuDNN: the xcorr's argmax decides each box). The per-frame box logic stays
host-side numpy as in the reference; with ``device_crops`` (the default)
the scale crops and the response post-processing run on the device too
(``device_crops.py``) and three ints a sequence come back.
"""

from __future__ import annotations

import copy
import functools
import os
import os.path as osp
import time
from typing import Optional

import cv2
import numpy as np
import torch
import torch.nn as nn

from vfs_tpu_torch import exact_fp32, resolve_device
from vfs_tpu_torch.checkpoint import (load_backbone_state,
                                      load_torchvision_resnet,
                                      save_checkpoint)
from vfs_tpu_torch.core.optimizer import ChainedOptimizer
from vfs_tpu_torch.datasets.builder import DataLoader
from vfs_tpu_torch.models import build_backbone
from vfs_tpu_torch.utils import get_root_logger

from . import ops
from .datasets import Pair, SiamFCTransforms
from .device_crops import (cubic_resize_matrix, device_response_post,
                           device_scale_crops, make_region, make_taps)
from .heads import SiamConvFC, SiamFC, flax_conv_init_
from .losses import balanced_loss, create_labels, focal_loss

IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)


def flax_resnet_init_(backbone: nn.Module,
                      generator: Optional[torch.Generator] = None) -> None:
    """The JAX package's ResNet initialisers, by distribution: every conv
    as flax ``nn.Conv`` draws it (``heads.flax_conv_init_``), BatchNorm
    scale 1, shift 0 and fresh running statistics, and the last
    BatchNorm of each block zero under ``zero_init_residual``."""
    with torch.no_grad():
        for m in backbone.modules():
            if isinstance(m, nn.Conv2d):
                flax_conv_init_(m, generator)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.reset_running_stats()
        if getattr(backbone, 'zero_init_residual', False):
            for m in backbone.modules():
                if hasattr(m, 'last_bn'):
                    m.last_bn.weight.zero_()


class Net(nn.Module):
    """backbone + head (reference Net, :75-85); channels-last maps."""

    def __init__(self, backbone, head):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def features(self, imgs):
        out = self.backbone(imgs)
        return out[-1] if isinstance(out, tuple) else out

    def forward(self, z, x):
        return self.head(self.features(z), self.features(x))


class TrackerSiamFC:

    def __init__(self, cfg, logger=None, device=None):
        self.cfg = cfg
        self.logger = logger or get_root_logger()
        self.device = resolve_device(device)
        backbone_cfg = dict(cfg['model']['backbone'])
        backbone_cfg.setdefault('type', 'ResNet')
        backbone_cfg.setdefault('depth', 18)
        if cfg['extra_conv']:
            head = SiamConvFC(cfg['out_channels'],
                              cfg['out_channels'] // cfg['reduction'],
                              out_scale=cfg['out_scale'])
        else:
            head = SiamFC(out_scale=cfg['out_scale'])
        self.net = self._place(Net(build_backbone(backbone_cfg), head),
                               self.device)

    @staticmethod
    def _place(net, device):
        net = net.to(device).eval()
        if device.type == 'cuda':
            net.backbone.to(memory_format=torch.channels_last)
        return net

    def clone(self, device=None):
        """A tracker with its own per-sequence tracking state on
        ``device`` (this one's when None): the same module on the same
        device, a copy of the current weights on another. One clone per
        device drives parallel OTB sequences (reference
        siamfc_tracker_base.py:393's DataParallel)."""
        dev = self.device if device is None else resolve_device(device)
        t = TrackerSiamFC.__new__(TrackerSiamFC)
        t.cfg, t.logger, t.device = self.cfg, self.logger, dev
        t.net = self.net if dev == self.device else self._place(
            copy.deepcopy(self.net).cpu(), dev)
        return t

    # -- weights -----------------------------------------------------------
    def init_weights(self, pretrained: Optional[str] = None,
                     generator: Optional[torch.Generator] = None):
        """Seeded random weights drawn on the CPU from ``generator`` (seed
        0 when None) from the JAX package's initialisers
        (``flax_resnet_init_`` for the backbone, flax ``nn.Conv``'s
        defaults for the head); then the torchvision-layout backbone
        ``pretrained`` when given."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        # draw into contiguous memory: a fill of channels_last parameters
        # (the layout on CUDA) would lay the same stream out otherwise
        net = self.net.cpu().to(memory_format=torch.contiguous_format)
        flax_resnet_init_(net.backbone, generator)
        net.head.init_weights(generator)
        if pretrained:
            load_backbone_state(net.backbone,
                                load_torchvision_resnet(pretrained))
            self.logger.info(f'loaded backbone from {pretrained}')
        self.net = self._place(net, self.device)
        return self.net

    # -- device pieces --------------------------------------------------------
    @property
    def dtype(self):
        return next(self.net.parameters()).dtype

    def _upload(self, arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _readback(self, t):
        return t.cpu().numpy()

    def _normalise(self, x):
        """uint8 or float crops on the device -> normalised in the net's
        dtype (crops ship uint8: 4x fewer bytes to the device)."""
        mean = torch.as_tensor(IMG_MEAN, device=x.device).to(self.dtype)
        std = torch.as_tensor(IMG_STD, device=x.device).to(self.dtype)
        return (x.to(self.dtype) - mean) / std

    @torch.no_grad()
    def _backbone_fwd(self, imgs):
        """(N, H, W, 3) crops (numpy or a tensor) -> (N, h, w, C)."""
        if isinstance(imgs, np.ndarray):
            imgs = self._upload(imgs)
        with exact_fp32():
            return self.net.features(self._normalise(imgs))

    @torch.no_grad()
    def _update_fwd(self, kernel, x):
        """Search-branch forward from host crops: backbone + xcorr."""
        with exact_fp32():
            xf = self.net.features(self._normalise(self._upload(x)))
            return self.net.head(kernel, xf)

    def _post_consts(self, r):
        """The ``r -> response_up * response_sz`` bicubic matrix and the
        hann window on the device (the host path resizes whatever size
        the xcorr yields)."""
        cache = self.__dict__.setdefault('_consts', {})
        key = r
        if key not in cache:
            up = self.cfg['response_up'] * self.cfg['response_sz']
            cache[key] = (
                torch.as_tensor(cubic_resize_matrix(r, up),
                                device=self.device),
                torch.as_tensor(self._hann_window, dtype=torch.float32,
                                device=self.device))
        return cache[key]

    @torch.no_grad()
    def _region_responses(self, kernel, region, taps):
        """The device half up to the raw responses: scale crops
        (cv2-bit-replicating int32 gathers,
        ``device_crops.device_scale_crops``), backbone and xcorr.

        region: (K, bucket, bucket, 3) uint8; taps: (K, S, 8, out) int32
        (numpy). Crops are flattened scale-major (row s*K+j) to pair crop
        (s, j) with kernel j under fast_xcorr's grouping. Returns (K, S,
        r, r) responses on the device.
        """
        cfg = self.cfg
        k_seq = region.shape[0]
        with exact_fp32():
            crops = device_scale_crops(self._upload(region),
                                       self._upload(taps))
            x = crops.transpose(0, 1).reshape(
                -1, cfg['instance_sz'], cfg['instance_sz'], 3)
            xf = self.net.features(self._normalise(x))
            resp = self.net.head(kernel, xf)[..., 0]
            return resp.reshape(cfg['scale_num'], k_seq,
                                *resp.shape[1:]).transpose(0, 1)

    @torch.no_grad()
    def _update_fwd_region(self, kernel, region, taps):
        """Whole update step from ONE host-cut search region a sequence:
        ``_region_responses`` and the response post-processing on the
        device; only (scale_id, peak y, peak x) a sequence come back, as a
        (3, K) int64 array."""
        cfg = self.cfg
        resp = self._region_responses(kernel, region, taps)
        with exact_fp32():
            up_mat, hann = self._post_consts(resp.shape[-1])
            peaks = device_response_post(
                resp.float(), up_mat, hann, cfg['scale_penalty'],
                cfg['window_influence'])
            return self._readback(torch.stack(peaks))

    # -- per-sequence tracking state (shared by the single-sequence
    # got10k interface and track_batch) --------------------------------------
    def _make_state(self, img, box):
        """First-frame state + exemplar crop (reference :200-243).
        ``box`` is 1-indexed ltwh. Returns (state dict, z crop)."""
        cfg = self.cfg
        box = np.array([
            box[1] - 1 + (box[3] - 1) / 2,
            box[0] - 1 + (box[2] - 1) / 2,
            box[3], box[2]], np.float32)
        st = dict(center=box[:2].copy(), target_sz=box[2:].copy())
        context = cfg['context'] * np.sum(st['target_sz'])
        st['z_sz'] = np.sqrt(np.prod(st['target_sz'] + context))
        st['x_sz'] = st['z_sz'] * cfg['instance_sz'] / cfg['exemplar_sz']
        st['avg_color'] = np.mean(img, axis=(0, 1))
        z = ops.crop_and_resize(img, st['center'], st['z_sz'],
                                out_size=cfg['exemplar_sz'],
                                border_value=st['avg_color'])
        return st, z

    @functools.cached_property
    def _scale_factors(self):
        cfg = self.cfg
        return cfg['scale_step']**np.linspace(
            -(cfg['scale_num'] // 2), cfg['scale_num'] // 2,
            cfg['scale_num'])

    @functools.cached_property
    def _hann_window(self):
        upscale_sz = self.cfg['response_up'] * self.cfg['response_sz']
        win = np.outer(np.hanning(upscale_sz), np.hanning(upscale_sz))
        return win / win.sum()

    def _make_region(self, img, st):
        """Host side of the device-crop update: one integer-corner
        region slice + per-scale offsets (no cv2 work), and its taps."""
        region, offs, sizes = make_region(img, st['center'],
                                          st['x_sz'] * self._scale_factors,
                                          st['avg_color'])
        return region, make_taps(offs, sizes, self.cfg['instance_sz'])

    def _apply_peak(self, scale_id, loc, st):
        """State/box update from the device-computed (scale_id, peak):
        the tail of _apply_response after its argmax (reference
        siamfc_tracker_base.py:245-319)."""
        cfg = self.cfg
        upscale_sz = cfg['response_up'] * cfg['response_sz']
        disp_in_response = np.asarray(loc, np.float64) - \
            (upscale_sz - 1) / 2
        disp_in_instance = disp_in_response * \
            cfg['total_stride'] / cfg['response_up']
        disp_in_image = disp_in_instance * st['x_sz'] * \
            self._scale_factors[scale_id] / cfg['instance_sz']
        st['center'] += disp_in_image
        scale = (1 - cfg['scale_lr']) * 1.0 + \
            cfg['scale_lr'] * self._scale_factors[scale_id]
        st['target_sz'] *= scale
        st['z_sz'] *= scale
        st['x_sz'] *= scale
        return np.array([
            st['center'][1] + 1 - (st['target_sz'][1] - 1) / 2,
            st['center'][0] + 1 - (st['target_sz'][0] - 1) / 2,
            st['target_sz'][1], st['target_sz'][0]])

    def _scale_crops(self, img, st):
        """(S, instance_sz, instance_sz, 3) search crops for a state, in
        the image's dtype (uint8 from read_image)."""
        cfg = self.cfg
        return np.stack([
            ops.crop_and_resize(img, st['center'], st['x_sz'] * f,
                                out_size=cfg['instance_sz'],
                                border_value=st['avg_color'])
            for f in self._scale_factors])

    def _host_peak(self, responses):
        """Raw (S, h, w) responses -> (scale_id, loc) on the host: cv2
        bicubic x16 upsample, scale penalty, peak scale, min/sum
        normalize, hann blend, argmax (reference :245-319)."""
        cfg = self.cfg
        upscale_sz = cfg['response_up'] * cfg['response_sz']
        responses = np.stack([
            cv2.resize(u, (upscale_sz, upscale_sz),
                       interpolation=cv2.INTER_CUBIC) for u in responses])
        responses[:cfg['scale_num'] // 2] *= cfg['scale_penalty']
        responses[cfg['scale_num'] // 2 + 1:] *= cfg['scale_penalty']
        scale_id = np.argmax(np.amax(responses, axis=(1, 2)))
        response = responses[scale_id]
        response -= response.min()
        response /= response.sum() + 1e-16
        response = (1 - cfg['window_influence']) * response + \
            cfg['window_influence'] * self._hann_window
        loc = np.unravel_index(response.argmax(), response.shape)
        return scale_id, loc

    def _apply_response(self, responses, st):
        """Post-process raw (S, h, w) responses on the host -> updated
        state + ltwh box."""
        return self._apply_peak(*self._host_peak(responses), st)

    # -- got10k-compatible Tracker interface --------------------------------
    def init(self, img, box):
        """First-frame init (reference :200-243). box is 1-indexed ltwh."""
        self._state, z = self._make_state(img, box)
        self.kernel = self._backbone_fwd(z[None])

    def update(self, img):
        """Per-frame tracking step (reference :245-319)."""
        if self.cfg.get('device_crops', True):
            region, taps = self._make_region(img, self._state)
            sid, ly, lx = self._update_fwd_region(
                self.kernel, region[None], taps[None])[:, 0]
            return self._apply_peak(int(sid), (int(ly), int(lx)),
                                    self._state)
        responses = self._update_fwd(self.kernel,
                                     self._scale_crops(img, self._state))
        return self._apply_response(self._readback(responses[..., 0]),
                                    self._state)

    def track(self, img_files, box, visualize=False):
        frame_num = len(img_files)
        boxes = np.zeros((frame_num, 4))
        boxes[0] = box
        times = np.zeros(frame_num)
        for f, img_file in enumerate(img_files):
            img = ops.read_image(img_file)
            begin = time.time()
            if f == 0:
                self.init(img, box)
            else:
                boxes[f, :] = self.update(img)
            times[f] = time.time() - begin
        return boxes, times

    def track_batch(self, seqs, batch_size=8):
        """Track ``seqs`` = [(img_files, first_box), ...] with K sequences
        per device call — OTB runs independent sequences, so batching
        across them is free parallelism the reference's sequential
        got10k loop leaves on the table (reference
        siamfc_tracker_base.py:245-319 drives one sequence at a time).
        Per-sequence box math is ``track``'s: ``fast_xcorr``'s grouping
        pairs kernel k with its own crops. Sequences are chunked
        longest-first so chunk members have similar lengths; the last
        chunk may be smaller. With device crops each frame's regions are
        padded to the largest of the chunk's (the taps never leave a
        region's own [corner, corner+size), so the padding is never
        read).

        Returns [(boxes, times), ...] in the input order.
        """
        cfg = self.cfg
        s = cfg['scale_num']
        use_dev = cfg.get('device_crops', True)
        order = sorted(range(len(seqs)), key=lambda i: -len(seqs[i][0]))
        results = [None] * len(seqs)
        for c0 in range(0, len(order), batch_size):
            chunk = order[c0:c0 + batch_size]
            k = len(chunk)
            files = [seqs[i][0] for i in chunk]
            lengths = [len(f) for f in files]
            boxes = [np.zeros((n, 4)) for n in lengths]
            times = [np.zeros(n) for n in lengths]
            states, zs = [], []
            t0 = time.time()
            for j, i in enumerate(chunk):
                img = ops.read_image(files[j][0])
                st, z = self._make_state(img, seqs[i][1])
                states.append(st)
                zs.append(z)
                boxes[j][0] = seqs[i][1]
            kernels = self._backbone_fwd(np.stack(zs))
            init_dt = (time.time() - t0) / k
            for j in range(k):
                times[j][0] = init_dt
            xs = np.zeros((s, k, cfg['instance_sz'], cfg['instance_sz'],
                           3), np.uint8)
            regions = [np.zeros((64, 64, 3), np.uint8)] * k
            taps_arr = np.zeros((k, s, 8, cfg['instance_sz']), np.int32)
            for t in range(1, max(lengths)):
                begin = time.time()
                active = [j for j in range(k) if t < lengths[j]]
                if use_dev:
                    for j in active:
                        img = ops.read_image(files[j][t])
                        regions[j], taps_arr[j] = self._make_region(
                            img, states[j])
                    bucket = max(r.shape[0] for r in regions)
                    reg = np.zeros((k, bucket, bucket, 3), np.uint8)
                    for j in range(k):
                        r = regions[j]
                        reg[j, :r.shape[0], :r.shape[1]] = r
                    sid, ly, lx = self._update_fwd_region(kernels, reg,
                                                          taps_arr)
                    for j in active:
                        boxes[j][t] = self._apply_peak(
                            int(sid[j]), (int(ly[j]), int(lx[j])),
                            states[j])
                else:
                    for j in active:
                        img = ops.read_image(files[j][t])
                        xs[:, j] = self._scale_crops(img, states[j])
                    # scale-major flatten: row s*k+j pairs crop (s, j)
                    # with kernel j under fast_xcorr's grouping
                    resp = self._readback(self._update_fwd(
                        kernels, xs.reshape(s * k, *xs.shape[2:]))[..., 0])
                    resp = resp.reshape(s, k, *resp.shape[1:])
                    for j in active:
                        boxes[j][t] = self._apply_response(resp[:, j],
                                                           states[j])
                dt = (time.time() - begin) / max(len(active), 1)
                for j in active:
                    times[j][t] = dt
            for j, i in enumerate(chunk):
                results[i] = (boxes[j], times[j])
        return results

    # -- training ------------------------------------------------------------
    def _build_optimizer(self, iters_per_epoch: int):
        """The JAX package's optax chain over the head's parameters
        (``ChainedOptimizer`` computes it: SGD adds the decay before the
        momentum trace, Adam after its scaling), with its staircase
        schedules: ``exp`` decays once an epoch to ``ultimate_lr`` over
        ``epoch_num`` epochs, ``step`` by 0.1 every ``lr_step_size``
        epochs."""
        cfg = self.cfg
        wd = cfg['weight_decay'] if (
            cfg['model']['backbone'].get('frozen_stages', -1) < 4
            or cfg.get('force_wd', False)) else 0.0
        init_lr = cfg['initial_lr']
        if cfg['lr_schedule'] == 'exp':
            gamma = (cfg['ultimate_lr'] / init_lr)**(1.0 / cfg['epoch_num'])
            every = iters_per_epoch
        elif cfg['lr_schedule'] == 'step':
            gamma, every = 0.1, cfg['lr_step_size'] * iters_per_epoch
        else:
            gamma, every = 1.0, 1

        def sched(count):  # optax.exponential_decay(staircase=True)
            return init_lr * gamma**(count // every)
        kind = 'SGD' if cfg['optimizer'] == 'SGD' else 'Adam'
        opt = ChainedOptimizer(self.net.head.parameters(), kind, sched,
                               weight_decay=wd,
                               momentum=cfg['momentum'] if kind == 'SGD'
                               else 0.0)
        return opt, sched

    def _loss(self, z, x, labels):
        """The probe's loss on normalised (B, H, W, 3) tensors: backbone
        features without gradient (the JAX step differentiates the head's
        parameters only), then the head and the configured loss."""
        with torch.no_grad():
            zf, xf = self.net.features(z), self.net.features(x)
        responses = self.net.head(zf, xf)[..., 0]
        if self.cfg['loss'] == 'focal':
            return focal_loss(responses, labels)
        return balanced_loss(responses, labels)

    def _labels(self, batch_size, z, x):
        """Labels for the response size these crop shapes give."""
        cache = self.__dict__.setdefault('_label_cache', {})
        key = (tuple(z.shape[1:]), tuple(x.shape[1:]), batch_size, z.dtype)
        if key not in cache:
            with torch.no_grad():
                r = self.net(z[:1], x[:1])
            cfg = self.cfg
            labels = create_labels(r.shape[1:3], cfg['r_pos'], cfg['r_neg'],
                                   cfg['total_stride'])
            cache[key] = torch.as_tensor(
                np.tile(labels[None], (batch_size, 1, 1)),
                device=self.device).to(z.dtype)
        return cache[key]

    def probe_step(self, optimizer, z, x):
        """One probe update on a loader batch's (B, H, W, 3) float crops
        (numpy); returns the loss."""
        z = self._upload((z - IMG_MEAN) / IMG_STD).to(self.dtype)
        x = self._upload((x - IMG_MEAN) / IMG_STD).to(self.dtype)
        with exact_fp32():
            labels = self._labels(z.shape[0], z, x)
            optimizer.zero_grad()
            loss = self._loss(z, x, labels)
            loss.backward()
            optimizer.step()
        return loss.detach()

    def train_over(self, seqs, work_dir='./work_dirs/siamfc'):
        """Linear-probe training on sequence pairs (reference :388-467).
        Only the head's parameters train (the backbone is frozen whole at
        frozen_stages=4, the linear probe). Saves ``epoch_{n}`` under
        ``work_dir/checkpoints`` after every epoch."""
        cfg = self.cfg
        transforms = SiamFCTransforms(
            exemplar_sz=cfg['exemplar_sz'], instance_sz=cfg['instance_sz'],
            context=cfg['context'])
        dataset = Pair(seqs=seqs, transforms=transforms,
                       pairs_per_seq=cfg.get('pairs_per_seq', 1))
        loader = DataLoader(dataset, batch_size=cfg['batch_size'],
                            shuffle=True, num_workers=cfg['num_workers'],
                            drop_last=True)
        optimizer, _ = self._build_optimizer(len(loader))
        os.makedirs(work_dir, exist_ok=True)
        try:
            for epoch in range(cfg['epoch_num']):
                loader.set_epoch(epoch)
                for i, batch in enumerate(loader):
                    loss = self.probe_step(optimizer, batch['z'],
                                           batch['x'])
                    if (i + 1) % cfg.get('log_interval', 20) == 0:
                        self.logger.info(
                            f'Epoch {epoch + 1} [{i + 1}/{len(loader)}] '
                            f'loss: {float(loss):.4f}')
                save_checkpoint(osp.join(work_dir, 'checkpoints'),
                                epoch + 1, dict(
                                    model=self.net.state_dict(),
                                    optimizer=optimizer.state_dict(),
                                    step=optimizer.count, epoch=epoch + 1))
        finally:
            loader.close()
        return self.net
