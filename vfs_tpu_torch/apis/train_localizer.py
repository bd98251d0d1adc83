"""Training loop of the temporal-action localizers, BMN, TEM, PEM and SSN
(counterpart of ``vfs_tpu/apis/train_localizer.py``; reference: the
mmcv runner of mmaction/apis/train.py:12-119 with each localizer's
``forward_train``).

A batch's labels are made on the host first (BMN's and TEM's label maps
are data-dependent numpy work, reference bmn.py:430-470,
bsn.py:190-230); then one step on the device: forward, the localizer's
loss, backward and one update of the optax chain (``core.optimizer``), in
the exact fp32 mode (TF32 off). BMN's and PEM's losses sample their
medium and low IoU cells, and SSN's head drops features, with draws from
a generator on the device seeded from ``(seed, rank, step,
LOSS_STREAM)``; a test may hand the step the loss's uniform draws
instead (``draws``). Checkpoints each ``checkpoint_config.interval``
epochs under ``work_dir/checkpoints/epoch_{n}``, auto-resume from the
latest, and with ``validate`` a per-epoch loss over ``cfg.data.val`` in
eval mode (dropout off, BatchNorm running statistics; the loss's draws
from seed 0, so that epochs compare), logged as ``mode='val'``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn as nn

from ..core.optimizer import ChainedOptimizer, build_optimizer
from ..datasets import build_dataloader
from ..device import DeviceLike, exact_fp32, resolve_device
from ..ops.device_aug import step_seed
from ..parallel import (get_rank, get_world_size, reduce_log_vars,
                        wrap_distributed)
from ..utils import JsonlLogger, get_root_logger
from .train import (TrainState, auto_resume, build_train_loader,
                    grad_clip_of, log_train_entry, save_epoch_checkpoint)

LOCALIZER_TYPES = ('BMN', 'TEM', 'PEM', 'SSN')
# the step_seed stream of the loss's draws and the head's dropout ('loss')
LOSS_STREAM = 0x6c6f7373

Tensors = Dict[str, torch.Tensor]


def _features(batch, device) -> torch.Tensor:
    # the pipeline loads (C, T) a video; the model's seam is (N, T, C): a
    # view of the channels-first batch, which the model reads as it lies
    return torch.as_tensor(np.asarray(batch['raw_feature'], np.float32)
                           ).to(device).transpose(1, 2)


def _labelled(names):
    """The prepare of a localizer that labels its features on the host
    (BMN: confidence, start, end; TEM: action, start, end)."""
    def prepare(model, batch, device) -> Tensors:
        labels = model.generate_labels(batch['gt_bbox'])
        return dict(raw_feature=_features(batch, device),
                    **{k: torch.as_tensor(v).to(device)
                       for k, v in zip(names, labels)})
    return prepare


def _pem_prepare(model, batch, device) -> Tensors:
    return {k: torch.as_tensor(np.asarray(batch[k], np.float32)).to(device)
            for k in ('bsp_feature', 'reference_temporal_iou')}


def _ssn_prepare(model, batch, device) -> Tensors:
    return {k: torch.as_tensor(np.asarray(batch[k])).to(device) for k in
            ('imgs', 'proposal_scale_factor', 'proposal_type',
             'proposal_labels', 'reg_targets')}


def _bmn_losses(net, model, t, generator, draws):
    cm, start, end = net(t['raw_feature'])
    return model.loss(cm, start, end, t['label_confidence'],
                      t['label_start'], t['label_end'], generator=generator,
                      draws=draws)


def _tem_losses(net, model, t, generator, draws):
    return model.loss(net(t['raw_feature']), t['label_action'],
                      t['label_start'], t['label_end'])


def _pem_losses(net, model, t, generator, draws):
    # a batch's proposal banks are one pool, the reference's collated
    # (N*P, D) batch
    bsp = t['bsp_feature']
    out = net(bsp.reshape(-1, bsp.shape[-1]))
    return model.loss(out, t['reference_temporal_iou'].reshape(-1),
                      generator=generator, draws=draws)


def _ssn_losses(net, model, t, generator, draws):
    return net(t['imgs'], proposal_scale_factor=t['proposal_scale_factor'],
               proposal_type=t['proposal_type'],
               proposal_labels=t['proposal_labels'],
               reg_targets=t['reg_targets'], generator=generator)


_KINDS = {
    'BMN': (_labelled(('label_confidence', 'label_start', 'label_end')),
            _bmn_losses),
    'TEM': (_labelled(('label_action', 'label_start', 'label_end')),
            _tem_losses),
    'PEM': (_pem_prepare, _pem_losses),
    'SSN': (_ssn_prepare, _ssn_losses),
}


def prepare_batch(model: nn.Module, batch, device) -> Tensors:
    """A loader batch -> the localizer's step tensors on ``device`` (host
    labels for BMN and TEM)."""
    model = getattr(model, 'module', model)
    return _KINDS[type(model).__name__][0](model, batch, device)


def sum_losses(losses: Tensors):
    """(total, log vars) as the JAX loop sums them: ``loss`` when the
    dict has it (BMN's is the weighted sum of its parts), else the sum of
    the entries named ``*loss*``, added as ``loss``."""
    if 'loss' not in losses:
        losses = dict(losses, loss=sum(v for k, v in losses.items()
                                       if 'loss' in k))
    log_vars = {k: torch.mean(v) for k, v in losses.items()}
    return log_vars['loss'], log_vars


def make_localizer_train_step(model: nn.Module, optimizer: ChainedOptimizer,
                              seed: int = 0
                              ) -> Callable[..., Tensors]:
    """``step(tensors, draws=None)``: forward, loss, backward and one
    update on ``prepare_batch``'s tensors; returns this process's log vars
    (tensors on the device). ``model`` may be the
    ``DistributedDataParallel`` wrapper. ``draws``, BMN's or PEM's two
    uniform tensors, replaces the generator's."""
    core = getattr(model, 'module', model)
    losses_of = _KINDS[type(core).__name__][1]
    device = next(core.parameters()).device
    rank = get_rank()

    def train_step(tensors: Tensors, draws=None) -> Tensors:
        generator = torch.Generator(device=device)
        generator.manual_seed(step_seed(seed, rank, optimizer.count,
                                        LOSS_STREAM))
        with exact_fp32():
            total, log_vars = sum_losses(losses_of(model, core, tensors,
                                                   generator, draws))
            optimizer.zero_grad()
            total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in log_vars.items()}

    return train_step


def make_localizer_eval_step(model: nn.Module) -> Callable[..., Tensors]:
    """``step(tensors, draws=None)``: the loss in eval mode (dropout off,
    BatchNorm running statistics), without a gradient; the loss's draws
    from a generator seeded 0 every call."""
    core = getattr(model, 'module', model)
    losses_of = _KINDS[type(core).__name__][1]
    device = next(core.parameters()).device

    @torch.no_grad()
    def eval_step(tensors: Tensors, draws=None) -> Tensors:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
        was_training = core.training
        core.eval()
        try:
            with exact_fp32():
                _, log_vars = sum_losses(losses_of(core, core, tensors,
                                                   generator, draws))
        finally:
            core.train(was_training)
        return log_vars

    return eval_step


def _validate(model, val_loader, device, epoch, logger, jsonl):
    eval_step = make_localizer_eval_step(model)
    sums: Dict[str, float] = {}
    n_samples = 0
    for batch in val_loader:
        bn = len(next(iter(batch.values())))
        log_vars = eval_step(prepare_batch(model, batch, device))
        # per-batch means weighted by batch size: a ragged last batch
        # does not outweigh its samples
        for k, v in reduce_log_vars(log_vars).items():
            sums[k] = sums.get(k, 0.0) + v * bn
        n_samples += bn
    if not n_samples:
        logger.warning('validation loader produced no batches')
        return None
    means = {k: v / n_samples for k, v in sums.items()}
    logger.info(f'Epoch [{epoch}] val ({n_samples} samples): ' + ', '.join(
        f'{k}: {v:.4f}' for k, v in means.items()))
    if get_rank() == 0:
        jsonl.log(dict(mode='val', epoch=epoch, **means))
    return means


def train_localizer_model(model: nn.Module, dataset, cfg,
                          validate: bool = False, logger=None,
                          device: DeviceLike = None) -> TrainState:
    """Train a localizer per ``cfg`` on ``device`` (CUDA unless the caller
    says otherwise), the localization analogue of
    ``apis.train.train_model``. Returns the final ``TrainState``."""
    kind = cfg.model['type']
    if kind not in _KINDS:
        raise KeyError(f'not a localizer: {kind}')
    logger = logger or get_root_logger()
    device = resolve_device(device)
    work_dir = cfg.get('work_dir', './work_dirs/default')
    os.makedirs(work_dir, exist_ok=True)
    rank = get_rank()
    jsonl = JsonlLogger(os.path.join(work_dir, 'train_log.jsonl'))
    seed = cfg.get('seed', 0) or 0

    loader = build_train_loader(dataset, cfg, seed)
    total_epochs = cfg.total_epochs
    iters_per_epoch = max(len(loader), 1)
    model.init_weights(torch.Generator().manual_seed(seed))
    model.to(device)
    optimizer, schedule = build_optimizer(
        model.parameters(), dict(cfg.optimizer), cfg.get('lr_config'),
        total_epochs * iters_per_epoch, iters_per_epoch, grad_clip_of(cfg))
    start_epoch = auto_resume(model, optimizer, work_dir, cfg, device,
                              logger)

    net = wrap_distributed(model, device)
    train_step = make_localizer_train_step(net, optimizer, seed)
    log_interval = (cfg.get('log_config') or {}).get('interval', 50)

    val_loader = None
    eval_interval = 1
    if validate:
        val_cfg = (cfg.get('data') or {}).get('val')
        if not val_cfg:
            logger.warning('--validate requested but cfg.data.val is '
                           'missing; skipping validation')
        else:
            from ..datasets import build_dataset
            val_loader = build_dataloader(
                build_dataset(val_cfg),
                videos_per_gpu=cfg.data['videos_per_gpu'],
                workers_per_gpu=cfg.data['workers_per_gpu'], shuffle=False,
                drop_last=False, num_shards=get_world_size(),
                shard_index=rank)
            eval_interval = (cfg.get('evaluation') or {}).get('interval', 1)

    try:
        for epoch in range(start_epoch, total_epochs):
            loader.set_epoch(epoch)
            model.train()
            t_iter = time.time()
            for i, batch in enumerate(loader):
                log_vars = train_step(prepare_batch(model, batch, device))
                if (i + 1) % log_interval == 0 or i + 1 == iters_per_epoch:
                    log_vars = reduce_log_vars(log_vars)
                    lr = schedule(optimizer.count - 1)
                    dt = (time.time() - t_iter) / (i + 1)
                    log_train_entry(logger, jsonl, epoch + 1, i + 1,
                                    iters_per_epoch, lr, dt, log_vars)
            save_epoch_checkpoint(model, optimizer, work_dir, epoch + 1, cfg,
                                  logger)
            if val_loader is not None and (epoch + 1) % eval_interval == 0:
                _validate(net, val_loader, device, epoch + 1, logger, jsonl)
    finally:
        loader.close()
        if val_loader is not None:
            val_loader.close()
    return TrainState(model, optimizer, optimizer.count)
