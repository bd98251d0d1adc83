"""Training loop (counterpart of ``vfs_tpu/apis/train.py``; reference:
mmaction/apis/train.py:12-119 and the mmcv EpochBasedRunner it delegates
to, here one loop).

One process trains on one device, CUDA unless the caller passes
``device='cpu'``; a process group of several (``parallel.init_dist``)
trains data-parallel under the JAX package's contract (each process its
shard, the local mean loss, averaged gradients, global BatchNorm
statistics). A step is forward, backward and one update of the optax
chain (``core.optimizer``). Without ``fp16`` / ``bf16`` in the config it
runs in the exact fp32 mode (TF32 off); with either, the backbone runs
under bf16 autocast (``apply_mixed_precision``) while the master weights,
the heads, the loss and the BatchNorm statistics stay fp32. Checkpoints
each ``checkpoint_config.interval`` epochs under
``work_dir/checkpoints/epoch_{n}``, auto-resume from the latest, and the
propagation eval of ``data.val`` after each ``evaluation.interval``
epochs (``EvalHook``, ``best.json``).

A recognizer (``model_takes_labels``) trains on the batch's ``label``,
its heads' dropout drawing from a generator on the device seeded from
``(seed, rank, step)`` (a stream of its own beside the augmentation's);
``optimizer.constructor='TSMOptimizerConstructor'`` in the config, as
MMAction2's TSM configs give it, takes the TSM parameter groups
(``core.optimizer.build_tsm_optimizer``, ``paramwise_cfg.fc_lr5``).

``cfg.device_aug`` runs the augmentation chain in the step on the batch's
device (``ops.device_aug``; the loader ships uint8 staging frames and
``orig_hw``). ``cfg.profile_steps`` (``--profile N``) traces steps
[2, 2+N) with ``torch.profiler`` into ``work_dir/profile``, the
program's spans (``utils.trace``) beside the operators. Each log entry
carries ``time`` (seconds an iteration) and ``data_time`` (of those, the
wait for the loader, span ``train.wait_batch``). A
``WandbLoggerHook`` in ``log_config.hooks`` mirrors the JSONL log to wandb
(``utils.wandb_logger``).

The validation eval runs over the processes of the group
(``multi_process_test``) or, in one process, over ``local_devices``
(``single_process_test(devices=...)``); rank 0 writes its log entry and
``best.json``.
"""

from __future__ import annotations

import contextlib
import inspect
import os
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn

from ..checkpoint import (latest_checkpoint, load_backbone_state,
                          load_torchvision_resnet, restore_checkpoint,
                          save_checkpoint)
from ..core.optimizer import (ChainedOptimizer, build_lr_schedule,
                              build_optimizer, build_tsm_optimizer)
from ..datasets import build_dataloader
from ..device import DeviceLike, exact_fp32, resolve_device, to_channels_last
from ..models.trackers.sim_siam_tracker import parse_losses
from ..ops.device_aug import DeviceAugChain, build_device_aug, step_seed
from ..parallel import (get_rank, get_world_size, reduce_log_vars,
                        wrap_distributed)
from ..utils import JsonlLogger, build_wandb_logger, get_root_logger, trace


# the step_seed stream of the heads' dropout ('drop')
DROPOUT_STREAM = 0x64726f70


class TrainState(NamedTuple):
    model: nn.Module
    optimizer: ChainedOptimizer
    step: int


def build_train_loader(dataset, cfg, seed: int):
    """The train loader of ``cfg.data``: shuffled from ``seed``, full
    batches only, this process's shard."""
    return build_dataloader(
        dataset, videos_per_gpu=cfg.data['videos_per_gpu'],
        workers_per_gpu=cfg.data['workers_per_gpu'], shuffle=True,
        drop_last=True, seed=seed, num_shards=get_world_size(),
        shard_index=get_rank())


def grad_clip_of(cfg) -> Optional[float]:
    """``optimizer_config.grad_clip``'s max norm (a dict's ``max_norm``
    or the number itself); None when it is unset."""
    gc = (cfg.get('optimizer_config') or {}).get('grad_clip')
    if not gc:
        return None
    return gc.get('max_norm') if isinstance(gc, dict) else gc


def auto_resume(model: nn.Module, optimizer: ChainedOptimizer,
                work_dir: str, cfg, device, logger) -> int:
    """Restore ``model`` and ``optimizer`` from the latest checkpoint
    under ``work_dir/checkpoints`` unless ``cfg.auto_resume`` is false
    (reference tools/train.py:103-105). Returns the epoch to start from,
    0 without a checkpoint."""
    latest = latest_checkpoint(os.path.join(work_dir, 'checkpoints'))
    if not latest or not cfg.get('auto_resume', True):
        return 0
    ckpt = restore_checkpoint(latest, map_location=device)
    model.load_state_dict(ckpt['model'])
    optimizer.load_state_dict(ckpt['optimizer'])
    start_epoch = int(os.path.basename(latest).split('_')[1])
    logger.info(f'auto-resumed from {latest} (epoch {start_epoch})')
    return start_epoch


def save_epoch_checkpoint(model: nn.Module, optimizer: ChainedOptimizer,
                          work_dir: str, epoch: int, cfg, logger) -> None:
    """On rank 0, ``work_dir/checkpoints/epoch_{epoch}`` after every
    ``checkpoint_config.interval``-th epoch and after the last."""
    interval = (cfg.get('checkpoint_config') or {}).get('interval', 1)
    if get_rank() != 0 or (epoch % interval and epoch != cfg.total_epochs):
        return
    path = save_checkpoint(
        os.path.join(work_dir, 'checkpoints'), epoch, dict(
            model=model.state_dict(), optimizer=optimizer.state_dict(),
            step=optimizer.count, epoch=epoch))
    logger.info(f'checkpoint saved to {path}')


def log_train_entry(logger, jsonl: JsonlLogger, epoch: int, it: int,
                    iters_per_epoch: int, lr: float, dt: float,
                    log_vars: Dict[str, float],
                    data_time: Optional[float] = None) -> Dict:
    """One train log entry: the logger's line on every rank, the JSONL
    line on rank 0. ``dt``: seconds an iteration over the interval;
    ``data_time``: of those, the mean wait for the loader (MMAction2's
    ``IterTimerHook`` field), left out if None. Returns the entry."""
    timing = dict(time=dt)
    if data_time is not None:
        timing['data_time'] = data_time
    logger.info(f'Epoch [{epoch}][{it}/{iters_per_epoch}] '
                f'lr: {lr:.5f}, ' + ', '.join(
                    f'{k}: {v:.3f}' for k, v in timing.items()) + ', '
                + ', '.join(f'{k}: {v:.4f}' for k, v in log_vars.items()))
    entry = dict(mode='train', epoch=epoch, iter=it, lr=lr, **timing,
                 **log_vars)
    if get_rank() == 0:
        jsonl.log(entry)
    return entry


def model_takes_labels(model: nn.Module) -> bool:
    """Recognizers take (imgs, labels); the self-supervised trackers take
    the frames alone. Looks through a ``DistributedDataParallel``."""
    model = getattr(model, 'module', model)
    return 'labels' in inspect.signature(type(model).forward).parameters


def apply_mixed_precision(cfg) -> bool:
    """With the reference's ``fp16 = dict(...)`` key (or ``bf16 = True``)
    in the config, give the backbone ``dtype='bfloat16'`` (bf16 autocast
    in its forward; parameters and BatchNorm statistics stay fp32).
    ``loss_scale`` keys are accepted and ignored: bf16 needs no loss
    scaling. A backbone without a ``dtype`` argument stays fp32, with a
    warning, as in the JAX package. Returns True if mixed precision was
    enabled. Call before ``build_model``."""
    mixed = bool(cfg.get('fp16') is not None or cfg.get('bf16'))
    if mixed and isinstance(cfg.get('model'), dict) \
            and isinstance(cfg.model.get('backbone'), dict):
        from ..models import BACKBONES
        backbone = cfg.model.backbone
        klass = BACKBONES.get(backbone.get('type'))
        if klass is not None and \
                'dtype' in inspect.signature(klass).parameters:
            backbone.setdefault('dtype', 'bfloat16')
        else:
            get_root_logger().warning(
                f'fp16/bf16 requested but backbone {backbone.get("type")!r} '
                'takes no dtype; its compute stays fp32')
    return mixed


def make_train_step(model: nn.Module, optimizer: ChainedOptimizer,
                    norm_cfg: Optional[Dict] = None,
                    device_aug: Optional[DeviceAugChain] = None,
                    seed: int = 0) -> Callable[..., Dict[str, torch.Tensor]]:
    """The train step: ``step(imgs, orig_hw=None, labels=None)`` moves a
    batch to the model's device ((B, 2, T, H, W, C) for a tracker, a
    recognizer's clips and their labels), runs forward and backward
    (``model`` may be the ``DistributedDataParallel`` wrapper) and one
    optimizer update, and returns this process's log vars (tensors on the
    device; reading them waits for the step). A recognizer's dropout draws
    from a generator on the device seeded from ``(seed, rank, step,
    DROPOUT_STREAM)``.

    ``norm_cfg`` (``mean`` / ``std``) takes the uint8 input path: a train
    pipeline with ``Normalize(on_device=True)`` ships uint8 frames and
    the step computes ``(x - mean) / std`` on the device, in fp32, with
    the pipeline's own constants (``_pipeline_norm_cfg``).

    ``device_aug`` runs the augmentation chain on the uint8 staging
    frames and their (B, 2) ``orig_hw`` before the forward, in fp32,
    drawing from a generator on the device seeded from ``(seed, rank,
    step)``, ``step`` being the optimizer's update count.

    Spans (``utils.trace``), keyed by the optimizer's update count:
    ``train.step`` around the whole step, and inside it ``train.h2d``
    (the batch's copies to the device), ``train.device_aug``,
    ``train.forward`` (with ``parse_losses``), ``train.backward`` (with
    ``zero_grad``) and ``train.optimizer``."""
    device = next(model.parameters()).device
    rank = get_rank()
    mean = std = None
    if norm_cfg is not None:
        mean = torch.as_tensor(np.asarray(norm_cfg['mean'], np.float32),
                               device=device)
        std = torch.as_tensor(np.asarray(norm_cfg['std'], np.float32),
                              device=device)

    takes_labels = model_takes_labels(model)

    def train_step(imgs, orig_hw=None,
                   labels=None) -> Dict[str, torch.Tensor]:
        with trace.span('train.step', optimizer.count):
            return _step(imgs, orig_hw, labels)

    def _step(imgs, orig_hw, labels) -> Dict[str, torch.Tensor]:
        with trace.span('train.h2d'):
            x = torch.as_tensor(imgs).to(device)
            if device_aug is not None:
                orig_hw = torch.as_tensor(orig_hw).to(device)
            if takes_labels:
                labels = torch.as_tensor(labels).to(device)
        if device_aug is not None:
            with trace.span('train.device_aug'):
                generator = torch.Generator(device=device)
                generator.manual_seed(step_seed(seed, rank, optimizer.count))
                x = device_aug(x, orig_hw, generator)
        elif x.dtype == torch.uint8:
            if mean is None:
                raise ValueError(
                    'uint8 train batch needs img_norm_cfg (pipeline used '
                    'Normalize(on_device=True) but the config has no '
                    'img_norm_cfg)')
            x = (x.to(torch.float32) - mean) / std
        args, kwargs = (x,), {}
        if takes_labels:
            args += (labels,)
            generator = torch.Generator(device=device)
            generator.manual_seed(step_seed(seed, rank, optimizer.count,
                                            DROPOUT_STREAM))
            kwargs['generator'] = generator
        with exact_fp32():
            with trace.span('train.forward'):
                total, log_vars = parse_losses(model(*args, **kwargs))
            with trace.span('train.backward'):
                optimizer.zero_grad()
                total.backward()
        with trace.span('train.optimizer'):
            optimizer.step()
        return {k: v.detach() for k, v in log_vars.items()}

    return train_step


def _load_backbone_pretrained(model: nn.Module, cfg, logger) -> None:
    """Honour ``cfg.model.backbone.pretrained`` (a torchvision-layout
    ``.pth``) for the train path, after the random init. A checkpoint
    that does not fit the backbone raises."""
    backbone = (cfg.get('model') or {}).get('backbone') \
        if isinstance(cfg.get('model'), dict) else None
    pre = (backbone or {}).get('pretrained')
    if not pre:
        return
    if backbone.get('type') != 'ResNet':
        raise ValueError(
            f'backbone.pretrained={pre!r} is only supported for the 2D '
            f"ResNet backbone; got type={backbone.get('type')!r}")
    load_backbone_state(model.backbone, load_torchvision_resnet(pre))
    logger.info(f'initialized backbone from pretrained {pre}')


def _pipeline_norm_cfg(dataset) -> Optional[Dict]:
    """The mean/std that the train pipeline's ``Normalize`` applies (the
    uint8 on-device path must use these, not ``cfg.img_norm_cfg``).
    Unwraps ``RepeatDataset`` and the like through ``.dataset``."""
    from ..datasets.pipelines.augmentations import Normalize
    ds = dataset
    while not hasattr(ds, 'pipeline') and hasattr(ds, 'dataset'):
        ds = ds.dataset
    for t in getattr(getattr(ds, 'pipeline', None), 'transforms', []):
        if isinstance(t, Normalize):
            return dict(mean=t.mean, std=t.std)
    return None


def train_model(model: nn.Module, dataset, cfg, validate: bool = False,
                logger=None, local_devices=None,
                device: DeviceLike = None) -> TrainState:
    """Train ``model`` (a tracker whose forward returns a loss dict) on
    ``dataset`` per ``cfg`` on ``device`` (CUDA unless the caller says
    otherwise). ``local_devices``: devices to round-robin the validation
    eval's videos over in a run of one process. Returns the final
    ``TrainState``."""
    logger = logger or get_root_logger()
    device = resolve_device(device)
    work_dir = cfg.get('work_dir', './work_dirs/default')
    os.makedirs(work_dir, exist_ok=True)
    rank = get_rank()
    jsonl = JsonlLogger(os.path.join(work_dir, 'train_log.jsonl'))
    wandb_log = build_wandb_logger(cfg.get('log_config')) if rank == 0 \
        else None
    seed = cfg.get('seed', 0) or 0

    loader = build_train_loader(dataset, cfg, seed)
    total_epochs = cfg.total_epochs
    iters_per_epoch = len(loader)
    total_iters = total_epochs * iters_per_epoch
    grad_clip = grad_clip_of(cfg)

    model.init_weights(torch.Generator().manual_seed(seed))
    _load_backbone_pretrained(model, cfg, logger)
    model.to(device)
    if device.type == 'cuda':
        to_channels_last(model.backbone)
    opt_cfg = dict(cfg.optimizer)
    if opt_cfg.get('constructor') == 'TSMOptimizerConstructor':
        schedule = build_lr_schedule(cfg.get('lr_config'), opt_cfg['lr'],
                                     total_iters, iters_per_epoch)
        optimizer = build_tsm_optimizer(
            model, schedule, opt_cfg.get('momentum', 0.9),
            opt_cfg.get('weight_decay', 1e-4),
            (opt_cfg.get('paramwise_cfg') or {}).get('fc_lr5', True),
            grad_clip)
    else:
        optimizer, schedule = build_optimizer(
            model.parameters(), opt_cfg, cfg.get('lr_config'), total_iters,
            iters_per_epoch, grad_clip)

    start_epoch = auto_resume(model, optimizer, work_dir, cfg, device,
                              logger)

    if cfg.get('fp16') is not None or cfg.get('bf16'):
        logger.info('mixed precision enabled: bf16 backbone, fp32 master '
                    'weights, heads and BatchNorm statistics')
    norm_cfg = _pipeline_norm_cfg(dataset) or cfg.get('img_norm_cfg')
    device_aug = None
    if cfg.get('device_aug'):
        da = dict(cfg.device_aug)
        device_aug = build_device_aug(
            da['transforms'], da.get('img_norm_cfg') or norm_cfg,
            out_hw=tuple(da.get('out_hw', (224, 224))))
        logger.info('on-device augmentation enabled ('
                    f'{len(da["transforms"])} transforms -> '
                    f'{device_aug.out_hw})')
    train_step = make_train_step(wrap_distributed(model, device), optimizer,
                                 norm_cfg, device_aug, seed)

    log_interval = (cfg.get('log_config') or {}).get('interval', 50)
    takes_labels = model_takes_labels(model)
    eval_hook = None
    if validate and cfg.get('data') and cfg.data.get('val'):
        if takes_labels:
            raise NotImplementedError(
                '--validate runs the propagation eval of a tracker; a '
                "recognizer's validation is not ported (nor is it in the "
                'JAX package)')
        from ..core.evaluation.eval_hooks import EvalHook
        eval_cfg = dict(cfg.get('evaluation') or {})
        eval_hook = EvalHook(
            build_val_eval_fn(cfg, lambda: model, device=device,
                              local_devices=local_devices),
            interval=eval_cfg.get('interval', 1),
            key_indicator=eval_cfg.get('key_indicator'),
            rule=eval_cfg.get('rule'), work_dir=work_dir,
            save_best=rank == 0)
    # --profile N: a torch.profiler trace of the steps [2, 2+N), with the
    # program's spans recorded into it
    profile_steps = max(0, int(cfg.get('profile_steps', 0) or 0))
    profiler = None
    steps_run = 0
    spans = contextlib.ExitStack()

    try:
        for epoch in range(start_epoch, total_epochs):
            loader.set_epoch(epoch)
            model.train()
            t_iter = time.time()
            waited = [0.0]
            for i, batch in enumerate(_waits(loader, optimizer, waited)):
                if profile_steps and steps_run == 2:
                    profiler = _start_profiler(device)
                    spans.enter_context(trace.recording(annotate=True))
                log_vars = train_step(
                    batch['imgs'], batch.get('orig_hw'),
                    batch.get('label') if takes_labels else None)
                steps_run += 1
                if profiler is not None \
                        and steps_run >= 2 + profile_steps:
                    spans.close()
                    _stop_profiler(profiler, work_dir, device, logger)
                    profiler = None
                if (i + 1) % log_interval == 0:
                    log_vars = reduce_log_vars(log_vars)
                    lr = schedule(optimizer.count - 1)
                    dt = (time.time() - t_iter) / log_interval
                    t_iter = time.time()
                    entry = log_train_entry(logger, jsonl, epoch + 1, i + 1,
                                            iters_per_epoch, lr, dt,
                                            log_vars,
                                            waited[0] / log_interval)
                    waited[0] = 0.0
                    if wandb_log is not None:
                        wandb_log.log(entry, step=optimizer.count)
            save_epoch_checkpoint(model, optimizer, work_dir, epoch + 1, cfg,
                                  logger)
            if eval_hook is not None:
                results = eval_hook.after_epoch(epoch)
                if results and rank == 0:
                    entry = dict(mode='val', epoch=epoch + 1, **{
                        k: float(v) for k, v in results.items()
                        if isinstance(v, (int, float))})
                    jsonl.log(entry)
                    if wandb_log is not None:
                        wandb_log.log(entry, step=optimizer.count)
        if profiler is not None:  # fewer steps than asked for
            spans.close()
            _stop_profiler(profiler, work_dir, device, logger)
            profiler = None
    finally:
        loader.close()
        spans.close()
        if profiler is not None:  # a step raised inside the trace
            profiler.stop()
    if wandb_log is not None:
        wandb_log.finish()
    return TrainState(model, optimizer, optimizer.count)


def _waits(loader, optimizer: ChainedOptimizer, waited: list):
    """The batches of ``loader``; each wait for one (``next``) runs in the
    span ``train.wait_batch``, keyed by the update it feeds, and its
    seconds are added to ``waited[0]``."""
    batches = iter(loader)
    while True:
        t0 = time.time()
        with trace.span('train.wait_batch', optimizer.count):
            batch = next(batches, None)
        waited[0] += time.time() - t0
        if batch is None:
            return
        yield batch


def _start_profiler(device: torch.device):
    """A started ``torch.profiler`` of the host and, on a CUDA device, the
    card's kernels. A profiler that cannot start raises."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, work_dir: str, device: torch.device,
                   logger) -> str:
    """Wait for the traced steps, stop and write the Chrome trace to
    ``work_dir/profile/trace_rank{rank}.json``; returns its path."""
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    profiler.stop()
    out = os.path.join(work_dir, 'profile')
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f'trace_rank{get_rank()}.json')
    profiler.export_chrome_trace(path)
    logger.info(f'profiler trace written to {path}')
    return path


def build_val_eval_fn(cfg, model_getter: Callable[[], nn.Module],
                      device: DeviceLike = None, local_devices=None):
    """An eval_fn running the propagation eval of ``cfg.data.val`` with the
    current training backbone: its state dict goes into a
    ``VanillaTracker`` built with ``test_cfg`` (test strides and
    out_indices; the weights do not depend on them). A hand-off whose
    ``backbone.*`` keys do not match raises, because a silent miss would
    evaluate untrained weights. In a process group the videos are shared
    among the processes and the predictions gathered on every rank
    (``multi_process_test``); in one process, ``local_devices`` (a list
    of devices) round-robins them over those devices
    (``single_process_test(devices=...)``), as the JAX package's
    ``build_val_eval_fn`` does."""
    from ..datasets import build_dataset
    from ..models import build_model
    from .test import multi_process_test, single_process_test

    dataset = build_dataset(cfg.data.val, dict(test_mode=True))
    tracker = build_model(
        dict(type='VanillaTracker', backbone=dict(cfg.model.backbone)),
        test_cfg=cfg.test_cfg)

    def eval_fn():
        prefix = 'backbone.'
        state = {k[len(prefix):]: v
                 for k, v in model_getter().state_dict().items()
                 if k.startswith(prefix)}
        want = set(tracker.backbone.state_dict())
        if set(state) != want:
            raise KeyError(
                'validation weight hand-off: the train model\'s backbone.* '
                f'keys do not match the eval backbone (missing '
                f'{sorted(want - set(state))[:4]}, unexpected '
                f'{sorted(set(state) - want)[:4]}); did the tracker rename '
                'its backbone?')
        tracker.backbone.load_state_dict(state)
        if get_world_size() > 1:
            results = multi_process_test(tracker, dataset, device=device)
        else:
            results = single_process_test(tracker, dataset,
                                          devices=local_devices,
                                          device=device)
        metrics = cfg.evaluation.get('metrics', 'davis') \
            if cfg.get('evaluation') else 'davis'
        return dataset.evaluate(results, metrics=metrics)

    return eval_fn
