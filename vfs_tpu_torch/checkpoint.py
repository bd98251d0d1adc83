"""Checkpoint bridges (counterpart of ``vfs_tpu/checkpoint.py``).

- ``vfs_train_ckpt_to_torchvision``: VFS training checkpoint
  (``backbone.conv1.conv.weight`` ConvModule naming) -> torchvision keys.
- ``load_torchvision_resnet``: a released torchvision-layout ``.pth`` as a
  state dict for the port's ``ResNet`` (same key names).
- ``flax_resnet_to_torch``: the JAX package's ResNet ``(params,
  batch_stats)`` trees, as nested dicts of numpy arrays, -> a state dict
  for the port's ``ResNet``. Conv kernels go HWIO -> OIHW.
- ``flax_head_to_torch`` / ``flax_simsiam_to_torch``: the same for a
  SimSiam head and a whole ``SimSiamBaseTracker`` (``_backbone`` and
  ``_img_head``); ``Dense`` kernels go (in, out) -> ``Linear`` (out, in).
- ``flax_recognizer_to_torch``: the JAX package's recognizer trees (any
  of its recognition backbones and heads) -> a state dict of the port's
  recognizer, by name.
- ``save_checkpoint`` / ``latest_checkpoint`` / ``restore_checkpoint``:
  train checkpoints (``torch.save`` of the model, the optimizer, the
  schedule step and the epoch) under ``epoch_{n}``, with a ``latest``
  marker that auto-resume reads.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def vfs_train_ckpt_to_torchvision(
        state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Strip ``backbone.`` ConvModule naming into torchvision keys."""
    out = {}
    for key, value in state_dict.items():
        if not key.startswith('backbone.'):
            continue
        name = key[len('backbone.'):]
        # conv1.conv.weight -> conv1.weight ; conv1.bn.* -> bn1.*
        if name.startswith('conv1.conv.'):
            out['conv1.' + name[len('conv1.conv.'):]] = value
        elif name.startswith('conv1.bn.'):
            out['bn1.' + name[len('conv1.bn.'):]] = value
        else:
            # layerX.Y.convN.conv.* -> layerX.Y.convN.*
            # layerX.Y.convN.bn.*   -> layerX.Y.bnN.*
            # layerX.Y.downsample.conv.* -> layerX.Y.downsample.0.*
            # layerX.Y.downsample.bn.*   -> layerX.Y.downsample.1.*
            m = re.match(r'(layer\d+\.\d+)\.(conv\d|downsample)\.'
                         r'(conv|bn)\.(.+)', name)
            if m is None:
                continue
            prefix, mod, sub, rest = m.groups()
            if mod == 'downsample':
                idx = '0' if sub == 'conv' else '1'
                out[f'{prefix}.downsample.{idx}.{rest}'] = value
            else:
                if sub == 'conv':
                    out[f'{prefix}.{mod}.{rest}'] = value
                else:
                    out[f'{prefix}.bn{mod[len("conv"):]}.{rest}'] = value
    return out


def load_torchvision_resnet(path: str) -> Dict[str, torch.Tensor]:
    """Load a released/torchvision-layout ``.pth`` (or a VFS training
    checkpoint) as a state dict for ``vfs_tpu_torch``'s ``ResNet``."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(ckpt, dict) and 'state_dict' in ckpt:
        ckpt = ckpt['state_dict']
    sd = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
          for k, v in ckpt.items()}
    if any(k.startswith('backbone.') for k in sd):
        sd = vfs_train_ckpt_to_torchvision(sd)
    return sd


def flax_resnet_to_torch(params: Mapping, batch_stats: Mapping
                         ) -> Dict[str, torch.Tensor]:
    """JAX-package ResNet trees (``conv1``, ``layer{i}_{j}`` with
    ``conv{n}`` / ``downsample`` ConvBN children) -> torchvision-named
    state dict."""
    sd: Dict[str, torch.Tensor] = {}

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def convbn(p, s, conv_name, bn_name):
        kernel = np.asarray(p['conv']['kernel'], dtype=np.float32)
        sd[f'{conv_name}.weight'] = t(np.transpose(kernel, (3, 2, 0, 1)))
        sd[f'{bn_name}.weight'] = t(p['bn']['scale'])
        sd[f'{bn_name}.bias'] = t(p['bn']['bias'])
        sd[f'{bn_name}.running_mean'] = t(s['bn']['mean'])
        sd[f'{bn_name}.running_var'] = t(s['bn']['var'])

    convbn(params['conv1'], batch_stats['conv1'], 'conv1', 'bn1')
    for name in params:
        m = re.fullmatch(r'layer(\d+)_(\d+)', name)
        if m is None:
            continue
        base = f'layer{m.group(1)}.{m.group(2)}'
        for child in params[name]:
            p, s = params[name][child], batch_stats[name][child]
            if child == 'downsample':
                convbn(p, s, f'{base}.downsample.0', f'{base}.downsample.1')
            else:
                n = re.fullmatch(r'conv(\d)', child).group(1)
                convbn(p, s, f'{base}.conv{n}', f'{base}.bn{n}')
    return sd


def flax_head_to_torch(params: Mapping, batch_stats: Mapping
                       ) -> Dict[str, torch.Tensor]:
    """A JAX-package head's trees -> a state dict of the port's head, leaf
    by leaf: ``kernel`` -> ``weight`` in torch's layout (``Dense`` (in,
    out) -> (out, in); ``Conv`` HWIO -> OIHW), ``scale`` -> ``weight``,
    ``mean`` / ``var`` -> ``running_mean`` / ``running_var``."""
    sd: Dict[str, torch.Tensor] = {}
    leaf_names = dict(bias='bias', scale='weight', mean='running_mean',
                      var='running_var')

    def walk(tree, prefix):
        for name, node in tree.items():
            if hasattr(node, 'items'):
                walk(node, f'{prefix}{name}.')
                continue
            a = np.asarray(node, dtype=np.float32)
            if name == 'kernel':
                a = a.T if a.ndim == 2 else np.transpose(a, (3, 2, 0, 1))
                name = 'weight'
            else:
                name = leaf_names[name]
            sd[f'{prefix}{name}'] = torch.from_numpy(np.array(a))

    walk(params, '')
    walk(batch_stats, '')
    return sd


def flax_simsiam_to_torch(params: Mapping, batch_stats: Mapping
                          ) -> Dict[str, torch.Tensor]:
    """JAX-package ``SimSiamBaseTracker`` trees -> a state dict of the
    port's tracker: ``_backbone`` through ``flax_resnet_to_torch`` under
    ``backbone.``, ``_img_head`` through ``flax_head_to_torch`` under
    ``img_head.``."""
    sd = {f'backbone.{k}': v for k, v in flax_resnet_to_torch(
        params['_backbone'], batch_stats['_backbone']).items()}
    if '_img_head' in params:
        sd.update({f'img_head.{k}': v for k, v in flax_head_to_torch(
            params['_img_head'], batch_stats.get('_img_head', {})).items()})
    return sd


_LEAF_NAMES = dict(kernel='weight', scale='weight', bias='bias',
                   mean='running_mean', var='running_var')


def _module_name(name: str) -> str:
    """A flax submodule's name -> the port's attribute path: ``_backbone``
    / ``_cls_head`` -> ``backbone`` / ``cls_head``, ``layer{i}_{j}`` ->
    ``layer{i}.{j}``, ``layer{i}_{j}_nl`` -> ``layer{i}_nl.{j}`` (TSM's
    non-local wrappers), ``{slow,fast}_path_X`` -> ``{slow,fast}_path.X``
    (SlowFast's pathways)."""
    m = re.fullmatch(r'(slow_path|fast_path)_(.+)', name)
    if m:
        return f'{m.group(1)}.{_module_name(m.group(2))}'
    m = re.fullmatch(r'(layer\d+)_(\d+)(_nl)?', name)
    if m:
        return f'{m.group(1)}{m.group(3) or ""}.{m.group(2)}'
    return dict(_backbone='backbone', _cls_head='cls_head').get(name, name)


def _torch_leaf(name: str, value) -> torch.Tensor:
    """A flax leaf in torch's layout: a ``Dense`` kernel (in, out) ->
    (out, in); a conv kernel (k..., in / groups, out) -> (out, in /
    groups, k...) for 1-, 2- and 3-D convolutions."""
    a = np.asarray(value)
    if name == 'kernel':
        nd = a.ndim
        a = a.T if nd == 2 else np.transpose(
            a, (nd - 1, nd - 2) + tuple(range(nd - 2)))
    return torch.from_numpy(np.array(a))


def _is_convbn_2d(node: Mapping) -> bool:
    """A 2-D ``ConvBN`` (``conv`` and optionally ``bn`` children, 4-D
    kernel): the port's 2-D ResNets and AlexNets name its parts
    torchvision's way."""
    return (hasattr(node, 'items') and 'conv' in node
            and set(node) <= {'conv', 'bn'}
            and np.ndim(node['conv'].get('kernel')) == 4)


def flax_recognizer_to_torch(params: Mapping, batch_stats: Mapping
                             ) -> Dict[str, torch.Tensor]:
    """The JAX package's recognizer trees (nested dicts of numpy arrays)
    -> a state dict of the port's recognizer, in the trees' dtype.

    Names: see ``_module_name``. A 2-D ``ConvBN`` ``conv{n}`` becomes
    ``conv{n}`` and ``bn{n}``, a 2-D ``downsample`` ``downsample.0`` and
    ``downsample.1`` (the port's ``ResNet`` blocks, which ``ResNetTSM``
    and ``ResNetTIN`` reuse, and its AlexNets); 3-D ``ConvBN3d`` pairs
    keep ``.conv`` / ``.bn`` (MMAction2's ConvModule names). Leaves:
    ``kernel`` -> ``weight`` in torch's layout (``_torch_leaf``), ``scale``
    -> ``weight``, ``mean`` / ``var`` -> ``running_mean`` /
    ``running_var``."""
    sd: Dict[str, torch.Tensor] = {}

    def leaves(node, stats, prefix):
        for tree in (node, stats):
            for leaf, value in tree.items():
                if not hasattr(value, 'items'):
                    sd[prefix + _LEAF_NAMES[leaf]] = _torch_leaf(leaf, value)

    def walk(tree, stats, prefix):
        for name, node in tree.items():
            if not hasattr(node, 'items'):
                continue
            sub = stats.get(name, {})
            if _is_convbn_2d(node):
                m = re.fullmatch(r'conv(\d+)', name)
                if m:
                    conv, bn = f'conv{m.group(1)}', f'bn{m.group(1)}'
                elif name == 'downsample':
                    conv, bn = 'downsample.0', 'downsample.1'
                else:
                    raise KeyError(f'2-D ConvBN {prefix}{name}: no port name')
                leaves(node['conv'], {}, f'{prefix}{conv}.')
                if 'bn' in node:
                    leaves(node['bn'], sub.get('bn', {}), f'{prefix}{bn}.')
                continue
            path = f'{prefix}{_module_name(name)}.'
            leaves(node, sub, path)
            walk(node, sub, path)

    walk(params, batch_stats, '')
    return sd



def flax_localizer_to_torch(params: Mapping, batch_stats: Mapping
                            ) -> Dict[str, torch.Tensor]:
    """The JAX package's BMN / TEM / PEM / SSN trees -> a state dict of the
    port's localizer. The port names its layers as the flax modules are
    named (``x1db_0``, ``x3dp``, ``conv1``, ``fc1``; SSN's ``_backbone``
    and ``_cls_head`` become ``backbone`` and ``cls_head``, its ResNet
    named as ``flax_recognizer_to_torch`` names it), so the walk is that
    function's. The layouts: a 1-D kernel (k, in / groups, out) -> (out,
    in / groups, k), both splitting the groups contiguously; ``x3dp``'s
    (S, 1, 1, in, out) over (N, S, T, T, C) -> (out, in, S, 1, 1) over
    (N, C, S, T, T); 2-D kernels and ``Dense`` kernels as everywhere."""
    return flax_recognizer_to_torch(params, batch_stats)

def save_checkpoint(ckpt_dir: str, epoch: int, state: Dict[str, Any]) -> str:
    """``torch.save`` a train state (model and optimizer state dicts, the
    schedule step, the epoch) as ``ckpt_dir/epoch_{epoch}`` and point the
    ``latest`` marker at it. Returns the path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f'epoch_{epoch}'
    path = os.path.join(ckpt_dir, name)
    torch.save(state, path + '.tmp')
    os.replace(path + '.tmp', path)
    with open(os.path.join(ckpt_dir, 'latest'), 'w') as f:
        f.write(name)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The path the ``latest`` marker names, or None."""
    marker = os.path.join(ckpt_dir, 'latest')
    if not os.path.isfile(marker):
        return None
    with open(marker) as f:
        path = os.path.join(ckpt_dir, f.read().strip())
    return path if os.path.isfile(path) else None


def restore_checkpoint(path: str,
                       map_location: Any = 'cpu') -> Dict[str, Any]:
    """A train state written by ``save_checkpoint``."""
    return torch.load(path, map_location=map_location, weights_only=True)


def load_backbone_state(module: torch.nn.Module,
                        state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load ``state_dict`` into a backbone: keys the backbone lacks (a
    torchvision classifier ``fc.*``) are ignored, and a checkpoint without
    BN ``num_batches_tracked`` counters is fine; any other missing key
    raises."""
    own = module.state_dict()
    sd = {k: v for k, v in state_dict.items() if k in own}
    missing = [k for k in own if k not in sd
               and not k.endswith('num_batches_tracked')]
    if missing:
        raise KeyError(f'checkpoint lacks backbone keys: {missing[:8]}')
    module.load_state_dict(sd, strict=False)
