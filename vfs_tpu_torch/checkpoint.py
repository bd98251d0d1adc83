"""Checkpoint bridges (counterpart of ``vfs_tpu/checkpoint.py``).

- ``vfs_train_ckpt_to_torchvision``: VFS training checkpoint
  (``backbone.conv1.conv.weight`` ConvModule naming) -> torchvision keys.
- ``load_torchvision_resnet``: a released torchvision-layout ``.pth`` as a
  state dict for the port's ``ResNet`` (same key names).
- ``flax_resnet_to_torch``: the JAX package's ResNet ``(params,
  batch_stats)`` trees, as nested dicts of numpy arrays, -> a state dict
  for the port's ``ResNet``. Conv kernels go HWIO -> OIHW.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

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
