"""The TSM optimizer's parameter groups (counterpart of
``vfs_tpu/core/optimizer/tsm_optimizer_constructor.py``; reference:
mmaction/core/optimizer/tsm_optimizer_constructor.py:7-116).

Groups, as (lr, weight decay) multipliers of the base values:

- the first convolution's weight (1, 1) and bias (2, 0);
- BatchNorm scales and shifts (1, 0);
- with ``fc_lr5``, the classifier ``cls_head.fc_cls``'s weight (5, 10)
  and bias (10, 0);
- every other weight (1, 1) and bias (2, 0).

The JAX package labels flax paths by name; the port labels each torch
parameter as the JAX package labels its flax counterpart, finding the
BatchNorms by module type. Two quirks of the JAX package are kept so that
the packages agree: ``lr5_weight`` takes 10x the weight decay, where
MMAction2 gives that group the base decay; and a non-local block's
``conv_out`` BatchNorm (``norm``, which the JAX path rule does not take
for a BatchNorm) falls in the weight and bias groups.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import torch.nn as nn

from .builder import ChainedOptimizer, Schedule, _constant

GROUPS = {
    'first_conv_weight': (1.0, 1.0),
    'first_conv_bias': (2.0, 0.0),
    'normal_weight': (1.0, 1.0),
    'normal_bias': (2.0, 0.0),
    'bn': (1.0, 0.0),
    'lr5_weight': (5.0, 10.0),
    'lr10_bias': (10.0, 0.0),
}


def tsm_param_labels(model: nn.Module, fc_lr5: bool = True
                     ) -> Dict[str, str]:
    """Each named parameter of ``model`` -> its TSM group name."""
    from ...models.common.non_local import NonLocal3d
    nl_norms = {id(m.norm) for m in model.modules()
                if isinstance(m, NonLocal3d) and m.with_norm}
    owner = {}
    for mname, m in model.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            owner[f'{mname}.{pname}' if mname else pname] = m
    first_conv = next((m for m in model.modules()
                       if isinstance(m, nn.modules.conv._ConvNd)), None)
    fc = getattr(getattr(model, 'cls_head', None), 'fc_cls', None)
    labels = OrderedDict()
    for name, _ in model.named_parameters():
        m = owner[name]
        bias = name.endswith('bias')
        if isinstance(m, nn.modules.batchnorm._BatchNorm) \
                and id(m) not in nl_norms:
            labels[name] = 'bn'
        elif m is first_conv:
            labels[name] = 'first_conv_bias' if bias else 'first_conv_weight'
        elif fc_lr5 and m is fc:
            labels[name] = 'lr10_bias' if bias else 'lr5_weight'
        else:
            labels[name] = 'normal_bias' if bias else 'normal_weight'
    return labels


def build_tsm_optimizer(model: nn.Module, lr, momentum: float = 0.9,
                        weight_decay: float = 1e-4, fc_lr5: bool = True,
                        grad_clip: Optional[float] = None
                        ) -> ChainedOptimizer:
    """SGD over ``model``'s parameters in the TSM groups: for each, decay
    ``weight_decay * wd_mult`` added to the gradient, the momentum trace,
    and a step of ``lr * lr_mult``; ``lr`` is a number or a schedule of
    the update count."""
    labels = tsm_param_labels(model, fc_lr5)
    params = [p for _, p in model.named_parameters()]
    schedule: Schedule = lr if callable(lr) else _constant(lr)
    return ChainedOptimizer(params, 'SGD', schedule,
                            weight_decay=weight_decay, momentum=momentum,
                            grad_clip=grad_clip,
                            mults=[GROUPS[labels[n]] for n, _ in
                                   model.named_parameters()])


def CopyOfSGD(params, learning_rate, momentum=0.0, weight_decay=0.0,
              nesterov=False) -> ChainedOptimizer:
    """The reference's example of a registered custom optimizer
    (core/optimizer/copy_of_sgd.py, an SGD clone): the plain SGD chain;
    ``learning_rate`` is a number or a schedule."""
    schedule = learning_rate if callable(learning_rate) \
        else _constant(learning_rate)
    return ChainedOptimizer(params, 'SGD', schedule,
                            weight_decay=weight_decay, momentum=momentum,
                            nesterov=nesterov)
