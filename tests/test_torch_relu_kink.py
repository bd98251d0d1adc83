"""What made the card's fp32 SimSiam step look far less accurate than the
CPU's on one batch: a ReLU decision at the kink, not an inaccurate op.

A pre-activation that lies within the fp32 rounding of 0 takes its sign
from the rounding. ReLU's gradient jumps there (1 above 0, 0 at and below
it, in flax and in PyTorch alike), so an fp32 step passes or cuts the
whole gradient of that position by chance, and every gradient that sums
over the position (a BatchNorm's shift, the layers below) moves by what
it carries. On the r18 train phase's first mp4v batch that was one
position of layer2's output, +1.8e-7 in fp64 and exactly 0 in the card's
fp32 (``chip_smoke``'s docstring, tolerances). No accumulation in higher
precision can undo it: the sign is lost when the input is rounded to
fp32.

Here, on the CPU: a BatchNorm2d in training mode (flax's semantics) on a
channel built so that one element sits 2^-30 above the channel's mean in
float64 and on it in fp32. The fp32 step's forward agrees with float64's
to 1e-6 while its shift gradient is 1/16 off; the JAX package's BatchNorm
(flax) gives the same fp32 gradient; with the ReLU decisions pinned to the
float64 step's (``chip_smoke.relu_decisions``, which the train phase's
``card_vs_cpu_kinks`` uses) the fp32 gradients agree with float64's to
1e-6, and the differing decision lies within ``chip_smoke.KINK_ULPS``
ulps of 0.
"""

import os.path as osp
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from vfs_tpu_torch.models.common.norm import BatchNorm2d

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

D = 2.0 ** -30  # the probe's distance above the mean, below fp32's reach


def kink_input():
    """(2, 1, 4, 4) float64: 15 values at 1.5, 15 at 0.5, the probe at
    1 + D and its counterweight at 1 - D; the mean is 1 exactly. In fp32
    the probe and its counterweight round to 1.0, the mean stays 1.0."""
    values = np.array([1.5, 0.5] * 15 + [1 + D, 1 - D], np.float64)
    return values.reshape(2, 1, 4, 4)


def step(x, dtype, pinned=None, record=None):
    """BatchNorm2d (training mode) -> F.relu -> sum: the loss, the input's
    and the parameters' gradients."""
    bn = BatchNorm2d(1).to(dtype).train()
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    with chip_smoke.relu_decisions(record=record, pinned=pinned):
        out = F.relu(bn(xt))
    out.sum().backward()
    return out.detach(), dict(x=xt.grad, weight=bn.weight.grad,
                              bias=bn.bias.grad)


def rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def test_relu_kink_decides_the_fp32_gradient():
    x = kink_input()
    inputs = []
    out64, g64 = step(x, torch.float64, record=inputs)
    out32, g32 = step(x, torch.float32)
    probe = (1, 0, 3, 2)  # flat index 30
    assert inputs[0][probe] > 0 and out32[probe] == 0.0
    # the forward is as accurate as fp32 allows
    assert rel(out32, out64) < 1e-6
    # the decision cuts one of 16 positive positions from the shift's sum
    assert float(g64['bias']) == 16.0 and float(g32['bias']) == 15.0
    assert rel(g32['bias'], g64['bias']) == 1 / 16

    # pinned to the float64 decisions, fp32 gives float64's gradients
    masks = [t > 0 for t in inputs]
    _, pinned = step(x, torch.float32, pinned=masks)
    for k in g64:
        assert rel(pinned[k], g64[k]) < 1e-6, k
    # the differing decision lies at the kink: well inside KINK_ULPS of
    # the input's RMS
    ulp = float(inputs[0].square().mean().sqrt()) * 2.0 ** -23
    assert float(inputs[0][probe]) / ulp < chip_smoke.KINK_ULPS


def test_flax_batchnorm_takes_the_same_fp32_decision():
    """The JAX package's BatchNorm (flax ``nn.BatchNorm``, momentum 0.9,
    eps 1e-5) with ``jax.nn.relu`` in fp32: the same shift gradient as the
    port's fp32 step, so the cut is the function's at fp32, not the
    port's."""
    x = np.transpose(kink_input(), (0, 2, 3, 1)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), x)

    def loss(params):
        y, _ = bn.apply({'params': params,
                         'batch_stats': variables['batch_stats']}, x,
                        mutable=['batch_stats'])
        return jnp.sum(jax.nn.relu(y))

    grads = jax.grad(loss)(variables['params'])
    _, g32 = step(kink_input(), torch.float32)
    assert float(grads['bias'][0]) == float(g32['bias']) == 15.0
    np.testing.assert_allclose(float(grads['scale'][0]),
                               float(g32['weight']), rtol=1e-6)
