"""vfs_tpu_torch's per-step attention v2 (``local_topk_attend_v2``)
against the JAX package's ``pallas_local_topk_attend_v2`` on the CPU.

The port's op (on the CPU: the plain ``local_topk_attend_reference``) is
held against the TPU kernel run in Pallas interpret mode on the inputs of
``tests/test_ops/test_pallas_kernel.py:39-61`` and on a case with ragged
tiles and invalid slots. Logits agree within rtol 1e-4 / atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.ops.affinity import l2_normalize as jax_l2_normalize
from vfs_tpu.ops.pallas_attention import pad_for_pallas
from vfs_tpu.ops.pallas_attention_v2 import pallas_local_topk_attend_v2
from vfs_tpu_torch.ops import local_topk_attend_v2, local_topk_attend_v2_cuda
from vfs_tpu_torch.ops.local_attention import local_topk_attend_reference

torch.set_num_threads(1)


def _inputs(seed, h, w, f=5, c=16, k=3):
    """The seeded inputs of tests/test_ops/test_pallas_kernel.py."""
    rng = np.random.RandomState(seed)
    query = np.array(jax_l2_normalize(
        jnp.asarray(rng.randn(h, w, c), jnp.float32), -1))
    bank = np.array(jax_l2_normalize(
        jnp.asarray(rng.randn(f, h, w, c), jnp.float32), -1))
    vals = rng.rand(f, h, w, k).astype(np.float32)
    return query, bank, vals


@pytest.mark.parametrize('h,w,nr,tile,topk,valid', [
    (12, 14, 6, (4, 8), 4, [1, 1, 1, 0, 0]),   # test_pallas_kernel.py:39-61
    (10, 11, 8, (8, 8), 3, [0, 1, 1, 0, 1]),   # ragged tiles, holes
    (9, 13, 6, (4, 8), 10, [1, 0, 0, 0, 1]),   # two valid slots, top-10
])
def test_local_attend_v2_matches_tpu_kernel(h, w, nr, tile, topk, valid):
    query, bank, vals = _inputs(0, h, w)
    radius = nr // 2
    ref = np.asarray(pallas_local_topk_attend_v2(
        pad_for_pallas(jnp.asarray(query), h, w, radius, tile),
        pad_for_pallas(jnp.asarray(bank), h, w, radius, tile),
        jnp.asarray(vals), jnp.asarray(valid), radius=radius,
        temperature=0.07, topk=topk, h=h, w=w, tile=tile, interpret=True))
    out, scores, src = local_topk_attend_v2(
        torch.from_numpy(query), torch.from_numpy(bank),
        torch.from_numpy(vals), torch.tensor(valid), float(radius), 0.07,
        topk)
    assert out.shape == (h, w, 3) and scores.shape == (h, w, topk)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)
    slots = src.numpy() // (h * w)
    assert np.isin(slots, np.flatnonzero(valid)).all()


def test_local_attend_v2_dispatch_cpu_is_reference():
    query, bank, vals = _inputs(6, 5, 6, f=3)
    args = [torch.from_numpy(a) for a in (query, bank, vals)]
    valid = torch.tensor([True, False, True])
    a = local_topk_attend_v2(*args, valid, 3.0, 0.07, 4)
    b = local_topk_attend_reference(*args, valid, 3.0, 0.07, 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_local_attend_v2_kernel_wrapper_refuses_cpu_tensors():
    query, bank, vals = _inputs(7, 4, 5, f=2)
    with pytest.raises(ValueError, match='CUDA tensors'):
        local_topk_attend_v2_cuda(
            torch.from_numpy(query), torch.from_numpy(bank),
            torch.from_numpy(vals), torch.ones(2, dtype=torch.int32), 3.0,
            0.07, 4)
    assert local_topk_attend_v2_cuda.launches == 0
