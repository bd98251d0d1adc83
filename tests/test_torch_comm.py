"""``vfs_tpu_torch.parallel.comm`` in two ``gloo`` processes on the CPU,
held against ``vfs_tpu/parallel/comm.py`` on a two-device mesh and the
semantics of ``tests/test_core/test_comm.py``: every process gathers the
global batch in rank order with no gradient through the gather; the batch
shuffle is a permutation of the global batch that moves rows across the
processes and that the unshuffle undoes; gradients are averaged; the
sharded gather returns the global batch with the identity's gradient; log
vars average. Outside a process group each helper is the identity.

The workers run ``WORKER`` in fresh interpreters, joined with a timeout,
as ``tests/test_torch_ddp.py`` runs its own.
"""

import os
import os.path as osp
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vfs_tpu.parallel import (allreduce_grads as jax_allreduce_grads,
                              concat_all_gather as jax_concat_all_gather)
from vfs_tpu_torch.parallel import (allreduce_grads, batch_shuffle,
                                    batch_unshuffle, concat_all_gather,
                                    concat_all_gather_sharded)

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
WORLD, PER_RANK = 2, 3
TIMEOUT_S = 120

WORKER = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
from vfs_tpu_torch.parallel import (allreduce_grads, batch_shuffle,
                                    batch_unshuffle, concat_all_gather,
                                    concat_all_gather_sharded,
                                    reduce_log_vars)

torch.set_num_threads(1)
rank, world, port, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                        rank=rank, world_size=world)
data = np.load(f'{workdir}/data.npz')
n = len(data['x']) // world
x = torch.tensor(data['x'][rank * n:(rank + 1) * n], requires_grad=True)
gathered = concat_all_gather(x)
(gathered.sum() + (2.0 * x).sum()).backward()
gen = torch.Generator().manual_seed(0)  # alike on every rank
shuffled, inverse = batch_shuffle(x.detach(), gen)
back = batch_unshuffle(shuffled, inverse)
grads = {k: torch.tensor(data[k][rank]) for k in ('w', 'b')}
allreduce_grads(grads)
y = torch.tensor(data['x'][rank * n:(rank + 1) * n], requires_grad=True)
sharded = concat_all_gather_sharded(y)
sharded.pow(2).sum().backward()
logs = reduce_log_vars({'loss': grads['b'].sum() * 0 + float(rank)})
torch.save(dict(gathered=gathered, requires_grad=gathered.requires_grad,
                x_grad=x.grad, shuffled=shuffled, inverse=inverse,
                back=back, grads=grads, sharded=sharded.detach(),
                y_grad=y.grad, loss=logs['loss']),
           f'{workdir}/rank{rank}.pt')
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """The two workers' results on the module's data."""
    workdir = str(tmp_path_factory.mktemp('comm'))
    rng = np.random.RandomState(0)
    data = dict(x=rng.randn(WORLD * PER_RANK, 4).astype(np.float32),
                w=rng.randn(WORLD, 3, 2).astype(np.float32),
                b=rng.randn(WORLD, 5).astype(np.float64))
    np.savez(osp.join(workdir, 'data.npz'), **data)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, '-c', WORKER, str(rank), str(WORLD), str(port),
         workdir], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return data, [torch.load(osp.join(workdir, f'rank{r}.pt'))
                  for r in range(WORLD)]


def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ('data',))


def _smap(fn, mesh, in_specs, out_specs):
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     check_vma=False)


def test_gather_equals_jax_and_carries_no_gradient(ranks):
    data, out = ranks
    mesh = _mesh()
    xs = jax.device_put(jnp.asarray(data['x']), NamedSharding(mesh,
                                                                P('data')))
    ref = np.asarray(_smap(jax_concat_all_gather, mesh, (P('data'),),
                           P('data'))(xs))
    n = len(data['x'])
    for r in range(WORLD):
        np.testing.assert_array_equal(out[r]['gathered'].numpy(), data['x'])
        np.testing.assert_array_equal(ref[r * n:(r + 1) * n], data['x'])
        assert not out[r]['requires_grad']
        # only the local 2x term reaches x
        np.testing.assert_array_equal(out[r]['x_grad'].numpy(),
                                      np.full((PER_RANK, 4), 2.0))


def test_batch_shuffle_roundtrip(ranks):
    data, out = ranks
    x = data['x']
    shuffled = np.concatenate([o['shuffled'].numpy() for o in out])
    assert sorted(shuffled[:, 0].tolist()) == sorted(x[:, 0].tolist())
    assert not np.array_equal(shuffled, x)
    # rows cross the processes' boundary
    assert set(shuffled[:PER_RANK, 0]) != set(x[:PER_RANK, 0])
    for r in range(WORLD):
        assert torch.equal(out[r]['inverse'], out[0]['inverse'])
        np.testing.assert_array_equal(
            out[r]['back'].numpy(), x[r * PER_RANK:(r + 1) * PER_RANK])


def test_allreduce_grads_equals_jax_mean(ranks):
    data, out = ranks
    mesh = _mesh()
    for key in ('w', 'b'):
        g = jax.device_put(jnp.asarray(data[key].astype(np.float32)),
                           NamedSharding(mesh, P('data')))
        ref = np.asarray(_smap(jax_allreduce_grads, mesh, (P('data'),),
                               P('data'))(g))
        for r in range(WORLD):
            got = out[r]['grads'][key]
            assert got.dtype == torch.from_numpy(data[key]).dtype
            np.testing.assert_allclose(got.numpy(), data[key].mean(0),
                                       rtol=1e-6)
            np.testing.assert_allclose(got.numpy(), ref[r], rtol=1e-6)


def test_sharded_gather_keeps_the_identity_gradient(ranks):
    data, out = ranks
    x = data['x']
    for r in range(WORLD):
        np.testing.assert_array_equal(out[r]['sharded'].numpy(), x)
        np.testing.assert_allclose(
            out[r]['y_grad'].numpy(), 2.0 * x[r * PER_RANK:(r + 1) * PER_RANK],
            rtol=1e-6)
        assert out[r]['loss'] == pytest.approx(0.5)


def test_one_process_is_the_identity():
    x = torch.arange(12.0).reshape(6, 2).requires_grad_()
    gathered = concat_all_gather(x)
    assert torch.equal(gathered, x) and not gathered.requires_grad
    shuffled, inverse = batch_shuffle(x.detach(),
                                      torch.Generator().manual_seed(1))
    assert not torch.equal(shuffled, x)
    assert torch.equal(batch_unshuffle(shuffled, inverse), x)
    grads = [torch.ones(3), torch.full((2,), 3.0)]
    assert allreduce_grads(grads) is grads and torch.equal(grads[1],
                                                           torch.full((2,),
                                                                      3.0))
    assert concat_all_gather_sharded(x) is x
