"""Data-parallel training on the CPU: two ``gloo`` processes, each on half
the batch (its shard: the local mean loss, gradients averaged by
``DistributedDataParallel``, BatchNorm statistics all-reduced), end one
step with the parameters and running statistics of one process on the
whole batch, and of the JAX package's step on it (the global batch from
local shards, ``vfs_tpu/parallel/mesh.py::shard_local_batch``).

The workers run ``WORKER`` in fresh interpreters, joined with a timeout
of their own, so a hang fails the test and does not hold the suite.
Tolerances: the two ranks end bit-equal; against one process and against
JAX, the step-1 update and the running statistics within 2e-4 relative
L2 (see ``test_torch_train_step``: fp32 sums in another order, amplified
by BatchNorm over 8 frames).
"""

import json
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

from vfs_tpu.apis.train import TrainState as JaxTrainState
from vfs_tpu.apis.train import make_train_step as jax_make_train_step
from vfs_tpu.core.optimizer.builder import \
    build_optimizer as jax_build_optimizer
from vfs_tpu.models import build_model as jax_build_model
from vfs_tpu_torch.apis.train import make_train_step
from vfs_tpu_torch.checkpoint import flax_simsiam_to_torch
from vfs_tpu_torch.core.optimizer import build_optimizer

from test_torch_train_step import (ITERS_PER_EPOCH, LR_CFG, MODEL_CFG,
                                   OPT_CFG, TOTAL_ITERS, TRAIN_CFG,
                                   assert_tree_close, jax_variables,
                                   port_model, to_torch_tree, train_batch)

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
WORLD = 2
TIMEOUT_S = 240

WORKER = r'''
import json
import sys
import numpy as np
import torch
import torch.distributed as dist
from vfs_tpu_torch.apis.train import make_train_step
from vfs_tpu_torch.core.optimizer import build_optimizer
from vfs_tpu_torch.models import build_model
from vfs_tpu_torch.parallel import (get_rank, get_world_size,
                                    reduce_log_vars, wrap_distributed)

torch.set_num_threads(1)
rank, world, port, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                        rank=rank, world_size=world)
assert (get_rank(), get_world_size()) == (rank, world)
with open(f'{workdir}/cfg.json') as f:
    cfg = json.load(f)
model = build_model(cfg['model'], train_cfg=cfg['train'])
model.load_state_dict(torch.load(f'{workdir}/start.pt'), strict=False)
model.train()
optimizer, _ = build_optimizer(model.parameters(), cfg['optimizer'],
                               cfg['lr'], *cfg['iters'])
net = wrap_distributed(model, torch.device('cpu'))
assert net is not model
x = np.load(f'{workdir}/batch.npy')
shard = len(x) // world
log_vars = make_train_step(net, optimizer)(x[rank * shard:(rank + 1) * shard])
loss = reduce_log_vars(log_vars)['loss']
torch.save(dict(state=model.state_dict(), loss=loss),
           f'{workdir}/rank{rank}.pt')
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def setup():
    model = jax_build_model(MODEL_CFG, train_cfg=TRAIN_CFG)
    x = train_batch(1)
    params, stats = jax_variables(model, x)
    tx, _ = jax_build_optimizer(OPT_CFG, LR_CFG, TOTAL_ITERS,
                                ITERS_PER_EPOCH)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=stats, opt_state=tx.init(params))
    state, log_vars = jax.jit(jax_make_train_step(model, tx))(
        state, jnp.asarray(x))
    return params, stats, x, state, float(log_vars['loss'])


def _run_workers(workdir):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, '-c', WORKER, str(rank), str(WORLD), str(port),
         workdir], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(WORLD)]
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


def test_two_gloo_processes_equal_one_process_and_jax(setup, tmp_path):
    params, stats, x, jax_state, jax_loss = setup
    workdir = str(tmp_path)
    start = flax_simsiam_to_torch(params, stats)
    torch.save(start, osp.join(workdir, 'start.pt'))
    np.save(osp.join(workdir, 'batch.npy'), x)
    with open(osp.join(workdir, 'cfg.json'), 'w') as f:
        json.dump(dict(model=MODEL_CFG, train=TRAIN_CFG, optimizer=OPT_CFG,
                       lr=LR_CFG, iters=[TOTAL_ITERS, ITERS_PER_EPOCH]), f)
    _run_workers(workdir)
    ranks = [torch.load(osp.join(workdir, f'rank{r}.pt'))
             for r in range(WORLD)]
    for k, v in ranks[0]['state'].items():
        assert torch.equal(v, ranks[1]['state'][k]), k
    # one process on the whole batch
    model = port_model(params, stats)
    optimizer, _ = build_optimizer(model.parameters(), OPT_CFG, LR_CFG,
                                   TOTAL_ITERS, ITERS_PER_EPOCH)
    loss = float(make_train_step(model, optimizer)(x)['loss'])
    np.testing.assert_allclose(ranks[0]['loss'], loss, rtol=1e-5)
    np.testing.assert_allclose(ranks[0]['loss'], jax_loss, rtol=1e-5)
    ddp = ranks[0]['state']
    names = [n for n, _ in model.named_parameters()]
    jax_sd = to_torch_tree(jax_state.params, jax_state.batch_stats)
    for ref_sd, what in ((model.state_dict(), 'one process'),
                         (jax_sd, 'JAX')):
        assert_tree_close({n: ddp[n] - start[n] for n in names},
                          {n: ref_sd[n] - start[n] for n in names},
                          f'DDP vs {what} update', names=names)
        stat_names = [k for k in ref_sd if 'running' in k]
        assert_tree_close(ddp, ref_sd, f'DDP vs {what}', names=stat_names)
    # the statistics are global: a shard alone would give others
    alone = port_model(params, stats)
    with torch.no_grad():
        alone(torch.from_numpy(x[:1]))
    var = 'img_head.projection_fc0.bn.running_var'
    assert not torch.allclose(alone.state_dict()[var], ddp[var], rtol=1e-3)
