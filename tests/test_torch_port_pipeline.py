'''Pipeline parallelism (``parallel.pipeline``) and a dp 1 x mp 2 step in
the port against the JAX package, on the CPU: two gloo processes
(``parallel.launch.spawn``) form a pp = 2 group, each holding one stage of
the bi-modal encoder, and

- the pipelined forward and the gradients of sum(Av^2) + sum(Va^2) at
  (layers, microbatches) (2, 4) and (4, 2) match JAX's
  ``pipelined_bimodal_encoder_forward`` over a 'pp' mesh of two virtual
  CPU devices (forward rtol/atol 1e-4 as JAX's own test; gradients
  atol max(5e-6 scale, 5e-4), the regrouping noise JAX's test measured),
  and the inputs' gradient is whole on both ranks;
- the output does not depend on the microbatch count (1, 2 and 8);
- with dropout 0.3 and a generator the pipelined forward stays finite and
  differs from the deterministic one;
- a generic stack of four linear maps carries an int constant unchanged;
- a split that does not divide raises ValueError, as do microbatches that
  do not divide the batch;

then, on the same two ranks, the captioner's dp 1 x mp 2 steps give the
JAX package's ``DataParallel(1, mp=2)`` ``place_params`` step (fp32,
dropout 0: losses rtol 2e-5, parameters 2e-6).'''
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from bmt_tpu.models import init_bimodal_transformer
from bmt_tpu.models.encoders import init_bimodal_encoder
from bmt_tpu.parallel import DataParallel as JaxDataParallel
from bmt_tpu.parallel.pipeline import (pipelined_bimodal_encoder_forward,
                                       stack_layer_params as jstack)
from bmt_tpu.train import steps as jsteps
from bmt_tpu_torch.models.encoders import BiModalEncoder
from bmt_tpu_torch.parallel.launch import spawn
from bmt_tpu_torch.parallel.mesh import Group
from bmt_tpu_torch.parallel.pipeline import (pipeline_layer_stack,
                                             stack_layer_params)
from tests import torch_port_dp as dpwork
from tests import torch_port_shard as work
from tests.test_torch_port_fsdp import CFG, cap_batch
from tests.torch_port_util import (PAD, SMALL, assert_jax_trees_close,
                                   assert_losses_close, dims_pair,
                                   jax_sharded_steps)

H = 2
CAP = {**SMALL, 'N': 1, 'dout_p': 0.0, 'voc_size': 24}
CASES = [(2, (4, 1, 8)), (4, (2,))]       # (layers, microbatch counts)


def encoder_tree(n_layers):
    return jax.tree.map(np.asarray, init_bimodal_encoder(
        jax.random.PRNGKey(0), 8, 8, 16, 16, 16, n_layers))


def encoder_data(seed=0, B=8, Sa=6, Sv=5):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, Sa, 8)).astype(np.float32)
    V = rng.normal(size=(B, Sv, 8)).astype(np.float32)
    Am = np.ones((B, 1, Sa), bool)
    Am[:, :, -1] = False        # a padded key: masking rides the ring
    Vm = np.ones((B, 1, Sv), bool)
    return A, V, Am, Vm


def jax_pipeline(tree, data, n_micro):
    '''JAX's pipelined (Av, Va) and the gradients of sum(Av^2) +
    sum(Va^2) w.r.t. the stacked stage parameters and A.'''
    mesh = Mesh(np.array(jax.devices()[:2]), ('pp',))
    stage = jstack(jax.tree.map(jnp.asarray, tree['layers']), 2)
    A, V, Am, Vm = (jnp.asarray(x) for x in data)

    def loss(stk, a):
        Av, Va = pipelined_bimodal_encoder_forward(stk, a, V, Am, Vm, H,
                                                   mesh, n_micro=n_micro)
        return jnp.sum(Av ** 2) + jnp.sum(Va ** 2), (Av, Va)
    (_, outs), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(stage, A)
    return outs, grads


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    '''(the two ranks' results, JAX's pipelines by case, JAX's mp step).'''
    jcap, _ = dims_pair(**CAP)
    params = init_bimodal_transformer(jax.random.PRNGKey(3), jcap)
    batches = [cap_batch(90 + i, jcap) for i in range(2)]
    rng = np.random.default_rng(5)
    job = {'pipeline': [{'n_layers': n, 'n_micro': m,
                         'tree': encoder_tree(n), 'data': encoder_data(n)}
                        for n, m in CASES],
           'generic': {'W': rng.normal(size=(4, 3, 3)).astype(np.float32),
                       'x': rng.normal(size=(8, 3)).astype(np.float32)},
           'jobs': [{'label': 'mp2', 'grid': (1, 1, 1, 2), 'fsdp': False,
                     'min_elems': 0,
                     'runs': [{'name': 'mp2', 'kind': 'cap', 'dims': CAP,
                               'tree': work.as_numpy(params), 'cfg': CFG,
                               'frozen': dpwork.nothing,
                               'batches': batches}]}]}
    job['pipeline'][0]['dout_p'] = 0.3
    path = tmp_path_factory.mktemp('pp') / 'job.pkl'
    with open(path, 'wb') as f:
        pickle.dump(job, f)
    got = spawn(work.pipeline_work, (str(path),), 2, 'cpu')
    want = [jax_pipeline(c['tree'], c['data'], c['n_micro'][0])
            for c in job['pipeline']]
    mp = jax_sharded_steps(
        lambda opt, mask: jsteps.make_cap_train_step(
            jcap, opt, work.SMOOTHING, PAD, frozen_mask=mask),
        params, CFG, dpwork.nothing, batches, JaxDataParallel(1, mp=2),
        place=True)
    return got, want, mp, job


@pytest.mark.parametrize('case', [0, 1])
def test_pp2_forward_matches_jax_pipeline(ranks, case):
    got, want, _, job = ranks
    m = job['pipeline'][case]['n_micro'][0]
    for r in got:
        for a, b in zip(r['cases'][case]['outs'][m], want[case][0]):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize('case', [0, 1])
def test_pp2_grads_match_jax_pipeline(ranks, case):
    '''Each rank's layers' gradients are JAX's stacked stage gradients at
    those layers; the inputs' gradient is JAX's on both ranks.'''
    got, want, _, job = ranks
    n = job['pipeline'][case]['n_layers']
    jgrads, jA = want[case][1]
    per = n // 2
    held = {}
    for r in got:
        held.update(r['cases'][case]['grads'])
        np.testing.assert_allclose(r['cases'][case]['input_grad'],
                                   np.asarray(jA), rtol=1e-4, atol=5e-4)
    leaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(held) == len(leaves) * n
    for path, g in leaves:
        keys = [str(getattr(k, 'key', getattr(k, 'idx', None)))
                for k in path]
        g = np.asarray(g)                  # (pp, per, ...)
        for s in range(2):
            for j in range(per):
                key = '/'.join([str(s * per + j)] + keys)
                scale = float(np.abs(g[s, j]).max()) + 1.0
                np.testing.assert_allclose(held[key], g[s, j], rtol=0,
                                           atol=max(5e-6 * scale, 5e-4),
                                           err_msg=key)


def test_pp2_micro_batch_count_invariance(ranks):
    got, _, _, _ = ranks
    outs = got[0]['cases'][0]['outs']
    for m in (1, 8):
        for a, b in zip(outs[m], outs[4]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_pp2_dropout_trains(ranks):
    '''Dropout draws per (stage layer, tick): the output stays finite and
    differs from the deterministic pass, and both ranks see the same
    output.'''
    got, _, _, _ = ranks
    dr = [r['cases'][0]['dropout'] for r in got]
    assert np.isfinite(dr[0]).all()
    np.testing.assert_array_equal(dr[0], dr[1])
    assert np.abs(dr[0] - got[0]['cases'][0]['outs'][4][0]).max() > 1e-3


def test_pp2_generic_stack_threads_constants(ranks):
    '''A layer_fn-agnostic stack: four linear maps applied in order over
    two stages, an int flag carried unchanged.'''
    got, _, _, job = ranks
    W, x = job['generic']['W'], job['generic']['x']
    ref = x
    for w in W:
        ref = ref @ w
    for r in got:
        y, f = r['generic']
        np.testing.assert_allclose(y, ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(f, np.arange(8))


def test_stack_layer_params_validates_divisibility():
    enc = BiModalEncoder(8, 8, 16, 16, 16, 3, H, device='cpu')
    with pytest.raises(ValueError, match='3 layers do not split into 2'):
        stack_layer_params(enc.layers, 2, 0)
    stage = stack_layer_params(enc.layers, 3, 1)
    assert len(stage) == 1 and stage[0] is enc.layers[1]
    with pytest.raises(ValueError, match='n_micro=3'):
        pipeline_layer_stack(stage, (torch.zeros(8, 3),),
                             lambda layer, c: c, Group(), 3)


def test_mp2_steps_match_the_jax_place_params_step(ranks):
    got, _, (losses, params), _ = ranks
    mine = got[0]['jobs']['mp2']
    assert [r['jobs']['mp2']['coords'] for r in got] == [(0, 0, 0, 0),
                                                          (0, 0, 0, 1)]
    assert_losses_close(mine['mp2']['losses'], losses)
    assert_jax_trees_close(mine['mp2']['tree'], params)
