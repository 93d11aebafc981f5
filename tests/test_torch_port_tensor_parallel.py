'''Tensor parallelism (``mp``) in the port against the JAX package, on the
CPU: eight gloo processes (``parallel.launch.spawn``, one group) run five
grids in turn, each against the JAX package's ``place_params`` step on
the conftest's virtual CPU devices (fp32, dropout 0, Adam eps 1e-4: losses
rtol 2e-5, parameters 2e-6):

- dp 2 x mp 4, the captioner with H = 2 (H % mp != 0: the port keeps the
  attention whole, where the JAX guard splits d_model's columns; the
  feed-forwards and the vocabulary split), against JAX's dp 2 x mp 4
  step, its shard shapes against ``cap_param_shardings``, its greedy
  decode with mp-sharded parameters and its checkpoint against the
  unsharded run's, key for key;
- dp 4 x mp 2 with ``--fsdp`` (every leaf's mp block cut over dp), the
  attention split into one head a rank, against the same JAX step (the
  JAX package's own tests hold its mp and fsdp steps to one device's);
- dp 2 x sp 2 x mp 2, the bi-modal proposal generator's sequence-parallel
  step, against JAX's dp 2 x sp 2 ``seq_mesh`` step: JAX's dp 2 x sp 2 x
  mp 2 step departs from its own unsharded, sp and mp steps (a step-2 loss
  397.562 against their 397.460 here; ROADMAP.md section 3), and the
  port's grid gives the unsharded step's;
- dp 2 x ep 2 x mp 2, the Switch-MoE captioner (E = 4, each expert's
  hidden width split over mp), against JAX's dp 2 x ep 2 x mp 2 step;
- dp 2 x mp 4, LoRA (rank 2 on the attention and feed-forward linears,
  the vocabulary 23 not dividing: the generator whole), against JAX's
  dp 2 x mp 4 step: only the adapters move.

One encoder and one decoder layer keep JAX's compiles short.
'''
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from bmt_tpu.models import init_bimodal_transformer
from bmt_tpu.models import proposal as jprop
from bmt_tpu.ops.lora import add_lora as jadd_lora
from bmt_tpu.parallel import DataParallel as JaxDataParallel
from bmt_tpu.parallel import cap_param_shardings, make_mesh
from bmt_tpu.train import checkpoint as jckpt
from bmt_tpu.train import steps as jsteps
from bmt_tpu_torch.decode import make_bimodal_greedy_fn
from bmt_tpu_torch.ops.lora import lora_frozen_predicate
from bmt_tpu_torch.parallel.launch import spawn
from tests import torch_port_dp as dpwork
from tests import torch_port_shard as work
from tests.test_torch_port_fsdp import CFG, PROP, cap_batch, prop_batch, \
    prop_params
from tests.torch_port_util import (PAD, SMALL, assert_jax_trees_close,
                                   assert_losses_close, dims_pair, features,
                                   jax_sharded_steps)

CAP = {**SMALL, 'N': 1, 'dout_p': 0.0, 'voc_size': 24}   # 24 splits over 4
LORA = {**SMALL, 'N': 1, 'dout_p': 0.0}                  # 23 does not
E = 4
ATTENTION = ('q2d', 'k2d', 'v2d', 'd2q')


def cap_params(dims, seed):
    return init_bimodal_transformer(jax.random.PRNGKey(seed), dims)


def jax_step(dims, kind='cap', **kw):
    if kind == 'prop':
        return lambda opt, mask, m: jsteps.make_prop_train_step(
            dims, opt, PAD, seq_mesh=m, frozen_mask=mask)
    return lambda opt, mask, m: jsteps.make_cap_train_step(
        dims, opt, work.SMOOTHING, PAD, frozen_mask=mask, **kw)


@pytest.fixture(scope='module')
def grids(tmp_path_factory):
    '''{label: (JAX (losses, params), rank 0's result, every rank's
    result)}, the unsharded run of the dp 2 x mp 4 job, the JAX mesh of
    that job and its parameters, and the save dir.'''
    save = tmp_path_factory.mktemp('mp')
    jcap, _ = dims_pair(**CAP)
    jmoe, _ = dims_pair(**CAP, moe_experts=E)
    jlora, _ = dims_pair(**LORA)
    pdims = jprop.PropModelDims(**PROP)
    params = {'mp4': cap_params(jcap, 3),
              'sp_mp2': prop_params(pdims, seed=6),
              'ep_mp2': cap_params(jmoe, 7),
              'lora_mp4': jadd_lora(cap_params(jlora, 8), 2,
                                    jax.random.PRNGKey(9),
                                    targets='attn_ffn')}
    decode_src = features(np.random.default_rng(81), 8, 6, 8, jcap,
                          pad_rows={3: (2, 5)})

    params['fsdp_mp2'] = params['mp4']

    def run(label, kind, dims, frozen, batches, **kw):
        return {'name': label, 'kind': kind, 'dims': dims,
                'tree': work.as_numpy(params[label]), 'cfg': CFG,
                'frozen': frozen, 'batches': batches, **kw}
    cap_batches = [cap_batch(90 + i, jcap) for i in range(2)]
    jobs = [
        {'label': 'mp4', 'grid': (2, 1, 1, 4), 'fsdp': False,
         'min_elems': 0, 'save_dir': str(save),
         'runs': [run('mp4', 'cap', CAP, dpwork.nothing, cap_batches,
                      shapes=True, decode=decode_src)]},
        {'label': 'fsdp_mp2', 'grid': (4, 1, 1, 2), 'fsdp': True,
         'min_elems': 0,
         'runs': [run('fsdp_mp2', 'cap', CAP, dpwork.nothing,
                      cap_batches)]},
        {'label': 'sp_mp2', 'grid': (2, 2, 1, 2), 'fsdp': False,
         'min_elems': 0,
         'runs': [run('sp_mp2', 'prop', PROP, dpwork.dp_frozen_anchors,
                      [prop_batch(95 + i, pdims) for i in range(2)])]},
        {'label': 'ep_mp2', 'grid': (2, 1, 2, 2), 'fsdp': False,
         'min_elems': 0,
         'runs': [run('ep_mp2', 'cap', {**CAP, 'moe_experts': E},
                      dpwork.nothing, cap_batches, shapes=True)]},
        {'label': 'lora_mp4', 'grid': (2, 1, 1, 4), 'fsdp': False,
         'min_elems': 0,
         'runs': [run('lora_mp4', 'cap', LORA, lora_frozen_predicate,
                      [cap_batch(97 + i, jlora) for i in range(2)],
                      shapes=True)]}]
    path = save / 'jobs.pkl'
    with open(path, 'wb') as f:
        pickle.dump(jobs, f)
    with ThreadPoolExecutor(1) as pool:
        # the ranks run while JAX compiles its steps
        ranks = pool.submit(spawn, work.shard_grids, (str(path),), 8, 'cpu')
        plain = work.unsharded({**jobs[0], 'save_dir': str(save)})
        meshes = {'mp4': JaxDataParallel(2, mp=4),
                  'sp_mp2': JaxDataParallel(2, sp=2),
                  'ep_mp2': JaxDataParallel(2, ep=2, mp=2),
                  'lora_mp4': JaxDataParallel(2, mp=4)}
        steps = {'mp4': jax_step(jcap), 'sp_mp2': jax_step(pdims, 'prop'),
                 'ep_mp2': jax_step(jmoe, moe_aux_coeff=0.01),
                 'lora_mp4': jax_step(jlora)}
        jax_out = {}
        for job in jobs:
            label, r = job['label'], job['runs'][0]
            if label in meshes:
                jax_out[label] = jax_sharded_steps_mp(
                    steps[label], params[label], r['frozen'], r['batches'],
                    meshes[label])
        jax_out['fsdp_mp2'] = jax_out['mp4']
        ranks = ranks.result()
    out = {job['label']: (jax_out[job['label']],
                          ranks[0][job['label']][job['label']],
                          [r[job['label']] for r in ranks])
           for job in jobs}
    return out, plain, params, save


def jax_sharded_steps_mp(make_step, params, frozen, batches, mesh_dp):
    '''``torch_port_util.jax_sharded_steps`` with the parameters placed by
    ``place_params`` (the mp rules, fsdp as the grid asks) and the step
    given the mesh (the proposal step's ``seq_mesh``).'''
    return jax_sharded_steps(
        lambda opt, mask: make_step(opt, mask, mesh_dp.mesh), params, CFG,
        frozen, batches, mesh_dp, place=True)


@pytest.mark.parametrize('label', ['mp4', 'fsdp_mp2', 'sp_mp2', 'ep_mp2',
                                   'lora_mp4'])
def test_mp_steps_match_the_jax_place_params_step(grids, label):
    out, _, _, _ = grids
    (losses, params), mine, ranks = out[label]
    assert {r['backend'] for r in ranks} == {'gloo'}
    assert_losses_close(mine['losses'], losses)
    assert_jax_trees_close(mine['tree'], params)


def test_mp_grid_coordinates_follow_the_jax_mesh_order(grids):
    '''Rank r sits at unravel(r, (dp, sp, ep, mp)).'''
    out, _, _, _ = grids
    ranks = out['sp_mp2'][2]
    assert [r['coords'] for r in ranks] == [
        tuple(int(i) for i in np.unravel_index(r, (2, 2, 1, 2)))
        for r in range(8)]


@pytest.mark.parametrize('label', ['mp4', 'ep_mp2', 'lora_mp4'])
def test_mp_shard_shapes_match_cap_param_shardings(grids, label):
    '''Every leaf a rank holds has the shape of its JAX shard under
    ``cap_param_shardings`` over the same mesh, but the attention
    projections when H (2) does not divide mp (4): the port keeps those
    whole, the JAX guard splits their d_model columns.'''
    out, _, params, _ = grids
    grid = {'mp4': (2, 1, 1, 4), 'ep_mp2': (2, 1, 2, 2),
            'lora_mp4': (2, 1, 1, 4)}[label]
    mesh = make_mesh(dp=grid[0], sp=grid[1], ep=grid[2], mp=grid[3])
    shardings = cap_param_shardings(params[label], mesh)
    # lora_s (replicated in JAX) is a buffer of the port's linear
    leaves = [(path, leaf, sh) for (path, leaf), sh in zip(
        jax.tree_util.tree_flatten_with_path(params[label])[0],
        jax.tree_util.tree_leaves(shardings))
        if getattr(path[-1], 'key', None) != 'lora_s']
    split_heads = 2 % grid[3] == 0
    departures = 0
    for r in out[label][2]:
        held = r[label]['rank']['shapes']
        assert len(held) == len(leaves)
        for path, leaf, sh in leaves:
            key = '/'.join(str(getattr(k, 'key', getattr(k, 'idx', None)))
                           for k in path)
            want = sh.shard_shape(leaf.shape)
            if not split_heads and set(key.split('/')) & set(ATTENTION):
                assert held[key] == leaf.shape, key
                departures += want != leaf.shape
            else:
                assert held[key] == want, key
    assert (departures > 0) == (not split_heads)


def test_mp_rank_holds_about_1_over_mp_of_the_split_leaves(grids):
    '''Under dp 4 x mp 2 with --fsdp every leaf is cut (its mp block over
    dp), so a rank holds about 1/8 of the bytes; under dp 2 x mp 4 the
    split leaves' bytes are a quarter of theirs whole.'''
    out, _, _, _ = grids
    for r in out['fsdp_mp2'][2]:
        mine = r['fsdp_mp2']['rank']
        assert mine['held']['whole'] == 0
        assert mine['bytes'] <= mine['whole_bytes'] / 8 + 4 * 1024
    for r in out['mp4'][2]:
        mine = r['mp4']['rank']
        assert mine['bytes'] < mine['whole_bytes']
        assert mine['held']['whole'] > 0          # norms, embedders, heads


def test_mp_greedy_decode_with_sharded_parameters(grids):
    '''The greedy decode with each rank's mp blocks gives the whole
    model's tokens, and its step log-probs along the whole model's
    trajectory are the unsharded run's within 1e-5.'''
    from bmt_tpu_torch.models import BiModalTransformer, CapModelDims
    from bmt_tpu_torch.params import load_jax_params
    out, plain, _, _ = grids
    decode_src = features(np.random.default_rng(81), 8, 6, 8,
                          dims_pair(**CAP)[0], pad_rows={3: (2, 5)})
    model = BiModalTransformer(CapModelDims(**CAP), device='cpu')
    load_jax_params(model, plain['mp4']['tree'])
    stacks = {k: torch.from_numpy(v) for k, v in decode_src.items()}
    with torch.no_grad():
        tokens = make_bimodal_greedy_fn(model.dims, 6, 2, 3, PAD)(
            model.eval(), stacks).numpy()
    want = work.step_logprobs(model, stacks, tokens)
    for r in out['mp4'][2]:
        res = r['mp4']
        np.testing.assert_array_equal(res['decode'], tokens)
        np.testing.assert_array_equal(res['decode_mp'], tokens)
        np.testing.assert_allclose(res['logprobs_mp'], want, atol=1e-5)


def test_mp_checkpoint_is_the_unsharded_runs_key_for_key(grids):
    '''The npz and ``.opt.npz`` rank 0 writes under dp 2 x mp 4 hold the
    unsharded run's keys, shapes and dtypes, and its values within the
    parity tolerance; the JAX package loads the parameters.'''
    _, plain, params, save = grids
    for suffix in ('params', 'opt'):
        with np.load(save / 'mp4' / f'last.{suffix}.npz') as a, \
                np.load(save / 'mp4_plain' / f'last.{suffix}.npz') as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].shape == b[k].shape and \
                    a[k].dtype == b[k].dtype, k
                np.testing.assert_allclose(a[k], b[k], atol=2e-6,
                                           err_msg=k)
    loaded, meta, _ = jckpt.load_checkpoint(str(save / 'mp4'),
                                            params['mp4'], name='last')
    assert meta['step'] == 2
    assert_jax_trees_close(loaded, plain['mp4']['tree'], atol=2e-6)


def test_mp_lora_moves_only_the_adapters(grids):
    '''Under the LoRA frozen predicate only lora_a and lora_b leaves move
    over the two steps; the base weights are the JAX tree's bit for bit.'''
    out, _, params, _ = grids
    tree = out['lora_mp4'][1]['tree']
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    base = jax.tree_util.tree_leaves(params['lora_mp4'])
    moved = [path[-1].key for (path, a), b in zip(got, base)
             if not np.array_equal(np.asarray(a), np.asarray(b))]
    assert moved and set(moved) <= {'lora_a', 'lora_b'}
