'''Expert parallelism (``--ep_devices``) in the port against the JAX package,
on the CPU: four gloo processes form a dp = 2 x ep = 2 grid; each holds 2
of the MoE captioner's 4 experts a layer, the ep ranks of a row block run
their experts on the tokens routed to them, and their train steps (two
microbatches a step, the Switch loss on) give the JAX package's step over
``DataParallel(2, ep=2)`` with ``place_params`` on the conftest's virtual
CPU devices (fp32, dropout 0: losses rtol 2e-5, parameters 2e-6), and
with ``--fsdp`` too (the other large leaves split over dp) the JAX
package's ``DataParallel(2, ep=2, fsdp=True)`` step. The greedy decode over the grid is the unsharded model's, the directory rank 0
writes is an unsharded run's key for key (experts whole, leading axis E)
and loads in the JAX package; ``--moe_experts`` not divisible by
``--ep_devices`` raises the JAX package's ValueError; and ``python -m
bmt_tpu_torch --procedure train_cap --moe_experts 4 --ep_devices 2`` runs,
its captioner scored by evaluate in one process.'''
import json
import pickle

import numpy as np
import pytest
import torch

from bmt_tpu.parallel import DataParallel as JaxDataParallel
from bmt_tpu.train import checkpoint as jckpt
from bmt_tpu.train import steps as jsteps
from bmt_tpu_torch import __main__ as cli
from bmt_tpu_torch.config import Config, build_parser
from bmt_tpu_torch.decode import make_bimodal_greedy_fn
from bmt_tpu_torch.parallel.launch import spawn
from tests import torch_port_dp as dpwork
from tests import torch_port_shard as work
from tests.test_torch_port_fsdp import CFG, cap_batch
from tests.torch_port_tree import mini_argv, mini_tree
from tests.torch_port_util import (PAD, SMALL, assert_jax_trees_close,
                                   assert_losses_close, features,
                                   jax_and_torch_model, jax_sharded_steps)

E, ACCUM, AUX = 4, 2, 0.05


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    '''(JAX steps, the port's four ranks, the unsharded run, save dir,
    the unsharded model's greedy decode).'''
    mdims, params, model = jax_and_torch_model(seed=4, dout_p=0.0,
                                               moe_experts=E)
    save = tmp_path_factory.mktemp('ep')
    decode_src = features(np.random.default_rng(41), 8, 6, 8, mdims,
                          pad_rows={3: (2, 5)})
    run = {'name': 'moe', 'kind': 'cap',
           'dims': {**SMALL, 'dout_p': 0.0, 'moe_experts': E},
           'tree': work.as_numpy(params), 'cfg': CFG,
           'frozen': dpwork.nothing,
           'step_kw': {'accum_steps': ACCUM, 'moe_aux_coeff': AUX},
           'batches': [cap_batch(30 + i, mdims) for i in range(2)],
           'decode': decode_src}
    with_fsdp = {**run, 'name': 'moe_fsdp', 'fsdp': True}
    del with_fsdp['decode']
    job = {'grid': (2, 1, 2), 'fsdp': False, 'min_elems': 0,
           'save_dir': str(save), 'runs': [run, with_fsdp]}
    plain = work.unsharded(job)
    path = save / 'job.pkl'
    with open(path, 'wb') as f:
        pickle.dump(job, f)
    ranks = spawn(work.shard_steps, (str(path),), 4, 'cpu')

    from bmt_tpu_torch.params import load_jax_params
    load_jax_params(model, plain['moe']['tree'])
    greedy = make_bimodal_greedy_fn(model.dims, 6, 2, 3, PAD)
    with torch.no_grad():
        tokens = greedy(model.eval(), {k: torch.from_numpy(v)
                                       for k, v in decode_src.items()})
    jax_out = {name: jax_sharded_steps(
        lambda opt, mask: jsteps.make_cap_train_step(
            mdims, opt, work.SMOOTHING, PAD, accum_steps=ACCUM,
            moe_aux_coeff=AUX, frozen_mask=mask),
        params, CFG, dpwork.nothing, run['batches'],
        JaxDataParallel(2, ep=2, fsdp=fsdp), place=True)
        for name, fsdp in (('moe', False), ('moe_fsdp', True))}
    return jax_out, ranks, plain, save, tokens.numpy()


@pytest.mark.parametrize('name', ['moe', 'moe_fsdp'])
def test_ep_steps_match_the_jax_ep_step(runs, name):
    jax_out, ranks, _, _, _ = runs
    losses, params = jax_out[name]
    assert [r['coords'] for r in ranks] == [(0, 0, 0), (0, 0, 1),
                                            (1, 0, 0), (1, 0, 1)]
    assert {r['backend'] for r in ranks} == {'gloo'}
    assert_losses_close(ranks[0][name]['losses'], losses)
    assert_jax_trees_close(ranks[0][name]['tree'], params)
    if name == 'moe_fsdp':
        # the experts' ep blocks and the other leaves' dp shards
        for r in ranks:
            held = r[name]['rank']['held']
            assert held['whole'] < held['sharded'] / 50


def test_ep_rank_holds_its_block_of_experts(runs):
    '''Each rank's MoE FFNs hold E/ep = 2 experts (its bytes of them half
    the whole's); the router and every other leaf stay whole.'''
    _, ranks, _, _, _ = runs
    for r in ranks:
        mine = r['moe']['rank']
        assert mine['experts'] and set(mine['experts']) == {E // 2}
        held = mine['held']
        assert mine['whole_bytes'] - mine['bytes'] == held['sharded'] // 3


def test_ep_greedy_decode_is_the_unsharded_models(runs):
    '''Validation's decode over the grid (rows over dp, experts over ep,
    the lossless MoE form) gives the unsharded model's tokens.'''
    _, ranks, _, _, tokens = runs
    for r in ranks:
        np.testing.assert_array_equal(r['moe']['decode'], tokens)


def test_ep_checkpoint_is_the_unsharded_runs_key_for_key(runs):
    _, _, plain, save, _ = runs
    for suffix in ('params', 'opt'):
        with np.load(save / 'moe' / f'last.{suffix}.npz') as a, \
                np.load(save / 'moe_plain' / f'last.{suffix}.npz') as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].shape == b[k].shape, k
                np.testing.assert_allclose(a[k], b[k], atol=2e-6, err_msg=k)
            assert any(k.endswith('experts/w1') and a[k].shape[0] == E
                       for k in a.files)
    _, params, _ = jax_and_torch_model(seed=4, dout_p=0.0, moe_experts=E)
    loaded, _, _ = jckpt.load_checkpoint(str(save / 'moe'), params,
                                         name='last')
    assert_jax_trees_close(loaded, plain['moe']['tree'], atol=2e-6)


def test_ep_needs_experts_divisible_by_ep_devices(tmp_path):
    from bmt_tpu_torch.train.cap_trainer import train_cap
    cfg = Config(build_parser().parse_args(mini_argv(
        tmp_path, tmp_path, 'train_cap', moe_experts=3, ep_devices=2)))
    with pytest.raises(ValueError, match='--ep_devices 2 requires '
                                         '--moe_experts divisible by it'):
        train_cap(cfg, 'cpu')


def test_ep_cli_train_cap_then_evaluate(tmp_path, monkeypatch):
    '''train_cap --moe_experts 4 --ep_devices 2 spawns two ranks (one row
    block, the experts split), writes the whole experts, and evaluate
    scores that captioner in one process.'''
    monkeypatch.chdir(tmp_path)
    (tmp_path / 'tree').mkdir()
    tree = mini_tree(tmp_path / 'tree')
    log = tmp_path / 'log'

    def run(procedure, **flags):
        return cli.main(mini_argv(tree, log, procedure, device='cpu',
                                  **flags))
    run('train_cap', exper_name='cap', moe_experts=4, ep_devices=2)
    cap = log / 'train_cap' / 'cap'
    with open(cap / 'last_cap_model.meta.json') as f:
        meta = json.load(f)
    # one row block: the global batch is B = 4, as without --ep_devices
    assert meta['config']['ep_devices'] == 2
    assert meta['config']['train_batch_size'] == 4
    with np.load(cap / 'last_cap_model.params.npz') as z:
        w1 = [k for k in z.files if k.endswith('experts/w1')]
        assert w1 and all(z[k].shape[0] == 4 for k in w1)
    run('evaluate', pretrained_cap_model_path=cap,
        prop_pred_path=tree / 'val_1.json', ep_devices=2)
    assert (cap / 'captioning_results_learned_props_e0.json').exists()


def test_ep_group_sum_has_the_backward_of_a_sum(runs):
    '''``CopyToGroup`` then ``ReduceFromGroup`` over the two ep ranks
    (each rank's term w_r x, w_r = r + 1): y = 3x on both, dL/dx the sum
    of the ranks' partial gradients (3c, not 6c as an all-reduce of dL/dy
    in the backward would give), dL/dw_r = sum(c x) on each.'''
    _, ranks, _, _, _ = runs
    x = np.arange(1.0, 7.0).reshape(2, 3)
    c = np.array([[1.0, -2.0, 3.0], [0.5, 4.0, -1.0]])
    for r in ranks:
        y, dx, dw = r['ep_sum']
        np.testing.assert_allclose(y, 3 * x)
        np.testing.assert_allclose(dx, 3 * c)
        np.testing.assert_allclose(dw, (c * x).sum())
