'''Sequence parallelism (``--sp_devices``) in the port against the JAX
package, on the CPU: four gloo processes form a dp = 2 x sp = 2 grid; each
holds its rows' block of every feature sequence that splits (40 audio rows
into 20 + 20; 15 video rows do not split and stay whole, as the JAX
package leaves them), and the bi-modal (its encoder's layers recomputed in
the backward) and uni-modal (audio) proposal generators' train steps give the JAX package's step over
``DataParallel(2, sp=2)`` with its ``seq_mesh`` on the conftest's virtual
CPU devices (fp32, dropout 0: losses rtol 2e-5, parameters 2e-6), and
the bi-modal one with ``--fsdp`` too (dp shards replicated over sp) the
``DataParallel(2, sp=2, fsdp=True)`` step. The encoder's output has S/sp rows on each rank, validation's predictions are
gathered whole in sequence order (the unsharded model's), and ``python -m
bmt_tpu_torch --procedure train_prop --sp_devices 2`` runs after a
train_cap that the flag leaves alone.'''
import json
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bmt_tpu.models import proposal as jprop
from bmt_tpu.parallel import DataParallel as JaxDataParallel
from bmt_tpu.train import steps as jsteps
from bmt_tpu_torch import __main__ as cli
from bmt_tpu_torch.parallel.launch import spawn
from tests import torch_port_dp as dpwork
from tests import torch_port_shard as work
from tests.test_torch_port_fsdp import CFG, PROP, prop_batch, prop_params
from tests.torch_port_tree import mini_argv, mini_tree
from tests.torch_port_util import (PAD, assert_jax_trees_close,
                                   assert_losses_close, jax_sharded_steps)

SA, SV = 40, 15                 # audio splits over sp = 2, video does not
BI = {**PROP, 'remat': True}    # the encoder's layers recomputed
UNI = {**PROP, 'modality': 'audio'}


def uni_batch(seed, dims):
    batch = prop_batch(seed, dims, SA, SV)
    batch['src'] = {'audio': batch['src']['audio']}
    return batch


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    '''(JAX steps by generator, the port's four ranks, the unsharded
    runs).'''
    bdims = jprop.PropModelDims(**BI)
    udims = jprop.PropModelDims(**UNI)
    bparams = prop_params(bdims, seed=8)
    uparams = jprop.init_unimodal_proposal_generator(jax.random.PRNGKey(9),
                                                     udims)
    uparams['anchors'] = jnp.asarray([2.0, 6.0, 15.0])
    runs_ = [{'name': 'bi', 'kind': 'prop', 'dims': BI,
              'tree': work.as_numpy(bparams), 'cfg': CFG,
              'frozen': dpwork.dp_frozen_anchors,
              'batches': [prop_batch(50 + i, bdims, SA, SV)
                          for i in range(2)],
              'predict': prop_batch(52, bdims, SA, SV)['src']},
             {'name': 'uni', 'kind': 'prop', 'dims': UNI,
              'tree': work.as_numpy(uparams), 'cfg': CFG,
              'frozen': dpwork.dp_frozen_anchors,
              'batches': [uni_batch(60 + i, udims) for i in range(2)],
              'predict': uni_batch(62, udims)['src']}]
    runs_.append({**runs_[0], 'name': 'bi_fsdp', 'fsdp': True})
    del runs_[-1]['predict']
    job = {'grid': (2, 2, 1), 'fsdp': False, 'min_elems': 0,
           'runs': runs_}
    plain = work.unsharded(job)
    path = tmp_path_factory.mktemp('sp') / 'job.pkl'
    with open(path, 'wb') as f:
        pickle.dump(job, f)
    ranks = spawn(work.shard_steps, (str(path),), 4, 'cpu')

    jax_out = {}
    for name, dims, params, fsdp in (('bi', bdims, bparams, False),
                                     ('uni', udims, uparams, False),
                                     ('bi_fsdp', bdims, bparams, True)):
        jdp = JaxDataParallel(2, sp=2, fsdp=fsdp)
        jax_out[name] = jax_sharded_steps(
            lambda opt, mask, d=dims, m=jdp.mesh: jsteps.make_prop_train_step(
                d, opt, PAD, seq_mesh=m, frozen_mask=mask),
            params, CFG, dpwork.dp_frozen_anchors,
            runs_[0 if name != 'uni' else 1]['batches'], jdp, place=fsdp)
    return jax_out, ranks, plain


@pytest.mark.parametrize('name', ['bi', 'uni', 'bi_fsdp'])
def test_sp_steps_match_the_jax_sp_step(runs, name):
    jax_out, ranks, _ = runs
    assert [r['coords'] for r in ranks] == [(0, 0, 0), (0, 1, 0),
                                            (1, 0, 0), (1, 1, 0)]
    losses, params = jax_out[name]
    assert_losses_close(ranks[0][name]['losses'], losses)
    assert_jax_trees_close(ranks[0][name]['tree'], params)


@pytest.mark.parametrize('name,rows', [('bi', [SA // 2, SV]),
                                       ('uni', [SA // 2])])
def test_sp_encoder_output_has_the_blocks_rows(runs, name, rows):
    '''A forward hook on the encoder sees S/sp rows of the split audio on
    every rank, and the whole 15 video rows.'''
    _, ranks, _ = runs
    for r in ranks:
        assert r[name]['rank']['encoder_rows'] == rows


@pytest.mark.parametrize('name', ['bi', 'uni'])
def test_sp_predictions_are_gathered_whole(runs, name):
    '''Validation's predictions over the grid (each rank its rows' sequence
    block, gathered in sequence order, then rows over dp) are the unsharded
    model's.'''
    _, ranks, plain = runs
    want = plain[name]['predictions']
    for r in ranks:
        got = r[name]['predictions']
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_sp_cli_train_prop(tmp_path, monkeypatch):
    '''train_cap with --sp_devices 2 runs in one process (the flag acts in
    train_prop only, as in the JAX package); train_prop --sp_devices 2
    from it spawns two ranks and writes its checkpoints and predictions,
    alone and with --fsdp.'''
    monkeypatch.chdir(tmp_path)
    (tmp_path / 'tree').mkdir()
    tree = mini_tree(tmp_path / 'tree')
    log = tmp_path / 'log'

    def run(procedure, **flags):
        return cli.main(mini_argv(tree, log, procedure, device='cpu',
                                  sp_devices=2, **flags))
    run('train_cap', exper_name='cap')
    cap = log / 'train_cap' / 'cap'
    for name, flags in (('prop', {}),
                        ('prop_fsdp', {'fsdp': None,
                                       'fsdp_min_elems': 1024})):
        run('train_prop', exper_name=name, pretrained_cap_model_path=cap,
            **flags)
        prop = log / 'train_prop' / name
        with open(prop / 'last_prop_model.meta.json') as f:
            meta = json.load(f)
        assert meta['config']['sp_devices'] == 2 and meta['step'] == 2
        assert meta['config']['fsdp'] == (name == 'prop_fsdp')
        assert (prop / 'last_prop_model.opt.npz').exists()
        assert list((prop / 'submissions').glob(
            'prop_results_val_1_e0_*.json'))


def test_sp_group_is_seen_from_another_thread():
    '''The autograd engine runs the backward, and the recompute of a
    checkpointed layer, on a thread of its own on the card: the step's sp
    group is process-wide, so that thread sees it.'''
    import threading
    from bmt_tpu_torch.parallel import seq
    from bmt_tpu_torch.parallel.mesh import Group
    group, seen = Group(None, 2, 1), []
    with seq.sequence_parallel(group):
        t = threading.Thread(target=lambda: seen.append(seq.active()))
        t.start()
        t.join()
        assert seq.offset(20, 40) == 20
    assert seen == [group] and seq.active() is None
