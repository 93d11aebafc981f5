'''``--fsdp`` (ZeRO-3) in the port against the JAX package, on the CPU: two
gloo processes (``parallel.launch.spawn``) shard every leaf
(``fsdp_min_elems=0``) of the captioner (its GloVe-like table frozen) and
of the proposal generator (its anchors frozen) over dp = 2, and their train
steps give the JAX package's fsdp steps on the conftest's virtual CPU
devices (``DataParallel(2, fsdp=True)``, ``place_params(...,
fsdp_min_elems=0)``) within the dp parity's tolerances (fp32, dropout 0:
losses rtol 2e-5, parameters 2e-6). A rank holds about half the bytes;
the directory it writes is an unsharded run's, key for key, loads in the
JAX package, and an unsharded run's directory resumes under fsdp; and
``python -m bmt_tpu_torch --fsdp --dp_devices 2`` runs train_cap then
train_prop.'''
import json
import pickle
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bmt_tpu.models import proposal as jprop
from bmt_tpu.parallel import DataParallel as JaxDataParallel
from bmt_tpu.train import checkpoint as jckpt
from bmt_tpu.train import steps as jsteps
from bmt_tpu_torch import __main__ as cli
from bmt_tpu_torch.parallel.launch import spawn
from tests import torch_port_dp as dpwork
from tests import torch_port_shard as work
from tests.torch_port_tree import mini_argv, mini_tree
from tests.torch_port_util import (PAD, SMALL, assert_jax_trees_close,
                                   assert_losses_close, features,
                                   jax_and_torch_model, jax_sharded_steps)

CFG = types.SimpleNamespace(optimizer='adam', lr=1e-3, grad_clip=1.0,
                            weight_decay=1e-4, beta1=0.9, beta2=0.999,
                            eps=1e-4, momentum=0.0)
B = 8
PROP = dict(d_model_A=8, d_model_V=16, d_model=16, H=2, N=1, d_ff_A=16,
            d_ff_V=24, dout_p=0.0, d_vid=20, d_aud=6,
            use_linear_embedder=True, kernel_sizes_A=(3, 5),
            kernel_sizes_V=(1, 3), conv_layers_A=(8,), conv_layers_V=(8,),
            anchors_num_A=3, anchors_num_V=4)
PSA, PSV, PE = 40, 16, 5


def cap_batch(seed, dims, b=B):
    rng = np.random.default_rng(seed)
    src = features(rng, b, 6, 8, dims, pad_rows={1: (4, 5)})
    caps = rng.integers(4, dims.voc_size, size=(b, 7)).astype(np.int32)
    caps[:, 0] = 2
    caps[1, 5:] = PAD
    return {'src': src, 'caption': caps}


def prop_batch(seed, dims, sa=PSA, sv=PSV, b=B):
    rng = np.random.default_rng(seed)
    src = {'rgb': rng.normal(size=(b, sv, dims.d_vid)).astype(np.float32),
           'flow': rng.normal(size=(b, sv, dims.d_vid)).astype(np.float32),
           'audio': rng.normal(size=(b, sa, dims.d_aud)).astype(np.float32)}
    src['rgb'][1, sv // 2:] = PAD
    src['flow'][1, sv // 2:] = 0.0
    src['audio'][1, sa // 2:] = PAD
    return {'src': src,
            'centers': rng.uniform(-2, sa * dims.stride_A + 2,
                                   size=(b, PE)).astype(np.float32),
            'lengths': rng.uniform(0.5, 30, size=(b, PE)).astype(np.float32),
            'valid': np.arange(PE)[None, :] < rng.integers(1, PE + 1,
                                                           size=(b, 1))}


def prop_params(dims, seed=7):
    params = jprop.init_multimodal_proposal_generator(
        jax.random.PRNGKey(seed), dims)
    params['anchors_A'] = jnp.asarray([2.0, 6.0, 15.0])
    params['anchors_V'] = jnp.asarray([3.0, 9.0, 20.0, 40.0])
    return params


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    '''The JAX package's fsdp steps, the port's over two ranks, and the
    port's unsharded steps, on the same parameters and global batches:
    (jax, port ranks, unsharded, save dir).'''
    jdims, cap_params, _ = jax_and_torch_model(seed=3, dout_p=0.0)
    pdims = jprop.PropModelDims(**PROP)
    pparams = prop_params(pdims)
    save = tmp_path_factory.mktemp('fsdp')
    runs_ = [{'name': 'cap', 'kind': 'cap', 'dims': {**SMALL, 'dout_p': 0.0},
              'tree': work.as_numpy(cap_params), 'cfg': CFG,
              'frozen': dpwork.dp_frozen_table, 'ema': True,
              'batches': [cap_batch(10 + i, jdims) for i in range(2)],
              'next': cap_batch(12, jdims),
              'resume_from': str(save / 'cap_plain')},
             {'name': 'prop', 'kind': 'prop', 'dims': PROP,
              'tree': work.as_numpy(pparams), 'cfg': CFG,
              'frozen': dpwork.dp_frozen_anchors,
              'batches': [prop_batch(20 + i, pdims) for i in range(2)]}]
    job = {'grid': (2, 1, 1), 'fsdp': True, 'min_elems': 0,
           'save_dir': str(save), 'runs': runs_}
    plain = work.unsharded(job)
    path = save / 'job.pkl'
    with open(path, 'wb') as f:
        pickle.dump(job, f)
    ranks = spawn(work.shard_steps, (str(path),), 2, 'cpu')

    jdp = JaxDataParallel(2, fsdp=True)
    out = {'cap': jax_sharded_steps(
        lambda opt, mask: jsteps.make_cap_train_step(
            jdims, opt, work.SMOOTHING, PAD, frozen_mask=mask, ema_decay=0.0),
        cap_params, CFG, dpwork.dp_frozen_table, runs_[0]['batches'], jdp,
        place=True),
        'prop': jax_sharded_steps(
        lambda opt, mask: jsteps.make_prop_train_step(
            pdims, opt, PAD, frozen_mask=mask),
        pparams, CFG, dpwork.dp_frozen_anchors, runs_[1]['batches'], jdp,
        place=True)}
    return out, ranks, plain, save


@pytest.mark.parametrize('name', ['cap', 'prop'])
def test_fsdp_steps_match_the_jax_fsdp_step(runs, name):
    jax_out, ranks, _, _ = runs
    assert [r['rank'] for r in ranks] == [0, 1]
    assert {r['backend'] for r in ranks} == {'gloo'}
    losses, params = jax_out[name]
    assert_losses_close(ranks[0][name]['losses'], losses)
    assert_jax_trees_close(ranks[0][name]['tree'], params)


@pytest.mark.parametrize('name', ['cap', 'prop'])
def test_fsdp_rank_holds_half_of_the_sharded_bytes(runs, name):
    '''Every leaf is at least fsdp_min_elems (0) here, so each rank's
    parameters are the whole's halves, padded to an even count: about
    1/dp of the bytes; its Adam moments and EMA are halves too.'''
    _, ranks, _, _ = runs
    for r in ranks:
        mine = r[name]['rank']
        assert mine['held']['whole'] == 0
        assert mine['bytes'] <= mine['whole_bytes'] / 2 + 4 * 1024
        assert mine['bytes'] >= mine['whole_bytes'] / 2
        # parameters, two moments for the trainable leaves, and the EMA
        assert mine['held']['sharded'] <= 4.1 * mine['bytes']


def test_fsdp_checkpoint_is_the_unsharded_runs_key_for_key(runs):
    '''The npz and the optax-layout ``.opt.npz`` rank 0 writes under fsdp
    hold the unsharded run's keys, shapes and dtypes, and its values
    within the parity tolerance; the JAX package loads both.'''
    _, _, plain, save = runs
    for name in ('cap', 'prop'):
        for suffix in ('params', 'opt'):
            with np.load(save / name / f'last.{suffix}.npz') as a, \
                    np.load(save / f'{name}_plain' / f'last.{suffix}.npz') \
                    as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    assert a[k].shape == b[k].shape and \
                        a[k].dtype == b[k].dtype, k
                    np.testing.assert_allclose(a[k], b[k], atol=2e-6,
                                               err_msg=k)
    jdims, cap_params, _ = jax_and_torch_model(seed=3, dout_p=0.0)
    params, meta, _ = jckpt.load_checkpoint(str(save / 'cap'), cap_params,
                                            name='last')
    assert meta['step'] == 2
    assert_jax_trees_close(params, plain['cap']['tree'], atol=2e-6)


def test_fsdp_resumes_an_unsharded_directory(runs):
    '''The unsharded run's directory (weights and Adam moments) loads
    into the sharded state and its next step is the unsharded run's.'''
    _, ranks, plain, _ = runs
    assert_jax_trees_close(ranks[0]['cap']['resumed'], plain['cap']['next'],
                           atol=2e-6)


def test_fsdp_cli_chain_train_cap_then_train_prop(tmp_path, monkeypatch):
    '''train_cap --fsdp --dp_devices 2 (two spawned gloo ranks), then
    train_prop --fsdp --dp_devices 2 from its captioner: each writes its
    checkpoints with the optimizer state, and evaluate in one process
    scores the fsdp captioner.'''
    monkeypatch.chdir(tmp_path)
    (tmp_path / 'tree').mkdir()
    tree = mini_tree(tmp_path / 'tree')
    log = tmp_path / 'log'

    def run(procedure, **flags):
        return cli.main(mini_argv(tree, log, procedure, device='cpu',
                                  **flags))
    kw = dict(fsdp=None, fsdp_min_elems=1024, dp_devices=2)
    run('train_cap', exper_name='cap', **kw)
    cap = log / 'train_cap' / 'cap'
    with open(cap / 'last_cap_model.meta.json') as f:
        meta = json.load(f)
    assert meta['config']['fsdp'] and meta['step'] == 2
    assert (cap / 'last_cap_model.opt.npz').exists()
    run('train_prop', exper_name='prop', pretrained_cap_model_path=cap,
        **kw)
    assert (log / 'train_prop' / 'prop' / 'last_prop_model.opt.npz'
            ).exists()
    run('evaluate', pretrained_cap_model_path=cap,
        prop_pred_path=tree / 'val_1.json')
    assert (cap / 'captioning_results_learned_props_e0.json').exists()
