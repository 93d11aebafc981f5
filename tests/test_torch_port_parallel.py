'''Data parallelism in the port against the JAX package, on the CPU: two gloo
processes (as tests/test_multiprocess.py runs two JAX processes) each take
half of a global batch, and their captioner (dense, and MoE with two
microbatches a step) and proposal train steps give the JAX package's
single-process steps on that global batch (fp32, dropout 0: the losses
within rtol 2e-5 and the parameters within 2e-6, the single-process parity
tests' tolerances); ``local_rows`` is the JAX package's row block; a seeded
sampler over the two ranks, and the serving engine over two replicas,
greedy and sampling, give one process's tokens exactly; and tensor
parallelism, which is not ported, still raises.'''
import pickle
import threading
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bmt_tpu.models import proposal as jprop
from bmt_tpu.parallel import DataParallel as JaxDataParallel
from bmt_tpu.train import optim as joptim
from bmt_tpu.train import steps as jsteps
from bmt_tpu_torch import __main__ as cli
from bmt_tpu_torch.config import Config, build_parser
from bmt_tpu_torch.data import Vocab
from bmt_tpu_torch.decode import make_bimodal_sample_fn
from bmt_tpu_torch.parallel import DataParallel, replica_devices
from bmt_tpu_torch.parallel.launch import spawn
from bmt_tpu_torch.serve import CaptionEngine
from bmt_tpu_torch.train.options import check_ported
from tests import torch_port_dp as work
from tests.torch_port_tree import mini_argv, mini_tree
from tests.torch_port_util import (PAD, SMALL, assert_tree_close, features,
                                   jax_and_torch_model)

STEP_CFG = types.SimpleNamespace(optimizer='adam', lr=1e-3, grad_clip=1.0,
                                 weight_decay=1e-4, beta1=0.9, beta2=0.999,
                                 eps=1e-4, momentum=0.0)
B = 8                     # the global batch; 4 rows a rank
PROP = dict(d_model_A=8, d_model_V=16, d_model=16, H=2, N=1, d_ff_A=16,
            d_ff_V=24, dout_p=0.0, d_vid=20, d_aud=6,
            use_linear_embedder=True, kernel_sizes_A=(3, 5),
            kernel_sizes_V=(1, 3), conv_layers_A=(8,), conv_layers_V=(8,),
            anchors_num_A=3, anchors_num_V=4)
PSA, PSV, PE = 40, 16, 5


def _cap_batch(seed, dims):
    rng = np.random.default_rng(seed)
    src = features(rng, B, 6, 8, dims, pad_rows={1: (4, 5), 6: (2, 3)})
    caps = rng.integers(4, dims.voc_size, size=(B, 7)).astype(np.int32)
    caps[:, 0] = 2
    caps[1, 5:] = PAD                 # ranks with unequal token counts
    caps[2, 4] = 3
    caps[2, 3:] = PAD
    return {'src': src, 'caption': caps,
            'row_valid': np.arange(B) < B - 1}      # a padded tail row


def _prop_batch(seed, dims):
    rng = np.random.default_rng(seed)
    src = {'rgb': rng.normal(size=(B, PSV, dims.d_vid)).astype(np.float32),
           'flow': rng.normal(size=(B, PSV, dims.d_vid)).astype(np.float32),
           'audio': rng.normal(size=(B, PSA, dims.d_aud)).astype(np.float32)}
    src['rgb'][5, 10:] = PAD
    src['flow'][5, 10:] = 0.0
    src['audio'][5, 25:] = PAD
    return {'src': src,
            'centers': rng.uniform(-2, PSA * dims.stride_A + 2,
                                   size=(B, PE)).astype(np.float32),
            'lengths': rng.uniform(0.5, 30, size=(B, PE)).astype(np.float32),
            'valid': np.arange(PE)[None, :] < rng.integers(1, PE + 1,
                                                           size=(B, 1))}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    '''The JAX package's single-process steps and the port's dp=2 steps on
    the same parameters and global batches: (jax, port rank outputs).'''
    jdims, cap_params, _ = jax_and_torch_model(seed=3, dout_p=0.0)
    mdims, moe_params, _ = jax_and_torch_model(seed=4, dout_p=0.0,
                                               moe_experts=4)
    pdims = jprop.PropModelDims(**PROP)
    prop_params = jprop.init_multimodal_proposal_generator(
        jax.random.PRNGKey(7), pdims)
    prop_params['anchors_A'] = jnp.asarray([2.0, 6.0, 15.0])
    prop_params['anchors_V'] = jnp.asarray([3.0, 9.0, 20.0, 40.0])
    job = {'cfg': STEP_CFG,
           'cap_dims': {**SMALL, 'dout_p': 0.0}, 'prop_dims': PROP,
           'cap_tree': work.as_numpy(cap_params),
           'prop_tree': work.as_numpy(prop_params),
           'cap_frozen': work.dp_frozen_table,
           'prop_frozen': work.dp_frozen_anchors,
           'cap_batches': [_cap_batch(10 + i, jdims) for i in range(2)],
           'moe_dims': {**SMALL, 'dout_p': 0.0, 'moe_experts': 4},
           'moe_tree': work.as_numpy(moe_params),
           'moe_frozen': work.nothing,
           'moe_batches': [_cap_batch(30 + i, mdims) for i in range(2)],
           'sample_src': features(np.random.default_rng(40), B, 6, 8, jdims,
                                  pad_rows={3: (2, 5)}),
           'prop_batches': [_prop_batch(20 + i, pdims) for i in range(2)]}
    path = tmp_path_factory.mktemp('dp') / 'job.pkl'
    with open(path, 'wb') as f:
        pickle.dump(job, f)
    ranks = spawn(work.dp_steps, (str(path),), 2, 'cpu')

    out = {}
    for name, params, dims, frozen, make in (
            ('cap', cap_params, jdims, work.dp_frozen_table,
             lambda opt, mask: jsteps.make_cap_train_step(
                 jdims, opt, work.SMOOTHING, PAD, frozen_mask=mask)),
            ('moe', moe_params, mdims, work.nothing,
             lambda opt, mask: jsteps.make_cap_train_step(
                 mdims, opt, work.SMOOTHING, PAD,
                 accum_steps=work.MOE_ACCUM, moe_aux_coeff=work.MOE_AUX,
                 frozen_mask=mask)),
            ('prop', prop_params, pdims, work.dp_frozen_anchors,
             lambda opt, mask: jsteps.make_prop_train_step(
                 pdims, opt, PAD, frozen_mask=mask))):
        mask = joptim.freeze_mask(params, frozen)
        opt = joptim.build_optimizer(STEP_CFG, frozen_mask=mask)
        step = jax.jit(make(opt, mask))
        state = jsteps.init_train_state(params, opt)
        losses = []
        for batch in job[f'{name}_batches']:
            state, m = step(state, jax.tree.map(jnp.asarray, batch))
            losses.append({k: float(v) for k, v in m.items()})
        out[name] = {'losses': losses, 'params': state.params}
    return out, ranks


@pytest.mark.parametrize('name', ['cap', 'moe', 'prop'])
def test_dp2_steps_match_the_jax_single_process_step(runs, name):
    jax_out, ranks = runs
    assert [r['rank'] for r in ranks] == [0, 1]
    assert {r['backend'] for r in ranks} == {'gloo'}
    ours = ranks[0][name]
    for got, want in zip(ours['losses'], jax_out[name]['losses']):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=2e-5, err_msg=k)
    flat = jax.tree_util.tree_flatten_with_path(ours['tree'])[0]
    named = [(tuple(getattr(k, 'key', getattr(k, 'idx', None))
                    for k in path), torch.from_numpy(np.asarray(leaf)))
             for path, leaf in flat]
    # the tree is already in the JAX layout: compare it leaf for leaf
    want = jax.tree_util.tree_flatten_with_path(jax_out[name]['params'])[0]
    assert len(named) == len(want)
    for (path, got), (_, w) in zip(named, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=2e-6,
                                   err_msg=str(path))


def test_local_rows_are_the_jax_row_blocks(runs):
    '''Rank r's rows are those of the r-th device of the JAX package's
    2-way dp mesh (one device a process, as on a pod).'''
    _, ranks = runs
    jdp = JaxDataParallel(2)
    for B_ in (2, 4, 8, 16):
        blocks = [idx[0] for idx in
                  jdp.batch_sh.devices_indices_map((B_,)).values()]
        want = sorted((s.start or 0, s.stop if s.stop is not None else B_)
                      for s in blocks)
        assert [r['local_rows'][B_] for r in ranks] == want


def test_dp2_sampling_draws_the_undivided_batch(runs):
    '''A seeded sampler over two ranks gives, on each, the tokens of a
    sampler of the same seed over the whole batch in one process, call
    for call (each rank draws the batch's noise and keeps its rows).'''
    _, ranks = runs
    for r in ranks:
        for got, want in zip(r['sample']['dp'], r['sample']['one']):
            np.testing.assert_array_equal(got, want)
    one = ranks[0]['sample']['one']
    assert not np.array_equal(one[0], one[1])       # fresh draws a call


def test_dp2_engine_equals_one_replica():
    '''Two CPU replicas decode each batch's halves in two threads; the
    sentences are one replica's, and a batch of 3 crops rounds up to 4
    rows.'''
    _, _, model = jax_and_torch_model(seed=2, dout_p=0.0)
    vocab = Vocab(['<unk>', '<blank>', '<s>', '</s>']
                  + [f'w{i}' for i in range(4, SMALL['voc_size'])])
    rng = np.random.default_rng(0)
    crops = [{'rgb': rng.normal(size=(sv, SMALL['d_vid'])).astype(np.float32),
              'flow': rng.normal(size=(sv, SMALL['d_vid'])).astype(
                  np.float32),
              'audio': rng.normal(size=(sa, SMALL['d_aud'])).astype(
                  np.float32)}
             for sv, sa in ((5, 9), (12, 20), (3, 4), (30, 60), (7, 7))]
    kw = dict(max_len=6, attention_impl='torch', max_batch=4)
    one = CaptionEngine(model, vocab, **kw)
    two = CaptionEngine(model, vocab, dp=replica_devices(2, 'cpu'), **kw)
    assert two._bucket_batch(3) == 4 and two._bucket_batch(1) == 2
    np.testing.assert_array_equal(two.caption_tokens(crops[:3]),
                                  one.caption_tokens(crops[:3]))
    assert two.caption_crops(crops) == one.caption_crops(crops)
    with pytest.raises(ValueError, match='max_batch'):
        CaptionEngine(model, vocab, dp=replica_devices(3, 'cpu'), **kw)
    # a seeded sampler: the replicas' threads take one call a batch and
    # draw its noise, so the seed gives one replica's captions, call for
    # call
    sampled = {n: CaptionEngine(model, vocab, dp=replica_devices(n, 'cpu'),
                                decode_fn=make_bimodal_sample_fn(
                                    model.dims, **work.SAMPLE_KW), **kw)
               for n in (1, 2)}
    first, second = ([e.caption_tokens(crops[:4]) for e in sampled.values()]
                     for _ in 'ab')
    np.testing.assert_array_equal(first[1], first[0])
    np.testing.assert_array_equal(second[1], second[0])
    assert not np.array_equal(first[0], second[0])


def test_dp_devices_above_the_cards_raises_naming_both(tmp_path):
    (tmp_path / 'tree').mkdir()
    tree = mini_tree(tmp_path / 'tree')
    with pytest.raises(ValueError, match=r'needs 2 CUDA devices .*but 0 are '
                                         r'visible'):
        cli.main(mini_argv(tree, tmp_path / 'log', 'train_cap',
                           dp_devices=2))
    with pytest.raises(ValueError, match='needs 3 CUDA devices'):
        replica_devices(3, 'cuda')
    with pytest.raises(RuntimeError, match='one process a rank'):
        DataParallel(2, 'cpu')


@pytest.mark.parametrize('flag', [{'fsdp': None}, {'ep_devices': 2},
                                  {'sp_devices': 2}])
def test_other_parallelism_still_raises_naming_item_11(tmp_path, flag):
    '''--fsdp, --ep_devices and --sp_devices pass the option check in
    both trainers, and DataParallel takes them (more than one rank needs a
    process group); so does tensor parallelism (mp), which no longer
    raises NotImplementedError: with more than one rank it too asks for a
    process group.'''
    for procedure in ('train_cap', 'train_prop'):
        check_ported(Config(build_parser().parse_args(
            mini_argv(tmp_path, tmp_path, procedure, **flag))))
    kw = {'fsdp': True} if 'fsdp' in flag else {k[:2]: 2 for k in flag}
    if 'fsdp' in flag:
        assert DataParallel(1, 'cpu', **kw).fsdp
    else:
        with pytest.raises(RuntimeError, match='one process a rank'):
            DataParallel(1, 'cpu', **kw)
    with pytest.raises(RuntimeError, match='one process a rank'):
        DataParallel(1, 'cpu', mp=2, **kw)


def test_replica_threads_build_a_kernel_library_once(tmp_path, monkeypatch):
    '''Replica threads that launch a kernel first at the same time wait for
    one build: a stand-in compiler that takes 0.2 s runs once, and every
    thread loads its library.'''
    from bmt_tpu_torch.ops import _build
    (tmp_path / 'csrc').mkdir()
    (tmp_path / 'csrc' / 'stub.cu').write_text('// stub\n')
    nvcc = tmp_path / 'nvcc'
    nvcc.write_text(f'#!/bin/sh\necho run >> {tmp_path}/runs\nsleep 0.2\n'
                    'while [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = -o ]; then touch "$2"; fi; shift\n'
                    'done\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, 'CSRC_DIR', tmp_path / 'csrc')
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_build, '_nvcc', lambda: str(nvcc))
    monkeypatch.setattr(_build.ctypes, 'CDLL', lambda path: path)
    _build._load_library.cache_clear()
    got, errors = [], []

    def first_launch():
        try:
            got.append(_build.load_library('stub'))
        except Exception as e:
            errors.append(e)
    try:
        threads = [threading.Thread(target=first_launch) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        _build._load_library.cache_clear()
    assert not errors
    assert len(got) == 4 and len(set(got)) == 1
    assert (tmp_path / 'runs').read_text().split() == ['run']


def test_train_loop_polls_the_ranks_only_with_a_guard():
    '''Without a PreemptionGuard (the same on every rank) a step makes no
    collective; with one, the ranks' agreement sets the guard.'''
    from bmt_tpu_torch.train.loops import _stop

    class Ranks:
        n_dp = size = 2

        def __init__(self, answer):
            self.answer, self.asked = answer, 0

        def any(self, flag):
            self.asked += 1
            return self.answer or flag
    quiet = Ranks(True)
    assert _stop(None, quiet) is False and quiet.asked == 0
    guard = types.SimpleNamespace(requested=False)
    assert _stop(guard, Ranks(False)) is False and not guard.requested
    assert _stop(guard, Ranks(True)) is True and guard.requested
