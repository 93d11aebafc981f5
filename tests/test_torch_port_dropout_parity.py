'''Training with dropout on under ``--prng_impl threefry2x32`` in the port
against the JAX package, on the CPU (fp32, dropout 0.1, Adam eps 1e-4):

- the captioners' and proposal generators' train steps (bi-modal with and
  without remat and with ``grad_accum_steps`` 2, MoE, uni-modal) against
  JAX's ``make_cap_train_step``/``make_prop_train_step`` from the same
  seed: the masks are JAX's, so the existing train tolerance holds (loss,
  grad_norm and each loss term 2e-5 relative, parameters 2e-6 absolute
  after two Adam steps);
- four gloo ranks (``parallel.launch.spawn``, one group) on dp 2 x mp 2,
  dp 2 x sp 2 (the proposal generator), dp 2 x ep 2 (MoE) and dp 4 with
  ``grad_accum_steps`` 2: each rank draws its block of the one global
  mask, so each grid's steps are the one-process step's within STEP_TOL
  (chip_smoke's: loss 1e-5 and grad_norm 1e-4 relative, parameters 1e-6
  absolute) and JAX's single-device step's within the train tolerance;
- two ranks on pp 2: the pipelined encoder's outputs and gradients with
  dropout against JAX's pipelined forward with the same key, within PP_TOL
  (chip_smoke's fp32: 1e-5 and 1e-3 relative L2);
- sampled tokens against JAX's ``sample_decode_*`` for the same seed
  (tokens equal, the beam and sample tests' rule: the log-probs agree to
  ~1e-6 and random fp32 weights leave no near ties);
- ``--prng_impl rbg`` (the trainers' default) keeps the port's generator
  path: its masks are the ``bernoulli_`` draws of the state's generator,
  remat redraws them, and they depend only on (seed, step).
'''
import pickle
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bmt_tpu.decode.sample import make_bimodal_sample_fn as j_sample_fn
from bmt_tpu.decode.sample import sample_decode_bimodal as j_sample
from bmt_tpu.decode.sample import sample_decode_unimodal as j_sample_uni
from bmt_tpu.models import init_bimodal_transformer
from bmt_tpu.models import proposal as jprop
from bmt_tpu.models.encoders import init_bimodal_encoder
from bmt_tpu.parallel.pipeline import pipelined_bimodal_encoder_forward
from bmt_tpu.parallel.pipeline import stack_layer_params as jstack
from bmt_tpu.train import optim as joptim
from bmt_tpu.train import steps as jsteps
from bmt_tpu_torch.decode import (make_bimodal_sample_fn,
                                  sample_decode_bimodal,
                                  sample_decode_unimodal)
from bmt_tpu_torch.ops import prng
from bmt_tpu_torch.ops.layers import Dropout, dropout_generator
from bmt_tpu_torch.parallel.launch import spawn
from bmt_tpu_torch.train import optim as toptim
from bmt_tpu_torch.train import options
from bmt_tpu_torch.train import steps as tsteps
from tests import torch_port_dp as dpwork
from tests import torch_port_prng_work as prngwork
from tests import torch_port_shard as work
from tests.test_torch_port_fsdp import CFG, PROP, cap_batch
from tests.test_torch_port_fsdp import prop_batch as grid_prop_batch
from tests.test_torch_port_fsdp import prop_params
from tests.test_torch_port_proposal import (jax_and_torch_generator,
                                            prop_batch)
from tests.test_torch_port_train import SMOOTHING, STEP_CFG, _batch, _cfg
from tests.test_torch_port_unimodal import (_cap_batch, captioner, features,
                                            generator, only)
from tests.test_torch_port_unimodal import prop_batch as uni_prop_batch
from tests.torch_port_util import (END, PAD, SMALL, START,
                                   assert_tree_close, dims_pair,
                                   jax_and_torch_model, to_jax, to_torch)
from tests.torch_port_util import features as cap_features

DOUT = 0.1
STEP_TOL = {'loss': 1e-5, 'grad_norm': 1e-4, 'param': 1e-6}
PP_TOL = (1e-5, 1e-3)             # outputs, gradients: relative L2


def _close(got: dict, want: dict, rtol=2e-5):
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=rtol,
                                   err_msg=k)


def _cap_steps(jdims, params, model, batches, accum=1, impl='torch',
               jimpl='xla', **kw):
    '''Two steps of JAX's captioner step and the port's from seed 0, the
    default threefry2x32 on both sides; the metrics compared each step.'''
    jopt = joptim.build_optimizer(STEP_CFG)
    jstep = jax.jit(jsteps.make_cap_train_step(
        jdims, jopt, SMOOTHING, PAD, attention_impl=jimpl,
        accum_steps=accum, **kw))
    jstate = jsteps.init_train_state(to_jax(params), jopt)
    opt = toptim.build_optimizer(STEP_CFG, model)
    step = tsteps.make_cap_train_step(model.dims, SMOOTHING, PAD, impl,
                                      accum_steps=accum, **kw)
    state = tsteps.init_train_state(model, opt)
    assert state.prng_impl == 'threefry2x32' and state.generator is None
    for batch in batches:
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        _close(m, jm)
    assert_tree_close(model, jstate.params, atol=2e-6)
    return state


CAP_CASES = {'plain': ({}, 1, 'torch'), 'remat': ({'remat': True}, 1,
                                                  'kernel'),
             'accum2': ({}, 2, 'torch'),
             'remat_accum2': ({'remat': True}, 2, 'kernel'),
             'moe': ({'moe_experts': 4}, 2, 'torch')}


@pytest.mark.parametrize('case', list(CAP_CASES))
def test_cap_train_step_with_dropout_matches_jax(case):
    kw, accum, impl = CAP_CASES[case]
    jdims, params, model = jax_and_torch_model(seed=3, dout_p=DOUT, **kw)
    extra = {'moe_aux_coeff': 0.05} if 'moe_experts' in kw else {}
    _cap_steps(jdims, params, model, [_batch(10 + i, dims=jdims)
                                      for i in range(2)],
               accum, impl, {'torch': 'xla', 'kernel': 'pallas'}[impl],
               **extra)


@pytest.mark.parametrize('modality,accum', [('audio', 2), ('video', 1)])
def test_unimodal_cap_train_step_with_dropout_matches_jax(modality, accum):
    jdims, params, model = captioner(modality, seed=7, dout_p=DOUT)
    _cap_steps(jdims, params, model,
               [_cap_batch(10 + i, modality, jdims) for i in range(2)],
               accum)


def _prop_steps(jdims, params, model, batches, accum=1, impl='torch',
                jimpl='xla'):
    frozen = tsteps.prop_frozen(False)
    mask = joptim.freeze_mask(params, frozen)
    jopt = joptim.build_optimizer(STEP_CFG, frozen_mask=mask)
    jstep = jax.jit(jsteps.make_prop_train_step(
        jdims, jopt, PAD, attention_impl=jimpl, accum_steps=accum,
        frozen_mask=mask))
    jstate = jsteps.init_train_state(to_jax(params), jopt)
    opt = toptim.build_optimizer(STEP_CFG, model, frozen=frozen)
    step = tsteps.make_prop_train_step(model.dims, PAD, impl,
                                       accum_steps=accum)
    state = tsteps.init_train_state(model, opt)
    for batch in batches:
        jstate, jm = jstep(jstate, to_jax(batch))
        state, m = step(state, batch)
        _close(m, jm)
    assert_tree_close(model, jstate.params, atol=2e-6)


PROP_CASES = {'plain': ({}, 1, 'torch'), 'remat': ({'remat': True}, 1,
                                                   'kernel'),
              'accum2': ({'layer_norm': True}, 2, 'torch')}


@pytest.mark.parametrize('case', list(PROP_CASES))
def test_prop_train_step_with_dropout_matches_jax(case):
    kw, accum, impl = PROP_CASES[case]
    jdims, params, model = jax_and_torch_generator(seed=7, dout_p=DOUT, **kw)
    _prop_steps(jdims, params, model,
                [prop_batch(10 + i, jdims) for i in range(2)], accum, impl,
                {'torch': 'xla', 'kernel': 'pallas'}[impl])


def test_unimodal_prop_train_step_with_dropout_matches_jax():
    jdims, params, model = generator('audio', seed=3, dout_p=DOUT)
    _prop_steps(jdims, params, model,
                [uni_prop_batch(10 + i, 'audio', jdims) for i in range(2)],
                2)


def test_the_step_key_depends_on_seed_and_step_only():
    '''Step s draws from fold_in(key(seed), s): the same (seed, step) the
    same loss whatever ran before, another step or seed another.'''
    def loss(seed, step_index):
        _, _, model = jax_and_torch_model(seed=5, dout_p=DOUT)
        opt = toptim.build_optimizer(_cfg(lr=0.0), model)
        state = tsteps.init_train_state(model, opt, seed=seed)
        state.step = step_index
        step = tsteps.make_cap_train_step(model.dims, SMOOTHING, PAD)
        return step(state, _batch(30, dims=model.dims))[1]['loss'].item()
    a = loss(1, 0)
    torch.rand(10)
    assert loss(1, 0) == a
    assert len({a, loss(1, 1), loss(2, 0)}) == 3
    np.testing.assert_array_equal(
        tsteps.step_key(types.SimpleNamespace(key=prng.key(1, 'cpu'),
                                              step=4)),
        np.asarray(jax.random.key_data(jax.random.fold_in(
            jax.random.key(1), 4))))


# ---------------------------------------------------------------------------
# rbg: the generator path
# ---------------------------------------------------------------------------

def test_rbg_keeps_the_generator_path():
    '''A state of prng_impl 'rbg' holds a generator and no key, and a
    ``Dropout`` under its generator draws ``bernoulli_`` masks of it,
    scaled in x's dtype.'''
    _, _, model = jax_and_torch_model(seed=5, dout_p=DOUT)
    state = tsteps.init_train_state(model, toptim.build_optimizer(
        _cfg(), model), seed=3, prng_impl='rbg')
    assert state.key is None and isinstance(state.generator,
                                            torch.Generator)
    x = torch.randn(4, 5, 6)
    g = torch.Generator().manual_seed(11)
    with dropout_generator(g):
        got = Dropout(0.3).train()(x)
    keep = torch.empty_like(x).bernoulli_(
        0.7, generator=torch.Generator().manual_seed(11))
    assert torch.equal(got, x * keep.div_(0.7))
    with pytest.raises(ValueError, match='prng_impl'):
        tsteps.init_train_state(model, state.optimizer, prng_impl='philox')


def _rbg_grads(remat, seed=7, step_index=0, impl='torch'):
    _, _, model = jax_and_torch_model(seed=5, dout_p=DOUT, remat=remat)
    opt = toptim.build_optimizer(_cfg(lr=0.0), model)
    state = tsteps.init_train_state(model, opt, seed=seed, prng_impl='rbg')
    state.step = step_index
    step = tsteps.make_cap_train_step(model.dims, SMOOTHING, PAD, impl)
    state, m = step(state, _batch(30, dims=model.dims))
    return m['loss'].item(), {n: p.grad.clone()
                              for n, p in model.named_parameters()}


def test_rbg_remat_redraws_the_masks_and_they_depend_on_seed_and_step():
    loss_a, grads_a = _rbg_grads(remat=False, impl='kernel')
    loss_b, grads_b = _rbg_grads(remat=True, impl='kernel')
    assert loss_a == loss_b
    for name, g in grads_a.items():
        np.testing.assert_allclose(grads_b[name].numpy(), g.numpy(),
                                   atol=1e-6, err_msg=name)
    loss_c, _ = _rbg_grads(remat=False, step_index=1)
    loss_d, _ = _rbg_grads(remat=False, seed=8)
    loss_e, _ = _rbg_grads(remat=False)
    assert len({loss_e, loss_c, loss_d}) == 3


def test_trainers_read_prng_impl():
    assert options.prng_impl(types.SimpleNamespace()) == 'rbg'
    for flag in tsteps.PRNG_IMPLS:
        assert options.prng_impl(types.SimpleNamespace(prng_impl=flag)) \
            == flag
    with pytest.raises(ValueError, match='--prng_impl'):
        options.prng_impl(types.SimpleNamespace(prng_impl='philox'))


# ---------------------------------------------------------------------------
# dp, mp, sp, ep and pp with dropout on
# ---------------------------------------------------------------------------

GRID_CAP = {**SMALL, 'N': 1, 'dout_p': DOUT, 'voc_size': 24}
GRID_PROP = {**PROP, 'dout_p': DOUT}
E = 4


def _jax_single(kind, dims, params, frozen, batches, **kw):
    '''JAX's one-device steps from seed 0: (metrics by step, params).'''
    mask = joptim.freeze_mask(params, frozen)
    opt = joptim.build_optimizer(CFG, frozen_mask=mask)
    if kind == 'cap':
        make = jsteps.make_cap_train_step(dims, opt, work.SMOOTHING, PAD,
                                          frozen_mask=mask, **kw)
    else:
        make = jsteps.make_prop_train_step(dims, opt, PAD, frozen_mask=mask,
                                           **kw)
    step = jax.jit(make)
    state = jsteps.init_train_state(params, opt)
    out = []
    for batch in batches:
        state, m = step(state, to_jax(batch))
        out.append({k: float(v) for k, v in m.items()})
    return out, jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope='module')
def grids(tmp_path_factory):
    '''{label: (rank 0's run, the one-process run, JAX's (metrics,
    params))} of the four grids.'''
    path = tmp_path_factory.mktemp('prng_grids') / 'jobs.pkl'
    jcap, _ = dims_pair(**GRID_CAP)
    jmoe, _ = dims_pair(**GRID_CAP, moe_experts=E)
    pdims = jprop.PropModelDims(**GRID_PROP)
    cap_params = init_bimodal_transformer(jax.random.PRNGKey(3), jcap)
    moe_params = init_bimodal_transformer(jax.random.PRNGKey(7), jmoe)
    p_params = prop_params(pdims, seed=6)
    cap_batches = [cap_batch(90 + i, jcap) for i in range(2)]
    prop_batches = [grid_prop_batch(95 + i, pdims) for i in range(2)]

    def job(label, grid, kind, dims, params, frozen, batches, **step_kw):
        return {'label': label, 'grid': grid, 'fsdp': False, 'min_elems': 0,
                'runs': [{'name': label, 'kind': kind, 'dims': dims,
                          'tree': work.as_numpy(params), 'cfg': CFG,
                          'frozen': frozen, 'batches': batches,
                          'step_kw': step_kw}]}
    jobs = [job('dp2_mp2', (2, 1, 1, 2), 'cap', GRID_CAP, cap_params,
                dpwork.nothing, cap_batches),
            job('dp2_sp2', (2, 2, 1, 1), 'prop', GRID_PROP, p_params,
                dpwork.dp_frozen_anchors, prop_batches),
            job('dp2_ep2', (2, 1, 2, 1), 'cap', {**GRID_CAP,
                                                 'moe_experts': E},
                moe_params, dpwork.nothing, cap_batches,
                moe_aux_coeff=0.01),
            job('dp4_accum2', (4, 1, 1, 1), 'cap', GRID_CAP, cap_params,
                dpwork.nothing, cap_batches, accum_steps=2)]
    with open(path, 'wb') as f:
        pickle.dump(jobs, f)
    with ThreadPoolExecutor(1) as pool:
        # the ranks run while JAX compiles its steps
        ranks = pool.submit(spawn, work.shard_grids, (str(path),), 4, 'cpu')
        single = {j['label']: work.unsharded(j)[j['label']] for j in jobs}
        dims = {'dp2_mp2': jcap, 'dp2_sp2': pdims, 'dp2_ep2': jmoe,
                'dp4_accum2': jcap}
        params = {'dp2_mp2': cap_params, 'dp2_sp2': p_params,
                  'dp2_ep2': moe_params, 'dp4_accum2': cap_params}
        jax_out = {}
        for j in jobs:
            r = j['runs'][0]
            jax_out[j['label']] = _jax_single(
                r['kind'], dims[j['label']], params[j['label']],
                r['frozen'], r['batches'], **r['step_kw'])
        got = ranks.result()
    rank0 = next(r for r in got if r['dp2_mp2']['rank'] == 0)
    return {j['label']: (rank0[j['label']][j['label']],
                         single[j['label']], jax_out[j['label']])
            for j in jobs}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize('label', ['dp2_mp2', 'dp2_sp2', 'dp2_ep2',
                                   'dp4_accum2'])
def test_grid_with_dropout_equals_one_process(grids, label):
    '''The grid's losses and parameters against the port's one-process
    steps within STEP_TOL, and against JAX's one-device steps within the
    train tolerance.'''
    got, single, (jax_metrics, jax_params) = grids[label]
    for g, s in zip(got['losses'], single['losses']):
        np.testing.assert_allclose(g['loss'], s['loss'],
                                   rtol=STEP_TOL['loss'])
        np.testing.assert_allclose(g['grad_norm'], s['grad_norm'],
                                   rtol=STEP_TOL['grad_norm'])
    want = dict(_flat(single['tree']))
    for path, leaf in _flat(got['tree']):
        np.testing.assert_allclose(leaf, want[path], atol=STEP_TOL['param'],
                                   err_msg=str(path))
    for g, j in zip(got['losses'], jax_metrics):
        _close(g, j)
    jax_leaves = dict(_flat(jax_params))
    for path, leaf in _flat(got['tree']):
        np.testing.assert_allclose(leaf, jax_leaves[path], atol=2e-6,
                                   err_msg=str(path))


def test_grid_masks_are_live(grids):
    '''Dropout moved the grids' losses: the dropout-off step reads
    another loss.'''
    got, _, _ = grids['dp2_mp2']
    jcap, _ = dims_pair(**{**GRID_CAP, 'dout_p': 0.0})
    params = init_bimodal_transformer(jax.random.PRNGKey(3), jcap)
    off, _ = _jax_single('cap', jcap, params, dpwork.nothing,
                         [cap_batch(90, jcap)])
    assert abs(got['losses'][0]['loss'] - off[0]['loss']) > 1e-4


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope='module')
def pipeline(tmp_path_factory):
    '''(the two ranks' results, JAX's (outputs, gradients) by case).'''
    cases = []
    for n, m, seed in ((2, 4, 5), (4, 2, 9)):
        rng = np.random.default_rng(n)
        B, Sa, Sv = 8, 6, 5
        Am = np.ones((B, 1, Sa), bool)
        Am[:, :, -1] = False
        cases.append({
            'n_layers': n, 'n_micro': m, 'dout_p': 0.3, 'seed': seed,
            'tree': jax.tree.map(np.asarray, init_bimodal_encoder(
                jax.random.PRNGKey(0), 8, 8, 16, 16, 16, n)),
            'data': (rng.normal(size=(B, Sa, 8)).astype(np.float32),
                     rng.normal(size=(B, Sv, 8)).astype(np.float32), Am,
                     np.ones((B, 1, Sv), bool))})
    path = tmp_path_factory.mktemp('prng_pp') / 'job.pkl'
    with open(path, 'wb') as f:
        pickle.dump({'cases': cases}, f)
    got = spawn(prngwork.pipeline_dropout_work, (str(path),), 2, 'cpu')
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ('pp',))
    want = []
    for c in cases:
        stage = jstack(jax.tree.map(jnp.asarray, c['tree']['layers']), 2)
        A, V, Am, Vm = (jnp.asarray(x) for x in c['data'])

        def loss(stk, a, c=c, V=V, Am=Am, Vm=Vm):
            Av, Va = pipelined_bimodal_encoder_forward(
                stk, a, V, Am, Vm, 2, mesh, n_micro=c['n_micro'],
                dout_p=c['dout_p'], rng=jax.random.key(c['seed']),
                deterministic=False)
            return jnp.sum(Av ** 2) + jnp.sum(Va ** 2), (Av, Va)
        (_, outs), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(stage, A)
        want.append((outs, grads))
    return got, want, cases


@pytest.mark.parametrize('case', [0, 1])
def test_pp2_dropout_matches_jax_pipeline(pipeline, case):
    got, want, cases = pipeline
    (jouts, (jgrads, jA)) = want[case]
    n = cases[case]['n_layers']
    per = n // 2
    held = {}
    for r in got:
        mine = r['cases'][case]
        out_err = max(_rel_l2(a, b) for a, b in zip(mine['outs'], jouts))
        assert out_err <= PP_TOL[0], out_err
        assert _rel_l2(mine['input_grad'], jA) <= PP_TOL[1]
        held.update(mine['grads'])
        # another key, other masks
        assert np.abs(mine['other_key'] - mine['outs'][0]).max() > 1e-2
    # each layer's gradient as one vector, as chip_smoke's 23c reads it: a
    # key projection's bias has a gradient of exactly 0 but for rounding,
    # so a leaf alone has no scale to be read in
    leaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for s in range(2):
        for j in range(per):
            ours, theirs = [], []
            for path, g in leaves:
                keys = [str(getattr(k, 'key', getattr(k, 'idx', None)))
                        for k in path]
                ours.append(held['/'.join([str(s * per + j)] + keys)]
                            .reshape(-1))
                theirs.append(np.asarray(g)[s, j].reshape(-1))
            err = _rel_l2(np.concatenate(ours), np.concatenate(theirs))
            assert err <= PP_TOL[1], (s * per + j, err)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

MAX_LEN = 6
FILTERS = [dict(), dict(top_k=5, temperature=1.3), dict(top_p=0.8),
           dict(top_k=7, top_p=0.9, temperature=0.7)]


@pytest.fixture(scope='module')
def sample_setup():
    jdims, params, model = jax_and_torch_model(seed=3)
    src = cap_features(np.random.default_rng(1), 5, 6, 8, jdims,
                       pad_rows={1: (3, 5)})
    return jdims, params, model, src


@pytest.mark.parametrize('kw', FILTERS, ids=str)
def test_sampled_tokens_match_jax(sample_setup, kw):
    jdims, params, model, src = sample_setup
    for seed in (0, 7, 11):
        got = sample_decode_bimodal(model, to_torch(src), seed, MAX_LEN,
                                    START, END, PAD, **kw)
        want = j_sample(params, jdims, to_jax(src),
                        jax.random.PRNGKey(seed), MAX_LEN, START, END, PAD,
                        **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bound_sampler_calls_and_row_blocks_match_jax(sample_setup):
    '''Call n of a bound sampler keys fold_in(PRNGKey(seed), n), as JAX's
    binder; a block of a call's rows samples those rows of it.'''
    jdims, params, model, src = sample_setup
    ours = make_bimodal_sample_fn(jdims, MAX_LEN, START, END, PAD,
                                  top_k=6, seed=4)
    theirs = j_sample_fn(jdims, MAX_LEN, START, END, PAD, top_k=6, seed=4)
    for _ in range(3):
        part = ours.for_batch()
        want = np.asarray(theirs(params, to_jax(src)))
        whole = part(model, to_torch(src))
        np.testing.assert_array_equal(whole.numpy(), want)
        rows = part(model, {k: v[2:5] for k, v in to_torch(src).items()},
                    (2, 5))
        # up to each row's end: a block whose rows all ended stops early
        # and pads with the end token, where the whole batch goes on
        assert _to_end(rows.numpy()) == _to_end(want[2:5])


def _to_end(tokens) -> list:
    out = []
    for row in np.asarray(tokens).tolist():
        out.append(row[:row.index(END) + 1] if END in row else row)
    return out


@pytest.mark.parametrize('modality', ['audio', 'video'])
def test_unimodal_sampled_tokens_match_jax(modality):
    jdims, params, model = captioner(modality, seed=2)
    src = only(features(3, jdims, B=4), modality)
    for seed in (1, 5):
        got = sample_decode_unimodal(model, to_torch(src), seed, MAX_LEN,
                                     START, END, PAD, top_k=8)
        want = j_sample_uni(to_jax(params), jdims, to_jax(src),
                            jax.random.PRNGKey(seed), MAX_LEN, START, END,
                            PAD, top_k=8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
