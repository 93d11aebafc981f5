'''Work for the ranks of a sharded group in the port's CPU tests
(``parallel.launch.spawn`` runs it in each spawned process; nothing here
imports JAX, so the workers start fast): train steps under ``--fsdp``,
expert, sequence and tensor parallelism, what each rank holds, and the
whole state written and read back under ``DataParallel.whole``.'''
import copy
import os
import pickle

import numpy as np
import torch

SMOOTHING = 0.7
PAD = 1


def _model(run, device):
    from bmt_tpu_torch.models import (BiModalTransformer, CapModelDims,
                                      PropModelDims, proposal_class)
    from bmt_tpu_torch.params import load_jax_params
    if run['kind'] == 'cap':
        dims = CapModelDims(**run['dims'])
        model = BiModalTransformer(dims, device=device)
    else:
        dims = PropModelDims(**run['dims'])
        model = proposal_class(dims)(dims, device=device)
    load_jax_params(model, run['tree'])
    return dims, model


def _step(run, dims, dp):
    from bmt_tpu_torch.train import steps
    if run['kind'] == 'cap':
        return steps.make_cap_train_step(dims, SMOOTHING, PAD, dp=dp,
                                         **run.get('step_kw', {}))
    return steps.make_prop_train_step(dims, PAD, dp=dp,
                                      **run.get('step_kw', {}))


def _state(run, model, job, dp):
    '''The run's train state, its shards cut under ``dp`` (``--fsdp`` as the
    run or else the job asks).'''
    from bmt_tpu_torch.train import optim, steps
    opt = optim.build_optimizer(run['cfg'], model, frozen=run['frozen'])
    state = steps.init_train_state(model, opt, ema=run.get('ema', False))
    if dp is None:
        return state, None
    dp.fsdp = run.get('fsdp', job['fsdp'])
    return state, dp.shard_params(state, job['min_elems'])


def _bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def shard_steps(job_path, device):
    '''Each run of the job (a captioner or a proposal generator from a JAX
    tree, its optimizer config, frozen predicate and global batches) on the
    job's (dp, sp, ep[, mp]) grid with ``--fsdp`` as asked. Returns, from
    every rank, its coordinates, its bytes and experts, the encoder's output
    rows and its leaves' shapes (JAX layout); from rank 0, the losses by
    step, the whole parameters (JAX layout) and optimizer state after the
    last step, the decode or the predictions asked for, and the step after
    a resume of an unsharded run's directory.'''
    torch.set_num_threads(1)
    with open(job_path, 'rb') as f:
        job = pickle.load(f)
    return run_job(job, device)


def shard_grids(jobs_path, device):
    '''``shard_steps`` for each job of a list (one group, a grid a job):
    {job's 'label': its result}.'''
    torch.set_num_threads(1)
    with open(jobs_path, 'rb') as f:
        jobs = pickle.load(f)
    return {job['label']: run_job(job, device) for job in jobs}


def local_shapes(model) -> dict:
    '''{JAX path: the shape this rank holds, in the JAX layout}.'''
    from bmt_tpu_torch.params import jax_weight_axes, named_jax_parameters
    axes = jax_weight_axes(model)
    return {'/'.join(map(str, path)): tuple(
        p.shape[i] for i in axes.get(id(p), range(p.dim())))
        for path, p in named_jax_parameters(model)}


def run_job(job, device):
    from bmt_tpu_torch.models.encoders import BiModalEncoder, Encoder
    from bmt_tpu_torch.ops.moe import MoEFeedForward
    from bmt_tpu_torch.parallel import DataParallel
    from bmt_tpu_torch.params import to_jax_tree
    from bmt_tpu_torch.train import checkpoint, steps

    n_dp, n_sp, n_ep, *more = job['grid']
    n_mp = more[0] if more else 1
    dp = DataParallel(n_dp, device, sp=n_sp, ep=n_ep, mp=n_mp,
                      fsdp=job['fsdp'])
    out = {'rank': dp.rank, 'backend': dp.backend,
           'coords': (dp.dp_rank, dp.sp_rank, dp.ep_rank)
           + ((dp.mp_rank,) if more else ())}
    if n_ep > 1:
        out['ep_sum'] = ep_sum_gradients(dp.ep_group)
    for run in job['runs']:
        name = run['name']
        dims, model = _model(run, device)
        whole_bytes = _bytes(model)
        state, shards = _state(run, model, job, dp)
        rows = []
        enc = next(m for m in model.modules()
                   if isinstance(m, (BiModalEncoder, Encoder)))
        hook = enc.register_forward_hook(lambda m, a, o: rows.append(
            [t.shape[1] for t in (o if isinstance(o, tuple) else (o,))]))
        step = _step(run, dims, dp)
        losses = []
        for batch in run['batches']:
            state, metrics = step(state, dp.shard(batch))
            losses.append({k: v.item() for k, v in metrics.items()})
        hook.remove()
        mine = {'bytes': _bytes(model), 'whole_bytes': whole_bytes,
                'held': None if shards is None else shards.bytes(),
                'experts': [m.experts.w1.shape[0] for m in model.modules()
                            if isinstance(m, MoEFeedForward)],
                'encoder_rows': rows[0]}
        if run.get('shapes'):
            mine['shapes'] = local_shapes(model)
        res = {}
        if 'predict' in run:
            infer = steps.make_prop_inference_step(dims, PAD, dp=dp)
            with dp.whole():
                res['predictions'] = dp.gather_rows(infer(
                    model, dp.shard({'src': run['predict']}))).numpy()
        if 'decode' in run:
            from bmt_tpu_torch.decode import make_bimodal_greedy_fn
            greedy = make_bimodal_greedy_fn(dims, 6, 2, 3, PAD)
            stacks = {k: torch.from_numpy(v) for k, v in
                      run['decode'].items()}
            model.eval()
            with dp.whole():
                res['decode'] = dp.decode(greedy, model, stacks).numpy()
            if n_mp > 1:        # with this rank's mp blocks
                res['decode_mp'] = dp.decode(greedy, model, stacks).numpy()
                res['logprobs_mp'] = step_logprobs(model, stacks,
                                                   res['decode'])
        with dp.whole(everything=True):
            if dp.is_main:
                res.update(losses=losses, tree=to_jax_tree(model),
                           opt=checkpoint.optimizer_state_tree(
                               model, state.optimizer))
                if job.get('save_dir'):
                    checkpoint.save_checkpoint(
                        os.path.join(job['save_dir'], name), model,
                        {'epoch': 0, 'step': state.step}, state.optimizer,
                        'last')
        if run.get('resume_from'):
            # an unsharded run's directory into a sharded state, one more
            # step
            _, again = _model(run, device)
            state, _ = _state(run, again, job, dp)
            with dp.whole(everything=True):
                checkpoint.load_checkpoint(run['resume_from'], again,
                                           state.optimizer, 'last')
            state.step = len(run['batches'])
            state, _ = _step(run, dims, dp)(state, dp.shard(run['next']))
            with dp.whole(everything=True):
                if dp.is_main:
                    res['resumed'] = to_jax_tree(again)
        out[name] = {'rank': mine, **res}
    return out


def ep_sum_gradients(group):
    '''y = sum over the ep ranks of w_r * x (x the same on every rank,
    w_r = r + 1) through ``CopyToGroup`` and ``ReduceFromGroup``; L =
    sum(y * c). Returns (y, dL/dx, dL/dw_r): the right values are
    x sum_r w_r, c sum_r w_r (every rank) and c x.'''
    from bmt_tpu_torch.parallel.mesh import CopyToGroup, ReduceFromGroup
    x = torch.arange(1.0, 7.0).view(2, 3).requires_grad_()
    w = torch.tensor(float(group.rank + 1), requires_grad=True)
    c = torch.tensor([[1.0, -2.0, 3.0], [0.5, 4.0, -1.0]])
    y = ReduceFromGroup.apply(CopyToGroup.apply(x, group) * w, group)
    (y * c).sum().backward()
    return y.detach().numpy(), x.grad.numpy(), w.grad.item()


def unsharded(job, device='cpu'):
    '''Rank 0's work of ``shard_steps`` in this process, without a group:
    the losses, the whole parameters and optimizer state; written to
    ``job['save_dir']`` when set, and the resume's next step taken from
    that directory.'''
    from bmt_tpu_torch.params import to_jax_tree
    from bmt_tpu_torch.train import checkpoint
    out = {}
    for run in job['runs']:
        dims, model = _model(run, device)
        state, _ = _state(run, model, job, None)
        step = _step(run, dims, None)
        losses = []
        for batch in run['batches']:
            state, metrics = step(state, batch)
            losses.append({k: v.item() for k, v in metrics.items()})
        res = {'losses': losses, 'tree': copy.deepcopy(to_jax_tree(model)),
               'opt': checkpoint.optimizer_state_tree(model,
                                                      state.optimizer)}
        if 'predict' in run:
            from bmt_tpu_torch.train import steps
            infer = steps.make_prop_inference_step(dims, PAD)
            res['predictions'] = infer(model, {'src': run['predict']}
                                       ).numpy()
        if job.get('save_dir'):
            path = os.path.join(job['save_dir'], run['name'] + '_plain')
            checkpoint.save_checkpoint(path, model,
                                       {'epoch': 0, 'step': state.step},
                                       state.optimizer, 'last')
            if 'next' in run:
                state, _ = step(state, run['next'])
                res['next'] = to_jax_tree(model)
        out[run['name']] = res
    return out


def as_numpy(tree):
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [as_numpy(v) for v in tree]
    return np.asarray(tree)


@torch.inference_mode()
def step_logprobs(model, stacks, tokens, steps: int = 3):
    """The KV-cached decode's step log-probs teacher-forced along
    ``tokens`` (the first ``steps`` steps)."""
    from bmt_tpu_torch.decode.greedy import bimodal_step_setup
    state, step_fn, _ = bimodal_step_setup(model, stacks, PAD, 6)
    tokens = torch.as_tensor(tokens)
    out = []
    for s in range(steps):
        lp, state = step_fn(state, tokens[:, s:s + 1], s)
        out.append(lp.numpy())
    return np.stack(out)


def pipeline_work(job_path, device):
    '''The pipeline cases of the job on a pp group of every rank
    (``parallel.pipeline``), then its tensor-parallel ``jobs`` (as
    ``shard_grids``). For each encoder case (a JAX encoder tree, its
    layer count, microbatch counts, inputs): the pipelined (Av, Va) at
    each count and, at the first, the gradients of sum(Av^2) + sum(Va^2)
    w.r.t. this rank's layers (JAX layout, keyed by the global layer) and
    the inputs; the same encoder in train mode with dropout 0.3 and a
    generator; and a generic stack of linear maps carrying an int
    constant.'''
    from bmt_tpu_torch.models.encoders import BiModalEncoder
    from bmt_tpu_torch.parallel.pipeline import (
        pipeline_layer_stack, pipelined_bimodal_encoder_forward,
        stack_layer_params, stage_group)
    from bmt_tpu_torch.params import (jax_weight_axes, load_jax_params,
                                      named_jax_parameters)
    torch.set_num_threads(1)
    with open(job_path, 'rb') as f:
        job = pickle.load(f)
    group = stage_group(device)
    out = {'rank': group.rank, 'pp': group.size, 'cases': []}
    for case in job['pipeline']:
        n = case['n_layers']
        enc = BiModalEncoder(8, 8, 16, 16, 16, n, 2, device='cpu',
                             dout_p=case.get('dout_p', 0.0))
        load_jax_params(enc, case['tree'])
        enc.eval()                      # deterministic, but the dropout run
        stage = stack_layer_params(enc.layers, group.size, group.rank)
        A, V, Am, Vm = (torch.from_numpy(x) for x in case['data'])
        res = {'outs': {}}
        for i, m in enumerate(case['n_micro']):
            a = A.clone().requires_grad_(i == 0)
            Av, Va = pipelined_bimodal_encoder_forward(stage, a, V, Am, Vm,
                                                       group, m)
            res['outs'][m] = (Av.detach().numpy(), Va.detach().numpy())
            if i == 0:
                ((Av ** 2).sum() + (Va ** 2).sum()).backward()
                axes = jax_weight_axes(stage)
                per = n // group.size
                res['grads'] = {
                    '/'.join(map(str, (group.rank * per + path[0],)
                                 + path[1:])):
                    p.grad.permute(*axes[id(p)]).numpy()
                    if id(p) in axes else p.grad.numpy()
                    for path, p in named_jax_parameters(stage)}
                res['input_grad'] = a.grad.numpy()
        if case.get('dout_p'):
            enc.train()
            with torch.no_grad():
                res['dropout'] = pipelined_bimodal_encoder_forward(
                    stage, A, V, Am, Vm, group, 2,
                    generator=torch.Generator().manual_seed(7))[0].numpy()
        out['cases'].append(res)
    W = torch.from_numpy(job['generic']['W'])            # (4, 3, 3)
    x = torch.from_numpy(job['generic']['x'])
    flag = torch.arange(x.shape[0], dtype=torch.int32)
    layers = torch.nn.ModuleList(
        torch.nn.Linear(3, 3, bias=False) for _ in range(W.shape[0]))
    with torch.no_grad():
        for lin, w in zip(layers, W):
            lin.weight.copy_(w.T)
    y, f = pipeline_layer_stack(
        stack_layer_params(layers, group.size, group.rank), (x, flag),
        lambda layer, carry: (layer(carry[0]), carry[1]), group, 2)
    out['generic'] = (y.detach().numpy(), f.numpy())
    out['jobs'] = {j['label']: run_job(j, device) for j in job['jobs']}
    return out
