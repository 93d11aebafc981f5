'''Work for the ranks of the threefry dropout tests (``parallel.launch.spawn``
runs it in each spawned process; nothing here imports JAX): the pipelined
bi-modal encoder in train mode with dropout drawn from a threefry key.'''
import pickle

import numpy as np
import torch


def pipeline_dropout_work(job_path, device):
    '''For each case of the job (a JAX encoder tree, its layer count,
    microbatch count, dropout rate, key seed and inputs) on a pp group of
    every rank: the pipelined (Av, Va) in train mode with dropout from
    ``prng.key(seed)``, the gradients of sum(Av^2) + sum(Va^2) w.r.t.
    this rank's layers (JAX layout, keyed by the global layer) and the
    audio input, and the output of a second key.'''
    from bmt_tpu_torch.models.encoders import BiModalEncoder
    from bmt_tpu_torch.ops import prng
    from bmt_tpu_torch.parallel.pipeline import (
        pipelined_bimodal_encoder_forward, stack_layer_params, stage_group)
    from bmt_tpu_torch.params import (jax_weight_axes, load_jax_params,
                                      named_jax_parameters)
    torch.set_num_threads(1)
    with open(job_path, 'rb') as f:
        job = pickle.load(f)
    group = stage_group(device)
    out = {'rank': group.rank, 'cases': []}
    for case in job['cases']:
        n, m = case['n_layers'], case['n_micro']
        enc = BiModalEncoder(8, 8, 16, 16, 16, n, 2, device='cpu',
                             dout_p=case['dout_p'])
        load_jax_params(enc, case['tree'])
        enc.train()
        stage = stack_layer_params(enc.layers, group.size, group.rank)
        A, V, Am, Vm = (torch.from_numpy(x) for x in case['data'])
        a = A.clone().requires_grad_()
        Av, Va = pipelined_bimodal_encoder_forward(
            stage, a, V, Am, Vm, group, m, key=prng.key(case['seed'], 'cpu'))
        ((Av ** 2).sum() + (Va ** 2).sum()).backward()
        axes = jax_weight_axes(stage)
        per = n // group.size
        res = {'outs': (Av.detach().numpy(), Va.detach().numpy()),
               'input_grad': a.grad.numpy(),
               'grads': {'/'.join(map(str, (group.rank * per + path[0],)
                                      + path[1:])):
                         p.grad.permute(*axes[id(p)]).numpy()
                         if id(p) in axes else p.grad.numpy()
                         for path, p in named_jax_parameters(stage)}}
        with torch.no_grad():
            res['other_key'] = np.asarray(pipelined_bimodal_encoder_forward(
                stage, A, V, Am, Vm, group, m,
                key=prng.key(case['seed'] + 1, 'cpu'))[0])
        out['cases'].append(res)
    return out
