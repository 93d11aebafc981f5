'''Multi-process dry-run worker and its shared fixtures (counterpart of
``bmt_tpu.parallel.dryrun_dist``).

Run as ``python -m bmt_tpu_torch.parallel.dryrun_dist [--device cpu]
[--backend gloo]`` in each of two processes that join one
``torch.distributed`` group through ``maybe_init_distributed``: torchrun's
``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``, or the JAX
package's ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID``. Each process is a rank of a dp = 2 group, runs one
captioning train step on its rows, and prints ``RESULT <loss> <checksum>``.
``scripts.dryrun_multichip`` section 9 starts the two processes and holds
their line to ``run_step()`` in one process, as the JAX package's dry run
does with its two-host run.

The fixtures are deterministic (the weights from a seeded CPU generator,
the batch from a numpy seed), so the two processes and the one process
build the same step.
'''
from __future__ import annotations

import argparse

import numpy as np
import torch


def dryrun_dims():
    '''The JAX fixture's dims, with dropout off as the fixture has it.'''
    from bmt_tpu_torch.models import CapModelDims
    return CapModelDims(voc_size=64, d_model_A=16, d_model_V=16,
                        d_model_C=16, d_model=32, H=2, N=1, d_ff_A=32,
                        d_ff_V=32, d_ff_C=32, dout_p=0.0)


class OptCfg:
    optimizer = 'adam'
    lr = 1e-3
    grad_clip = 1.0
    weight_decay = 0.0
    beta1, beta2, eps = 0.9, 0.999, 1e-8


def make_batch(B: int = 4):
    rng = np.random.default_rng(42)
    return {
        'src': {
            'rgb': rng.normal(size=(B, 6, 16)).astype(np.float32),
            'flow': rng.normal(size=(B, 6, 16)).astype(np.float32),
            'audio': rng.normal(size=(B, 8, 16)).astype(np.float32),
        },
        'caption': rng.integers(4, 64, size=(B, 7)).astype(np.int64),
    }


def run_step(dp=None, device='cpu'):
    '''One captioning train step on ``device``; returns (loss, checksum:
    the sum of |parameter| after the update). ``dp``: a
    ``parallel.DataParallel`` whose rows this process runs; None runs the
    whole batch in this process.'''
    from bmt_tpu_torch.models import BiModalTransformer
    from bmt_tpu_torch.train.optim import build_optimizer
    from bmt_tpu_torch.train.steps import (init_train_state,
                                           make_cap_train_step)
    device = torch.device(device)
    dims = dryrun_dims()
    model = BiModalTransformer(
        dims, device='cpu',
        generator=torch.Generator().manual_seed(0)).to(device)
    state = init_train_state(model, build_optimizer(OptCfg(), model))
    impl = 'kernel' if device.type == 'cuda' else 'torch'
    step = make_cap_train_step(dims, 0.7, 1, impl, dp=dp)
    batch = make_batch()
    state, metrics = step(state, batch if dp is None else dp.shard(batch))
    checksum = float(sum(p.detach().abs().sum().item()
                         for p in model.parameters()))
    return float(metrics['loss']), checksum


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    p.add_argument('--backend', default=None,
                   help='nccl (a card a rank) or gloo; default: nccl on '
                        'the card, gloo on the CPU')
    args = p.parse_args(argv)
    from bmt_tpu_torch.parallel.mesh import (DataParallel,
                                             maybe_init_distributed,
                                             rank_device)
    device = torch.device(args.device)
    if not maybe_init_distributed(device.type, args.backend):
        raise SystemExit('dryrun_dist: no process group named by the '
                         'environment (torchrun or JAX_* variables)')
    import torch.distributed as dist
    try:
        if dist.get_world_size() != 2:
            raise SystemExit(f'dryrun_dist runs two processes, not '
                             f'{dist.get_world_size()}')
        dev = rank_device(device, dist.get_backend())
        if dev.type == 'cuda':
            torch.cuda.set_device(dev)
        dp = DataParallel(2, dev)
        loss, checksum = run_step(dp, dev)
        print(f'RESULT {loss:.8f} {checksum:.8f}', flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    main()
