'''The port's counterpart of ``main.py``, with the reference's procedures
(reference: main.py:20-184):

    python -m bmt_tpu_torch --procedure {train_cap,train_prop,evaluate} \\
        [main.py's flags] [--device cuda|cuda:N|cpu]

``--device`` (the card by default; the CPU only when asked) is the port's
own and stays out of the ``Config``, so a checkpoint's config dict is the
JAX package's. ``--debug`` builds the config and runs no procedure, as in
the reference. Nothing is imported from torch until a procedure runs: the
METEOR worker pool spawns processes that re-import this module.

Data parallelism, as main.py's ``--dp_devices N`` (``Config.train_batch_size
= B * N``, the global batch): under torchrun (or the JAX package's
``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) each
process joins the group, which must have N ranks; with no group around it
the command spawns N workers, one a card (``parallel.launch.spawn``), and
returns rank 0's result. The group runs on NCCL on the card and on gloo on
the CPU. ``--sp_devices M`` (train_prop) and ``--ep_devices M`` (train_cap)
multiply the ranks: N x M processes, the ranks of one sp or ep group
sharing a row block (``parallel.mesh.axes``); ``--fsdp`` shards the large
parameters over the N dp ranks.
'''
from __future__ import annotations

from pprint import pprint

from bmt_tpu_torch.config import Config, build_parser


def build_cli_parser():
    '''``build_parser()`` plus the port's ``--device``.'''
    parser = build_parser()
    parser.add_argument('--device', type=str, default='cuda',
                        help='where the models run: cuda (default), cuda:N, '
                             'or cpu')
    return parser


def run(cfg: Config, device='cuda'):
    '''Run ``cfg.procedure`` on ``device``; returns what the procedure
    returns (the best METEOR, the best F1, the evaluation's metrics).'''
    if cfg.procedure == 'train_cap':
        from bmt_tpu_torch.train.cap_trainer import train_cap
        return train_cap(cfg, device)
    if cfg.procedure == 'train_prop':
        from bmt_tpu_torch.train.prop_trainer import train_prop
        return train_prop(cfg, device)
    if cfg.procedure == 'evaluate':
        from bmt_tpu_torch.scripts.eval_on_learned_props import \
            eval_on_learned_props
        return eval_on_learned_props(cfg, device)
    raise NotImplementedError(cfg.procedure)


def main(argv=None):
    args = build_cli_parser().parse_args(argv)
    device = args.device
    del args.device
    pprint(vars(args))
    cfg = Config(args)
    if args.debug:
        # reference quirk (main.py:178-182): --debug is a hook for ad-hoc
        # experiments with a fully-built Config and runs NO procedure
        print('--debug: config built, no procedure run '
              '(reference main.py:178-182 semantics)')
        return None
    import numpy as np
    import torch
    import torch.distributed as dist

    from bmt_tpu_torch.parallel import maybe_init_distributed, rank_device
    from bmt_tpu_torch.parallel.mesh import axes
    device_type = torch.device(device).type
    if maybe_init_distributed(device_type):
        device = rank_device(device, dist.get_backend())
        if device.type == 'cuda':
            torch.cuda.set_device(device)
        return run(cfg, device)
    ranks = int(np.prod(axes(cfg)))
    if ranks > 1:
        from bmt_tpu_torch.parallel.launch import spawn
        return spawn(run, (cfg,), ranks, device)[0]
    return run(cfg, device)


if __name__ == '__main__':
    main()
