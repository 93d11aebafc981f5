'''How the port's trainers and evaluation read a ``Config``: the device, the
JAX package's flag values in the port's terms, the options that are not
ported (orbax), and the timing lines they print.

The config keeps the JAX flag values, so a config dict round-trips between
the packages; ``--attention_impl pallas`` (the Pallas kernels) reads as the
port's ``'kernel'`` (the CUDA kernels) and ``xla`` (plain jnp attention) as
``'torch'``.
'''
from __future__ import annotations

import json
import statistics
from time import perf_counter

import torch

ATTENTION_IMPL = {'pallas': 'kernel', 'xla': 'torch'}


def resolve_device(device=None) -> torch.device:
    '''``device`` as a torch.device, the card when None; a CUDA device
    without a card raises (nothing falls back to the CPU).'''
    device = torch.device(device or 'cuda')
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {device} asked for, but no CUDA device is available; '
            f'pass device "cpu" (the CLI\'s --device cpu) to run on the CPU')
    return device


def attention_impl(cfg) -> str:
    '''The port's attention for the config's ``--attention_impl``.'''
    flag = getattr(cfg, 'attention_impl', 'xla')
    if flag not in ATTENTION_IMPL:
        raise ValueError(f'--attention_impl {flag!r}: one of '
                         f'{sorted(ATTENTION_IMPL)}')
    return ATTENTION_IMPL[flag]


def prng_impl(cfg) -> str:
    '''The dropout PRNG of ``--prng_impl`` (``train.steps.init_train_state``):
    'rbg' by default, as the JAX trainers default; 'threefry2x32' draws
    JAX's masks bit for bit.'''
    from bmt_tpu_torch.train.steps import PRNG_IMPLS
    flag = getattr(cfg, 'prng_impl', 'rbg')
    if flag not in PRNG_IMPLS:
        raise ValueError(f'--prng_impl {flag!r}: one of {PRNG_IMPLS}')
    return flag


def compute_dtype(cfg, default: str = 'float32') -> torch.dtype:
    return (torch.bfloat16
            if getattr(cfg, 'compute_dtype', default) == 'bfloat16'
            else torch.float32)


MODALITIES = ('audio', 'video', 'audio_video')


def check_model_ported(cfg) -> None:
    '''Raise ValueError for a modality that no model is built for: the
    bi-modal models take audio_video, the uni-modal ones audio or video.'''
    modality = getattr(cfg, 'modality', 'audio_video')
    if modality not in MODALITIES:
        raise ValueError(f'--modality {modality!r}: one of {MODALITIES}')


def check_ported(cfg) -> None:
    '''Raise for a model or an option of the config that the port does not
    run: NotImplementedError, naming its ROADMAP item, for orbax (item
    12).
    ``--fsdp``, ``--ep_devices`` (train_cap) and ``--sp_devices``
    (train_prop) run, alone and together; in the other procedures they
    have no effect, as in the JAX package.'''
    check_model_ported(cfg)
    if getattr(cfg, 'ckpt_format', 'npz') != 'npz':
        raise NotImplementedError(
            f'--ckpt_format {cfg.ckpt_format}: the port reads and writes the '
            f'npz format only; orbax is not ported (ROADMAP queue 1 item 12)')


def report_time(stage: str, t0: float, extra: str = '') -> float:
    '''Print ``[time] <stage>: <seconds since t0> s`` and return the
    seconds.'''
    s = perf_counter() - t0
    print(f'[time] {stage}: {s:.3f} s{extra}')
    return s


def report_epoch(stage: str, t0: float, stats: dict) -> float:
    '''``report_time`` of a train epoch, with its steps, the median seconds
    from one batch to the next and the loop's median wait on the prefetch
    queue (``stats`` from the epoch loop).'''
    steps, waits = stats.get('step_s', []), stats.get('wait_s', [])

    def median_ms(xs):
        return 1e3 * statistics.median(xs) if xs else float('nan')
    return report_time(stage, t0, (
        f', {len(waits)} batches, {median_ms(steps):.2f} ms/step (median, '
        f'host clock), prefetch wait {median_ms(waits):.2f} ms/batch '
        f'(median; max {1e3 * max(waits, default=0):.2f}; '
        f'{sum(waits):.3f} s in all)'))


def report_graphs(state) -> None:
    '''Print ``[graphs]`` with the CUDA graphs of ``--steps_per_dispatch``
    that the state holds (``train.graphs.StepGraphs.report``), when it
    holds any.'''
    if state.graphs is not None:
        print(f'[graphs] {json.dumps(state.graphs.report())}')
