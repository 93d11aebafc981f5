'''Epoch-level training and validation loops, and the 1-by-1 greedy-decode
validation that writes and scores an ActivityNet submission (counterpart of
``bmt_tpu.train.loops``).

Each loop walks a dataset with ``batch_size`` and ``batches(epoch=, seed=,
shuffle=, start_batch=)``: the port's ``CaptioningDataset`` and
``ProposalDataset``, or any object with that interface. In the captioning
loops a short tail batch is repeat-padded to ``batch_size`` and its padded
rows are masked out of the loss by ``row_valid``, as in the JAX loops; the
proposal loop drops it, as ``ProposalDataset`` does in training. The losses
stay on the device until the epoch ends.

The train loops take the JAX loops' ``guard`` (a ``PreemptionGuard`` polled
after every step) and ``start_batch`` (the batch-exact resume), and
``profile_steps``: a ``torch.profiler`` trace of the first steps of epoch 0,
closed in ``finally`` in both loops. ``stats``, when a dict, receives the
seconds each batch was waited for (``wait_s``: the loop blocked on the
prefetch queue) and the seconds from each batch's arrival to the next
(``step_s``).

Data parallelism (``dp``, a ``parallel.DataParallel``): each rank loads
only its row block of every batch (the datasets' ``local_rows``) and steps
on it; the validation loss is summed over the ranks, the decode runs on
each rank's rows and is gathered in row order, rank 0 alone writes and
scores the submission and hands the scores to the others, and a preemption
signal on any rank stops every rank after the same step. The ranks of one
sp or ep group load the same rows (``local_rows`` reads the dp
coordinate).

Multi-step dispatch (``multistep``, ``train.steps.make_multistep``, with
``steps_per_dispatch`` K > 1): the train loops run bundles of K batches
through ``multistep``, an epoch's tail shorter than a bundle through the
single step, and poll the guard between bundles, so the exact-resume point
comes at most K - 1 batches after the signal, as in the JAX loops.
'''
from __future__ import annotations

import json
import os
import sys
from time import perf_counter, time
from typing import Optional

import numpy as np
import torch

from bmt_tpu_torch.decode.beam import make_bimodal_beam_fn
from bmt_tpu_torch.decode.greedy import make_bimodal_greedy_fn
from bmt_tpu_torch.decode.sample import make_bimodal_sample_fn
from bmt_tpu_torch.evaluation.metrics import calculate_metrics
from bmt_tpu_torch.serve import ints_to_sentence
from bmt_tpu_torch.utils.misc import HiddenPrints
from bmt_tpu_torch.utils.proposal_utils import add_dict_to_another_dict

__all__ = ['busy_union', 'device_busy_ms', 'device_intervals',
           'ints_to_sentence', 'make_decode_fn', 'make_strategy_fn',
           'train_epoch_cap',
           'train_epoch_prop', 'validate_next_word', 'validate_prop',
           'validation_1by1']


def _pad_batch_to(batch: dict, B: int) -> dict:
    '''Repeat the last row of every array leaf up to B rows.'''
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.shape and v.shape[0] < B:
            out[k] = np.concatenate([v] + [v[-1:]] * (B - v.shape[0]))
        elif isinstance(v, dict):
            out[k] = _pad_batch_to(v, B)
        else:
            out[k] = v
    return out


def _step_batch(batch: dict, B: int) -> dict:
    '''{'src', 'caption', 'row_valid'} of a host batch padded to B rows.'''
    n_valid = len(batch['video_ids'])
    if n_valid != B:
        batch = _pad_batch_to(batch, B)
    return {'src': batch['src'], 'caption': batch['caption'],
            'row_valid': np.arange(B) < n_valid}


def device_intervals(events) -> list:
    '''[(start_us, end_us, stream)] of the device activity in a profiler's
    event list (``prof.events()``): every CUDA kernel, copy and set, the
    user annotations (spans around other events) aside.'''
    from torch.autograd import DeviceType
    return [(e.time_range.start, e.time_range.end, e.device_resource_id)
            for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)]


def busy_union(intervals) -> float:
    '''The length of the union of ``(start, end, ...)`` intervals: the time
    the device ran at least one of them. Kernels that overlap in time (on
    two streams) count once, where a sum of their durations counts them
    twice.'''
    total, start, end = 0.0, None, None
    for s, e, *_ in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    return total + (end - start if end is not None else 0.0)


def device_busy_ms(events) -> dict:
    '''{'union_ms', 'sum_ms', 'kernels', 'streams'} of a profiler's event
    list: the device's busy time as the union of its activity's intervals,
    beside their summed durations, their number and the streams they ran
    on.'''
    iv = device_intervals(events)
    return {'union_ms': busy_union(iv) / 1e3,
            'sum_ms': sum(e - s for s, e, _ in iv) / 1e3,
            'kernels': len(iv), 'streams': len({k for *_, k in iv})}


class _EpochProfiler:
    '''A ``torch.profiler`` trace of the first ``profile_steps`` steps of
    epoch 0 (both loops' ``--profile_steps``), written as a Chrome trace
    under ``profile_dir``; on close it prints the device kernels' ms per
    step and the traced steps' wall time (host clock, the card synchronised
    at both ends). The device time is the union of the device activity's
    intervals (``device_busy_ms``; their sum, which counts overlapping
    kernels twice, is printed beside it). That wall time holds the
    profiler's own host work too, so their ratio reads below the busy share
    of an unprofiled run. A trace the profiler cannot summarise skips the
    summary, never the epoch.'''

    def __init__(self, profile_steps: int, epoch: int, profile_dir):
        self.n_target = profile_steps
        self.dir = profile_dir
        self.prof = None
        if profile_steps > 0 and epoch == 0 and profile_dir:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize()
            self.prof = profile(activities=activities)
            self.prof.__enter__()
            self.t0 = perf_counter()

    def step(self, n: int):
        '''Call after every step; closes once n reaches the target.'''
        if self.prof is not None and n >= self.n_target:
            self.close(n)

    def close(self, n: int):
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall_ms = 1e3 * (perf_counter() - self.t0)
        prof.__exit__(None, None, None)
        try:
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, 'trace.json')
            prof.export_chrome_trace(path)
            busy = device_busy_ms(prof.events())
            device_ms, steps = busy['union_ms'], max(n, 1)
            print(f'[profile] traced device time: '
                  f'{device_ms / steps:.3f} ms/step over {n} steps in '
                  f'{wall_ms:.1f} ms of wall time '
                  f'({100 * device_ms / wall_ms:.1f}% of it, the '
                  f'profiler\'s host work included; the union of '
                  f'{busy["kernels"]} kernels\' intervals on '
                  f'{busy["streams"]} streams, their sum '
                  f'{busy["sum_ms"] / steps:.3f} ms/step; {path})',
                  file=sys.stderr)
        except Exception as e:
            print(f'[profile] trace summary unavailable: '
                  f'{type(e).__name__}: {e}', file=sys.stderr)


def _timed(batches, stats: Optional[dict]):
    '''Yield from ``batches``, recording into ``stats`` (when a dict) the
    seconds blocked on each batch and those from each batch to the next.'''
    if stats is None:
        yield from batches
        return
    waits, steps = stats.setdefault('wait_s', []), stats.setdefault(
        'step_s', [])
    it = iter(batches)
    while True:
        t0 = perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        t1 = perf_counter()
        waits.append(t1 - t0)
        yield batch
        steps.append(perf_counter() - t1)


def _batches_kw(dataset, start_batch: int = 0, dp=None) -> dict:
    '''``batches()``'s keywords: the resume cursor and, under data
    parallelism, this rank's rows (when the batch splits evenly).'''
    kw = {'start_batch': start_batch} if start_batch else {}
    if dp is not None and dp.n_dp > 1 \
            and dataset.batch_size % dp.n_dp == 0:
        kw['local_rows'] = dp.local_rows(dataset.batch_size)
    return kw


def _stop(guard, dp) -> bool:
    '''Whether a preemption was asked for, on any rank; the ranks agree
    after every step, so all of them stop after the same one.'''
    if guard is None:               # the same on every rank: no collective
        return False
    requested = guard.requested
    if dp is not None and dp.size > 1:
        requested = guard.requested = dp.any(requested)
    return requested


def _on_rank(batch: dict, dp) -> dict:
    return batch if dp is None else dp.shard(batch)


class _Bundler:
    '''Runs a train loop's steps one at a time, or in bundles of
    ``steps_per_dispatch`` through ``multistep``: ``add(batch)`` returns
    [(metrics, steps)] of what ran (nothing while a bundle fills; a
    bundle's metrics summed over its steps); ``tail()`` yields (metrics, 1)
    for each batch that a short last bundle left, run one step each.'''

    def __init__(self, train_step, multistep, steps_per_dispatch: int,
                 state):
        self.step, self.multistep = train_step, multistep
        self.k = steps_per_dispatch if multistep is not None else 1
        self.state, self.pending, self.bundled = state, [], 0

    def add(self, batch: dict) -> list:
        if self.k == 1:
            self.state, metrics = self.step(self.state, batch)
            return [(metrics, 1)]
        self.pending.append(batch)
        if len(self.pending) < self.k:
            return []
        bundle, self.pending = self.pending, []
        self.state, metrics = self.multistep(self.state, bundle)
        self.bundled += self.k
        return [({k: v.sum() for k, v in metrics.items()}, self.k)]

    def tail(self):
        pending, self.pending = self.pending, []
        for batch in pending:
            self.state, metrics = self.step(self.state, batch)
            yield metrics, 1

    def even_out(self, stats: Optional[dict]) -> None:
        '''``stats['step_s']`` holds a bundle's seconds on its last batch
        and ~0 on the others: give each of its batches the bundle's
        mean.'''
        steps = None if stats is None else stats.get('step_s')
        if not steps or self.k == 1:
            return
        for i in range(0, self.bundled, self.k):
            mean = sum(steps[i:i + self.k]) / self.k
            steps[i:i + self.k] = [mean] * self.k


def train_epoch_cap(train_step, state, dataset, epoch: int, logger=None,
                    seed: int = 0, profile_steps: int = 0, profile_dir=None,
                    guard=None, start_batch: int = 0,
                    stats: Optional[dict] = None, dp=None, multistep=None,
                    steps_per_dispatch: int = 1):
    '''Teacher-forced training epoch (reference:
    captioning_epoch_loops.py:122-149). Returns (state, mean loss).

    guard: optional ``PreemptionGuard``, polled after every step (bundle);
    on request the epoch stops early with ``guard.batch_in_epoch`` the
    index of the next unprocessed batch. start_batch: skip the first k
    batches (exact resume of an interrupted epoch; the batch order is fixed
    by (seed, epoch)). dp: this rank's rows of each batch go to
    ``train_step``. multistep, steps_per_dispatch: bundles of that many
    steps (module docstring).'''
    total, n = 0.0, 0
    runner = _Bundler(train_step, multistep, steps_per_dispatch, state)
    prof = _EpochProfiler(profile_steps, epoch, profile_dir)
    try:
        for batch in _timed(dataset.batches(
                epoch=epoch, seed=seed,
                **_batches_kw(dataset, start_batch, dp)), stats):
            ran = runner.add(_on_rank(_step_batch(batch, dataset.batch_size),
                                      dp))
            for metrics, k in ran:
                total = total + metrics['loss']      # a device scalar
                n += k
            if not ran:
                continue
            prof.step(n)
            if _stop(guard, dp):
                guard.batch_in_epoch = start_batch + n
                break
        else:                   # the tail that did not fill a bundle
            for metrics, k in runner.tail():
                total = total + metrics['loss']
                n += k
                if _stop(guard, dp):
                    guard.batch_in_epoch = start_batch + n
                    break
    finally:
        prof.close(n)
    state = runner.state
    runner.even_out(stats)
    mean = float(total) / max(n, 1)
    if logger is not None:
        logger.add_scalar('debug/train_loss_epoch', mean, epoch)
    return state, mean


def validate_next_word(val_step, model, dataset, epoch: int,
                       dp=None) -> float:
    '''Mean next-word validation loss over the dataset's batches
    (reference: captioning_epoch_loops.py:152-172); under ``dp`` each
    batch's loss is the global batch's (``make_cap_val_step(dp=)``).'''
    total, n = 0.0, 0
    for batch in dataset.batches(epoch=0, shuffle=False,
                                 **_batches_kw(dataset, dp=dp)):
        total = total + val_step(model, _on_rank(
            _step_batch(batch, dataset.batch_size), dp))
        n += 1
    return float(total) / max(n, 1)


def make_strategy_fn(options, dims, max_len: int, dataset,
                     attention_impl: str = 'torch', seed: int = 0):
    '''The decoder of ``options.decode_strategy``, bound as the JAX trainer
    and evaluation bind theirs (``bmt_tpu/train/cap_trainer.py:186-209``):
    greedy, beam (``--beam_size``, ``--length_penalty``) or sampling
    (``--temperature``, ``--sample_top_k``, ``--sample_top_p``, draws from
    ``seed``), each with the int8 cross K/V of ``--kv_cache_int8``.
    ``dataset`` gives the start, end and pad ids. Returns fn(model,
    feature_stacks) -> (B, max_len + 1) tokens.'''
    strategy = getattr(options, 'decode_strategy', 'greedy') or 'greedy'
    ids = (dataset.start_idx, dataset.end_idx, dataset.pad_idx)
    kv_int8 = bool(getattr(options, 'kv_cache_int8', False))
    if strategy == 'beam':
        return make_bimodal_beam_fn(
            dims, max_len, *ids, options.beam_size, options.length_penalty,
            attention_impl, kv_int8)
    if strategy == 'sample':
        return make_bimodal_sample_fn(
            dims, max_len, *ids, options.temperature,
            getattr(options, 'sample_top_k', 0),
            getattr(options, 'sample_top_p', 1.0), attention_impl, kv_int8,
            seed=seed)
    if strategy != 'greedy':
        raise ValueError(f'--decode_strategy {strategy!r}: greedy, beam or '
                         f'sample')
    return make_bimodal_greedy_fn(dims, max_len, *ids, attention_impl,
                                  kv_int8)


def make_decode_fn(greedy_fn, compute_dtype=None, dp=None):
    '''Decode wrapper shared by the trainer and the eval script:
    decode_fn(model, src) takes numpy feature stacks, moves them to the
    model's device in ``compute_dtype`` (the model's own dtype when None)
    and returns greedy_fn(model, stacks), the (B, max_len + 1) tokens.
    ``dp`` (a ``parallel.DataParallel`` or ``LocalReplicas``) decodes the
    batch's rows split over its ranks or replicas and joins them in row
    order.'''

    def decode_fn(model, src):
        p = next(model.parameters())
        dtype = compute_dtype or p.dtype
        stacks = {k: torch.as_tensor(x).to(p.device, dtype)
                  for k, x in src.items()}
        if dp is not None and dp.size > 1:
            return dp.decode(greedy_fn, model, stacks)
        return greedy_fn(model, stacks)
    return decode_fn


def validation_1by1(cfg, model, decoder_fn, dataset, epoch: int,
                    logger=None, phase: Optional[str] = None, dp=None):
    '''Greedy-decode every validation segment, write the submission JSON and
    score it (reference: captioning_epoch_loops.py:174-292).

    decoder_fn(model, feature_stacks) -> (B, max_len + 1) token ids. The
    greedy loop syncs with the host at every step, so each batch's
    sentences are built once its decode returns; the order of the JAX
    loop's one-deep pipeline is kept. ``dp``: ``decoder_fn`` gathers the
    ranks' rows (``make_decode_fn(dp=)``), each rank loads only its rows,
    rank 0 writes and scores the submission, and every rank returns its
    scores.'''
    start_timer = time()
    phase = phase or dataset.phase
    predictions = {
        'version': 'VERSION 1.0',
        'external_data': {'used': True, 'details': ''},
        'results': {},
    }

    if phase == 'val_1':
        reference_paths = [cfg.reference_paths[0]]
        tIoUs = [0.5]
    elif phase == 'val_2':
        reference_paths = [cfg.reference_paths[1]]
        tIoUs = [0.5]
    elif phase == 'learned_props':
        reference_paths = cfg.reference_paths
        tIoUs = cfg.tIoUs
        assert len(tIoUs) == 4
    else:
        raise ValueError(phase)

    def flush(batch, tokens):
        ints_stack = np.asarray(tokens.cpu())[:len(batch['video_ids'])]
        for vid, start, end, ints in zip(batch['video_ids'], batch['starts'],
                                         batch['ends'], ints_stack):
            segment = {
                'sentence': ints_to_sentence(ints, dataset.train_vocab,
                                             cfg.end_token),
                'timestamp': [float(start), float(end)],
            }
            predictions['results'].setdefault(vid, []).append(segment)

    t0 = perf_counter()
    in_flight = None
    for batch in dataset.batches(epoch=0, shuffle=False,
                                 **_batches_kw(dataset, dp=dp)):
        padded = _pad_batch_to(batch, dataset.batch_size)
        tokens = decoder_fn(model, padded['src'])
        if in_flight is not None:
            flush(*in_flight)
        in_flight = (batch, tokens)
    if in_flight is not None:
        flush(*in_flight)
    decode_s = perf_counter() - t0
    if dp is not None and not dp.is_main:
        return dp.broadcast_object(None)

    # a disabled (--dont_log) or empty log dir must not disable SCORING:
    # the decode work is already paid and best-model/early-stop tracking
    # depends on the metrics — fall back to ./tmp for the submission file
    # (AnetPredictions uses the same fallback)
    out_dir = cfg.log_path or './tmp'
    os.makedirs(out_dir, exist_ok=True)
    submission_path = os.path.join(
        out_dir, f'captioning_results_{phase}_e{epoch}.json')
    if os.path.exists(submission_path):
        submission_path = submission_path.replace('.json', f'_{time()}.json')
    with open(submission_path, 'w') as f:
        json.dump(predictions, f)

    t0 = perf_counter()
    with HiddenPrints():
        val_metrics = calculate_metrics(reference_paths, submission_path,
                                        tIoUs, cfg.max_prop_per_vid)
    print(f'[time] {phase} 1-by-1 decode: {decode_s:.3f} s '
          f'({dataset.num_rows()} segments); scoring: '
          f'{perf_counter() - t0:.3f} s')
    if phase == 'learned_props':
        print(submission_path)

    if logger is not None and phase != 'learned_props':
        avg = val_metrics['Average across tIoUs']
        logger.add_scalar(f'{phase}/meteor', avg['METEOR'] * 100, epoch)
        logger.add_scalar(f'{phase}/bleu4', avg['Bleu_4'] * 100, epoch)
        logger.add_scalar(f'{phase}/bleu3', avg['Bleu_3'] * 100, epoch)
        logger.add_scalar(f'{phase}/precision', avg['Precision'] * 100, epoch)
        logger.add_scalar(f'{phase}/recall', avg['Recall'] * 100, epoch)
        logger.add_scalar(f'{phase}/duration_of_1by1',
                          (time() - start_timer) / 60, epoch)
    if dp is not None:
        dp.broadcast_object(val_metrics)
    return val_metrics


def train_epoch_prop(train_step, state, dataset, epoch: int, logger=None,
                     seed: int = 0, guard=None, start_batch: int = 0,
                     profile_steps: int = 0, profile_dir=None,
                     stats: Optional[dict] = None, dp=None, multistep=None,
                     steps_per_dispatch: int = 1):
    '''Proposal-generator training epoch (reference:
    proposal_epoch_loops.py:27-63). The dataset's batches hold 'src',
    'centers', 'lengths' and 'valid'; a batch shorter than ``batch_size``
    (the tail) is dropped. guard, start_batch, profile_steps, stats, dp,
    multistep, steps_per_dispatch: as in ``train_epoch_cap``. Returns
    (state, mean loss).'''
    total, n, acc = 0.0, 0, {}
    runner = _Bundler(train_step, multistep, steps_per_dispatch, state)
    prof = _EpochProfiler(profile_steps, epoch, profile_dir)

    def account(ran):
        nonlocal total, n, acc
        for metrics, k in ran:
            total = total + metrics['loss']           # device scalars
            acc = add_dict_to_another_dict(
                {key: v for key, v in metrics.items() if key != 'loss'}, acc)
            n += k
    try:
        for batch in _timed(dataset.batches(
                epoch=epoch, seed=seed,
                **_batches_kw(dataset, start_batch, dp)), stats):
            if len(batch['valid']) < dataset.batch_size:
                continue                              # drop_last
            ran = runner.add(_on_rank({
                k: batch[k] for k in ('src', 'centers', 'lengths', 'valid')},
                dp))
            account(ran)
            if not ran:
                continue
            prof.step(n)
            if _stop(guard, dp):
                guard.batch_in_epoch = start_batch + n
                break
        else:
            for ran in runner.tail():
                account([ran])
                if _stop(guard, dp):
                    guard.batch_in_epoch = start_batch + n
                    break
    finally:
        prof.close(n)
    state = runner.state
    runner.even_out(stats)
    if n == 0 and start_batch == 0:
        print(f'WARNING: proposal train epoch {epoch} ran ZERO batches -- '
              f'the dataset has fewer videos than the batch size '
              f'{dataset.batch_size} and the last partial batch is dropped; '
              f'nothing was trained this epoch', file=sys.stderr)
    mean = float(total) / max(n, 1)
    if logger is not None:
        logger.add_scalar('debug/loss_epoch', mean, epoch)
        for k, v in acc.items():
            logger.add_scalar(f'debug/train_{k}', float(v) / max(n, 1),
                              epoch)
    else:
        print(f'Train Loss @ {epoch} epoch: {mean}')
    return state, mean


def validate_prop(cfg, inference_step, model, dataset, epoch: int,
                  logger=None, dp=None):
    '''Proposal validation -> AnetPredictions -> detection P/R/F1
    (reference: proposal_epoch_loops.py:99-140). Returns (avg F1,
    metrics). ``dp``: each rank predicts its rows, the predictions are
    gathered in row order, rank 0 writes and scores them and every rank
    returns the scores.'''
    from bmt_tpu_torch.utils.proposal_utils import (AnetPredictions,
                                                    calculate_f1)
    main = dp is None or dp.is_main
    anet = AnetPredictions(cfg, dataset.phase, epoch) if main else None
    for batch in dataset.batches(epoch=0, shuffle=False,
                                 **_batches_kw(dataset, dp=dp)):
        n_valid = len(batch['video_ids'])
        padded = _pad_batch_to(batch, dataset.batch_size)
        src = {'src': padded['src']}
        if dp is None or dp.size == 1:
            preds = inference_step(model, src)
        else:
            local = dp.maybe_shard(src)
            preds = inference_step(model, local)
            if local is not src:
                preds = dp.gather_rows(preds)
        if main:
            anet.add_new_predictions(preds.cpu().numpy()[:n_valid], batch)
    if not main:
        return dp.broadcast_object(None)
    anet.write_anet_predictions_to_json()
    metrics = anet.evaluate_predictions()

    if logger is not None:
        for tiou in cfg.tIoUs:
            p, r = metrics[tiou]['Precision'], metrics[tiou]['Recall']
            logger.add_scalar(f'densevid_eval_k/precision_{tiou}', p, epoch)
            logger.add_scalar(f'densevid_eval_k/recall_{tiou}', r, epoch)
            logger.add_scalar(f'densevid_eval_k/F1_{tiou}',
                              calculate_f1(r, p), epoch)
    avg_p = metrics['Average across tIoUs']['Precision']
    avg_r = metrics['Average across tIoUs']['Recall']
    avg_f1 = calculate_f1(avg_r, avg_p)
    if logger is not None:
        logger.add_scalar('metrics/avg_precision_at_k', avg_p, epoch)
        logger.add_scalar('metrics/avg_recall_at_k', avg_r, epoch)
        logger.add_scalar('metrics/avg_F1_at_k', avg_f1, epoch)
    if dp is not None:
        dp.broadcast_object((avg_f1, metrics))
    return avg_f1, metrics
