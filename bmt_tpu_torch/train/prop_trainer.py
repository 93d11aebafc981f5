'''Proposal-generator trainer (counterpart of
``bmt_tpu.train.prop_trainer``; reference:
scripts/train_proposal_generator.py:15-104): k-means anchors from the train
JSON, the encoder optionally seeded from a pretrained captioner of the same
modality (reference ``.pt`` or native npz) and frozen unless
``--finetune_cap_encoder``, ``validate_prop`` F1 for the best checkpoint,
``last_prop_model`` and ``best_prop_model`` npz checkpoints with the JAX
package's meta keys, resume down to the batch, and the ``PreemptionGuard``;
``--dp_devices N`` over a data-parallel group and ``--fsdp``, as
``train_cap``; ``--sp_devices N`` splits the features' sequences over N
ranks that hold the same rows (``dp_devices x N`` processes;
``parallel.seq``): each rank runs the encoder, the heads and the losses on
its block, and validation gathers the predictions in sequence order.
'''
from __future__ import annotations

import os
from time import perf_counter

import numpy as np
import torch

from bmt_tpu_torch.config import Config
from bmt_tpu_torch.data.proposal_data import ProposalDataset
from bmt_tpu_torch.data.vocab import Vocab, build_vocab_from_meta
from bmt_tpu_torch.models import PropModelDims, proposal_class
from bmt_tpu_torch.params import load_jax_params, to_jax_tree
from bmt_tpu_torch.train.cap_trainer import (checkpoint_writer,
                                             data_parallel, eval_model,
                                             resume, shard_state)
from bmt_tpu_torch.train.checkpoint import (import_any_cap_model,
                                            load_pretrained_encoder_native,
                                            load_torch_checkpoint,
                                            optimizer_state_tree)
from bmt_tpu_torch.train.loops import train_epoch_prop, validate_prop
from bmt_tpu_torch.train.optim import (ReduceLROnPlateau, build_optimizer,
                                       set_learning_rate)
from bmt_tpu_torch.train.options import (attention_impl, check_ported,
                                         compute_dtype, prng_impl,
                                         report_epoch, report_graphs,
                                         report_time, resolve_device)
from bmt_tpu_torch.train.steps import (init_train_state,
                                       make_multistep,
                                       make_prop_inference_step,
                                       make_prop_train_step, prop_frozen)
from bmt_tpu_torch.utils.logging import MetricsLogger, NullLogger
from bmt_tpu_torch.utils.misc import timer
from bmt_tpu_torch.utils.proposal_utils import calc_anchors_using_kmeans


def _load_pretrained_encoder(model, cfg) -> bool:
    '''Seed the encoder from ``--pretrained_cap_model_path`` (reference:
    proposal_generator.py:234-249; a uni-modal captioner's for a uni-modal
    generator, :85-106); returns whether it stays frozen.'''
    path = getattr(cfg, 'pretrained_cap_model_path', None)
    if not path:
        return False
    print(f'Pretrained caption path: \n {path}')
    if path.endswith('.pt'):
        tree = import_any_cap_model(load_torch_checkpoint(path))[0][
            'encoder']
    else:
        # only the encoder subtree transfers, mirroring the reference's
        # 'encoder' key filter (proposal_generator.py:244-246)
        tree = load_pretrained_encoder_native(path, to_jax_tree(model.encoder),
                                              'cap')
    load_jax_params(model.encoder, tree)
    return not getattr(cfg, 'finetune_cap_encoder', False)


def train_prop(cfg: Config, device=None):
    '''Train the proposal generator as ``main.py --procedure train_prop``;
    the card unless ``device`` names another. Returns the best F1.'''
    device = resolve_device(device)
    check_ported(cfg)
    dp = data_parallel(cfg, device)
    dp_step = dp if dp.size > 1 else None
    impl, dtype = attention_impl(cfg), compute_dtype(cfg)
    seed = 0
    np.random.seed(seed)

    t0 = perf_counter()
    anchors = {
        'audio': calc_anchors_using_kmeans(cfg.train_json_path,
                                           cfg.anchors_num_audio),
        'video': calc_anchors_using_kmeans(cfg.train_json_path,
                                           cfg.anchors_num_video)}
    # the reference builds a whole captioning dataset here only to read
    # pad_idx (train_proposal_generator.py:34-35); the vocabulary suffices
    if getattr(cfg, 'vocab_path', None):
        vocab = Vocab.load(cfg.vocab_path)
    else:
        vocab = build_vocab_from_meta(cfg.train_meta_path, cfg.start_token,
                                      cfg.end_token, cfg.pad_token,
                                      cfg.min_freq_caps)
    pad_idx = vocab[cfg.pad_token]
    train_ds = ProposalDataset(cfg, 'train', pad_idx)
    valid_ds = ProposalDataset(cfg, 'val_1', pad_idx)
    report_time('dataset build', t0,
                f' ({len(train_ds.video_ids)} train, '
                f'{len(valid_ds.video_ids)} validation videos; anchors)')

    dims = PropModelDims.from_config(cfg)
    model = proposal_class(dims)(
        dims, device=device,
        generator=torch.Generator(device=device).manual_seed(seed))
    if cfg.modality == 'audio_video':
        model.set_anchors(anchors['audio'], anchors['video'])
    else:
        model.set_anchors(anchors[cfg.modality])
    freeze_encoder = _load_pretrained_encoder(model, cfg)
    optimizer = build_optimizer(cfg, model, frozen=prop_frozen(freeze_encoder),
                                total_steps=cfg.epoch_num * len(train_ds))
    ema_decay = float(getattr(cfg, 'ema_decay', 0.0) or 0.0)
    # accumulation is exact here too: the YOLO masked-mean denominators
    # depend on the targets only (make_prop_train_step)
    train_step = make_prop_train_step(
        dims, pad_idx, impl, dtype,
        accum_steps=getattr(cfg, 'grad_accum_steps', 1) or 1,
        ema_decay=ema_decay, dp=dp_step)
    # --steps_per_dispatch > 1: bundles (see cap_trainer)
    steps_per_dispatch = int(getattr(cfg, 'steps_per_dispatch', 1) or 1)
    multistep = (make_multistep(train_step) if steps_per_dispatch > 1
                 else None)
    inference_step = make_prop_inference_step(dims, pad_idx, impl, dtype,
                                              dp=dp_step)
    state = init_train_state(model, optimizer, seed, ema=ema_decay > 0,
                             prng_impl=prng_impl(cfg))

    n_params = sum(p.numel() for p in optimizer.params)
    print(f'Total Number of Trainable Parameters: {n_params / 1e6} Mil.')
    logger = (MetricsLogger(cfg.log_path) if cfg.to_log and dp.is_main
              else NullLogger())
    logger.add_scalar('debug/param_number', n_params, 0)

    scheduler = None
    if cfg.scheduler == 'reduce_on_plateau':
        scheduler = ReduceLROnPlateau(cfg.lr, cfg.lr_reduce_factor,
                                      cfg.lr_patience, mode='max')

    best_metric, unchanged, start_epoch, resume_batch = -np.inf, 0, 0, 0
    save_ckpt, async_writer = checkpoint_writer(cfg, dp)
    ckpt_dir = cfg.log_path if cfg.to_log else None
    meta = resume(ckpt_dir, 'last_prop_model', state)
    dp.broadcast_module(state.model)
    shard_state(dp, state, cfg)
    if meta is not None:
        start_epoch = meta.get('epoch', -1) + 1
        best_metric = meta.get('best_metric', -np.inf)
        unchanged = meta.get('unchanged', 0)
        resume_batch = meta.get('batch_in_epoch', 0) or 0
        if scheduler is not None and meta.get('scheduler'):
            scheduler.load_state_dict(meta['scheduler'])
            set_learning_rate(state.optimizer, scheduler.lr)
        print(f'Resumed from epoch {start_epoch}'
              + (f' batch {resume_batch}' if resume_batch else ''))

    def meta_of(epoch, **fields):
        return {'config': cfg.to_dict(), 'epoch': epoch,
                'step': int(state.step), 'anchors': anchors,
                'best_metric': float(best_metric), 'unchanged': unchanged,
                'scheduler': (scheduler.state_dict()
                              if scheduler is not None else None),
                **fields}

    def save_epoch(epoch, evaluated, is_best, metrics):
        t0 = perf_counter()
        meta = meta_of(epoch, val_anet_metrics=metrics)
        opt = optimizer_state_tree(state.model, state.optimizer)
        # rolling checkpoint every epoch (resume), best kept apart
        save_ckpt(ckpt_dir, state.model, meta, opt, 'last_prop_model')
        if state.ema is not None:
            save_ckpt(ckpt_dir, evaluated, {'epoch': epoch}, None,
                      'last_prop_model.ema')
        if is_best:
            # best_* holds the weights that scored (EMA when on)
            save_ckpt(ckpt_dir, evaluated, meta, opt, 'best_prop_model')
            print(f'Saved model @ {epoch} epoch. '
                  f'Best metric: {best_metric:.5f}')
        report_time(f'checkpoint save {epoch}', t0,
                    ' (last and best)' if is_best else ' (last)')

    guard = None
    if ckpt_dir and getattr(cfg, 'preempt_save', True):
        from bmt_tpu_torch.utils import preempt
        guard = preempt.PreemptionGuard().install()

    try:
        for epoch in range(start_epoch, cfg.epoch_num):
            print(f'The best metric was unchanged for {unchanged} epochs.')
            print(f'Started @ {cfg.curr_time}; '
                  f'Current timer: {timer(cfg.curr_time)}')
            # >=: a resume with a LOWERED --early_stop_after must still stop
            if unchanged >= cfg.early_stop_after:
                break

            t0, stats = perf_counter(), {}
            state, _ = train_epoch_prop(
                train_step, state, train_ds, epoch, logger, seed,
                guard=guard,
                start_batch=(resume_batch if epoch == start_epoch else 0),
                profile_steps=getattr(cfg, 'profile_steps', 0),
                profile_dir=(os.path.join(cfg.log_path, 'profile')
                             if cfg.log_path else None),
                stats=stats, dp=dp_step, multistep=multistep,
                steps_per_dispatch=steps_per_dispatch)
            state.optimizer.zero_grad()
            report_epoch(f'train epoch {epoch}', t0, stats)
            report_graphs(state)

            if guard is not None and guard.requested:
                b = guard.batch_in_epoch
                with dp.whole(everything=True):
                    save_ckpt(ckpt_dir, state.model, meta_of(
                        epoch - 1 if b else epoch, batch_in_epoch=b or 0,
                        val_anet_metrics=None), state.optimizer,
                        'last_prop_model')
                    if state.ema is not None:
                        save_ckpt(ckpt_dir, eval_model(state),
                                  {'epoch': epoch}, None,
                                  'last_prop_model.ema')
                print(f'[preempt] rolling checkpoint saved @ epoch {epoch} '
                      f'batch {b if b else "end"}; exiting')
                break

            # EMA (if on) is what gets validated and what best_* holds
            with dp.whole():
                evaluated = eval_model(state)
                t0 = perf_counter()
                avg_f1, metrics = validate_prop(cfg, inference_step,
                                                evaluated, valid_ds, epoch,
                                                logger, dp=dp_step)
            avg = metrics['Average across tIoUs']
            report_time(f'proposal validation {epoch}', t0,
                        f' (precision {avg["Precision"]:.6f}, recall '
                        f'{avg["Recall"]:.6f}, F1 {avg_f1:.6f})')

            if scheduler is not None:
                set_learning_rate(state.optimizer, scheduler.step(avg_f1))

            is_best = avg_f1 > best_metric
            if is_best:
                best_metric = avg_f1
                unchanged = 0
            else:
                unchanged += 1

            if ckpt_dir:
                # the whole weights, moments and EMA on every rank; rank 0
                # writes them
                with dp.whole(everything=True):
                    if dp.shards is not None:
                        evaluated = eval_model(state)
                    if dp.is_main:
                        save_epoch(epoch, evaluated, is_best, metrics)
            del evaluated
    finally:
        if guard is not None:
            guard.uninstall()
        if async_writer is not None:
            async_writer.close()
    print(f'Experiment: {cfg.curr_time[2:]}')
    logger.close()
    return best_metric
