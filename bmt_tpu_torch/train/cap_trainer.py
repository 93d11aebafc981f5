'''Captioning-module trainer (counterpart of
``bmt_tpu.train.cap_trainer``; reference:
scripts/train_captioning_module.py:18-135).

The JAX trainer's flow on an explicit ``device``: the three datasets, the
captioner from a seed (GloVe table frozen unless ``--unfreeze_word_emb``;
the encoder seeded from a proposal checkpoint and frozen unless
``--finetune_prop_encoder``; or the whole model seeded from a captioner
checkpoint), the optimizer and ``ReduceLROnPlateau``, EMA and gradient
accumulation, next-word validation each epoch and from
``--one_by_one_starts_at`` the 1-by-1 greedy decode scored with METEOR,
best-METEOR tracking with early stop, ``last_cap_model`` and
``best_cap_model`` npz checkpoints with the JAX package's meta keys
(optionally written by ``AsyncCheckpointWriter``), resume from
``last_cap_model`` down to the batch, and the ``PreemptionGuard``.

The model options run as in the JAX trainer: Switch MoE FFNs
(``--moe_experts``, their load-balance loss weighted by
``--moe_aux_coeff``); LoRA finetuning (``--lora_rank``, ``--lora_alpha``,
``--lora_targets``: adapters added after the full-model seed, everything
else frozen, ``best_cap_model.lora.npz`` written beside the best model); a
bf16 Adam first moment (``--optim_mu_dtype``). The 1-by-1 decode follows
``--decode_strategy`` with ``--kv_cache_int8``; ``--weights_int8`` is for
the evaluation, and train_cap leaves it aside, as the JAX trainer does.

``--dp_devices N`` trains over a data-parallel group of N ranks (one
process a card, spawned by ``python -m bmt_tpu_torch`` or joined under
torchrun; ``parallel.DataParallel``): the global batch ``B * N`` is split
over the ranks, every rank loads the same weights (rank 0's are broadcast
after the resume), and rank 0 alone writes checkpoints, logs and scores, as
the JAX package's process 0 does. ``--fsdp`` (with ``--fsdp_min_elems``)
shards the large parameters, their Adam moments and the EMA over the dp
ranks, and ``--ep_devices N`` (with ``--moe_experts`` divisible by N) the
MoE experts over N ranks that see the same rows (``dp_devices x N``
processes; ``parallel.DataParallel.shard_params``); validation, checkpoints
and resumes see the whole model (``DataParallel.whole``), so a directory
written under either flag is an unsharded run's.

``--modality audio`` or ``video`` trains the uni-modal captioner
(``UniModalTransformer``), its encoder optionally seeded from a uni-modal
proposal checkpoint, as the JAX trainer does.

Weights start from a ``torch.Generator`` seeded with 0, not from the JAX
package's PRNG, so the two packages train the same recipe from different
random weights; from one checkpoint they train alike.
'''
from __future__ import annotations

import copy
import os
import re
from time import perf_counter

import numpy as np
import torch

from bmt_tpu_torch.config import Config
from bmt_tpu_torch.data.captioning import CaptioningDataset
from bmt_tpu_torch.data.vocab import load_glove
from bmt_tpu_torch.models import CapModelDims, captioner_class
from bmt_tpu_torch.ops.lora import add_lora, count_lora, lora_frozen_predicate
from bmt_tpu_torch.parallel import DataParallel
from bmt_tpu_torch.parallel.mesh import axes
from bmt_tpu_torch.params import load_jax_params, to_jax_tree
from bmt_tpu_torch.train.checkpoint import (
    AsyncCheckpointWriter, _has_orbax, _orbax_only, cap_embedding_key,
    checkpoint_exists, import_prop_model, import_unimodal_prop_model,
    load_checkpoint, load_model_params,
    load_pretrained_cap_params, load_pretrained_encoder_native,
    load_torch_checkpoint, optimizer_state_tree, save_checkpoint,
    save_lora_npz)
from bmt_tpu_torch.train.loops import (make_decode_fn, make_strategy_fn,
                                       train_epoch_cap, validate_next_word,
                                       validation_1by1)
from bmt_tpu_torch.train.optim import (ReduceLROnPlateau, build_optimizer,
                                       set_learning_rate)
from bmt_tpu_torch.train.options import (attention_impl, check_ported,
                                         compute_dtype, prng_impl,
                                         report_epoch, report_graphs,
                                         report_time, resolve_device)
from bmt_tpu_torch.train.steps import (TrainState, init_train_state,
                                       make_cap_train_step, make_cap_val_step,
                                       make_multistep)
from bmt_tpu_torch.utils.logging import MetricsLogger, NullLogger
from bmt_tpu_torch.utils.misc import average_metrics_in_two_dicts, timer


def _glove_dim(cfg) -> int:
    '''Embedding width of the configured GloVe vectors: parsed from the
    "<N>d" suffix of the vectors name/path (reference torchtext infers it
    from the chosen ``word_emb_caps`` vectors, e.g. glove.840B.300d).'''
    for source in (os.path.basename(getattr(cfg, 'glove_path', '') or ''),
                   getattr(cfg, 'word_emb_caps', '') or ''):
        m = re.search(r'(\d+)d', source)
        if m:
            return int(m.group(1))
    return 300


def _load_pretrained_encoder(model, cfg):
    '''Optionally seed the encoder from a proposal checkpoint (ablation;
    reference: captioning_module.py:147-162), a native npz directory or
    file or a reference .pt; a uni-modal captioner takes a uni-modal
    generator's encoder. Returns the frozen module's name or None.'''
    path = getattr(cfg, 'pretrained_prop_model_path', None)
    if not path:
        return None
    print(f'Pretrained prop path: \n {path}')
    if path.endswith('.pt'):
        cpt = load_torch_checkpoint(path)
        tree = (import_prop_model(cpt) if cfg.modality == 'audio_video'
                else import_unimodal_prop_model(cpt, cfg.modality))[0][
                    'encoder']
    else:
        # only the encoder subtree transfers (reference filter:
        # captioning_module.py:157-159 keeps 'encoder' keys)
        tree = load_pretrained_encoder_native(path, to_jax_tree(model.encoder),
                                              'prop')
    load_jax_params(model.encoder, tree)
    return None if getattr(cfg, 'finetune_prop_encoder', False) else 'encoder'


def eval_model(state: TrainState):
    '''The weights that are validated and saved as best: a copy of the model
    holding the EMA when EMA is on, else the model itself.'''
    if state.ema is None:
        return state.model
    model = copy.deepcopy(state.model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.grad = None
            p.copy_(state.ema[name])
    return model


def resume(ckpt_dir, name: str, state: TrainState):
    '''Restore the rolling checkpoint ``name`` into ``state`` (weights,
    optimizer, EMA, step) when ``ckpt_dir`` holds one; returns its meta,
    else None. An orbax-only checkpoint raises.'''
    if not ckpt_dir or not checkpoint_exists(ckpt_dir, name):
        if ckpt_dir and _has_orbax(ckpt_dir, name):
            _orbax_only(ckpt_dir, name)
        return None
    _, meta, opt = load_checkpoint(ckpt_dir, state.model, state.optimizer,
                                   name)
    state.step = int(meta.get('step', 0))
    if opt is None:
        # one update a step (accumulation is within the step), so the
        # update count that the warmup_cosine schedule reads is the step
        state.optimizer.count = state.step
        print(f'{name}: no optimizer state beside the weights; the '
              f'optimizer starts afresh, its schedule at update {state.step}')
    else:
        print(f'{name}: optimizer state restored at update {opt.count}')
    if state.ema is not None:
        # the EMA sidecar restores an exact resume; a pre-EMA run seeds the
        # EMA from the restored weights
        source = copy.deepcopy(state.model)
        if checkpoint_exists(ckpt_dir, f'{name}.ema'):
            load_model_params(ckpt_dir, f'{name}.ema', source)
        # in place: a CUDA graph of the step holds the EMA's tensors
        with torch.no_grad():
            for n, p in source.named_parameters():
                state.ema[n].copy_(p)
    return meta


def checkpoint_writer(cfg, dp=None):
    '''(save function, async writer or None) for ``--async_ckpt``; on a
    data-parallel rank other than 0, a save that writes nothing.'''
    if dp is not None and not dp.is_main:
        return (lambda *args, **kwargs: None), None
    if getattr(cfg, 'async_ckpt', False):
        writer = AsyncCheckpointWriter(save_checkpoint)
        return writer.save, writer
    return save_checkpoint, None


def data_parallel(cfg, device) -> DataParallel:
    '''The run's process grid: dp x sp x ep as the procedure reads the
    flags (``parallel.mesh.axes``), ``--fsdp``; the axes that are not
    ported raise.'''
    dp, sp, ep = axes(cfg)
    return DataParallel(dp, device, sp=sp, ep=ep,
                        fsdp=bool(getattr(cfg, 'fsdp', False)))


def shard_state(dp: DataParallel, state: TrainState, cfg):
    '''Cut the rank's shards of the state (``--fsdp``, the experts over
    ep), once every rank holds the same whole state; prints the rank's
    share of the sharded bytes.'''
    shards = dp.shard_params(state, getattr(cfg, 'fsdp_min_elems', None))
    if shards is not None:
        held = shards.bytes()
        print(f'[shards] rank {dp.rank}: {held["sharded"] / 2**20:.1f} MiB '
              f'of sharded leaves, {held["whole"] / 2**20:.1f} MiB whole '
              f'(parameters, moments, EMA)')
    return shards


def train_cap(cfg: Config, device=None):
    '''Train the captioner as ``main.py --procedure train_cap``; the card
    unless ``device`` names another. Returns the best METEOR.'''
    device = resolve_device(device)
    check_ported(cfg)
    n_ep = axes(cfg)[2]
    if n_ep > 1 and (getattr(cfg, 'moe_experts', 0) or 0) % n_ep:
        raise ValueError(
            f'--ep_devices {n_ep} requires --moe_experts divisible by it '
            f'(got {cfg.moe_experts}); expert weights shard their leading '
            f'expert axis over the ep mesh axis')
    dp = data_parallel(cfg, device)
    impl, dtype = attention_impl(cfg), compute_dtype(cfg)
    seed = 0
    np.random.seed(seed)

    t0 = perf_counter()
    train_ds = CaptioningDataset(cfg, 'train')
    val_1_ds = CaptioningDataset(cfg, 'val_1', vocab=train_ds.train_vocab)
    val_2_ds = CaptioningDataset(cfg, 'val_2', vocab=train_ds.train_vocab)
    report_time('dataset build', t0,
                f' ({train_ds.num_rows()} train, {val_1_ds.num_rows()} + '
                f'{val_2_ds.num_rows()} validation rows)')

    dims = CapModelDims.from_config(cfg, train_ds.trg_voc_size)
    glove = None
    if getattr(cfg, 'glove_path', None):
        # the full pretrained width: when it differs from d_model_C the
        # embedder carries the reference's trained Linear+ReLU adapter
        glove = load_glove(cfg.glove_path, train_ds.train_vocab,
                           dim=_glove_dim(cfg), cache_dir='./tmp')
    emb_key = cap_embedding_key(dims.modality)
    caption_width = {'audio_video': dims.d_model_C, 'audio': dims.d_model_A,
                     'video': dims.d_model_V}[dims.modality]
    table_dim = (glove.shape[1] if glove is not None
                 and glove.shape[1] != caption_width else None)
    model = captioner_class(dims)(
        dims, device=device, table_dim=table_dim,
        generator=torch.Generator(device=device).manual_seed(seed))
    if glove is not None:
        with torch.no_grad():
            getattr(model, emb_key).table.copy_(torch.from_numpy(glove))

    frozen_module = _load_pretrained_encoder(model, cfg)
    # full-captioner seed (continued training), beyond the reference
    cap_seed = getattr(cfg, 'pretrained_cap_model_path', None)
    if cap_seed:
        print(f'Pretrained cap path (full-model seed): \n {cap_seed}')
        load_pretrained_cap_params(cap_seed, model)

    lora_rank = int(getattr(cfg, 'lora_rank', 0) or 0)
    if lora_rank:
        add_lora(model, lora_rank,
                 torch.Generator(device=device).manual_seed(seed + 77),
                 getattr(cfg, 'lora_alpha', None),
                 getattr(cfg, 'lora_targets', 'attn'))
        sites, n_adapter = count_lora(model)
        print(f'LoRA: rank {lora_rank}, {sites} adapted linears, '
              f'{n_adapter / 1e6:.3f} Mil. adapter params')

    # frozen: the GloVe table unless --unfreeze_word_emb; the imported
    # encoder unless fine-tuned; with LoRA, everything but the adapters
    freeze_emb = (glove is not None
                  and not getattr(cfg, 'unfreeze_word_emb', False))

    def is_frozen(path):
        if lora_rank:
            return lora_frozen_predicate(path)
        if freeze_emb and path[:2] == (emb_key, 'table'):
            return True
        return frozen_module is not None and path[0] == frozen_module

    optimizer = build_optimizer(cfg, model, frozen=is_frozen,
                                total_steps=cfg.epoch_num * len(train_ds))
    ema_decay = float(getattr(cfg, 'ema_decay', 0.0) or 0.0)
    dp_step = dp if dp.size > 1 else None
    train_step = make_cap_train_step(
        dims, cfg.smoothing, train_ds.pad_idx, impl, dtype,
        accum_steps=getattr(cfg, 'grad_accum_steps', 1) or 1,
        ema_decay=ema_decay,
        moe_aux_coeff=getattr(cfg, 'moe_aux_coeff', 0.01), dp=dp_step)
    # --steps_per_dispatch > 1: bundles of that many steps (CUDA graphs of
    # the step on the card; train.steps.make_multistep)
    steps_per_dispatch = int(getattr(cfg, 'steps_per_dispatch', 1) or 1)
    multistep = (make_multistep(train_step) if steps_per_dispatch > 1
                 else None)
    val_step = make_cap_val_step(dims, cfg.smoothing, train_ds.pad_idx, impl,
                                 dtype, dp=dp_step)
    decode_fn = make_decode_fn(
        make_strategy_fn(cfg, dims, cfg.max_len, train_ds, impl, seed), dtype,
        dp=dp_step)
    state = init_train_state(model, optimizer, seed, ema=ema_decay > 0,
                             prng_impl=prng_impl(cfg))

    # trainable means not frozen, as the reference counts requires_grad
    n_params = sum(p.numel() for p in optimizer.params)
    print(f'Total Number of Trainable Parameters: {n_params / 1e6} Mil.')
    logger = (MetricsLogger(cfg.log_path) if cfg.to_log and dp.is_main
              else NullLogger())
    logger.add_scalar('debug/param_number', n_params, 0)

    scheduler = None
    if cfg.scheduler == 'reduce_on_plateau':
        scheduler = ReduceLROnPlateau(cfg.lr, cfg.lr_reduce_factor,
                                      cfg.lr_patience)

    best_metric, unchanged, start_epoch, resume_batch = 0.0, 0, 0, 0
    save_ckpt, async_writer = checkpoint_writer(cfg, dp)
    ckpt_dir = cfg.model_checkpoint_path if cfg.to_log else None
    meta = resume(ckpt_dir, 'last_cap_model', state)
    dp.broadcast_module(state.model)
    shard_state(dp, state, cfg)
    if meta is not None:
        start_epoch = meta.get('epoch', -1) + 1
        best_metric = meta.get('best_metric', 0.0)
        unchanged = meta.get('unchanged', 0)
        # batch-exact resume of a preemption-interrupted epoch
        resume_batch = meta.get('batch_in_epoch', 0) or 0
        if scheduler is not None and meta.get('scheduler'):
            scheduler.load_state_dict(meta['scheduler'])
            set_learning_rate(state.optimizer, scheduler.lr)
        print(f'Resumed from epoch {start_epoch}'
              + (f' batch {resume_batch}' if resume_batch else ''))

    def meta_of(epoch, **fields):
        return {'config': cfg.to_dict(), 'epoch': epoch,
                'step': int(state.step),
                'trg_voc_size': train_ds.trg_voc_size,
                'vocab_itos': train_ds.train_vocab.itos,
                'best_metric': best_metric, 'unchanged': unchanged,
                'scheduler': (scheduler.state_dict()
                              if scheduler is not None else None),
                **fields}

    def save_epoch(epoch, evaluated, is_best, *scores):
        t0 = perf_counter()
        meta = meta_of(epoch, **dict(zip(
            ('val_1_loss', 'val_2_loss', 'val_1_metrics', 'val_2_metrics'),
            scores)))
        opt = optimizer_state_tree(state.model, state.optimizer)
        # rolling checkpoint every epoch: a crash before the first 1-by-1
        # validation still resumes from the latest epoch
        save_ckpt(ckpt_dir, state.model, meta, opt, 'last_cap_model')
        if state.ema is not None:
            save_ckpt(ckpt_dir, evaluated, {'epoch': epoch}, None,
                      'last_cap_model.ema')
        if is_best:
            # best_* holds the weights that SCORED best (the EMA when on),
            # so eval and serving load it unchanged
            save_ckpt(ckpt_dir, evaluated, meta, opt, 'best_cap_model')
            if lora_rank:
                # the finetune's shippable artifact: the adapter leaves
                # alone, which serving's --lora_adapter reads
                save_lora_npz(os.path.join(
                    ckpt_dir, 'best_cap_model.lora.npz'), evaluated)
        report_time(f'checkpoint save {epoch}', t0,
                    ' (last and best)' if is_best else ' (last)')

    # SIGTERM -> finish the current batch, checkpoint, exit cleanly
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
            state, _ = train_epoch_cap(
                train_step, state, train_ds, epoch, logger, seed,
                profile_steps=getattr(cfg, 'profile_steps', 0),
                profile_dir=(os.path.join(cfg.log_path, 'profile')
                             if cfg.log_path else None),
                guard=guard,
                start_batch=(resume_batch if epoch == start_epoch else 0),
                stats=stats, dp=dp_step, multistep=multistep,
                steps_per_dispatch=steps_per_dispatch)
            state.optimizer.zero_grad()
            report_epoch(f'train epoch {epoch}', t0, stats)
            report_graphs(state)

            if guard is not None and guard.requested:
                # mid-epoch: save with the last COMPLETED epoch and the
                # batch cursor, so the resume re-enters this epoch there
                b = guard.batch_in_epoch
                with dp.whole(everything=True):
                    save_ckpt(ckpt_dir, state.model, meta_of(
                        epoch - 1 if b else epoch, batch_in_epoch=b or 0,
                        val_1_loss=None, val_2_loss=None,
                        val_1_metrics=None, val_2_metrics=None),
                        state.optimizer, 'last_cap_model')
                    if state.ema is not None:
                        save_ckpt(ckpt_dir, eval_model(state),
                                  {'epoch': epoch}, None,
                                  'last_cap_model.ema')
                print(f'[preempt] rolling checkpoint saved @ epoch {epoch} '
                      f'batch {b if b else "end"}; exiting')
                break

            # EMA (if on) is what gets EVALUATED and what best_* holds;
            # --fsdp validates the whole model, ep the experts' shards
            with dp.whole():
                evaluated = eval_model(state)
                t0 = perf_counter()
                val_1_loss = validate_next_word(val_step, evaluated, val_1_ds,
                                                epoch, dp_step)
                val_2_loss = validate_next_word(val_step, evaluated, val_2_ds,
                                                epoch, dp_step)
                report_time(f'next-word validation {epoch}', t0,
                            f' (losses {val_1_loss:.5f}, {val_2_loss:.5f})')
                val_avg = (val_1_loss + val_2_loss) / 2
                logger.add_scalar('debug/val_loss_avg', val_avg, epoch)

                if scheduler is not None:
                    set_learning_rate(state.optimizer, scheduler.step(val_avg))

                val_1_metrics = val_2_metrics = avg = None
                if epoch >= cfg.one_by_one_starts_at:
                    # decode in the compute dtype: a cast copy of the weights
                    decoding = (evaluated if dtype == torch.float32 else
                                copy.deepcopy(evaluated).to(dtype=dtype))
                    decoding.eval()
                    val_1_metrics = validation_1by1(cfg, decoding, decode_fn,
                                                    val_1_ds, epoch, logger,
                                                    dp=dp_step)
                    val_2_metrics = validation_1by1(cfg, decoding, decode_fn,
                                                    val_2_ds, epoch, logger,
                                                    dp=dp_step)
                    del decoding
                    avg = average_metrics_in_two_dicts(
                        val_1_metrics, val_2_metrics)['Average across tIoUs']
                    print(f'[scores] epoch {epoch}: ' + ', '.join(
                        f'{k} {avg[k]:.6f}' for k in (
                            'METEOR', 'Bleu_4', 'Bleu_3', 'Precision',
                            'Recall')))
                    if cfg.to_log:
                        for name, tag in (('METEOR', 'meteor'),
                                          ('Bleu_4', 'bleu4'),
                                          ('Bleu_3', 'bleu3'),
                                          ('Precision', 'precision'),
                                          ('Recall', 'recall')):
                            logger.add_scalar(f'metrics/{tag}',
                                              avg[name] * 100, epoch)

            is_best = False
            if avg is not None:
                is_best = best_metric < avg['METEOR']
                if is_best:
                    best_metric = avg['METEOR']
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
                        save_epoch(epoch, evaluated, is_best, val_1_loss,
                                   val_2_loss, val_1_metrics, val_2_metrics)
            del evaluated
    finally:
        if guard is not None:
            guard.uninstall()
        if async_writer is not None:
            # drain pending background writes (incl. a preemption save) so
            # the checkpoint is durably on disk before the process can exit
            async_writer.close()
    print(f'{cfg.curr_time}')
    print(f'best_metric: {best_metric}')
    logger.close()
    return best_metric
