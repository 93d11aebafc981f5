'''Configuration: the reference's CLI flags and the derived fields
(counterpart of ``bmt_tpu.config``, a copy; the port imports nothing of the
JAX package).

``Config`` is a flat attribute bag built from the parsed flags; a checkpoint
stores it as a plain JSON dict (``to_dict``), and ``from_dict`` rebuilds one
from such a dict, or from the attributes of the pickled Config of a reference
``.pt`` checkpoint. The flags and derived fields are the JAX package's, so a
config dict written by either package loads in the other. One field differs:
``device`` is ``'cuda'`` where the JAX package writes ``'tpu'``. The flags
that only the JAX package reads (``--ckpt_format``, the mesh sizes) are
parsed and kept, so a dict round-trips, and the port ignores them.
``--attention_impl {xla,pallas}`` reads as the port's plain or kernel
attention, and ``--prng_impl`` picks the trainers' dropout PRNG as in JAX
(``train.options``).
'''
from __future__ import annotations

import argparse
import json
import os
from time import localtime, strftime


class Config:
    '''Flat attribute-bag config (reference: config_constructor.py:5-142).'''

    def __init__(self, args=None, **kwargs):
        if args is None and kwargs:
            args = argparse.Namespace(**kwargs)
        if args is None:
            return
        self.curr_time = strftime('%y%m%d%H%M%S', localtime())

        self.procedure = args.procedure
        # dataset
        self.train_meta_path = args.train_meta_path
        self.val_1_meta_path = args.val_1_meta_path
        self.val_2_meta_path = args.val_2_meta_path
        self.modality = args.modality
        self.video_feature_name = args.video_feature_name
        self.audio_feature_name = args.audio_feature_name
        self.video_features_path = args.video_features_path
        self.audio_features_path = args.audio_features_path
        self.d_vid = args.d_vid
        self.d_aud = args.d_aud
        self.start_token = args.start_token
        self.end_token = args.end_token
        self.pad_token = args.pad_token
        self.max_len = args.max_len
        self.min_freq_caps = args.min_freq_caps

        if args.procedure == 'train_cap':
            self.word_emb_caps = args.word_emb_caps
            self.unfreeze_word_emb = args.unfreeze_word_emb
            self.model = args.model
            self.pretrained_prop_model_path = args.pretrained_prop_model_path
            self.finetune_prop_encoder = args.finetune_prop_encoder
            # full-captioner init (LoRA base / continued pretraining) — the
            # reference reuses this flag name for train_prop's encoder seed
            self.pretrained_cap_model_path = getattr(
                args, 'pretrained_cap_model_path', None)
        elif args.procedure == 'train_prop':
            if getattr(args, 'lora_rank', 0):
                # fail loudly: the proposal stage's trainable surface is
                # the conv heads (the encoder is transplanted + frozen,
                # reference: proposal_generator.py:234-249), so LoRA
                # applies to train_cap only — silently ignoring the flag
                # would look like a finetune that never happened
                raise ValueError(
                    '--lora_rank applies to --procedure train_cap only '
                    '(the proposal stage already trains just the conv '
                    'heads on a frozen encoder)')
            self.word_emb_caps = args.word_emb_caps
            self.pretrained_cap_model_path = args.pretrained_cap_model_path
            self.finetune_cap_encoder = args.finetune_cap_encoder
            self.layer_norm = args.layer_norm
            self.anchors_num_audio = args.anchors_num_audio
            self.anchors_num_video = args.anchors_num_video
            self.noobj_coeff = args.noobj_coeff
            self.obj_coeff = args.obj_coeff
            self.train_json_path = args.train_json_path
            self.nms_tiou_thresh = args.nms_tiou_thresh
            self.strides = {}
            self.pad_feats_up_to = {}
            self.kernel_sizes = {}
            if 'audio' in self.modality:
                self.strides['audio'] = args.audio_feature_timespan
                self.pad_feats_up_to['audio'] = args.pad_audio_feats_up_to
                self.conv_layers_audio = args.conv_layers_audio
                self.kernel_sizes['audio'] = args.kernel_sizes_audio
            if 'video' in self.modality:
                self.feature_timespan_in_fps = args.feature_timespan_in_fps
                self.fps_at_extraction = args.fps_at_extraction
                self.strides['video'] = (
                    args.feature_timespan_in_fps / args.fps_at_extraction)
                self.pad_feats_up_to['video'] = args.pad_video_feats_up_to
                self.conv_layers_video = args.conv_layers_video
                self.kernel_sizes['video'] = args.kernel_sizes_video
        elif args.procedure == 'evaluate':
            self.pretrained_cap_model_path = args.pretrained_cap_model_path
        else:
            raise NotImplementedError(args.procedure)

        self.dout_p = args.dout_p
        self.N = args.N
        self.use_linear_embedder = args.use_linear_embedder
        if args.use_linear_embedder:
            self.d_model_video = args.d_model_video
            self.d_model_audio = args.d_model_audio
        else:
            self.d_model_video = self.d_vid
            self.d_model_audio = self.d_aud
        self.H = args.H
        self.d_model = args.d_model
        self.d_model_caps = args.d_model_caps
        if 'video' in self.modality:
            self.d_ff_video = (4 * self.d_model_video
                               if args.d_ff_video is None else args.d_ff_video)
        if 'audio' in self.modality:
            self.d_ff_audio = (4 * self.d_model_audio
                               if args.d_ff_audio is None else args.d_ff_audio)
        self.d_ff_caps = (4 * self.d_model_caps
                          if args.d_ff_caps is None else args.d_ff_caps)

        # training — 'device_ids' maps to the data-parallel size
        self.device_ids = args.device_ids
        self.device = 'cuda'
        self.dp_devices = getattr(args, 'dp_devices', None) or len(args.device_ids)
        self.sp_devices = getattr(args, 'sp_devices', None) or 1
        self.train_batch_size = args.B * self.dp_devices
        self.inference_batch_size = args.inf_B_coeff * self.train_batch_size
        self.epoch_num = args.epoch_num
        self.one_by_one_starts_at = args.one_by_one_starts_at
        self.early_stop_after = args.early_stop_after
        self.smoothing = args.smoothing
        self.grad_clip = args.grad_clip

        self.optimizer = args.optimizer
        if self.optimizer == 'adam':
            self.beta1, self.beta2 = args.betas
            self.eps = args.eps
            self.weight_decay = args.weight_decay
        elif self.optimizer == 'sgd':
            self.momentum = args.momentum
            self.weight_decay = args.weight_decay
        else:
            raise ValueError(self.optimizer)

        self.scheduler = args.scheduler
        self.lr = args.lr
        if self.scheduler == 'reduce_on_plateau':
            self.lr_reduce_factor = args.lr_reduce_factor
            self.lr_patience = args.lr_patience
        self.warmup_steps = getattr(args, 'warmup_steps', 0)
        self.lr_final_ratio = getattr(args, 'lr_final_ratio', 0.0)
        self.skip_nonfinite_grads = getattr(args, 'skip_nonfinite_grads', 0)
        self.ema_decay = getattr(args, 'ema_decay', 0.0)

        # evaluation
        self.reference_paths = args.reference_paths
        self.tIoUs = args.tIoUs
        self.max_prop_per_vid = args.max_prop_per_vid
        self.prop_pred_path = args.prop_pred_path
        self.avail_mp4_path = args.avail_mp4_path
        self.val_prop_meta_path = getattr(args, 'val_prop_meta_path', None)

        # the JAX package's own knobs (kept so a config dict round-trips)
        self.compute_dtype = getattr(args, 'compute_dtype', 'bfloat16')
        self.remat = getattr(args, 'remat', False)
        self.attention_impl = getattr(args, 'attention_impl', 'xla')
        self.kv_cache_int8 = getattr(args, 'kv_cache_int8', False)
        self.weights_int8 = getattr(args, 'weights_int8', False)
        self.ckpt_format = getattr(args, 'ckpt_format', 'npz')
        self.prng_impl = getattr(args, 'prng_impl', 'rbg')
        self.optim_mu_dtype = getattr(args, 'optim_mu_dtype', 'float32')
        self.grad_accum_steps = getattr(args, 'grad_accum_steps', 1)
        self.steps_per_dispatch = getattr(args, 'steps_per_dispatch', 1)
        self.moe_experts = getattr(args, 'moe_experts', 0)
        self.moe_capacity_factor = getattr(args, 'moe_capacity_factor', 1.25)
        self.moe_aux_coeff = getattr(args, 'moe_aux_coeff', 0.01)
        self.ep_devices = getattr(args, 'ep_devices', 1)
        self.fsdp = getattr(args, 'fsdp', False)
        self.fsdp_min_elems = getattr(args, 'fsdp_min_elems', 1 << 16)
        self.preempt_save = getattr(args, 'preempt_save', True)
        self.async_ckpt = getattr(args, 'async_ckpt', False)
        self.length_sort_window = getattr(args, 'length_sort_window', 100)
        self.lora_rank = getattr(args, 'lora_rank', 0)
        self.lora_alpha = getattr(args, 'lora_alpha', None)
        self.lora_targets = getattr(args, 'lora_targets', 'attn')
        self.decode_strategy = getattr(args, 'decode_strategy', 'greedy')
        self.profile_steps = getattr(args, 'profile_steps', 0)
        self.beam_size = getattr(args, 'beam_size', 4)
        self.length_penalty = getattr(args, 'length_penalty', 0.0)
        self.temperature = getattr(args, 'temperature', 1.0)
        self.sample_top_k = getattr(args, 'sample_top_k', 0)
        self.sample_top_p = getattr(args, 'sample_top_p', 1.0)
        self.max_events_per_video = getattr(args, 'max_events_per_video', 32)
        self.glove_path = getattr(args, 'glove_path', None)
        self.vocab_path = getattr(args, 'vocab_path', None)

        # logging
        self.to_log = args.to_log
        if args.to_log:
            self.log_dir = os.path.join(args.log_dir, args.procedure)
            self.checkpoint_dir = self.log_dir
            # --exper_name pins the experiment directory so a relaunched
            # run finds its rolling last_* checkpoint and RESUMES; the
            # default timestamp (reference: config_constructor.py:130-141)
            # makes every process a fresh experiment
            exper_name = getattr(args, 'exper_name', None) \
                or self.curr_time[2:]
            self.exper_name = exper_name
            self.log_path = os.path.join(self.log_dir, exper_name)
            self.model_checkpoint_path = os.path.join(self.checkpoint_dir,
                                                      exper_name)
        else:
            self.log_dir = None
            self.log_path = None

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith('_')}

    @classmethod
    def from_dict(cls, d: dict) -> 'Config':
        cfg = cls()
        cfg.__dict__.update(d)
        return cfg

    def save_json(self, path: str):
        with open(path, 'w') as f:
            json.dump(self.to_dict(), f, indent=1, default=str)

    @classmethod
    def load_json(cls, path: str) -> 'Config':
        with open(path) as f:
            return cls.from_dict(json.load(f))


def build_parser() -> argparse.ArgumentParser:
    '''Reference-compatible CLI (reference: main.py:20-172) plus the JAX
    package's own flags, parsed as there.'''
    parser = argparse.ArgumentParser(
        description='Run experiment (bmt_tpu_torch)')

    # DATA
    parser.add_argument('--train_meta_path', type=str, default='./data/train.csv')
    parser.add_argument('--val_1_meta_path', type=str, default='./data/val_1.csv')
    parser.add_argument('--val_2_meta_path', type=str, default='./data/val_2.csv')
    parser.add_argument('--modality', type=str, default='audio_video',
                        choices=['audio', 'video', 'audio_video'])
    parser.add_argument('--video_feature_name', type=str, default='i3d')
    parser.add_argument('--audio_feature_name', type=str, default='vggish')
    parser.add_argument('--video_features_path', type=str,
                        default='./data/i3d_25fps_stack64step64_2stream_npy/')
    parser.add_argument('--audio_features_path', type=str,
                        default='./data/vggish_npy/')
    parser.add_argument('--d_vid', type=int, default=1024)
    parser.add_argument('--d_aud', type=int, default=128)
    parser.add_argument('--word_emb_caps', default='glove.840B.300d', type=str)
    parser.add_argument('--unfreeze_word_emb', action='store_true', default=False)
    parser.add_argument('--feature_timespan_in_fps', type=int, default=64)
    parser.add_argument('--fps_at_extraction', type=int, default=25)
    parser.add_argument('--audio_feature_timespan', type=float, default=0.96)
    parser.add_argument('--train_json_path', type=str, default='./data/train.json')

    # TRAINING
    parser.add_argument('--procedure', type=str, required=True,
                        choices=['train_cap', 'train_prop', 'evaluate'])
    parser.add_argument('--device_ids', type=int, nargs='+', default=[0])
    parser.add_argument('--dp_devices', type=int, default=None,
                        help='data-parallel mesh size; defaults to '
                             'len(--device_ids) = 1, matching the '
                             'reference\'s single-default-GPU semantics '
                             '(total batch = B * dp_devices). A warning is '
                             'printed when more chips are visible than '
                             'used.')
    parser.add_argument('--sp_devices', type=int, default=None,
                        help='sequence-parallel mesh axis (train_prop '
                             'only): the Sa=800/Sv=300 proposal sequences '
                             'are sharded over this many devices per dp '
                             'replica; total devices = dp_devices * '
                             'sp_devices. Default 1 (off).')
    parser.add_argument('--start_token', type=str, default='<s>')
    parser.add_argument('--end_token', type=str, default='</s>')
    parser.add_argument('--pad_token', type=str, default='<blank>')
    parser.add_argument('--max_len', type=int, default=30)
    parser.add_argument('--min_freq_caps', type=int, default=1)
    parser.add_argument('--optimizer', type=str, default='adam',
                        choices=['adam', 'sgd'])
    parser.add_argument('--betas', type=float, nargs=2, default=[0.9, 0.999])
    parser.add_argument('--eps', type=float, default=1e-8)
    parser.add_argument('--momentum', type=float, default=0.0)
    parser.add_argument('--scheduler', type=str, default='constant',
                        choices=['constant', 'reduce_on_plateau',
                                 'warmup_cosine'])
    parser.add_argument('--warmup_steps', type=int, default=0,
                        help='(warmup_cosine) linear LR warmup steps '
                             'before the cosine decay')
    parser.add_argument('--lr_final_ratio', type=float, default=0.0,
                        help='(warmup_cosine) cosine floor as a fraction '
                             'of the peak --lr')
    parser.add_argument('--ema_decay', type=float, default=0.0,
                        help='exponential moving average of the weights '
                             '(e.g. 0.999): validation decode and the '
                             'best_* checkpoint use the EMA weights, the '
                             'rolling last_* checkpoint keeps raw weights '
                             '+ an .ema sidecar for exact resume (0 = off)')
    parser.add_argument('--skip_nonfinite_grads', type=int, default=0,
                        help='skip optimizer updates on steps with '
                             'NaN/inf gradients; after N consecutive bad '
                             'steps the failure surfaces instead of '
                             'looping (0 = off)')
    parser.add_argument('--lr', type=float, default=5e-5)
    parser.add_argument('--weight_decay', type=float, default=0)
    parser.add_argument('--lr_patience', type=int)
    parser.add_argument('--lr_reduce_factor', type=float)
    parser.add_argument('--B', type=int, default=32)
    parser.add_argument('--inf_B_coeff', type=int, default=2)
    parser.add_argument('--epoch_num', type=int, default=100)
    parser.add_argument('--one_by_one_starts_at', type=int, default=1)
    parser.add_argument('--early_stop_after', type=int, default=30)
    parser.add_argument('--smoothing', type=float, default=0.7)
    parser.add_argument('--grad_clip', type=float)
    parser.add_argument('--pretrained_prop_model_path', type=str)
    parser.add_argument('--finetune_prop_encoder', action='store_true',
                        default=False)
    parser.add_argument('--pretrained_cap_model_path', type=str)
    parser.add_argument('--finetune_cap_encoder', action='store_true',
                        default=False)
    parser.add_argument('--obj_coeff', type=float, default=1)
    parser.add_argument('--noobj_coeff', type=float, default=100)
    parser.add_argument('--pad_audio_feats_up_to', type=int, default=800)
    parser.add_argument('--pad_video_feats_up_to', type=int, default=300)
    parser.add_argument('--nms_tiou_thresh', type=float)
    parser.add_argument('--log_dir', type=str, default='./log/')
    parser.add_argument('--exper_name', type=str, default=None,
                        help='pin the log/checkpoint directory name '
                             '(default: a fresh timestamp). Relaunching '
                             'with the same name resumes from the rolling '
                             'last_* checkpoint after a crash.')

    # EVALUATION
    parser.add_argument('--prop_pred_path', type=str)
    parser.add_argument('--avail_mp4_path', type=str,
                        default='./data/available_mp4.txt')
    parser.add_argument('--reference_paths', type=str, nargs='+',
                        default=['./data/val_1_no_missings.json',
                                 './data/val_2_no_missings.json'])
    parser.add_argument('--tIoUs', type=float, default=[0.3, 0.5, 0.7, 0.9],
                        nargs='+')
    parser.add_argument('--max_prop_per_vid', type=int, default=100)
    parser.add_argument('--val_prop_meta_path', type=str)

    # MODEL
    parser.add_argument('--model', type=str, default='av_transformer',
                        choices=['transformer', 'av_transformer'])
    parser.add_argument('--dout_p', type=float, default=0.1)
    parser.add_argument('--N', type=int, default=2)
    parser.add_argument('--d_model', type=int, default=1024)
    parser.add_argument('--d_model_video', type=int)
    parser.add_argument('--d_model_audio', type=int)
    parser.add_argument('--d_model_caps', type=int, default=300)
    parser.add_argument('--use_linear_embedder', action='store_true',
                        default=False)
    parser.add_argument('--H', type=int, default=4)
    parser.add_argument('--d_ff_video', type=int)
    parser.add_argument('--d_ff_audio', type=int)
    parser.add_argument('--d_ff_caps', type=int)
    parser.add_argument('--anchors_num_video', type=int, default=128)
    parser.add_argument('--anchors_num_audio', type=int, default=48)
    parser.add_argument('--kernel_sizes_audio', type=int, nargs='+',
                        default=[5, 13, 23, 35, 51, 69, 91, 121, 161, 211])
    parser.add_argument('--kernel_sizes_video', type=int, nargs='+',
                        default=[1, 5, 9, 13, 19, 25, 35, 45, 61, 79])
    parser.add_argument('--conv_layers_audio', type=int, nargs='*',
                        default=[512, 512])
    parser.add_argument('--conv_layers_video', type=int, nargs='*',
                        default=[512, 512])
    parser.add_argument('--layer_norm', action='store_true', default=False)

    # the JAX package's options: parsed with its defaults and choices so a
    # config dict round-trips; the port ports them slice by slice (ROADMAP)
    parser.add_argument('--compute_dtype', type=str, default='bfloat16',
                        choices=['bfloat16', 'float32'])
    parser.add_argument('--attention_impl', type=str, default='xla',
                        choices=['xla', 'pallas'],
                        help='the JAX package\'s attention; the port\'s entry '
                             'points take their own --attention_impl '
                             '{kernel,torch}')
    parser.add_argument('--kv_cache_int8', action='store_true',
                        default=False,
                        help='int8 cross-attention K/V in the decode loop')
    parser.add_argument('--weights_int8', action='store_true',
                        default=False,
                        help='weight-only int8 linears in inference decode')
    parser.add_argument('--ckpt_format', type=str, default='npz',
                        choices=['npz', 'orbax'],
                        help='native checkpoint backend (the port reads and '
                             'writes npz only)')
    parser.add_argument('--prng_impl', type=str, default='rbg',
                        choices=['threefry2x32', 'rbg', 'unsafe_rbg'],
                        help='the dropout PRNG: threefry2x32 draws the '
                             'JAX package\'s masks bit for bit, rbg and '
                             'unsafe_rbg the port\'s Philox generator')
    parser.add_argument('--optim_mu_dtype', type=str, default='float32',
                        choices=['float32', 'bfloat16'],
                        help='dtype of Adam\'s first moment')
    parser.add_argument('--grad_accum_steps', type=int, default=1,
                        help='microbatches per optimizer step; B must be '
                             'divisible by it')
    parser.add_argument('--steps_per_dispatch', type=int, default=1,
                        help='optimizer steps bundled into one device '
                             'dispatch')
    parser.add_argument('--length_sort_window', type=int, default=100,
                        help='train batching: sort a pool of this many '
                             'shuffled batches by crop length before '
                             'batching (0 disables)')
    parser.add_argument('--remat', action='store_true', default=False,
                        help='recompute encoder layers in the backward pass')
    parser.add_argument('--lora_rank', type=int, default=0,
                        help='train_cap: rank-r LoRA adapters on the '
                             'captioner linears (0 disables)')
    parser.add_argument('--lora_alpha', type=float, default=None,
                        help='LoRA scale numerator; defaults to the rank')
    parser.add_argument('--lora_targets', type=str, default='attn',
                        choices=['attn', 'attn_ffn', 'all'],
                        help='which linears get LoRA adapters')
    parser.add_argument('--moe_experts', type=int, default=0,
                        help='mixture-of-experts FFNs with this many experts '
                             '(0/1 = dense, the reference)')
    parser.add_argument('--moe_capacity_factor', type=float, default=1.25,
                        help='MoE per-row expert capacity factor')
    parser.add_argument('--moe_aux_coeff', type=float, default=0.01,
                        help='weight of the MoE load-balance loss')
    parser.add_argument('--ep_devices', type=int, default=1,
                        help='expert-parallel size')
    parser.add_argument('--fsdp', action='store_true', default=False,
                        help='shard parameters and optimizer state over the '
                             'data-parallel devices')
    parser.add_argument('--fsdp_min_elems', type=int, default=1 << 16,
                        help='with --fsdp, smaller leaves stay replicated')
    parser.add_argument('--async_ckpt', action='store_true', default=False,
                        help='write checkpoints on a background thread')
    parser.add_argument('--no_preempt_save', dest='preempt_save',
                        action='store_false', default=True,
                        help='no checkpoint on SIGTERM')
    parser.add_argument('--decode_strategy', type=str, default='greedy',
                        choices=['greedy', 'beam', 'sample'])
    parser.add_argument('--beam_size', type=int, default=4)
    parser.add_argument('--length_penalty', type=float, default=0.0,
                        help='GNMT length penalty alpha for beam search')
    parser.add_argument('--temperature', type=float, default=1.0,
                        help='sampling temperature')
    parser.add_argument('--sample_top_k', type=int, default=0,
                        help='sample from the k best tokens (0 = off)')
    parser.add_argument('--sample_top_p', type=float, default=1.0,
                        help='nucleus sampling mass (1.0 = off)')
    parser.add_argument('--profile_steps', type=int, default=0,
                        help='trace this many training steps at the start '
                             'of epoch 0')
    parser.add_argument('--max_events_per_video', type=int, default=32)
    parser.add_argument('--glove_path', type=str, default=None,
                        help='path to glove .txt vectors (optional)')
    parser.add_argument('--vocab_path', type=str, default=None,
                        help='load a fixed vocabulary instead of building one')

    # DEBUGGING
    parser.add_argument('--debug', action='store_true', default=False)
    parser.add_argument('--dont_log', dest='to_log', action='store_false')
    parser.set_defaults(to_log=True)
    return parser
