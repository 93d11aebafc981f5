'''End-to-end single-video inference: proposal generation, then captioning
(counterpart of ``sample/single_video_prediction.py``).

    python -m bmt_tpu_torch.scripts.single_video_prediction \\
        --prop_generator_model_path <dir or best_prop_model.pt> \\
        --pretrained_cap_model_path <dir or best_cap_model.pt> \\
        --vggish_features_path v_vggish.npy --rgb_features_path v_rgb.npy \\
        --flow_features_path v_flow.npy --duration_in_secs 35.1 \\
        [--train_meta_path train.csv] [--output_json out.json]

Signature-compatible with the reference app (reference:
sample/single_video_prediction.py:279-316): prints, and with
``--output_json`` writes, ``[{start, end, sentence}, ...]``. Both checkpoint
formats load: a native npz directory or a reference ``.pt`` (its vocabulary
rebuilt from ``--train_meta_path``). The models run on the card
(``--device_id N`` picks ``cuda:N``) in the checkpoints' fp32; the encoder's
attention goes through the CUDA forward kernel (``--attention_impl kernel``)
or plain PyTorch (``torch``). ``--device cpu`` runs everything on the CPU,
where the kernel's wrapper runs its plain version (for tests).

The proposal forward is one B=1 pass at the config's ``pad_feats_up_to``;
then all proposals are captioned in ONE batched KV-cached greedy decode
(the reference loops over proposals, re-encoding every prefix:
single_video_prediction.py:218-229). As the JAX package's app, this one
does not skip a proposal whose crop is empty (``VideoPipeline`` does).
'''
from __future__ import annotations

import argparse
import json
import shutil
import struct
import subprocess

import numpy as np
import torch

from bmt_tpu_torch.data import (AUDIO_BUCKETS, VIDEO_BUCKETS, bucket_len,
                                crop_a_segment, pad_segment, pad_stack_batch)
from bmt_tpu_torch.decode import greedy_decode_bimodal
from bmt_tpu_torch.ops.attention import ATTENTION_IMPLS
from bmt_tpu_torch.ops.masks import make_masks
from bmt_tpu_torch.serve import SHORTEST_SEGMENT, ints_to_sentence
from bmt_tpu_torch.train.checkpoint import (load_cap_checkpoint,
                                            load_prop_checkpoint)
from bmt_tpu_torch.utils.proposal_utils import (get_corner_coords,
                                                non_max_suppression,
                                                remove_very_short_segments,
                                                select_topk_predictions,
                                                trim_proposals)


def load_features_from_npy(feature_paths, start, end, duration, pad_idx,
                           get_full_feat=False, pad_feats_up_to=None):
    '''Load one video's features, either full and padded (proposal stage)
    or cropped to a segment (captioning stage): {'audio', 'rgb', 'flow'}
    numpy arrays, each with a batch axis of 1.'''
    vggish = np.load(feature_paths['audio']).astype(np.float32)
    rgb = np.load(feature_paths['rgb']).astype(np.float32)
    flow = np.load(feature_paths['flow']).astype(np.float32)

    if get_full_feat:
        vggish = pad_segment(vggish, pad_feats_up_to['audio'], pad_idx)
        rgb = pad_segment(rgb, pad_feats_up_to['video'], pad_idx)
        flow = pad_segment(flow, pad_feats_up_to['video'], pad_idx=0)
    else:
        vggish = crop_a_segment(vggish, start, end, duration)
        rgb = crop_a_segment(rgb, start, end, duration)
        flow = crop_a_segment(flow, start, end, duration)
    return {'audio': vggish[None], 'rgb': rgb[None], 'flow': flow[None]}


def load_prop_model(prop_generator_model_path: str, max_prop_per_vid: int,
                    device='cuda'):
    '''Returns (cfg, dims, model) (reference:
    single_video_prediction.py:28-77).'''
    return load_prop_checkpoint(prop_generator_model_path, max_prop_per_vid,
                                device=device)


def load_cap_model(pretrained_cap_model_path: str, train_meta_path: str,
                   allow_vocab_drift: bool = False, device='cuda'):
    '''Returns (cfg, dims, model, vocab) (reference:
    single_video_prediction.py:92-117).'''
    return load_cap_checkpoint(pretrained_cap_model_path, train_meta_path,
                               allow_vocab_drift, device=device)


def generate_proposals(prop_model, feature_paths, pad_idx, prop_cfg,
                       duration_in_secs, attention_impl='kernel'):
    '''Full padded features -> proposal tensor -> corner/trim/short/top-k
    (reference: single_video_prediction.py:148-192). Returns (1, k, 3)
    [start, end, conf] numpy.'''
    device = next(prop_model.parameters()).device
    stacks = load_features_from_npy(
        feature_paths, None, None, duration_in_secs, pad_idx,
        get_full_feat=True, pad_feats_up_to=prop_cfg.pad_feats_up_to)
    stacks = {k: torch.from_numpy(v).to(device) for k, v in stacks.items()}
    masks = make_masks(stacks, None, prop_cfg.modality, pad_idx)
    with torch.inference_mode():
        preds = prop_model(stacks, None, masks, attention_impl)[0]
        preds = preds.float().cpu().numpy()
    preds = get_corner_coords(preds)
    preds = trim_proposals(preds, [duration_in_secs])
    preds = remove_very_short_segments(preds, SHORTEST_SEGMENT)
    return select_topk_predictions(preds, k=prop_cfg.max_prop_per_vid)


def caption_batch(feature_paths, segments, duration_in_secs, pad_idx,
                  device) -> dict:
    '''The crops of (n, 3) [start, end, conf] segments as one batch on
    ``device``: each stack padded to the bucket of the longest crop (rgb and
    audio with the pad index, flow with 0).'''
    crops = []
    for start, end, _conf in segments:
        stacks = load_features_from_npy(feature_paths, float(start),
                                        float(end), duration_in_secs,
                                        pad_idx)
        crops.append({k: v[0] for k, v in stacks.items()})

    Sv = bucket_len(max(c['rgb'].shape[0] for c in crops), VIDEO_BUCKETS)
    Sa = bucket_len(max(c['audio'].shape[0] for c in crops), AUDIO_BUCKETS)
    batch = {
        'rgb': pad_stack_batch([c['rgb'] for c in crops], pad_idx, Sv),
        'flow': pad_stack_batch([c['flow'] for c in crops], 0.0, Sv),
        'audio': pad_stack_batch([c['audio'] for c in crops], pad_idx, Sa),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def caption_proposals(cap_model, feature_paths, vocab, cap_cfg, proposals,
                      duration_in_secs, attention_impl='kernel'):
    '''Caption all proposals in one batched greedy decode (replaces the
    reference's per-proposal loop). Returns [{start, end, sentence}].'''
    pad_idx = vocab[cap_cfg.pad_token]
    start_idx = vocab[cap_cfg.start_token]
    end_idx = vocab[cap_cfg.end_token]

    segments = proposals.reshape(-1, 3)
    batch = caption_batch(feature_paths, segments, duration_in_secs, pad_idx,
                          next(cap_model.parameters()).device)
    ints_stack = greedy_decode_bimodal(
        cap_model, batch, cap_cfg.max_len, start_idx, end_idx, pad_idx,
        attention_impl).cpu().numpy()

    return [{'start': round(float(start), 1), 'end': round(float(end), 1),
             'sentence': ints_to_sentence(ints, vocab, cap_cfg.end_token)}
            for (start, end, _conf), ints in zip(segments, ints_stack)]


def which_ffprobe() -> str:
    return shutil.which('ffprobe') or ''


def mp4_duration_mvhd(path) -> float:
    '''Video duration in seconds from the mp4 ``moov/mvhd`` atom — a
    pure-Python fallback for hosts without ffprobe (the reference shells
    out unconditionally, single_video_prediction.py:259-277).

    ISO BMFF layout: boxes are [u32 size][4cc type]; size==1 means a u64
    largesize follows, size==0 means "to end of file". ``mvhd`` version 0
    packs creation/modification as u32s so timescale sits at byte 12 and
    duration (u32) at 16; version 1 widens them to u64s, putting
    timescale at 20 and duration (u64) at 24. Seconds = duration/timescale.
    '''
    with open(path, 'rb') as f:
        def boxes(end):
            # yield (type, payload_offset, payload_end) for boxes up to end
            while True:
                pos = f.tell()
                if end is not None and pos >= end:
                    return
                hdr = f.read(8)
                if len(hdr) < 8:
                    return
                size, typ = struct.unpack('>I4s', hdr)
                payload = pos + 8
                if size == 1:
                    size = struct.unpack('>Q', f.read(8))[0]
                    payload = pos + 16
                box_end = None if size == 0 else pos + size
                yield typ, payload, box_end
                if box_end is None:
                    return
                f.seek(box_end)

        for typ, payload, box_end in boxes(None):
            if typ != b'moov':
                continue
            f.seek(payload)
            for t2, p2, e2 in boxes(box_end):
                if t2 != b'mvhd':
                    continue
                f.seek(p2)
                version = f.read(4)[0]
                if version == 1:
                    f.seek(p2 + 20)
                    timescale, = struct.unpack('>I', f.read(4))
                    duration, = struct.unpack('>Q', f.read(8))
                else:
                    f.seek(p2 + 12)
                    timescale, duration = struct.unpack('>II', f.read(8))
                if timescale == 0:
                    raise ValueError(f'{path}: mvhd timescale is 0')
                return duration / timescale
    raise ValueError(f'{path}: no moov/mvhd atom found (not an mp4?)')


def get_video_duration(path) -> float:
    '''Video duration in seconds via ffprobe (reference:
    single_video_prediction.py:259-277; used when --duration_in_secs is
    omitted and --video_path given). On ffprobe-less hosts, falls back
    to parsing the mp4 mvhd atom directly.'''
    ffprobe = which_ffprobe()
    if not ffprobe:
        try:
            duration = mp4_duration_mvhd(path)
        except (OSError, ValueError, struct.error) as e:
            raise SystemExit(
                f'ffprobe not found on PATH and mp4 header parse failed '
                f'({e}); pass --duration_in_secs explicitly')
        print('Video Duration:', duration)
        return duration
    # stderr captured SEPARATELY: an ffprobe warning merged into stdout
    # would corrupt the float parse with an unhelpful traceback
    cmd = [ffprobe, '-hide_banner', '-v', 'error',
           '-show_entries', 'format=duration',
           '-of', 'default=noprint_wrappers=1:nokey=1', str(path)]
    result = subprocess.run(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    if result.returncode != 0 or not result.stdout.strip():
        raise SystemExit(f'ffprobe failed on {path}: '
                         f'{result.stderr.strip() or "no duration output"}')
    duration = float(result.stdout.strip())
    print('Video Duration:', duration)
    return duration


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='One video prediction')
    parser.add_argument('--prop_generator_model_path', required=True)
    parser.add_argument('--pretrained_cap_model_path', required=True)
    parser.add_argument('--vggish_features_path', required=True)
    parser.add_argument('--rgb_features_path', required=True)
    parser.add_argument('--flow_features_path', required=True)
    parser.add_argument('--duration_in_secs', type=float, default=None,
                        help='video duration; omit to derive it from '
                             '--video_path via ffprobe')
    parser.add_argument('--video_path', default=None,
                        help='source .mp4 (only needed when '
                             '--duration_in_secs is omitted)')
    parser.add_argument('--device_id', type=int, default=0,
                        help='CUDA device index to run on (the reference\'s '
                             'CUDA device id)')
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                        help='cpu runs the models on the CPU (for tests)')
    parser.add_argument('--attention_impl', default='kernel',
                        choices=list(ATTENTION_IMPLS)[::-1],
                        help="the encoder's attention: the CUDA kernel or "
                             'plain PyTorch')
    parser.add_argument('--max_prop_per_vid', type=int, default=5)
    parser.add_argument('--nms_tiou_thresh', type=float)
    parser.add_argument('--train_meta_path', default='./data/train.csv')
    parser.add_argument('--output_json', default=None,
                        help='also write the predicted segments as JSON')
    parser.add_argument('--allow_vocab_drift', action='store_true',
                        help='decode even when the vocabulary rebuilt from '
                             '--train_meta_path differs in size from the '
                             'checkpoint embedding table (captions will '
                             'likely be garbled)')
    return parser


def main(argv=None) -> list:
    '''Run the app on ``argv`` (the command line when None); prints and
    returns the [{start, end, sentence}] list.'''
    parser = build_parser()
    args = parser.parse_args(argv)
    device = (f'cuda:{args.device_id}' if args.device == 'cuda' else 'cpu')
    if args.duration_in_secs is None:
        if not args.video_path:
            parser.error('pass --duration_in_secs or --video_path')
        args.duration_in_secs = get_video_duration(args.video_path)

    feature_paths = {
        'audio': args.vggish_features_path,
        'rgb': args.rgb_features_path,
        'flow': args.flow_features_path,
    }

    cap_cfg, _, cap_model, vocab = load_cap_model(
        args.pretrained_cap_model_path, args.train_meta_path,
        args.allow_vocab_drift, device)
    prop_cfg, _, prop_model = load_prop_model(
        args.prop_generator_model_path, args.max_prop_per_vid, device)
    if cap_cfg.modality != 'audio_video' or \
            prop_cfg.modality != 'audio_video':
        raise SystemExit(
            f'this app drives the bi-modal models only (like the '
            f'reference); got cap modality {cap_cfg.modality!r}, prop '
            f'modality {prop_cfg.modality!r}')

    pad_idx = vocab[cap_cfg.pad_token]
    proposals = generate_proposals(prop_model, feature_paths, pad_idx,
                                   prop_cfg, args.duration_in_secs,
                                   args.attention_impl)
    if args.nms_tiou_thresh is not None:
        proposals = non_max_suppression(proposals.reshape(-1, 3),
                                        args.nms_tiou_thresh)[None]

    captions = caption_proposals(cap_model, feature_paths, vocab, cap_cfg,
                                 proposals, args.duration_in_secs,
                                 args.attention_impl)
    print(captions)
    if args.output_json:
        with open(args.output_json, 'w') as f:
            json.dump(captions, f, indent=1)
    return captions


if __name__ == '__main__':
    main()
