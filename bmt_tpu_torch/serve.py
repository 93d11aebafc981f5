'''Caption serving and dense video captioning (counterpart of
``bmt_tpu.serve``).

- ``CaptionEngine.caption_crops`` takes per-segment feature dicts
  ({'rgb', 'flow', 'audio'}: (s, D) float arrays of ragged lengths), pads
  them into the shared bucket shapes (batch, Sv, Sa), decodes them through
  the KV-cached decoder (greedy, or a ``decode_fn`` from ``decode.beam`` /
  ``decode.sample``) and returns one sentence per crop. Buckets keep the
  set of shapes small, so the CUDA kernel and the caching allocator see few
  distinct sizes; padded batch rows repeat row 0 and are sliced away.
  ``kv_int8`` stores the cross-attention K/V int8, ``weights_int8`` serves
  every linear int8 (``ops.quant``), and ``add_adapter`` registers LoRA
  adapters that a request selects by name (``ops.lora.apply_adapter``).
- ``MicroBatcher`` coalesces concurrent requests into engine batches, with
  a queue cap (``QueueFull``) and a queue-age deadline
  (``DeadlineExceeded``).
- ``VideoPipeline.predict`` takes a whole video's features, finds its
  events with the proposal generator (one forward at the fixed padded
  shapes) and captions each event's crop through the engine.
- ``CaptionHTTPServer``: the JSON API (POST /caption, POST /predict,
  GET /healthz, GET /stats) on the standard library's threading server.

Not ported: data parallelism (ROADMAP queue 1 item 11) and
``export_decode`` / ``load_exported_decode``.
'''
from __future__ import annotations

import copy
import json
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from bmt_tpu_torch.data import (AUDIO_BUCKETS, VIDEO_BUCKETS, Vocab,
                                bucket_len, crop_a_segment, pad_segment,
                                pad_stack_batch)
from bmt_tpu_torch.decode.greedy import greedy_decode_bimodal
from bmt_tpu_torch.ops.attention import ATTENTION_IMPLS
from bmt_tpu_torch.ops.lora import apply_adapter, count_lora, merge_lora
from bmt_tpu_torch.ops.masks import make_masks
from bmt_tpu_torch.ops.quant import Int8Linear, quantize_tree_int8
from bmt_tpu_torch.params import jax_child
from bmt_tpu_torch.utils.proposal_utils import (get_corner_coords,
                                                non_max_suppression,
                                                remove_very_short_segments,
                                                select_topk_predictions,
                                                trim_proposals)

__all__ = ['BATCH_BUCKETS', 'CaptionEngine', 'CaptionHTTPServer',
           'DeadlineExceeded', 'MicroBatcher', 'QueueFull', 'VideoPipeline',
           'Vocab', 'ints_to_sentence']

SHORTEST_SEGMENT = 0.2      # seconds; shorter proposals are dropped

BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


class QueueFull(RuntimeError):
    '''Raised by ``MicroBatcher.submit`` when the admission queue is at
    capacity; the HTTP layer answers 503.'''


class DeadlineExceeded(RuntimeError):
    '''Set on a request's future when it waited in the queue past the
    batcher's ``deadline_ms`` before reaching the device; the HTTP layer
    answers 504.'''


def ints_to_sentence(ints, vocab, end_token: str = '</s>') -> str:
    '''Token ids -> sentence: drop the start token, cut at the first end
    token, join and capitalize (``bmt_tpu/train/loops.py``).'''
    strings = [vocab.itos[int(i)] for i in ints][1:]
    if end_token in strings:
        strings = strings[:strings.index(end_token)]
    return ' '.join(strings).capitalize()


def _check_bimodal(what: str, model) -> None:
    '''Serving runs the bi-modal models only, as in the JAX package.'''
    if model.dims.modality != 'audio_video':
        raise ValueError(f'{what} serves the bi-modal (audio_video) models '
                         f'only; got a {model.dims.modality} model')


def _check_impl(attention_impl: str) -> None:
    if attention_impl not in ATTENTION_IMPLS:
        raise ValueError(f'attention_impl {attention_impl!r} is not one '
                         f'of {ATTENTION_IMPLS}')


def _serving_copy(model, compute_dtype, weights_int8: bool = False):
    '''The model to serve, in eval mode: a copy when it must change (cast
    to ``compute_dtype``, quantized, or with LoRA adapters of its own folded
    into the weights), else the model itself.'''
    cast = compute_dtype is not None and compute_dtype != next(
        model.parameters()).dtype
    if cast or weights_int8 or count_lora(model)[0]:
        model = copy.deepcopy(model)
        if cast:
            model = model.to(dtype=compute_dtype)
        if weights_int8:
            quantize_tree_int8(model)         # folds adapters in first
        else:
            merge_lora(model)
    return model.eval()


class CaptionEngine:
    '''Batched, bucketed captioning over feature crops.

    ``model``: a ``BiModalTransformer``; the engine serves it on the device
    its parameters live on, in ``eval()`` mode. ``compute_dtype`` (e.g.
    ``torch.bfloat16``) serves a cast copy of the model and casts the
    features; None keeps the model's dtype and fp32 features.
    ``attention_impl``: 'kernel' (the fused CUDA attention in the encoder)
    or 'torch' (plain math). ``kv_int8``: the greedy decode stores the
    cross-attention K/V int8. ``weights_int8``: every linear of a copy is
    quantized (``ops.quant``), after the cast. ``decode_fn``: fn(model,
    feature_stacks) -> (B, max_len + 1) tokens in place of greedy decoding
    (``decode.make_bimodal_beam_fn``, ``make_bimodal_sample_fn``).

    A model that carries LoRA adapters of its own is served with them
    folded into its weights (a copy); the JAX engine keeps them as leaves,
    which computes the same up to rounding. Registered adapters
    (``add_adapter``) stay separate: each is only its deltas, applied by
    hooks on the shared base linears for the batches that select it.'''

    def __init__(self, model, vocab: Vocab, *, max_len: int = 30,
                 start_token: str = '<s>', end_token: str = '</s>',
                 pad_token: str = '<blank>', max_batch: int = 64,
                 attention_impl: str = 'kernel',
                 compute_dtype: torch.dtype | None = None,
                 kv_int8: bool = False, weights_int8: bool = False,
                 decode_fn=None):
        _check_impl(attention_impl)
        _check_bimodal('CaptionEngine', model)
        model = _serving_copy(model, compute_dtype, weights_int8)
        self.model = model
        self.device = next(model.parameters()).device
        self.dims = model.dims
        self.vocab = vocab
        self.max_len = max_len
        self.end_token = end_token
        self.start_idx = vocab[start_token]
        self.end_idx = vocab[end_token]
        self.pad_idx = vocab[pad_token]
        self.max_batch = max_batch
        self.attention_impl = attention_impl
        self.compute_dtype = compute_dtype
        self.kv_int8 = kv_int8
        self.weights_int8 = weights_int8
        self.decode_fn = decode_fn
        # LoRA adapters: name -> {linear of the base: (A, B, s)}
        self.adapters: Dict[str, dict] = {}
        self._lock = threading.Lock()    # one batch on the device at a time
        self.n_requests = 0
        self.n_batches = 0
        self.n_rows_padded = 0

    def _bucket_batch(self, n: int) -> int:
        for cand in BATCH_BUCKETS:
            if cand >= n:
                return min(cand, self.max_batch)
        return self.max_batch

    def _pad_batch(self, crops: Sequence[dict], Bb: int, Sv: int,
                   Sa: int) -> dict:
        '''rgb and audio padded with pad_idx (the masks read channel 0),
        flow with 0.0; pad rows repeat row 0 so they decode over real masks.
        Returns tensors on the engine's device.'''
        batch = {
            'rgb': pad_stack_batch([c['rgb'] for c in crops], self.pad_idx,
                                   Sv),
            'flow': pad_stack_batch([c['flow'] for c in crops], 0.0, Sv),
            'audio': pad_stack_batch([c['audio'] for c in crops],
                                     self.pad_idx, Sa),
        }
        dtype = self.compute_dtype or torch.float32
        out = {}
        for key, x in batch.items():
            if len(crops) < Bb:
                x = np.concatenate(
                    [x, np.repeat(x[:1], Bb - x.shape[0], axis=0)], axis=0)
            out[key] = torch.from_numpy(x).to(device=self.device, dtype=dtype)
        return out

    # -- LoRA adapters ------------------------------------------------------

    def add_adapter(self, name: str, sites: Dict[str, dict]) -> int:
        '''Register a LoRA adapter under ``name`` for per-request selection
        (``caption_crops(..., adapter=name)``, HTTP ``{"adapter": name}``).

        ``sites``: ``{tree path: {'lora_a', 'lora_b', 'lora_s'}}`` from
        ``train.checkpoint.load_lora_sites``. The adapter keeps only these
        deltas (fp32, on the engine's device); the base linears are shared
        by every adapter, and a delta rides on top of the base product,
        int8 or not. Returns the adapted-site count.'''
        entries = {}
        for site, leaves in sites.items():
            node, path_done = self.model, ''
            for head in site.split('/'):
                try:
                    if not isinstance(node, nn.Module):     # a parameter
                        raise KeyError(head)
                    node = jax_child(node, head)
                except IndexError:
                    raise ValueError(
                        f'adapter {name!r}: site path {path_done}/{head} '
                        f'indexes past the served model\'s {len(node)} '
                        f'layers (finetune of a deeper architecture?)'
                    ) from None
                except KeyError:
                    raise ValueError(
                        f'adapter {name!r}: site path {path_done}/{head} not '
                        f'in the served model (different architecture?)'
                    ) from None
                path_done = f'{path_done}/{head}'
            if not isinstance(node, (nn.Linear, Int8Linear)):
                raise ValueError(f'adapter {name!r}: site {path_done!r} is '
                                 f'not a linear in the served model')
            a, b = leaves['lora_a'], leaves['lora_b']
            base = (node.in_features, node.out_features)
            if (a.shape[0], b.shape[1]) != base or a.shape[1] != b.shape[0]:
                raise ValueError(
                    f'adapter {name!r}: site {path_done!r} deltas '
                    f'{a.shape}x{b.shape} do not fit the base {base} linear')
            entries[node] = tuple(
                torch.from_numpy(np.array(x, np.float32)).to(self.device)
                for x in (a, b, leaves['lora_s']))
        self.adapters[name] = entries
        return len(sites)

    def _select_params(self, adapter: Optional[str]):
        '''The adapter's sites, None for the base; an unknown name raises.'''
        if adapter is None:
            return None
        if adapter not in self.adapters:
            raise ValueError(
                f'unknown adapter {adapter!r}; loaded: '
                f'{sorted(self.adapters) or "none"}')
        return self.adapters[adapter]

    # -- public API ---------------------------------------------------------

    def validate_crop(self, crop: dict) -> None:
        '''Per-request shape checks, raised before a crop joins a batch.'''
        if crop['rgb'].shape[0] != crop['flow'].shape[0]:
            raise ValueError(
                f'rgb/flow length mismatch: {crop["rgb"].shape[0]} vs '
                f'{crop["flow"].shape[0]} frames (I3D emits both streams '
                f'at the same temporal stride)')
        if crop['rgb'].shape[0] > VIDEO_BUCKETS[-1] \
                or crop['audio'].shape[0] > AUDIO_BUCKETS[-1]:
            raise ValueError(
                f'crop too long: video {crop["rgb"].shape[0]} frames '
                f'(max {VIDEO_BUCKETS[-1]}), audio '
                f'{crop["audio"].shape[0]} (max {AUDIO_BUCKETS[-1]}) -- '
                f'split the segment')

    def _decode(self, batch: dict) -> torch.Tensor:
        if self.decode_fn is not None:
            return self.decode_fn(self.model, batch)
        return greedy_decode_bimodal(
            self.model, batch, self.max_len, self.start_idx, self.end_idx,
            self.pad_idx, self.attention_impl, self.kv_int8)

    def caption_tokens(self, crops: Sequence[dict], _count: bool = True,
                       adapter: Optional[str] = None) -> np.ndarray:
        '''Decode crops; returns (len(crops), max_len + 1) int32 tokens.
        ``adapter`` names a registered LoRA adapter; None decodes the base.'''
        sites = self._select_params(adapter)
        if not crops:
            return np.zeros((0, self.max_len + 1), np.int32)
        for c in crops:
            self.validate_crop(c)
        out = []
        for lo in range(0, len(crops), self.max_batch):
            chunk = crops[lo:lo + self.max_batch]
            Bb = self._bucket_batch(len(chunk))
            Sv = bucket_len(max(c['rgb'].shape[0] for c in chunk),
                            VIDEO_BUCKETS)
            Sa = bucket_len(max(c['audio'].shape[0] for c in chunk),
                            AUDIO_BUCKETS)
            with self._lock, apply_adapter(sites), torch.inference_mode():
                batch = self._pad_batch(chunk, Bb, Sv, Sa)
                toks = self._decode(batch)
                toks = toks[:len(chunk)].cpu().numpy().astype(np.int32)
                if _count:
                    self.n_batches += 1
                    self.n_requests += len(chunk)
                    self.n_rows_padded += Bb - len(chunk)
            out.append(toks)
        return np.concatenate(out, axis=0)

    def caption_crops(self, crops: Sequence[dict],
                      adapter: Optional[str] = None) -> List[str]:
        return [ints_to_sentence(row, self.vocab, self.end_token)
                for row in self.caption_tokens(crops, adapter=adapter)]

    def warmup(self, batch_sizes: Sequence[int] | None = None,
               shapes: Sequence[tuple] = ((96, 256),)) -> int:
        '''Decode one all-zero batch per (batch bucket, (Sv, Sa)) pair ahead
        of traffic, for the base and, when adapters are registered, for the
        first of them (every adapter runs the same operations): this builds
        the CUDA kernel and fills the caching allocator. Warmup bypasses the
        counters. Returns the number of batches decoded.'''
        if batch_sizes is None:
            batch_sizes = sorted({self._bucket_batch(b)
                                  for b in BATCH_BUCKETS
                                  if b <= self.max_batch} | {self.max_batch})
        reps = sorted(self.adapters)[:1]
        n = 0
        for Sv, Sa in shapes:
            for b in batch_sizes:
                if b > self.max_batch:
                    continue
                crop = {'rgb': np.zeros((Sv, self.dims.d_vid), np.float32),
                        'flow': np.zeros((Sv, self.dims.d_vid), np.float32),
                        'audio': np.zeros((Sa, self.dims.d_aud), np.float32)}
                for a_name in [None] + reps:
                    self.caption_tokens([crop] * b, _count=False,
                                        adapter=a_name)
                    n += 1
        return n

    def stats(self) -> dict:
        return {'requests': self.n_requests, 'batches': self.n_batches,
                'rows_padded': self.n_rows_padded,
                'avg_batch': round(self.n_requests / self.n_batches, 2)
                if self.n_batches else 0.0,
                'adapters': sorted(self.adapters)}


class MicroBatcher:
    '''Coalesce concurrent caption requests into engine batches.

    ``submit(crop)`` returns a Future resolving to the sentence. A worker
    thread drains the queue: it waits at most ``max_wait_ms`` after the
    first pending request, then decodes up to ``engine.max_batch`` pending
    requests in one batch. ``max_queue`` bounds the queue: past it,
    ``submit`` raises ``QueueFull``. ``deadline_ms`` bounds a request's wait
    in the queue: at each drain, requests older than it fail with
    ``DeadlineExceeded`` instead of being decoded; None (the default) sets
    no deadline. Unlike the JAX batcher, which reads 0 as no deadline, a
    ``deadline_ms`` <= 0 raises. Cancelled futures are dropped at the
    drain, and a batch takes only the oldest request's adapter cohort (one
    adapter per batch).'''

    def __init__(self, engine: CaptionEngine, max_wait_ms: float = 5.0,
                 max_queue: int = 1024,
                 deadline_ms: Optional[float] = None):
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f'deadline_ms must be > 0 or None (no '
                             f'deadline), got {deadline_ms}')
        self.engine = engine
        self.max_wait = max_wait_ms / 1e3
        self.max_queue = max_queue
        self.deadline = deadline_ms / 1e3 if deadline_ms is not None else None
        self.n_shed = 0
        self._pending: List[tuple] = []
        self._mu = threading.Condition()
        self._closed = False
        # end-to-end latency samples (submit -> result), a bounded window
        self._lat = deque(maxlen=2048)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, crop: dict,
               adapter: Optional[str] = None) -> 'Future[str]':
        # a bad crop or an unknown adapter fails its own submit, not the
        # batch it would have joined
        self.engine.validate_crop(crop)
        self.engine._select_params(adapter)
        fut: Future = Future()
        with self._mu:
            if self._closed:
                raise RuntimeError('batcher is closed')
            if len(self._pending) >= self.max_queue:
                raise QueueFull(
                    f'{len(self._pending)} requests already queued')
            self._pending.append((crop, fut, time.monotonic(), adapter))
            self._mu.notify()
        return fut

    def caption(self, crop: dict, timeout: Optional[float] = None,
                adapter: Optional[str] = None) -> str:
        return self.submit(crop, adapter=adapter).result(timeout)

    def _shed(self) -> None:
        '''Fail the pending requests older than the deadline (under _mu).'''
        now = time.monotonic()
        live, dead = [], []
        for e in self._pending:
            (dead if now - e[2] > self.deadline else live).append(e)
        self._pending = live
        self.n_shed += len(dead)
        for _, fut, t0, _ in dead:
            if not fut.done():
                fut.set_exception(DeadlineExceeded(
                    f'queued {(now - t0) * 1e3:.0f} ms > deadline '
                    f'{self.deadline * 1e3:.0f} ms; retry against a '
                    f'replica'))

    def _take(self) -> tuple:
        '''(batch, adapter): up to max_batch pending requests of the oldest
        request's adapter, taken off the queue (under _mu).'''
        if not self._pending:
            return [], None
        adapter = self._pending[0][3]
        batch, rest = [], []
        for e in self._pending:
            if e[3] == adapter and len(batch) < self.engine.max_batch:
                batch.append(e)
            else:
                rest.append(e)
        self._pending = rest
        return batch, adapter

    def _run(self):
        while True:
            with self._mu:
                while not self._pending and not self._closed:
                    self._mu.wait()
                if self._closed and not self._pending:
                    return
                deadline = time.monotonic() + self.max_wait
                while (len(self._pending) < self.engine.max_batch
                       and not self._closed):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._mu.wait(timeout=left)
                self._pending = [e for e in self._pending
                                 if not e[1].cancelled()]
                if self.deadline is not None:
                    self._shed()
                batch, adapter = self._take()
            if not batch:
                continue
            try:
                sentences = self.engine.caption_crops(
                    [c for c, _, _, _ in batch], adapter=adapter)
                done_t = time.monotonic()
                for (_, fut, t0, _), s in zip(batch, sentences):
                    # a future cancelled mid-decode must not fail the rest
                    try:
                        if not fut.cancelled():
                            fut.set_result(s)
                            self._lat.append(done_t - t0)
                    except Exception:
                        pass
            except Exception as e:          # to every waiter of the batch
                for _, fut, _, _ in batch:
                    if not fut.done():
                        fut.set_exception(e)

    def stats(self) -> dict:
        '''Queue depth, end-to-end latency percentiles (submit -> result,
        ms) over the last 2048 requests, and the shed count.'''
        with self._mu:
            depth = len(self._pending)
        lats = sorted(self._lat)

        def pct(p):
            if not lats:
                return None
            return round(lats[min(int(p * len(lats)), len(lats) - 1)] * 1e3,
                         2)

        return {'queue_depth': depth,
                'latency_ms': {'p50': pct(0.50), 'p95': pct(0.95),
                               'p99': pct(0.99)},
                'latency_samples': len(lats),
                'shed': self.n_shed}

    def close(self):
        with self._mu:
            self._closed = True
            self._mu.notify_all()
        self._worker.join()


class VideoPipeline:
    '''Dense video captioning as a service: a whole video's features ->
    the proposal generator -> a crop per proposed segment -> the caption
    engine (reference: single_video_prediction.py:279-316).

    ``prop_model``: a ``MultimodalProposalGenerator`` with its anchors set;
    served on the device its parameters live on, in ``eval()`` mode, as a
    copy cast to ``compute_dtype`` when that is given.
    ``pad_feats_up_to``: {'audio': Sa, 'video': Sv}, the rows every video is
    padded to (the proposal forward runs at one shape).
    ``max_prop_per_vid``: segments kept per video, by confidence.
    ``nms_tiou``: the default tIoU threshold of non-maximum suppression
    (None: none).
    ``attention_impl``: 'kernel' (the fused CUDA attention) or 'torch'.'''

    def __init__(self, engine: CaptionEngine, prop_model,
                 pad_feats_up_to: dict, max_prop_per_vid: int,
                 nms_tiou: Optional[float] = None,
                 attention_impl: str = 'kernel',
                 compute_dtype: torch.dtype | None = None):
        _check_impl(attention_impl)
        _check_bimodal('VideoPipeline', prop_model)
        self.engine = engine
        self.prop_model = _serving_copy(prop_model, compute_dtype)
        self.device = next(self.prop_model.parameters()).device
        self.pad_feats = dict(pad_feats_up_to)
        self.max_props = max_prop_per_vid
        self.nms_tiou = nms_tiou
        self.attention_impl = attention_impl
        self.compute_dtype = compute_dtype

    def inputs(self, feats: Dict[str, np.ndarray]):
        '''(src, masks): the features padded to ``pad_feats_up_to`` (audio
        and rgb with the pad index, flow with 0) as a batch of one on the
        device, in the compute dtype, and their masks, read from the fp32
        features.'''
        pad_idx = self.engine.pad_idx
        stacks = {
            'audio': pad_segment(feats['audio'], self.pad_feats['audio'],
                                 pad_idx),
            'rgb': pad_segment(feats['rgb'], self.pad_feats['video'],
                               pad_idx),
            'flow': pad_segment(feats['flow'], self.pad_feats['video'], 0.0)}
        src = {k: torch.as_tensor(x[None], dtype=torch.float32,
                                  device=self.device)
               for k, x in stacks.items()}
        masks = make_masks(src, None, self.prop_model.dims.modality, pad_idx)
        dtype = self.compute_dtype or torch.float32
        return {k: x.to(dtype) for k, x in src.items()}, masks

    def proposals(self, feats: Dict[str, np.ndarray]) -> np.ndarray:
        '''The generator's raw predictions for one video: (1, N, 3) fp32
        [center, length, conf] in seconds.'''
        src, masks = self.inputs(feats)
        with self.engine._lock, torch.inference_mode():
            preds = self.prop_model(src, None, masks, self.attention_impl)[0]
            return preds.float().cpu().numpy()

    def predict(self, feats: Dict[str, np.ndarray], duration: float,
                nms_tiou: Optional[float] = None,
                adapter: Optional[str] = None) -> List[dict]:
        '''feats: a whole video's {'rgb', 'flow', 'audio'} (s, D) arrays;
        duration: its length in seconds. Returns [{'start', 'end',
        'sentence'}, ...] in confidence order, times rounded to 0.1 s.
        ``adapter`` selects a registered LoRA adapter for the captions (the
        proposals always come from the base proposal generator).'''
        self.engine._select_params(adapter)   # an unknown name raises first
        preds = get_corner_coords(self.proposals(feats))
        preds = trim_proposals(preds, [duration])
        preds = remove_very_short_segments(preds, SHORTEST_SEGMENT)
        preds = select_topk_predictions(preds, k=self.max_props)
        tiou = nms_tiou if nms_tiou is not None else self.nms_tiou
        segments = preds.reshape(-1, 3)
        if tiou is not None:
            segments = non_max_suppression(segments, tiou)

        crops, kept = [], []
        for start, end, _conf in segments:
            crop = {k: crop_a_segment(feats[k], float(start), float(end),
                                      duration) for k in feats}
            if any(v is None for v in crop.values()):
                continue                 # an empty crop (the reference skips)
            crops.append(crop)
            kept.append((float(start), float(end)))
        sentences = self.engine.caption_crops(crops, adapter=adapter)
        return [{'start': round(s, 1), 'end': round(e, 1), 'sentence': sent}
                for (s, e), sent in zip(kept, sentences)]


# -- HTTP front end ----------------------------------------------------------

def _crop_from_json(obj: dict, dims, max_lens=None) -> dict:
    '''Parse and validate one request's features. ``max_lens`` {'video': n,
    'audio': n} rejects over-long inputs per request (a bad crop answers
    400 at admission instead of failing a coalesced batch).'''
    if max_lens is None:
        max_lens = {'video': VIDEO_BUCKETS[-1], 'audio': AUDIO_BUCKETS[-1]}
    feats = obj.get('features', obj)
    crop = {}
    for key, d, kind in (('rgb', dims.d_vid, 'video'),
                         ('flow', dims.d_vid, 'video'),
                         ('audio', dims.d_aud, 'audio')):
        if key not in feats:
            raise ValueError(f'missing feature: {key}')
        arr = np.asarray(feats[key], np.float32)
        if arr.ndim != 2 or arr.shape[1] != d:
            raise ValueError(
                f'{key}: expected (s, {d}), got {list(arr.shape)}')
        if arr.shape[0] > max_lens[kind]:
            raise ValueError(
                f'{key}: {arr.shape[0]} frames exceeds the maximum '
                f'{max_lens[kind]} — split the segment')
        crop[key] = arr
    if crop['rgb'].shape[0] != crop['flow'].shape[0]:
        raise ValueError(
            f'rgb/flow length mismatch: {crop["rgb"].shape[0]} vs '
            f'{crop["flow"].shape[0]} frames (I3D emits both streams at '
            f'the same temporal stride)')
    return crop


class _CaptionHandler(BaseHTTPRequestHandler):
    '''One request (the threading server makes one per connection); the
    server object carries the engine, the batcher and the pipeline. Client
    errors answer 400, an unknown path or a /predict without a proposal
    model 404, a full queue 503, a request that timed out or was shed 504,
    anything else 500.'''

    def _reply(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == '/healthz':
            self._reply(200, {'status': 'ok'})
        elif self.path == '/stats':
            stats = dict(self.server.engine.stats())
            stats.update(self.server.batcher.stats())
            self._reply(200, stats)
        else:
            self._reply(404, {'error': f'unknown path {self.path}'})

    def do_POST(self):
        if self.path == '/caption':
            handler, payload_key = self._handle_caption, 'sentence'
        elif self.path == '/predict':
            if self.server.pipeline is None:
                self._reply(404, {'error': 'no proposal model loaded '
                                           '(--prop_generator_model_path)'})
                return
            handler, payload_key = self._handle_predict, 'results'
        else:
            self._reply(404, {'error': f'unknown path {self.path}'})
            return
        try:
            length = int(self.headers.get('Content-Length', 0))
            obj = json.loads(self.rfile.read(length))
            if not isinstance(obj, dict):
                raise ValueError('request body must be a JSON object')
        except Exception as e:
            self._reply(400, {'error': f'{type(e).__name__}: {e}'})
            return
        try:
            result = handler(obj)
        except QueueFull as e:
            self._reply(503, {'error': f'server saturated: {e}'})
            return
        except FutureTimeoutError:
            self._reply(504, {'error': 'request timed out in queue; '
                                       'retry against a replica'})
            return
        except DeadlineExceeded as e:
            self._reply(504, {'error': str(e)})
            return
        except (ValueError, KeyError, TypeError) as e:
            # raised while reading the client's values: a client error
            self._reply(400, {'error': f'{type(e).__name__}: {e}'})
            return
        except Exception as e:
            self._reply(500, {'error': f'{type(e).__name__}: {e}'})
            return
        self._reply(200, {payload_key: result})

    @staticmethod
    def _adapter(obj: dict):
        adapter = obj.get('adapter')
        if adapter is not None and not isinstance(adapter, str):
            raise ValueError('"adapter" must be a string adapter name')
        return adapter

    def _handle_caption(self, obj: dict):
        crop = _crop_from_json(obj, self.server.engine.dims)
        fut = self.server.batcher.submit(crop, adapter=self._adapter(obj))
        try:
            return fut.result(timeout=self.server.request_timeout)
        except FutureTimeoutError:
            # the client is gone: a crop not yet decoded is dropped
            fut.cancel()
            raise

    def _handle_predict(self, obj: dict):
        # the whole video must fit the proposal model's padded lengths
        feats = _crop_from_json(obj, self.server.engine.dims,
                                max_lens=self.server.pipeline.pad_feats)
        duration = float(obj['duration'])
        if duration <= 0:
            raise ValueError('duration must be positive')
        nms = obj.get('nms_tiou')
        return self.server.pipeline.predict(
            feats, duration, None if nms is None else float(nms),
            adapter=self._adapter(obj))

    def log_message(self, *args):      # quiet
        pass


class CaptionHTTPServer(ThreadingHTTPServer):
    '''The JSON API over an engine, with a ``MicroBatcher`` in front of it
    and, given a ``pipeline``, POST /predict.'''
    daemon_threads = True

    def __init__(self, addr, engine: CaptionEngine,
                 max_wait_ms: float = 5.0, request_timeout: float = 120.0,
                 pipeline: Optional[VideoPipeline] = None,
                 max_queue: int = 1024,
                 deadline_ms: Optional[float] = None):
        batcher = MicroBatcher(engine, max_wait_ms, max_queue=max_queue,
                               deadline_ms=deadline_ms)
        super().__init__(addr, _CaptionHandler)
        self.engine = engine
        self.batcher = batcher
        self.request_timeout = request_timeout
        self.pipeline = pipeline

    def shutdown(self):
        super().shutdown()
        self.batcher.close()
        self.server_close()              # release the listening socket
