#!/usr/bin/env python3
'''Smoke test of the PyTorch port (bmt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA device; it imports
nothing of JAX. Phases, each of which stops the script with a non-zero exit
when it fails:

1. the device: torch's name for it and nvidia-smi's name and power limit;
2. build the CUDA kernels from bmt_tpu_torch/csrc/ (one nvcc per source,
   started together; timed): the forward on tensor cores in fp32
   (flash_attn_fwd_tf32_kernel, 3xTF32, and flash_attn_fwd_combine_kernel,
   which combines the partials of a split key loop) and in bf16
   (flash_attn_fwd_bf16_kernel); dQ and dK/dV as fp32 FMA kernels and bf16
   tensor-core kernels (flash_attn_bwd_dq_bf16_kernel,
   flash_attn_bwd_dkv_bf16_kernel); the tensor-core kernels at head dims
   padded to 64 and 256; print what ptxas reports for each and fail if one
   is missing or any kernel spills registers;
3. the forward kernel against its plain PyTorch version on the card, in
   fp32 and bf16, at the serving shapes and at Sq = Sk = 2048, with random
   padded key masks and one batch row whose keys are all masked (NaN in
   both);
4. the training kernels on the card, in fp32 and bf16: the lse forward
   against flash_attention_lse_reference and dQ, dK, dV against their plain
   versions on the same inputs, at the train cell's seven attention shapes
   (B=32, H=4, d=256) and at S=2048 plain and causal; the batch row with
   every key masked has lse -inf and exactly zero gradients in both; the
   bf16 dQ of the 256x256 call is bitwise equal across two launches (no
   atomics);
5. serving: a flagship-width BiModalTransformer made from a seed on the card,
   round-tripped through the JAX-layout npz, answers five crops of ragged
   lengths in two buckets through CaptionEngine (bf16); the forward kernel's
   launch count must rise by 8 per batch (2 layers x 4 encoder attentions);
6. serving parity: in fp32 the engine's tokens through the kernel equal
   those of the plain path, or their step log-probs agree along one
   trajectory;
7. train-step parity (fp32, flagship width, B=4, dropout off): two Adam
   steps through attention_impl 'kernel' and 'torch'; loss, grad_norm,
   gradients and parameters agree;
8. train-step timing (bf16) at bench.py's train cell (B=32, Sa=256, Sv=96,
   Sc=22, flagship, Adam lr 5e-5, clip 1.0, smoothing 0.7, dropout 0.1):
   ms per step through both paths (median of alternating repetitions), 14
   launches of each kernel per step, a loss that falls over 10 steps on one
   repeated batch, the device-busy time of one step of each path
   (torch.profiler), and at the step's seven attention shapes in bf16 each
   kernel's device time (torch.profiler) beside its plain version's, its
   bound (attention_cost) and its share of it, and the library yardsticks
   timed in the same turns: F.scaled_dot_product_attention for the forward,
   one autograd.grad through it (dQ, dK and dV together) for the backward
   pair; and each kernel's time per call launched back to back (CUDA
   events), which the host's launch rate sets for short calls; then the
   same for the three kernels in fp32 at the step's 256x256 call;
9. the trainer: train_epoch_cap over an in-memory dataset of 20 crops in
   batches of 8 (a ragged tail of 4) through the kernels; the launch counts
   of this run are the ones the kernel report gives;
10. serving timings in bf16 at B=64, Sa=256, Sv=96, 30 decode steps: the
    forward kernel's device time beside the plain attention's,
    scaled_dot_product_attention's and its bound at the five encoder and
    decoder shapes, decode captions/s
    through both paths, and the uncached decoder once as the baseline;
11. the three kernels at the proposal generator's shapes (H=4, d=256;
    800x800, 300x300, 800x300, 300x800), in fp32 and bf16, against their
    plain versions: the lse forward at B=1 and B=16, dQ and dK/dV at B=16,
    with key masks of videos shorter than the pad (65%, 40%, 90% of the
    rows) and one batch row with every key masked; then each kernel's
    device time in bf16 beside its plain version's, the library call's and
    its bound, at B=16 and (the serving forward) B=1;
12. dense captioning (bf16): a flagship MultimodalProposalGenerator
    (PropModelDims(): 10 + 10 conv heads, 48 + 128 anchors as bench.py sets
    them) from a seed, round-tripped through the JAX-layout npz, serves two
    videos (300 video and 800 audio rows, 768 s; 120 and 320 rows,
    307.2 s) through VideoPipeline and the phase-5 engine: at most 100
    segments each, inside the video, with string sentences, and 8 forward
    launches per proposal forward; the proposal forward's device ms, that
    of its 20 conv heads alone, and the seconds per video end to end;
13. proposal parity (fp32): the raw predictions of both videos through
    'kernel' and 'torch' agree within PROP_TOL, and their top-100 segments
    are the same up to a boundary tie (see phase_prop_parity);
14. proposal train-step parity (fp32, flagship, B=2, Sa=800, Sv=300, E=6,
    dropout off, 2 Adam steps): loss, each loss term, grad_norm, gradients
    (whole and by part, within PROP_STEP_TOL; the heads' ReLU ties that
    explain the gap are counted) and parameters agree, the anchors stay bit
    for bit; then one step with
    the encoder frozen (remat on) launches no dQ and no dK/dV and leaves the
    encoder and the anchors bit for bit;
15. the proposal train step (bf16) at bench.py's proposal cell (B=16,
    Sa=800, Sv=300, E=6, remat, Adam lr 5e-5, clip 1.0, dropout 0.1): ms
    per step through both paths (median of alternating repetitions), 16
    forward, 8 dQ and 8 dK/dV launches per step, a loss that falls over 10
    steps on one repeated batch, one torch.profiler trace per path (kernel
    sums by name; no busy share: the trace's sum may overrun the traced
    span on this step), the 20 conv heads' device time beside the attention
    kernels', and
    train_epoch_prop over 20 in-memory videos in batches of 8 (two steps,
    the tail of 4 dropped);
16. the single-video app from checkpoints (fp32, as the app computes): a
    captioner from build_parser()'s train_cap defaults, its vocabulary
    rebuilt by build_vocab_from_meta from a train CSV of
    data/vocab_ref.json's tokens, and a proposal generator from the
    train_prop defaults (bench.py's anchors), both from a seed, saved as
    native npz directories and as reference .pt files (save and load
    seconds, sizes; loads equal to the saved parameters); the full-length
    video of phase 12 as .npy files through
    single_video_prediction.main three times, each with
    --max_prop_per_vid 100: native checkpoints through the kernel, the .pt
    files through the kernel, native through plain attention. The native
    and .pt runs give identical JSON; the kernel and plain runs the same
    top-100 up to a boundary tie (phase 13's rule) and the same sentences
    (or, for a sentence that differs, step log-probs within LOGPROB_TOL
    along one trajectory, phase 6's rule); the kernel run launches 8 + 8
    forwards (one proposal forward, one caption batch). The app's seconds
    end to end and by stage, then the fp32 forward kernel's device time
    where the app launches it, at the four B=1 proposal shapes (key loops
    split) and the caption batch's four shapes, beside plain, library and
    bound, and the kernel that scaled_dot_product_attention runs at the
    caption batch's 512x512 call (torch.profiler).

The line before the last is the kernel report as JSON; the last line is
{"ok": true, "device": {...}}. The report's `launches` are the captioning
trainer's (phase 9); `launches_by_path` gives those of each main path's run
(phases 9, 12, 15 and 16), `proposal_800x800` each kernel's times at the
proposal cell's 800x800 call, and the forward's `fp32_app` its fp32 times
at the app's caption-batch 512x512 and B=1 800x800 calls.
'''
import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from bmt_tpu_torch.config import Config, build_parser
from bmt_tpu_torch.decode import greedy_decode_bimodal, greedy_decode_uncached
from bmt_tpu_torch.decode.greedy import bimodal_step_setup
from bmt_tpu_torch.models import BiModalTransformer, CapModelDims
from bmt_tpu_torch.ops._build import load_library, ptxas_report
from bmt_tpu_torch.ops.flash_attention import (
    BWD_LIBRARY, KERNEL, KERNEL_DKV, KERNEL_DQ, attention_bound_ms,
    attention_cost, flash_attention, fp32_key_splits,
    flash_attention_bwd_dkv, flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq, flash_attention_bwd_dq_reference,
    flash_attention_forward, flash_attention_lse_reference,
    flash_attention_reference, key_mask_and_causal, launch_counts,
    reset_launch_counts, row_dot)
from bmt_tpu_torch.models import MultimodalProposalGenerator, PropModelDims
from bmt_tpu_torch.params import (load_jax_params, load_params_npz,
                                  save_params_npz, to_jax_tree)
from bmt_tpu_torch.data import (AUDIO_BUCKETS, VIDEO_BUCKETS, Vocab,
                                bucket_len, build_vocab_from_meta)
from bmt_tpu_torch.ops.masks import make_masks
from bmt_tpu_torch.scripts import single_video_prediction as app
from bmt_tpu_torch.serve import SHORTEST_SEGMENT, CaptionEngine, VideoPipeline
from bmt_tpu_torch.train import (build_optimizer, init_train_state,
                                 make_cap_train_step,
                                 make_prop_inference_step,
                                 make_prop_train_step, prop_frozen, train_epoch_cap,
                                 train_epoch_prop)
from bmt_tpu_torch.train.checkpoint import (load_cap_checkpoint,
                                            load_prop_checkpoint,
                                            save_checkpoint,
                                            save_torch_checkpoint,
                                            save_torch_prop_checkpoint)
from bmt_tpu_torch.utils import (get_corner_coords,
                                 remove_very_short_segments,
                                 select_topk_predictions, trim_proposals)

SOURCES = {KERNEL: 'bmt_tpu_torch/csrc/flash_attn_fwd.cu',
           KERNEL_DQ: 'bmt_tpu_torch/csrc/flash_attn_bwd.cu',
           KERNEL_DKV: 'bmt_tpu_torch/csrc/flash_attn_bwd.cu'}
# the kernels each library holds: the forward on tensor cores (3xTF32 with
# its split's combine, and bf16); the backward on fp32 FMA and bf16 tensor
# cores
ENTRIES = {KERNEL: ('flash_attn_fwd_tf32_kernel',
                    'flash_attn_fwd_combine_kernel',
                    'flash_attn_fwd_bf16_kernel'),
           BWD_LIBRARY: ('flash_attn_bwd_dq_kernel',
                         'flash_attn_bwd_dq_bf16_kernel',
                         'flash_attn_bwd_dkv_kernel',
                         'flash_attn_bwd_dkv_bf16_kernel')}
REPLACES = {KERNEL: 'bmt_tpu/ops/pallas_attention.py:237',  # and :278
            KERNEL_DQ: 'bmt_tpu/ops/pallas_attention.py:473',
            KERNEL_DKV: 'bmt_tpu/ops/pallas_attention.py:498'}
# the library yardstick beside each kernel (timed, never called by the port)
LIBRARY_CALL = {
    KERNEL: 'F.scaled_dot_product_attention, the same boolean mask',
    KERNEL_DQ: 'autograd.grad through scaled_dot_product_attention: dQ, dK '
               'and dV together',
    KERNEL_DKV: 'autograd.grad through scaled_dot_product_attention: dQ, dK '
                'and dV together'}
# |kernel - plain| <= atol + rtol |plain|. fp32: the same math summed in
# another order. bf16: the output rounds to 8 mantissa bits (one ulp is
# 2^-7 relative) and the plain version also rounds p to bf16, so outputs may
# differ by an ulp or two, whose absolute size grows with |out|
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 1e-2)}
# gradients: fp32 as above. bf16: dS and P are rounded to bf16 at values
# that differ slightly between the two versions, and the gradient rounds to
# bf16 at the end, so they may differ by two ulps (2^-7 relative each)
BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
# lse: fp32 in both versions from the same inputs, summed in another order
LSE_TOL = (1e-5, 1e-5)
# log-probs along one trajectory, fp32: two fp32 encoders whose attention
# sums differ in order, seen through 2 layers and a 10172-word softmax
LOGPROB_TOL = 1e-3
# train-step parity, fp32 (attention sums in another order, seen through 2
# layers forward and back): loss and grad_norm relative; the gradient of
# the first step as one vector, relative L2; parameters after two Adam
# steps, absolute.
# A ReLU pre-activation within rounding of 0 can fall on either side in the
# two paths; such a tie moves one FFN row's gradient by |dh| |x|, ~5e-6 in
# an element, and the whole gradient by 4.6e-5 relative L2 on the H100 (the
# sound reading this limit sits above). Adam's first update,
# lr g / (|g| + eps), flips sign with such a change where |g| is that small,
# so the parity run takes eps 1e-3: since d/dg g / (|g| + eps) <= 1 / eps,
# an update then moves by at most lr |dg| / eps = 2.5e-7 a step for a tie,
# while a wrong gradient still moves it by up to lr
STEP_TOL = {'loss': 1e-5, 'grad_norm': 1e-4, 'grad': 1e-4, 'param': 1e-6}
VOC = 10172
PAD, START, END = 1, 2, 3
B, SA, SV, STEPS = 64, 256, 96, 30      # bench.py's decode cell
TB, TSC = 32, 22                        # bench.py's train cell (and SA, SV)
TRAIN_CFG = types.SimpleNamespace(optimizer='adam', lr=5e-5, grad_clip=1.0,
                                  weight_decay=0.0, beta1=0.9, beta2=0.999,
                                  eps=1e-8)
PARITY_CFG = types.SimpleNamespace(**{**vars(TRAIN_CFG), 'eps': 1e-3})
SMOOTHING = 0.7
DEVICE = 'cuda:0'                       # one card

# (name, B, H, Sq, Sk, d, causal): the attention calls of the serving path
# at the decode cell, and a long one that loops over 64 key tiles
CASES = [('enc self-attn audio', B, 4, SA, SA, 256, False),
         ('enc self-attn video', B, 4, SV, SV, 256, False),
         ('enc cross audio->video', B, 4, SA, SV, 256, False),
         ('enc cross video->audio', B, 4, SV, SA, 256, False),
         ('dec causal self-attn', B, 4, 22, 22, 256, True),
         ('long, many key tiles', 2, 4, 2048, 2048, 256, False),
         ('long causal', 2, 4, 2048, 2048, 256, True)]
# the 14 attention calls of a train step come in these seven shapes (the
# captions enter the decoder as Sc - 1 = 21 tokens), and the long ones
TRAIN_CASES = [('enc self-attn audio', TB, 4, SA, SA, 256, False),
               ('enc self-attn video', TB, 4, SV, SV, 256, False),
               ('enc cross audio->video', TB, 4, SA, SV, 256, False),
               ('enc cross video->audio', TB, 4, SV, SA, 256, False),
               ('dec causal self-attn', TB, 4, TSC - 1, TSC - 1, 256, True),
               ('dec cross -> audio', TB, 4, TSC - 1, SA, 256, False),
               ('dec cross -> video', TB, 4, TSC - 1, SV, 256, False),
               ('long, many key tiles', 2, 4, 2048, 2048, 256, False),
               ('long causal', 2, 4, 2048, 2048, 256, True)]
TRAIN_ROUNDS = 4                        # timed steps: 2 x this per path
CALLS_PER_STEP = 14                     # 2 layers x (4 encoder + 3 decoder)

# the proposal generator: bench.py's proposal cell (B=16, every video padded
# to 800 audio and 300 video rows, 6 events), the flagship PropModelDims()
# (d_model 1024, H=4, d_k=256, N=2, 10 + 10 conv heads, 48 + 128 anchors)
PB, PSA, PSV, PE = 16, 800, 300, 6
PROP_PAD = {'audio': PSA, 'video': PSV}
MAX_PROPS = 100                         # max_prop_per_vid
ANCHORS = (np.linspace(2.0, 300.0, 48), np.linspace(3.0, 400.0, 128))
PROP_CASES = [('prop self-attn audio', PB, 4, PSA, PSA, 256, False),
              ('prop self-attn video', PB, 4, PSV, PSV, 256, False),
              ('prop cross audio->video', PB, 4, PSA, PSV, 256, False),
              ('prop cross video->audio', PB, 4, PSV, PSA, 256, False)]
PROP_CALLS = 8                          # 2 layers x 4 encoder attentions
PROP_ROUNDS = 2                         # timed steps: 2 x this per path
# (name, video rows, audio rows, seconds): a video as long as the pad, and
# a short one (2.56 s a video row, 0.96 s an audio row)
PROP_VIDEOS = [('full', 300, 800, 768.0), ('short', 120, 320, 307.2)]
# raw proposal predictions kernel vs torch, fp32, |a - b| <= atol + rtol |b|:
# the two encoders' attention sums differ in order (~1e-6 relative), seen
# through 2 layers and the conv heads; centers reach 768 s (fp32 ulp 6e-5),
# lengths prior exp(l) stride carry l's error relatively, confidences are
# sigmoids in [0, 1]
PROP_TOL = (1e-4, 1e-4)
# proposal train-step parity, fp32: STEP_TOL, but the gradient (relative L2,
# of the whole and of each part: the encoder, the heads' convs by position)
# within 5e-4. The attention's ~1e-6 moves a few of the heads' 22.5 M ReLU
# inputs across 0 (5 on the H100); each such tie moves one (channel, row)'s
# whole upstream gradient into or out of the conv that feeds the ReLU, and
# so up to k x d_in of that conv's weight gradient (79 x 1024 in the video
# heads' first conv). That part reads 1.4e-4, the encoder 4.8e-5, the whole
# 7.6e-5, the heads' other convs below 4e-7 (no saturated confidence in
# the batch). The limit is 3.5x the worst part's reading and 10x the
# encoder's, and holds for ~10x as many ties (their errors add in squares)
PROP_STEP_TOL = {**STEP_TOL, 'grad': 5e-4}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'FAILED: {msg}')


def device_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def kernel_name(line):
    '''The kernel and template argument of a ptxas "Compiling entry" line:
    ..tc29flash_attn_bwd_dq_bf16_kernelILi256EEEv.. ->
    flash_attn_bwd_dq_bf16_kernel<256>. The mangled name's length prefix
    tells the kernel from the anonymous namespace, which holds the source's
    file name.'''
    m = re.search(r'\d+(flash_attn_\w*?_kernel)(?:ILi(\d+)EE|I(f)EE)?',
                  line)
    if m is None:
        return line.strip()
    arg = m.group(2) or (m.group(3) and 'float')
    return f'{m.group(1)}<{arg}>' if arg else m.group(1)


def cuda_ms(fn, iters):
    '''Mean device time of fn() over ``iters`` launches (after warmup).'''
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters, hold_cycles=10_000_000):
    '''Device time of one fn() call (after warmup), without the host's time
    between launches, which sets cuda_ms for calls shorter than their Python
    wrapper: a spin kernel holds the stream while the host queues ``iters``
    calls behind CUDA events, so they then run back to back. If the hold
    ended before the host had queued them all, it doubles and retries. A
    stream's launch queue holds ~1000 launches; past that the host blocks
    until the card drains it, so ``iters`` times the launches of fn() must
    stay below.'''
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(hold_cycles)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    held = not start.query()          # the stream still waits on the spin
    torch.cuda.synchronize()
    if not held:
        check(hold_cycles < 10 ** 10, 'the host never got ahead of the card')
        return device_ms(fn, iters, 2 * hold_cycles)
    return start.elapsed_time(stop) / iters


def alternating_ms(fns: dict, iters: int, timer=cuda_ms) -> dict:
    '''{name: mean of timer} over two rounds, in turns a, b, b, a.'''
    names = list(fns)
    t = {n: [] for n in names}
    for n in names + names[::-1]:
        t[n].append(timer(fns[n], iters))
    return {n: statistics.mean(v) for n, v in t.items()}


def timed(fns: dict, iters: int) -> dict:
    '''{name: {'device': device ms per call, 'launched': ms per call when
    launched back to back (CUDA events)}}, each in alternating turns.'''
    dev, ev = (alternating_ms(fns, iters, timer)
               for timer in (device_ms, cuda_ms))
    return {n: {'device': dev[n], 'launched': ev[n]} for n in fns}


def attention_inputs(case, dtype, dev, seed, lengths=None):
    '''q, k, v, the boolean mask and the query rows with no valid key.
    ``lengths``: the valid keys of each batch row; random by default, with
    every key of the last row masked.'''
    _, b, h, sq, sk, d, causal = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=dev).to(dtype)
               for s in (sq, sk, sk))
    if lengths is None:
        lengths = torch.randint(1, sk + 1, (b,), generator=g, device=dev)
        lengths[-1] = 0                               # every key masked
    valid = torch.arange(sk, device=dev)[None, :] < lengths[:, None]
    mask = valid[:, None, None, :]
    if causal:
        mask = mask & torch.ones(sq, sk, dtype=torch.bool, device=dev).tril()
    # a query row with no valid key must come out NaN in both versions
    empty = ~mask.expand(b, 1, sq, sk).any(-1)        # (b, 1, sq)
    return q, k, v, mask, empty


def within(got, want, atol, rtol):
    '''(max abs error, all within atol + rtol |want|), NaN-free inputs.'''
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return diff.max().item(), ok


def phase_kernel(dev):
    max_err, worst = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(CASES):
            q, k, v, mask, empty = attention_inputs(case, dtype, dev, i)
            out = flash_attention(q, k, v, mask)
            key_mask, causal = key_mask_and_causal(mask, q.shape[0],
                                                   k.shape[2], dev)
            ref = flash_attention_reference(q, k, v, key_mask, causal)
            torch.cuda.synchronize()
            out, ref = out.float(), ref.float()
            nan_o, nan_r = out.isnan(), ref.isnan()
            want = empty[..., None].expand_as(out)    # broadcast over H, d
            check(torch.equal(nan_o, nan_r) and torch.equal(nan_o, want),
                  f'{case[0]} {dtype}: NaN pattern differs')
            atol, rtol = TOL[dtype]
            err, ok = within(out.nan_to_num(0.0), ref.nan_to_num(0.0), atol,
                             rtol)
            print(f'  {case[0]:24s} {str(dtype):15s} B={case[1]} H={case[2]} '
                  f'Sq={case[3]} Sk={case[4]} d={case[5]} causal={case[6]}: '
                  f'max_abs_err {err:.3e} (atol {atol:.0e} rtol {rtol:.0e}), '
                  f'NaN rows {int(empty.sum())} equal -> '
                  f'{"ok" if ok else "FAIL"}')
            check(ok, f'{case[0]} {dtype}: error {err} beyond tolerance')
            max_err = max(max_err, err)
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    return max_err, worst


def check_kernels(case, dtype, dev, seed, dout_seed, lengths=None,
                  backward=True, bitwise_dq=False):
    '''The lse forward and, with ``backward``, dQ and dK/dV against their
    plain versions at ``case``; the plain backward gets the kernel's lse and
    D (the same inputs). A batch row with every key masked has lse -inf and
    exactly zero gradients in both. Returns {kernel: max abs error}.'''
    q, k, v, mask, empty = attention_inputs(case, dtype, dev, seed, lengths)
    km, causal = key_mask_and_causal(mask, q.shape[0], k.shape[2], dev)
    out, lse = flash_attention_forward(q, k, v, km, causal, with_lse=True)
    ref_out, ref_lse = flash_attention_lse_reference(q, k, v, km, causal)
    torch.cuda.synchronize()
    check(torch.equal(out.isnan(), ref_out.isnan()),
          f'{case[0]} {dtype}: forward NaN pattern differs')
    check(torch.equal(lse.isneginf(), ref_lse.isneginf())
          and torch.equal(lse.isneginf(), empty.expand_as(lse)),
          f'{case[0]} {dtype}: lse -inf pattern differs')
    e_out, ok_out = within(out.nan_to_num(0.0), ref_out.nan_to_num(0.0),
                           *TOL[dtype])
    e_lse, ok_lse = within(lse.nan_to_num(neginf=0.0),
                           ref_lse.nan_to_num(neginf=0.0), *LSE_TOL)
    line = [f'  {case[0]:24s} {str(dtype):15s} B={case[1]} Sq={case[3]} '
            f'Sk={case[4]} causal={case[6]}: out {e_out:.2e} lse {e_lse:.2e}']
    oks = [ok_out, ok_lse]
    err = {KERNEL: e_out}
    if backward:
        g = torch.Generator(device=dev).manual_seed(dout_seed)
        dout = torch.randn(q.shape, generator=g, device=dev).to(dtype)
        drow = row_dot(out, dout)
        dq = flash_attention_bwd_dq(q, k, v, km, causal, lse, drow, dout)
        dk, dv = flash_attention_bwd_dkv(q, k, v, km, causal, lse, drow,
                                         dout)
        ref_dq = flash_attention_bwd_dq_reference(q, k, v, km, causal, lse,
                                                  drow, dout)
        ref_dk, ref_dv = flash_attention_bwd_dkv_reference(
            q, k, v, km, causal, lse, drow, dout)
        torch.cuda.synchronize()
        if bitwise_dq:
            again = flash_attention_bwd_dq(q, k, v, km, causal, lse, drow,
                                           dout)
            check(torch.equal(dq, again), f'{case[0]} {dtype}: dQ differs '
                  f'between two launches on the same inputs')
            line.append('dq bitwise equal in 2 launches')
        empty_row = bool(empty[-1].all())
        for name, got, want in (('dq', dq, ref_dq), ('dk', dk, ref_dk),
                                ('dv', dv, ref_dv)):
            check(not got.isnan().any() and not want.isnan().any(),
                  f'{case[0]} {dtype}: NaN in {name}')
            check(not empty_row or bool((got[-1] == 0).all()
                                        and (want[-1] == 0).all()),
                  f'{case[0]} {dtype}: {name} of the empty batch row is '
                  f'not 0')
            e, ok = within(got, want, *BWD_TOL[dtype])
            oks.append(ok)
            line.append(f'{name} {e:.2e}')
            which = KERNEL_DQ if name == 'dq' else KERNEL_DKV
            err[which] = max(err.get(which, 0.0), e)
        if empty_row:
            line.append('(empty-row grads 0)')
    print(', '.join(line) + f' -> {"ok" if all(oks) else "FAIL"}')
    check(all(oks), f'{case[0]} {dtype}: error beyond tolerance')
    return err


def phase_train_kernels(dev):
    '''The lse forward, dQ and dK/dV against their plain versions at the
    train shapes.'''
    err = {KERNEL: 0.0, KERNEL_DQ: 0.0, KERNEL_DKV: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(TRAIN_CASES):
            e = check_kernels(case, dtype, dev, 100 + i, 200 + i,
                              bitwise_dq=dtype == torch.bfloat16 and i == 0)
            err = {n: max(err[n], e[n]) for n in err}
    return err


def features(g, b, sv, sa, dims, dev, dtype=torch.float32):
    '''Random feature stacks (b, s, d) for the model's input widths.'''
    shapes = {'rgb': (sv, dims.d_vid), 'flow': (sv, dims.d_vid),
              'audio': (sa, dims.d_aud)}
    return {key: torch.randn(b, *shape, generator=g, device=dev).to(dtype)
            for key, shape in shapes.items()}


def crop(g, sv, sa, dims, dev):
    '''One request: ragged (s, d) numpy arrays, as a client sends them.'''
    return {key: x[0].cpu().numpy()
            for key, x in features(g, 1, sv, sa, dims, dev).items()}


def train_batch(seed, b, sv, sa, sc, dims):
    '''A host batch (numpy) with padded feature tails and ragged captions,
    as CaptioningDataset makes them.'''
    rng = np.random.default_rng(seed)
    src = {'rgb': rng.normal(size=(b, sv, dims.d_vid)).astype(np.float32),
           'flow': rng.normal(size=(b, sv, dims.d_vid)).astype(np.float32),
           'audio': rng.normal(size=(b, sa, dims.d_aud)).astype(np.float32)}
    caption = np.full((b, sc), PAD, np.int32)
    for r in range(b):
        nv, na = rng.integers(sv // 2, sv + 1), rng.integers(sa // 2, sa + 1)
        src['rgb'][r, nv:] = PAD
        src['flow'][r, nv:] = 0.0
        src['audio'][r, na:] = PAD
        n = rng.integers(4, sc + 1)
        caption[r, :n] = rng.integers(4, dims.voc_size, size=n)
        caption[r, 0], caption[r, n - 1] = START, END
    return {'src': src, 'caption': caption}


class InMemoryDataset:
    '''What train_epoch_cap reads of CaptioningDataset: ``batch_size`` and
    ``batches(epoch, seed, shuffle)`` yielding src, caption and video_ids;
    the last batch is short.'''

    def __init__(self, n_rows, batch_size, sv, sa, sc, dims):
        self.batch_size = batch_size
        self.data = train_batch(7, n_rows, sv, sa, sc, dims)

    def batches(self, epoch=0, shuffle=True, seed=0, **_):
        order = np.arange(len(self.data['caption']))
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(order)
        for i in range(0, len(order), self.batch_size):
            idx = order[i:i + self.batch_size]
            yield {'src': {k: x[idx] for k, x in self.data['src'].items()},
                   'caption': self.data['caption'][idx],
                   'video_ids': [f'v{j}' for j in idx]}


def trainer(dims, dev, impl, compute_dtype=torch.float32, seed=0,
            cfg=TRAIN_CFG):
    '''A flagship model made from ``seed`` on the card, its Adam optimizer
    and train step.'''
    model = BiModalTransformer(
        dims, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed))
    state = init_train_state(model, build_optimizer(cfg, model))
    step = make_cap_train_step(dims, SMOOTHING, PAD, impl,
                               compute_dtype=compute_dtype)
    return state, step


def trajectory_logprob_err(model, x, steps=STEPS):
    '''Max abs difference of the step log-probs through 'kernel' and
    'torch' along the plain path's greedy trajectory of the batch ``x``
    (no end token, so every step runs): where two paths' tokens part at a
    near-tie, their log-probs still agree.'''
    traj = greedy_decode_bimodal(model, x, steps, START, -1, PAD, 'torch')
    lp_err = 0.0
    with torch.inference_mode():
        runs = {impl: bimodal_step_setup(model, x, PAD, steps, impl)
                for impl in ('kernel', 'torch')}
        for step in range(steps):
            cur = traj[:, step:step + 1]
            lps = []
            for impl, (state, step_fn, _) in runs.items():
                lp, _ = step_fn(state, cur, step)
                lps.append(lp)
            check(torch.isfinite(lps[0]).all(), 'non-finite log-probs')
            lp_err = max(lp_err, (lps[0] - lps[1]).abs().max().item())
    return lp_err


def phase_train_parity(dev):
    dims = CapModelDims(voc_size=VOC, dout_p=0.0)
    runs = {}
    for impl in ('kernel', 'torch'):
        state, step = trainer(dims, dev, impl, cfg=PARITY_CFG)
        metrics = []
        for i in range(2):
            state, m = step(state, train_batch(20 + i, 4, SV, SA, TSC, dims))
            metrics.append({k: v.item() for k, v in m.items()})
            if i == 0:
                grads = [p.grad.clone() for p in state.model.parameters()]
        runs[impl] = (metrics, grads, list(state.model.parameters()))
    (mk, gk, pk), (mt, gt, pt) = runs['kernel'], runs['torch']
    errs = {'loss': max(abs(a['loss'] / b['loss'] - 1)
                        for a, b in zip(mk, mt)),
            'grad_norm': max(abs(a['grad_norm'] / b['grad_norm'] - 1)
                             for a, b in zip(mk, mt)),
            'grad': (sum((a - b).square().sum() for a, b in zip(gk, gt))
                     / sum(b.square().sum() for b in gt)).sqrt().item(),
            'param': max((a - b).abs().max().item() for a, b in zip(pk, pt))}
    print(f'    losses kernel {[m["loss"] for m in mk]} torch '
          f'{[m["loss"] for m in mt]}; grad_norm kernel '
          f'{[m["grad_norm"] for m in mk]} torch '
          f'{[m["grad_norm"] for m in mt]}')
    print(f'    errors {errs} (tolerances {STEP_TOL})')
    for key, e in errs.items():
        check(e <= STEP_TOL[key], f'train-step parity: {key} error {e}')


def step_ms(state, step, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, m


def phase_train_timing(dev, smi):
    dims = CapModelDims(voc_size=VOC)                 # dropout 0.1
    batch = train_batch(30, TB, SV, SA, TSC, dims)
    paths = {impl: trainer(dims, dev, impl, torch.bfloat16)
             for impl in ('torch', 'kernel')}
    for impl, (state, step) in paths.items():        # warm-up
        step_ms(state, step, batch)
    times = {'torch': [], 'kernel': []}
    for impl in ('torch', 'kernel', 'kernel', 'torch') * TRAIN_ROUNDS:
        state, step = paths[impl]
        reset_launch_counts()
        ms, m = step_ms(state, step, batch)
        counts = launch_counts()
        times[impl].append(ms)
        check(torch.isfinite(m['loss']).item(), f'{impl}: loss not finite')
        want = CALLS_PER_STEP if impl == 'kernel' else 0
        check(all(n == want for n in counts.values()),
              f'{impl} step launched {counts}, {want} of each expected')
    med = {impl: statistics.median(t) for impl, t in times.items()}
    print(f'    ms per step (median of {2 * TRAIN_ROUNDS}; {smi}): kernel '
          f'{med["kernel"]:.2f} '
          f'{[round(t, 2) for t in times["kernel"]]}, torch '
          f'{med["torch"]:.2f} {[round(t, 2) for t in times["torch"]]}; '
          f'launches per kernel step {CALLS_PER_STEP} of each kernel')

    state, step = paths['kernel']
    losses = []
    for _ in range(10):
        state, m = step(state, batch)
        losses.append(m['loss'].item())
    print(f'    10 more steps on the same batch (kernel): loss '
          f'{[round(x, 4) for x in losses]}')
    # dropout makes single steps noisy: compare the first and last three
    check(sum(losses[-3:]) < sum(losses[:3]), 'the loss does not fall')

    for impl, (state, step) in paths.items():
        busy, n, top, attn = device_busy(lambda: step(state, batch))
        share = 'not measured' if busy is None else (
            f'{busy:.2f} ms of the median {med[impl]:.2f} ms step '
            f'({busy / med[impl]:.1%})')
        print(f'    {impl}: device busy {share} in {n} kernels and copies; '
              f'top (ms): {top}; attention kernels (ms): {attn}')

    # the three kernels against their plain versions and the library at
    # the step's seven attention shapes; the first (encoder 256x256) goes
    # into the report. The library's backward computes dQ, dK and dV
    # together: it compares with the sum of the two backward kernels
    ms = {}
    print(f'    device ms per call (bf16, B={TB}, H=4, d=256; {smi}):')
    for case in TRAIN_CASES[:7]:
        t = kernel_times(case, dev)
        ms = ms or t
        pair = t[KERNEL_DQ]['kernel'] + t[KERNEL_DKV]['kernel']
        print(f'    {case[0]:24s} Sq={case[3]:3d} Sk={case[4]:3d}: '
              + '; '.join(times_line(n, v) for n, v in t.items())
              + f'; dQ + dK/dV {pair:.4f} vs library backward '
              f'{t[KERNEL_DQ]["library"]:.4f}')
    # fp32 at the encoder's 256x256 call: the forward on tensor cores
    # (3xTF32), dQ and dK/dV on fp32 FMA (no main path launches the fp32
    # backward: training computes in bf16)
    case = TRAIN_CASES[0]
    t = kernel_times(case, dev, dtype=torch.float32)
    pair = t[KERNEL_DQ]['kernel'] + t[KERNEL_DKV]['kernel']
    print(f'    fp32, {case[0]} B={TB} Sq={case[3]} Sk={case[4]} (library '
          f'backward: autograd.grad through fp32 '
          f'scaled_dot_product_attention): '
          + '; '.join(times_line(n, v) for n, v in t.items())
          + f'; dQ + dK/dV {pair:.4f} vs library backward '
          f'{t[KERNEL_DQ]["library"]:.4f}')
    return med, ms


def kernel_times(case, dev, lengths=None, dtype=torch.bfloat16):
    '''{kernel: {'kernel', 'plain', 'library', 'bound', 'bound_by'} ms}
    of the lse forward, dQ and dK/dV at ``case`` in ``dtype``, timed in
    turns with their plain versions and the library yardsticks: one
    scaled_dot_product_attention call for the forward, one autograd.grad
    through it (dQ, dK and dV together) for the backward pair.'''
    _, b, h, sq, sk, d, causal = case
    q, k, v, mask, _ = attention_inputs(case, dtype, dev, 1, lengths)
    g = torch.Generator(device=dev).manual_seed(2)
    dout = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    km, causal = key_mask_and_causal(mask, q.shape[0], k.shape[2], dev)
    out, lse = flash_attention_forward(q, k, v, km, causal, with_lse=True)
    drow = row_dot(out, dout)
    args = (q, k, v, km, causal, lse, drow, dout)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    t = timed({
        'fwd plain': lambda: flash_attention_lse_reference(*args[:5]),
        'fwd kernel': lambda: flash_attention_forward(*args[:5],
                                                      with_lse=True),
        'fwd library': lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask),
        'dq plain': lambda: flash_attention_bwd_dq_reference(*args),
        'dq kernel': lambda: flash_attention_bwd_dq(*args),
        'dkv plain': lambda: flash_attention_bwd_dkv_reference(*args),
        'dkv kernel': lambda: flash_attention_bwd_dkv(*args),
        'bwd library': lambda: torch.autograd.grad(
            lib_out, (qg, kg, vg), dout, retain_graph=True)}, 10)
    res = {}
    for kname, key, lib in ((KERNEL, 'fwd', 'fwd library'),
                            (KERNEL_DQ, 'dq', 'bwd library'),
                            (KERNEL_DKV, 'dkv', 'bwd library')):
        name = str(dtype).removeprefix('torch.')
        bound, by = attention_bound_ms(
            *attention_cost(kname, b, h, sq, sk, d, name, causal), name)
        res[kname] = {'kernel': t[f'{key} kernel']['device'],
                      'plain': t[f'{key} plain']['device'],
                      'library': t[lib]['device'],
                      'launched': t[f'{key} kernel']['launched'],
                      'bound': bound, 'bound_by': by}
    return res


def forward_times(case, dev, seed, lengths=None, dtype=torch.bfloat16):
    '''The serving forward (no lse) at ``case`` in ``dtype``: device ms of
    the kernel, its plain version and scaled_dot_product_attention in
    turns, the kernel's time launched back to back, and its bound.'''
    q, k, v, mask, _ = attention_inputs(case, dtype, dev, seed, lengths)
    km, causal = key_mask_and_causal(mask, q.shape[0], k.shape[2], dev)
    both = timed({
        'plain': lambda: flash_attention_reference(q, k, v, km, causal),
        'kernel': lambda: flash_attention(q, k, v, mask),
        'library': lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask)}, 20)
    t = {n: v['device'] for n, v in both.items()}
    t['launched'] = both['kernel']['launched']
    name = str(dtype).removeprefix('torch.')
    t['bound'], t['bound_by'] = attention_bound_ms(*attention_cost(
        KERNEL, *case[1:6], name, case[6], with_lse=False), name)
    return t


def times_line(name, t):
    '''One kernel's device time beside its plain version's, the library
    call's and its bound, its share of the bound, and its time per call
    when launched back to back through its wrapper.'''
    return (f'{name} {t["kernel"]:.4f} (plain {t["plain"]:.4f}, library '
            f'{t["library"]:.4f}, bound {t["bound"]:.4f} by {t["bound_by"]}, '
            f'{t["bound"] / t["kernel"]:.1%} of bound; launched '
            f'{t["launched"]:.4f})')


def device_busy(fn, width=40):
    '''(ms of device kernels, their number, the five longest by name, cut
    to ``width`` characters, ms of each attention kernel by name) in one
    call of fn() under torch.profiler.'''
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False)]
    if not kernels:
        return None, 0, 'not measured: the profiler saw no device kernel', {}
    kernels.sort(key=lambda e: -e.self_device_time_total)
    short = {e.key: e.key.replace('void ', '').replace(
        '(anonymous namespace)::', '')[:width] for e in kernels}
    top = {short[e.key]: round(e.self_device_time_total / 1e3, 3)
           for e in kernels[:5]}
    attn = {short[e.key]: round(e.self_device_time_total / 1e3, 3)
            for e in kernels if 'flash_attn' in e.key}
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels), top, attn)


def phase_trainer(dev):
    dims = CapModelDims(voc_size=VOC)
    data = InMemoryDataset(20, 8, 48, 128, 16, dims)
    state, step = trainer(dims, dev, 'kernel', torch.bfloat16, seed=3)
    reset_launch_counts()
    state, mean = train_epoch_cap(step, state, data, epoch=0)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f'    3 batches (8, 8, a tail of 4): {state.step} steps, mean loss '
          f'{mean:.4f}, launches {counts}')
    check(state.step == 3, f'{state.step} steps for 3 batches')
    check(np.isfinite(mean), f'epoch loss {mean}')
    check(all(n == CALLS_PER_STEP * 3 for n in counts.values()),
          f'launches {counts}, {CALLS_PER_STEP * 3} of each expected')
    return counts


# ---------------------------------------------------------------------------
# the proposal generator
# ---------------------------------------------------------------------------

def heads_flops(model, b):
    '''FLOPs of the 20 conv heads' forward at batch b, from the shapes:
    each conv is a product of (b S) rows by (k d_in) x d_out.'''
    return sum(2 * b * S * conv.kernel_size[0] * conv.in_channels
               * conv.out_channels
               for name, S in (('heads_A', PSA), ('heads_V', PSV))
               for head in getattr(model, name) for conv in head.convs)


def prop_key_lengths(b, sk, dev):
    '''Valid keys of each batch row of a proposal batch: videos padded to
    the pad length, most of them shorter (65%: 520 of 800 audio rows, 195
    of 300 video rows; 40%, 90%), one as long; at B > 1 the last row has
    every key masked. At B = 1, one short video.'''
    if b == 1:
        return torch.tensor([int(0.65 * sk)], device=dev)
    fracs = (1.0, 0.65, 0.4, 0.9)
    lengths = torch.tensor([int(sk * fracs[i % 4]) for i in range(b)],
                           device=dev)
    lengths[-1] = 0
    return lengths


def phase_prop_kernels(dev, smi):
    '''The three kernels against their plain versions at the proposal
    shapes (fp32 and bf16; the forward at B = 1 and B = 16, dQ and dK/dV at
    B = 16), then their device times in bf16 beside the plain versions, the
    library calls and the bounds. Returns (max abs error by kernel,
    {case: kernel_times at B = 16}).'''
    err = {KERNEL: 0.0, KERNEL_DQ: 0.0, KERNEL_DKV: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(PROP_CASES):
            for b in (1, PB):
                c = (case[0], b) + case[2:]
                e = check_kernels(c, dtype, dev, 300 + i, 400 + i,
                                  prop_key_lengths(b, case[4], dev),
                                  backward=b > 1)
                err = {n: max(err[n], e.get(n, 0.0)) for n in err}
    train = {}
    print(f'    device ms per call (bf16, H=4, d=256; {smi}):')
    for i, case in enumerate(PROP_CASES):
        lengths = prop_key_lengths(PB, case[4], dev)
        t = train[case[0]] = kernel_times(case, dev, lengths)
        pair = t[KERNEL_DQ]['kernel'] + t[KERNEL_DKV]['kernel']
        print(f'    B={PB} {case[0]:24s} Sq={case[3]:3d} Sk={case[4]:3d}: '
              + '; '.join(times_line(n, v) for n, v in t.items())
              + f'; dQ + dK/dV {pair:.4f} vs library backward '
              f'{t[KERNEL_DQ]["library"]:.4f}')
        c = (case[0], 1) + case[2:]
        t = forward_times(c, dev, 500 + i, prop_key_lengths(1, case[4], dev))
        print(f'    B=1  {case[0]:24s} Sq={case[3]:3d} Sk={case[4]:3d}: '
              + times_line('forward (no lse)', t))
    return err, train


def proposal_model(dims, dev, seed):
    '''A proposal generator made from ``seed`` on the card, with bench.py's
    anchors.'''
    model = MultimodalProposalGenerator(
        dims, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed))
    model.set_anchors(*ANCHORS)
    return model


def phase_dense_captioning(dev, engine, smi):
    '''A flagship proposal generator round-tripped through the JAX-layout
    npz, then two videos through VideoPipeline (bf16) and the phase-5
    engine. Returns (the fp32 model, {video: (features, seconds)}, the
    launches of the two predictions).'''
    prop = proposal_model(PropModelDims(), dev, seed=4).eval()
    n_params = sum(p.numel() for p in prop.parameters())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'best_prop_model.params.npz')
        save_params_npz(path, to_jax_tree(prop))
        size = os.path.getsize(path)
        loaded = MultimodalProposalGenerator(PropModelDims(), device=dev)
        load_jax_params(loaded, load_params_npz(path))
    for (pname, a), b in zip(prop.named_parameters(), loaded.parameters()):
        check(torch.equal(a, b), f'npz round trip changed {pname}')
    del loaded
    print(f'    flagship proposal generator: {n_params} parameters; npz round '
          f'trip ({size} bytes) gives equal parameters')
    pipeline = VideoPipeline(engine, prop, PROP_PAD, MAX_PROPS,
                             compute_dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(5)
    videos = {name: (crop(g, sv, sa, engine.dims, dev), seconds)
              for name, sv, sa, seconds in PROP_VIDEOS}
    path_launches = dict.fromkeys(launch_counts(), 0)
    for name, (feats, seconds) in videos.items():
        batches = engine.stats()['batches']
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        segments = pipeline.predict(feats, seconds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = launch_counts()
        path_launches = {n: path_launches[n] + delta[n] for n in delta}
        n_batches = engine.stats()['batches'] - batches
        check(0 < len(segments) <= MAX_PROPS,
              f'{name}: {len(segments)} segments')
        check(all(0.0 <= r['start'] < r['end'] <= seconds for r in segments),
              f'{name}: a segment outside [0, {seconds}]')
        check(all(isinstance(r['sentence'], str) for r in segments),
              f'{name}: a sentence is not a string')
        check(delta[KERNEL] == PROP_CALLS + 8 * n_batches
              and delta[KERNEL_DQ] == delta[KERNEL_DKV] == 0,
              f'{name}: launches {delta} for one proposal forward and '
              f'{n_batches} caption batches (8 forward launches each)')
        src, masks = pipeline.inputs(feats)
        with torch.inference_mode():          # ~650 launches a forward
            fwd_ms = device_ms(lambda: pipeline.prop_model(
                src, None, masks, 'kernel'), 1)
        print(f'    {name} video ({feats["rgb"].shape[0]} video rows, '
              f'{feats["audio"].shape[0]} audio rows, {seconds} s): '
              f'{len(segments)} segments in {n_batches} caption batches, '
              f'{wall:.3f} s end to end; proposal forward {fwd_ms:.3f} device '
              f'ms ({smi}); forward launches {delta[KERNEL]} '
              f'({PROP_CALLS} proposal + 8 x {n_batches} caption)')
        for r in segments[:3]:
            print(f'      {r["start"]:7.1f} {r["end"]:7.1f} '
                  f'{r["sentence"][:70]!r}')
    # the 20 conv heads alone, on inputs of the encoder's output shapes:
    # their share of the proposal forward
    served = pipeline.prop_model
    heads = [(getattr(served, name),
              torch.randn(1, S, width, generator=g, device=dev,
                          dtype=torch.bfloat16))
             for name, S, width in (('heads_A', PSA, served.dims.d_model_A),
                                    ('heads_V', PSV, served.dims.d_model_V))]
    with torch.inference_mode():
        heads_ms = device_ms(
            lambda: [head(x) for hs, x in heads for head in hs], 1)
    flops = heads_flops(served, 1)
    print(f'    the 20 conv heads of one proposal forward: {heads_ms:.3f} '
          f'device ms, {flops / 1e12:.3f} TFLOP, '
          f'{flops / heads_ms / 1e9:.1f} TFLOP/s ({smi})')
    return prop, videos, path_launches


def top_segments(raw, seconds, k):
    '''(indices of the top-k predictions, corner-form predictions) of one
    video's raw (N, 3) predictions, by VideoPipeline's post-processing
    (corner, trim, drop short, stable top-k), kept as indices.'''
    seg = trim_proposals(get_corner_coords(raw[None]), [seconds])[0]
    keep = np.flatnonzero(seg[:, 1] - seg[:, 0] > SHORTEST_SEGMENT)
    order = keep[np.argsort(-seg[keep, 2], kind='stable')][:k]
    chain = select_topk_predictions(
        remove_very_short_segments(seg[None], SHORTEST_SEGMENT), k)[0]
    check(np.array_equal(seg[order], chain),
          'top_segments differs from the pipeline\'s post-processing')
    return order, seg


def phase_prop_parity(engine, prop, videos):
    '''fp32: raw predictions through 'kernel' and 'torch' within PROP_TOL,
    and the same top-100 segments. Allowed difference: a boundary tie, an
    index in one top-100 and not the other whose confidence lies within
    PROP_TOL of the 100th confidence in both runs (or whose length lies
    within PROP_TOL of the 0.2 s cut).'''
    pipes = {impl: VideoPipeline(engine, prop, PROP_PAD, MAX_PROPS,
                                 attention_impl=impl)
             for impl in ('kernel', 'torch')}
    for name, (feats, seconds) in videos.items():
        same_top(name, {impl: p.proposals(feats)[0]
                        for impl, p in pipes.items()}, seconds)


def same_top(name, raw, seconds):
    '''Check one video's raw (N, 3) predictions through 'kernel' and
    'torch' (``raw``) within PROP_TOL and their top-MAX_PROPS up to a
    boundary tie (phase_prop_parity); returns each path's top indices in
    confidence order.'''
    atol, rtol = PROP_TOL
    err, ok = within(torch.from_numpy(raw['kernel']),
                     torch.from_numpy(raw['torch']), atol, rtol)
    check(bool(np.isfinite(raw['kernel']).all()),
          f'{name}: non-finite predictions')
    top = {impl: top_segments(r, seconds, MAX_PROPS)
           for impl, r in raw.items()}
    (ik, sk), (it, st) = top['kernel'], top['torch']
    cut = {'kernel': sk[ik[-1], 2], 'torch': st[it[-1], 2]}

    def near(a, b):
        return abs(a - b) <= atol + rtol * abs(b)
    ties = sorted(set(ik) ^ set(it))
    allowed = all(
        (near(sk[i, 2], cut['kernel']) and near(st[i, 2], cut['torch']))
        or near(sk[i, 1] - sk[i, 0], SHORTEST_SEGMENT)
        for i in ties)
    print(f'    {name}: {raw["kernel"].shape[0]} predictions, max_abs_err '
          f'{err:.3e} (atol {atol:.0e} rtol {rtol:.0e}); top-{MAX_PROPS}: '
          f'{len(ik)} segments, {len(set(ik) & set(it))} in both, '
          f'{len(ties)} boundary ties'
          f'{"" if allowed else " NOT at the cut"}')
    check(ok, f'{name}: raw predictions differ by {err}')
    check(len(ik) == len(it) and allowed,
          f'{name}: the top-{MAX_PROPS} segments differ beyond a '
          f'boundary tie: {ties}')
    return {'kernel': ik, 'torch': it}


def prop_train_batch(seed, b, sa, sv, e, dims):
    '''A host batch (numpy) as ProposalDataset makes it: every other video
    shorter than the pad (65% of the rows), events in seconds as bench.py's
    proposal cell draws them, the last two events of every third video
    padded.'''
    rng = np.random.default_rng(seed)
    src = {'rgb': rng.normal(size=(b, sv, dims.d_vid)).astype(np.float32),
           'flow': rng.normal(size=(b, sv, dims.d_vid)).astype(np.float32),
           'audio': rng.normal(size=(b, sa, dims.d_aud)).astype(np.float32)}
    for r in range(1, b, 2):
        src['rgb'][r, int(0.65 * sv):] = PAD
        src['flow'][r, int(0.65 * sv):] = 0.0
        src['audio'][r, int(0.65 * sa):] = PAD
    valid = np.ones((b, e), bool)
    valid[::3, -2:] = False
    return {'src': src,
            'centers': rng.uniform(5, 700, (b, e)).astype(np.float32),
            'lengths': rng.uniform(2, 60, (b, e)).astype(np.float32),
            'valid': valid}


class InMemoryPropDataset:
    '''What train_epoch_prop reads of ProposalDataset: ``batch_size`` and
    ``batches(epoch, seed, shuffle)`` yielding src, the events and
    video_ids; the last batch is short.'''

    def __init__(self, n_rows, batch_size, dims):
        self.batch_size = batch_size
        self.data = prop_train_batch(8, n_rows, PSA, PSV, PE, dims)

    def batches(self, epoch=0, shuffle=True, seed=0, **_):
        order = np.arange(len(self.data['valid']))
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(order)
        for i in range(0, len(order), self.batch_size):
            idx = order[i:i + self.batch_size]
            yield {'src': {k: x[idx] for k, x in self.data['src'].items()},
                   **{k: self.data[k][idx]
                      for k in ('centers', 'lengths', 'valid')},
                   'video_ids': [f'v{j}' for j in idx]}


def prop_trainer(dims, dev, impl, compute_dtype=torch.float32, seed=0,
                 cfg=TRAIN_CFG, freeze_encoder=False):
    '''A proposal generator made from ``seed`` on the card, its Adam
    optimizer (the anchors frozen, and the encoder with
    ``freeze_encoder``) and train step.'''
    model = proposal_model(dims, dev, seed)
    state = init_train_state(model, build_optimizer(
        cfg, model, frozen=prop_frozen(freeze_encoder)))
    step = make_prop_train_step(dims, PAD, impl, compute_dtype=compute_dtype)
    return state, step


def relu_sign_hooks(model, signs):
    '''Forward hooks that append, for every conv of the heads whose output
    goes to a ReLU (all but each head's last; dropout off), (its part, as
    grad_error_by_part names it, and where that output is > 0).'''
    def hook(part):
        def record(module, inputs, out):
            signs.append((part, out.detach() > 0))
        return record
    return [conv.register_forward_hook(hook(f'{name}.convs.{i}'))
            for name in ('heads_A', 'heads_V') for head in getattr(model, name)
            for i, conv in enumerate(head.convs[:-1])]


def saturated_confidences(model, batch):
    '''(confidences within 1e-4 of 1, all confidences, confidences exactly
    1) of the model's fp32 predictions on ``batch`` (plain attention).'''
    conf = make_prop_inference_step(model.dims, PAD, 'torch')(
        model, batch)[..., 2]
    return ((conf > 1 - 1e-4).sum().item(), conf.numel(),
            (conf == 1).sum().item())


def grad_error_by_part(names, got, want):
    '''{part: (relative L2 error of the part's gradient, its share of the
    whole squared error)}; the parts are the encoder, each other top-level
    leaf, and the heads' convs by position (summed over the 10 heads).'''
    err, ref = {}, {}
    for name, a, b in zip(names, got, want):
        parts = name.split('.')
        part = ('.'.join(parts[:1] + parts[2:4])
                if parts[0] in ('heads_A', 'heads_V') else parts[0])
        err[part] = err.get(part, 0.0) + (a - b).square().sum().item()
        ref[part] = ref.get(part, 0.0) + b.square().sum().item()
    total = sum(err.values())
    return {p: (float(f'{(err[p] / ref[p]) ** 0.5 if ref[p] else 0.0:.3g}'),
                float(f'{err[p] / total if total else 0.0:.3g}'))
            for p in err}


def phase_prop_train_parity(dev):
    '''fp32, flagship width, B=2, dropout off: two Adam steps through
    'kernel' and 'torch' agree in the loss and each loss term, grad_norm,
    the first step's gradient and the parameters; the anchors stay bit for
    bit. Then one step with the encoder frozen (remat on): no backward
    kernel runs, the forward runs once per call, and the encoder and the
    anchors stay bit for bit.'''
    dims = PropModelDims(dout_p=0.0)
    batches = [prop_train_batch(40 + i, 2, PSA, PSV, PE, dims)
               for i in range(2)]
    runs, signs = {}, {}
    for impl in ('kernel', 'torch'):
        state, step = prop_trainer(dims, dev, impl, seed=6, cfg=PARITY_CFG)
        names = [n for n, _ in state.model.named_parameters()]
        anchors = [state.model.anchors_A.clone(),
                   state.model.anchors_V.clone()]
        if impl == 'torch':
            conf = saturated_confidences(state.model, batches[0])
        metrics = []
        for i, batch in enumerate(batches):
            hooks = (relu_sign_hooks(state.model, signs.setdefault(impl, []))
                     if i == 0 else [])
            state, m = step(state, batch)
            for h in hooks:
                h.remove()
            metrics.append({k: v.item() for k, v in m.items()})
            if i == 0:
                grads = [torch.zeros_like(p) if p.grad is None
                         else p.grad.clone()
                         for p in state.model.parameters()]
        check(torch.equal(state.model.anchors_A, anchors[0])
              and torch.equal(state.model.anchors_V, anchors[1]),
              f'{impl}: the anchors moved')
        runs[impl] = (metrics, grads, list(state.model.parameters()))
        del state, step
    (mk, gk, pk), (mt, gt, pt) = runs['kernel'], runs['torch']
    flips = {}
    for (part, a), (_, b) in zip(signs['kernel'], signs['torch']):
        flips[part] = flips.get(part, 0) + (a != b).sum().item()
    n_relu = sum(a.numel() for _, a in signs['kernel'])
    del signs
    by_part = grad_error_by_part(names, gk, gt)
    print(f'    first step, gradient error by part (relative L2 of the part; '
          f'share of the squared error): {by_part}')
    print(f'    the heads\' ReLU inputs on a different side of 0 in the two '
          f'paths, by the conv that feeds them: {flips} of {n_relu}; '
          f'confidence logits of the first batch past 9.2 (sigmoid within '
          f'1e-4 of 1, where 1 - p is read to a relative ulp of 6e-8 / (1 - p) '
          f'or worse): {conf[0]} of {conf[1]}, sigmoid exactly 1 (clamped '
          f'log, gradient 0): {conf[2]}')
    for part, (e, _) in by_part.items():
        check(e <= PROP_STEP_TOL['grad'], f'proposal train-step parity: the '
              f'gradient of {part} differs by {e} (relative L2)')
    terms = [k for k in mk[0] if k != 'grad_norm']
    errs = {'loss': max(abs(a[k] / b[k] - 1) for a, b in zip(mk, mt)
                        for k in terms),
            'grad_norm': max(abs(a['grad_norm'] / b['grad_norm'] - 1)
                             for a, b in zip(mk, mt)),
            'grad': (sum((a - b).square().sum() for a, b in zip(gk, gt))
                     / sum(b.square().sum() for b in gt)).sqrt().item(),
            'param': max((a - b).abs().max().item() for a, b in zip(pk, pt))}
    print(f'    losses kernel {[m["loss"] for m in mk]} torch '
          f'{[m["loss"] for m in mt]}; grad_norm kernel '
          f'{[m["grad_norm"] for m in mk]} torch '
          f'{[m["grad_norm"] for m in mt]}')
    print(f'    errors {errs} over loss and {len(terms) - 1} loss terms '
          f'(tolerances {PROP_STEP_TOL}, the gradient\'s for the whole and '
          f'each part); anchors bit for bit')
    for key, e in errs.items():
        check(e <= PROP_STEP_TOL[key], f'proposal train-step parity: {key} '
              f'error {e}')
    del runs, gk, gt, pk, pt

    state, step = prop_trainer(dataclasses.replace(dims, remat=True), dev,
                               'kernel', seed=6, cfg=PARITY_CFG,
                               freeze_encoder=True)
    model = state.model
    frozen = [p.clone() for p in model.encoder.parameters()] + [
        model.anchors_A.clone(), model.anchors_V.clone()]
    heads = [p.clone() for p in model.heads_A.parameters()]
    reset_launch_counts()
    state, m = step(state, batches[0])
    torch.cuda.synchronize()
    counts = launch_counts()
    now = list(model.encoder.parameters()) + [model.anchors_A,
                                              model.anchors_V]
    check(all(torch.equal(a, b) for a, b in zip(frozen, now)),
          'frozen encoder: an encoder parameter or anchor moved')
    check(any(not torch.equal(a, b)
              for a, b in zip(heads, model.heads_A.parameters())),
          'frozen encoder: the heads did not train')
    check(counts == {KERNEL: PROP_CALLS, KERNEL_DQ: 0, KERNEL_DKV: 0},
          f'frozen encoder: launches {counts}, {PROP_CALLS} forward and no '
          f'backward expected')
    print(f'    frozen encoder (remat on), one step: loss {m["loss"].item():.4f}'
          f', launches {counts}; encoder and anchors bit for bit, heads moved')


def phase_prop_train(dev, smi, kernel_ms):
    '''bf16 at bench.py's proposal cell: ms per step through both paths,
    launches per step, a falling loss, one trace per path, the conv heads'
    device time beside the attention kernels', and train_epoch_prop.
    Returns the epoch's launches.'''
    dims = PropModelDims(remat=True)                  # dropout 0.1
    batch = prop_train_batch(50, PB, PSA, PSV, PE, dims)
    paths = {impl: prop_trainer(dims, dev, impl, torch.bfloat16, seed=7)
             for impl in ('torch', 'kernel')}
    want = {KERNEL: 2 * PROP_CALLS, KERNEL_DQ: PROP_CALLS,
            KERNEL_DKV: PROP_CALLS}                   # remat: forward twice
    for impl, (state, step) in paths.items():        # warm-up
        step_ms(state, step, batch)
    times = {'torch': [], 'kernel': []}
    for impl in ('torch', 'kernel', 'kernel', 'torch') * PROP_ROUNDS:
        state, step = paths[impl]
        reset_launch_counts()
        ms, m = step_ms(state, step, batch)
        counts = launch_counts()
        times[impl].append(ms)
        check(torch.isfinite(m['loss']).item()
              and torch.isfinite(m['grad_norm']).item(),
              f'{impl}: loss or grad_norm not finite')
        check(counts == (want if impl == 'kernel' else dict.fromkeys(want, 0)),
              f'{impl} step launched {counts}')
    med = {impl: statistics.median(t) for impl, t in times.items()}
    print(f'    ms per step (median of {2 * PROP_ROUNDS}; {smi}): kernel '
          f'{med["kernel"]:.2f} {[round(t, 2) for t in times["kernel"]]}, '
          f'torch {med["torch"]:.2f} {[round(t, 2) for t in times["torch"]]}'
          f'; launches per kernel step {want}')

    state, step = paths['kernel']
    losses = []
    for _ in range(10):
        state, m = step(state, batch)
        losses.append(m['loss'].item())
    print(f'    10 more steps on the same batch (kernel): loss '
          f'{[round(x, 3) for x in losses]}')
    check(sum(losses[-3:]) < sum(losses[:3]), 'the loss does not fall')

    # one trace per path, its kernel sums by name beside the traced step's
    # own span (CUDA events around it) and the untraced median. The sum may
    # overrun the span on this step (its cuDNN convs read more than events
    # around the same heads), so no busy share is derived from it
    for impl, (state, step) in paths.items():
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))

        def traced():
            start.record()
            step(state, batch)
            stop.record()
        busy, n, top, attn = device_busy(traced)
        span = start.elapsed_time(stop)
        total = 'not measured' if busy is None else (
            f'{busy:.2f} ms summed over {n} kernels and copies in a traced '
            f'span of {span:.2f} ms (busy share withdrawn: on this step the '
            f'sum may overrun the span); untraced median {med[impl]:.2f} ms')
        print(f'    {impl}: trace {total}; top (ms): {top}; attention kernels '
              f'(ms): {attn}')

    # the 20 heads' forward and backward (bf16 copies, inputs of the
    # encoder's output shapes) beside the attention kernels of one step:
    # each of the 4 shapes runs in 2 layers, with 2 forwards under remat
    model = paths['kernel'][0].model
    g = torch.Generator(device=dev).manual_seed(9)
    heads = [(copy.deepcopy(getattr(model, name)).to(torch.bfloat16),
              torch.randn(PB, S, width, generator=g, device=dev,
                          dtype=torch.bfloat16, requires_grad=True))
             for name, S, width in (('heads_A', PSA, dims.d_model_A),
                                    ('heads_V', PSV, dims.d_model_V))]

    def heads_fwd_bwd():
        total = sum(head(x).float().sum() for hs, x in heads for head in hs)
        total.backward()
    # more launches than a stream's launch queue holds, so device_ms cannot
    # hold them; they keep the card busy throughout (tens of ms of convs),
    # so the CUDA events around one call read device time
    heads_ms = cuda_ms(heads_fwd_bwd, 1)
    # the same with cuDNN choosing each conv's algorithm by timing them
    # (the port keeps torch's default, heuristics): a yardstick only
    torch.backends.cudnn.benchmark = True
    try:
        tuned_ms = cuda_ms(heads_fwd_bwd, 1)
    finally:
        torch.backends.cudnn.benchmark = False
    attn_ms = sum(2 * (2 * t[KERNEL]['kernel'] + t[KERNEL_DQ]['kernel']
                       + t[KERNEL_DKV]['kernel']) for t in kernel_ms.values())
    # the backward computes the input and the weight gradients, each a
    # product as large as the forward's
    flops = 3 * heads_flops(model, PB)
    print(f'    device ms per step: the 20 conv heads forward and backward '
          f'{heads_ms:.2f} ({flops / 1e12:.2f} TFLOP, '
          f'{flops / heads_ms / 1e9:.1f} TFLOP/s; with cudnn.benchmark '
          f'{tuned_ms:.2f}); the '
          f'attention kernels {attn_ms:.3f} (16 forward, 8 dQ, 8 dK/dV at the '
          f'phase-11 times)')
    del heads

    data = InMemoryPropDataset(20, 8, dims)
    steps = state.step
    reset_launch_counts()
    state, mean = train_epoch_prop(step, state, data, epoch=0)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f'    train_epoch_prop: 20 videos in batches of 8: '
          f'{state.step - steps} steps (the tail of 4 dropped), mean loss '
          f'{mean:.4f}, launches {counts}')
    check(state.step - steps == 2, f'{state.step - steps} steps for 2 full '
          f'batches')
    check(np.isfinite(mean), f'epoch loss {mean}')
    check(counts == {n: 2 * c for n, c in want.items()},
          f'launches {counts}, twice {want} expected')
    return counts


# ---------------------------------------------------------------------------
# the single-video app from checkpoints
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
APP_VIDEO = PROP_VIDEOS[0]              # 300 video and 800 audio rows, 768 s
# the models' configs: build_parser()'s defaults of each procedure
APP_CAP_ARGV = ['--procedure', 'train_cap', '--dont_log']
APP_PROP_ARGV = ['--procedure', 'train_prop', '--dont_log']


def synced(fn):
    '''(fn(), seconds) on the host clock, the card synchronized on both
    sides.'''
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def write_train_csv(path):
    '''A train meta CSV whose captions hold every token of
    data/vocab_ref.json once (but those with a double quote, which the CSV
    reader would take for a quoted field), 12 to a caption, in seeded
    order.'''
    words = [w for w in Vocab.load(os.path.join(
        REPO, 'data', 'vocab_ref.json')).itos[4:] if '"' not in w]
    order = np.random.default_rng(16).permutation(len(words))
    with open(path, 'w') as f:
        f.write('video_id\tcaption\tstart\tend\tduration\tphase\tidx\n')
        for i in range(0, len(order), 12):
            caption = ' '.join(words[j] for j in order[i:i + 12])
            f.write(f'v_{i}\t{caption}\t0.0\t1.0\t2.0\ttrain\t{i}\n')


def app_argv(ckpt, pts, paths, csv, out_json, impl, native, seconds, dev):
    '''single_video_prediction's command line for one run.'''
    return ['--prop_generator_model_path', ckpt if native else pts['prop'],
            '--pretrained_cap_model_path', ckpt if native else pts['cap'],
            '--vggish_features_path', paths['audio'],
            '--rgb_features_path', paths['rgb'],
            '--flow_features_path', paths['flow'],
            '--duration_in_secs', str(seconds),
            '--max_prop_per_vid', str(MAX_PROPS),
            '--train_meta_path', csv, '--output_json', out_json,
            '--attention_impl', impl,
            '--device_id', str(torch.device(dev).index or 0)]


def save_and_load(tmp, csv, vocab, dev, smi):
    '''The phase's two models from a seed, saved as native directories and
    as .pt files, each format loaded back onto the card and held equal.
    Returns (the directory, the .pt paths, the captioner's and the proposal
    generator's dims).'''
    cap_cfg = Config(build_parser().parse_args(APP_CAP_ARGV))
    cap = BiModalTransformer(
        CapModelDims.from_config(cap_cfg, len(vocab)), device=dev,
        generator=torch.Generator(device=dev).manual_seed(16)).eval()
    prop_cfg = Config(build_parser().parse_args(APP_PROP_ARGV))
    pdims = PropModelDims.from_config(prop_cfg)
    prop = proposal_model(pdims, dev, seed=17).eval()
    print(f'    vocabulary rebuilt from a train CSV of data/vocab_ref.json\'s '
          f'tokens: {len(vocab)} tokens; captioner '
          f'{sum(p.numel() for p in cap.parameters())} parameters (d_model '
          f'{cap.dims.d_model}, H={cap.dims.H}, N={cap.dims.N}, d_model_C '
          f'{cap.dims.d_model_C}), proposal generator '
          f'{sum(p.numel() for p in prop.parameters())} (PropModelDims(), the '
          f'flagship: {pdims == PropModelDims()})')

    ckpt = os.path.join(tmp, 'ckpt')
    pts = {'cap': os.path.join(tmp, 'best_cap_model.pt'),
           'prop': os.path.join(tmp, 'best_prop_model.pt')}
    cap_meta = {'config': cap_cfg.to_dict(), 'epoch': 0,
                'vocab_itos': vocab.itos, 'trg_voc_size': len(vocab)}
    prop_meta = {'config': prop_cfg.to_dict(), 'epoch': 0}
    _, native_s = synced(lambda: (
        save_checkpoint(ckpt, cap, cap_meta),
        save_checkpoint(ckpt, prop, prop_meta, name='best_prop_model')))
    _, pt_s = synced(lambda: (
        save_torch_checkpoint(pts['cap'], cap, cap_meta),
        save_torch_prop_checkpoint(pts['prop'], prop, prop_meta)))
    sizes = {'native': sum(os.path.getsize(os.path.join(ckpt, f))
                           for f in os.listdir(ckpt)),
             '.pt': sum(os.path.getsize(p) for p in pts.values())}
    for fmt, cpath, ppath, save_s in (('native', ckpt, ckpt, native_s),
                                      ('.pt', pts['cap'], pts['prop'], pt_s)):
        got, cap_s = synced(lambda: load_cap_checkpoint(cpath, csv,
                                                        device=dev))
        pgot, prop_s = synced(lambda: load_prop_checkpoint(ppath, MAX_PROPS,
                                                           device=dev))
        check(got[3].itos == vocab.itos, f'{fmt}: vocabulary differs')
        for saved, loaded in ((cap, got[2]), (prop, pgot[2])):
            for (pname, a), b in zip(saved.named_parameters(),
                                     loaded.parameters()):
                check(torch.equal(a, b), f'{fmt}: {pname} differs after the '
                      f'save and load')
        del got, pgot
        print(f'    {fmt:6s} checkpoints of both models: {sizes[fmt]} bytes, '
              f'saved in {save_s:.2f} s, loaded onto the card in '
              f'{cap_s + prop_s:.2f} s (captioner {cap_s:.2f}), equal '
              f'parameters ({smi})')
    return ckpt, pts, cap.dims, pdims


def phase_single_video_app(dev, smi):
    '''Checkpoints of both models in both formats, then the app through
    main() three times, the kernel against plain attention, and the fp32
    forward kernel's times (see the module docstring). Returns the
    launches of the native 'kernel' run.'''
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, 'train.csv')
        write_train_csv(csv)
        vocab = build_vocab_from_meta(csv)
        check(vocab.itos[:4] == ['<unk>', '<blank>', '<s>', '</s>'],
              f'specials {vocab.itos[:4]}')
        ckpt, pts, cdims, dims = save_and_load(tmp, csv, vocab, dev, smi)
        torch.cuda.empty_cache()

        _, sv, sa, seconds = APP_VIDEO
        rng = np.random.default_rng(18)
        paths = {}
        for key, shape in (('rgb', (sv, dims.d_vid)),
                           ('flow', (sv, dims.d_vid)),
                           ('audio', (sa, dims.d_aud))):
            paths[key] = os.path.join(tmp, f'video_{key}.npy')
            np.save(paths[key], rng.normal(size=shape).astype(np.float32))

        outs, counts = {}, {}
        for run, impl in (('native', 'kernel'), ('.pt', 'kernel'),
                          ('native', 'torch')):
            out_json = os.path.join(tmp, f'{run}_{impl}.json')
            argv = app_argv(ckpt, pts, paths, csv, out_json, impl,
                            run == 'native', seconds, dev)
            printed = io.StringIO()
            torch.cuda.synchronize()
            reset_launch_counts()
            with contextlib.redirect_stdout(printed):
                returned, wall = synced(lambda: app.main(argv))
            counts[run, impl] = launch_counts()
            with open(out_json) as f:
                outs[run, impl] = json.load(f)
            check(outs[run, impl] == returned
                  and printed.getvalue().strip() == str(returned),
                  f'{run} {impl}: the JSON, the printed and the returned '
                  f'lists differ')
            print(f'    app ({run} checkpoints, {impl}): {len(returned)} '
                  f'segments in {wall:.2f} s end to end (loading both '
                  f'checkpoints included; {smi}); launches '
                  f'{counts[run, impl]}')

        kernel, plain = outs['native', 'kernel'], outs['native', 'torch']
        check(outs['.pt', 'kernel'] == kernel,
              'the app gives other output from the .pt checkpoints')
        # times are rounded to 0.1 s
        check(len(kernel) == MAX_PROPS
              and all(0.0 <= r['start'] < r['end'] <= seconds + 0.05
                      and isinstance(r['sentence'], str) for r in kernel),
              'app output: the wrong number of segments, or one outside '
              'the video')
        # 4 encoder attentions a layer, in one proposal forward and one
        # caption batch
        want = {KERNEL: 4 * (dims.N + cdims.N), KERNEL_DQ: 0, KERNEL_DKV: 0}
        for run in ('native', '.pt'):
            check(counts[run, 'kernel'] == want,
                  f'{run} kernel run launched {counts[run, "kernel"]}, '
                  f'{want} expected (one proposal forward, one caption '
                  f'batch)')
        check(counts['native', 'torch'] == dict.fromkeys(want, 0),
              f'the torch run launched {counts["native", "torch"]}')
        print(f'    native == .pt output: identical ({len(kernel)} segments)')
        lengths = app_kernel_vs_plain(ckpt, paths, vocab, seconds, kernel,
                                      plain, dev, smi)

    # the fp32 forward kernel where the app launches it: the B=1 proposal
    # forward (every key valid) and the caption batch (bucket lengths, each
    # row's valid keys as the batch holds them)
    b, sa = lengths['audio'].shape[0], bucket_len(
        int(lengths['audio'].max()), AUDIO_BUCKETS)
    sv = bucket_len(int(lengths['video'].max()), VIDEO_BUCKETS)
    cases = [((c[0], 1) + c[2:], torch.tensor([c[4]], device=dev))
             for c in PROP_CASES]
    cases += [((f'caption {n}', b, 4, sq, sk, 256, False), lengths[keys])
              for n, sq, sk, keys in (('self-attn audio', sa, sa, 'audio'),
                                      ('self-attn video', sv, sv, 'video'),
                                      ('cross audio->video', sa, sv, 'video'),
                                      ('cross video->audio', sv, sa, 'audio'))]
    print(f'    the fp32 forward kernel (3xTF32) at the app\'s shapes (H=4, '
          f'd=256; {smi}):')
    app_ms = {}
    for i, (case, keys) in enumerate(cases):
        t = forward_times(case, dev, 600 + i, keys, torch.float32)
        splits = fp32_key_splits(
            *case[1:5], torch.cuda.get_device_properties(dev)
            .multi_processor_count)
        print(f'    B={case[1]:<3d} {case[0]:28s} Sq={case[3]:3d} '
              f'Sk={case[4]:3d} key splits {splits}: '
              + times_line('fp32 forward', t))
        if i in (0, len(PROP_CASES)):    # B=1 800x800, the batch's audio self
            app_ms[f'B={case[1]} {case[3]}x{case[4]}'] = t
    case, keys = cases[len(PROP_CASES)]
    print(f'    scaled_dot_product_attention, fp32 B={case[1]} {case[3]}x'
          f'{case[4]}, runs (torch.profiler, device ms by kernel over 3 '
          f'calls): {library_kernels(case, keys)}')
    return counts['native', 'kernel'], app_ms


def library_kernels(case, keys):
    '''The device kernels scaled_dot_product_attention runs at ``case`` in
    fp32 with these key lengths, by name with their ms over 3 calls, from a
    torch.profiler session in a child process: after this process's four
    sessions (phases 8 and 15) a fifth saw no device event.'''
    proc = subprocess.run(
        [sys.executable, '-c', 'import sys, chip_smoke; '
         'chip_smoke.print_library_kernels(sys.argv[1], sys.argv[2])',
         json.dumps(case), ','.join(str(int(x)) for x in keys)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f'library profile failed: {proc.stderr}')
    return proc.stdout.strip().splitlines()[-1]


def print_library_kernels(case, keys):
    '''library_kernels' child: one profiler session around 3 calls.'''
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    keys = torch.tensor([int(x) for x in keys.split(',')], device=dev)
    q, k, v, mask, _ = attention_inputs(json.loads(case), torch.float32, dev,
                                        700, keys)
    F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    _, _, top, _ = device_busy(lambda: [F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask) for _ in range(3)], width=160)
    print(top)


def app_kernel_vs_plain(ckpt, paths, vocab, seconds, kernel, plain, dev,
                        smi):
    '''The app's kernel and plain outputs: the raw predictions and the
    top-100 by phase 13's rule, then each common segment's sentence equal
    (or, where a decode step's near-tie parts them, the step log-probs
    within LOGPROB_TOL); the app's compute alone, in turns, and the fp32
    B=1 proposal forward's device time through both paths; the kernel
    path's time by stage. Returns the valid keys of each row of the
    caption batch, {'audio', 'video'}.'''
    cap_cfg, _, cap, _ = load_cap_checkpoint(ckpt, device=dev)
    prop_cfg, _, prop = load_prop_checkpoint(ckpt, MAX_PROPS, device=dev)
    stacks = app.load_features_from_npy(
        paths, None, None, seconds, PAD, get_full_feat=True,
        pad_feats_up_to=prop_cfg.pad_feats_up_to)
    src = {k: torch.from_numpy(x).to(dev) for k, x in stacks.items()}
    masks = make_masks(src, None, 'audio_video', PAD)
    with torch.inference_mode():
        raw = {impl: prop(src, None, masks, impl)[0][0].cpu().numpy()
               for impl in ('kernel', 'torch')}
        fwd_ms = alternating_ms(
            {impl: (lambda impl=impl: prop(src, None, masks, impl))
             for impl in ('kernel', 'torch')}, 1, device_ms)
    top = same_top('app video', raw, seconds)
    rows = {impl: {int(i): r for i, r in zip(top[impl], out)}
            for impl, out in (('kernel', kernel), ('torch', plain))}
    common = sorted(set(rows['kernel']) & set(rows['torch']))
    for i in common:
        a, b = rows['kernel'][i], rows['torch'][i]
        check(abs(a['start'] - b['start']) <= 0.1 + 1e-6
              and abs(a['end'] - b['end']) <= 0.1 + 1e-6,
              f'segment {i}: {a} vs {b}')
    differ = [i for i in common
              if rows['kernel'][i]['sentence'] != rows['torch'][i]['sentence']]
    line = (f'    kernel vs torch: {len(common)} common segments, '
            f'{len(common) - len(differ)} equal sentences')
    if differ:
        segs = app.generate_proposals(prop, paths, PAD, prop_cfg, seconds,
                                      'torch')[0]
        pos = {int(i): n for n, i in enumerate(top['torch'])}
        batch = app.caption_batch(paths, segs[[pos[i] for i in differ]],
                                  seconds, PAD, dev)
        lp_err = trajectory_logprob_err(cap, batch, cap_cfg.max_len)
        line += (f'; the {len(differ)} others: step log-probs along the '
                 f'torch trajectory within {lp_err:.3e} (tol '
                 f'{LOGPROB_TOL:.0e})')
        check(lp_err <= LOGPROB_TOL, f'app captions: log-prob error {lp_err}')
    print(line)

    compute = {'kernel': [], 'torch': []}
    for impl in ('kernel', 'torch', 'torch', 'kernel'):
        def run_app():
            props = app.generate_proposals(prop, paths, PAD, prop_cfg,
                                           seconds, impl)
            return app.caption_proposals(cap, paths, vocab, cap_cfg, props,
                                         seconds, impl)
        got, t = synced(run_app)
        compute[impl].append(t)
        check(got == (kernel if impl == 'kernel' else plain),
              f'{impl}: the app functions give other output than main()')
    # the kernel path by stage: the proposals (features read and padded,
    # the B=1 forward, post-processing), the caption batch (a crop read
    # from the .npy files per proposal, padded, copied to the card), the
    # encoder and the 30 decode steps
    props, t_prop = synced(lambda: app.generate_proposals(
        prop, paths, PAD, prop_cfg, seconds, 'kernel'))
    batch, t_batch = synced(lambda: app.caption_batch(
        paths, props.reshape(-1, 3), seconds, PAD, dev))
    _, t_decode = synced(lambda: greedy_decode_bimodal(
        cap, batch, cap_cfg.max_len, START, END, PAD, 'kernel'))
    print(f'    the app without loading (proposals, then {len(kernel)} '
          f'captions in one batch), s: kernel '
          f'{[round(t, 3) for t in compute["kernel"]]}, torch '
          f'{[round(t, 3) for t in compute["torch"]]}; kernel path by stage: '
          f'proposals {t_prop:.3f}, caption batch from the .npy files '
          f'{t_batch:.3f}, encoder and decode {t_decode:.3f}; the fp32 B=1 '
          f'proposal forward {fwd_ms["kernel"]:.3f} device ms through the '
          f'kernel, {fwd_ms["torch"]:.3f} through plain attention ({smi})')
    return {'audio': (batch['audio'][:, :, 0] != PAD).sum(1),
            'video': (batch['rgb'][:, :, 0] != PAD).sum(1)}


def main():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: no CUDA device; this smoke test runs only on '
                 'the GPU')
    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 parity is fp32
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = device_line()
    print(f'[1] device: {name} | nvidia-smi: {smi} | torch '
          f'{torch.__version__} CUDA {torch.version.cuda}')
    print(smi)                                       # name, power limit

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(load_library, (KERNEL, BWD_LIBRARY)))
    print(f'[2] kernels {sorted(set(SOURCES.values()))} built and loaded in '
          f'{time.perf_counter() - t0:.2f} s; ptxas:')
    for lib, want in ENTRIES.items():
        built = set()
        for line in ptxas_report(lib).splitlines():
            if 'Compiling entry' in line:
                entry = kernel_name(line)
                built.add(entry.split('<')[0])
                print(f'    {entry}:')
            elif 'registers' in line or 'spill' in line:
                print(f'      {line.strip()}')
            if 'spill' in line:
                check(' 0 bytes spill stores, 0 bytes spill loads' in line,
                      f'{lib}: a kernel spills registers: {line.strip()}')
        check(set(want) <= built, f'{lib}: ptxas compiled {sorted(built)}, '
              f'not all of {want}')

    print('[3] forward kernel vs plain PyTorch on the card:')
    max_err, worst = phase_kernel(dev)
    print(f'    max_abs_err by dtype: {worst}')

    print('[4] training kernels vs plain PyTorch on the card:')
    train_err = phase_train_kernels(dev)
    print(f'    max_abs_err by kernel: {train_err}')

    print('[5] serving:')
    dims = CapModelDims(voc_size=VOC)
    model = BiModalTransformer(
        dims, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0)).eval()
    n_params = sum(p.numel() for p in model.parameters())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'best_cap_model.params.npz')
        save_params_npz(path, to_jax_tree(model))
        size = os.path.getsize(path)
        loaded = BiModalTransformer(dims, device=dev).eval()
        load_jax_params(loaded, load_params_npz(path))
    for (pname, a), b in zip(model.named_parameters(), loaded.parameters()):
        check(torch.equal(a, b), f'npz round trip changed {pname}')
    print(f'    flagship model: {n_params} parameters; npz round trip '
          f'({size} bytes) gives equal parameters')
    del loaded
    vocab = Vocab(['<unk>', '<blank>', '<s>', '</s>']
                  + [f'w{i}' for i in range(4, VOC)])
    engine = CaptionEngine(model, vocab, max_len=STEPS,
                           compute_dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(1)
    # two requests: three short crops (bucket Sv=32, Sa=64) and two long
    # ones (bucket Sv=96, Sa=256)
    requests = [[crop(g, sv, sa, dims, dev)
                 for sv, sa in ((20, 50), (28, 60), (9, 30))],
                [crop(g, sv, sa, dims, dev) for sv, sa in ((90, 250),
                                                           (70, 200))]]
    reset_launch_counts()
    t0 = time.perf_counter()
    sentences = [engine.caption_crops(r) for r in requests]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = flash_attention.launches
    stats = engine.stats()
    for batch in sentences:
        for s in batch:
            print(f'    caption: {s[:100]!r}')
    print(f'    {stats} in {serve_s:.3f} s; kernel launches {launches}')
    check(stats['requests'] == 5 and stats['batches'] == 2,
          f'engine stats {stats}')
    check(launches == 8 * stats['batches'],
          f'{launches} kernel launches for {stats["batches"]} batches '
          f'(8 per batch expected)')
    check(all(isinstance(s, str) for b in sentences for s in b),
          'captions are not strings')

    print('[6] serving parity on the card (fp32):')
    toks = {}
    for impl in ('kernel', 'torch'):
        eng = CaptionEngine(model, vocab, max_len=STEPS, attention_impl=impl)
        toks[impl] = [eng.caption_tokens(r) for r in requests]
    same = all((a == b).all() for a, b in zip(toks['kernel'], toks['torch']))
    x = features(g, 4, SV, SA, dims, dev)
    x['rgb'][1, 60:] = PAD
    x['flow'][1, 60:] = 0.0
    x['audio'][1, 150:] = PAD
    lp_err = trajectory_logprob_err(model, x)
    print(f'    engine tokens kernel == torch: {same}; step log-probs along '
          f'the torch trajectory (B=4, {STEPS} steps): max_abs_err '
          f'{lp_err:.3e} (tol {LOGPROB_TOL:.0e})')
    check(lp_err <= LOGPROB_TOL, f'log-prob error {lp_err}')

    print(f'[7] train-step parity on the card (fp32, B=4, Sa={SA}, Sv={SV}, '
          f'Sc={TSC}, dropout off, 2 Adam steps, eps {PARITY_CFG.eps}):')
    phase_train_parity(dev)

    print(f'[8] train step (bf16, B={TB}, Sa={SA}, Sv={SV}, Sc={TSC}, '
          f'dropout 0.1, Adam lr {TRAIN_CFG.lr}, clip 1.0) on {smi}:')
    train_ms, train_kernel_ms = phase_train_timing(dev, smi)

    print('[9] trainer: train_epoch_cap (bf16, kernels):')
    trainer_launches = phase_trainer(dev)

    print(f'[10] serving timings (bf16, B={B}, Sa={SA}, Sv={SV}, {STEPS} '
          f'steps, end_idx=-1) on {smi}:')
    for i, case in enumerate(CASES[:5]):
        print(f'    {case[0]:24s} Sq={case[3]:3d} Sk={case[4]:3d}: '
              + times_line('forward', forward_times(case, dev, i)))
    model16 = engine.model                          # the bf16 copy
    x16 = features(g, B, SV, SA, dims, dev, torch.bfloat16)
    times = {'kernel': [], 'torch': []}
    for impl in ('torch', 'kernel'):
        greedy_decode_bimodal(model16, x16, STEPS, START, -1, PAD, impl)
    for impl in ('torch', 'kernel', 'kernel', 'torch', 'torch', 'kernel'):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = greedy_decode_bimodal(model16, x16, STEPS, START, -1, PAD, impl)
        torch.cuda.synchronize()
        times[impl].append(time.perf_counter() - t0)
        check(out.shape == (B, STEPS + 1), f'decode shape {out.shape}')
    cps = {impl: B / statistics.median(t) for impl, t in times.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = greedy_decode_uncached(
        lambda s, t, m: model16(s, t, m, 'kernel'), x16, STEPS, START, -1,
        PAD)
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0
    check(base.shape == (B, STEPS + 1), f'uncached shape {base.shape}')
    print(f'    decode captions/s: kernel {cps["kernel"]:.1f}, torch '
          f'{cps["torch"]:.1f} (median of 3; batch s kernel '
          f'{[round(t, 4) for t in times["kernel"]]}, torch '
          f'{[round(t, 4) for t in times["torch"]]})')
    print(f'    uncached decoder (once): {base_s:.3f} s = '
          f'{B / base_s:.1f} captions/s; vs_baseline '
          f'{cps["kernel"] / (B / base_s):.2f}x')
    print(f'    train step ms: kernel {train_ms["kernel"]:.2f}, torch '
          f'{train_ms["torch"]:.2f}')
    del model16, x16
    torch.cuda.empty_cache()

    print(f'[11] the kernels at the proposal shapes (B=1 and B={PB}, H=4, '
          f'd=256, Sa={PSA}, Sv={PSV}, padded keys) vs plain PyTorch on the '
          f'card:')
    prop_err, prop_kernel_ms = phase_prop_kernels(dev, smi)
    print(f'    max_abs_err by kernel: {prop_err}')

    print(f'[12] dense captioning (bf16, flagship PropModelDims(), pad '
          f'{PROP_PAD}, max_prop_per_vid {MAX_PROPS}) through VideoPipeline '
          f'and the phase-5 engine:')
    prop, videos, pipeline_launches = phase_dense_captioning(dev, engine, smi)

    print('[13] proposal parity on the card (fp32, kernel vs torch):')
    phase_prop_parity(engine, prop, videos)
    del prop, videos
    torch.cuda.empty_cache()

    print(f'[14] proposal train-step parity on the card (fp32, B=2, '
          f'Sa={PSA}, Sv={PSV}, E={PE}, dropout off, 2 Adam steps, eps '
          f'{PARITY_CFG.eps}):')
    phase_prop_train_parity(dev)
    torch.cuda.empty_cache()

    print(f'[15] proposal train step (bf16, B={PB}, Sa={PSA}, Sv={PSV}, '
          f'E={PE}, remat, dropout 0.1, Adam lr {TRAIN_CFG.lr}, clip 1.0) on '
          f'{smi}:')
    prop_launches = phase_prop_train(dev, smi, prop_kernel_ms)
    torch.cuda.empty_cache()

    print(f'[16] the single-video app from checkpoints (fp32, train_cap and '
          f'train_prop defaults, max_prop_per_vid {MAX_PROPS}) on {smi}:')
    app_launches, app_ms = phase_single_video_app(dev, smi)

    # times at the train cell's encoder 256x256 call (forward with lse), and
    # at the proposal cell's 800x800 call; launches of each main path's run
    # (the captioning trainer's are the report's `launches`)
    at_prop = prop_kernel_ms[PROP_CASES[0][0]]
    paths = {'train_epoch_cap': trainer_launches,
             'video_pipeline': pipeline_launches,
             'train_epoch_prop': prop_launches,
             'single_video_app': app_launches}
    report = [
        (KERNEL, max(max_err, train_err[KERNEL], prop_err[KERNEL]),
         train_kernel_ms[KERNEL]),
        (KERNEL_DQ, max(train_err[KERNEL_DQ], prop_err[KERNEL_DQ]),
         train_kernel_ms[KERNEL_DQ]),
        (KERNEL_DKV, max(train_err[KERNEL_DKV], prop_err[KERNEL_DKV]),
         train_kernel_ms[KERNEL_DKV])]
    print(json.dumps({'kernels': [{
        'name': kname, 'route': 'cuda', 'source': SOURCES[kname],
        'replaces': REPLACES[kname], 'launches': trainer_launches[kname],
        'max_abs_err': err, 'ms': t['kernel'], 'plain_ms': t['plain'],
        'bound_ms': t['bound'], 'bound_by': t['bound_by'],
        'library_ms': t['library'], 'library_call': LIBRARY_CALL[kname],
        'launches_by_path': {p: c[kname] for p, c in paths.items()},
        'proposal_800x800': {
            'ms': at_prop[kname]['kernel'], 'plain_ms': at_prop[kname]['plain'],
            'bound_ms': at_prop[kname]['bound'],
            'bound_by': at_prop[kname]['bound_by'],
            'library_ms': at_prop[kname]['library']},
        **({'fp32_app': {shape: {
            'ms': a['kernel'], 'plain_ms': a['plain'],
            'library_ms': a['library'], 'bound_ms': a['bound'],
            'bound_by': a['bound_by']} for shape, a in app_ms.items()}}
           if kname == KERNEL else {})}
        for kname, err, t in report]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
