#!/usr/bin/env python3
'''Smoke test of the PyTorch port (bmt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA device; it imports
nothing of JAX. Phases, each of which stops the script with a non-zero exit
when it fails:

1. the device: torch's name for it and nvidia-smi's name and power limit;
2. build the CUDA kernels from bmt_tpu_torch/csrc/ (one nvcc per source,
   started together; timed): the forward, dQ and dK/dV, each as an fp32
   FMA kernel and a bf16 tensor-core kernel (flash_attn_fwd_bf16_kernel,
   flash_attn_bwd_dq_bf16_kernel, flash_attn_bwd_dkv_bf16_kernel, each at
   head dims padded to 64 and 256); print what ptxas reports for each and
   fail if one is missing or any kernel spills registers;
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
   events), which the host's launch rate sets for short calls;
9. the trainer: train_epoch_cap over an in-memory dataset of 20 crops in
   batches of 8 (a ragged tail of 4) through the kernels; the launch counts
   of this run are the ones the kernel report gives;
10. serving timings in bf16 at B=64, Sa=256, Sv=96, 30 decode steps: the
    forward kernel's device time beside the plain attention's,
    scaled_dot_product_attention's and its bound at the five encoder and
    decoder shapes, decode captions/s
    through both paths, and the uncached decoder once as the baseline.

The line before the last is the kernel report as JSON; the last line is
{"ok": true, "device": {...}}.
'''
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

from bmt_tpu_torch.decode import greedy_decode_bimodal, greedy_decode_uncached
from bmt_tpu_torch.decode.greedy import bimodal_step_setup
from bmt_tpu_torch.models import BiModalTransformer, CapModelDims
from bmt_tpu_torch.ops._build import load_library, ptxas_report
from bmt_tpu_torch.ops.flash_attention import (
    BWD_LIBRARY, KERNEL, KERNEL_DKV, KERNEL_DQ, attention_bound_ms,
    attention_cost, flash_attention,
    flash_attention_bwd_dkv, flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq, flash_attention_bwd_dq_reference,
    flash_attention_forward, flash_attention_lse_reference,
    flash_attention_reference, key_mask_and_causal, launch_counts,
    reset_launch_counts, row_dot)
from bmt_tpu_torch.params import (load_jax_params, load_params_npz,
                                  save_params_npz, to_jax_tree)
from bmt_tpu_torch.data import Vocab
from bmt_tpu_torch.serve import CaptionEngine
from bmt_tpu_torch.train import (build_optimizer, init_train_state,
                                 make_cap_train_step, train_epoch_cap)

SOURCES = {KERNEL: 'bmt_tpu_torch/csrc/flash_attn_fwd.cu',
           KERNEL_DQ: 'bmt_tpu_torch/csrc/flash_attn_bwd.cu',
           KERNEL_DKV: 'bmt_tpu_torch/csrc/flash_attn_bwd.cu'}
# the kernels each library holds: fp32 FMA and bf16 tensor cores
ENTRIES = {KERNEL: ('flash_attn_fwd_kernel', 'flash_attn_fwd_bf16_kernel'),
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
    ended before the host had queued them all, it doubles and retries.'''
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


def attention_inputs(case, dtype, dev, seed):
    _, b, h, sq, sk, d, causal = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=dev).to(dtype)
               for s in (sq, sk, sk))
    lengths = torch.randint(1, sk + 1, (b,), generator=g, device=dev)
    lengths[-1] = 0                                   # every key masked
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


def phase_train_kernels(dev):
    '''The lse forward, dQ and dK/dV against their plain versions; the
    plain backward gets the kernel's lse and D (the same inputs).'''
    err = {KERNEL: 0.0, KERNEL_DQ: 0.0, KERNEL_DKV: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(TRAIN_CASES):
            q, k, v, mask, empty = attention_inputs(case, dtype, dev, 100 + i)
            g = torch.Generator(device=dev).manual_seed(200 + i)
            dout = torch.randn(q.shape, generator=g, device=dev).to(dtype)
            km, causal = key_mask_and_causal(mask, q.shape[0], k.shape[2],
                                             dev)
            out, lse = flash_attention_forward(q, k, v, km, causal,
                                               with_lse=True)
            drow = row_dot(out, dout)
            dq = flash_attention_bwd_dq(q, k, v, km, causal, lse, drow, dout)
            dk, dv = flash_attention_bwd_dkv(q, k, v, km, causal, lse, drow,
                                             dout)
            ref_out, ref_lse = flash_attention_lse_reference(q, k, v, km,
                                                             causal)
            ref_dq = flash_attention_bwd_dq_reference(q, k, v, km, causal,
                                                      lse, drow, dout)
            ref_dk, ref_dv = flash_attention_bwd_dkv_reference(
                q, k, v, km, causal, lse, drow, dout)
            torch.cuda.synchronize()
            check(torch.equal(out.isnan(), ref_out.isnan()),
                  f'{case[0]} {dtype}: forward NaN pattern differs')
            check(torch.equal(lse.isneginf(), ref_lse.isneginf())
                  and torch.equal(lse.isneginf(), empty.expand_as(lse)),
                  f'{case[0]} {dtype}: lse -inf pattern differs')
            e_out, ok_out = within(out.nan_to_num(0.0),
                                   ref_out.nan_to_num(0.0), *TOL[dtype])
            e_lse, ok_lse = within(lse.nan_to_num(neginf=0.0),
                                   ref_lse.nan_to_num(neginf=0.0), *LSE_TOL)
            line = [f'  {case[0]:24s} {str(dtype):15s} Sq={case[3]} '
                    f'Sk={case[4]} causal={case[6]}: out {e_out:.2e} '
                    f'lse {e_lse:.2e}']
            oks = [ok_out, ok_lse]
            if dtype == torch.bfloat16 and i == 0:     # the 256x256 call
                again = flash_attention_bwd_dq(q, k, v, km, causal, lse,
                                               drow, dout)
                check(torch.equal(dq, again), f'{case[0]} bf16: dQ differs '
                      f'between two launches on the same inputs')
                line.append('dq bitwise equal in 2 launches')
            for name, got, want in (('dq', dq, ref_dq), ('dk', dk, ref_dk),
                                    ('dv', dv, ref_dv)):
                check(not got.isnan().any() and not want.isnan().any(),
                      f'{case[0]} {dtype}: NaN in {name}')
                check(bool((got[-1] == 0).all() and (want[-1] == 0).all()),
                      f'{case[0]} {dtype}: {name} of the empty batch row is '
                      f'not 0')
                e, ok = within(got, want, *BWD_TOL[dtype])
                oks.append(ok)
                line.append(f'{name} {e:.2e}')
                which = KERNEL_DQ if name == 'dq' else KERNEL_DKV
                err[which] = max(err[which], e)
            err[KERNEL] = max(err[KERNEL], e_out)
            print(', '.join(line) + f' (empty-row grads 0) -> '
                  f'{"ok" if all(oks) else "FAIL"}')
            check(all(oks), f'{case[0]} {dtype}: error beyond tolerance')
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
    return med, ms


def kernel_times(case, dev):
    '''{kernel: {'kernel', 'plain', 'library', 'bound', 'bound_by'} ms}
    of the lse forward, dQ and dK/dV at ``case`` in bf16, timed in turns
    with their plain versions and the library yardsticks: one
    scaled_dot_product_attention call for the forward, one autograd.grad
    through it (dQ, dK and dV together) for the backward pair.'''
    _, b, h, sq, sk, d, causal = case
    q, k, v, mask, _ = attention_inputs(case, torch.bfloat16, dev, 1)
    g = torch.Generator(device=dev).manual_seed(2)
    dout = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
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
        bound, by = attention_bound_ms(
            *attention_cost(kname, b, h, sq, sk, d, 'bfloat16', causal),
            'bfloat16')
        res[kname] = {'kernel': t[f'{key} kernel']['device'],
                      'plain': t[f'{key} plain']['device'],
                      'library': t[lib]['device'],
                      'launched': t[f'{key} kernel']['launched'],
                      'bound': bound, 'bound_by': by}
    return res


def times_line(name, t):
    '''One kernel's device time beside its plain version's, the library
    call's and its bound, its share of the bound, and its time per call
    when launched back to back through its wrapper.'''
    return (f'{name} {t["kernel"]:.4f} (plain {t["plain"]:.4f}, library '
            f'{t["library"]:.4f}, bound {t["bound"]:.4f} by {t["bound_by"]}, '
            f'{t["bound"] / t["kernel"]:.1%} of bound; launched '
            f'{t["launched"]:.4f})')


def device_busy(fn):
    '''(ms of device kernels, their number, the five longest by name, ms of
    each attention kernel by name) in one call of fn() under
    torch.profiler.'''
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
        '(anonymous namespace)::', '')[:40] for e in kernels}
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
    traj = greedy_decode_bimodal(model, x, STEPS, START, -1, PAD, 'torch')
    lp_err = 0.0
    with torch.inference_mode():
        runs = {impl: bimodal_step_setup(model, x, PAD, STEPS, impl)
                for impl in ('kernel', 'torch')}
        for step in range(STEPS):
            cur = traj[:, step:step + 1]
            lps = []
            for impl, (state, step_fn, _) in runs.items():
                lp, _ = step_fn(state, cur, step)
                lps.append(lp)
            check(torch.isfinite(lps[0]).all(), 'non-finite log-probs')
            lp_err = max(lp_err, (lps[0] - lps[1]).abs().max().item())
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
        q, k, v, mask, _ = attention_inputs(case, torch.bfloat16, dev, i)
        km, causal = key_mask_and_causal(mask, q.shape[0], k.shape[2], dev)
        both = timed({
            'plain': lambda: flash_attention_reference(q, k, v, km, causal),
            'kernel': lambda: flash_attention(q, k, v, mask),
            'library': lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask)}, 20)
        t = {n: v['device'] for n, v in both.items()}
        t['launched'] = both['kernel']['launched']
        t['bound'], t['bound_by'] = attention_bound_ms(*attention_cost(
            KERNEL, *case[1:6], 'bfloat16', case[6], with_lse=False),
            'bfloat16')
        print(f'    {case[0]:24s} Sq={case[3]:3d} Sk={case[4]:3d}: '
              + times_line('forward', t))
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

    # times at the train cell's encoder 256x256 call (forward with lse)
    report = [
        (KERNEL, max(max_err, train_err[KERNEL]), train_kernel_ms[KERNEL]),
        (KERNEL_DQ, train_err[KERNEL_DQ], train_kernel_ms[KERNEL_DQ]),
        (KERNEL_DKV, train_err[KERNEL_DKV], train_kernel_ms[KERNEL_DKV])]
    print(json.dumps({'kernels': [{
        'name': kname, 'route': 'cuda', 'source': SOURCES[kname],
        'replaces': REPLACES[kname], 'launches': trainer_launches[kname],
        'max_abs_err': err, 'ms': t['kernel'], 'plain_ms': t['plain'],
        'bound_ms': t['bound'], 'bound_by': t['bound_by'],
        'library_ms': t['library'], 'library_call': LIBRARY_CALL[kname]}
        for kname, err, t in report]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
