#!/usr/bin/env python3
'''Smoke test of the PyTorch port (bmt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA device; it imports
nothing of JAX. Phases, each of which stops the script with a non-zero exit
when it fails:

1. the device: torch's name for it and nvidia-smi's name and power limit;
2. build the CUDA kernels from bmt_tpu_torch/csrc/ (one nvcc per source,
   started together; each timed), all on wgmma at head dims padded to 64
   and 256: the forward in fp32 (flash_attn_fwd_tf32_sm90_kernel: three
   TF32 wgmma products on TMA tiles, at 256 in clusters of two blocks) and
   in bf16 (flash_attn_fwd_sm90_kernel: wgmma on TMA tiles, at 32 too),
   with flash_attn_fwd_combine_kernel<float> and <bf16>, which combine the
   partials of a split key loop; dQ and dK/dV in fp32
   (flash_attn_bwd_dq_tf32_sm90_kernel,
   flash_attn_bwd_dkv_tf32_sm90_kernel: three TF32 wgmma products on TMA
   tiles, at 256 in clusters of two blocks) and in bf16
   (flash_attn_bwd_dq_sm90_kernel, flash_attn_bwd_dkv_sm90_kernel: wgmma
   on TMA tiles, at 32 too); print what ptxas reports for each and fail if
   one is missing or any kernel spills registers; count HGMMA (wgmma),
   UTMALDG (TMA loads) and HMMA (the older mma.sync) in each kernel's
   machine code (cuobjdump -sass) and fail if an attention kernel lacks
   HGMMA or UTMALDG, or any kernel holds HMMA; beside them, the
   two host libraries from bmt_tpu_torch/csrc/*.cc with g++ (the feature
   loader bmt_io, the METEOR aligner meteor_align; timed), failing if
   either does not build or does not serve; and the threefry kernels
   (bmt_tpu_torch/csrc/threefry.cu: threefry_dropout_kernel<float> and
   <bf16>, threefry_bits32_kernel);
3. the forward kernel against its plain PyTorch version on the card, in
   fp32 and bf16, at the serving shapes and at Sq = Sk = 2048, with random
   padded key masks and one batch row whose keys are all masked (NaN in
   both);
4. the training kernels on the card, in fp32 and bf16: the lse forward
   against flash_attention_lse_reference and dQ, dK, dV against their plain
   versions on the same inputs, at the train cell's seven attention shapes
   (B=32, H=4, d=256) and at S=2048 plain and causal; the batch row with
   every key masked has lse -inf and exactly zero gradients in both; dQ,
   dK and dV of the 256x256 call are bitwise equal across two launches in
   both dtypes (no atomics);
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
8. train-step timing at bench.py's train cell (B=32, Sa=256, Sv=96,
   Sc=22, flagship, Adam lr 5e-5, clip 1.0, smoothing 0.7, dropout 0.1),
   in bf16 and then in fp32 (the train steps' default compute dtype): ms
   per step through both paths (median of alternating repetitions), 14
   launches of each kernel per step, the device-busy time of one step of
   each path (torch.profiler), and in bf16 a loss that falls over 10 steps
   on one repeated batch; then at the step's seven attention shapes, in
   bf16 and in fp32, each kernel's device time (device_ms) beside its
   plain version's, its bound (attention_cost) and its share of it, and
   the library yardsticks timed in the same turns:
   F.scaled_dot_product_attention for the forward, one autograd.grad
   through it (dQ, dK and dV together) for the backward pair; and each
   kernel's time per call launched back to back (CUDA events), which the
   host's launch rate sets for short calls;
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
    its bound, at B=16 and (the serving forward, whose key loops split over
    the bf16_key_splits printed beside each) B=1, and the same in fp32
    at B=16 (the shapes of a fp32 proposal train step, which launches 8 dQ
    and 8 dK/dV);
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
    steps on one repeated batch, one torch.profiler trace per path (the
    device's busy time as the union of its kernels' intervals beside their
    sum, the convolutions' alone and the streams they ran on; the busy
    share is the union over the traced span, read where it fits the span),
    the 20 conv heads' device time beside the attention kernels', and
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
    bound;
17. main.py's procedures through the port's CLI (bmt_tpu_torch.__main__,
    build_parser()'s widths: d_model 1024, H=4, d_k=256, N=2; bf16;
    --attention_impl pallas) from .npy files of a synthetic ActivityNet tree
    made from a seed: 64 train videos and 16 validation videos that val_1
    and val_2 both annotate, 2-4 events each, I3D rows 60-300 (2.56 s a
    row), VGGish rows 2.67 x as many up to 800, captions of
    data/vocab_ref.json's words (the 10,172-word generator through
    --vocab_path). train_cap (one epoch at B=32, then next-word validation
    and the 1-by-1 decode scored), train_prop (one epoch at B=16, the
    encoder from train_cap's best_cap_model, frozen) and evaluate (the
    proposals captioned and scored at 4 tIoUs), each with its launches
    counted from 0, its stage seconds, ms per step and the loop's wait on
    the prefetch queue printed; it fails on a procedure that raises, a
    missing best_* checkpoint, a non-finite loss, a checkpoint that does
    not load back (best_* through the app's loader, last_* with its
    optimizer state) or a kernel that never launched over the three. Then
    evaluate twice more in fp32 from the same checkpoint, through pallas
    (the kernel) and xla (plain attention): the captions must be equal, or,
    at the first that differ, the plain trajectory's top-2 log-prob gap at
    the first differing word within TOP2_GAP_TOL. Every shape at which
    these runs launched a kernel (B, H, Sq, Sk, d, causal, dtype; recorded
    at the wrappers' launch call) is checked as in phase 4, in its dtype
    and in fp32: the lse forward, and dQ and dK/dV where a backward kernel
    launched there (this and every later phase checks only the launch
    shapes and dtypes no earlier phase checked). train_cap ran once more
    in a child process started after train_cap, beside the rest (python -m
    bmt_tpu_torch --profile_steps 6): its traced device time per step over
    the wall time of the first train_cap's epoch, which ran without the
    profiler, is the device's busy share (the device time is the union of
    its kernels' intervals, their sum beside it). Last (17g), the host
    libraries on what 17a-17c did: their build seconds, the batches and
    METEOR pairs they served in 17a-17d (each must be more than 0); every
    feature-loader call 17a and 17b made, through the native library and
    numpy (equal arrays and statuses), timed in alternating passes; 17c's
    METEOR requests and a seeded set of 10,000 segments with 1-5
    references each, through the native aligner and the Python one with
    its spawn pool (BMT_METEOR_NATIVE=0): equal statistics pair for pair
    and equal scores, timed in turns;
18. the serving API from phase 17's checkpoints (still on disk): rank-8
    attn_ffn LoRA adapters of the captioner written by save_lora_npz (one
    with a random B, one all zeros); bmt_tpu_torch.scripts.serve.main
    (block=False; bf16, --attention_impl pallas, the proposal checkpoint,
    --lora_adapter tuned) answers 64 concurrent POST /caption requests of
    ragged crops and two POST /predict videos (phase 12's lengths), all
    200, coalesced into fewer batches than requests; each sentence equals
    engine.caption_crops([crop]) on its crop alone, or parts from it at a
    near-tie (the alone run's top-2 log-prob gap within BF16_GAP_TOL), each
    /predict equals VideoPipeline.predict, the zero adapter gives the base's
    tokens (18a); at the decode cell (B=64, Sa=256, Sv=96, 30 steps,
    end_idx=-1, bf16) greedy, beam K=4, sampling (top-k 50, top-p 0.9),
    kv_int8, weights_int8 and the tuned adapter: captions/s through
    'kernel' and 'torch' (medians of 3 alternating runs with their range)
    and the peak device memory (18b); in fp32 beam K=1 and top-k 1 sampling
    equal greedy, and kv_int8 and weights_int8 give their share of equal
    tokens and the first step's largest log-prob error against the
    unquantized decode (18c); the forward kernel against its plain version
    at every shape 18a-18b launched it (18d, as 17e); then
    bmt_tpu_torch.scripts.serve_bench with one 3 s window of each scenario,
    its JSON line printed (18e);
19. main.py's model and decode options through the port's CLI on phase
    17's tree and checkpoints (build_parser()'s widths, bf16,
    --attention_impl pallas), each run's launches counted from 0 and its
    shapes recorded: (19a) train_cap --lora_rank 8 --lora_targets attn_ffn
    seeded from phase 17's best_cap_model: every base leaf of its last and
    best weights bit for bit the seed's, every adapter's B moved off zero,
    and its best_cap_model.lora.npz served through scripts.serve's
    --lora_adapter (two /caption requests through it, one without); (19b)
    train_cap --moe_experts 4 --optim_mu_dtype bfloat16 from a seed: a
    finite loss, the first moment saved in bf16, and a step's loss with
    the Switch aux above the same step's without it by at most coeff x E;
    (19c) evaluate of 19b's best_cap_model greedy, with beam K=4 and the
    int8 cross K/V, with sampling (top-k 50, top-p 0.9) and with int8
    weights, scores finite; (19d) in fp32 the MoE captioner's cached greedy decode
    against the uncached one (B=4, 30 steps, plain attention; where a row
    parts, a near-tie within TOP2_GAP_TOL) and its evaluation through
    pallas and xla under phase 17d's rule; (19e) the kernels against their
    plain versions at every shape 19a-19d launched them, as 17e; (19f) the
    int8 weights and scales of the generator, the activation levels and
    scales of a batch and the int8 K/V levels and scales equal on the card
    and the CPU bit for bit. It prints seconds, ms per step, launches and
    scores per run;
20. the uni-modal models and the acceptance chain on phase 17's tree and
    checkpoints (build_parser()'s widths, bf16, --attention_impl pallas),
    each run's launches counted from 0 and its shapes recorded: (20a)
    train_cap --modality video (d_k = 256) and --modality audio
    (d_model_audio = 128, H=4: d_k = 32), train_prop --modality audio with
    the audio captioner's encoder, frozen, and evaluate of the audio
    captioner on its proposals, each one epoch, failing as phase 17's runs
    fail; (20b) in fp32 each modality's cached greedy decode against the
    uncached one (B=4, 30 steps, plain attention; where a row parts, a
    near-tie within TOP2_GAP_TOL), then the audio evaluation through
    pallas and xla under phase 17d's rule; (20c) the kernels against their
    plain versions at every shape 20a-20b launched them, as 17e, the
    d = 32 shapes among them; (20d) each kernel's device time beside its
    plain version's, the library call's and its bound at the most-launched
    d = 32 shape, the d = 32 shape of the most work and the most-launched
    d = 256 shape phase 17 did not launch (the most-launched d = 256 one
    when there is none);
    (20e) python -m bmt_tpu_torch.scripts.acceptance on phase 17's
    bi-modal checkpoints: md5 SKIP (native checkpoints), import, gt_val and
    learned_props PASS, and sample PASS against a golden from one direct
    run of the port's app on seeded women_long_jump stand-ins; overall
    PASS;
21. export_decode, Adam's moments across the packages and data
    parallelism on phase 17's tree and checkpoints: (21a) export_decode at
    the decode cell (B=64, Sa=256, Sv=96, 30 steps, end token 3) through
    'kernel' in bf16 and fp32 and 'torch' in fp32, the three exported side
    by side in child processes while 21b-21d run (printed after them),
    each blob loaded from bytes and replayed
    with phase 17's best_cap_model and a seeded parameter set against the
    live decode (fp32 bit for bit; bf16 equal or a near-tie within
    BF16_GAP_TOL), the forward kernel's launches inside the replay (above
    0 through 'kernel'), export and load seconds, bytes, and the replay's
    captions/s beside the live decode's (median of 4 alternating runs);
    (21b) train_cap two epochs straight against one epoch resumed for a
    second through .opt.npz, and through an earlier port's .torch_opt.npz,
    last_cap_model's weights and optimizer file bit for bit; (21c) two
    ranks spawned as python -m bmt_tpu_torch spawns them, on gloo (both on
    the one card: NCCL refuses two ranks on one device; NCCL with two
    cards or more): train_cap --B 16 --dp_devices 2 and its fp32
    evaluation over two ranks and over one, under phase 17d's caption rule
    (the two ranks' train steps are held to one process in 22a); (21d) a CaptionEngine with two replicas on the one
    card answers phase 18's 64 requests with one replica's sentences (a
    near-tie within BF16_GAP_TOL allowed), 2 x 8 forward launches, and
    captions/s beside one replica's; (21e) the kernels against their plain
    versions at every 21a-21d launch shape, the ranks' included (the
    spawned workers return their launches and shapes);
22. --fsdp, expert and sequence parallelism, two gloo ranks sharing the
    card (22a's spawn, which runs 23a-23c too, and 23d's run beside 22b's
    four, its one-process references made before them): (22a) the fp32
    train cells, 3 Adam steps (dropout 0) of the
    global batch, held to one process's within STEP_TOL and PROP_STEP_TOL:
    the captioner and the proposal generator under --fsdp (dp 2, leaves of
    >= FSDP_MIN_ELEMS shard), the MoE captioner (E = 4) over ep 2, the
    proposal generator over sp 2 (each rank a 400-row audio and 150-row
    video block); each rank's memory_allocated after init and after the
    steps beside one process's, and its sharded and whole bytes; (22b) on
    phase 17's tree at build_parser widths, bf16, pallas, one epoch:
    train_cap --fsdp --dp_devices 2 --B 16, train_prop --fsdp --dp_devices
    2 --B 8, train_cap --moe_experts 4 --ep_devices 2, train_prop
    --sp_devices 2, spawned as python -m bmt_tpu_torch spawns them, all
    four side by side; each run directory loads in one process (best_*
    through the app's loader; a captioner's last_* with its optimizer too)
    and each captioner is scored by evaluate in one process; the seconds
    by stage; (22c) the kernels against their plain versions at every 22a-22b launch shape, and their times at the
    sp shapes (B=16: 400x800, 150x300, 400x300, 150x800) beside the plain
    versions, the library and the bound;
23. tensor and pipeline parallelism, two gloo ranks sharing the card, in
    one spawn: (23a) fp32, 3 Adam steps, dropout 0, under mp 2 (each rank
    2 of the 4 heads, half of each feed-forward's width and of the
    vocabulary): the train cell, the proposal cell and the train cell's
    captioner with rank-8 LoRA adapters (only they move), held to one
    process (22a's runs for the first two) within STEP_TOL and
    PROP_STEP_TOL, each rank's memory_allocated after init and after the
    steps beside one process's and beside the share of the leaves it holds
    (``mp_share``), and the LoRA cell's ReLU inputs within KINK of 0 in
    one process and those the ranks put on the other side, by step (forward
    hooks on each fc1: such a tie moves the adapters' gradient, and its
    norm, by ~1e-4); (23b) the decode cell with mp-2 parameters in fp32
    (its step log-probs along one process's trajectory within
    LOGPROB_TOL) and bf16 (its tokens one process's, or a near-tie within
    BF16_GAP_TOL), captions/s beside one process's; (23c) the flagship
    bi-modal encoder pipelined over pp 2 (a layer a stage, B=32 in 4
    microbatches) in fp32 and bf16, its outputs and each layer's gradient
    against the sequential stack in one process within PP_TOL, ms a
    forward + backward beside the stack's, and the feed-forwards' ReLU
    inputs that fall on the other side of 0 from the stack's, by layer
    and stream (forward hooks on each fc1); (23d) python -m
    bmt_tpu_torch.scripts.dryrun_multichip --n_devices 4 --backend gloo
    (its dryrun_multichip, run here so its four ranks report their
    launches and shapes; it runs beside 22a's and 22b's spawns, its lines
    printed here); (23e) the kernels against their plain versions at every
    23a-23d launch shape, and their times at H = 2 at the train and
    proposal cells' longest calls, bf16 and fp32.

24. multi-step dispatch (``--steps_per_dispatch``; ``make_multistep``):
    the captioner's train cell in bf16 and in fp32 and the proposal cell
    (bf16, B=16, E=6, remat), each with EMA, as bundles of 4 steps through
    CUDA graphs against 4 eager steps from the same state (24a): the
    losses, parameters, moments, counters and EMA agree within STEP_TOL /
    PROP_STEP_TOL (the differences are printed; expected 0) after two
    bundles (the first warms up and captures) and after timed rounds; each
    bundle launches the kernels of its 4 steps from the graph; the ms a
    step eager and graphed (host clock, medians of alternating bundles),
    the capture's seconds, the graph pool's MiB, and each graphed bundle's
    busy share in one trace of the three. 24b runs train_cap with
    --steps_per_dispatch 4 on phase 17's tree: the graphs it captured and
    replayed, and its epoch loss beside 17a's. The step API's default
    draws the masks of the three cells from threefry2x32: a graphed bundle
    equals its eager steps bit for bit (so each replay drew its own step's
    masks from the step key its input buffer held), and each bundle
    launches the dropout kernel from the graph.

25. the threefry2x32 kernels (``ops.prng``): threefry_dropout_kernel at
    each of the train cell's nine dropout shapes in bf16 and fp32, its
    backward on a gradient, and two offset blocks (a dp 2 x mp 2 rank's
    block of the video feed-forward's hidden, an sp 2 rank's of the
    proposal cell's audio), and every draw of a proposal train step (bf16,
    B=16, remat; recorded where the step calls ``prng.dropout``, the heads'
    conv outputs read in place through their transposed views), against
    the plain version: bit for bit (max abs err 0);
    threefry_bits32_kernel at the decode cell's (B, 10172)
    sampling draw and a block of its rows, bit for bit; a captioner train
    step's dropout launches against the count of its sites, each kernel's
    device ms beside its plain version's, F.dropout's and the rbg
    bernoulli_ path's (context: no library call computes threefry), its
    bound (bytes over HBM's rate; the integer ops an element, ``prng``'s
    count, at the card's max SM clock: the rotations, xors and compare on
    the 64 INT32 lanes of an SM, all of them within its 128 issue slots a
    clock) and the share of a step; a sampled decode
    (make_bimodal_sample_fn, top-k 50 and top-p 0.9) of the flagship
    captioner at the decode cell, its bits launches counted, the same
    tokens on a second run; the captioner train cell's step under
    threefry2x32 beside rbg (bf16 and fp32, alternating eager steps), and
    the proposal cell's (bf16, remat) in alternating graphed bundles.

The line before the last is the kernel report as JSON; the last line is
{"ok": true, "device": {...}}. The report's `launches` are the captioning
trainer's (phase 9); `launches_by_path` gives those of each main path's run
(phases 9, 12, 15 and 16, phase 17's train_cap, train_prop and
evaluate, phase 18's requests as `serve`, phase 19's runs, phase 20's
as `unimodal` (20a's four runs) and `acceptance`, and phase 21's:
`export_replay`, `moments ...`, `dp_*` summed over the ranks,
`engine_replicas`; and phase 22's `22a ...` and `22b ...`, and phase 23's
`23a ...`, `23b decode`, `23c pp ...` and `23d dryrun ranks`, summed over
the ranks, and phase 24's `24b train_cap K4`), `multistep` phase 24's
numbers, `serving` phase 18's numbers, `main_py_options` phase 19's,
`unimodal` phase 20's, `export_dp` phase 21's, `sharding` phase 22's,
`tensor_pipeline` phase 23's,
`main_py_procedures` phase 17's seconds, step and prefetch-wait
times, scores, the checks at its launch shapes and busy share, `proposal_800x800` each kernel's times at the
proposal cell's 800x800 call, `fp32_train_256x256` its fp32 times at the
train cell's 256x256 call, and the forward's `fp32_app` its fp32 times at
the app's caption-batch 512x512 and B=1 800x800 calls; the report's
`fp32_train_step_ms` holds the fp32 captioner train step's medians through
'kernel' and 'torch' (phase 8). The threefry kernels' entries come from
phase 25 (their `launches` from phase 9's trainer for the dropout kernel
and phase 25's sampled decode for the bits kernel; their times at the
train cell's video feed-forward hidden in bf16 and at the decode cell's
sampling draw), `threefry` phase 25's numbers.
'''
import atexit
import collections
import contextlib
import copy
import dataclasses
import gc
import importlib
import io
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from bmt_tpu_torch.config import Config, build_parser
from bmt_tpu_torch.decode import (beam_search_bimodal, greedy_decode_bimodal,
                                  greedy_decode_uncached,
                                  make_bimodal_greedy_fn,
                                  sample_decode_bimodal)
from bmt_tpu_torch.decode.greedy import bimodal_step_setup
from bmt_tpu_torch.models import BiModalTransformer, CapModelDims
from bmt_tpu_torch.ops._build import (host_lib_path, load_host_library,
                                     load_library, ptxas_report, sass)
from bmt_tpu_torch.ops.flash_attention import (
    BWD_LIBRARY, KERNEL, KERNEL_DKV, KERNEL_DQ, _sm_count, attention_bound_ms,
    attention_cost, bf16_key_splits, flash_attention, fp32_key_splits,
    flash_attention_bwd_dkv, flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq, flash_attention_bwd_dq_reference,
    flash_attention_forward, flash_attention_lse_reference,
    flash_attention_reference, key_mask_and_causal, launch_counts,
    row_dot)
from bmt_tpu_torch.ops import launches as kernel_launches
from bmt_tpu_torch.ops import prng
from bmt_tpu_torch.decode import make_bimodal_sample_fn
from bmt_tpu_torch.models import (MultimodalProposalGenerator, PropModelDims,
                                  captioner_class, proposal_class)
from bmt_tpu_torch.params import (init_params, load_jax_params,
                                  load_params_npz, save_params_npz,
                                  to_jax_tree)
from bmt_tpu_torch.models.encoders import BiModalEncoder
from bmt_tpu_torch.data import (AUDIO_BUCKETS, VIDEO_BUCKETS, Vocab,
                                bucket_len, build_vocab_from_meta)
from bmt_tpu_torch.ops.masks import make_masks
from bmt_tpu_torch.scripts import single_video_prediction as app
from bmt_tpu_torch.ops.lora import (add_lora, apply_adapter, has_lora,
                                    lora_frozen_predicate)
from bmt_tpu_torch.ops.attention import _quantize_per_channel
from bmt_tpu_torch.ops.quant import (quantize_linear_int8, quantize_rows_int8,
                                     quantize_tree_int8)
from bmt_tpu_torch.scripts import acceptance
from bmt_tpu_torch.scripts import serve as serve_cli
from bmt_tpu_torch.serve import (SHORTEST_SEGMENT, CaptionEngine,
                                 MicroBatcher, VideoPipeline,
                                 export_decode, ints_to_sentence,
                                 load_exported_decode)
from bmt_tpu_torch.parallel import DataParallel, replica_devices
from bmt_tpu_torch.parallel.launch import spawn
from bmt_tpu_torch.parallel.pipeline import (
    pipelined_bimodal_encoder_forward, stack_layer_params, stage_group)
from bmt_tpu_torch.parallel.sharding_rules import mp_plan
from bmt_tpu_torch.train import (build_optimizer, init_train_state,
                                 make_cap_train_step, make_multistep,
                                 make_prop_inference_step,
                                 make_prop_train_step, prop_frozen, train_epoch_cap,
                                 train_epoch_prop)
from bmt_tpu_torch import __main__ as cli
from bmt_tpu_torch.data import native as native_io
from bmt_tpu_torch.data.features import load_features_from_npy
from bmt_tpu_torch.evaluation import meteor, meteor_native
from bmt_tpu_torch.train.loops import device_busy_ms
from bmt_tpu_torch.train.checkpoint import (checkpoint_exists,
                                            load_cap_checkpoint,
                                            load_checkpoint,
                                            load_lora_sites,
                                            load_prop_checkpoint,
                                            read_checkpoint_meta,
                                            save_checkpoint,
                                            save_lora_npz,
                                            save_torch_checkpoint,
                                            save_torch_prop_checkpoint)
from bmt_tpu_torch.utils import (get_corner_coords,
                                 remove_very_short_segments,
                                 select_topk_predictions, trim_proposals)

# every kernel's launch count to 0 (``ops.launches``); a path is driven
# between this and the reads: ``launch_counts()`` the attention kernels',
# ``kernel_launches.counts()`` every kernel's
reset_launch_counts = kernel_launches.reset


SOURCES = {KERNEL: 'bmt_tpu_torch/csrc/flash_attn_fwd.cu',
           KERNEL_DQ: 'bmt_tpu_torch/csrc/flash_attn_bwd.cu',
           KERNEL_DKV: 'bmt_tpu_torch/csrc/flash_attn_bwd.cu',
           prng.KERNEL_DROPOUT: 'bmt_tpu_torch/csrc/threefry.cu',
           prng.KERNEL_BITS32: 'bmt_tpu_torch/csrc/threefry.cu'}
# the kernels each library holds, all on wgmma: three TF32 products for
# fp32 and bf16 (the forward with its split's combine)
ENTRIES = {KERNEL: ('flash_attn_fwd_tf32_sm90_kernel',
                    'flash_attn_fwd_combine_kernel',
                    'flash_attn_fwd_sm90_kernel'),
           BWD_LIBRARY: ('flash_attn_bwd_dq_tf32_sm90_kernel',
                         'flash_attn_bwd_dq_sm90_kernel',
                         'flash_attn_bwd_dkv_tf32_sm90_kernel',
                         'flash_attn_bwd_dkv_sm90_kernel'),
           prng.LIBRARY: ('threefry_dropout_kernel',
                          'threefry_bits32_kernel')}
# the opcodes counted in the kernels' machine code: wgmma, the TMA tile load
# and mma.sync; the attention kernels must hold the first two, and no
# kernel the third
SASS_OPS = ('HGMMA', 'UTMALDG', 'HMMA')
HOPPER_KERNELS = ('flash_attn_fwd_tf32_sm90_kernel',
                  'flash_attn_fwd_sm90_kernel',
                  'flash_attn_bwd_dq_sm90_kernel',
                  'flash_attn_bwd_dkv_sm90_kernel',
                  'flash_attn_bwd_dq_tf32_sm90_kernel',
                  'flash_attn_bwd_dkv_tf32_sm90_kernel')
REPLACES = {KERNEL: 'bmt_tpu/ops/pallas_attention.py:237',  # and :278
            KERNEL_DQ: 'bmt_tpu/ops/pallas_attention.py:473',
            KERNEL_DKV: 'bmt_tpu/ops/pallas_attention.py:498',
            # no Pallas kernel: XLA lowered these on the TPU
            prng.KERNEL_DROPOUT: 'bmt_tpu/ops/layers.py:87',
            prng.KERNEL_BITS32: 'bmt_tpu/decode/sample.py:88'}
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
    '''The kernel and template argument of a ptxas "Compiling entry" line
    or a cuobjdump "Function :" line:
    ..wg29flash_attn_bwd_dq_sm90_kernelILi256EEEv14CUtensorMap_st.. ->
    flash_attn_bwd_dq_sm90_kernel<256>. The mangled name's length prefix
    tells the kernel from the anonymous namespace, which holds the source's
    file name.'''
    m = re.search(r'\d+((?:flash_attn|threefry)_\w*?_kernel)'
                  r'(?:ILi(\d+)EE|I(f)EE|I\d+(__nv_bfloat16)EE)?', line)
    if m is None:
        return line.strip()
    arg = m.group(2) or (m.group(3) and 'float') or (m.group(4) and 'bf16')
    return f'{m.group(1)}<{arg}>' if arg else m.group(1)


def sass_counts(lib):
    '''{kernel<arg>: {opcode: instructions}} of SASS_OPS in the machine
    code of the library ``lib`` (cuobjdump -sass).'''
    counts, cur = {}, None
    for line in sass(lib).splitlines():
        if 'Function :' in line:
            cur = counts.setdefault(kernel_name(line),
                                    dict.fromkeys(SASS_OPS, 0))
            continue
        m = re.search(r'/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)',
                      line)
        if cur is not None and m and m.group(1) in cur:
            cur[m.group(1)] += 1
    return counts


def timed_load(name):
    '''Seconds to build (nvcc, when no library of this source exists yet)
    and load the CUDA library ``name``.'''
    t0 = time.perf_counter()
    load_library(name)
    return time.perf_counter() - t0


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
                  backward=True, bitwise=False):
    '''The lse forward and, with ``backward``, dQ and dK/dV against their
    plain versions at ``case``; the plain backward gets the kernel's lse and
    D (the same inputs). A batch row with every key masked has lse -inf and
    exactly zero gradients in both. With ``bitwise``, a second launch of
    each backward kernel gives the same bits. Returns {kernel: max abs
    error}.'''
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
        if bitwise:
            again = (flash_attention_bwd_dq(q, k, v, km, causal, lse, drow,
                                            dout),
                     *flash_attention_bwd_dkv(q, k, v, km, causal, lse, drow,
                                              dout))
            check(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
                  f'{case[0]} {dtype}: dQ, dK or dV differs between two '
                  f'launches on the same inputs')
            line.append('dq, dk, dv bitwise equal in 2 launches')
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
                              bitwise=i == 0)
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


def step_medians(paths, batch, label, smi):
    '''{impl: ms per step} of each path's train step on ``batch``: the
    median of alternating repetitions after a warm-up step each, with a
    finite loss and CALLS_PER_STEP launches of each kernel in every
    'kernel' step (none in a 'torch' step).'''
    for impl, (state, step) in paths.items():        # warm-up
        step_ms(state, step, batch)
    times = {'torch': [], 'kernel': []}
    for impl in ('torch', 'kernel', 'kernel', 'torch') * TRAIN_ROUNDS:
        state, step = paths[impl]
        reset_launch_counts()
        ms, m = step_ms(state, step, batch)
        counts = launch_counts()
        times[impl].append(ms)
        check(torch.isfinite(m['loss']).item(),
              f'{label} {impl}: loss not finite')
        want = CALLS_PER_STEP if impl == 'kernel' else 0
        check(all(n == want for n in counts.values()),
              f'{label} {impl} step launched {counts}, {want} of each '
              f'expected')
    med = {impl: statistics.median(t) for impl, t in times.items()}
    print(f'    {label}: ms per step (median of {2 * TRAIN_ROUNDS}; {smi}): '
          f'kernel {med["kernel"]:.2f} '
          f'{[round(t, 2) for t in times["kernel"]]}, torch '
          f'{med["torch"]:.2f} {[round(t, 2) for t in times["torch"]]}; '
          f'launches per kernel step {CALLS_PER_STEP} of each kernel')
    return med


def print_busy(paths, batch, med, label):
    '''The device-busy time of one step of each path (torch.profiler).'''
    for impl, (state, step) in paths.items():
        busy, n, top, attn, union = device_busy(lambda: step(state, batch))
        share = 'not measured' if busy is None else (
            f'{union["union_ms"]:.2f} ms (the union of its kernels\' '
            f'intervals on {union["streams"]} streams; their sum '
            f'{busy:.2f}) of the median {med[impl]:.2f} ms step '
            f'({union["union_ms"] / med[impl]:.1%})')
        print(f'    {label} {impl}: device busy {share} in {n} kernels and '
              f'copies; top (ms): {top}; attention kernels (ms): {attn}')


def phase_train_timing(dev, smi):
    '''The train step through both paths in bf16 and then in fp32 (the
    steps' default compute dtype), then the kernels' times at the step's
    shapes. Returns (bf16 medians, fp32 medians, bf16 kernel_times at
    256x256, fp32 kernel_times at 256x256).'''
    dims = CapModelDims(voc_size=VOC)                 # dropout 0.1
    batch = train_batch(30, TB, SV, SA, TSC, dims)
    paths = {impl: trainer(dims, dev, impl, torch.bfloat16)
             for impl in ('torch', 'kernel')}
    med = step_medians(paths, batch, 'bf16', smi)

    state, step = paths['kernel']
    losses = []
    for _ in range(10):
        state, m = step(state, batch)
        losses.append(m['loss'].item())
    print(f'    10 more steps on the same batch (bf16, kernel): loss '
          f'{[round(x, 4) for x in losses]}')
    # dropout makes single steps noisy: compare the first and last three
    check(sum(losses[-3:]) < sum(losses[:3]), 'the loss does not fall')
    print_busy(paths, batch, med, 'bf16')
    del paths, state, step
    torch.cuda.empty_cache()

    paths = {impl: trainer(dims, dev, impl, torch.float32)
             for impl in ('torch', 'kernel')}
    med32 = step_medians(paths, batch, 'fp32', smi)
    print_busy(paths, batch, med32, 'fp32')
    del paths
    torch.cuda.empty_cache()

    # the three kernels against their plain versions and the library at
    # the step's seven attention shapes, in bf16 and in fp32 (TF32); the
    # first (encoder 256x256) goes into the report. The library's backward
    # computes dQ, dK and dV together: it compares with the sum of the two
    # backward kernels
    first = {}
    for dtype in (torch.bfloat16, torch.float32):
        print(f'    device ms per call ({str(dtype).removeprefix("torch.")}, '
              f'B={TB}, H=4, d=256; library backward: autograd.grad through '
              f'scaled_dot_product_attention of that dtype; {smi}):')
        for case in TRAIN_CASES[:7]:
            t = kernel_times(case, dev, dtype=dtype)
            first.setdefault(dtype, t)
            pair = t[KERNEL_DQ]['kernel'] + t[KERNEL_DKV]['kernel']
            print(f'    {case[0]:24s} Sq={case[3]:3d} Sk={case[4]:3d}: '
                  + '; '.join(times_line(n, v) for n, v in t.items())
                  + f'; dQ + dK/dV {pair:.4f} vs library backward '
                  f'{t[KERNEL_DQ]["library"]:.4f}')
    ms, ms32 = first[torch.bfloat16], first[torch.float32]
    return med, med32, ms, ms32


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


def device_busy(fn):
    '''(ms of device kernels summed, their number, the five longest by
    name, cut to 40 characters, ms of each attention kernel by name,
    ``device_busy_ms`` of all of them and of the convolutions alone: the
    union of their intervals, their sum, the streams) in one call of fn()
    under torch.profiler.'''
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
        return (None, 0, 'not measured: the profiler saw no device kernel',
                {}, None)
    events = prof.events()
    busy = device_busy_ms(events)
    busy['conv'] = device_busy_ms([e for e in events if 'conv' in e.name])
    kernels.sort(key=lambda e: -e.self_device_time_total)
    short = {e.key: e.key.replace('void ', '').replace(
        '(anonymous namespace)::', '')[:40] for e in kernels}
    top = {short[e.key]: round(e.self_device_time_total / 1e3, 3)
           for e in kernels[:5]}
    attn = {short[e.key]: round(e.self_device_time_total / 1e3, 3)
            for e in kernels if 'flash_attn' in e.key}
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels), top, attn, busy)


def phase_trainer(dev):
    dims = CapModelDims(voc_size=VOC)
    data = InMemoryDataset(20, 8, 48, 128, 16, dims)
    state, step = trainer(dims, dev, 'kernel', torch.bfloat16, seed=3)
    reset_launch_counts()
    state, mean = train_epoch_cap(step, state, data, epoch=0)
    torch.cuda.synchronize()
    counts = launch_counts()
    drawn = kernel_launches.counts([prng.KERNEL_DROPOUT, prng.KERNEL_BITS32])
    print(f'    3 batches (8, 8, a tail of 4): {state.step} steps, mean loss '
          f'{mean:.4f}, launches {counts}, threefry {drawn} (the step '
          f'API\'s default prng_impl {state.prng_impl})')
    check(state.step == 3, f'{state.step} steps for 3 batches')
    check(np.isfinite(mean), f'epoch loss {mean}')
    check(all(n == CALLS_PER_STEP * 3 for n in counts.values()),
          f'launches {counts}, {CALLS_PER_STEP * 3} of each expected')
    want = 3 * dropout_launches_per_step()
    check(drawn[prng.KERNEL_DROPOUT] == want and not drawn[
        prng.KERNEL_BITS32], f'threefry launches {drawn}, {want} dropout '
        f'launches expected (forward and backward) and no bits')
    return {**counts, **drawn}


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
    B = 16), then their device times in bf16 (B = 16 and B = 1) and in fp32
    (B = 16) beside the plain versions, the library calls and the bounds.
    Returns (max abs error by kernel, {case: bf16 kernel_times at
    B = 16}).'''
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
        splits = bf16_key_splits(*c[1:6], _sm_count(dev))
        print(f'    B=1  {case[0]:24s} Sq={case[3]:3d} Sk={case[4]:3d} key '
              f'splits {splits}: ' + times_line('forward (no lse)', t))
    # fp32 at B=16: what a fp32 proposal train step launches (16 forward,
    # 8 dQ and 8 dK/dV calls at these four shapes)
    print(f'    device ms per call (fp32, B={PB}, H=4, d=256; library '
          f'backward: autograd.grad through fp32 '
          f'scaled_dot_product_attention; {smi}):')
    for case in PROP_CASES:
        lengths = prop_key_lengths(PB, case[4], dev)
        t = kernel_times(case, dev, lengths, dtype=torch.float32)
        pair = t[KERNEL_DQ]['kernel'] + t[KERNEL_DKV]['kernel']
        print(f'    B={PB} {case[0]:24s} Sq={case[3]:3d} Sk={case[4]:3d}: '
              + '; '.join(times_line(n, v) for n, v in t.items())
              + f'; dQ + dK/dV {pair:.4f} vs library backward '
              f'{t[KERNEL_DQ]["library"]:.4f}')
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

    # one trace per path: the device's busy time as the union of its
    # kernels' intervals beside their sum (which counts kernels that overlap
    # in time twice), the convolutions' alone, the streams they ran on, the
    # traced step's own span (CUDA events around it) and the untraced
    # median. The busy share is the union over the span, read only where
    # the union fits in the span
    traces = {}
    for impl, (state, step) in paths.items():
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))

        def traced():
            start.record()
            step(state, batch)
            stop.record()
        busy, n, top, attn, union = device_busy(traced)
        span = start.elapsed_time(stop)
        if busy is None:
            total = 'not measured'
        else:
            conv = union['conv']
            share = (f'busy share {union["union_ms"] / span:.1%} of the '
                     f'span' if union['union_ms'] <= span else
                     'busy share withdrawn: the union overruns the span')
            total = (f'{union["union_ms"]:.2f} ms busy (the union of {n} '
                     f'kernels\' and copies\' intervals on '
                     f'{union["streams"]} streams; summed {busy:.2f}) in a '
                     f'traced span of {span:.2f} ms ({share}); the '
                     f'convolutions {conv["union_ms"]:.2f} ms as a union, '
                     f'{conv["sum_ms"]:.2f} summed, {conv["kernels"]} '
                     f'kernels on {conv["streams"]} streams; untraced median '
                     f'{med[impl]:.2f} ms')
            traces[impl] = {'union_ms': union['union_ms'], 'sum_ms': busy,
                            'span_ms': span, 'streams': union['streams'],
                            'conv': conv}
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
          f'phase-11 times); the traced steps\' convolutions as a union '
          + ', '.join(f'{impl} {t["conv"]["union_ms"]:.2f}'
                      for impl, t in traces.items()))
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
    print(f'    the fp32 forward kernel (TF32 wgmma) at the app\'s shapes '
          f'(H=4, d=256; {smi}):')
    app_ms = {}
    for i, (case, keys) in enumerate(cases):
        t = forward_times(case, dev, 600 + i, keys, torch.float32)
        splits = fp32_key_splits(
            *case[1:6], torch.cuda.get_device_properties(dev)
            .multi_processor_count)
        print(f'    B={case[1]:<3d} {case[0]:28s} Sq={case[3]:3d} '
              f'Sk={case[4]:3d} key splits {splits}: '
              + times_line('fp32 forward', t))
        if i in (0, len(PROP_CASES)):    # B=1 800x800, the batch's audio self
            app_ms[f'B={case[1]} {case[3]}x{case[4]}'] = t
    return counts['native', 'kernel'], app_ms


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


# ---------------------------------------------------------------------------
# main.py's procedures through the port
# ---------------------------------------------------------------------------

VOCAB_REF = os.path.join(REPO, 'data', 'vocab_ref.json')
# phase 17's synthetic ActivityNet-like tree: 64 train videos and 16
# validation videos that val_1 and val_2 both annotate (as ActivityNet's two
# validation sets annotate the same videos), 2-4 events a video, I3D rows
# 60-300 (2.56 s a row), VGGish rows 2.67 x as many, up to 800
ANET_TRAIN, ANET_VAL, ANET_ROWS, ANET_EVENTS = 64, 16, (60, 300), (2, 4)
# every procedure's flags beyond the tree's paths: build_parser()'s defaults
# otherwise (d_model 1024, H=4, d_k=256, N=2, --compute_dtype bfloat16)
CLI_FLAGS = ['--attention_impl', 'pallas', '--epoch_num', '1']
# the procedures' own: train_cap's batch is bench.py's train cell's,
# train_prop's its proposal cell's (the encoder seeded from the captioner
# and frozen, as in the reference's second stage)
CAP_FLAGS = ['--B', '32', '--one_by_one_starts_at', '0']
PROP_FLAGS = ['--B', '16']
# the fp32 evaluations' captions, kernel against plain attention: where
# they part, the plain trajectory's top-2 log-prob gap at the first step
# that differs must be a near-tie (the engine's rule, PERF.md section 2)
TOP2_GAP_TOL = 1e-3


def write_anet_tree(root, seed=17):
    '''The tree under ``root``: i3d/<vid>_{rgb,flow}.npy, vggish/<vid>.npy,
    {train,val_1,val_2}.json and .csv, val_*_no_missings.json and
    available_mp4.txt; captions of 8-20 words of data/vocab_ref.json.
    Returns the command-line flags of its paths.'''
    words = [w for w in Vocab.load(VOCAB_REF).itos[4:]
             if '"' not in w and w.strip() == w and '\t' not in w]
    # the vocabulary lists its words by their frequency in ActivityNet's
    # train captions: drawn with p ~ 1 / rank, captions lean on the
    # frequent words as real ones do, and a one-epoch captioner scores
    # METEOR above 0 (which best_cap_model needs)
    zipf = 1.0 / np.arange(1, len(words) + 1)
    zipf /= zipf.sum()
    rng = np.random.default_rng(seed)
    vdir, adir = os.path.join(root, 'i3d'), os.path.join(root, 'vggish')
    os.makedirs(vdir)
    os.makedirs(adir)
    ann = {'train': {}, 'val_1': {}, 'val_2': {}}
    for v in range(ANET_TRAIN + ANET_VAL):
        vid = f'v_{v:05d}'
        sv = int(rng.integers(ANET_ROWS[0], ANET_ROWS[1] + 1))
        sa = min(int(round(2.67 * sv)), 800)
        for name, shape in ((f'{vid}_rgb', (sv, 1024)),
                            (f'{vid}_flow', (sv, 1024))):
            np.save(os.path.join(vdir, f'{name}.npy'),
                    rng.standard_normal(shape, np.float32))
        np.save(os.path.join(adir, f'{vid}.npy'),
                rng.standard_normal((sa, 128), np.float32))
        duration = round(2.56 * sv, 2)
        for phase in (('train',) if v < ANET_TRAIN else ('val_1', 'val_2')):
            n = int(rng.integers(ANET_EVENTS[0], ANET_EVENTS[1] + 1))
            starts = rng.uniform(0.0, 0.8 * duration, n)
            ends = np.minimum(starts + rng.uniform(2.0, 0.4 * duration, n),
                              duration)
            ann[phase][vid] = {
                'duration': duration,
                'timestamps': [[round(float(a), 2), round(float(b), 2)]
                               for a, b in zip(starts, ends)],
                'sentences': [' '.join(rng.choice(words, rng.integers(8, 21),
                                                  p=zipf))
                              for _ in range(n)]}
    for phase, videos in ann.items():
        names = [f'{phase}.json'] + ([f'{phase}_no_missings.json']
                                     if phase != 'train' else [])
        for name in names:
            with open(os.path.join(root, name), 'w') as f:
                json.dump(videos, f)
        with open(os.path.join(root, f'{phase}.csv'), 'w') as f:
            f.write('video_id\tcaption\tstart\tend\tduration\tphase\tidx\n')
            idx = 0
            for vid, info in videos.items():
                for (a, b), cap in zip(info['timestamps'], info['sentences']):
                    f.write(f'{vid}\t{cap}\t{a}\t{b}\t{info["duration"]}\t'
                            f'{phase}\t{idx}\n')
                    idx += 1
    with open(os.path.join(root, 'available_mp4.txt'), 'w') as f:
        f.write(''.join(f'v_{v:05d}.mp4\n'
                        for v in range(ANET_TRAIN + ANET_VAL)))
    return ['--train_meta_path', os.path.join(root, 'train.csv'),
            '--val_1_meta_path', os.path.join(root, 'val_1.csv'),
            '--val_2_meta_path', os.path.join(root, 'val_2.csv'),
            '--video_features_path', vdir, '--audio_features_path', adir,
            '--train_json_path', os.path.join(root, 'train.json'),
            '--reference_paths', os.path.join(root, 'val_1_no_missings.json'),
            os.path.join(root, 'val_2_no_missings.json'),
            '--avail_mp4_path', os.path.join(root, 'available_mp4.txt'),
            '--vocab_path', VOCAB_REF]


def run_procedure(argv, dev, shapes: collections.Counter):
    '''python -m bmt_tpu_torch's main(argv) on ``dev``, the launch counts
    set to 0 just before and read just after, the launches' shapes added to
    ``shapes``; its stdout is captured and its timing and score lines
    echoed. Returns (result, seconds, launches, {stage: the rest of its
    [time] line}).'''
    printed = io.StringIO()
    torch.cuda.synchronize()
    reset_launch_counts()
    with contextlib.redirect_stdout(printed), launch_shapes(shapes):
        result, seconds = synced(lambda: cli.main(
            argv + ['--device', str(dev)]))
    launches = launch_counts()
    stages = {}
    for line in printed.getvalue().splitlines():
        if line.startswith(('[time]', '[scores]', '[graphs]',
                            'Total Number')):
            print(f'      {line}')
        if line.startswith('[time] '):
            stage, rest = line[len('[time] '):].split(': ', 1)
            stages[stage] = rest
    print(f'      -> {seconds:.2f} s end to end; launches {launches}')
    return result, seconds, launches, stages


def epoch_numbers(stages):
    '''The train epoch line of ``run_procedure``'s stages: its seconds and
    batches, ms per step (median) and the prefetch wait (ms per batch,
    median and max; s in all).'''
    m = re.search(r'^([\d.]+) s, (\d+) batches, ([\d.]+) ms/step .*'
                  r'prefetch wait ([\d.]+) ms/batch \(median; max ([\d.]+); '
                  r'([\d.]+) s in all\)', stages['train epoch 0'])
    return {'epoch_s': float(m[1]), 'batches': int(m[2]),
            'step_ms': float(m[3]), 'wait_ms': float(m[4]),
            'wait_max_ms': float(m[5]), 'wait_s': float(m[6])}


def logged(log_path, tag):
    '''The ``tag`` scalars the trainer logged under ``log_path``; they must
    be finite.'''
    with open(os.path.join(log_path, 'metrics.jsonl')) as f:
        values = [r['value'] for r in map(json.loads, f) if r['tag'] == tag]
    check(values and bool(np.isfinite(values).all()), f'{tag}: {values}')
    return values


def read_json(path):
    with open(path) as f:
        return json.load(f)


def loads_back(cfg_argv, ckpt_dir, kind, steps, dev):
    '''best_* loads through the app's loader and last_* with the optimizer's
    state through the trainers' resume; returns the best model's parameter
    count.'''
    if kind == 'cap':
        _, dims, model, _ = load_cap_checkpoint(ckpt_dir, device=dev)
        # the trainer's frozen predicate: nothing frozen at these flags (it
        # always gives one, so the optax layout holds the masked zeroing)
        fresh = captioner_class(dims)(dims, device=dev)
        frozen = (lambda path: False)
    else:
        _, dims, model = load_prop_checkpoint(ckpt_dir, device=dev)
        fresh = proposal_class(dims)(dims, device=dev)
        frozen = prop_frozen(True)
    opt = build_optimizer(Config(build_parser().parse_args(cfg_argv)), fresh,
                          frozen=frozen)
    _, meta, got = load_checkpoint(ckpt_dir, fresh, opt, f'last_{kind}_model')
    check(got is opt and opt.count == steps == meta['step'],
          f'last_{kind}_model: the optimizer state did not load back '
          f'({meta["step"]} steps saved, {opt.count} restored, {steps} run)')
    n = sum(p.numel() for p in model.parameters())
    del model, fresh, opt
    torch.cuda.empty_cache()
    return n


def fp32_copy(cap_dir, dst, impl_flag):
    '''``cap_dir``'s best_cap_model under ``dst``, its config's
    compute_dtype float32 and attention_impl ``impl_flag`` (the params
    linked, not copied): the evaluation decodes as the checkpoint says.'''
    os.makedirs(dst)
    meta = read_checkpoint_meta(cap_dir, 'best_cap_model')
    meta['config'] = {**meta['config'], 'compute_dtype': 'float32',
                      'attention_impl': impl_flag}
    with open(os.path.join(dst, 'best_cap_model.meta.json'), 'w') as f:
        json.dump(meta, f)
    os.symlink(os.path.join(cap_dir, 'best_cap_model.params.npz'),
               os.path.join(dst, 'best_cap_model.params.npz'))
    return dst


def top2_gap(ckpt, tree_argv, vid, start, end, sentence, step, dev):
    '''The top-2 log-prob gap at decode ``step`` along ``sentence``'s
    trajectory, fp32 through plain attention, for the crop [start, end] of
    ``vid`` (B=1).'''
    cfg, _, model, vocab = load_cap_checkpoint(ckpt, device=dev)
    paths = dict(zip(tree_argv[::2], tree_argv[1::2]))
    cfg.video_features_path = paths['--video_features_path']
    cfg.audio_features_path = paths['--audio_features_path']
    duration = read_json(paths['--reference_paths'])[vid]['duration']
    stacks = load_features_from_npy(cfg, ['i3d_features', 'vggish_features'],
                                    vid, start, end, duration, PAD)
    src = {k: torch.from_numpy(stacks[k][None]).to(dev)
           for k in ('rgb', 'flow', 'audio')}
    ids = [START] + vocab.encode(sentence.lower().split())
    trg = torch.tensor([ids[:step + 1]], device=dev)
    with torch.inference_mode():
        masks = make_masks(src, trg, cfg.modality, PAD)
        top = model(src, trg, masks, 'torch')[0, -1].topk(2).values
    del model
    torch.cuda.empty_cache()
    return float(top[0] - top[1])


def compare_captions(subs, ckpt, tree_argv, dev,
                     names=(('pallas', 'kernel'), ('xla', 'plain'))):
    '''The fp32 kernel and plain evaluations' submissions (or the two
    that ``names`` picks: (key, label) pairs): equal captions, or, at the
    first segment whose captions part, the second's trajectory's top-2
    log-prob gap at the first word that differs within TOP2_GAP_TOL.
    Returns (segments, differing segments, that gap or None).'''
    (ka, la), (kb, lb) = names
    a, b = subs[ka]['results'], subs[kb]['results']
    check(a.keys() == b.keys(), 'the fp32 evaluations caption other videos')
    pairs = [(vid, x, y) for vid in a for x, y in zip(a[vid], b[vid])]
    check(all(x['timestamp'] == y['timestamp'] for _, x, y in pairs),
          'the fp32 evaluations caption other segments')
    differ = [(vid, x, y) for vid, x, y in pairs
              if x['sentence'] != y['sentence']]
    gap = None
    if differ:
        vid, x, y = differ[0]
        wx, wy = x['sentence'].lower().split(), y['sentence'].lower().split()
        step = next((i for i, (p, q) in enumerate(zip(wx, wy)) if p != q),
                    min(len(wx), len(wy)))
        gap = top2_gap(ckpt, tree_argv, vid, *y['timestamp'], y['sentence'],
                       step, dev)
        print(f'      first differing segment {vid} {y["timestamp"]}: step '
              f'{step}, {la} {x["sentence"]!r}, {lb} {y["sentence"]!r}; '
              f'top-2 log-prob gap there {gap:.3e} (tol {TOP2_GAP_TOL:.0e})')
        check(gap <= TOP2_GAP_TOL, f'fp32 captions part at step {step} with '
              f'a top-2 gap of {gap}')
    return len(pairs), len(differ), gap


@contextlib.contextmanager
def launch_shapes(seen: collections.Counter):
    '''Count in ``seen`` the (kernel, B, H, Sq, Sk, d, causal, dtype) of
    every kernel launch inside the block: the wrappers' one launch call
    ``_run`` is wrapped (the launch counts are untouched). Its arguments are
    the tensors (q and k first), then B, H, Sq, Sk, d, causal and, for a
    split fp32 forward, the split count.'''
    ops = importlib.import_module('bmt_tpu_torch.ops.flash_attention')
    run = ops._run

    def recording(name, fn, *args):
        q, k = args[0], args[1]
        ints = [a for a in args if type(a) is int]
        seen[(name, *q.shape[:3], k.shape[2], q.shape[3], bool(ints[5]),
              q.dtype)] += 1
        return run(name, fn, *args)
    ops._run = recording
    try:
        yield seen
    finally:
        ops._run = run


# (B, H, Sq, Sk, d, causal, dtype, backward) that check_path_shapes has
# checked in this run: a later phase's launches at the same shape are not
# checked again (a backward check holds the lse forward too)
CHECKED = set()


def check_path_shapes(seen: collections.Counter, dev):
    '''check_kernels at every shape of ``seen`` (launch_shapes) that no
    earlier call checked (CHECKED), in the dtype it was launched in and in
    fp32: the lse forward everywhere, dQ and dK/dV where a backward kernel
    launched at that shape. A B=1 shape gets 3/4 of its keys valid (the
    default masks every key of the last row). Returns ({kernel: max abs
    error}, {kernel: the shape and dtype of it}, checks by dtype).'''
    shapes = {}
    for name, *geom, dtype in seen:
        entry = shapes.setdefault(tuple(geom), [set(), False])
        entry[0].update((dtype, torch.float32))
        entry[1] |= name != KERNEL
    err = {KERNEL: 0.0, KERNEL_DQ: 0.0, KERNEL_DKV: 0.0}
    worst, checks, printed = {}, {}, io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            for i, (geom, (dtypes, backward)) in enumerate(sorted(
                    shapes.items())):
                b, h, sq, sk, d, causal = geom
                case = (f'B={b} H={h} Sq={sq} Sk={sk} d={d}'
                        f'{" causal" if causal else ""}', *geom)
                lengths = (torch.tensor([max(1, 3 * sk // 4)], device=dev)
                           if b == 1 else None)
                for dtype in sorted(dtypes, key=str):
                    if (*geom, dtype, True) in CHECKED or (
                            *geom, dtype, backward) in CHECKED:
                        continue
                    e = check_kernels(case, dtype, dev, 300 + i, 400 + i,
                                      lengths, backward=backward)
                    CHECKED.add((*geom, dtype, backward))
                    key = f'{str(dtype)[6:]}{" +bwd" if backward else ""}'
                    for n, x in e.items():
                        if x > err[n] or n not in worst:
                            err[n] = max(err[n], x)
                            worst[n] = f'{case[0]} {str(dtype)[6:]}'
                    checks[key] = checks.get(key, 0) + 1
    except Exception:
        print(printed.getvalue())
        raise
    return err, worst, checks


HOST_LIBRARIES = ('bmt_io', 'meteor_align')  # csrc/<name>.cc, built by g++
LOADER_ROUNDS = 3                       # 17g: timed passes a loader backend
SCORE_ROUNDS = 2                        # 17g: timed scorings a METEOR path
SCORE_SEGMENTS, SCORE_REFS = 10_000, (1, 5)  # 17g: the learned-props scale


def build_host_library(name):
    '''(seconds, path) of building (or finding) and loading a host
    library.'''
    t0 = time.perf_counter()
    load_host_library(name)
    return time.perf_counter() - t0, str(host_lib_path(name))


@contextlib.contextmanager
def recorded_loads(calls: list):
    '''Append to ``calls`` the arguments of every batch_load the captioning
    and proposal datasets make inside the block (their module attributes
    wrapped; the loads themselves unchanged).'''
    mods = [importlib.import_module(f'bmt_tpu_torch.data.{m}')
            for m in ('captioning', 'proposal_data')]
    loaders = [m.batch_load for m in mods]

    def recording(load):
        def call(paths, starts, ends, durations, full, pad, out_len, cols):
            calls.append((list(paths), list(starts), list(ends),
                          list(durations), list(full), pad, out_len, cols))
            return load(paths, starts, ends, durations, full, pad, out_len,
                        cols)
        return call
    for m, load in zip(mods, loaders):
        m.batch_load = recording(load)
    try:
        yield calls
    finally:
        for m, load in zip(mods, loaders):
            m.batch_load = load


@contextlib.contextmanager
def recorded_meteor_tasks(tasks: list):
    '''Append to ``tasks`` every densevid METEOR request made inside the
    block (``meteor.compute_meteor_corpus_scores``' argument; the scoring
    unchanged).'''
    score = meteor.compute_meteor_corpus_scores

    def call(t):
        tasks.append(t)
        return score(t)
    meteor.compute_meteor_corpus_scores = call
    try:
        yield tasks
    finally:
        meteor.compute_meteor_corpus_scores = score


def score_set(seed=23):
    '''The seeded scoring set: SCORE_SEGMENTS hypotheses with 1-5
    references each, captions of 8-20 words of data/vocab_ref.json drawn
    with p ~ 1 / rank, as phase 17's tree draws them. Returns (gts, res) in
    compute_meteor's form.'''
    words = np.array(Vocab.load(VOCAB_REF).itos[4:], dtype=object)
    zipf = 1.0 / np.arange(1, len(words) + 1)
    zipf /= zipf.sum()
    rng = np.random.default_rng(seed)
    refs = rng.integers(SCORE_REFS[0], SCORE_REFS[1] + 1, SCORE_SEGMENTS)
    lengths = rng.integers(8, 21, SCORE_SEGMENTS + int(refs.sum()))
    # every caption's words in one draw (a draw a caption recomputes the
    # distribution's table each time)
    drawn = words[rng.choice(len(words), int(lengths.sum()), p=zipf)]
    ends = np.cumsum(lengths)
    captions = iter(' '.join(drawn[e - n:e]) for e, n in zip(ends, lengths))
    gts, res = {}, {}
    for k in range(SCORE_SEGMENTS):
        res[k] = [next(captions)]
        gts[k] = [next(captions) for _ in range(refs[k])]
    return gts, res


def alternating_s(fns: dict, rounds: int) -> dict:
    '''{name: [host seconds of each call]} of each function, called in
    turns (a, b, b, a, ...) ``rounds`` times each.'''
    names, out = list(fns), {k: [] for k in fns}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            fns[name]()
            out[name].append(time.perf_counter() - t0)
    return out


def spread(xs, scale=1.0, digits=3):
    '''"median (min-max)" of ``xs`` times ``scale``.'''
    xs = [x * scale for x in xs]
    return (f'{statistics.median(xs):.{digits}f} ({min(xs):.{digits}f}-'
            f'{max(xs):.{digits}f})')


def phase_native_host(builds, served, loads, tasks, epoch, smi, tmp):
    '''17g: the two host libraries on phase 17's tree. (a) their build
    seconds and paths, and what they served in 17a-17d; (b) every loader
    call 17a and 17b made, through the native library and numpy: equal
    arrays and statuses, then LOADER_ROUNDS timed passes of each in turns;
    (c) 17c's METEOR requests and a seeded set of SCORE_SEGMENTS segments
    through the native aligner and the Python one (with its spawn pool at
    that size), in a child process (METEOR_CHILD): equal statistics pair
    for pair and equal scores, and SCORE_ROUNDS timed scorings of each in
    turns. Returns the numbers.'''
    out = {'builds': builds, 'served_17a_17d': served}
    for name, (secs, path) in builds.items():
        print(f'      [17g] {name}: built and loaded in {secs:.2f} s at '
              f'{os.path.relpath(path, REPO)}')
    print(f'      [17g] served in 17a-17d: feature loader {served["loader"]},'
          f' METEOR aligner {served["meteor"]}')
    check(served['loader']['batches'] > 0, 'the native feature loader '
          'served no batch in 17a-17d')
    check(served['meteor']['pairs'] > 0, 'the native METEOR aligner served '
          'no pair in 17a-17d')

    # (b) the loader
    rows = sum(len(c[0]) for c in loads)
    for c in loads:
        got, st = native_io.batch_load(*c, use_native=True)
        want, wst = native_io.batch_load(*c, use_native=False)
        check(np.array_equal(got, want) and np.array_equal(st, wst),
              f'17g: the native loader differs from numpy on {c[0][:2]}')
    before = native_io.served()['batches']

    def load_all(native):
        return lambda: [native_io.batch_load(*c, use_native=native)
                        for c in loads]
    secs = alternating_s({'native': load_all(True),
                          'numpy': load_all(False)}, LOADER_ROUNDS)
    check(native_io.served()['batches'] - before
          == len(loads) * LOADER_ROUNDS, '17g: the native rounds did '
          'not go through the library')
    per_call = {k: [t / len(loads) for t in v] for k, v in secs.items()}
    out['loader'] = {'calls': len(loads), 'rows': rows, 's': secs,
                     'ms_per_call': {k: statistics.median(v) * 1e3
                                     for k, v in per_call.items()},
                     'epoch_17a': epoch}
    print(f'      [17g] loader: {len(loads)} calls of 17a and 17b ({rows} '
          f'rows; each one stream of a batch, (B, L, D) fp32) equal through '
          f'both backends; ms a call, median (min-max) of {LOADER_ROUNDS} '
          f'passes in turns, files in the page cache (warm): native '
          f'{spread(per_call["native"], 1e3)}, numpy '
          f'{spread(per_call["numpy"], 1e3)} ({smi}); 17a on the native '
          f'loader: prefetch wait {epoch["wait_ms"]:.2f} ms/batch (median; '
          f'max {epoch["wait_max_ms"]:.2f}), step interval '
          f'{epoch["step_ms"]:.2f} ms (median)')

    # (c) scoring, in a child process that imports the scorers and no torch
    gts, res = score_set()
    path = os.path.join(tmp, 'meteor_sets.pkl')
    with open(path, 'wb') as f:
        pickle.dump(({'17c': ('videos', tasks),
                      'seeded': ('keys', [(gts, res)])}, SCORE_ROUNDS), f)
    proc = subprocess.run([sys.executable, '-c', METEOR_CHILD, path],
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, f'17g scoring: {proc.stderr[-3000:]}')
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    out['scoring'] = got
    for label, r in got['sets'].items():
        check(r['stats_equal'], f'17g {label}: native and Python METEOR '
              f'statistics differ')
        check(r['scores_equal'], f'17g {label}: the scores differ between '
              f'the paths')
        pooled = r['python_procs'] > 1
        print(f'      [17g] METEOR, {label} ({r["segments"]} segments, '
              f'{r["pairs"]} pairs, {r["requests"]} requests): statistics '
              f'equal pair for pair; s, median (min-max) of {SCORE_ROUNDS} '
              f'in turns: native {spread(r["s"]["native"])}, Python '
              f'{spread(r["s"]["python"])}'
              + (f' with its spawn pool of {r["python_procs"]} (a first '
                 f'scoring that starts the pool {r["python_first_s"]:.2f} s)'
                 if pooled else ' (serial: under the pool\'s '
                 f'{meteor._PARALLEL_MIN_KEYS}-segment threshold)')
              + f' ({smi})')
    check(got['sets']['17c']['segments'] > 0, '17g: 17c scored no segment')
    return out


# 17g's METEOR scorings, run by ``python -c`` with a pickle of {label:
# (kind, requests)} and the rounds: a process that imports the scorers and
# no torch, so the Python aligner's spawn pool re-imports no entry module
# (a trainer's workers would re-import it, torch with it). For each set:
# the statistics of the native and the Python aligner (its pool at that
# size) pair for pair, then the scorer's calls through each in turns;
# prints one JSON line.
METEOR_CHILD = r"""
import dataclasses, json, os, pickle, sys, time
from bmt_tpu_torch.evaluation import meteor


def stats(items, native, procs):
    os.environ['BMT_METEOR_NATIVE'] = '1' if native else '0'
    if native or procs < 2:
        return meteor._batch_best_ref_stats(items)
    step = -(-len(items) // procs)
    parts = [items[i:i + step] for i in range(0, len(items), step)]
    return [st for part in meteor._get_score_pool(procs).map_async(
        meteor._score_chunk, parts).get(timeout=600) for st in part]


with open(sys.argv[1], 'rb') as f:
    sets, rounds = pickle.load(f)
procs = int(os.environ.get('BMT_METEOR_PROCS', min(8, os.cpu_count() or 1)))
out = {}
try:
    for label, (kind, reqs) in sets.items():
        score = (meteor.compute_meteor_corpus_scores if kind == 'videos'
                 else lambda r: meteor.compute_meteor(*r))
        tasks = reqs if kind == 'videos' else [{0: r} for r in reqs]
        items = [(r[k][0], list(g[k])) for t in tasks for g, r in t.values()
                 for k in sorted(g, key=str)]
        # the scorer's own rule: the pool serves a request of that many
        # segments
        largest = max(sum(len(g) for g, _ in t.values()) for t in tasks)
        pool = procs if largest >= meteor._PARALLEL_MIN_KEYS else 1
        native = stats(items, True, pool)
        t0 = time.perf_counter()
        python = stats(items, False, pool)
        first = time.perf_counter() - t0
        secs, results = {'native': [], 'python': []}, []
        for r in range(rounds):
            for name in (('native', 'python') if r % 2 == 0
                         else ('python', 'native')):
                os.environ['BMT_METEOR_NATIVE'] = str(int(name == 'native'))
                t0 = time.perf_counter()
                results.append([score(q) for q in reqs])
                secs[name].append(time.perf_counter() - t0)
        out[label] = {
            'segments': len(items), 'requests': len(reqs),
            'pairs': sum(len(refs) for _, refs in items),
            'stats_equal': [dataclasses.astuple(x) for x in native]
            == [dataclasses.astuple(x) for x in python],
            'scores_equal': all(r == results[0] for r in results),
            's': secs, 'python_first_s': first, 'python_procs': pool}
finally:
    meteor._shutdown_score_pool()
print(json.dumps({'sets': out}))
"""


def start_profiled_train_cap(tree_argv, log_dir):
    '''train_cap once more in a child process (python -m bmt_tpu_torch; a
    fresh torch.profiler, as sessions repeated in this process lose their
    device events) with --profile_steps over the whole epoch and no 1-by-1
    decode, started now (17f: beside 17b-17e) and read by
    ``profiled_train_cap``; killed at exit if still running.'''
    argv = [sys.executable, '-m', 'bmt_tpu_torch', '--procedure',
            'train_cap', *tree_argv, *CLI_FLAGS, *CAP_FLAGS,
            '--one_by_one_starts_at', '1', '--profile_steps', '6',
            '--log_dir', log_dir, '--exper_name', 'profiled', '--device',
            str(DEVICE)]
    os.makedirs(log_dir, exist_ok=True)
    out, err = (open(os.path.join(log_dir, f'child.{x}'), 'w+')
                for x in ('out', 'err'))
    proc = subprocess.Popen(argv, cwd=REPO, stdout=out, stderr=err,
                            text=True)
    atexit.register(lambda: proc.poll() is None and (proc.kill(),
                                                     proc.wait()))
    return proc, out, err


def profiled_train_cap(child):
    '''Wait for ``start_profiled_train_cap``'s child. Returns (the
    profiler's line, the epoch's [time] line).'''
    proc, out, err = child
    rc = proc.wait(timeout=600)
    texts = []
    for f in (out, err):
        f.seek(0)
        texts.append(f.read())
        f.close()
    check(rc == 0, f'profiled train_cap: {texts[1][-3000:]}')
    prof = [x for x in texts[1].splitlines() if x.startswith('[profile]')]
    epoch = [x for x in texts[0].splitlines()
             if x.startswith('[time] train epoch 0')]
    check(prof and epoch, 'profiled train_cap printed no profile or epoch')
    return prof[-1], epoch[-1]


def phase_main_procedures(dev, smi, tmp, host_builds=None):
    '''main.py's train_cap -> train_prop -> evaluate through the port's CLI
    on a synthetic ActivityNet tree under ``tmp`` (see the module
    docstring); the checkpoints stay there for phases 18-20. 17g measures
    the host libraries on what 17a-17c loaded and scored (``host_builds``:
    {name: (build s, path)} from phase 2, built here when None). Returns
    ({procedure: launches}, {procedure: numbers for the report}, the
    captioner's checkpoint directory, the proposal generator's, the tree's
    command-line flags, the launch shapes).'''
    if host_builds is None:
        host_builds = {n: build_host_library(n) for n in HOST_LIBRARIES}
    loads, tasks = [], []
    native_io.reset_served()
    meteor_native.reset_served()
    t0 = time.perf_counter()
    tree = write_anet_tree(os.path.join(tmp, 'data'))
    print(f'    tree: {ANET_TRAIN} train + {ANET_VAL} validation videos '
          f'written in {time.perf_counter() - t0:.2f} s')
    log = os.path.join(tmp, 'log')
    common = tree + CLI_FLAGS + ['--log_dir', log]
    cap_dir = os.path.join(log, 'train_cap', 'cap')
    prop_dir = os.path.join(log, 'train_prop', 'prop')
    launches, report, shapes = {}, {}, collections.Counter()

    print(f'    [17a] train_cap {" ".join(CAP_FLAGS)} ({smi}):')
    cap_argv = ['--procedure', 'train_cap', *common, *CAP_FLAGS,
                '--exper_name', 'cap']
    with recorded_loads(loads):
        best, secs, launches['train_cap'], stages = run_procedure(
            cap_argv, dev, shapes)
    check(checkpoint_exists(cap_dir, 'best_cap_model'),
          'train_cap wrote no best_cap_model')
    loss = logged(cap_dir, 'debug/train_loss_epoch')
    meta = read_json(os.path.join(cap_dir, 'last_cap_model.meta.json'))
    val = [meta['val_1_loss'], meta['val_2_loss']]
    check(bool(np.isfinite(val).all()), f'validation losses {val}')
    n = loads_back(cap_argv, cap_dir, 'cap', meta['step'], dev)
    print(f'      train loss {loss}, validation losses {val}, best '
          f'METEOR {best}; {meta["step"]} steps; both checkpoints load '
          f'back ({n} parameters; last_cap_model with its optimizer)')
    report['train_cap'] = {'s': secs, **epoch_numbers(stages),
                           'stages': stages}
    torch.cuda.empty_cache()
    # 17f's profiled train_cap runs beside 17b-17e in a child process
    profiled = start_profiled_train_cap(tree, os.path.join(tmp, 'plog'))

    print(f'    [17b] train_prop {" ".join(PROP_FLAGS)}, the encoder from '
          f'best_cap_model, frozen ({smi}):')
    prop_argv = ['--procedure', 'train_prop', *common, *PROP_FLAGS,
                 '--exper_name', 'prop', '--pretrained_cap_model_path',
                 cap_dir]
    with recorded_loads(loads):
        f1, secs, launches['train_prop'], stages = run_procedure(
            prop_argv, dev, shapes)
    check(checkpoint_exists(prop_dir, 'best_prop_model'),
          'train_prop wrote no best_prop_model')
    loss = logged(prop_dir, 'debug/loss_epoch')
    steps = read_json(os.path.join(prop_dir,
                                   'last_prop_model.meta.json'))['step']
    n = loads_back(prop_argv, prop_dir, 'prop', steps, dev)
    for name in os.listdir(prop_dir):     # their GB are not needed on
        if name.startswith('last_prop_model'):
            os.remove(os.path.join(prop_dir, name))
    print(f'      train loss {loss}, F1 {f1}; {steps} steps; both '
          f'checkpoints load back ({n} parameters; last_prop_model with '
          f'its optimizer)')
    report['train_prop'] = {'s': secs, **epoch_numbers(stages),
                            'stages': stages}
    torch.cuda.empty_cache()

    props = os.path.join(prop_dir, 'submissions',
                         'prop_results_val_1_e0_maxprop100.json')
    ev_argv = ['--procedure', 'evaluate', *common,
               '--prop_pred_path', props]
    print(f'    [17c] evaluate (bf16 through the kernel, as '
          f'best_cap_model says) at 4 tIoUs ({smi}):')
    with recorded_meteor_tasks(tasks):
        metrics, secs, launches['evaluate'], stages = run_procedure(
            ev_argv + ['--pretrained_cap_model_path', cap_dir], dev, shapes)
    avg = metrics['Average across tIoUs']
    print('      scores (average over tIoUs): ' + ', '.join(
        f'{k} {avg[k]:.6f}' for k in ('METEOR', 'Bleu_4', 'Bleu_3',
                                      'Precision', 'Recall')))
    check(all(np.isfinite(v) for v in avg.values()),
          f'evaluate scores {avg}')
    report['evaluate'] = {'s': secs, 'stages': stages,
                          'scores': {k: avg[k] for k in (
                              'METEOR', 'Bleu_4', 'Bleu_3', 'Precision',
                              'Recall')}}
    total = {k: sum(c[k] for c in launches.values())
             for k in (KERNEL, KERNEL_DQ, KERNEL_DKV)}
    check(all(total.values()), f'a kernel never launched on the three '
          f'procedures: {total}')
    torch.cuda.empty_cache()

    print('    [17d] evaluate again in fp32 from the same checkpoints, '
          'through --attention_impl pallas and xla:')
    subs, ckpt = {}, None
    for flag in ('pallas', 'xla'):
        ckpt = fp32_copy(cap_dir, os.path.join(tmp, f'fp32_{flag}'), flag)
        _, _, counts, _ = run_procedure(
            ev_argv + ['--pretrained_cap_model_path', ckpt], dev, shapes)
        check((counts[KERNEL] > 0) == (flag == 'pallas'),
              f'the fp32 {flag} evaluation launched {counts}')
        subs[flag] = read_json(os.path.join(
            ckpt, 'captioning_results_learned_props_e0.json'))
    segs, differ, gap = compare_captions(subs, ckpt, tree, dev)
    print(f'      fp32 captions, kernel vs plain: {segs - differ} of '
          f'{segs} segments equal')
    report['fp32_captions'] = {'segments': segs, 'differ': differ,
                               'top2_gap': gap}
    served = {'loader': native_io.served(), 'meteor': meteor_native.served()}
    torch.cuda.empty_cache()

    print(f'    [17e] the kernels against their plain versions at every '
          f'shape 17a-17d launched them, in that dtype and in fp32 '
          f'({len(shapes)} launch shapes):')
    check({s[0] for s in shapes} == {KERNEL, KERNEL_DQ, KERNEL_DKV},
          f'launch shapes recorded for {sorted({s[0] for s in shapes})}')
    err, worst, checks = check_path_shapes(shapes, dev)
    print(f'      checks by dtype {checks} all within TOL, LSE_TOL and '
          f'BWD_TOL; max_abs_err by kernel ' + ', '.join(
              f'{n} {err[n]:.3e} ({worst.get(n, "no new shape")})'
              for n in err))
    report['path_shapes'] = {'launch_shapes': len(shapes),
                             'checks': checks, 'max_abs_err': err,
                             'at': worst}
    torch.cuda.empty_cache()

    print('    [17f] train_cap profiled in a child process (python -m '
          'bmt_tpu_torch, --profile_steps 6, no 1-by-1), beside 17b-17e:')
    prof, epoch = profiled_train_cap(profiled)
    print(f'      {prof}\n      {epoch}')
    m = re.search(r'([\d.]+) ms/step over (\d+) steps in ([\d.]+) ms',
                  prof)
    device_ms, n = float(m[1]), int(m[2])
    # the device time is the union of the kernels' intervals; their sum
    # and the streams beside it
    u = re.search(r'the union of (\d+) kernels\' intervals on (\d+) '
                  r'streams, their sum ([\d.]+) ms/step', prof)
    check(u is not None, f'17f: no union in the profile line: {prof}')
    # the busy share over 17a's epoch, which ran without the profiler;
    # the traced run's own wall time also holds the profiler's host work
    plain = report['train_cap']
    busy = device_ms * plain['batches'] / (1e3 * plain['epoch_s'])
    report['profiled_train_cap'] = {
        'device_ms_per_step': device_ms, 'steps': n,
        'kernels': int(u[1]), 'streams': int(u[2]),
        'summed_ms_per_step': float(u[3]),
        'traced_wall_ms': float(m[3]),
        'busy_of_17a_epoch': busy,
        'busy_of_17a_median_step': device_ms / plain['step_ms'],
        'device_over_traced_wall': device_ms * n / float(m[3])}
    print(f'      device busy {100 * busy:.1f}% of 17a\'s unprofiled epoch '
          f'({device_ms:.3f} ms a step, traced beside 17b-17e (contended), '
          f'as the union of {u[1]} kernels\' '
          f'intervals on {u[2]} streams, {u[3]} summed, x '
          f'{plain["batches"]} in '
          f'{plain["epoch_s"]:.3f} s; '
          f'{100 * device_ms / plain["step_ms"]:.1f}% of its median step); '
          f'{100 * device_ms * n / float(m[3]):.1f}% of the traced run\'s '
          f'wall, which holds the profiler\'s own host work ({smi})')

    print('    [17g] the host libraries (csrc/bmt_io.cc, csrc/meteor_align.cc) '
          'on what 17a-17c loaded and scored:')
    report['native_host'] = phase_native_host(
        host_builds, served, loads, tasks, report['train_cap'], smi, tmp)
    return launches, report, cap_dir, prop_dir, tree, shapes


# ---------------------------------------------------------------------------
# the serving API
# ---------------------------------------------------------------------------

SERVE_REQUESTS = 64                     # concurrent POST /caption requests
# ragged requests: video rows 8-48 (20-123 s of I3D), audio rows 20-128
SERVE_ROWS = ((8, 49), (20, 129))
LORA_RANK = 8
BEAM = 4
SAMPLE = {'temperature': 1.0, 'top_k': 50, 'top_p': 0.9}
# bf16 serving: a request decoded in a coalesced batch and alone runs the
# same math at other shapes (batch rows, bucket lengths), whose bf16
# products may round apart. Where two sentences part, the alone run's top-2
# log-prob gap at the first word that differs must be a near-tie at bf16's
# resolution: a logit of |z| <= 16 rounds to 2^-8 |z| = 0.0625
BF16_GAP_TOL = 0.0625
# one 3 s window a scenario keeps the script inside its time with phase 19
SERVE_BENCH_ENV = {'SERVE_BENCH_T_LOAD': '3', 'SERVE_BENCH_WINDOWS': '1'}


def http(url, payload=None, timeout=300):
    '''(status, JSON reply) of a GET, or of a POST of ``payload`` (bytes of
    JSON).'''
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, data=payload, headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def request_crop(rng, dims):
    '''One ragged request as a client sends it: features rounded to 3
    decimals (short JSON), and the fp32 arrays the server parses from it.'''
    sv = int(rng.integers(*SERVE_ROWS[0]))
    sa = int(rng.integers(*SERVE_ROWS[1]))
    feats = {k: np.round(rng.normal(size=(n, d)), 3) for k, n, d in (
        ('rgb', sv, dims.d_vid), ('flow', sv, dims.d_vid),
        ('audio', sa, dims.d_aud))}
    body = json.dumps({'features': {k: v.tolist()
                                    for k, v in feats.items()}}).encode()
    return body, {k: v.astype(np.float32) for k, v in feats.items()}


def first_gap(engine, crop, alone, served):
    '''The top-2 log-prob gap of the alone run (B=1, the engine's model and
    path) at the first token where the served sentence ``served`` parts
    from the alone one's tokens ``alone``.'''
    words = served.lower().split()
    ids = [engine.vocab.stoi.get(w, 0) for w in words]
    step = next((i for i, t in enumerate(alone[1:]) if i >= len(ids)
                 or t != ids[i]), len(ids))
    batch = engine._pad_batch([crop], 1, bucket_len(crop['rgb'].shape[0],
                                                    VIDEO_BUCKETS),
                              bucket_len(crop['audio'].shape[0],
                                         AUDIO_BUCKETS))
    trg = torch.tensor([alone[:step + 1].tolist()], device=engine.device)
    with torch.inference_mode():
        masks = make_masks(batch, trg, 'audio_video', engine.pad_idx)
        lp = engine.model(batch, trg, masks, engine.attention_impl)
        top = lp[0, -1].float().topk(2).values
    return step, float(top[0] - top[1])


def decode_strategies(engine, q8, x, impl):
    '''{strategy: fn() -> (B, STEPS + 1) tokens} at the decode cell, all
    with end_idx -1, through ``impl``.'''
    model = engine.model
    args = (x, STEPS, START, -1, PAD)

    def adapter():
        with apply_adapter(engine.adapters['tuned']):
            return greedy_decode_bimodal(model, *args, impl)
    def gc_off():
        gc.disable()
        try:
            return greedy_decode_bimodal(model, *args, impl)
        finally:
            gc.enable()
    return {
        'greedy': lambda: greedy_decode_bimodal(model, *args, impl),
        'greedy_gc_off': gc_off,
        f'beam{BEAM}': lambda: beam_search_bimodal(model, *args, BEAM, 0.0,
                                                   impl)[0],
        'sample': lambda: sample_decode_bimodal(model, x, 0, STEPS, START,
                                                -1, PAD, **SAMPLE,
                                                attention_impl=impl),
        'kv_int8': lambda: greedy_decode_bimodal(model, *args, impl,
                                                 kv_int8=True),
        'weights_int8': lambda: greedy_decode_bimodal(q8, *args, impl),
        'lora': adapter}


def first_step_err(model, ref_model, x, kv_int8):
    '''Max abs difference of the first decode step's log-probs of ``model``
    (with ``kv_int8``) and of ``ref_model`` (unquantized), fp32.'''
    cur = torch.full((x['audio'].shape[0], 1), START, device=x['audio'].device)
    lps = []
    with torch.inference_mode():
        for m, kv in ((model, kv_int8), (ref_model, False)):
            state, step_fn, _ = bimodal_step_setup(m, x, PAD, STEPS,
                                                   'kernel', kv)
            lps.append(step_fn(state, cur, 0)[0])
    return (lps[0] - lps[1]).abs().max().item()


def phase_serving(dev, smi, cap_dir, prop_dir, tmp):
    '''The serving API at full width from phase 17's checkpoints (see the
    module docstring). Returns (the launches of 18a's requests, numbers for
    the report).'''
    report, shapes = {}, collections.Counter()
    _, dims, base, _ = load_cap_checkpoint(cap_dir, device=dev)   # fp32
    g = torch.Generator(device=dev).manual_seed(18)
    lora = {}
    for name, scale in (('tuned', 0.1), ('zero', 0.0)):
        adapted = add_lora(copy.deepcopy(base), LORA_RANK, g,
                           targets='attn_ffn')
        with torch.no_grad():
            for m in adapted.modules():
                if has_lora(m):
                    m.lora_b.normal_(0.0, 1.0, generator=g).mul_(scale)
        lora[name] = os.path.join(tmp, f'lora_{name}.npz')
        n_sites = save_lora_npz(lora[name], adapted)
        del adapted
    print(f'    rank-{LORA_RANK} attn_ffn adapters of the captioner '
          f'({n_sites} linears each) written by save_lora_npz: lora_b '
          f'~ N(0, 0.1^2) (tuned) and zeros (zero)')

    print(f'    [18a] python -m bmt_tpu_torch.scripts.serve (bf16, '
          f'--attention_impl pallas, --lora_adapter tuned, /predict), '
          f'{SERVE_REQUESTS} concurrent /caption requests and two /predict '
          f'videos ({smi}):')
    rng = np.random.default_rng(18)
    requests = [request_crop(rng, dims) for _ in range(SERVE_REQUESTS)]
    videos = []
    for _, sv, sa, seconds in PROP_VIDEOS:
        feats = {k: np.round(rng.normal(size=(n, d)), 3) for k, n, d in (
            ('rgb', sv, dims.d_vid), ('flow', sv, dims.d_vid),
            ('audio', sa, dims.d_aud))}
        videos.append((json.dumps({'features': {
            k: v.tolist() for k, v in feats.items()},
            'duration': seconds}).encode(),
            {k: v.astype(np.float32) for k, v in feats.items()}, seconds))
    mb = sum(len(b) for b, _ in requests) / 2 ** 20
    torch.cuda.synchronize()
    reset_launch_counts()
    with launch_shapes(shapes):
        t0 = time.perf_counter()
        server = serve_cli.main([
            '--pretrained_cap_model_path', cap_dir,
            '--prop_generator_model_path', prop_dir, '--attention_impl',
            'pallas', '--port', '0', '--device', str(dev),
            '--lora_adapter', f'tuned={lora["tuned"]}'], block=False)
        start_s = time.perf_counter() - t0
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = f'http://127.0.0.1:{server.server_address[1]}'
        try:
            engine = server.engine
            before = engine.stats()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(SERVE_REQUESTS) as pool:
                replies = list(pool.map(
                    lambda r: http(f'{url}/caption', r[0]), requests))
            caption_s = time.perf_counter() - t0
            after = engine.stats()
            t0 = time.perf_counter()
            predicted = [http(f'{url}/predict', body) for body, _, _ in videos]
            predict_s = time.perf_counter() - t0
            stats = http(f'{url}/stats')[1]
            health = http(f'{url}/healthz')
            torch.cuda.synchronize()
            launches = launch_counts()
            check(all(code == 200 for code, _ in replies + predicted),
                  f'non-200 replies: {[r for r in replies + predicted if r[0] != 200][:3]}')
            check(health == (200, {'status': 'ok'}), f'/healthz {health}')
            n_batches = after['batches'] - before['batches']
            n_req = after['requests'] - before['requests']
            check(n_req == SERVE_REQUESTS and n_batches < SERVE_REQUESTS,
                  f'{n_req} requests in {n_batches} batches')
            check(launches[KERNEL] >= 8 * n_batches,
                  f'{launches} kernel launches for {n_batches} caption '
                  f'batches')
            print(f'      server up in {start_s:.2f} s (checkpoints loaded, '
                  f'a rank-{LORA_RANK} adapter, bucket grid warmed); '
                  f'{SERVE_REQUESTS} requests ({mb:.1f} MB of JSON) '
                  f'answered 200 in {caption_s:.3f} s, coalesced into '
                  f'{n_batches} batches (avg {n_req / n_batches:.1f}); '
                  f'latency p50/p95/p99 {stats["latency_ms"]}; two /predict '
                  f'in {predict_s:.3f} s ({[len(r[1]["results"]) for r in predicted]} '
                  f'segments); launches {launches}')

            # each sentence against the engine's on the same crop alone
            differ, worst = 0, 0.0
            for (body, crop), (_, reply) in zip(requests, replies):
                alone = engine.caption_tokens([crop])[0]
                sentence = ints_to_sentence(alone, engine.vocab,
                                            engine.end_token)
                if reply['sentence'] != sentence:
                    differ += 1
                    step, gap = first_gap(engine, crop, alone,
                                          reply['sentence'])
                    worst = max(worst, gap)
                    print(f'      parts from the alone decode at step {step}:'
                          f' top-2 gap {gap:.3e}')
            check(worst <= BF16_GAP_TOL, f'a served sentence parts from the '
                  f'alone decode at a top-2 gap of {worst}')
            for (_, feats, seconds), (_, reply) in zip(videos, predicted):
                want = server.pipeline.predict(feats, seconds)
                check(reply['results'] == want and want,
                      '/predict differs from VideoPipeline.predict')
            print(f'      sentences equal to engine.caption_crops([crop]) '
                  f'alone: {SERVE_REQUESTS - differ} of {SERVE_REQUESTS} '
                  f'(the rest near-ties, top-2 gap <= {worst:.3e}, tol '
                  f'{BF16_GAP_TOL}); /predict equal to VideoPipeline.predict')
            engine.add_adapter('zero', load_lora_sites(lora['zero']))
            crops = [c for _, c in requests[:16]]
            plain = engine.caption_tokens(crops, _count=False)
            check(np.array_equal(plain, engine.caption_tokens(
                crops, _count=False, adapter='zero')),
                'the zero adapter changes the base tokens')
            tuned = engine.caption_tokens(crops, _count=False,
                                          adapter='tuned')
            print(f'      zero adapter: the base tokens; tuned adapter: '
                  f'{int((tuned != plain).any(1).sum())} of 16 captions '
                  f'differ from the base')
            report['requests'] = {
                'n': SERVE_REQUESTS, 'batches': n_batches, 'caption_s':
                caption_s, 'predict_s': predict_s, 'start_s': start_s,
                'latency_ms': stats['latency_ms'], 'json_mb': mb,
                'differ_alone': differ, 'worst_gap': worst}

            print(f'    [18b] decode strategies at the decode cell (bf16, '
                  f'B={B}, Sa={SA}, Sv={SV}, {STEPS} steps, end_idx=-1), '
                  f'captions/s through kernel and torch, medians of 3 '
                  f'alternating runs [min, max] ({smi}):')
            x16 = features(g, B, SV, SA, dims, dev, torch.bfloat16)
            q8 = quantize_tree_int8(copy.deepcopy(engine.model))
            report['gc_tracked_objects'] = len(gc.get_objects())
            print(f'      ({report["gc_tracked_objects"]} objects tracked by '
                  f'Python\'s garbage collector; greedy_gc_off runs with it '
                  f'disabled)')
            runs = {impl: decode_strategies(engine, q8, x16, impl)
                    for impl in ('kernel', 'torch')}
            report['strategies'] = {}
            for name in runs['kernel']:
                times = {'kernel': [], 'torch': []}
                for impl in ('torch', 'kernel', 'torch', 'kernel', 'kernel',
                             'torch', 'torch', 'kernel'):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = runs[impl][name]()
                    torch.cuda.synchronize()
                    times[impl].append(time.perf_counter() - t0)
                    check(out.shape == (B, STEPS + 1),
                          f'{name} decode shape {out.shape}')
                peak = {}
                for impl in ('kernel', 'torch'):
                    resident = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    runs[impl][name]()
                    torch.cuda.synchronize()
                    peak[impl] = (torch.cuda.max_memory_allocated()
                                  - resident) / 2 ** 30
                cps = {impl: {'median': B / statistics.median(t[1:]),
                              'min': B / max(t[1:]), 'max': B / min(t[1:])}
                       for impl, t in times.items()}       # t[0]: warmup
                report['strategies'][name] = {
                    'captions_per_s': cps, 'peak_above_resident_gb': peak,
                    'resident_gb': resident / 2 ** 30}
                print(f'      {name:13s} kernel {cps["kernel"]["median"]:7.1f} '
                      f'[{cps["kernel"]["min"]:.1f}, {cps["kernel"]["max"]:.1f}]'
                      f', torch {cps["torch"]["median"]:7.1f} '
                      f'[{cps["torch"]["min"]:.1f}, {cps["torch"]["max"]:.1f}]'
                      f'; peak above the resident {resident / 2 ** 30:.2f} GB: '
                      f'kernel {peak["kernel"]:.3f} GB, torch '
                      f'{peak["torch"]:.3f} GB')
            del q8, runs, x16
        finally:
            server.shutdown()
    torch.cuda.empty_cache()

    print(f'    [18c] fp32 on the card: the {SERVE_REQUESTS} requests '
          f'coalesced by a MicroBatcher against each alone; decoders at '
          f'B={B}, Sa={SA}, Sv={SV}, {STEPS} steps, end_idx=-1, kernel:')
    engine32 = CaptionEngine(base, engine.vocab, max_len=engine.max_len)
    check((engine32.start_idx, engine32.end_idx, engine32.pad_idx) == (
        engine.start_idx, engine.end_idx, engine.pad_idx), 'special tokens')
    batcher = MicroBatcher(engine32, max_wait_ms=5.0)
    try:
        futs = [batcher.submit(c) for _, c in requests]
        served = [f.result(timeout=300) for f in futs]
    finally:
        batcher.close()
    differ32, gap32 = 0, 0.0
    for (_, crop), sentence in zip(requests, served):
        alone = engine32.caption_tokens([crop], _count=False)[0]
        if sentence != ints_to_sentence(alone, engine32.vocab,
                                        engine32.end_token):
            differ32 += 1
            gap32 = max(gap32, first_gap(engine32, crop, alone, sentence)[1])
    check(gap32 <= TOP2_GAP_TOL, f'an fp32 coalesced sentence parts from '
          f'its alone decode at a top-2 gap of {gap32}')
    print(f'      {SERVE_REQUESTS - differ32} of {SERVE_REQUESTS} coalesced '
          f'sentences ({engine32.stats()["batches"]} batches) equal to their '
          f'alone decode; the rest part at top-2 gaps <= {gap32:.3e} (tol '
          f'{TOP2_GAP_TOL:.0e})')
    report['fp32_coalesced'] = {'differ': differ32, 'worst_gap': gap32,
                                'batches': engine32.stats()['batches']}
    del engine32
    x = features(g, B, SV, SA, dims, dev)
    args = (x, STEPS, START, -1, PAD, 'kernel')
    greedy = greedy_decode_bimodal(base, *args)
    beam1 = beam_search_bimodal(base, *args[:5], 1, 0.0, 'kernel')[0]
    top1 = sample_decode_bimodal(base, x, 3, STEPS, START, -1, PAD,
                                 top_k=1, attention_impl='kernel')
    check(torch.equal(beam1, greedy), 'beam K=1 differs from greedy')
    check(torch.equal(top1, greedy), 'top-k 1 sampling differs from greedy')
    kv8 = greedy_decode_bimodal(base, *args, kv_int8=True)
    w8 = quantize_tree_int8(copy.deepcopy(base))
    w8_toks = greedy_decode_bimodal(w8, *args)
    quant = {'kv_int8': {'equal_tokens': (kv8 == greedy).float().mean()
                         .item(), 'first_step_err': first_step_err(
                             base, base, x, True)},
             'weights_int8': {'equal_tokens': (w8_toks == greedy).float()
                              .mean().item(), 'first_step_err':
                              first_step_err(w8, base, x, False)}}
    del w8
    torch.cuda.empty_cache()
    print(f'      beam K=1 == greedy, top-k 1 sampling == greedy; against '
          f'the unquantized greedy: ' + '; '.join(
              f'{k} {100 * v["equal_tokens"]:.1f}% of tokens equal, first '
              f'step log-probs max_abs_err {v["first_step_err"]:.3e}'
              for k, v in quant.items()))
    report['fp32'] = quant

    print(f'    [18d] the forward kernel against its plain version at every '
          f'shape 18a-18b launched it, in that dtype and in fp32 '
          f'({len(shapes)} launch shapes; those an earlier phase checked '
          f'are not checked again):')
    check({s[0] for s in shapes} == {KERNEL},
          f'launch shapes recorded for {sorted({s[0] for s in shapes})}')
    err, worst_at, checks = check_path_shapes(shapes, dev)
    print(f'      checks by dtype {checks} within TOL and LSE_TOL; '
          f'max_abs_err {err[KERNEL]:.3e} '
          f'({worst_at.get(KERNEL, "no new shape")})')
    report['path_shapes'] = {'launch_shapes': len(shapes), 'checks': checks,
                             'max_abs_err': err[KERNEL],
                             'at': worst_at.get(KERNEL)}
    del base
    torch.cuda.empty_cache()

    print(f'    [18e] python -m bmt_tpu_torch.scripts.serve_bench '
          f'({" ".join(f"{k}={v}" for k, v in SERVE_BENCH_ENV.items())}; '
          f'{smi}):')
    env = dict(os.environ, **SERVE_BENCH_ENV, SERVE_BENCH_DEVICE=str(dev),
               PYTHONPATH=REPO)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-m',
                           'bmt_tpu_torch.scripts.serve_bench'], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0, f'serve_bench: {proc.stderr[-3000:]}')
    bench = json.loads(proc.stdout.strip().splitlines()[-1])
    for label in ('concurrent_base', 'multi_tenant'):
        check(bench[f'{label}_completed'] > 0, f'serve_bench {label} '
              f'completed nothing')
    print(f'      ({time.perf_counter() - t0:.1f} s) {json.dumps(bench)}')
    report['serve_bench'] = bench
    return launches, report


# ---------------------------------------------------------------------------
# main.py's model and decode options
# ---------------------------------------------------------------------------

LORA_FLAGS = ['--lora_rank', str(LORA_RANK), '--lora_targets', 'attn_ffn']
MOE_EXPERTS, MOE_AUX_COEFF = 4, 0.01     # --moe_experts, --moe_aux_coeff
MOE_FLAGS = ['--moe_experts', str(MOE_EXPERTS), '--optim_mu_dtype',
             'bfloat16']
# evaluate's decode options, each run alone from 19b's best_cap_model;
# greedy first, the baseline of the others' seconds
EVAL_OPTIONS = {
    'evaluate_greedy': [],
    'evaluate_beam_kv_int8': ['--decode_strategy', 'beam', '--beam_size',
                              str(BEAM), '--kv_cache_int8'],
    'evaluate_sample': ['--decode_strategy', 'sample', '--sample_top_k',
                        str(SAMPLE['top_k']), '--sample_top_p',
                        str(SAMPLE['top_p'])],
    'evaluate_weights_int8': ['--weights_int8'],
}
OPTION_ROWS = (4, 70, 180)               # 19d's decode batch: B, Sv, Sa


def params_npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def adam_prefix(opt):
    '''The key prefix of Adam's state (count, mu, nu) in an optimizer file
    of the optax layout (``train.optim.optax_layout``).'''
    found = [k[:-2] for k, v in opt.items()
             if k.endswith('/0') and v.ndim == 0
             and any(j.startswith(k[:-2] + '/1/') for j in opt)]
    check(len(found) == 1, f'no single Adam state in the optimizer file: '
          f'{found}')
    return found[0]


def lora_run_checks(lora_dir, base_dir):
    '''19a: every base leaf of the LoRA run's last and best weights is bit
    for bit its seed's (phase 17's best_cap_model) and every adapter's B
    has left zero. Returns the number of adapted linears.'''
    base = params_npz(os.path.join(base_dir, 'best_cap_model.params.npz'))
    sites = 0
    for name in ('last_cap_model', 'best_cap_model'):
        got = params_npz(os.path.join(lora_dir, f'{name}.params.npz'))
        adapters = {k for k in got if k.rsplit('/', 1)[-1] in (
            'lora_a', 'lora_b', 'lora_s')}
        check(set(got) - adapters == set(base),
              f'{name}: the LoRA run saved other base leaves')
        changed = [k for k in base if not np.array_equal(got[k], base[k])]
        check(not changed, f'{name}: LoRA training changed base leaves '
              f'{changed[:3]}')
        still = [k for k in adapters if k.endswith('lora_b')
                 and not np.any(got[k])]
        check(not still, f'{name}: adapters that never moved {still[:3]}')
        sites = len(adapters) // 3
    return sites


def serve_lora_adapter(dev, base_dir, lora_npz, rng, dims):
    '''19a: scripts.serve.main with --lora_adapter ft=<the run's
    best_cap_model.lora.npz> on the base checkpoint answers two /caption
    requests through the adapter and one without. Returns (adapted linears
    it loaded, the three sentences).'''
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        server = serve_cli.main([
            '--pretrained_cap_model_path', base_dir, '--attention_impl',
            'pallas', '--port', '0', '--device', str(dev), '--lora_adapter',
            f'ft={lora_npz}', '--warmup_batches', '1', '--max_batch', '8'],
            block=False)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{server.server_address[1]}'
    try:
        replies = []
        for adapter in ('ft', 'ft', None):
            body = json.loads(request_crop(rng, dims)[0])
            if adapter:
                body['adapter'] = adapter
            replies.append(http(f'{url}/caption', json.dumps(body).encode()))
    finally:
        server.shutdown()
        server.server_close()
    check(all(code == 200 for code, _ in replies),
          f'/caption through the adapter: {replies}')
    loaded = re.search(r"adapter 'ft': (\d+) adapted linears",
                       printed.getvalue())
    check(loaded is not None, 'scripts.serve did not load the adapter')
    return int(loaded[1]), [next(iter(r.values())) for _, r in replies]


def moe_aux_in_loss(moe_dir, dev):
    '''19b: one bf16 train step (lr 0) of the trained MoE captioner with the
    aux weighted by MOE_AUX_COEFF and one with it off, from the same seed
    and step: the first loss exceeds the second by coeff x the mean aux
    times the batch's share of tokens (0 < gap <= coeff E). Returns (the
    two losses, the encoder-then-decoder aux list of a train-mode forward,
    fp32).'''
    _, dims, model, _ = load_cap_checkpoint(moe_dir, device=dev)
    batch = train_batch(19, 8, SV, SA, TSC, dims)
    losses = []
    for coeff in (MOE_AUX_COEFF, 0.0):
        state = init_train_state(model, build_optimizer(
            types.SimpleNamespace(**{**vars(TRAIN_CFG), 'lr': 0.0}), model))
        step = make_cap_train_step(dims, SMOOTHING, PAD, 'kernel',
                                   compute_dtype=torch.bfloat16,
                                   moe_aux_coeff=coeff)
        losses.append(step(state, batch)[1]['loss'].item())
    src = {k: torch.from_numpy(v).to(dev) for k, v in batch['src'].items()}
    trg = torch.from_numpy(batch['caption'][:, :-1]).long().to(dev)
    aux = []
    with torch.no_grad():
        model.train()
        model(src, trg, make_masks(src, trg, 'audio_video', PAD), 'kernel',
              aux_out=aux)
    check(len(aux) == 2 * dims.N and all(torch.isfinite(a) for a in aux),
          f'aux list {aux}')
    del model
    torch.cuda.empty_cache()
    return losses, [a.item() for a in aux]


def cached_vs_uncached(model, x):
    '''19d and 20b: fp32 greedy decode of a captioner (bi-modal or
    uni-modal, its MoE FFNs one token at a time, lossless) KV-cached and
    uncached (the teacher-forced forward over the prefix at every step),
    both through plain attention with no end token. Returns (rows equal,
    the largest top-2 log-prob gap at a row's first differing step or
    None).'''
    modality = model.dims.modality
    cached = make_bimodal_greedy_fn(model.dims, STEPS, START, -1, PAD,
                                    'torch')(model, x)
    uncached = greedy_decode_uncached(
        lambda s, t, m: model(s, t, m, 'torch'), x, STEPS, START, -1, PAD,
        modality)
    same = (cached == uncached).all(dim=1)
    gap = None
    for r in (~same).nonzero().flatten().tolist():
        step = int((cached[r] != uncached[r]).nonzero()[0])
        row = {k: v[r:r + 1] for k, v in x.items()}
        trg = uncached[r:r + 1, :step]
        with torch.inference_mode():
            masks = make_masks(row, trg, modality, PAD)
            top = model(row, trg, masks, 'torch')[0, -1].topk(2).values
        gap = max(gap or 0.0, float(top[0] - top[1]))
    return int(same.sum()), gap


def int8_levels_on_card(model, dev):
    '''19f: the int8 weights and scales of the model's generator (the
    10,172 x 300 head), the int8 levels and scales of a batch of its
    inputs, and the int8 cross K/V of a (B, H, S, d_k) K, on the card and
    the CPU from the same tensors: equal bit for bit. Returns the number of
    values compared.'''
    w = model.generator.weight.detach()
    g = torch.Generator().manual_seed(19)
    x = torch.randn(B, STEPS, w.shape[1], generator=g)
    k = torch.randn(B, 4, SA, 256, generator=g) * 3
    n = 0
    for fn, t in ((quantize_linear_int8, w.cpu()), (quantize_rows_int8, x),
                  (_quantize_per_channel, k)):
        for a, b in zip(fn(t), fn(t.to(dev))):
            check(torch.equal(a, b.cpu()),
                  f'{fn.__name__}: int8 levels or scales of shape '
                  f'{tuple(a.shape)} differ between the card and the CPU')
            n += a.numel()
    return n


def phase_main_py_options(dev, smi, tmp, tree, cap_dir, prop_dir, full):
    '''main.py's model and decode options through the port's CLI on phase
    17's tree and checkpoints (see the module docstring). ``full``: phase
    17's report, for its dense train_cap's ms per step. Returns
    ({run: launches}, numbers for the report).'''
    log = os.path.join(tmp, 'log')
    common = tree + CLI_FLAGS + ['--log_dir', log]
    launches, report, shapes = {}, {}, collections.Counter()
    cap_argv = ['--procedure', 'train_cap', *common, *CAP_FLAGS]

    print(f'    [19a] train_cap {" ".join(LORA_FLAGS)} from phase 17\'s '
          f'best_cap_model ({smi}):')
    lora_dir = os.path.join(log, 'train_cap', 'lora')
    best, secs, launches['train_cap_lora'], stages = run_procedure(
        cap_argv + ['--exper_name', 'lora', '--pretrained_cap_model_path',
                    cap_dir, *LORA_FLAGS], dev, shapes)
    check(all(launches['train_cap_lora'].values()),
          f'the LoRA run launched {launches["train_cap_lora"]}')
    lora_npz = os.path.join(lora_dir, 'best_cap_model.lora.npz')
    check(os.path.exists(lora_npz), 'train_cap --lora_rank wrote no '
          'best_cap_model.lora.npz')
    sites = lora_run_checks(lora_dir, cap_dir)
    meta = read_checkpoint_meta(cap_dir, 'best_cap_model')
    dims = CapModelDims.from_config(Config.from_dict(meta['config']),
                                    len(meta['vocab_itos']))
    served, sentences = serve_lora_adapter(dev, cap_dir, lora_npz,
                                           np.random.default_rng(19), dims)
    check(served == sites, f'scripts.serve loaded {served} adapted linears '
          f'of {sites}')
    numbers = epoch_numbers(stages)
    print(f'      base leaves bit for bit phase 17\'s, {sites} adapters '
          f'(B moved off zero); best METEOR {best}; {served} adapters '
          f'served through scripts.serve: {sentences}; step '
          f'{numbers["step_ms"]:.2f} ms against the full step\'s '
          f'{full["train_cap"]["step_ms"]:.2f} ms (17a)')
    report['train_cap_lora'] = {'s': secs, 'meteor': best,
                                'adapted_linears': sites, **numbers,
                                'full_step_ms_17a': full['train_cap'][
                                    'step_ms'], 'stages': stages}
    torch.cuda.empty_cache()

    print(f'    [19b] train_cap {" ".join(MOE_FLAGS)} ({smi}):')
    moe_dir = os.path.join(log, 'train_cap', 'moe')
    best, secs, launches['train_cap_moe'], stages = run_procedure(
        cap_argv + ['--exper_name', 'moe', *MOE_FLAGS], dev, shapes)
    check(all(launches['train_cap_moe'].values()),
          f'the MoE run launched {launches["train_cap_moe"]}')
    check(checkpoint_exists(moe_dir, 'best_cap_model'),
          'the MoE train_cap wrote no best_cap_model')
    loss = logged(moe_dir, 'debug/train_loss_epoch')
    opt = params_npz(os.path.join(moe_dir, 'last_cap_model.opt.npz'))
    mu = [v for k, v in opt.items()
          if k.startswith(adam_prefix(opt) + '/1/')]
    check(mu and all(np.array_equal(v, torch.from_numpy(v).bfloat16()
                                    .float().numpy()) for v in mu),
          'the saved first moment is not bf16')
    (with_aux, without), aux = moe_aux_in_loss(moe_dir, dev)
    gap = with_aux - without
    check(0 < gap <= MOE_AUX_COEFF * MOE_EXPERTS,
          f'the MoE loss does not carry the aux: {with_aux} with, '
          f'{without} without')
    numbers = epoch_numbers(stages)
    print(f'      train loss {loss}, best METEOR {best}; a step\'s loss '
          f'{with_aux:.6f} with the aux ({MOE_AUX_COEFF}) and {without:.6f} '
          f'without; aux by layer {[round(a, 4) for a in aux]}; the first '
          f'moment saved bf16 ({len(mu)} tensors); step '
          f'{numbers["step_ms"]:.2f} ms against the dense step\'s '
          f'{full["train_cap"]["step_ms"]:.2f} ms (17a)')
    report['train_cap_moe'] = {'s': secs, 'meteor': best, 'loss': loss,
                               'step_loss_with_aux': with_aux,
                               'step_loss_without_aux': without,
                               'aux': aux, **numbers, 'stages': stages}
    torch.cuda.empty_cache()

    props = os.path.join(prop_dir, 'submissions',
                         'prop_results_val_1_e0_maxprop100.json')
    ev_argv = ['--procedure', 'evaluate', *common, '--prop_pred_path',
               props]
    print(f'    [19c] evaluate 19b\'s best_cap_model (bf16, the kernel) with '
          f'each decode option ({smi}):')
    for name, flags in EVAL_OPTIONS.items():
        metrics, secs, launches[name], stages = run_procedure(
            ev_argv + ['--pretrained_cap_model_path', moe_dir, *flags], dev,
            shapes)
        check(launches[name][KERNEL] > 0, f'{name} launched {launches[name]}')
        avg = metrics['Average across tIoUs']
        check(all(np.isfinite(v) for v in avg.values()),
              f'{name} scores {avg}')
        scores = {k: avg[k] for k in ('METEOR', 'Bleu_4', 'Bleu_3',
                                      'Precision', 'Recall')}
        print(f'      {" ".join(flags) or "greedy"}: {secs:.2f} s; '
              + ', '.join(f'{k} {v:.6f}' for k, v in scores.items()))
        report[name] = {'s': secs, 'scores': scores, 'stages': stages}
    torch.cuda.empty_cache()

    print('    [19d] fp32: the MoE captioner\'s cached greedy decode against '
          'the uncached one, and evaluate through pallas and xla:')
    _, dims, model, _ = load_cap_checkpoint(moe_dir, device=dev)
    b, sv, sa = OPTION_ROWS
    x = features(torch.Generator(device=dev).manual_seed(19), b, sv, sa,
                 dims, dev)
    x['rgb'][1, sv // 2:] = PAD
    x['flow'][1, sv // 2:] = 0.0
    x['audio'][1, sa // 3:] = PAD
    equal, gap = cached_vs_uncached(model, x)
    print(f'      cached == uncached greedy in {equal} of {b} rows '
          f'({STEPS} steps); largest top-2 gap where they part: {gap}')
    check(gap is None or gap <= TOP2_GAP_TOL,
          f'cached and uncached MoE decodes part at a gap of {gap}')
    n_int8 = int8_levels_on_card(model, dev)
    del model
    torch.cuda.empty_cache()
    subs, ckpt = {}, None
    for flag in ('pallas', 'xla'):
        ckpt = fp32_copy(moe_dir, os.path.join(tmp, f'moe_fp32_{flag}'),
                         flag)
        _, _, counts, _ = run_procedure(
            ev_argv + ['--pretrained_cap_model_path', ckpt], dev, shapes)
        check((counts[KERNEL] > 0) == (flag == 'pallas'),
              f'the fp32 {flag} MoE evaluation launched {counts}')
        subs[flag] = read_json(os.path.join(
            ckpt, 'captioning_results_learned_props_e0.json'))
    segs, differ, top2 = compare_captions(subs, ckpt, tree, dev)
    print(f'      fp32 MoE captions, kernel vs plain: {segs - differ} of '
          f'{segs} segments equal')
    report['fp32_moe'] = {'cached_equals_uncached_rows': [equal, b],
                          'cached_uncached_gap': gap, 'segments': segs,
                          'differ': differ, 'top2_gap': top2}
    torch.cuda.empty_cache()

    print(f'    [19e] the kernels against their plain versions at every '
          f'shape 19a-19d launched them ({len(shapes)} launch shapes; those '
          f'an earlier phase checked are not checked again):')
    check({s[0] for s in shapes} == {KERNEL, KERNEL_DQ, KERNEL_DKV},
          f'launch shapes recorded for {sorted({s[0] for s in shapes})}')
    err, worst, checks = check_path_shapes(shapes, dev)
    print(f'      checks by dtype {checks} all within TOL, LSE_TOL and '
          f'BWD_TOL; max_abs_err by kernel ' + ', '.join(
              f'{n} {err[n]:.3e} ({worst.get(n, "no new shape")})'
              for n in err))
    report['path_shapes'] = {'launch_shapes': len(shapes), 'checks': checks,
                             'max_abs_err': err, 'at': worst}

    print(f'    [19f] int8 levels on the card and the CPU: {n_int8} weights, '
          f'activation levels, K/V levels and their scales equal bit for '
          f'bit')
    report['int8_values_equal'] = n_int8
    return launches, report


# ---------------------------------------------------------------------------
# the uni-modal models and the acceptance chain
# ---------------------------------------------------------------------------

# the audio captioner (d_model 128) at train_cap's lr 5e-5 writes no word of
# a reference after its one epoch's 6 steps (METEOR 0 on the H100, so no
# best_cap_model); at 3e-4 it writes the frequent ones, as the others do
UNI_LR = {'video': [], 'audio': ['--lr', '3e-4']}
# the bundled women_long_jump video's length and rows (I3D at 2.56 s a row,
# VGGish at 0.96 s): its stand-in features are drawn from a seed
SAMPLE_SECONDS, SAMPLE_ROWS = 35.155, {'rgb': 14, 'flow': 14, 'vggish': 37}


def most_launched(shapes, keep):
    '''((B, H, Sq, Sk, d, causal), launches) of the shape with the most
    launches (all kernels, all dtypes) among those of ``shapes`` that
    ``keep`` accepts; None when it accepts none.'''
    count = collections.Counter()
    for (_, *geom, _), n in shapes.items():
        if keep(tuple(geom)):
            count[tuple(geom)] += n
    return count.most_common(1)[0] if count else None


def unimodal_kernel_times(shapes, seen17, smi, dev):
    '''20d: each kernel's times (kernel_times, bf16) at the most-launched
    d = 32 shape, at the d = 32 shape of the most work (B H Sq Sk), and at
    the most-launched d = 256 shape phase 17 did not launch (else the
    most-launched d = 256 one). Returns {label: times}.'''
    old = {tuple(geom) for _, *geom, _ in seen17}
    picks = {'d=32': most_launched(shapes, lambda g: g[4] == 32)}
    d32 = [tuple(geom) for _, *geom, _ in shapes if geom[4] == 32]
    if d32:
        big = max(d32, key=lambda g: g[0] * g[1] * g[2] * g[3])
        picks['d=32 most work'] = most_launched(shapes, lambda g: g == big)
    new = most_launched(shapes, lambda g: g[4] == 256 and g not in old)
    picks['d=256 new' if new else 'd=256'] = new or most_launched(
        shapes, lambda g: g[4] == 256)
    check(all(picks.values()), f'launch shapes at d = 32 and 256: {picks}')
    out = {}
    for label, (geom, n) in picks.items():
        b, h, sq, sk, d, causal = geom
        case = (f'B={b} H={h} Sq={sq} Sk={sk} d={d}'
                f'{" causal" if causal else ""}', *geom)
        t = kernel_times(case, dev, dtype=torch.bfloat16)
        # each kernel's launches at this shape in 20a-20b, all dtypes
        each = {kname: sum(c for (k, *g, _), c in shapes.items()
                           if k == kname and tuple(g) == geom)
                for kname in (KERNEL, KERNEL_DQ, KERNEL_DKV)}
        print(f'      {label} at {case[0]} ({n} launches in 20a-20b; '
              f'bf16, {smi}):')
        for kname in (KERNEL, KERNEL_DQ, KERNEL_DKV):
            print(f'        {kname:20s} ' + times_line('', t[kname])
                  + f'; {each[kname]} launches in 20a-20b')
        out[label] = {'shape': case[0], 'launches': n, **{
            kname: {**{k: t[kname][k] for k in ('kernel', 'plain', 'library',
                                                'bound', 'bound_by')},
                    'launches': each[kname]}
            for kname in (KERNEL, KERNEL_DQ, KERNEL_DKV)}}
    return out


def run_acceptance(tmp, tree, cap_dir, prop_dir, dev):
    '''20e: scripts.acceptance's main on phase 17's checkpoints, the sample
    stage against a golden from one direct run of the port's app on seeded
    stand-in features. Returns (the report, seconds, launches).'''
    rng = np.random.default_rng(20)
    sample_dir = os.path.join(tmp, 'sample')
    os.makedirs(sample_dir)
    for name, width in (('rgb', 1024), ('flow', 1024), ('vggish', 128)):
        np.save(os.path.join(sample_dir, f'women_long_jump_{name}.npy'),
                rng.standard_normal((SAMPLE_ROWS[name], width), np.float32))
    paths = dict(zip(tree[::2], tree[1::2]))
    args = types.SimpleNamespace(train_meta_path=paths['--train_meta_path'],
                                 device=str(dev))
    bootstrap = os.path.join(tmp, 'bootstrap_sample.json')
    with open(bootstrap, 'w') as f:
        f.write('[]')
    golden = acceptance.run_sample(args, cap_dir, prop_dir, sample_dir,
                                   bootstrap, SAMPLE_SECONDS,
                                   os.path.join(tmp, 'golden'))
    check(golden.get('predicted'), f'the app\'s golden run: {golden}')
    expected = os.path.join(tmp, 'expected_sample.json')
    with open(expected, 'w') as f:
        json.dump(golden['predicted'], f)
    report_path = os.path.join(tmp, 'acceptance_report.json')
    argv = ['--procedure', 'evaluate', *tree,
            '--pretrained_cap_model_path', cap_dir,
            '--pretrained_prop_model_path', prop_dir,
            '--log_dir', os.path.join(tmp, 'acc_log'),
            '--sample_dir', sample_dir, '--expected_sample', expected,
            '--sample_duration', str(SAMPLE_SECONDS),
            '--report_path', report_path, '--device', str(dev)]
    printed = io.StringIO()
    torch.cuda.synchronize()
    reset_launch_counts()
    with contextlib.redirect_stdout(printed):
        rc, seconds = synced(lambda: acceptance.main(argv))
    launches = launch_counts()
    for line in printed.getvalue().splitlines():
        if line.startswith(('  ', 'OVERALL')):
            print(f'      {line.strip()}')
    report = read_json(report_path)
    check(rc == 0, f'acceptance exited {rc}: {report}')
    return report, seconds, launches


def phase_unimodal(dev, smi, tmp, tree, cap_dir, prop_dir, seen17):
    '''The uni-modal models and the acceptance chain on phase 17's tree and
    checkpoints (see the module docstring). ``seen17``: phase 17's launch
    shapes. Returns ({'unimodal', 'acceptance': launches}, numbers for the
    report).'''
    log = os.path.join(tmp, 'log')
    common = tree + CLI_FLAGS + ['--log_dir', log]
    runs, report, shapes = {}, {}, collections.Counter()
    uni = {m: os.path.join(log, 'train_cap', f'uni_{m}')
           for m in ('video', 'audio')}

    def procedure(name, argv):
        result, secs, launches, stages = run_procedure(argv, dev, shapes)
        runs[name] = launches
        report[name] = {'s': secs, 'launches': launches, 'stages': stages}
        return result

    for modality, d_k in (('video', 256), ('audio', 32)):
        name = f'train_cap_{modality}'
        print(f'    [20a] train_cap --modality {modality} (d_k = {d_k}) '
              f'{" ".join(CAP_FLAGS + UNI_LR[modality])} ({smi}):')
        argv = ['--procedure', 'train_cap', *common, *CAP_FLAGS,
                *UNI_LR[modality], '--modality', modality, '--exper_name',
                f'uni_{modality}']
        best = procedure(name, argv)
        check(all(runs[name].values()),
              f'{modality} train_cap launched {runs[name]}')
        check(checkpoint_exists(uni[modality], 'best_cap_model'),
              f'{modality} train_cap wrote no best_cap_model')
        loss = logged(uni[modality], 'debug/train_loss_epoch')
        meta = read_json(os.path.join(uni[modality],
                                      'last_cap_model.meta.json'))
        n = loads_back(argv, uni[modality], 'cap', meta['step'], dev)
        report[name].update(meteor=best, loss=loss, parameters=n,
                            **epoch_numbers(report[name]['stages']))
        print(f'      train loss {loss}, best METEOR {best}; {meta["step"]} '
              f'steps; both checkpoints load back ({n} parameters; '
              f'last_cap_model with its optimizer)')
        torch.cuda.empty_cache()

    print(f'    [20a] train_prop --modality audio {" ".join(PROP_FLAGS)}, '
          f'the encoder from the audio best_cap_model, frozen ({smi}):')
    prop_argv = ['--procedure', 'train_prop', *common, *PROP_FLAGS,
                 '--modality', 'audio', '--exper_name', 'uni_prop',
                 '--pretrained_cap_model_path', uni['audio']]
    uni_prop = os.path.join(log, 'train_prop', 'uni_prop')
    f1 = procedure('train_prop_audio', prop_argv)
    check(checkpoint_exists(uni_prop, 'best_prop_model'),
          'the audio train_prop wrote no best_prop_model')
    loss = logged(uni_prop, 'debug/loss_epoch')
    steps = read_json(os.path.join(uni_prop,
                                   'last_prop_model.meta.json'))['step']
    n = loads_back(prop_argv, uni_prop, 'prop', steps, dev)
    prop_params = params_npz(os.path.join(uni_prop,
                                          'best_prop_model.params.npz'))
    cap_params = params_npz(os.path.join(uni['audio'],
                                         'best_cap_model.params.npz'))
    enc = [k for k in prop_params if k.startswith('encoder/')]
    check(enc and all(np.array_equal(prop_params[k], cap_params[k])
                      for k in enc),
          'the audio proposal encoder is not the captioner\'s, frozen')
    report['train_prop_audio'].update(f1=f1, loss=loss, parameters=n,
                                      **epoch_numbers(
                                          report['train_prop_audio'][
                                              'stages']))
    print(f'      train loss {loss}, F1 {f1}; {steps} steps; the encoder '
          f'bit for bit the captioner\'s; both checkpoints load back ({n} '
          f'parameters)')
    torch.cuda.empty_cache()

    props = os.path.join(uni_prop, 'submissions',
                         'prop_results_val_1_e0_maxprop100.json')
    ev_argv = ['--procedure', 'evaluate', *common, '--prop_pred_path', props]
    print(f'    [20a] evaluate the audio captioner on those proposals (bf16, '
          f'the kernel) at 4 tIoUs ({smi}):')
    metrics = procedure('evaluate_audio', ev_argv + [
        '--pretrained_cap_model_path', uni['audio']])
    avg = metrics['Average across tIoUs']
    check(all(np.isfinite(v) for v in avg.values()), f'scores {avg}')
    report['evaluate_audio']['scores'] = {
        k: avg[k] for k in ('METEOR', 'Bleu_4', 'Bleu_3', 'Precision',
                            'Recall')}
    print('      scores (average over tIoUs): ' + ', '.join(
        f'{k} {v:.6f}' for k, v in report['evaluate_audio']['scores']
        .items()))
    unimodal = {k: sum(c[k] for c in runs.values())
                for k in (KERNEL, KERNEL_DQ, KERNEL_DKV)}
    check(all(unimodal.values()), f'a kernel never launched in 20a: '
          f'{unimodal}')
    torch.cuda.empty_cache()

    b, sv, sa = OPTION_ROWS
    print(f'    [20b] fp32: cached against uncached greedy decode of each '
          f'modality (B={b}, {STEPS} steps, plain attention), then the '
          f'audio evaluation through pallas and xla:')
    for modality in ('video', 'audio'):
        _, dims, model, _ = load_cap_checkpoint(uni[modality], device=dev)
        x = features(torch.Generator(device=dev).manual_seed(20), b, sv, sa,
                     dims, dev)
        x['rgb'][1, sv // 2:] = PAD
        x['flow'][1, sv // 2:] = 0.0
        x['audio'][1, sa // 3:] = PAD
        x = {k: v for k, v in x.items()
             if (k == 'audio') == (modality == 'audio')}
        equal, gap = cached_vs_uncached(model, x)
        print(f'      {modality}: cached == uncached in {equal} of {b} rows; '
              f'largest top-2 gap where they part: {gap}')
        check(gap is None or gap <= TOP2_GAP_TOL,
              f'{modality}: cached and uncached decodes part at a gap of '
              f'{gap}')
        report[f'fp32_cached_{modality}'] = {'equal_rows': [equal, b],
                                             'gap': gap}
        del model
        torch.cuda.empty_cache()
    subs, ckpt = {}, None
    for flag in ('pallas', 'xla'):
        ckpt = fp32_copy(uni['audio'], os.path.join(tmp, f'uni_fp32_{flag}'),
                         flag)
        _, _, counts, _ = run_procedure(
            ev_argv + ['--pretrained_cap_model_path', ckpt], dev, shapes)
        check((counts[KERNEL] > 0) == (flag == 'pallas'),
              f'the fp32 {flag} audio evaluation launched {counts}')
        epoch = read_checkpoint_meta(ckpt, 'best_cap_model')['epoch']
        subs[flag] = read_json(os.path.join(
            ckpt, f'captioning_results_learned_props_e{epoch}.json'))
    segs, differ, gap = compare_captions(subs, ckpt, tree, dev)
    print(f'      fp32 audio captions, kernel vs plain: {segs - differ} of '
          f'{segs} segments equal')
    report['fp32_captions_audio'] = {'segments': segs, 'differ': differ,
                                     'top2_gap': gap}
    torch.cuda.empty_cache()

    print(f'    [20c] the kernels against their plain versions at every '
          f'shape 20a-20b launched them ({len(shapes)} launch shapes; those '
          f'an earlier phase checked are not checked again):')
    d32 = {s[0] for s in shapes if s[5] == 32}
    check(d32 == {KERNEL, KERNEL_DQ, KERNEL_DKV},
          f'the kernels launched at d = 32: {sorted(d32)}')
    err, worst, checks = check_path_shapes(shapes, dev)
    print(f'      checks by dtype {checks} all within TOL, LSE_TOL and '
          f'BWD_TOL; max_abs_err by kernel ' + ', '.join(
              f'{n} {err[n]:.3e} ({worst.get(n, "no new shape")})'
              for n in err))
    report['path_shapes'] = {
        'launch_shapes': len(shapes),
        'd32_shapes': len({tuple(s[1:7]) for s in shapes if s[5] == 32}),
        'checks': checks, 'max_abs_err': err, 'at': worst}
    torch.cuda.empty_cache()

    print('    [20d] kernel times at the uni-modal shapes:')
    report['kernel_times'] = unimodal_kernel_times(shapes, seen17, smi, dev)

    print(f'    [20e] python -m bmt_tpu_torch.scripts.acceptance on phase '
          f'17\'s bi-modal checkpoints ({smi}):')
    acc, secs, acc_launches = run_acceptance(tmp, tree, cap_dir, prop_dir,
                                             dev)
    stages = acc['stages']
    want = {'md5': 'SKIP', 'import': 'PASS', 'gt_val': 'PASS',
            'learned_props': 'PASS', 'sample': 'PASS'}
    got = {k: v['status'] for k, v in stages.items()}
    check(got == want and acc['overall'] == 'PASS',
          f'acceptance stages {got}, overall {acc["overall"]}')
    check(acc_launches[KERNEL] > 0, f'acceptance launched {acc_launches}')
    print(f'      -> {secs:.2f} s end to end; launches {acc_launches}')
    report['acceptance'] = {
        's': secs, 'launches': acc_launches, 'stages': got,
        'gt_val_meteor': [stages['gt_val']['measured_avg_meteor'],
                          stages['gt_val']['embedded_avg_meteor']],
        'learned_props_meteor': stages['learned_props'][
            'learned_props_meteor'],
        'sample_segments': len(stages['sample']['predicted'])}
    return {'unimodal': unimodal, 'acceptance': acc_launches}, report



# ---------------------------------------------------------------------------
# export_decode, Adam's moments across the packages, data parallelism
# ---------------------------------------------------------------------------

EXPORT_CASES = (('kernel', torch.bfloat16), ('kernel', torch.float32),
                ('torch', torch.float32))
EXPORT_ROUNDS = 2                       # timed decodes a path: 2 x this
DP = 2                                  # ranks, or engine replicas
DP_STEPS = 3                            # Adam steps of the dp parity
# the one card holds both ranks: NCCL refuses two ranks on one device, so
# the group runs on gloo, named (through host copies of the collectives)
DP_BACKEND = 'gloo'
# 21b's runs: train_cap epochs with no 1-by-1 decode
MOMENT_FLAGS = ['--one_by_one_starts_at', '9']
# 21c's train_cap over DP ranks: 17a's global batch of 32, B=16 a rank
DP_CAP_FLAGS = ['--B', str(32 // DP), '--one_by_one_starts_at', '0']


def sync():
    '''Wait for the card (the spawned ranks call this too).'''
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def tree_to(tree, dev, dtype):
    '''A JAX-layout tree of numpy arrays as tensors on ``dev`` in
    ``dtype``.'''
    if isinstance(tree, dict):
        return {k: tree_to(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev, dtype) for v in tree]
    return torch.from_numpy(np.asarray(tree)).to(dev, dtype)


def live_model(dims, tree, dev, dtype):
    model = BiModalTransformer(dims, device=dev)
    load_jax_params(model, tree)
    return model.to(dtype).eval()


def sentence_ids(row):
    '''A decoded row up to and with its first END.'''
    row = row.tolist()
    return row[:row.index(END) + 1] if END in row[1:] else row


def trajectory_gap(model, x, tokens, impl, row, step):
    '''The top-2 log-prob gap of ``row`` at decode ``step`` along the
    batch's own trajectory ``tokens`` (the live decode's).'''
    with torch.inference_mode():
        state, step_fn, _ = bimodal_step_setup(model, x, PAD, STEPS, impl)
        for i in range(step + 1):
            lp, state = step_fn(state, tokens[:, i:i + 1], i)
    top = lp[row].float().topk(2).values
    return float(top[0] - top[1])


def export_worker(dev, cap_dir, dims, impl, dtype, shape, out_path):
    '''21a's export of one case, in a child process (the three cases
    export side by side: tracing runs on the host): export_decode of phase
    17's best_cap_model in ``dtype`` at ``shape`` (B, Sv, Sa, steps), the
    blob written to ``out_path``. Returns the export's seconds.'''
    dev = torch.device(dev)
    params = tree_to(load_params_npz(os.path.join(
        cap_dir, 'best_cap_model.params.npz')), dev, dtype)
    b, sv, sa, steps = shape
    t0 = time.perf_counter()
    blob = export_decode(params, dims, b, sv, sa, steps, START, END, PAD,
                         impl, device=dev)
    seconds = time.perf_counter() - t0
    with open(out_path, 'wb') as f:
        f.write(blob)
    return seconds


def start_exports(dev, cap_dir, tmp):
    '''21a's exports, started in child processes (the host traces them,
    beside 21b-21d); ``phase_export`` waits for them.'''
    paths = {f'{impl} {str(dtype)[6:]}': os.path.join(
        tmp, f'decode_{impl}_{str(dtype)[6:]}.pt2')
        for impl, dtype in EXPORT_CASES}
    pool = ProcessPoolExecutor(len(EXPORT_CASES),
                               mp_context=mp.get_context('spawn'))
    futures = {name: pool.submit(export_worker, str(dev), cap_dir,
                                 CapModelDims(voc_size=VOC), impl, dtype,
                                 (B, SV, SA, STEPS), paths[name])
               for name, (impl, dtype) in zip(paths, EXPORT_CASES)}
    return {'pool': pool, 'futures': futures, 'paths': paths,
            't0': time.perf_counter()}


def phase_export(dev, smi, cap_dir, seen, exports):
    '''21a: export_decode at the decode cell (B, SA, SV, STEPS), the
    exports started by ``start_exports``, replayed from bytes with phase
    17's best_cap_model and a seeded parameter set against the live
    decode. Returns ({case: numbers}, the replays' forward launches).'''
    dims = CapModelDims(voc_size=VOC)
    paths = exports['paths']
    with exports['pool']:
        export_s = {name: f.result()
                    for name, f in exports['futures'].items()}
    print(f'      {len(paths)} exports side by side in child processes, '
          f'beside 21b-21d: {time.perf_counter() - exports["t0"]:.2f} s of '
          f'wall time from their start to the last one\'s end')
    trees = {'phase 17': load_params_npz(os.path.join(
                 cap_dir, 'best_cap_model.params.npz')),
             'seeded': to_jax_tree(BiModalTransformer(
                 dims, device=dev,
                 generator=torch.Generator(device=dev).manual_seed(21)))}
    g = torch.Generator(device=dev).manual_seed(21)
    x32 = features(g, B, SV, SA, dims, dev)
    x32['rgb'][1, 60:] = PAD
    x32['flow'][1, 60:] = 0.0
    x32['audio'][1, 150:] = PAD
    report, launches = {}, dict.fromkeys((KERNEL, KERNEL_DQ, KERNEL_DKV), 0)
    for impl, dtype in EXPORT_CASES:
        name = f'{impl} {str(dtype)[6:]}'
        xs = {k: v.to(dtype) for k, v in x32.items()}
        params = {k: tree_to(t, dev, dtype) for k, t in trees.items()}
        with open(paths[name], 'rb') as f:
            blob = f.read()
        os.remove(paths[name])
        t0 = time.perf_counter()
        replay = load_exported_decode(blob)
        load_s = time.perf_counter() - t0
        out = {'bytes': len(blob), 'export_s': export_s[name],
               'load_s': load_s}
        for pname, p in params.items():
            model = live_model(dims, trees[pname], dev, dtype)
            live = greedy_decode_bimodal(model, xs, STEPS, START, END, PAD,
                                         impl)
            reset_launch_counts()
            with launch_shapes(seen):
                got = replay(p, xs)
            sync()
            counts = launch_counts()
            for k in launches:
                launches[k] += counts[k]
            check((counts[KERNEL] > 0) == (impl == 'kernel')
                  and not counts[KERNEL_DQ] and not counts[KERNEL_DKV],
                  f'{name} replay launched {counts}')
            check(got.shape == live.shape, f'{name}: replay {got.shape}')
            if dtype == torch.float32:
                check(torch.equal(got, live), f'{name} ({pname}): the '
                      f'replay\'s tokens are not the live decode\'s')
                worst, differ = 0.0, 0
            else:
                rows = [r for r in range(B) if sentence_ids(got[r])
                        != sentence_ids(live[r])]
                differ, worst = len(rows), 0.0
                for r in rows:
                    j = next(i for i, (a, b) in enumerate(zip(
                        got[r].tolist(), live[r].tolist())) if a != b)
                    worst = max(worst, trajectory_gap(model, xs, live, impl,
                                                      r, j - 1))
                check(worst <= BF16_GAP_TOL, f'{name} ({pname}): a replayed '
                      f'sentence parts from the live one at a top-2 gap of '
                      f'{worst}')
            stop = int((live != END).any(0).nonzero().max())
            out[pname] = {'launches': counts[KERNEL], 'rows_differ': differ,
                          'worst_gap': worst, 'live_steps': stop}
            del model
        model = live_model(dims, trees['phase 17'], dev, dtype)
        fns = {'live': lambda: greedy_decode_bimodal(
                   model, xs, STEPS, START, END, PAD, impl),
               'replay': lambda: replay(params['phase 17'], xs)}
        for fn in fns.values():
            fn()
        times = {'live': [], 'replay': []}
        for path in ('live', 'replay', 'replay', 'live') * EXPORT_ROUNDS:
            sync()
            t0 = time.perf_counter()
            fns[path]()
            sync()
            times[path].append(time.perf_counter() - t0)
        cps = {k: B / statistics.median(v) for k, v in times.items()}
        out['captions_per_s'] = cps
        report[name] = out
        print(f'      {name}: blob {len(blob)} bytes, export '
              f'{export_s[name]:.2f} '
              f's, load {load_s:.2f} s; replay == live: phase 17\'s '
              f'weights {B - out["phase 17"]["rows_differ"]} of {B} rows '
              f'({out["phase 17"]["live_steps"]} live steps), seeded '
              f'{B - out["seeded"]["rows_differ"]} of {B}'
              f'{" (bit for bit)" if dtype == torch.float32 else ""}; '
              f'forward launches in the replay '
              f'{out["phase 17"]["launches"]}; captions/s replay '
              f'{cps["replay"]:.1f} vs live {cps["live"]:.1f} (median of '
              f'{2 * EXPORT_ROUNDS}; {smi})')
        del replay, blob, model, params, fns
        torch.cuda.empty_cache()
    return report, launches


def earlier_port_layout(run_dir, name='last_cap_model'):
    '''Rewrite ``run_dir``'s optimizer file in the layout an earlier port
    wrote: {name}.torch_opt.npz (per parameter its torch state in the torch
    layout, keyed state/<key>/<path>; the count, lr and notfinite scalars)
    and ``torch_opt`` in the meta; the captioner's '/w' leaves are its
    linears' weights, transposed.'''
    opt_path = os.path.join(run_dir, f'{name}.opt.npz')
    opt = params_npz(opt_path)
    meta_path = os.path.join(run_dir, f'{name}.meta.json')
    meta = read_json(meta_path)
    adam = adam_prefix(opt)
    count = int(opt[f'{adam}/0'])
    out = {'count': np.int64(count),
           'lr': np.float64(meta['config']['lr']),
           'notfinite': np.int64(0)}
    for part, key in (('1', 'exp_avg'), ('2', 'exp_avg_sq')):
        prefix = f'{adam}/{part}/'
        for k, v in opt.items():
            if k.startswith(prefix):
                path = k[len(prefix):]
                out[f'state/{key}/{path}'] = (v.T if path.endswith('/w')
                                              else v)
                out[f'state/step/{path}'] = np.float32(count)
    np.savez(os.path.join(run_dir, f'{name}.torch_opt.npz'), **out)
    os.remove(opt_path)
    with open(meta_path, 'w') as f:
        json.dump({**meta, 'torch_opt': True}, f)
    return count


def phase_moments(dev, smi, tmp, tree, seen):
    '''21b: train_cap for two epochs straight, and one epoch resumed for a
    second through the shared .opt.npz, and through an earlier port's
    .torch_opt.npz; the resumed runs' last_cap_model equals the straight
    one's bit for bit. Returns ({run: launches}, numbers).'''
    log = os.path.join(tmp, 'mlog')
    base = ['--procedure', 'train_cap', *tree, *CLI_FLAGS, *CAP_FLAGS,
            *MOMENT_FLAGS, '--log_dir', log]
    runs = {n: os.path.join(log, 'train_cap', n)
            for n in ('straight', 'resumed', 'earlier')}
    launches, secs = {}, {}

    def run(name, epochs, label):
        _, s, counts, _ = run_procedure(
            base + ['--exper_name', name, '--epoch_num', str(epochs)], dev,
            seen)
        launches[label], secs[label] = counts, s
    run('straight', 2, 'straight')
    run('resumed', 1, 'first epoch')
    shutil.copytree(runs['resumed'], runs['earlier'])
    run('resumed', 2, 'resumed')
    count = earlier_port_layout(runs['earlier'])
    run('earlier', 2, 'resumed from the earlier layout')
    want = {suffix: params_npz(os.path.join(runs['straight'],
                                            f'last_cap_model.{suffix}'))
            for suffix in ('params.npz', 'opt.npz')}
    for name in ('resumed', 'earlier'):
        for suffix, w in want.items():
            got = params_npz(os.path.join(runs[name],
                                          f'last_cap_model.{suffix}'))
            check(got.keys() == w.keys()
                  and all(np.array_equal(got[k], w[k]) for k in w),
                  f'{name}: last_cap_model.{suffix} differs from the '
                  f'straight run\'s')
        check(not os.path.exists(os.path.join(
            runs[name], 'last_cap_model.torch_opt.npz')),
            f'{name}: the earlier layout\'s file was left beside the new')
    steps = read_json(os.path.join(runs['straight'],
                                   'last_cap_model.meta.json'))['step']
    opt = want['opt.npz']
    print(f'      last_cap_model after 2 epochs ({steps} steps) bit for bit '
          f'equal: straight, resumed from .opt.npz at update {count}, and '
          f'resumed from an earlier port\'s .torch_opt.npz; .opt.npz holds '
          f'{len(opt)} arrays ({sum(v.nbytes for v in opt.values())} bytes, '
          f'optax count {int(opt["0"])}); runs {secs} s ({smi})')
    return launches, {'steps': steps, 'resumed_at': count, 's': secs,
                      'opt_arrays': len(opt)}


def dp_cells():
    '''22a's step-parity cells, everything a spawned rank needs to build
    them: the fp32 captioner at the train cell (global B=TB), its MoE
    variant (E = MOE_EXPERTS) and the fp32 proposal generator at the
    proposal cell (global B=PB, remat, bench.py's anchors), dropout 0,
    PARITY_CFG's Adam.'''
    cap = {'b': TB, 'seeds': [60 + i for i in range(DP_STEPS)],
           'shape': (SV, SA, TSC), 'cfg': PARITY_CFG}
    return {'captioner': ('captioner', {
                **cap, 'dims': CapModelDims(voc_size=VOC, dout_p=0.0)}),
            'moe': ('captioner', {
                **cap, 'dims': CapModelDims(voc_size=VOC, dout_p=0.0,
                                            moe_experts=MOE_EXPERTS)}),
            'proposal': ('proposal', {
                'dims': PropModelDims(dout_p=0.0, remat=True), 'b': PB,
                'seeds': [70 + i for i in range(DP_STEPS)],
                'shape': (PSA, PSV, PE), 'anchors': ANCHORS,
                'cfg': PARITY_CFG})}


def dp_cell(kind, cell, dev, dp=None):
    '''(state, step, host batches) of a ``dp_cells`` cell on ``dev`` (a
    captioner cell with ``'lora'``: rank-LORA_RANK adapters on its
    attention and feed-forward linears, trained alone); the step over
    ``dp``'s group when given, the state's shards cut as the group asks
    (``--fsdp`` at FSDP_MIN_ELEMS, the experts over ep, the tensor-parallel
    leaves over mp).'''
    dims = cell['dims']
    if kind == 'captioner':
        model = BiModalTransformer(
            dims, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
        frozen = None
        if cell.get('lora'):
            add_lora(model, LORA_RANK,
                     torch.Generator(device=dev).manual_seed(8),
                     targets='attn_ffn')
            frozen = lora_frozen_predicate
        state = init_train_state(model, build_optimizer(cell['cfg'], model,
                                                        frozen=frozen))
        step = make_cap_train_step(dims, SMOOTHING, PAD, 'kernel', dp=dp)
        batches = [train_batch(seed, cell['b'], *cell['shape'], dims)
                   for seed in cell['seeds']]
    else:
        model = MultimodalProposalGenerator(
            dims, device=dev,
            generator=torch.Generator(device=dev).manual_seed(7))
        model.set_anchors(*cell['anchors'])
        state = init_train_state(model, build_optimizer(
            cell['cfg'], model, frozen=prop_frozen(False)))
        step = make_prop_train_step(dims, PAD, 'kernel', dp=dp)
        batches = [prop_train_batch(seed, cell['b'], *cell['shape'], dims)
                   for seed in cell['seeds']]
    if dp is not None:
        dp.shard_params(state)
    return state, step, batches


def dp_steps(state, step, batches, dp=None):
    '''Run the batches (this rank's rows, and under sp its sequence
    blocks, of each under ``dp``); returns (metrics by step, ms by
    step).'''
    metrics, ms = [], []
    for batch in batches:
        sync()
        t0 = time.perf_counter()
        state, m = step(state, batch if dp is None else dp.shard(batch))
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: v.item() for k, v in m.items()})
    return metrics, ms


def allocated(device) -> int:
    '''Bytes the caching allocator holds for tensors on ``device`` (0 on
    the CPU, where a rehearsal runs).'''
    device = torch.device(device)
    return torch.cuda.memory_allocated(device) if device.type == 'cuda' \
        else 0


def shard_step_worker(cells, grid, fsdp, out_dir, device):
    '''One rank of 22a's (or 23a's) step parity (a spawned process) on the
    (dp, sp, ep[, mp]) ``grid`` with ``--fsdp`` as asked: for each (name,
    (kind, cell)) of
    ``cells``, its metrics, launches and launch shapes, its bytes
    (``memory_allocated`` after init and after the steps, the moments made;
    ``ParamShards.bytes``), and rank 0's whole parameters saved under
    ``out_dir``.'''
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dp = DataParallel(grid[0], device, sp=grid[1], ep=grid[2],
                      mp=grid[3] if len(grid) > 3 else 1, fsdp=fsdp)
    out = {'rank': dp.rank, 'cells': {}}
    for name, (kind, cell) in cells:
        # the last cell's state: ParamShards and its optimizer refer to
        # each other, so only the collector frees them
        dp.shards = None
        gc.collect()
        sync()
        base = allocated(device)
        state, step, batches = dp_cell(kind, cell, device, dp)
        sync()
        init_bytes = allocated(device) - base
        seen = collections.Counter()
        kinks = {}
        hooks = (kink_hooks(state.model, kinks, dp.mp_rank)
                 if cell.get('lora') else [])
        reset_launch_counts()
        with launch_shapes(seen):
            metrics, ms = dp_steps(state, step, batches, dp)
        launches = launch_counts()
        for h in hooks:
            h.remove()
        state.optimizer.zero_grad()
        gc.collect()
        sync()
        held = dp.shards.bytes() if dp.shards is not None else None
        out['cells'][name] = {
            'metrics': metrics, 'ms': ms, 'launches': launches,
            'shapes': dict(seen), 'init_bytes': init_bytes,
            'step_bytes': allocated(device) - base, 'held': held,
            'kinks': kinks}
        with dp.whole(everything=True):
            if dp.is_main:
                torch.save({n: p.detach().cpu() for n, p in
                            state.model.named_parameters()},
                           os.path.join(out_dir, f'{name}.pt'))
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dp_procedure_worker(cfg, device):
    '''One rank of a spawned procedure (python -m bmt_tpu_torch's run),
    its launches counted from 0 and its launch shapes recorded; its stdout
    kept apart, the timing and score lines returned.'''
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    printed, seen = io.StringIO(), collections.Counter()
    reset_launch_counts()
    with contextlib.redirect_stdout(printed), launch_shapes(seen):
        result = cli.run(cfg, device)
    return {'result': result, 'launches': launch_counts(),
            'shapes': dict(seen),
            'lines': [x for x in printed.getvalue().splitlines()
                      if x.startswith(('[time]', '[scores]'))]}


def summed(ranks):
    return {k: sum(r['launches'][k] for r in ranks)
            for k in (KERNEL, KERNEL_DQ, KERNEL_DKV)}


def phase_data_parallel(dev, smi, tmp, tree, prop_dir, seen):
    '''21c: two ranks of a gloo group sharing the card: train_cap
    --dp_devices 2 and its evaluation over two ranks against one. Returns
    ({run: launches}, numbers).'''
    n_cards = torch.cuda.device_count()
    backend = DP_BACKEND if n_cards < DP else 'nccl'
    why = ('NCCL refuses two ranks on one device' if backend == 'gloo'
           else f'{n_cards} cards, one a rank')
    print(f'      backend {backend} ({why}); the ranks share '
          f'{min(n_cards, DP)} card(s): step times are not a scaling '
          f'number')
    # the two ranks' fp32 train steps are held to one process in 22a
    # (under --fsdp, expert and sequence parallelism)
    launches, report = {}, {'backend': backend}
    log = os.path.join(tmp, 'dplog')
    argv = ['--procedure', 'train_cap', *tree, *CLI_FLAGS, *DP_CAP_FLAGS,
            '--log_dir', log, '--exper_name', 'dpcap', '--dp_devices',
            str(DP)]
    t0 = time.perf_counter()
    ranks = spawn(dp_procedure_worker,
                  (Config(build_parser().parse_args(argv)),), DP, dev,
                  backend)
    secs = time.perf_counter() - t0
    cap_dir = os.path.join(log, 'train_cap', 'dpcap')
    check(checkpoint_exists(cap_dir, 'best_cap_model'),
          'train_cap --dp_devices 2 wrote no best_cap_model')
    meta = read_json(os.path.join(cap_dir, 'last_cap_model.meta.json'))
    for r in ranks:
        check(all(r['launches'].values()), f'train_cap --dp_devices '
              f'{DP}: a rank launched {r["launches"]}')
        seen.update(r['shapes'])
    b = int(DP_CAP_FLAGS[1])
    check(any(s[1] == b and s[3] == SA for s in ranks[0]['shapes']),
          f'no per-rank B={b} launch at Sq={SA}')
    launches['dp_train_cap'] = summed(ranks)
    print(f'      train_cap {" ".join(DP_CAP_FLAGS)} --dp_devices {DP} '
          f'(global batch {b * DP}, as 17a\'s): {secs:.2f} s, best METEOR '
          f'{ranks[0]["result"]}, '
          f'{meta["step"]} steps, train_batch_size '
          f'{meta["config"]["train_batch_size"]}; rank 0: '
          + '; '.join(ranks[0]['lines']))
    props = os.path.join(prop_dir, 'submissions',
                         'prop_results_val_1_e0_maxprop100.json')
    subs = {}
    for n in (DP, 1):
        ckpt = fp32_copy(cap_dir, os.path.join(tmp, f'dp_fp32_{n}'),
                         'pallas')
        ev = ['--procedure', 'evaluate', *tree, *CLI_FLAGS,
              '--prop_pred_path', props, '--pretrained_cap_model_path',
              ckpt, '--dp_devices', str(n)]
        if n > 1:
            ranks = spawn(dp_procedure_worker,
                          (Config(build_parser().parse_args(ev)),), n, dev,
                          backend)
            for r in ranks:
                check(r['launches'][KERNEL] > 0, f'evaluate --dp_devices '
                      f'{n}: a rank launched {r["launches"]}')
                seen.update(r['shapes'])
            launches['dp_evaluate'] = summed(ranks)
            check(ranks[1]['result'] == ranks[0]['result'],
                  'the ranks returned different scores')
        else:
            run_procedure(ev, dev, seen)
        subs[n] = read_json(os.path.join(
            ckpt, 'captioning_results_learned_props_e0.json'))
    segs, differ, gap = compare_captions(
        subs, ckpt, tree, dev, names=((DP, f'{DP} ranks'), (1, 'one rank')))
    print(f'      evaluate of that captioner in fp32 over {DP} ranks and '
          f'over one: {segs - differ} of {segs} captions equal')
    report.update({'train_cap_s': secs, 'captions': segs,
                   'captions_differ': differ, 'top2_gap': gap})
    return launches, report


def phase_engine_replicas(dev, smi, cap_dir):
    '''21d: CaptionEngine with DP replicas on the one card answers phase
    18's 64 ragged requests with one replica's sentences (bf16, kernel;
    a part at a near-tie, as phase 18's rule). Returns (launches, numbers).'''
    if torch.cuda.device_count() < DP:
        try:
            replica_devices(DP, dev)
            check(False, 'replica_devices gave more replicas than cards')
        except ValueError as e:
            print(f'      replica_devices({DP}) on this machine: {e}')
    cfg, dims, model, vocab = load_cap_checkpoint(cap_dir, device=dev)
    kw = dict(max_len=cfg.max_len, start_token=cfg.start_token,
              end_token=cfg.end_token, pad_token=cfg.pad_token,
              compute_dtype=torch.bfloat16, attention_impl='kernel')
    engines = {1: CaptionEngine(model, vocab, **kw),
               DP: CaptionEngine(model, vocab, dp=[dev] * DP, **kw)}
    rng = np.random.default_rng(18)
    crops = [request_crop(rng, dims)[1] for _ in range(SERVE_REQUESTS)]
    for engine in engines.values():
        engine.caption_tokens(crops[:DP], _count=False)       # warm
    times, tokens, counts = {1: [], DP: []}, {}, {}
    for n in (1, DP, DP, 1):
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        tokens[n] = engines[n].caption_tokens(crops)
        sync()
        times[n].append(time.perf_counter() - t0)
        counts[n] = launch_counts()
    check(counts[DP][KERNEL] == DP * 8 and counts[1][KERNEL] == 8,
          f'forward launches {counts} (8 a replica\'s batch)')
    one, two = engines[1], engines[DP]
    differ, worst = 0, 0.0
    for crop, a, b in zip(crops, tokens[1], tokens[DP]):
        sa = ints_to_sentence(a, vocab, cfg.end_token)
        sb = ints_to_sentence(b, vocab, cfg.end_token)
        if sa != sb:
            differ += 1
            alone = one.caption_tokens([crop], _count=False)[0]
            worst = max(worst, first_gap(one, crop, alone, sb)[1],
                        first_gap(one, crop, alone, sa)[1])
    check(worst <= BF16_GAP_TOL, f'{DP} replicas part from one at a top-2 '
          f'gap of {worst}')
    cps = {n: SERVE_REQUESTS / statistics.median(t) for n, t in times.items()}
    print(f'      {SERVE_REQUESTS} requests: {SERVE_REQUESTS - differ} of '
          f'{SERVE_REQUESTS} sentences of {DP} replicas equal one\'s (the '
          f'rest near-ties, top-2 gap <= {worst:.3e}, tol {BF16_GAP_TOL}); '
          f'forward launches {counts[DP][KERNEL]} ({DP} x 8); captions/s '
          f'{DP} replicas sharing one card {cps[DP]:.1f}, one replica '
          f'{cps[1]:.1f} ({smi}; not a scaling number)')
    del engines, one, two, model
    torch.cuda.empty_cache()
    return counts[DP], {'differ': differ, 'worst_gap': worst,
                        'captions_per_s': cps}


# ---------------------------------------------------------------------------
# --fsdp, expert and sequence parallelism
# ---------------------------------------------------------------------------

# 22a's grids: (label, (dp, sp, ep), --fsdp, the cells it runs), each
# against one process's steps on the same global batches; one spawn runs
# them all, and 23a-23c after them
# 22a's and 23a-23c's times are taken beside 22b's spawns and 23d's ranks
CONTENDED = 'contended: beside 22b\'s eight ranks and 23d\'s four'
SHARD_SPAWNS = (('fsdp', (DP, 1, 1), True, ('captioner', 'proposal')),
                ('ep', (1, 1, DP), False, ('moe',)),
                ('sp', (1, DP, 1), False, ('proposal',)))
# 22b's procedures on phase 17's tree: (label, procedure, flags); the
# global batches are 17a's and 17b's (32 and 16)
SHARD_RUNS = (
    ('fsdp_cap', 'train_cap', [*DP_CAP_FLAGS, '--fsdp', '--dp_devices',
                               str(DP)]),
    ('fsdp_prop', 'train_prop', ['--B', str(16 // DP), '--fsdp',
                                 '--dp_devices', str(DP)]),
    ('ep_cap', 'train_cap', [*CAP_FLAGS, '--moe_experts', str(MOE_EXPERTS),
                             '--ep_devices', str(DP)]),
    ('sp_prop', 'train_prop', [*PROP_FLAGS, '--sp_devices', str(DP)]))
# the attention calls of a proposal step under sp = 2 at the proposal cell:
# a rank's query block (S/2 rows) against the whole key sequence
SP_CASES = [('sp audio self-attn', PB, 4, PSA // DP, PSA, 256, False),
            ('sp video self-attn', PB, 4, PSV // DP, PSV, 256, False),
            ('sp audio->video cross', PB, 4, PSA // DP, PSV, 256, False),
            ('sp video->audio cross', PB, 4, PSV // DP, PSA, 256, False)]


def step_errors(ranks_cell, single, got, want):
    '''21c's errors of a sharded run against one process: loss and
    grad_norm relative, each step; parameters absolute after the last.'''
    return {'loss': max(abs(a['loss'] / b['loss'] - 1) for a, b in
                        zip(ranks_cell['metrics'], single)),
            'grad_norm': max(abs(a['grad_norm'] / b['grad_norm'] - 1)
                             for a, b in zip(ranks_cell['metrics'], single)),
            'param': max((got[n] - w).abs().max().item()
                         for n, w in want.items())}


def single_run(kind, cell, dev):
    '''One process's run of a ``dp_cells`` cell: its metrics, ms, bytes
    after init and after the steps, its parameters after them (on the
    host), and, for the LoRA cell, its ReLU inputs near 0
    (``kink_hooks``).'''
    gc.collect()
    sync()
    base = allocated(dev)              # what earlier phases still hold
    state, step, batches = dp_cell(kind, cell, dev)
    sync()
    init_bytes = allocated(dev) - base
    kinks = {}
    hooks = kink_hooks(state.model, kinks) if cell.get('lora') else []
    metrics, ms = dp_steps(state, step, batches)
    for h in hooks:
        h.remove()
    state.optimizer.zero_grad()
    gc.collect()
    sync()
    out = {'metrics': metrics, 'ms': ms, 'init_bytes': init_bytes,
           'step_bytes': allocated(dev) - base, 'kinks': kinks,
           'want': {n: p.detach().cpu()
                    for n, p in state.model.named_parameters()}}
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def shard_tensor_worker(jobs, spec, out_dir, device):
    '''22a's and 23a-23c's ranks in one spawn (each spawn costs ~20 s of
    start-up on the card): each (label, grid, fsdp, cells) job as
    ``shard_step_worker`` (rank 0's whole parameters saved under
    ``out_dir/label``), then 23b and 23c (``tensor_pipeline_part``).'''
    out = {'jobs': {}}
    for label, grid, fsdp, cells in jobs:
        path = os.path.join(out_dir, label)
        os.makedirs(path, exist_ok=True)
        t0 = time.perf_counter()
        out['jobs'][label] = shard_step_worker(cells, grid, fsdp, path,
                                               device)
        out['jobs'][label]['s'] = time.perf_counter() - t0
    out.update(tensor_pipeline_part(spec, out_dir, device))
    return out


def shard_steps_setup(dev, tmp):
    '''22a's and 23a-23c's one-process runs and references (made in this
    process before their spawn), and the spawn's jobs.'''
    cells = dp_cells()
    single = {name: single_run(*cells[name], dev)
              for name in ('captioner', 'moe', 'proposal')}
    ref_dir = os.path.join(tmp, 'mp_ref')
    os.makedirs(ref_dir, exist_ok=True)
    refs23 = mp_references(dev, ref_dir)
    mp = mp_cells()
    jobs = [(label, grid, fsdp, [(n, cells[n]) for n in names])
            for label, grid, fsdp, names in SHARD_SPAWNS]
    jobs.append(('mp', (1, 1, 1, MP), False,
                 [(n, mp[n]) for n in ('captioner', 'proposal', 'lora')]))
    return {'cells': cells, 'single': single, 'ref_dir': ref_dir,
            'refs23': refs23, 'jobs': jobs}


def shard_steps_spawn(setup, dev):
    '''22a's and 23a-23c's spawn of DP gloo ranks: (their results, s).'''
    t0 = time.perf_counter()
    spawned = spawn(shard_tensor_worker, (setup['jobs'], setup['refs23'][
        'spec'], setup['ref_dir']), DP, dev, DP_BACKEND)
    return spawned, time.perf_counter() - t0


def phase_shard_steps(dev, smi, setup, spawned, secs, seen):
    '''22a: fp32 train-step parity of two gloo ranks sharing the card
    under --fsdp (the captioner and the proposal generator), expert
    parallelism (the MoE captioner) and sequence parallelism (the proposal
    generator), DP_STEPS steps each against one process (``setup``:
    ``shard_steps_setup``; ``spawned``, ``secs``: ``shard_steps_spawn``);
    each rank's bytes beside one process's. The same spawn runs 23a-23c.
    Returns ({run: launches}, numbers, what phase 23 reports from: the
    ranks' results, the one-process runs and references).'''
    cells, single, ref_dir = setup['cells'], setup['single'], setup['ref_dir']
    refs23 = setup['refs23']
    launches, report = {}, {}
    print(f'      one spawn of {DP} ranks for 22a and 23a-23c, beside 22b\'s '
          f'and 23d\'s: {secs:.1f} s')
    for label, grid, fsdp, names in SHARD_SPAWNS:
        ranks = [r['jobs'][label] for r in spawned]
        for name in names:
            path = os.path.join(ref_dir, label, f'{name}.pt')
            got = torch.load(path)
            os.remove(path)
            one = single[name]
            mine = [r['cells'][name] for r in ranks]
            errs = step_errors(mine[0], one['metrics'], got, one['want'])
            tol = PROP_STEP_TOL if name == 'proposal' else STEP_TOL
            for key, e in errs.items():
                check(e <= tol[key], f'{label} {name} steps: {key} error '
                      f'{e} (tol {tol[key]})')
            for r in mine:
                check(all(r['launches'].values()), f'{label} {name}: a rank '
                      f'launched {r["launches"]}')
                seen.update(r['shapes'])
            if label == 'sp':
                check(any(sh[3] == PSA // DP and sh[4] == PSA
                          for sh in mine[0]['shapes']),
                      f'sp: no {PSA // DP}x{PSA} launch')
            key = f'{label} {name}'
            launches[key] = {k: sum(r['launches'][k] for r in mine)
                             for k in (KERNEL, KERNEL_DQ, KERNEL_DKV)}
            mib = 2 ** 20
            report[key] = {
                'errors': errs, 'spawn_s': secs,
                'job_s': ranks[0]['s'],
                'ms': statistics.median(mine[0]['ms'][1:]),
                'single_ms': statistics.median(one['ms'][1:]),
                'rank_init_MiB': [r['init_bytes'] / mib for r in mine],
                'rank_step_MiB': [r['step_bytes'] / mib for r in mine],
                'rank_held_MiB': [None if r['held'] is None else
                                  {k: v / mib for k, v in r['held'].items()}
                                  for r in mine],
                'single_init_MiB': one['init_bytes'] / mib,
                'single_step_MiB': one['step_bytes'] / mib}
            rep = report[key]
            print(f'      {label} {name} fp32, {DP_STEPS} Adam steps, global '
                  f'batch {cells[name][1]["b"]}, grid dp x sp x ep {grid}: '
                  f'errors {errs} (tolerances {tol}); ms a step (median of '
                  f'steps 2-{DP_STEPS}): {len(mine)} ranks sharing one card '
                  f'{rep["ms"]:.2f} ({CONTENDED}), one process '
                  f'{rep["single_ms"]:.2f}; '
                  f'MiB allocated after init a rank '
                  f'{[round(x, 1) for x in rep["rank_init_MiB"]]}, one '
                  f'process {rep["single_init_MiB"]:.1f}; after the steps '
                  f'(moments made) '
                  f'{[round(x, 1) for x in rep["rank_step_MiB"]]}, one '
                  f'process {rep["single_step_MiB"]:.1f}; a rank\'s '
                  f'sharded / whole leaves (parameters, moments) MiB '
                  f'{rep["rank_held_MiB"]} ({smi}); {rep["job_s"]:.1f} s '
                  f'of the spawn; launches {launches[key]}')
    refs23['single'].update({k: single[k]
                             for k in ('captioner', 'proposal')})
    del single, setup['single']
    torch.cuda.empty_cache()
    return launches, report, {'ranks': spawned, 'spawn_s': secs,
                              'ref_dir': ref_dir, **refs23}


def phase_shard_procedures(dev, smi, tmp, tree, cap_dir, seen,
                           beside=None):
    '''22b: the procedures under each flag on phase 17's tree, one epoch,
    build_parser widths, bf16, pallas, the ranks spawned as python -m
    bmt_tpu_torch spawns them (gloo: two ranks share the card); the four
    runs side by side (eight ranks on the card and the host at once: their
    seconds are a cost of that, not the procedures' own; train_prop starts
    from phase 17's captioner, so no run waits for another); each run
    directory loads in one process
    (best_* through the app's loader; a captioner's last_* with its
    optimizer too), and each captioner is scored by evaluate in one
    process. ``beside`` ({name: a function of no arguments}): each runs in
    a thread of its own beside the spawns, while this process launches no
    kernel but theirs. Returns ({run: launches}, numbers, {name: result}).'''
    from bmt_tpu_torch.parallel.mesh import axes
    log = os.path.join(tmp, 'shardlog')
    props = os.path.join(os.path.dirname(os.path.dirname(cap_dir)),
                         'train_prop', 'prop', 'submissions',
                         'prop_results_val_1_e0_maxprop100.json')
    launches, report = {}, {}

    def argv_of(label, procedure, flags):
        argv = ['--procedure', procedure, *tree, *CLI_FLAGS, *flags,
                '--log_dir', log, '--exper_name', label]
        if procedure == 'train_prop':
            argv += ['--pretrained_cap_model_path', cap_dir]
        return argv

    def spawned(run):
        cfg = Config(build_parser().parse_args(argv_of(*run)))
        n = int(np.prod(axes(cfg)))
        t0 = time.perf_counter()
        ranks = spawn(dp_procedure_worker, (cfg,), n, dev, DP_BACKEND)
        return n, time.perf_counter() - t0, ranks

    beside = beside or {}
    with ThreadPoolExecutor(len(SHARD_RUNS) + len(beside)) as pool:
        other = {name: pool.submit(fn) for name, fn in beside.items()}
        done = list(pool.map(spawned, SHARD_RUNS))
        other = {name: f.result() for name, f in other.items()}
    for procedure in ('train_cap', 'train_prop'):
        runs = [(r, d) for r, d in zip(SHARD_RUNS, done) if r[1] == procedure]
        for (label, _, flags), (n, secs, ranks) in runs:
            argv = argv_of(label, procedure, flags)
            kind = 'cap' if procedure == 'train_cap' else 'prop'
            run_dir = os.path.join(log, procedure, label)
            check(checkpoint_exists(run_dir, f'best_{kind}_model'),
                  f'{label}: no best_{kind}_model')
            for r in ranks:
                # train_prop's encoder is the captioner's, frozen: no
                # backward kernel runs there (17b's rule)
                check(all(r['launches'].values()) if kind == 'cap'
                      else r['launches'][KERNEL] > 0,
                      f'{label}: a rank launched {r["launches"]}')
                seen.update(r['shapes'])
            if label == 'sp_prop':
                check(any(s[3] == PSA // DP and s[4] == PSA
                          for s in ranks[0]['shapes']),
                      f'{label}: no {PSA // DP}x{PSA} launch')
            launches[label] = summed(ranks)
            meta = read_json(os.path.join(run_dir,
                                          f'last_{kind}_model.meta.json'))
            t0 = time.perf_counter()
            if kind == 'cap':
                params = loads_back(argv, run_dir, kind, meta['step'], dev)
                loaded = ('best_cap_model, and last_cap_model with its '
                          'optimizer')
            else:
                # the app's loader; the optimizer file is the CPU tests'
                # (its ~2 GB read would add ~10 s a run here)
                _, _, model = load_prop_checkpoint(run_dir, device=dev)
                params = sum(p.numel() for p in model.parameters())
                loaded = 'best_prop_model through the app\'s loader'
                del model
            load_s = time.perf_counter() - t0
            print(f'      {procedure} {" ".join(flags)}: {n} ranks, '
                  f'{secs:.2f} s beside the other three runs, result '
                  f'{ranks[0]["result"]}, {meta["step"]} steps; loads in '
                  f'one process in {load_s:.2f} s ({params} parameters, '
                  f'{loaded}); rank 0: ' + '; '.join(ranks[0]['lines']))
            report[label] = {'s': secs, 'load_s': load_s, 'ranks': n,
                             'steps': meta['step'],
                             'result': ranks[0]['result'],
                             'lines': ranks[0]['lines']}
            if kind == 'cap':
                ev = ['--procedure', 'evaluate', *tree, *CLI_FLAGS,
                      '--prop_pred_path', props,
                      '--pretrained_cap_model_path', run_dir]
                _, ev_s, launches[f'{label} evaluate'], _ = run_procedure(
                    ev, dev, seen)
                report[label]['evaluate_s'] = ev_s
            shutil.rmtree(run_dir)
            torch.cuda.empty_cache()
    return launches, report, other


def phase_sp_kernel_times(dev, smi):
    '''22c: the three kernels' times at the sp shapes (bf16), beside their
    plain versions, the library call and their bound.'''
    out = {}
    for case in SP_CASES:
        t = kernel_times(case, dev)
        out[f'{case[3]}x{case[4]}'] = t
        print(f'      {case[0]:24s} B={case[1]} Sq={case[3]} Sk={case[4]}: '
              + '; '.join(f'{k} {v["kernel"]:.4f} ms (plain '
                          f'{v["plain"]:.4f}, library {v["library"]:.4f}, '
                          f'bound {v["bound"]:.4f} by {v["bound_by"]})'
                          for k, v in t.items()) + f' ({smi})')
    return out

# ---------------------------------------------------------------------------
# tensor and pipeline parallelism
# ---------------------------------------------------------------------------

MP = 2                                  # phase 23's mp ranks and pp stages
PP_B, PP_MICRO = TB, 4                  # 23c: the train cell's rows
PP_REPS = 3                             # 23c: timed forward + backward
MP_DECODE_ROUNDS = 3                    # 23b: timed decodes a path
DRYRUN_N = 4                            # 23d's ranks (sp 2 x mp 2)
# 23c, relative L2 against the sequential stack in one process: (the
# outputs, each layer's gradient as one vector). fp32: the microbatches'
# products (8 rows) and the weight gradients' sums over them run in
# another order; the outputs moved ~6e-7 (with the fp32 forward on
# mma.sync, which split its key loop at 8 rows x 96), and a ReLU input
# within that of 0 falls on the
# other side. 23c counts them with hooks on every fc1: on an H100, 2 of
# layer 1's 12,582,912 video feed-forward inputs, |x| <= 2.2e-7, and none
# elsewhere. Each flip adds or drops one token's term in a row of fc1's
# weight gradient, ~1 / sqrt(2048 x 3072 / 2) = 5.6e-4 of that gradient's
# norm, and one token's backward into layer 0: the gradients read 2.3e-4
# (the feed-forwards' leaves 2.7e-4, the rest 1.2e-4; printed by layer).
# A schedule fault (a microbatch dropped, doubled or out of order) moves
# them by O(1). bf16: both paths round to 8 mantissa bits (2^-7 relative
# an ulp), as BWD_TOL's bf16 rtol
PP_TOL = {torch.float32: (1e-5, 1e-3), torch.bfloat16: (2e-2, 2e-2)}
# 23e's timed H/mp calls: the train and proposal cells' longest ones at
# H = 4 / MP heads
MP_TIME_CASES = [('mp2 enc self-attn audio', TB, 4 // MP, SA, SA, 256,
                  False),
                 ('mp2 prop self-attn audio', PB, 4 // MP, PSA, PSA, 256,
                  False)]


def mp_spec():
    """What phase 23's ranks build, passed to them (a spawned rank
    re-imports this script): the decode cell's dims, rows, lengths and
    steps, 23c's encoder dims, rows, microbatches and repetitions."""
    return types.SimpleNamespace(
        dims=CapModelDims(voc_size=VOC), b=B, sa=SA, sv=SV, steps=STEPS,
        rounds=MP_DECODE_ROUNDS, pp_b=PP_B, pp_micro=PP_MICRO,
        pp_reps=PP_REPS)


def mp_cells():
    """23a's cells: 22a's fp32 captioner and proposal cells, and the
    captioner with rank-LORA_RANK adapters on its attention and
    feed-forward linears (only they train)."""
    cells = dp_cells()
    kind, cap = cells['captioner']
    return {'captioner': cells['captioner'], 'proposal': cells['proposal'],
            'lora': (kind, {**cap, 'lora': True})}


def mp_share(model, n_mp: int = MP) -> float:
    """The share of a model's parameter bytes an mp rank holds, from the
    leaf shapes and ``parallel.sharding_rules.mp_plan`` (the split leaves
    a 1/n_mp block, the rest whole)."""
    split = set(mp_plan(model, n_mp)[0])
    total = sum(p.numel() for p in model.parameters())
    held = sum(p.numel() / (n_mp if id(p) in split else 1)
               for p in model.parameters())
    return held / total


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def pp_encoder(dev, dtype, spec):
    """The flagship bi-modal encoder (``spec.dims``, CapModelDims(): N = 2,
    H = 4, d_model 1024, A 128 and V 1024 wide) drawn from a seed in
    ``dtype``, its inputs at the train cell (PP_B rows, SA audio and SV
    video, padded tails) and the loss weights: loss = sum(Av wA) +
    sum(Va wV)."""
    dims, n, sa, sv = spec.dims, spec.pp_b, spec.sa, spec.sv
    enc = BiModalEncoder(dims.d_model_A, dims.d_model_V, dims.d_model,
                         dims.d_ff_A, dims.d_ff_V, dims.N, dims.H, 0.0, dev)
    init_params(enc, torch.Generator(device=dev).manual_seed(31))
    enc = enc.to(dtype).eval()
    g = torch.Generator(device=dev).manual_seed(32)
    A = torch.randn(n, sa, dims.d_model_A, generator=g, device=dev)
    V = torch.randn(n, sv, dims.d_model_V, generator=g, device=dev)
    la = torch.randint(sa // 2, sa + 1, (n,), generator=g, device=dev)
    lv = torch.randint(sv // 2, sv + 1, (n,), generator=g, device=dev)
    Am = (torch.arange(sa, device=dev)[None] < la[:, None])[:, None]
    Vm = (torch.arange(sv, device=dev)[None] < lv[:, None])[:, None]
    w = (torch.randn(A.shape, generator=g, device=dev),
         torch.randn(V.shape, generator=g, device=dev))
    return enc, (A.to(dtype), V.to(dtype), Am, Vm), w


def pp_loss(Av, Va, w):
    return (Av.float() * w[0]).sum() + (Va.float() * w[1]).sum()


def relu_input_hooks(layers, record):
    """Forward hooks on each feed-forward's fc1 of ``layers`` ({index:
    encoder layer}): its output, the ReLU's input, is appended to
    ``record['<index>.ff_M1']`` (audio) or ``['<index>.ff_M2']`` (video) at
    every call, microbatches in order."""
    hooks = []
    for i, layer in layers.items():
        for ff in ('ff_M1', 'ff_M2'):
            def keep(module, inputs, out, key=f'{i}.{ff}'):
                record.setdefault(key, []).append(out.detach())
            hooks.append(getattr(layer, ff).fc1.register_forward_hook(keep))
    return hooks


KINK = 1e-5                             # 23a: a ReLU input this near 0


def kink_hooks(model, record, rank=0):
    """Forward hooks on every fc1 of ``model`` (its output is the ReLU's
    input): at each call, the (row, column, value) of the outputs within
    KINK of 0 are appended to ``record[name]`` on the host, the columns
    numbered in the whole layer (mp rank ``rank`` holds the rank-th block
    of its columns)."""
    hooks = []
    for name, module in model.named_modules():
        if name.endswith('fc1'):
            def keep(module, inputs, out, key=name):
                x = out.detach().reshape(-1, out.shape[-1])
                at = (x.abs() < KINK).nonzero()
                record.setdefault(key, []).append(
                    (at[:, 0].cpu(), (at[:, 1] + rank * x.shape[1]).cpu(),
                     x[at[:, 0], at[:, 1]].cpu()))
            hooks.append(module.register_forward_hook(keep))
    return hooks


def kink_flips(one, ranks):
    """The ReLU inputs within KINK of 0 in one process (``one``, from
    ``kink_hooks``) and those of them that the mp ranks (each with its
    column block) put on the other side of 0: (count, [(fc1, call, row,
    column, one process's value, the ranks'), ...])."""
    near, flips = 0, []
    for key, calls in one.items():
        for c, (rows, cols, vals) in enumerate(calls):
            near += len(vals)
            theirs = {}
            for rank in ranks:
                for a, b, v in zip(*(x.tolist() for x in rank[key][c])):
                    theirs[a, b] = v
            for a, b, v in zip(rows.tolist(), cols.tolist(), vals.tolist()):
                w = theirs.get((a, b))
                if w is not None and (v > 0) != (w > 0):
                    flips.append((key, c, a, b, v, w))
    return near, flips


def pp_reference(dev, dtype, path, spec):
    """23c's sequential stack in this process: its (Av, Va) and every
    layer's gradient saved to ``path``; returns its median ms of forward +
    backward."""
    enc, (A, V, Am, Vm), w = pp_encoder(dev, dtype, spec)
    ms, relu_in = [], {}
    hooks = relu_input_hooks(dict(enumerate(enc.layers)), relu_in)
    for _ in range(1 + spec.pp_reps):
        enc.zero_grad(set_to_none=True)
        sync()
        t0 = time.perf_counter()
        Av, Va = enc(A, V, Am, Vm, 'kernel')
        pp_loss(Av, Va, w).backward()
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
        for h in hooks:                  # the first run's ReLU inputs only
            h.remove()
        hooks = []
    torch.save({'out': (Av.detach().cpu(), Va.detach().cpu()),
                'grads': {f'{i}.{n}': p.grad.cpu()
                          for i, layer in enumerate(enc.layers)
                          for n, p in layer.named_parameters()},
                'relu_positive': {k: torch.cat(v).gt(0).cpu()
                                  for k, v in relu_in.items()}}, path)
    del enc
    return statistics.median(ms[1:])


def pp_rank(dev, dtype, path, seen, spec):
    """23c on this rank: its stage of the flagship encoder pipelined over
    the two ranks (PP_MICRO microbatches), timed; its outputs and each of
    its layers' gradients (one vector a layer) against the sequential
    stack's (``pp_reference``) as relative L2 errors, and the launches of
    the first run."""
    enc, (A, V, Am, Vm), w = pp_encoder(dev, dtype, spec)
    group = stage_group(dev)
    stage = stack_layer_params(enc.layers, group.size, group.rank)
    per = len(enc.layers) // group.size
    layers = {group.rank * per + j: layer for j, layer in enumerate(stage)}
    ms, launches, relu_in = [], None, {}
    hooks = relu_input_hooks(layers, relu_in)
    reset_launch_counts()
    with launch_shapes(seen):
        for _ in range(1 + spec.pp_reps):
            stage.zero_grad(set_to_none=True)
            sync()
            t0 = time.perf_counter()
            Av, Va = pipelined_bimodal_encoder_forward(
                stage, A, V, Am, Vm, group, spec.pp_micro,
                attention_impl='kernel')
            pp_loss(Av, Va, w).backward()
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
            launches = launches or launch_counts()
            for h in hooks:              # the first run's ReLU inputs only
                h.remove()
            hooks = []
    ref = torch.load(path)
    # the ReLU inputs on the other side of 0 from the sequential stack's,
    # by layer and stream: their number, of how many, and the largest |x|
    # among them
    flips = {}
    for key, outs in sorted(relu_in.items()):
        x = torch.cat(outs)
        flip = x.gt(0) != ref['relu_positive'][key].to(dev)
        n = int(flip.sum())
        flips[key] = {'flips': n, 'of': x.numel(), 'max_abs': float(
            x[flip].abs().max()) if n else 0.0}
    del relu_in
    # each layer's gradient as one vector (a key projection's bias has a
    # gradient of exactly 0, so a leaf alone has no scale to be read in)

    def one(i, layer, keep):
        names = [n for n, _ in layer.named_parameters() if keep(n)]
        got = dict(layer.named_parameters())
        return rel_l2(
            torch.cat([got[n].grad.float().reshape(-1) for n in names]),
            torch.cat([ref['grads'][f'{i}.{n}'].float().reshape(-1)
                       for n in names]).to(dev))

    def err(keep):
        return max(one(i, layer, keep) for i, layer in layers.items())
    by_layer = {i: {'ffn': one(i, layer, lambda n: n.startswith('ff_')),
                    'rest': one(i, layer, lambda n: not n.startswith('ff_'))}
                for i, layer in layers.items()}
    out = {'ms': ms[1:], 'launches': launches,
           'out_err': max(rel_l2(a, b.to(dev))
                          for a, b in zip((Av, Va), ref['out'])),
           'grad_err': err(lambda n: True),
           'ffn_err': err(lambda n: n.startswith('ff_')),
           'rest_err': err(lambda n: not n.startswith('ff_')),
           'layers': sorted(layers), 'relu_flips': flips,
           'by_layer': by_layer}
    del enc, stage, ref
    torch.cuda.empty_cache()
    return out


def decode_input(dev, spec, dtype=torch.float32):
    """The decode cell's features (B rows, SV video, SA audio), seeded."""
    return features(torch.Generator(device=dev).manual_seed(23), spec.b,
                    spec.sv, spec.sa, spec.dims, dev, dtype)


def decoded(model, x, spec, seen=None):
    """(the greedy tokens at the decode cell, end_idx -1: every step runs,
    the ms of MP_DECODE_ROUNDS timed decodes after a warm one)."""
    ms = []
    with launch_shapes(seen if seen is not None
                       else collections.Counter()):
        for _ in range(1 + spec.rounds):
            sync()
            t0 = time.perf_counter()
            tokens = greedy_decode_bimodal(model, x, spec.steps, START, -1,
                                           PAD, 'kernel')
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
    return tokens, ms[1:]


@torch.inference_mode()
def step_logprobs(model, x, tokens, steps):
    """The decode's step log-probs (steps, B, VOC) teacher-forced along
    ``tokens``, on the host."""
    state, step_fn, _ = bimodal_step_setup(model, x, PAD, steps, 'kernel')
    out = []
    for s in range(steps):
        lp, state = step_fn(state, tokens[:, s:s + 1], s)
        out.append(lp.float().cpu())
    return torch.stack(out)


def mp_decode_rank(dp, dev, path, seen, spec):
    """23b on this rank: the flagship captioner (seed 0) with its mp-2
    parameters decodes the decode cell in fp32, then in bf16; the fp32 step
    log-probs along one process's trajectory (``path``) against one
    process's, as the largest absolute error."""
    model = BiModalTransformer(
        spec.dims, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    state = init_train_state(model, build_optimizer(TRAIN_CFG, model))
    dp.shard_params(state)
    model.eval()
    ref = torch.load(path)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model.to(dtype)
        x = decode_input(dev, spec, dtype)
        tokens, ms = decoded(model, x, spec, seen)
        out[str(dtype)] = {'tokens': tokens.cpu(), 'ms': ms}
        if dtype == torch.float32:
            lp = step_logprobs(model, x, ref['tokens'].to(dev), spec.steps)
            out[str(dtype)]['lp_err'] = (lp - ref['lp']).abs().max().item()
    dp.shards = None
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tensor_pipeline_part(spec, ref_dir, device):
    """23b and 23c on one of the two gloo ranks (after 23a's steps, in
    ``shard_tensor_worker``): the decode cell with mp-2 parameters, and the
    flagship encoder pipelined over the two ranks in fp32 and bf16, each
    part's launches and launch shapes."""
    out = {}
    dp = DataParallel(1, device, mp=MP)
    seen = collections.Counter()
    reset_launch_counts()
    out['decode'] = mp_decode_rank(
        dp, device, os.path.join(ref_dir, 'decode.pt'), seen, spec)
    out['decode_launches'] = launch_counts()
    out['pp'] = {str(dtype): pp_rank(device, dtype, os.path.join(
        ref_dir, f'pp_{str(dtype)[6:]}.pt'), seen, spec)
        for dtype in (torch.float32, torch.bfloat16)}
    out['shapes23'] = dict(seen)
    return out


def phase_dryrun(dev, smi, seen, log=print):
    """23d: python -m bmt_tpu_torch.scripts.dryrun_multichip --n_devices
    DRYRUN_N --backend gloo, through its ``dryrun_multichip`` (run here, so
    that its ranks, spawned from this process, report their launches and
    their launch shapes through ``launch_shapes``); its lines go to
    ``log``. Returns (the ranks' launches summed, numbers)."""
    from bmt_tpu_torch.scripts.dryrun_multichip import dryrun_multichip
    t0 = time.perf_counter()
    with launch_shapes(seen):          # its one-process references, here
        line, ranks = dryrun_multichip(DRYRUN_N, 'cuda', DP_BACKEND,
                                       record=launch_shapes)
    secs = time.perf_counter() - t0
    log(f'      {line}')
    check(line.startswith(f'dryrun_multichip({DRYRUN_N}) OK'),
          f'dryrun_multichip: {line}')
    check(len(ranks) == DRYRUN_N and all(r['launches'][KERNEL]
                                         for r in ranks),
          f'a dry-run rank launched no forward kernel: '
          f'{[r["launches"] for r in ranks]}')
    for r in ranks:
        seen.update(r['launch_shapes'])
    launches = summed(ranks)
    log(f'      {secs:.1f} s beside 22a\'s and 22b\'s spawns (contended; '
        f'{smi}); the ranks\' launches {launches}')
    return launches, {'line': line, 's': secs, 'launches': launches}


def mp_references(dev, ref_dir):
    """Phase 23's one-process references, made before 22a's spawn: the
    LoRA captioner's steps, the decode cell's tokens in fp32 and bf16 and
    the fp32 step log-probs along its trajectory (saved for the ranks),
    23c's sequential stack (saved), and the share of each model's bytes
    an mp rank should hold (``mp_share``)."""
    spec = mp_spec()
    kind, cell = mp_cells()['lora']
    single = {'lora': single_run(kind, cell, dev)}
    model = BiModalTransformer(
        spec.dims, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0)).eval()
    share = {'captioner': mp_share(model), 'proposal': mp_share(
        MultimodalProposalGenerator(PropModelDims(), device='meta'))}
    x = decode_input(dev, spec)
    tokens32, ms32 = decoded(model, x, spec)
    torch.save({'tokens': tokens32,
                'lp': step_logprobs(model, x, tokens32, spec.steps)},
               os.path.join(ref_dir, 'decode.pt'))
    model16 = model.to(torch.bfloat16)
    x16 = decode_input(dev, spec, torch.bfloat16)
    tokens16, ms16 = decoded(model16, x16, spec)
    pp_ms = {str(dtype): pp_reference(dev, dtype, os.path.join(
        ref_dir, f'pp_{str(dtype)[6:]}.pt'), spec)
        for dtype in (torch.float32, torch.bfloat16)}
    torch.cuda.empty_cache()
    return {'spec': spec, 'single': single, 'share': share,
            'tokens32': tokens32, 'ms32': ms32, 'tokens16': tokens16,
            'ms16': ms16, 'model16': model16, 'x16': x16, 'pp_ms': pp_ms}


def phase_tensor_pipeline(dev, smi, ctx, seen):
    """23a-23c, from 22a's spawn (``ctx``: ``phase_shard_steps``'s third
    result), its MP gloo ranks sharing the card (NCCL refuses two ranks on
    one device), against one process: 23a the fp32 steps of the captioner
    and proposal cells (22a's one-process runs) and of the LoRA captioner
    under mp 2, each rank's bytes beside one process's and beside the
    predicted share; 23b the decode cell with mp-2 parameters, fp32 and
    bf16, beside one process's tokens and captions/s; 23c the flagship
    encoder pipelined over pp 2 (one layer a stage, PP_MICRO
    microbatches) against the sequential stack, fp32 and bf16, its ms
    beside the stack's. Returns ({run: launches summed over the ranks},
    numbers)."""
    spec, single, share = ctx['spec'], ctx['single'], ctx['share']
    tokens32, ms32 = ctx['tokens32'], ctx['ms32']
    tokens16, ms16 = ctx['tokens16'], ctx['ms16']
    model16, x16, pp_ms = ctx['model16'], ctx['x16'], ctx['pp_ms']
    ranks = ctx['ranks']
    launches, report = {}, {'spawn_s': ctx['spawn_s'],
                            'share_predicted': share}
    mib = 2 ** 20
    # 23a
    for name in ('captioner', 'proposal', 'lora'):
        got = torch.load(os.path.join(ctx['ref_dir'], 'mp', f'{name}.pt'))
        one = single[name]
        mine = [r['jobs']['mp']['cells'][name] for r in ranks]
        errs = step_errors(mine[0], one['metrics'], got, one['want'])
        tol = PROP_STEP_TOL if name == 'proposal' else STEP_TOL
        for key, e in errs.items():
            check(e <= tol[key], f'23a mp {name} steps: {key} error {e} '
                  f'(tol {tol[key]})')
        for r in mine:
            check(all(r['launches'].values()), f'23a mp {name}: a rank '
                  f'launched {r["launches"]}')
            seen.update(r['shapes'])
            check(any(sh[2] == 4 // MP for sh in r['shapes']),
                  f'23a mp {name}: no launch at H = {4 // MP}')
        if name == 'lora':
            # the ReLU inputs near 0 (a tie that the two runs' rounding may
            # put on either side moves the adapters' gradient: ROADMAP.md,
            # section 3)
            near, flips = kink_flips(one['kinks'],
                                     [r['kinks'] for r in mine])
            last = [(k, a, b, f'{v:.2e}', f'{w:.2e}')
                    for k, c, a, b, v, w in flips if c + 1 == DP_STEPS]
            print(f'      [23a] lora: {near} ReLU inputs within {KINK} of 0 '
                  f'in one process\'s {DP_STEPS} steps, {len(flips)} of '
                  f'them on the other side under mp {MP}, '
                  f'{len(flips) - len(last)} before step {DP_STEPS}; at '
                  f'step {DP_STEPS} (fc1, row, unit, one process, mp): '
                  f'{last}')
            base = {n: w for n, w in one['want'].items() if 'lora' not in n}
            moved = [n for n in base if not torch.equal(got[n], base[n])]
            check(not moved, f'23a mp lora: base leaves moved: {moved[:3]}')
            check(any(got[n].abs().sum() > 0 for n in got
                      if n.endswith('lora_b')), '23a mp lora: no adapter '
                  'moved')
        launches[f'23a {name}'] = {k: sum(r['launches'][k] for r in mine)
                                   for k in (KERNEL, KERNEL_DQ, KERNEL_DKV)}
        rep = report[name] = {
            'errors': errs, 'ms': statistics.median(mine[0]['ms'][1:]),
            'single_ms': statistics.median(one['ms'][1:]),
            'rank_init_MiB': [r['init_bytes'] / mib for r in mine],
            'rank_step_MiB': [r['step_bytes'] / mib for r in mine],
            'rank_held_MiB': [{k: v / mib for k, v in r['held'].items()}
                              for r in mine],
            'single_init_MiB': one['init_bytes'] / mib,
            'single_step_MiB': one['step_bytes'] / mib,
            'init_share': mine[0]['init_bytes'] / max(one['init_bytes'], 1)}
        predicted = (f', predicted {share[name]:.3f} of the parameters'
                     if name in share else '')
        print(f'      [23a] {name} fp32 under mp {MP}, {DP_STEPS} Adam '
              f'steps: errors {errs} (tolerances {tol}); ms a step (median '
              f'of steps 2-{DP_STEPS}): {MP} ranks sharing one card '
              f'{rep["ms"]:.2f} ({CONTENDED}), one process '
              f'{rep["single_ms"]:.2f}; MiB '
              f'allocated after init a rank '
              f'{[round(v, 1) for v in rep["rank_init_MiB"]]}, one process '
              f'{rep["single_init_MiB"]:.1f} (share {rep["init_share"]:.3f}'
              f'{predicted}); after the steps '
              f'{[round(v, 1) for v in rep["rank_step_MiB"]]}, one process '
              f'{rep["single_step_MiB"]:.1f}; a rank\'s sharded / whole '
              f'leaves (parameters, moments) MiB {rep["rank_held_MiB"]} '
              f'({smi}); launches {launches[f"23a {name}"]}')
    # 23b
    dec = {}
    for dtype, want, ms1 in ((torch.float32, tokens32, ms32),
                             (torch.bfloat16, tokens16, ms16)):
        mine = ranks[0]['decode'][str(dtype)]
        for r in ranks[1:]:
            check(torch.equal(r['decode'][str(dtype)]['tokens'],
                              mine['tokens']), f'23b {dtype}: the mp ranks '
                  f'decoded different tokens')
        got, want = mine['tokens'], want.cpu()
        rows = [i for i in range(spec.b)
                if not torch.equal(got[i], want[i])]
        worst = 0.0
        if dtype == torch.float32:
            lp_err = max(r['decode'][str(dtype)]['lp_err'] for r in ranks)
            check(lp_err <= LOGPROB_TOL, f'23b fp32: step log-probs along '
                  f'one process\'s trajectory off by {lp_err}')
        else:
            lp_err = None
            for i in rows:
                step = next(c for c in range(1, spec.steps + 1)
                            if got[i, c] != want[i, c]) - 1
                worst = max(worst, trajectory_gap(model16, x16,
                                                  want.to(dev), 'kernel',
                                                  i, step))
            check(worst <= BF16_GAP_TOL, f'23b bf16: mp-2 tokens part from '
                  f'one process\'s at a top-2 gap of {worst}')
        cps = spec.b / (statistics.median(mine['ms']) / 1e3)
        cps1 = spec.b / (statistics.median(ms1) / 1e3)
        dec[str(dtype)[6:]] = {'rows_differ': len(rows), 'lp_err': lp_err,
                               'worst_gap': worst, 'captions_per_s': cps,
                               'single_captions_per_s': cps1}
        print(f'      [23b] decode cell (B={spec.b}, Sa={spec.sa}, '
              f'Sv={spec.sv}, {spec.steps} steps) {str(dtype)[6:]} with '
              f'mp-{MP} parameters: {spec.b - len(rows)} of {spec.b} rows '
              f'equal one process\'s'
              + (f', step log-probs along its trajectory within {lp_err:.3e}'
                 f' (tol {LOGPROB_TOL})' if lp_err is not None else
                 f' (the rest near-ties, top-2 gap <= {worst:.3e}, tol '
                 f'{BF16_GAP_TOL})')
              + f'; captions/s {MP} ranks sharing one card {cps:.1f} '
                f'({CONTENDED}), one process {cps1:.1f} ({smi})')
    report['decode'] = dec
    launches['23b decode'] = summed([{'launches': r['decode_launches']}
                                     for r in ranks])
    check(launches['23b decode'][KERNEL] > 0, '23b: no forward launch')
    del model16, ctx['model16']
    # 23c
    pp = {}
    for dtype in (torch.float32, torch.bfloat16):
        mine = [r['pp'][str(dtype)] for r in ranks]
        out_err = max(m['out_err'] for m in mine)
        grad_err = max(m['grad_err'] for m in mine)
        tol = PP_TOL[dtype]
        check(out_err <= tol[0] and grad_err <= tol[1],
              f'23c pp {dtype}: outputs {out_err}, gradients {grad_err} '
              f'(tol {tol})')
        check(sorted(sum((m['layers'] for m in mine), [])) == sorted(
            set(sum((m['layers'] for m in mine), []))), '23c: a layer on '
            'both stages')
        key = f'23c pp {str(dtype)[6:]}'
        launches[key] = {k: sum(m['launches'][k] for m in mine)
                         for k in (KERNEL, KERNEL_DQ, KERNEL_DKV)}
        check(all(launches[key].values()), f'{key}: launches '
              f'{launches[key]}')
        ms = statistics.median(mine[0]['ms'])
        bubble = (MP - 1) / (spec.pp_micro + MP - 1)
        parts = {k: max(m[k] for m in mine) for k in ('ffn_err',
                                                      'rest_err')}
        flips = {k: v for m in mine for k, v in m['relu_flips'].items()}
        by_layer = {i: v for m in mine for i, v in m['by_layer'].items()}
        pp[str(dtype)[6:]] = {'out_err': out_err, 'grad_err': grad_err,
                              **parts, 'ms': ms,
                              'sequential_ms': pp_ms[str(dtype)],
                              'bubble': bubble, 'relu_flips': flips,
                              'by_layer': by_layer}
        print(f'      [23c] flagship encoder (N=2, B={spec.pp_b}, '
              f'Sa={spec.sa}, Sv={spec.sv}) {str(dtype)[6:]} over pp {MP} '
              f'({spec.pp_micro} microbatches, bubble {bubble:.2f}): '
              f'outputs rel L2 '
              f'{out_err:.2e}, gradients {grad_err:.2e} (the feed-forwards '
              f'{parts["ffn_err"]:.2e}, the rest {parts["rest_err"]:.2e}; '
              f'tol {tol}); ms a '
              f'forward + backward {ms:.2f} pipelined ({MP} ranks sharing '
              f'one card, {CONTENDED}), {pp_ms[str(dtype)]:.2f} sequential '
              f'in one '
              f'process ({smi}); launches {launches[key]}')
        print(f'        ReLU inputs on the other side of 0 from the '
              f'sequential stack\'s, by layer (ff_M1 audio, ff_M2 video): '
              + ', '.join(f'{k} {v["flips"]} of {v["of"]} (|x| <= '
                          f'{v["max_abs"]:.1e})' for k, v in flips.items())
              + '; gradients rel L2 by layer (feed-forwards, the rest): '
              + ', '.join(f'{i} {v["ffn"]:.2e}, {v["rest"]:.2e}'
                          for i, v in sorted(by_layer.items())))
    report['pipeline'] = pp
    for r in ranks:
        seen.update(r['shapes23'])
    torch.cuda.empty_cache()
    return launches, report


def phase_mp_kernel_times(dev, smi):
    """23e's times: the three kernels at MP_TIME_CASES in bf16 and fp32,
    beside their plain versions, the library call and their bound."""
    out = {}
    for case in MP_TIME_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            t = kernel_times(case, dev, dtype=dtype)
            out[f'{case[0]} {str(dtype)[6:]}'] = t
            print(f'      {case[0]:26s} B={case[1]} H={case[2]} '
                  f'Sq={case[3]} Sk={case[4]} {str(dtype)[6:]}: '
                  + '; '.join(f'{k} {v["kernel"]:.4f} ms (plain '
                              f'{v["plain"]:.4f}, library '
                              f'{v["library"]:.4f}, bound {v["bound"]:.4f} '
                              f'by {v["bound_by"]})'
                              for k, v in t.items()) + f' ({smi})')
    return out


# ---------------------------------------------------------------------------
# multi-step dispatch: CUDA graphs of the train steps
# ---------------------------------------------------------------------------

MULTISTEP_K = 4                         # steps a bundle (--steps_per_dispatch)
MULTISTEP_ROUNDS = 3                    # timed bundles a path, alternating
MULTISTEP_EMA = 0.999                   # the cells' EMA, so it is compared


def state_tensors(state) -> dict:
    '''{kind: [tensors]} of what a train step changes: the parameters,
    Adam's moments, the optimizer's device counters and rate table, the
    EMA.'''
    opt = state.optimizer
    return {'param': list(state.model.parameters()),
            'moment': [v for p in opt.params
                       for v in opt.inner.state.get(p, {}).values()],
            'counter': opt.device_state(),
            'ema': list((state.ema or {}).values())}


def state_diffs(a, b) -> dict:
    '''{kind: max |a - b|} over ``state_tensors``.'''
    ta, tb = state_tensors(a), state_tensors(b)
    check(all(len(ta[k]) == len(tb[k]) for k in ta), 'states differ in '
          'their tensors')
    return {k: max(((x.double() - y.double()).abs().max().item()
                    for x, y in zip(ta[k], tb[k])), default=0.0)
            for k in ta}


def traced_spans(fns: dict) -> dict:
    '''{name: (device busy ms, wall ms)} of each fn() in one
    torch.profiler session: the union of the device activity's intervals
    that fall inside the fn's span (the card synchronised at both ends of
    it), beside the span itself; (None, wall) where the profiler saw no
    device event.'''
    from torch.profiler import ProfilerActivity, profile
    spans = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, fn in fns.items():
            with torch.profiler.record_function(f'span {name}'):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                spans[name] = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    marks = {e.name[len('span '):]: (e.time_range.start, e.time_range.end)
             for e in events if e.name.startswith('span ')
             and e.device_type != torch.autograd.DeviceType.CUDA}
    out = {}
    for name, wall in spans.items():
        lo, hi = marks.get(name, (0, -1))
        inside = [e for e in events if lo <= e.time_range.start
                  and e.time_range.end <= hi]
        busy = device_busy_ms(inside)
        out[name] = (busy['union_ms'] if busy['kernels'] else None, wall)
    return out


def multistep_cell(label, make, batches, tol, want, smi):
    '''One train cell through ``make_multistep`` against the same steps run
    eagerly: ``make()`` gives (state, step) fresh from one seed, twice.
    Two bundles of the K ``batches`` (the first warms the graph up on its
    first batch and captures it on the second) against 2K eager steps from
    the same state: the losses and every tensor of the states agree within
    ``tol`` and bit for bit (threefry: the step key is a graph input),
    and each bundle launches the K steps' kernels (``want`` a step, and
    the dropout kernel) from the graph. Then MULTISTEP_ROUNDS timed
    bundles a path in turns (host clock, the card synchronised at both
    ends; ms a step), after which the states are compared again. Returns
    (numbers, a function that runs one graphed bundle).'''
    eager, step_e = make()
    graphed, step_g = make()
    multistep = make_multistep(step_g)
    diffs, launches = [], []

    def eager_bundle():
        nonlocal eager
        out = []
        for b in batches:
            eager, m = step_e(eager, b)
            out.append(m['loss'])
        return torch.stack(out)

    def graph_bundle():
        nonlocal graphed
        graphed, m = multistep(graphed, batches)
        return m['loss']

    def compare(le, lg):
        d = state_diffs(eager, graphed)
        d['loss'] = (le.double() - lg.double()).abs().max().item()
        check(torch.isfinite(lg).all().item(), f'{label}: graphed losses '
              f'{lg.tolist()}')
        check(d['loss'] <= tol['loss'] * le.abs().max().item()
              and max(d[k] for k in ('param', 'moment', 'counter', 'ema'))
              <= tol['param'], f'{label}: graphed bundle against eager '
              f'steps: {d} (tol {tol})')
        diffs.append(d)

    for _ in range(2):
        le = eager_bundle()
        reset_launch_counts()
        lg = graph_bundle()
        torch.cuda.synchronize()
        counts = launch_counts()
        drawn = kernel_launches.counts([prng.KERNEL_DROPOUT,
                                        prng.KERNEL_BITS32])
        launches.append({**counts, **drawn})
        check(counts == {k: len(batches) * n for k, n in want.items()},
              f'{label}: a bundle launched {counts}, {want} a step '
              f'expected')
        check(drawn[prng.KERNEL_DROPOUT] > 0 and drawn[
            prng.KERNEL_DROPOUT] % len(batches) == 0, f'{label}: a bundle '
            f'launched {drawn} of the threefry kernels')
        compare(le, lg)
        # threefry: each replay's masks come from the step key its input
        # buffer holds, so the bundle is its eager steps bit for bit
        check(all(v == 0 for v in diffs[-1].values()), f'{label}: the '
              f'graphed threefry bundle is not its eager steps bit for '
              f'bit: {diffs[-1]}')
    report = graphed.graphs.report()
    check(report['graphs'] == 1
          and report['replays'] == 2 * len(batches) - 1,
          f'{label}: graphs {report}')
    times = {'eager': [], 'graphed': []}
    fns = {'eager': eager_bundle, 'graphed': graph_bundle}
    lasts = {}
    order = ('eager', 'graphed', 'graphed', 'eager') * MULTISTEP_ROUNDS
    for path in order[:2 * MULTISTEP_ROUNDS]:
        out, secs = synced(fns[path])
        times[path].append(1e3 * secs / len(batches))
        lasts[path] = out
    compare(lasts['eager'], lasts['graphed'])
    med = {k: statistics.median(v) for k, v in times.items()}
    worst = {k: max(d[k] for d in diffs) for k in diffs[0]}
    print(f'    {label}: graphed bundle against eager steps, max |diff| '
          f'after bundles 1, 2 and the timed rounds: {worst} (tol {tol}); '
          f'launches a bundle {launches[-1]}; {report["graphs"]} graph, '
          f'captured in {report["capture_s"]:.3f} s, its pool '
          f'{report["pool_mib"]:.1f} MiB')
    print(f'      ms per step (host clock, median of {MULTISTEP_ROUNDS} '
          f'bundles of {len(batches)}; {smi}): eager {med["eager"]:.2f} '
          f'{[round(t, 2) for t in times["eager"]]}, graphed '
          f'{med["graphed"]:.2f} {[round(t, 2) for t in times["graphed"]]}'
          f' ({med["eager"] / med["graphed"]:.2f}x)')
    numbers = {'max_abs_diff': worst, 'launches_per_bundle': launches[-1],
               'eager_ms': med['eager'], 'graphed_ms': med['graphed'],
               'eager_ms_all': times['eager'],
               'graphed_ms_all': times['graphed'], **report}
    del eager
    return numbers, graph_bundle


def phase_multistep(dev, smi, tree, log, k1_loss):
    '''Phase 24: --steps_per_dispatch on the card. 24a the captioner's
    train cell in bf16 and fp32 and the proposal cell (bf16, remat) as
    graphed bundles of MULTISTEP_K against eager steps, with one trace of
    a bundle of each; 24b ``python -m bmt_tpu_torch --procedure train_cap
    --steps_per_dispatch MULTISTEP_K`` on phase 17's tree, its epoch loss
    beside 17a's (``k1_loss``, K = 1). Returns ({path: launches},
    numbers).'''
    out, bundles = {}, {}
    cap = CapModelDims(voc_size=VOC)                  # dropout 0.1
    cap_batches = [train_batch(240 + i, TB, SV, SA, TSC, cap)
                   for i in range(MULTISTEP_K)]
    for dtype in (torch.bfloat16, torch.float32):
        name = f'captioner {str(dtype)[6:]}'

        def make(dtype=dtype):
            model = BiModalTransformer(
                cap, device=dev,
                generator=torch.Generator(device=dev).manual_seed(24))
            state = init_train_state(model, build_optimizer(TRAIN_CFG,
                                                            model),
                                     seed=24, ema=True)
            return state, make_cap_train_step(
                cap, SMOOTHING, PAD, 'kernel', compute_dtype=dtype,
                ema_decay=MULTISTEP_EMA)
        out[name], bundles[name] = multistep_cell(
            f'[24a] {name} (B={TB}, Sa={SA}, Sv={SV}, Sc={TSC}, dropout '
            f'0.1, EMA {MULTISTEP_EMA})', make, cap_batches, STEP_TOL,
            dict.fromkeys((KERNEL, KERNEL_DQ, KERNEL_DKV), CALLS_PER_STEP),
            smi)
        torch.cuda.empty_cache()
    prop = PropModelDims(remat=True)                  # dropout 0.1
    prop_batches = [prop_train_batch(250 + i, PB, PSA, PSV, PE, prop)
                    for i in range(MULTISTEP_K)]

    def make_prop():
        model = proposal_model(prop, dev, 25)
        state = init_train_state(model, build_optimizer(
            TRAIN_CFG, model, frozen=prop_frozen(False)), seed=25, ema=True)
        return state, make_prop_train_step(prop, PAD, 'kernel',
                                           compute_dtype=torch.bfloat16,
                                           ema_decay=MULTISTEP_EMA)
    out['proposal bf16'], bundles['proposal bf16'] = multistep_cell(
        f'[24a] proposal bf16 (B={PB}, Sa={PSA}, Sv={PSV}, E={PE}, remat, '
        f'dropout 0.1, EMA {MULTISTEP_EMA})', make_prop, prop_batches,
        PROP_STEP_TOL, {KERNEL: 2 * PROP_CALLS, KERNEL_DQ: PROP_CALLS,
                        KERNEL_DKV: PROP_CALLS}, smi)
    for name, (busy, wall) in traced_spans(bundles).items():
        share = ('not measured: the profiler saw no device event'
                 if busy is None else
                 f'{busy:.2f} ms busy of {wall:.2f} ms ({busy / wall:.1%}; '
                 f'the union of its device intervals)')
        print(f'    [24a] traced graphed bundle, {name}: {share}')
        out[name]['traced_busy_ms'], out[name]['traced_wall_ms'] = busy, wall
    del bundles
    torch.cuda.empty_cache()
    launches, out['train_cap_k4'] = multistep_cli(dev, smi, tree, log,
                                                  k1_loss)
    return {'24b train_cap K4': launches}, out


def multistep_cli(dev, smi, tree, log, k1_loss):
    '''24b: train_cap with --steps_per_dispatch MULTISTEP_K on phase 17's
    tree; (launches, numbers).'''
    # two epochs: an epoch's 6 batches fall in as many bucket geometries,
    # each met once in the first epoch's bundle (a warm-up each); the
    # second epoch's bundle meets some again and captures and replays
    flags = [*CAP_FLAGS, '--one_by_one_starts_at', '2', '--epoch_num', '2',
             '--steps_per_dispatch', str(MULTISTEP_K)]
    print(f'    [24b] train_cap {" ".join(flags)} on phase 17\'s tree (the '
          f'1-by-1 validation left out; {smi}):')
    argv = ['--procedure', 'train_cap', *tree, *CLI_FLAGS, '--log_dir', log,
            *flags, '--exper_name', 'cap_k4']
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        _, secs, launches, stages = run_procedure(argv, dev,
                                                  collections.Counter())
    lines = printed.getvalue().splitlines()
    print('\n'.join(lines))
    graphs = [json.loads(line.strip()[len('[graphs] '):]) for line in lines
              if line.strip().startswith('[graphs] ')]
    check(graphs and graphs[-1]['replays'] > 0, f'train_cap '
          f'--steps_per_dispatch {MULTISTEP_K} replayed no graph: {graphs}')
    loss = logged(os.path.join(log, 'train_cap', 'cap_k4'),
                  'debug/train_loss_epoch')
    print(f'      epoch losses {loss}, epoch 0 against 17a\'s (K = 1) '
          f'{k1_loss}; graphs {graphs[-1]}')
    check(np.allclose(loss[:1], k1_loss[:1], rtol=1e-5), f'epoch 0 loss '
          f'{loss[0]} with bundles of {MULTISTEP_K}, {k1_loss[0]} without')
    return launches, {'s': secs, 'loss': loss, 'k1_loss': k1_loss,
                      'graphs': graphs[-1], **epoch_numbers(stages)}


# ---------------------------------------------------------------------------
# phase 25: the threefry2x32 kernels
# ---------------------------------------------------------------------------

DROPOUT_P = 0.1                         # CapModelDims' and the recipe's
THREEFRY_ROUNDS = 3                     # 25: alternating steps a PRNG path
INT32_LANES = 64                        # INT32 lanes an SM (Hopper)
ISSUE_LANES = 128                       # an SM's issue a clock: 4 x 32


def dropout_sites(dims=None) -> dict:
    '''{name: (shape, forward launches, backward launches)} of the
    captioner train cell's dropout tensors (B=TB, Sa=SA, Sv=SV, TSC - 1
    caption tokens; flagship widths): per encoder layer and modality three
    residuals, two attention outputs (B, H, S, d_k) and the feed-forward's
    hidden; per decoder layer four residuals and the bridge, three
    attention outputs and the hidden; one positional encoding a stream.
    The features' two have no backward (no parameter before them).'''
    d = dims or CapModelDims(voc_size=VOC)
    n, sc, dk, N = TB, TSC - 1, d.d_model // d.H, d.N
    feats = 0 if d.use_linear_embedder else 1
    return {
        'audio (B, Sa, 128)': ((n, SA, d.d_model_A), 1 + 3 * N,
                               1 - feats + 3 * N),
        'video (B, Sv, 1024)': ((n, SV, d.d_model_V), 1 + 3 * N,
                                1 - feats + 3 * N),
        'audio attention (B, 4, Sa, 256)': ((n, d.H, SA, dk), 2 * N, 2 * N),
        'video attention (B, 4, Sv, 256)': ((n, d.H, SV, dk), 2 * N, 2 * N),
        'audio ffn (B, Sa, 512)': ((n, SA, d.d_ff_A), N, N),
        'video ffn (B, Sv, 4096)': ((n, SV, d.d_ff_V), N, N),
        'caption (B, Sc-1, 300)': ((n, sc, d.d_model_C), 1 + 5 * N,
                                   1 + 5 * N),
        'caption attention (B, 4, Sc-1, 256)': ((n, d.H, sc, dk), 3 * N,
                                                3 * N),
        'caption ffn (B, Sc-1, 1200)': ((n, sc, d.d_ff_C), N, N)}


def dropout_launches_per_step(dims=None) -> int:
    return sum(f + b for _, f, b in dropout_sites(dims).values())


def sm_clocks(dev) -> tuple:
    '''(SM clocks a second over the card: SMs x its max SM clock, the clock
    in MHz).'''
    mhz = float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm',
         '--format=csv,noheader,nounits'], check=True, capture_output=True,
        text=True, timeout=60).stdout.split()[0])
    return _sm_count(dev) * mhz * 1e6, mhz


def threefry_bound(ops, alu_ops, nbytes, sm_hz) -> tuple:
    '''(least ms, 'operations' or 'bytes'): the larger of the bytes over
    HBM's rate and the integer work's least time, itself the larger of the
    INT32-lane ops (rotations, xors, compares) over INT32_LANES a clock an
    SM and all the integer ops over ISSUE_LANES (an add may run on the
    FP32 lanes as IMAD, but an SM issues 4 warp instructions a clock).'''
    t_ops = max(alu_ops / INT32_LANES, ops / ISSUE_LANES) / sm_hz * 1e3
    t_bytes = nbytes / 3.35e12 * 1e3
    return (t_ops, 'operations') if t_ops > t_bytes else (t_bytes, 'bytes')


def same_bits(a, b) -> bool:
    '''a and b equal bit for bit (NaNs and signed zeros included).'''
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(view[a.dtype]), b.view(view[b.dtype]))


def bernoulli_dropout(x, p=DROPOUT_P):
    '''The rbg path's draw (``ops.layers.Dropout`` with a generator).'''
    keep = torch.empty_like(x).bernoulli_(1.0 - p)
    return x * keep.div_(1.0 - p)


def threefry_checks(dev):
    '''25a: each kernel against its plain version, bit for bit. Returns
    the checks made.'''
    g = torch.Generator(device=dev).manual_seed(250)
    key = prng.Key(prng.key(25, dev), (3, 1))      # a step's site key
    made = 0
    for dtype in (torch.bfloat16, torch.float32):
        for name, (shape, _, _) in dropout_sites().items():
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            got = prng.dropout_kernel(x, key, DROPOUT_P, shape,
                                      (0,) * len(shape))
            want = prng.dropout_reference(x, key, DROPOUT_P)
            check(same_bits(got, want), f'25a {name} {dtype}: the dropout '
                  f'kernel differs from its plain version by '
                  f'{(got.float() - want.float()).abs().max().item()}')
            made += 1
        # the backward: the same mask on a gradient
        shape = dropout_sites()['video ffn (B, Sv, 4096)'][0]
        x = torch.randn(shape, generator=g, device=dev).to(
            dtype).requires_grad_()
        grad = torch.randn(shape, generator=g, device=dev).to(dtype)
        prng.dropout(x, key, DROPOUT_P).backward(grad)
        check(same_bits(x.grad, prng.dropout_reference(grad, key,
                                                       DROPOUT_P)),
              f'25a backward {dtype}: not the mask of the forward')
        # offset blocks: a dp 2 x mp 2 rank's block of the video
        # feed-forward's hidden, an sp 2 rank's of the proposal audio
        for whole, block, offsets in (((TB, SV, 4096), (TB // 2, SV, 2048),
                                       (TB // 2, 0, 2048)),
                                      ((PB, PSA, 128), (PB, PSA // 2, 128),
                                       (0, PSA // 2, 0))):
            x = torch.randn(whole, generator=g, device=dev).to(dtype)
            where = tuple(slice(o, o + b) for o, b in zip(offsets, block))
            got = prng.dropout_kernel(x[where].contiguous(), key, DROPOUT_P,
                                      whole, offsets)
            want = prng.dropout_reference(x, key, DROPOUT_P)[where]
            check(same_bits(got, want.contiguous()), f'25a block {block} at '
                  f'{offsets} of {whole} {dtype}: not that block of the '
                  f'whole mask')
            made += 2
    for shape, block, offsets in (((B, VOC), None, None),
                                  ((B, VOC), (B // 2, VOC), (B // 2, 0))):
        got = prng.bits32_kernel(key, shape, block, offsets)
        want = prng.bits_reference(key, shape, torch.uint32, block, offsets)
        check(torch.equal(got.to(torch.int64), want.to(torch.int64)),
              f'25a bits {shape} block {block}: the bits kernel differs '
              f'from its plain version')
        made += 1
    return made


def threefry_times(dev, smi, sm_hz):
    '''25b: {site: {dtype: ms of kernel, plain, F.dropout, bernoulli_,
    bound}} at the train cell's dropout shapes, and the bits kernel's at
    the decode cell's sampling draw.'''
    g = torch.Generator(device=dev).manual_seed(251)
    key = prng.Key(prng.key(25, dev), (3, 1))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        for name, (shape, fwd, bwd) in dropout_sites().items():
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            offsets = (0,) * len(shape)
            fns = {'kernel': lambda: prng.dropout_kernel(
                       x, key, DROPOUT_P, shape, offsets),
                   'F.dropout': lambda: F.dropout(x, DROPOUT_P, True),
                   'bernoulli_': lambda: bernoulli_dropout(x)}
            t = alternating_ms(fns, 20, device_ms)
            t['plain'] = cuda_ms(lambda: prng.dropout_reference(
                x, key, DROPOUT_P), 2)
            t['bound'], t['bound_by'] = threefry_bound(
                *prng.dropout_cost(x.numel(), dtype), sm_hz)
            t['launches_a_step'] = fwd + bwd
            out.setdefault(name, {})[dt] = t
    t = {'kernel': device_ms(lambda: prng.bits32_kernel(key, (B, VOC)), 20),
         'plain': cuda_ms(lambda: prng.bits_reference(key, (B, VOC)), 2),
         'torch.rand': device_ms(lambda: torch.rand(B, VOC, device=dev),
                                 20)}
    t['bound'], t['bound_by'] = threefry_bound(*prng.bits32_cost(B * VOC),
                                               sm_hz)
    out[f'sampling bits ({B}, {VOC})'] = {'uint32': t}
    return out


def threefry_step_times(dev, smi):
    '''25d: the captioner train cell's step under threefry2x32 and rbg, in
    bf16 and fp32: ms a step (host clock, the card synchronised), medians
    of alternating steps; the dropout launches of one threefry step.'''
    dims = CapModelDims(voc_size=VOC)                 # dropout 0.1
    batch = train_batch(31, TB, SV, SA, TSC, dims)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = BiModalTransformer(
            dims, device=dev,
            generator=torch.Generator(device=dev).manual_seed(26))
        step = make_cap_train_step(dims, SMOOTHING, PAD, 'kernel',
                                   compute_dtype=dtype)
        states = {impl: init_train_state(model, build_optimizer(
                      TRAIN_CFG, model), seed=26, prng_impl=impl)
                  for impl in ('threefry2x32', 'rbg')}
        for state in states.values():                 # warm-up
            step_ms(state, step, batch)
        reset_launch_counts()
        step_ms(states['threefry2x32'], step, batch)
        per_step = prng.dropout_kernel.launches
        check(per_step == dropout_launches_per_step(), f'25d: a threefry '
              f'step launched {per_step} dropout kernels, '
              f'{dropout_launches_per_step()} expected from its sites')
        times = {impl: [] for impl in states}
        for impl in ('rbg', 'threefry2x32', 'threefry2x32',
                     'rbg') * THREEFRY_ROUNDS:
            ms, m = step_ms(states[impl], step, batch)
            check(torch.isfinite(m['loss']).item(), f'25d {impl}: loss')
            times[impl].append(ms)
        med = {impl: statistics.median(v) for impl, v in times.items()}
        out[str(dtype)[6:]] = {'median_ms': med, 'ms': times,
                               'dropout_launches_a_step': per_step}
        print(f'    [25d] captioner train step {str(dtype)[6:]} (B={TB}, '
              f'Sa={SA}, Sv={SV}, Sc={TSC}, dropout {DROPOUT_P}; {smi}): '
              f'threefry2x32 {med["threefry2x32"]:.2f} ms '
              f'{[round(t, 2) for t in times["threefry2x32"]]}, rbg '
              f'{med["rbg"]:.2f} ms {[round(t, 2) for t in times["rbg"]]} '
              f'(median of {2 * THREEFRY_ROUNDS} alternating steps each); '
              f'{per_step} dropout launches a threefry step')
        del model, states
        torch.cuda.empty_cache()
    return out


def threefry_sampling(dev, smi):
    '''25c: make_bimodal_sample_fn (top-k 50, top-p 0.9) on the flagship
    captioner at the decode cell, the counts set to 0 just before and read
    just after; the same tokens again from a fresh binder of that seed, and
    the categorical draw on the card against the CPU's on the same logits.
    Returns (launches, numbers).'''
    dims = CapModelDims(voc_size=VOC)
    model = BiModalTransformer(
        dims, device=dev,
        generator=torch.Generator(device=dev).manual_seed(27)).eval()
    g = torch.Generator(device=dev).manual_seed(28)
    x = features(g, B, SV, SA, dims, dev)

    def decode():
        fn = make_bimodal_sample_fn(dims, STEPS, START, END, PAD,
                                    top_k=50, top_p=0.9,
                                    attention_impl='kernel', seed=5)
        return fn(model, x)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    tokens = decode()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = kernel_launches.counts()
    again = decode()
    check(torch.equal(tokens, again), '25c: a seed sampled other tokens')
    check(bool(((tokens >= 0) & (tokens < VOC)).all()), '25c: token ids')
    check(launches[prng.KERNEL_BITS32] > 0, f'25c: the sampled decode '
          f'launched {launches}')
    logits = torch.randn(B, VOC, generator=g, device=dev) * 3
    key = prng.key(29, dev)
    on_card = prng.categorical(key, logits)
    on_cpu = prng.categorical(key.cpu(), logits.cpu())
    agree = (on_card.cpu() == on_cpu).float().mean().item()
    check(agree >= 0.95, f'25c: categorical draws on the card and the CPU '
          f'agree on {agree:.1%} of the rows')
    print(f'    [25c] sampled decode (B={B}, Sa={SA}, Sv={SV}, {STEPS} steps, '
          f'top-k 50, top-p 0.9): {secs:.3f} s, launches {launches}; a '
          f'second binder of the seed gives the same tokens; categorical on '
          f'the card = on the CPU in {agree:.1%} of {B} rows (the Gumbel '
          f'noise\'s log may differ in the last bit)')
    del model
    torch.cuda.empty_cache()
    return launches, {'s': secs, 'launches': launches,
                      'categorical_agree': agree}


def recorded_draws(fn) -> collections.Counter:
    '''fn()'s calls of ``prng.dropout``: {(x's shape, x's memory order
    (``prng.memory_order``), the global shape, the offsets): calls}.'''
    draws, real = collections.Counter(), prng.dropout

    def record(x, k, p, shape=None, offsets=None):
        draws[(tuple(x.shape), prng.memory_order(x),
               tuple(x.shape if shape is None else shape),
               tuple((0,) * x.dim() if offsets is None else offsets))] += 1
        return real(x, k, p, shape, offsets)
    prng.dropout = record
    try:
        fn()
    finally:
        prng.dropout = real
    return draws


def prop_threefry_cell(dev, smi):
    '''25d's proposal cell (bf16, B=PB, Sa=PSA, Sv=PSV, E=PE, remat,
    dropout 0.1): the draws of one eager threefry step (``recorded_draws``;
    25a holds the kernel to its plain version at each), then graphed
    bundles of MULTISTEP_K steps under threefry2x32 and rbg in turns (host
    clock, the card synchronised at both ends; ms a step), the dropout
    launches of a threefry bundle from the graph and none of an rbg one.
    Returns (draws, numbers).'''
    dims = PropModelDims(remat=True)                  # dropout 0.1
    batches = [prop_train_batch(260 + i, PB, PSA, PSV, PE, dims)
               for i in range(MULTISTEP_K)]
    model = proposal_model(dims, dev, 26)
    step = make_prop_train_step(dims, PAD, 'kernel',
                                compute_dtype=torch.bfloat16)
    multistep = make_multistep(step)
    states = {impl: init_train_state(model, build_optimizer(
                  TRAIN_CFG, model, frozen=prop_frozen(False)), seed=26,
                  prng_impl=impl) for impl in ('threefry2x32', 'rbg')}

    def eager():
        states['threefry2x32'], m = step(states['threefry2x32'], batches[0])
        check(torch.isfinite(m['loss']).item(), '25d proposal: loss')
    draws = recorded_draws(eager)
    check(any(order not in (None, tuple(range(len(shape))))
              for shape, order, _, _ in draws), f'25d proposal: no draw '
          f'read a transposed view: {sorted(draws)}')

    def bundle(impl):
        states[impl], m = multistep(states[impl], batches)
        check(torch.isfinite(m['loss']).all().item(), f'25d proposal '
              f'{impl}: losses {m["loss"].tolist()}')
    for impl in states:      # the first batch eager, the second captured
        bundle(impl)
    launched = {}
    for impl in states:
        reset_launch_counts()
        synced(lambda: bundle(impl))
        launched[impl] = prng.dropout_kernel.launches
    per_step = launched['threefry2x32'] // MULTISTEP_K
    check(per_step > 0 and launched['threefry2x32'] % MULTISTEP_K == 0
          and launched['rbg'] == 0, f'25d proposal: a bundle launched '
          f'{launched} dropout kernels')
    times = {impl: [] for impl in states}
    for impl in ('rbg', 'threefry2x32', 'threefry2x32',
                 'rbg') * THREEFRY_ROUNDS:
        _, secs = synced(lambda: bundle(impl))
        times[impl].append(1e3 * secs / MULTISTEP_K)
    med = {impl: statistics.median(v) for impl, v in times.items()}
    print(f'    [25d] proposal train step bf16 graphed (B={PB}, Sa={PSA}, '
          f'Sv={PSV}, E={PE}, remat, dropout {DROPOUT_P}; bundles of '
          f'{MULTISTEP_K}; {smi}): threefry2x32 {med["threefry2x32"]:.2f} '
          f'ms {[round(t, 2) for t in times["threefry2x32"]]}, rbg '
          f'{med["rbg"]:.2f} ms {[round(t, 2) for t in times["rbg"]]} '
          f'(median of {2 * THREEFRY_ROUNDS} alternating bundles each); '
          f'{per_step} dropout launches a threefry step; {len(draws)} '
          f'distinct draws in {sum(draws.values())} calls of an eager step')
    del model, states, multistep
    torch.cuda.empty_cache()
    return draws, {'median_ms': med, 'ms': times,
                   'dropout_launches_a_step': per_step}


def prop_threefry_checks(dev, draws):
    '''25a at the proposal cell: the kernel against its plain version at
    each recorded draw (bf16; x laid out in the draw's memory order, so
    the heads' transposed views are read in place and the result keeps
    their strides), and the backward of a transposed draw. Then the
    largest transposed draw's device ms read in place, beside a copy to
    (B, S, C) and the kernel on it (the path before the kernel took a
    layout). Returns (the checks made, those ms).'''
    g = torch.Generator(device=dev).manual_seed(252)
    key = prng.Key(prng.key(25, dev), (4, 2))
    made, transposed = 0, None
    for shape, order, whole, offsets in sorted(draws, key=str):
        order = order or tuple(range(len(shape)))
        inverse = tuple(order.index(d) for d in range(len(shape)))
        x = torch.randn([shape[d] for d in order], generator=g,
                        device=dev).to(torch.bfloat16).permute(inverse)
        got = prng.dropout_kernel(x, key, DROPOUT_P, whole, offsets)
        want = prng.dropout_reference(x.contiguous(), key, DROPOUT_P, whole,
                                      offsets)
        check(got.stride() == x.stride()
              and same_bits(got.contiguous(), want), f'25a proposal draw '
              f'{shape} (memory order {order}) of {whole} at {offsets}: the '
              f'dropout kernel differs from its plain version by '
              f'{(got.float() - want.float()).abs().max().item()}')
        made += 1
        if order != tuple(range(len(shape))) and (
                transposed is None or x.numel() > transposed[0].numel()):
            transposed = (x, whole, offsets)
    x, whole, offsets = transposed
    leaf = x.detach().clone().requires_grad_()
    grad = torch.randn(x.shape, generator=g, device=dev).to(torch.bfloat16)
    prng.dropout(leaf, key, DROPOUT_P, whole, offsets).backward(grad)
    check(same_bits(leaf.grad.contiguous(), prng.dropout_reference(
        grad, key, DROPOUT_P, whole, offsets)), f'25a proposal backward of '
        f'a transposed draw {tuple(x.shape)}: not the mask of the forward')
    ms = alternating_ms(
        {'in place': lambda: prng.dropout_kernel(x, key, DROPOUT_P, whole,
                                                 offsets),
         'copy, then the kernel': lambda: prng.dropout_kernel(
             x.contiguous(), key, DROPOUT_P, whole, offsets)}, 20, device_ms)
    ms['draw'] = f'{tuple(x.shape)} of {whole} at {offsets}'
    return made + 1, ms


def phase_threefry(dev, smi):
    '''Phase 25 (module docstring). Returns (the two kernels' report
    entries, the sampled decode's launches, numbers).'''
    t0 = time.perf_counter()
    made = threefry_checks(dev)
    print(f'    [25a] {made} checks bit for bit against the plain versions '
          f'(the train cell\'s nine dropout shapes in bf16 and fp32, the '
          f'backward, two offset blocks in each dtype, the sampling bits '
          f'and a block of their rows): max_abs_err 0 '
          f'({time.perf_counter() - t0:.1f} s)')
    sm_hz, mhz = sm_clocks(dev)
    times = threefry_times(dev, smi, sm_hz)
    print(f'    [25b] device ms a call (p {DROPOUT_P}; bound: the larger '
          f'of the bytes over 3.35 TB/s, {prng.DROPOUT_ALU_OPS} '
          f'INT32-lane ops an element over {INT32_LANES} a clock an SM and '
          f'{prng.DROPOUT_INT_OPS} integer ops over {ISSUE_LANES}, '
          f'{_sm_count(dev)} SMs x {mhz:.0f} MHz; {smi}):')
    for name, by_dtype in times.items():
        for dt, t in by_dtype.items():
            print(f'      {name:36s} {dt:8s} ' + ', '.join(
                f'{k} {v:.4f}' for k, v in t.items()
                if isinstance(v, float)) + f' ({t["bound_by"]}; '
                f'{t.get("launches_a_step", "-")} launches a step)')
    share = {}
    for dt in ('bfloat16', 'float32'):
        share[dt] = sum(t[dt]['kernel'] * t[dt]['launches_a_step']
                        for n, t in times.items() if dt in t)
    launches, sampling = threefry_sampling(dev, smi)
    steps = threefry_step_times(dev, smi)
    draws, steps['proposal bfloat16'] = prop_threefry_cell(dev, smi)
    t0 = time.perf_counter()
    prop_made, head_ms = prop_threefry_checks(dev, draws)
    made += prop_made
    print(f'    [25a] {prop_made} checks bit for bit at the proposal cell: '
          f'its {len(draws)} distinct draws (bf16), each in its memory '
          f'order, and a transposed draw\'s backward: max_abs_err 0 '
          f'({time.perf_counter() - t0:.1f} s)')
    print(f'    [25b] proposal head draw {head_ms["draw"]} (bf16, a (B, C, S) '
          f'conv output through its (B, S, C) view; {smi}): device ms in '
          f'place {head_ms["in place"]:.4f}, a copy then the kernel '
          f'{head_ms["copy, then the kernel"]:.4f}')
    times['proposal head, transposed'] = {'bfloat16': head_ms}
    for dt, ms in share.items():
        step = steps[dt]['median_ms']['threefry2x32']
        print(f'    [25e] {dt}: the dropout kernels {ms:.3f} ms a step '
              f'(device ms x launches, summed over the sites), '
              f'{ms / step:.1%} of the threefry step\'s {step:.2f} ms')
    big, dt = 'video ffn (B, Sv, 4096)', 'bfloat16'
    at = times[big][dt]
    bits = times[f'sampling bits ({B}, {VOC})']['uint32']
    entries = [
        {'name': prng.KERNEL_DROPOUT, 'max_abs_err': 0.0,
         'ms': at['kernel'], 'plain_ms': at['plain'], 'bound_ms': at['bound'],
         'bound_by': at['bound_by'], 'library_ms': None,
         'library_call': None, 'at': f'{big} {dt}',
         'context_ms': {'F.dropout': at['F.dropout'],
                        'bernoulli_': at['bernoulli_']}},
        {'name': prng.KERNEL_BITS32, 'max_abs_err': 0.0,
         'ms': bits['kernel'], 'plain_ms': bits['plain'],
         'bound_ms': bits['bound'], 'bound_by': bits['bound_by'],
         'library_ms': None, 'library_call': None,
         'at': f'sampling bits ({B}, {VOC})',
         'context_ms': {'torch.rand': bits['torch.rand']}}]
    numbers = {'checks': made, 'times': times,
               'int32_lane_tops': sm_hz * INT32_LANES / 1e12,
               'sm_clock_mhz': mhz, 'dropout_ms_a_step': share,
               'sampling': sampling, 'train_step': steps}
    return entries, launches, numbers


def main():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: no CUDA device; this smoke test runs only on '
                 'the GPU')
    dev = torch.device(DEVICE)
    t_main, started = time.perf_counter(), {}        # s from here, by phase
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 parity is fp32
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = device_line()
    started[1] = round(time.perf_counter() - t_main, 1)
    print(f'[1] device: {name} | nvidia-smi: {smi} | torch '
          f'{torch.__version__} CUDA {torch.version.cuda}')
    print(smi)                                       # name, power limit

    t0 = time.perf_counter()
    # the three CUDA sources and the two host libraries build side by side
    with ThreadPoolExecutor(5) as pool:
        hosts = {n: pool.submit(build_host_library, n)
                 for n in HOST_LIBRARIES}
        libraries = (KERNEL, BWD_LIBRARY, prng.LIBRARY)
        cuda_builds = dict(zip(libraries, pool.map(timed_load, libraries)))
        host_builds = {n: f.result() for n, f in hosts.items()}
    check(native_io.native_available() and meteor_native.enabled(),
          'a host library does not serve: feature loader '
          f'{native_io.native_available()}, METEOR aligner '
          f'{meteor_native.enabled()}')
    started[2] = round(time.perf_counter() - t_main, 1)
    print(f'[2] kernels {sorted(set(SOURCES.values()))} built and loaded in '
          f'{time.perf_counter() - t0:.2f} s (nvcc and load: '
          + ', '.join(f'{n} {t:.2f} s' for n, t in cuda_builds.items())
          + '), beside the host libraries '
          + ', '.join(f'{os.path.relpath(p, REPO)} ({t:.2f} s)'
                      for t, p in host_builds.values()) + '; ptxas:')
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
    counts = {**sass_counts(KERNEL), **sass_counts(BWD_LIBRARY)}
    print('    machine code of the kernels (cuobjdump -sass):')
    for kname, c in sorted(counts.items()):
        print(f'      {kname}: ' + ', '.join(f'{op} {n}' for op, n in c.items()))
    for base in HOPPER_KERNELS:
        inst = {k: c for k, c in counts.items() if k.split('<')[0] == base}
        check(inst and all(c['HGMMA'] and c['UTMALDG'] and not c['HMMA']
                           for c in inst.values()),
              f'{base}: no HGMMA, no UTMALDG or an HMMA in its machine '
              f'code: {inst}')
    check(not any(c['HMMA'] for c in counts.values()),
          f'a kernel issues mma.sync (HMMA): {counts}')

    started[3] = round(time.perf_counter() - t_main, 1)
    print('[3] forward kernel vs plain PyTorch on the card:')
    max_err, worst = phase_kernel(dev)
    print(f'    max_abs_err by dtype: {worst}')

    started[4] = round(time.perf_counter() - t_main, 1)
    print('[4] training kernels vs plain PyTorch on the card:')
    train_err = phase_train_kernels(dev)
    print(f'    max_abs_err by kernel: {train_err}')

    started[5] = round(time.perf_counter() - t_main, 1)
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

    started[6] = round(time.perf_counter() - t_main, 1)
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

    started[7] = round(time.perf_counter() - t_main, 1)
    print(f'[7] train-step parity on the card (fp32, B=4, Sa={SA}, Sv={SV}, '
          f'Sc={TSC}, dropout off, 2 Adam steps, eps {PARITY_CFG.eps}):')
    phase_train_parity(dev)

    started[8] = round(time.perf_counter() - t_main, 1)
    print(f'[8] train step (bf16, then fp32; B={TB}, Sa={SA}, Sv={SV}, '
          f'Sc={TSC}, dropout 0.1, Adam lr {TRAIN_CFG.lr}, clip 1.0) on '
          f'{smi}:')
    train_ms, train_ms32, train_kernel_ms, train_kernel_ms32 = \
        phase_train_timing(dev, smi)

    started[9] = round(time.perf_counter() - t_main, 1)
    print('[9] trainer: train_epoch_cap (bf16, kernels):')
    trainer_launches = phase_trainer(dev)

    started[10] = round(time.perf_counter() - t_main, 1)
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
    gc_objects = len(gc.get_objects())
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
          f'{[round(t, 4) for t in times["torch"]]}; {gc_objects} objects '
          f'tracked by Python\'s garbage collector)')
    print(f'    uncached decoder (once): {base_s:.3f} s = '
          f'{B / base_s:.1f} captions/s; vs_baseline '
          f'{cps["kernel"] / (B / base_s):.2f}x')
    print(f'    train step ms: bf16 kernel {train_ms["kernel"]:.2f}, torch '
          f'{train_ms["torch"]:.2f}; fp32 kernel '
          f'{train_ms32["kernel"]:.2f}, torch {train_ms32["torch"]:.2f}')
    del model16, x16
    torch.cuda.empty_cache()

    started[11] = round(time.perf_counter() - t_main, 1)
    print(f'[11] the kernels at the proposal shapes (B=1 and B={PB}, H=4, '
          f'd=256, Sa={PSA}, Sv={PSV}, padded keys) vs plain PyTorch on the '
          f'card:')
    prop_err, prop_kernel_ms = phase_prop_kernels(dev, smi)
    print(f'    max_abs_err by kernel: {prop_err}')

    started[12] = round(time.perf_counter() - t_main, 1)
    print(f'[12] dense captioning (bf16, flagship PropModelDims(), pad '
          f'{PROP_PAD}, max_prop_per_vid {MAX_PROPS}) through VideoPipeline '
          f'and the phase-5 engine:')
    prop, videos, pipeline_launches = phase_dense_captioning(dev, engine, smi)

    started[13] = round(time.perf_counter() - t_main, 1)
    print('[13] proposal parity on the card (fp32, kernel vs torch):')
    phase_prop_parity(engine, prop, videos)
    del prop, videos
    torch.cuda.empty_cache()

    started[14] = round(time.perf_counter() - t_main, 1)
    print(f'[14] proposal train-step parity on the card (fp32, B=2, '
          f'Sa={PSA}, Sv={PSV}, E={PE}, dropout off, 2 Adam steps, eps '
          f'{PARITY_CFG.eps}):')
    phase_prop_train_parity(dev)
    torch.cuda.empty_cache()

    started[15] = round(time.perf_counter() - t_main, 1)
    print(f'[15] proposal train step (bf16, B={PB}, Sa={PSA}, Sv={PSV}, '
          f'E={PE}, remat, dropout 0.1, Adam lr {TRAIN_CFG.lr}, clip 1.0) on '
          f'{smi}:')
    prop_launches = phase_prop_train(dev, smi, prop_kernel_ms)
    torch.cuda.empty_cache()

    started[16] = round(time.perf_counter() - t_main, 1)
    print(f'[16] the single-video app from checkpoints (fp32, train_cap and '
          f'train_prop defaults, max_prop_per_vid {MAX_PROPS}) on {smi}:')
    app_launches, app_ms = phase_single_video_app(dev, smi)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        started[17] = round(time.perf_counter() - t_main, 1)
        print(f'[17] main.py\'s procedures through the port (python -m '
              f'bmt_tpu_torch: train_cap -> train_prop -> evaluate; '
              f'build_parser widths, bf16, --attention_impl pallas) from '
              f'.npy files:')
        proc_launches, procedures, cap_dir, prop_dir, tree, seen17 = \
            phase_main_procedures(dev, smi, tmp, host_builds)
        torch.cuda.empty_cache()
        started[18] = round(time.perf_counter() - t_main, 1)
        print(f'[18] the serving API from phase 17\'s checkpoints (python -m '
              f'bmt_tpu_torch.scripts.serve, bf16, --attention_impl pallas):')
        serve_launches, serving = phase_serving(dev, smi, cap_dir, prop_dir,
                                                tmp)
        torch.cuda.empty_cache()
        started[19] = round(time.perf_counter() - t_main, 1)
        print(f'[19] main.py\'s model and decode options through the port '
              f'(python -m bmt_tpu_torch: LoRA and MoE train_cap, evaluate '
              f'with beam, sampling and int8; build_parser widths, bf16, '
              f'--attention_impl pallas) on phase 17\'s tree and '
              f'checkpoints:')
        option_launches, options = phase_main_py_options(
            dev, smi, tmp, tree, cap_dir, prop_dir, procedures)
        torch.cuda.empty_cache()
        started[20] = round(time.perf_counter() - t_main, 1)
        print(f'[20] the uni-modal models and the acceptance chain through '
              f'the port (python -m bmt_tpu_torch --modality audio|video, '
              f'python -m bmt_tpu_torch.scripts.acceptance; build_parser '
              f'widths, bf16, --attention_impl pallas) on phase 17\'s tree '
              f'and checkpoints:')
        unimodal_launches, unimodal = phase_unimodal(
            dev, smi, tmp, tree, cap_dir, prop_dir, seen17)
        torch.cuda.empty_cache()
        started[21] = round(time.perf_counter() - t_main, 1)
        print(f'[21] export_decode, Adam\'s moments across the packages and '
              f'data parallelism (dp={DP}) on phase 17\'s tree and '
              f'checkpoints:')
        seen21 = collections.Counter()
        # the exports trace on the host in child processes while 21b-21d
        # run (their seconds are a cost of sharing the host with them)
        exports = start_exports(dev, cap_dir, tmp)
        print(f'    [21b] Adam\'s moments: train_cap resumed through '
              f'.opt.npz (CAP_FLAGS, no 1-by-1; build_parser widths, '
              f'bf16):')
        moment_launches, moments = phase_moments(dev, smi, tmp, tree,
                                                 seen21)
        print(f'    [21c] data parallelism, {DP} ranks spawned as python -m '
              f'bmt_tpu_torch spawns them:')
        dp_launches, dp_report = phase_data_parallel(dev, smi, tmp, tree,
                                                     prop_dir, seen21)
        print(f'    [21d] CaptionEngine with {DP} replicas on one card '
              f'(bf16, kernel):')
        engine_launches, engine_report = phase_engine_replicas(dev, smi,
                                                               cap_dir)
        print(f'    [21a] export_decode at the decode cell (B={B}, Sa={SA}, '
              f'Sv={SV}, {STEPS} steps, end token {END}), exported beside '
              f'21b-21d, replayed from bytes:')
        export_report, export_launches = phase_export(dev, smi, cap_dir,
                                                      seen21, exports)
        print(f'    [21e] the kernels against their plain versions at every '
              f'shape 21a-21d launched them, in that dtype and in fp32 '
              f'({len(seen21)} launch shapes, the ranks\' among them; those '
              f'an earlier phase checked are not checked again):')
        err21, worst21, checks21 = check_path_shapes(seen21, dev)
        print(f'      checks by dtype {checks21} all within TOL, LSE_TOL and '
              f'BWD_TOL; max_abs_err by kernel ' + ', '.join(
                  f'{n} {err21[n]:.3e} ({worst21.get(n, "no new shape")})'
                  for n in err21))
        export_dp = {'export': export_report, 'moments': moments,
                     'data_parallel': dp_report,
                     'engine_replicas': engine_report,
                     'path_shapes': {'launch_shapes': len(seen21),
                                     'checks': checks21,
                                     'max_abs_err': err21, 'at': worst21}}
        phase21_launches = {'export_replay': export_launches,
                            **{f'moments {k}': v
                               for k, v in moment_launches.items()},
                            **dp_launches, 'engine_replicas': engine_launches}
        started[22] = round(time.perf_counter() - t_main, 1)
        print(f'[22] --fsdp, expert and sequence parallelism ({DP} gloo '
              f'ranks sharing the card; not a scaling number):')
        seen22 = collections.Counter()
        # 22a's one-process references here; then its spawn (which runs
        # 23a-23c too) and 23d's dry run in threads beside 22b's four
        # spawned procedures; 23d's launch shapes go into seen23 and its
        # lines are printed in phase 23
        setup22 = shard_steps_setup(dev, tmp)
        seen23, lines23 = collections.Counter(), []
        print('    [22b] the procedures under each flag (build_parser '
              'widths, bf16, --attention_impl pallas, one epoch) on phase '
              '17\'s tree (22a\'s and 23d\'s spawns beside them):')
        shard_run_launches, shard_runs, beside = phase_shard_procedures(
            dev, smi, tmp, tree, cap_dir, seen22, beside={
                '22a': lambda: shard_steps_spawn(setup22, dev),
                '23d': lambda: phase_dryrun(dev, smi, seen23,
                                            lines23.append)})
        print(f'    [22a] fp32 train-step parity against one process '
              f'({DP_STEPS} Adam steps, dropout 0, eps {PARITY_CFG.eps}):')
        shard_step_launches, shard_steps, ctx23 = phase_shard_steps(
            dev, smi, setup22, *beside['22a'], seen22)
        del setup22
        print(f'    [22c] the kernels against their plain versions at every '
              f'shape 22a-22b launched them, in that dtype and in fp32 '
              f'({len(seen22)} launch shapes, the ranks\' among them; those '
              f'an earlier phase checked are not checked again), and their '
              f'times at the sp shapes:')
        err22, worst22, checks22 = check_path_shapes(seen22, dev)
        print(f'      checks by dtype {checks22} all within TOL, LSE_TOL and '
              f'BWD_TOL; max_abs_err by kernel ' + ', '.join(
                  f'{n} {err22[n]:.3e} ({worst22.get(n, "no new shape")})'
                  for n in err22))
        sp_ms = phase_sp_kernel_times(dev, smi)
        sharding = {'steps': shard_steps, 'procedures': shard_runs,
                    'sp_kernel_ms': sp_ms,
                    'path_shapes': {'launch_shapes': len(seen22),
                                    'checks': checks22,
                                    'max_abs_err': err22, 'at': worst22}}
        phase22_launches = {**{f'22a {k}': v
                                for k, v in shard_step_launches.items()},
                            **{f'22b {k}': v
                               for k, v in shard_run_launches.items()}}
        started[23] = round(time.perf_counter() - t_main, 1)
        print(f'[23] tensor and pipeline parallelism ({MP} gloo ranks '
              f'sharing the card; not a scaling number):')
        print(f'    [23a-c] (run in 22a\'s spawn) fp32 steps under mp {MP} '
              f'against one process ({DP_STEPS} Adam steps, dropout 0, eps '
              f'{PARITY_CFG.eps}), the decode cell with mp-{MP} parameters, '
              f'the flagship encoder over pp {MP}:')
        tp_launches, tensor_pipeline = phase_tensor_pipeline(
            dev, smi, ctx23, seen23)
        del ctx23
        print(f'    [23d] bmt_tpu_torch.scripts.dryrun_multichip '
              f'--n_devices {DRYRUN_N} --backend {DP_BACKEND} (its '
              f'dryrun_multichip, in this process, beside 22a\'s and 22b\'s '
              f'spawns; four ranks share the card):')
        tp_launches['23d dryrun ranks'], tensor_pipeline['dryrun'] = \
            beside['23d']
        print('\n'.join(lines23))
        print(f'    [23e] the kernels against their plain versions at every '
              f'shape 23a-23d launched them, in that dtype and in fp32 '
              f'({len(seen23)} launch shapes, the ranks\' among them; those '
              f'an earlier phase checked are not checked again), and their '
              f'times at H = {4 // MP}:')
        err23, worst23, checks23 = check_path_shapes(seen23, dev)
        print(f'      checks by dtype {checks23} all within TOL, LSE_TOL and '
              f'BWD_TOL; max_abs_err by kernel ' + ', '.join(
                  f'{n} {err23[n]:.3e} ({worst23.get(n, "no new shape")})'
                  for n in err23))
        tensor_pipeline['kernel_ms'] = phase_mp_kernel_times(dev, smi)
        tensor_pipeline['path_shapes'] = {
            'launch_shapes': len(seen23), 'checks': checks23,
            'max_abs_err': err23, 'at': worst23}
        torch.cuda.empty_cache()
        started[24] = round(time.perf_counter() - t_main, 1)
        print(f'[24] multi-step dispatch (--steps_per_dispatch '
              f'{MULTISTEP_K}): CUDA graphs of the train steps, the '
              f'attention kernels captured inside them:')
        multistep_launches, multistep = phase_multistep(
            dev, smi, tree, os.path.join(tmp, 'log'),
            logged(cap_dir, 'debug/train_loss_epoch'))

        torch.cuda.empty_cache()
        started[25] = round(time.perf_counter() - t_main, 1)
        print('[25] the threefry2x32 kernels (ops.prng): checks, times, a '
              'sampled decode and the train step beside rbg:')
        threefry_entries, sampling_launches, threefry = phase_threefry(
            dev, smi)

    # times at the train cell's encoder 256x256 call (forward with lse), and
    # at the proposal cell's 800x800 call; launches of each main path's run
    # (the captioning trainer's are the report's `launches`)
    at_prop = prop_kernel_ms[PROP_CASES[0][0]]
    at32 = train_kernel_ms32
    paths = {'train_epoch_cap': trainer_launches,
             'video_pipeline': pipeline_launches,
             'train_epoch_prop': prop_launches,
             'single_video_app': app_launches, **proc_launches,
             'serve': serve_launches, **option_launches,
             **unimodal_launches, **phase21_launches, **phase22_launches,
             **tp_launches, **multistep_launches}
    path_err = {k: max(procedures['path_shapes']['max_abs_err'][k],
                       options['path_shapes']['max_abs_err'][k],
                       unimodal['path_shapes']['max_abs_err'][k], err21[k],
                       err22[k], err23[k])
                for k in (KERNEL, KERNEL_DQ, KERNEL_DKV)}
    report = [
        (KERNEL, max(max_err, train_err[KERNEL], prop_err[KERNEL],
                     path_err[KERNEL], serving['path_shapes']['max_abs_err']),
         train_kernel_ms[KERNEL]),
        (KERNEL_DQ, max(train_err[KERNEL_DQ], prop_err[KERNEL_DQ],
                        path_err[KERNEL_DQ]), train_kernel_ms[KERNEL_DQ]),
        (KERNEL_DKV, max(train_err[KERNEL_DKV], prop_err[KERNEL_DKV],
                         path_err[KERNEL_DKV]), train_kernel_ms[KERNEL_DKV])]
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
        'fp32_train_256x256': {
            'ms': at32[kname]['kernel'], 'plain_ms': at32[kname]['plain'],
            'bound_ms': at32[kname]['bound'],
            'bound_by': at32[kname]['bound_by'],
            'library_ms': at32[kname]['library']},
        **({'fp32_app': {shape: {
            'ms': a['kernel'], 'plain_ms': a['plain'],
            'library_ms': a['library'], 'bound_ms': a['bound'],
            'bound_by': a['bound_by']} for shape, a in app_ms.items()}}
           if kname == KERNEL else {})}
        for kname, err, t in report] + [{
            'route': 'cuda', 'source': SOURCES[e['name']],
            'replaces': REPLACES[e['name']],
            'launches': (trainer_launches if e['name'] == prng.KERNEL_DROPOUT
                         else sampling_launches)[e['name']],
            **e, 'launches_by_path': {
                'train_epoch_cap': trainer_launches[e['name']],
                'sampled_decode': sampling_launches[e['name']]}}
            for e in threefry_entries],
        'threefry': threefry,
        'fp32_train_step_ms': train_ms32,
        'main_py_procedures': procedures, 'serving': serving,
        'main_py_options': options, 'unimodal': unimodal,
        'export_dp': export_dp, 'sharding': sharding,
        'tensor_pipeline': tensor_pipeline, 'multistep': multistep,
        'phase_started_s': started,
        'script_s': round(time.perf_counter() - t_main, 1)}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
