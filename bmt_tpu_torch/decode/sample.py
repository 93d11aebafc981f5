'''Stochastic caption decoding: temperature, top-k and nucleus sampling
(counterpart of ``bmt_tpu.decode.sample``).

The log-probs are divided by the temperature, cut to the top-k tokens and/or
the smallest nucleus whose probability mass exceeds top_p, and a token is
drawn from what is left, through the greedy loop's ``select_fn``.

Determinism and the draws: JAX's, from its threefry2x32 PRNG
(``ops.prng``). A bound sampler (``make_bimodal_sample_fn``) keys its
n-th call fold_in(PRNGKey(seed), n), and step t of a decode draws
``categorical(fold_in(key, t), logits)``: argmax of the filtered logits
plus Gumbel noise made from the key's uniform floats (JAX
``decode/sample.py:85-88, 144-150``). So a seed reproduces its captions,
and they are JAX's up to near ties (the noise's log may differ from
XLA's in its last bits). Each step draws the noise of the whole batch by
each element's global index; a decode of a block of its rows (data
parallelism, ``rows``) draws only its rows of it, so a split batch samples
the captions of the undivided one. On the card the bits come from
``threefry_bits32_kernel``.
'''
from __future__ import annotations

import torch

from bmt_tpu_torch.decode.greedy import (_greedy_core, bimodal_step_setup,
                                         stacks_device, unimodal_step_setup)
from bmt_tpu_torch.ops import prng

# the nucleus is cut inside the top _TOP_P_SUPPORT tokens (see filter_logits)
_TOP_P_SUPPORT = 512


def filter_logits(log_probs: torch.Tensor, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    '''Mask a (B, V) set of log-prob rows to the sampling support (-inf
    elsewhere); fp32.

    top_k > 0: keep the tokens scoring at least the k-th score of the row
    (a value threshold, so exact ties with it survive; k is clamped to V).
    top_p < 1: keep the smallest prefix of the descending order whose mass
    exceeds top_p (at least one token). The cut is at a sorted position
    inside the top ``_TOP_P_SUPPORT`` tokens, with the probabilities taken
    from the softmax over the whole row, so it is exact whenever the nucleus
    fits in that support. Both filters compose.'''
    filtered = log_probs.float()
    V = filtered.shape[-1]
    if top_k and top_k > 0:
        kth = torch.topk(filtered, min(top_k, V), dim=-1).values[:, -1:]
        filtered = filtered.masked_fill(filtered < kth, -torch.inf)
    if top_p < 1.0:
        support = min(_TOP_P_SUPPORT, V)
        top_lp, top_idx = torch.topk(filtered, support, dim=-1)  # descending
        lse = torch.logsumexp(filtered, dim=-1, keepdim=True)
        probs = torch.exp(top_lp - lse)
        csum = torch.cumsum(probs, dim=-1)
        # a sorted position is out when the mass before it exceeds top_p
        cut = (csum - probs) > top_p
        keep = torch.zeros_like(filtered, dtype=torch.bool).scatter_(
            -1, top_idx, ~cut)
        filtered = filtered.masked_fill(~keep, -torch.inf)
    return filtered


def _key(seed, device) -> prng.Key:
    '''The decode's key: ``seed`` an int (PRNGKey(seed)), a tuple (seed,
    data, ...) (PRNGKey(seed) with the data folded in: a bound sampler's
    (seed, call)), or a key tensor or ``prng.Key``.'''
    if isinstance(seed, prng.Key):
        return prng.Key(seed.base.to(device), seed.path)
    if isinstance(seed, torch.Tensor):
        return prng.Key(seed.to(device))
    seed = tuple(seed) if isinstance(seed, (tuple, list)) else (int(seed),)
    return prng.Key(prng.key(seed[0], device), tuple(seed[1:]))


def make_sample_select_fn(seed, temperature: float = 1.0, top_k: int = 0,
                          top_p: float = 1.0, rows=None):
    '''The per-step sampler for ``_greedy_core``: step t draws
    ``categorical(fold_in(key, t), filtered log-probs)``, JAX's draw.
    ``seed``: the decode's key (``_key``). ``rows``: (lo, B) when the
    log-probs are rows lo.. of a B-row batch: the step's noise is that
    block of the B rows' draw.'''
    if temperature <= 0:
        raise ValueError(
            f'temperature must be > 0, got {temperature} (use greedy '
            f'decoding for argmax behaviour)')
    t = float(temperature)
    keys = {}             # {device: the decode's key there}

    def select(log_probs, step):
        logits = filter_logits(log_probs.float() / t, top_k, top_p)
        if logits.device not in keys:
            keys[logits.device] = _key(seed, logits.device)
        return prng.categorical(keys[logits.device].fold_in(step), logits,
                                rows)

    return select


@torch.inference_mode()
def sample_decode_bimodal(model, feature_stacks: dict, seed, max_len: int,
                          start_idx: int, end_idx: int, pad_idx: int,
                          temperature: float = 1.0, top_k: int = 0,
                          top_p: float = 1.0, attention_impl: str = 'torch',
                          kv_int8: bool = False, rows=None) -> torch.Tensor:
    '''KV-cached stochastic decode: the greedy decoder's interface and
    output, plus the ``seed`` of the draws and the stacks' ``rows`` in
    their batch (``make_sample_select_fn``).'''
    select = make_sample_select_fn(seed, temperature, top_k, top_p, rows)
    state, step_fn, B = bimodal_step_setup(model, feature_stacks, pad_idx,
                                           max_len, attention_impl, kv_int8)
    return _greedy_core(step_fn, state, B, max_len, start_idx, end_idx,
                        feature_stacks['audio'].device, select_fn=select)


@torch.inference_mode()
def sample_decode_unimodal(model, feature_stacks: dict, seed, max_len: int,
                           start_idx: int, end_idx: int, pad_idx: int,
                           temperature: float = 1.0, top_k: int = 0,
                           top_p: float = 1.0, attention_impl: str = 'torch',
                           kv_int8: bool = False, rows=None) -> torch.Tensor:
    '''``sample_decode_bimodal`` for a uni-modal captioner.'''
    select = make_sample_select_fn(seed, temperature, top_k, top_p, rows)
    state, step_fn, B = unimodal_step_setup(model, feature_stacks, pad_idx,
                                            max_len, attention_impl, kv_int8)
    return _greedy_core(step_fn, state, B, max_len, start_idx, end_idx,
                        stacks_device(feature_stacks), select_fn=select)


def make_bimodal_sample_fn(dims, max_len: int, start_idx: int, end_idx: int,
                           pad_idx: int, temperature: float = 1.0,
                           top_k: int = 0, top_p: float = 1.0,
                           attention_impl: str = 'torch',
                           kv_int8: bool = False, seed: int = 0):
    '''Bind the static arguments; returns fn(model, feature_stacks) ->
    tokens. Each call advances a counter that joins the seed, so successive
    batches draw fresh samples, reproducibly for a run. Dispatches on
    ``dims.modality``, as the JAX binder does.

    The n-th call's key is fold_in(PRNGKey(seed), n), as JAX's binder
    keys it. ``fn.for_batch()`` takes one call's number and returns
    part(model, feature_stacks, rows) for the blocks of that batch
    (``rows`` = (lo, B)): data parallelism binds a batch once, on the
    caller's thread, so which replica or rank decodes a block changes no
    draw.'''
    make_sample_select_fn(seed, temperature)       # a bad temperature raises
    decode = (sample_decode_bimodal if dims.modality == 'audio_video'
              else sample_decode_unimodal)
    counter = [0]

    def for_batch():
        call = counter[0]
        counter[0] += 1

        def part(model, feature_stacks, rows=None):
            return decode(model, feature_stacks, (seed, call), max_len,
                          start_idx, end_idx, pad_idx, temperature, top_k,
                          top_p, attention_impl, kv_int8, rows)
        return part

    def fn(model, feature_stacks):
        return for_batch()(model, feature_stacks)
    fn.for_batch = for_batch
    return fn
