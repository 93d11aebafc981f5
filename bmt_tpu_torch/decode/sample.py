'''Stochastic caption decoding: temperature, top-k and nucleus sampling
(counterpart of ``bmt_tpu.decode.sample``).

The log-probs are divided by the temperature, cut to the top-k tokens and/or
the smallest nucleus whose probability mass exceeds top_p, and a token is
drawn from what is left, through the greedy loop's ``select_fn``.

Determinism: each step draws from its own ``torch.Generator`` on the
log-probs' device, seeded from (seed, call, step), where ``call`` counts the
calls of a bound sampler (``make_bimodal_sample_fn``); so a seed reproduces
its captions. The draws are not JAX's (its PRNG is another), so the two
packages agree on the filter (``filter_logits``, exactly) and on the
sampler's invariants, not on the tokens drawn.
'''
from __future__ import annotations

import numpy as np
import torch

from bmt_tpu_torch.decode.greedy import (_greedy_core, bimodal_step_setup,
                                         stacks_device, unimodal_step_setup)

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


def _step_generator(seed: tuple, step: int, device) -> torch.Generator:
    words = np.random.SeedSequence([*seed, step]).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed(int(words[0]) << 31 | int(words[1]) >> 1)
    return g


def make_sample_select_fn(seed, temperature: float = 1.0, top_k: int = 0,
                          top_p: float = 1.0):
    '''The per-step sampler for ``_greedy_core``: Gumbel-max over the
    filtered log-probs (a draw from their softmax). ``seed``: an int or a
    tuple of ints.'''
    if temperature <= 0:
        raise ValueError(
            f'temperature must be > 0, got {temperature} (use greedy '
            f'decoding for argmax behaviour)')
    t = float(temperature)
    seed = tuple(seed) if isinstance(seed, (tuple, list)) else (int(seed),)

    def select(log_probs, step):
        logits = filter_logits(log_probs.float() / t, top_k, top_p)
        g = _step_generator(seed, step, logits.device)
        u = torch.rand(logits.shape, generator=g, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return (logits + gumbel).argmax(dim=-1)

    return select


@torch.inference_mode()
def sample_decode_bimodal(model, feature_stacks: dict, seed, max_len: int,
                          start_idx: int, end_idx: int, pad_idx: int,
                          temperature: float = 1.0, top_k: int = 0,
                          top_p: float = 1.0, attention_impl: str = 'torch',
                          kv_int8: bool = False) -> torch.Tensor:
    '''KV-cached stochastic decode: the greedy decoder's interface and
    output, plus the ``seed`` of the draws.'''
    select = make_sample_select_fn(seed, temperature, top_k, top_p)
    state, step_fn, B = bimodal_step_setup(model, feature_stacks, pad_idx,
                                           max_len, attention_impl, kv_int8)
    return _greedy_core(step_fn, state, B, max_len, start_idx, end_idx,
                        feature_stacks['audio'].device, select_fn=select)


@torch.inference_mode()
def sample_decode_unimodal(model, feature_stacks: dict, seed, max_len: int,
                           start_idx: int, end_idx: int, pad_idx: int,
                           temperature: float = 1.0, top_k: int = 0,
                           top_p: float = 1.0, attention_impl: str = 'torch',
                           kv_int8: bool = False) -> torch.Tensor:
    '''``sample_decode_bimodal`` for a uni-modal captioner.'''
    select = make_sample_select_fn(seed, temperature, top_k, top_p)
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
    ``dims.modality``, as the JAX binder does.'''
    make_sample_select_fn(seed, temperature)       # a bad temperature raises
    decode = (sample_decode_bimodal if dims.modality == 'audio_video'
              else sample_decode_unimodal)
    counter = [0]

    def fn(model, feature_stacks):
        call = counter[0]
        counter[0] += 1
        return decode(model, feature_stacks, (seed, call), max_len,
                      start_idx, end_idx, pad_idx, temperature, top_k, top_p,
                      attention_impl, kv_int8)
    return fn
