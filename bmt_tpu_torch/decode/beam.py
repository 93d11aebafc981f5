'''Batched beam search with KV caches (counterpart of ``bmt_tpu.decode.beam``).

Length-penalized beam search (the GNMT penalty ((5 + len) / 6)^alpha; alpha
0 ranks by the log-prob sum, a negative alpha favours shorter captions):

- the encoder runs once, and the cross-attention K/V stay at B rows, shared
  by the beams (``ops.attention.cross_attention_step`` folds the K beams of
  a row into query positions); only the self-attention caches have B x K
  rows;
- only beam 0 is live at the start (K equal prefixes would fill the top-k);
- a finished beam extends only with ``</s>``, at zero cost;
- each step takes the top K of the K x V candidates of a row and reorders
  every B x K-row state tensor by parent beam. The self-attention step
  writes its caches in place (``self_attention_step``), so the reorder
  gathers them into fresh tensors: no beam writes into another's cache;
- the loop stops once every beam of every row is done (a host sync a step,
  as the greedy loop).

K = 1 is greedy decoding. JAX's ``lax.top_k`` and ``torch.topk`` may order
exact ties differently; with real-valued weights ties do not occur.
'''
from __future__ import annotations

import torch

from bmt_tpu_torch.decode.greedy import (bimodal_step_setup, stacks_device,
                                         unimodal_step_setup)

_NEG_INF = -1e9


def _reorder(node, index: torch.Tensor, rows: int):
    '''Every tensor of ``node`` (nested dicts, lists, tuples) with ``rows``
    leading rows gathered by ``index`` into a new tensor; the rest (the
    cross K/V at B rows) as it is.'''
    if isinstance(node, dict):
        return {k: _reorder(v, index, rows) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_reorder(v, index, rows) for v in node)
    if isinstance(node, torch.Tensor) and node.dim() and \
            node.shape[0] == rows:
        return node.index_select(0, index)
    return node


def _beam_core(step_fn, state, B: int, K: int, V: int, max_len: int,
               start_idx: int, end_idx: int, length_penalty: float, device):
    '''step_fn(state, cur (B*K, 1), step) -> ((B*K, V) log-probs, state).
    Returns (best tokens (B, max_len + 1) int64, their scores (B,) fp32).'''
    tokens = torch.full((B, K, max_len + 1), end_idx, dtype=torch.long,
                        device=device)
    tokens[:, :, 0] = start_idx
    scores = torch.full((B, K), _NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    done = torch.zeros((B, K), dtype=torch.bool, device=device)
    frozen = torch.full((V,), _NEG_INF, dtype=torch.float32, device=device)
    frozen[end_idx] = 0.0
    row_base = (torch.arange(B, device=device) * K)[:, None]
    for step in range(max_len):
        cur = tokens.reshape(B * K, -1)[:, step:step + 1]
        log_probs, state = step_fn(state, cur, step)
        log_probs = log_probs.reshape(B, K, V).float()
        # finished beams extend only with </s>, at zero cost
        log_probs = torch.where(done[:, :, None], frozen, log_probs)
        cand = scores[:, :, None] + log_probs                 # (B, K, V)
        scores, idx = torch.topk(cand.reshape(B, K * V), K, dim=-1)
        parent = idx // V                                     # (B, K)
        word = idx % V
        tokens = torch.take_along_dim(tokens, parent[:, :, None], dim=1)
        tokens[:, :, step + 1] = word
        done = torch.take_along_dim(done, parent, dim=1) | (word == end_idx)
        if K > 1:        # at K = 1 the gather is the identity
            state = _reorder(state, (row_base + parent).reshape(-1), B * K)
        if bool(done.all()):            # host sync once per step
            break

    if length_penalty != 0.0:
        is_end = tokens[:, :, 1:] == end_idx
        first_end = torch.where(is_end.any(-1),
                                is_end.int().argmax(-1) + 1,
                                torch.full_like(scores, max_len,
                                                dtype=torch.long))
        final = scores / ((5.0 + first_end) / 6.0) ** length_penalty
    else:
        final = scores
    best = final.argmax(dim=1)                                # (B,)
    rows = torch.arange(B, device=device)
    return tokens[rows, best], final[rows, best]


@torch.inference_mode()
def beam_search_bimodal(model, feature_stacks: dict, max_len: int,
                        start_idx: int, end_idx: int, pad_idx: int,
                        beam_size: int = 4, length_penalty: float = 0.0,
                        attention_impl: str = 'torch',
                        kv_int8: bool = False):
    '''Returns (tokens (B, max_len + 1) int64, scores (B,) fp32): the best
    beam of each row, formatted as the greedy decoder's rows.'''
    K = beam_size
    state, step_fn, B = bimodal_step_setup(
        model, feature_stacks, pad_idx, max_len, attention_impl, kv_int8,
        cache_batch_mult=K)
    return _beam_core(step_fn, state, B, K, model.dims.voc_size, max_len,
                      start_idx, end_idx, length_penalty,
                      feature_stacks['audio'].device)


@torch.inference_mode()
def beam_search_unimodal(model, feature_stacks: dict, max_len: int,
                         start_idx: int, end_idx: int, pad_idx: int,
                         beam_size: int = 4, length_penalty: float = 0.0,
                         attention_impl: str = 'torch',
                         kv_int8: bool = False):
    '''``beam_search_bimodal`` for a uni-modal captioner.'''
    K = beam_size
    state, step_fn, B = unimodal_step_setup(
        model, feature_stacks, pad_idx, max_len, attention_impl, kv_int8,
        cache_batch_mult=K)
    return _beam_core(step_fn, state, B, K, model.dims.voc_size, max_len,
                      start_idx, end_idx, length_penalty,
                      stacks_device(feature_stacks))


def make_bimodal_beam_fn(dims, max_len: int, start_idx: int, end_idx: int,
                         pad_idx: int, beam_size: int = 4,
                         length_penalty: float = 0.0,
                         attention_impl: str = 'torch',
                         kv_int8: bool = False):
    '''Bind the static arguments; returns fn(model, feature_stacks) ->
    tokens, the greedy decoder's interface. Dispatches on
    ``dims.modality``, as the JAX binder does.'''
    search = (beam_search_bimodal if dims.modality == 'audio_video'
              else beam_search_unimodal)

    def fn(model, feature_stacks):
        return search(model, feature_stacks, max_len, start_idx, end_idx,
                      pad_idx, beam_size, length_penalty, attention_impl,
                      kv_int8)[0]
    return fn
