'''Greedy caption decoding (counterpart of ``bmt_tpu.decode.greedy``).

The encoder runs once per batch, the cross-attention K/V are computed once,
and the decoder advances one token at a time through a KV cache. The JAX
package runs the loop as one ``lax.while_loop`` that stops on the device once
every row has emitted ``end_idx``; here the loop is Python over eager
kernels, and the batch-wide stop test is a device-to-host sync per step.
``greedy_decode_uncached`` re-runs the full forward on the growing prefix, as
the reference does, and serves as the parity check and the baseline.

The uni-modal captioners (``UniModalTransformer``) decode through the same
loop over their one memory (``unimodal_step_setup``); the ``make_*_fn``
binders pick the decoder of ``dims.modality``.
'''
from __future__ import annotations

import torch

from bmt_tpu_torch.ops.masks import make_masks


def _greedy_core(step_fn, state, B: int, max_len: int, start_idx: int,
                 end_idx: int, device, select_fn=None) -> torch.Tensor:
    '''step_fn(state, cur (B, 1), step) -> ((B, V) log-probs, state).
    select_fn(log_probs, step) -> (B,) next tokens; the default is greedy
    argmax, which takes the first maximum (``decode.sample`` plugs its
    sampler in here). Returns tokens (B, max_len + 1): row = [start, w1,
    ...]; positions after the batch stopped hold ``end_idx``.'''
    if select_fn is None:
        def select_fn(log_probs, step):
            return log_probs.argmax(dim=-1)
    tokens = torch.full((B, max_len + 1), end_idx, dtype=torch.long,
                        device=device)
    tokens[:, 0] = start_idx
    done = torch.zeros(B, dtype=torch.bool, device=device)
    for step in range(max_len):
        log_probs, state = step_fn(state, tokens[:, step:step + 1], step)
        nxt = select_fn(log_probs, step)
        tokens[:, step + 1] = nxt
        done |= nxt == end_idx
        if bool(done.all()):            # host sync once per step
            break
    return tokens


def bimodal_step_setup(model, feature_stacks: dict, pad_idx: int,
                       max_len: int, attention_impl: str = 'torch',
                       kv_int8: bool = False, cache_batch_mult: int = 1):
    '''Masks, the encoder and the decode state, shared by the greedy,
    sampling and beam decoders; returns (state, step_fn, B).
    ``kv_int8`` stores the cross-attention K/V int8;
    ``cache_batch_mult``: self-attention cache rows per batch row (beam
    search passes its width K; the cross K/V stay at B rows).'''
    masks = make_masks(feature_stacks, None, 'audio_video', pad_idx)
    A_mask, V_mask = masks['A_mask'], masks['V_mask']
    Av, Va = model.encode(feature_stacks, masks, attention_impl)
    B = Av.shape[0]
    state = model.decode_init(Av, Va, max_len, kv_int8=kv_int8,
                              cache_batch=B * cache_batch_mult,
                              A_mask=A_mask, V_mask=V_mask)

    def step_fn(state, cur, step):
        return model.decode_step(state, cur, step, A_mask, V_mask)

    return state, step_fn, B


@torch.inference_mode()
def greedy_decode_bimodal(model, feature_stacks: dict, max_len: int,
                          start_idx: int, end_idx: int, pad_idx: int,
                          attention_impl: str = 'torch',
                          kv_int8: bool = False) -> torch.Tensor:
    '''Batched KV-cached greedy decode.

    feature_stacks: {'rgb', 'flow', 'audio'} (B, S, D) padded segments on
    the model's device. ``kv_int8`` stores the cross-attention K/V int8
    (``ops.attention.precompute_kv``). Returns int64 tokens
    (B, max_len + 1).'''
    state, step_fn, B = bimodal_step_setup(model, feature_stacks, pad_idx,
                                           max_len, attention_impl, kv_int8)
    return _greedy_core(step_fn, state, B, max_len, start_idx, end_idx,
                        feature_stacks['audio'].device)


def unimodal_step_setup(model, feature_stacks: dict, pad_idx: int,
                        max_len: int, attention_impl: str = 'torch',
                        kv_int8: bool = False, cache_batch_mult: int = 1):
    '''``bimodal_step_setup`` for a uni-modal captioner: the mask of its
    modality, its encoder's one memory and the decode state over it.'''
    modality = model.dims.modality
    src_mask = model.src_mask(make_masks(feature_stacks, None, modality,
                                         pad_idx))
    memory = model.encode(feature_stacks, src_mask, attention_impl)
    B = memory.shape[0]
    state = model.decode_init(memory, max_len, kv_int8=kv_int8,
                              cache_batch=B * cache_batch_mult,
                              src_mask=src_mask)

    def step_fn(state, cur, step):
        return model.decode_step(state, cur, step, src_mask)

    return state, step_fn, B


def stacks_device(feature_stacks: dict) -> torch.device:
    '''The device of the feature stacks (any of them).'''
    return next(iter(feature_stacks.values())).device


@torch.inference_mode()
def greedy_decode_unimodal(model, feature_stacks: dict, max_len: int,
                           start_idx: int, end_idx: int, pad_idx: int,
                           attention_impl: str = 'torch',
                           kv_int8: bool = False) -> torch.Tensor:
    '''``greedy_decode_bimodal`` for a uni-modal captioner: the stacks of
    its modality ('audio', or 'rgb' and 'flow').'''
    state, step_fn, B = unimodal_step_setup(model, feature_stacks, pad_idx,
                                            max_len, attention_impl, kv_int8)
    return _greedy_core(step_fn, state, B, max_len, start_idx, end_idx,
                        stacks_device(feature_stacks))


def make_bimodal_greedy_fn(dims, max_len: int, start_idx: int, end_idx: int,
                           pad_idx: int, attention_impl: str = 'torch',
                           kv_int8: bool = False):
    '''Bind the static arguments once; returns fn(model, feature_stacks)
    -> tokens, the interface of ``CaptionEngine(decode_fn=...)``. A
    uni-modal ``dims`` binds ``greedy_decode_unimodal``, as the beam and
    sampling binders dispatch.'''
    decode = (greedy_decode_bimodal if dims.modality == 'audio_video'
              else greedy_decode_unimodal)

    def fn(model, feature_stacks):
        return decode(model, feature_stacks, max_len, start_idx, end_idx,
                      pad_idx, attention_impl, kv_int8)
    return fn


@torch.inference_mode()
def greedy_decode_uncached(forward_fn, feature_stacks: dict, max_len: int,
                           start_idx: int, end_idx: int, pad_idx: int,
                           modality: str = 'audio_video') -> torch.Tensor:
    '''The reference's greedy loop: the full forward over the whole prefix
    at every step. forward_fn(src, trg, masks) -> (B, St, V) log-probs.
    Returns int64 tokens (B, <= max_len + 1).'''
    src = feature_stacks['audio' if 'audio' in modality else 'rgb']
    B = src.shape[0]
    done = torch.zeros((B, 1), dtype=torch.bool, device=src.device)
    trg = torch.full((B, 1), start_idx, dtype=torch.long, device=src.device)
    while trg.shape[-1] <= max_len and not bool(done.all()):
        masks = make_masks(feature_stacks, trg, modality, pad_idx)
        preds = forward_fn(feature_stacks, trg, masks)
        next_word = preds[:, -1].argmax(dim=-1)[:, None]
        trg = torch.cat([trg, next_word], dim=-1)
        done = done | (next_word == end_idx)
    return trg
