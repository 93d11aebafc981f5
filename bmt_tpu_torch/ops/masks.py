'''Padding and causal masks (counterpart of ``bmt_tpu.ops.masks``).

Booleans, True = attend. Feature padding is read from channel 0 of a feature
stack compared against the *vocabulary* pad index, as the reference does.
'''
from __future__ import annotations

import torch


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    '''Lower-triangular causal mask, (1, size, size).'''
    return torch.ones((1, size, size), dtype=torch.bool,
                      device=device).tril()


def pad_mask(src: torch.Tensor, pad_idx) -> torch.Tensor:
    '''(B, S) -> (B, 1, S), True where not padding.'''
    return (src != pad_idx)[:, None, :]


def mask(src: torch.Tensor, trg: torch.Tensor | None, pad_idx):
    '''src (B, S) -> src_mask (B, 1, S); with trg (B, St) also
    trg_mask (B, St, St) = padding AND causal.'''
    src_mask = pad_mask(src, pad_idx)
    if trg is None:
        return src_mask
    trg_mask = (trg != pad_idx)[:, None, :] & subsequent_mask(
        trg.shape[-1], trg.device)
    return src_mask, trg_mask


def make_masks(feature_stacks: dict, captions: torch.Tensor | None,
               modality: str, pad_idx) -> dict:
    '''The mask dict the models read, from channel 0 of the ``rgb`` and
    ``audio`` stacks: ``V_mask`` for ``video``, ``A_mask`` for ``audio``,
    both for ``audio_video``, plus ``S_mask`` from the ``subs`` token ids for
    ``subs_audio_video``; with captions also ``C_mask``.'''
    def src(key):
        return feature_stacks[key][:, :, 0]

    def with_captions(key):
        if captions is None:
            return mask(src(key), None, pad_idx), None
        return mask(src(key), captions, pad_idx)

    masks = {}
    if modality == 'video':
        masks['V_mask'], c_mask = with_captions('rgb')
    elif modality == 'audio':
        masks['A_mask'], c_mask = with_captions('audio')
    elif modality in ('audio_video', 'subs_audio_video'):
        masks['A_mask'] = mask(src('audio'), None, pad_idx)
        masks['V_mask'], c_mask = with_captions('rgb')
        if modality == 'subs_audio_video':
            masks['S_mask'] = mask(feature_stacks['subs'], None, pad_idx)
    else:
        raise ValueError(f'Unknown modality: {modality}')
    if c_mask is not None:
        masks['C_mask'] = c_mask
    return masks
