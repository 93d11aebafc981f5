'''Caption learned proposals and score them, the paper's headline pipeline
(counterpart of ``bmt_tpu.scripts.eval_on_learned_props``; reference:
scripts/eval_on_learned_props.py:14-135).

Flow: proposals JSON -> tsv meta (filtering unavailable videos) ->
'learned_props' captioning dataset (features re-cropped per proposal) ->
batched KV-cached decode -> submission JSON -> densevid scoring against both
validation references at tIoUs [0.3, 0.5, 0.7, 0.9].

The captioner is bi-modal or uni-modal (``--modality audio|video``), from a
native directory or a reference ``.pt``. The model config, its decode dtype
(``compute_dtype``) and its attention (``--attention_impl``, ``pallas`` as
the port's kernels and ``xla`` as plain attention) come from the checkpoint, as in the JAX script; a
reference ``.pt`` config has neither and decodes in fp32 through plain
attention. The decode options come from the command line:
``--decode_strategy`` (greedy, beam or sample) with ``--kv_cache_int8``,
and ``--weights_int8``, which quantizes the linears after the dtype cast
(``ops.quant.quantize_tree_int8``; a MoE FFN's router and experts stay as
they are, as in the JAX package, whose quantizer takes {w, b} linears
only).
'''
from __future__ import annotations

import json
import os

from bmt_tpu_torch.config import Config
from bmt_tpu_torch.data.captioning import CaptioningDataset
from bmt_tpu_torch.data.vocab import Vocab, build_vocab_from_meta
from bmt_tpu_torch.models import CapModelDims, captioner_class
from bmt_tpu_torch.ops.quant import quantize_tree_int8
from bmt_tpu_torch.params import load_jax_params
from bmt_tpu_torch.train.checkpoint import (
    cap_embedding_key, import_any_cap_model, load_model_params,
    load_torch_checkpoint, native_table_dim, read_checkpoint_meta)
from bmt_tpu_torch.train.loops import (make_decode_fn, make_strategy_fn,
                                       validation_1by1)
from bmt_tpu_torch.train.options import (attention_impl, check_model_ported,
                                         check_ported, compute_dtype,
                                         resolve_device)


def convert_props_in_json_to_csv(prop_pred_path: str, val_1_json_path: str,
                                 avail_mp4_path: str) -> str:
    '''Proposal predictions JSON -> tab-separated meta file
    (reference: eval_on_learned_props.py:14-72).'''
    if 'val_1' not in val_1_json_path:
        raise ValueError(f'Is it the val_1 json: {val_1_json_path}')
    pred_csv_path = prop_pred_path.replace('.json', '.csv')
    if os.path.exists(pred_csv_path):
        print(f'File {pred_csv_path} already exists. I will use it.')
        return pred_csv_path

    with open(prop_pred_path) as f:
        pred_json = json.load(f)['results']
    with open(val_1_json_path) as f:
        vid2duration = {vid: v['duration']
                        for vid, v in json.load(f).items()}
    with open(avail_mp4_path) as f:
        avail = {line.strip().replace('.mp4', '') for line in f}

    rows = []
    idx = 0
    for video_id, props in pred_json.items():
        if video_id not in avail or video_id not in vid2duration:
            continue
        for prop in props:
            start, end = prop['timestamp']
            rows.append((video_id, 'PLACEHOLDER', start, end,
                         vid2duration[video_id], 'val_1', idx))
            idx += 1

    with open(pred_csv_path, 'w') as f:
        f.write('video_id\tcaption_pred\tstart\tend\tduration\tphase\tidx\n')
        for r in rows:
            f.write('\t'.join(str(x) for x in r) + '\n')
    return pred_csv_path


def eval_on_learned_props(args_cfg: Config, device=None):
    '''Reference: eval_on_learned_props.py:85-135. ``args_cfg`` carries the
    CLI args; the model config comes from the checkpoint. Runs on the card
    unless ``device`` names another. Returns the metrics.'''
    device = resolve_device(device)
    check_ported(args_cfg)               # the run's options
    path = args_cfg.pretrained_cap_model_path
    params, ckpt_vocab = None, None
    if path.endswith('.pt'):
        cpt = load_torch_checkpoint(path)
        params, cfg_dict = import_any_cap_model(cpt)
        epoch = cpt.get('epoch', 0)
    else:
        meta = read_checkpoint_meta(path, 'best_cap_model')
        cfg_dict, epoch = meta['config'], meta.get('epoch', 0)
        # decode with the vocabulary the checkpoint was TRAINED with: a
        # rebuild from the CLI's train meta could order it differently
        if meta.get('vocab_itos'):
            ckpt_vocab = Vocab(meta['vocab_itos'])

    cfg = Config.from_dict({**cfg_dict})
    check_model_ported(cfg)              # the checkpoint's model
    # CLI overrides (reference: eval_on_learned_props.py:88-95)
    cfg.max_prop_per_vid = args_cfg.max_prop_per_vid
    cfg.log_path = os.path.split(path)[0] if path.endswith('.pt') else path
    cfg.train_meta_path = args_cfg.train_meta_path
    cfg.val_1_meta_path = args_cfg.val_1_meta_path
    cfg.val_2_meta_path = args_cfg.val_2_meta_path
    cfg.reference_paths = args_cfg.reference_paths
    cfg.tIoUs = args_cfg.tIoUs
    cfg.avail_mp4_path = args_cfg.avail_mp4_path
    for modality in ('audio', 'video'):
        if modality in cfg.modality:
            features = getattr(args_cfg, f'{modality}_features_path')
            if not os.path.exists(features):
                raise FileNotFoundError(f'no feature directory {features}')
            setattr(cfg, f'{modality}_features_path', features)

    # the reference passes reference_paths[0] (val_1_no_missings.json) as
    # the duration source verbatim (eval_on_learned_props.py:102-104)
    cfg.val_prop_meta_path = convert_props_in_json_to_csv(
        args_cfg.prop_pred_path, cfg.reference_paths[0], cfg.avail_mp4_path)
    print(cfg.log_path)

    # only the vocabulary is needed from the train split; the checkpoint's
    # own wins when present
    if ckpt_vocab is None:
        ckpt_vocab = build_vocab_from_meta(
            cfg.train_meta_path, cfg.start_token, cfg.end_token,
            cfg.pad_token, cfg.min_freq_caps)
    ds = CaptioningDataset(cfg, 'learned_props', vocab=ckpt_vocab)
    print(f'Loader will use: {ds.meta_path}')

    dims = CapModelDims.from_config(cfg, ds.trg_voc_size)
    emb_key = cap_embedding_key(cfg.modality)
    if params is not None:
        emb = params[emb_key]
        model = captioner_class(dims)(
            dims, device=device,
            table_dim=emb['table'].shape[1] if 'adapter' in emb else None)
        load_jax_params(model, params)
    else:
        model = captioner_class(dims)(
            dims, device=device,
            table_dim=native_table_dim(path, emb_key=emb_key))
        load_model_params(path, 'best_cap_model', model)

    # the decode dtype and attention follow the CHECKPOINT's training
    # config (a reference .pt carries neither: fp32, plain attention)
    dtype = compute_dtype(cfg)
    impl = attention_impl(cfg)
    model = model.to(dtype=dtype).eval()
    if getattr(args_cfg, 'weights_int8', False):
        quantize_tree_int8(model)
    decode_fn = make_decode_fn(
        make_strategy_fn(args_cfg, dims, cfg.max_len, ds, impl), dtype)
    metrics = validation_1by1(cfg, model, decode_fn, ds, epoch, logger=None,
                              phase='learned_props')
    print(metrics)
    return metrics
