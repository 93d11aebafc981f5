'''One-command acceptance chain against the reference's published
checkpoints (counterpart of ``bmt_tpu.scripts.acceptance``; reference:
README.md:64-92, 173-185):

    python -m bmt_tpu_torch.scripts.acceptance \\
        --procedure evaluate \\
        --pretrained_cap_model_path  /path/best_cap_model.pt \\
        --pretrained_prop_model_path /path/best_prop_model.pt \\
        --video_features_path data/i3d_25fps_stack64step64_2stream_npy \\
        --audio_features_path data/vggish_npy \\
        --report_path acceptance_report.json [--device cuda|cuda:N|cpu]

Stages (each PASS, FAIL or SKIP; ``--acceptance_stages`` selects), as in
the JAX script:

  md5            the checkpoints' md5s against the reference README's
                 published hashes; SKIP with --skip_md5 or for native npz
                 checkpoints.
  import         the captioner imports (its params counted, its embedded
                 val_1/val_2 METEOR read).
  gt_val         captioning on the ground-truth proposals of val_1 and
                 val_2: the measured average METEOR within --meteor_tol of
                 the checkpoint's embedded one (or --expected_meteor); SKIP
                 when neither exists.
  learned_props  proposals of the proposal generator on val_1
                 (validate_prop), then captioned and scored through
                 eval_on_learned_props at 4 tIoUs.
  sample         the port's single-video app (python -m
                 bmt_tpu_torch.scripts.single_video_prediction) on the
                 women_long_jump features against --expected_sample:
                 equal sentences, boundaries within 0.051 s.

The chain is bi-modal, as the JAX script's. It runs on the card unless
``--device cpu`` (the port's own flag) asks for the CPU. The exit code is
1 when a stage FAILs, else 0.
'''
from __future__ import annotations

import copy
import glob
import hashlib
import json
import os
import subprocess
import sys

import torch

from bmt_tpu_torch.params import _flatten

CAP_MD5 = '7b4d48cd77ec49a027a4a1abc6867ee7'    # reference README.md:64
PROP_MD5 = '5f8b20826b09eadd41b7a5be662c198b'   # reference README.md:71
ALL_STAGES = ('md5', 'import', 'gt_val', 'learned_props', 'sample')
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..', '..'))


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, 'rb') as f:
        for chunk in iter(lambda: f.read(1 << 20), b''):
            h.update(chunk)
    return h.hexdigest()


def _avg_meteor(val_1_metrics, val_2_metrics):
    '''The reference's headline: the METEOR of the two validation sets'
    averages, averaged.'''
    m1 = val_1_metrics['Average across tIoUs']['METEOR']
    m2 = val_2_metrics['Average across tIoUs']['METEOR']
    return (m1 + m2) / 2


def _load_cap(path: str):
    '''-> (params tree or None, cfg_dict, epoch, vocab or None, the embedded
    average METEOR or None). A native checkpoint's params load later, once
    the dataset gives the vocabulary size.'''
    from bmt_tpu_torch.train.checkpoint import (import_cap_model,
                                                load_torch_checkpoint,
                                                read_checkpoint_meta)
    if path.endswith('.pt'):
        cpt = load_torch_checkpoint(path)
        params, cfg_dict = import_cap_model(cpt)
        embedded = None
        if cpt.get('val_1_metrics') and cpt.get('val_2_metrics'):
            embedded = _avg_meteor(cpt['val_1_metrics'],
                                   cpt['val_2_metrics'])
        return params, cfg_dict, cpt.get('epoch', 0), None, embedded
    ckpt_dir = path if os.path.isdir(path) else os.path.dirname(path)
    meta = read_checkpoint_meta(ckpt_dir, 'best_cap_model')
    vocab = None
    if meta.get('vocab_itos'):
        from bmt_tpu_torch.data.vocab import Vocab
        vocab = Vocab(meta['vocab_itos'])
    embedded = None
    if meta.get('val_1_metrics') and meta.get('val_2_metrics'):
        embedded = _avg_meteor(meta['val_1_metrics'], meta['val_2_metrics'])
    return None, meta['config'], meta.get('epoch', 0), vocab, embedded


def _device(args_cfg) -> torch.device:
    from bmt_tpu_torch.train.options import resolve_device
    return resolve_device(getattr(args_cfg, 'device', None))


def _decode_assembly(cfg, dims, ds, args_cfg):
    '''(decode_fn, compute dtype): the greedy decoder as
    eval_on_learned_props binds it, in the checkpoint's compute dtype.
    Data parallelism is not ported: --dp_devices above 1 raises.'''
    from bmt_tpu_torch.decode import make_bimodal_greedy_fn
    from bmt_tpu_torch.train.loops import make_decode_fn
    from bmt_tpu_torch.train.options import (attention_impl, check_ported,
                                             compute_dtype)
    check_ported(args_cfg)
    dtype = compute_dtype(cfg)
    greedy_fn = make_bimodal_greedy_fn(
        dims, cfg.max_len, ds.start_idx, ds.end_idx, ds.pad_idx,
        attention_impl(cfg))
    return make_decode_fn(greedy_fn, dtype), dtype


def _with_data_paths(cfg, args_cfg, log_name: str):
    '''The run's data paths and limits on a checkpoint's config.'''
    for key in ('train_meta_path', 'val_1_meta_path', 'val_2_meta_path',
                'avail_mp4_path', 'video_features_path',
                'audio_features_path', 'max_prop_per_vid'):
        setattr(cfg, key, getattr(args_cfg, key))
    cfg.log_path = os.path.join(args_cfg.log_dir or './tmp', log_name)
    return cfg


def run_gt_val(args_cfg, cap_path: str, tol: float,
               expected_meteor=None) -> dict:
    '''Captioning on ground-truth proposals, both val splits, against the
    checkpoint's embedded metrics (reference README.md:81-88).'''
    from bmt_tpu_torch.config import Config
    from bmt_tpu_torch.data.captioning import CaptioningDataset
    from bmt_tpu_torch.models import BiModalTransformer, CapModelDims
    from bmt_tpu_torch.params import load_jax_params
    from bmt_tpu_torch.train.checkpoint import (load_model_params,
                                                native_table_dim)
    from bmt_tpu_torch.train.loops import validation_1by1

    params, cfg_dict, epoch, vocab, embedded = _load_cap(cap_path)
    cfg = _with_data_paths(Config.from_dict({**cfg_dict}), args_cfg,
                           'acceptance')
    cfg.reference_paths = args_cfg.reference_paths
    if vocab is None:
        from bmt_tpu_torch.data.vocab import build_vocab_from_meta
        vocab = build_vocab_from_meta(
            cfg.train_meta_path, cfg.start_token, cfg.end_token,
            cfg.pad_token, cfg.min_freq_caps)
    val_1 = CaptioningDataset(cfg, 'val_1', vocab=vocab)
    val_2 = CaptioningDataset(cfg, 'val_2', vocab=vocab)
    dims = CapModelDims.from_config(cfg, val_1.trg_voc_size)
    device = _device(args_cfg)
    if params is not None:
        emb = params['emb_C']
        model = BiModalTransformer(
            dims, device=device,
            table_dim=emb['table'].shape[1] if 'adapter' in emb else None)
        load_jax_params(model, params)
    else:
        ckpt_dir = (cap_path if os.path.isdir(cap_path)
                    else os.path.dirname(cap_path))
        model = BiModalTransformer(dims, device=device,
                                   table_dim=native_table_dim(ckpt_dir))
        load_model_params(ckpt_dir, 'best_cap_model', model)

    decode_fn, dtype = _decode_assembly(cfg, dims, val_1, args_cfg)
    model = model.to(dtype=dtype).eval()
    m1 = validation_1by1(cfg, model, decode_fn, val_1, epoch, phase='val_1')
    m2 = validation_1by1(cfg, model, decode_fn, val_2, epoch, phase='val_2')
    measured = _avg_meteor(m1, m2)
    target = embedded if embedded is not None else expected_meteor
    out = {
        'measured_avg_meteor': measured,
        'embedded_avg_meteor': embedded,
        'val_1_metrics': m1['Average across tIoUs'],
        'val_2_metrics': m2['Average across tIoUs'],
        'tol': tol,
    }
    if target is None:
        out['status'] = 'SKIP'
        out['detail'] = ('checkpoint embeds no val metrics and no '
                         '--expected_meteor given; measured values reported')
    elif abs(measured - target) <= tol:
        out['status'] = 'PASS'
    else:
        out['status'] = 'FAIL'
        out['detail'] = f'|{measured:.4f} - {target:.4f}| > {tol}'
    return out


def run_learned_props(args_cfg, prop_path: str, cap_path: str) -> dict:
    '''Proposal generator -> proposals JSON on val_1 -> captioned and
    scored (reference README.md:89-92, eval_on_learned_props).'''
    from bmt_tpu_torch.config import Config
    from bmt_tpu_torch.data.proposal_data import ProposalDataset
    from bmt_tpu_torch.scripts.eval_on_learned_props import \
        eval_on_learned_props
    from bmt_tpu_torch.train.checkpoint import (load_prop_checkpoint,
                                                load_torch_checkpoint,
                                                read_checkpoint_meta)
    from bmt_tpu_torch.train.loops import validate_prop
    from bmt_tpu_torch.train.options import attention_impl, compute_dtype
    from bmt_tpu_torch.train.steps import make_prop_inference_step

    device = _device(args_cfg)
    pcfg, pdims, model = load_prop_checkpoint(prop_path, device=device)
    if prop_path.endswith('.pt'):
        epoch = load_torch_checkpoint(prop_path).get('epoch', 0)
    else:
        ckpt_dir = (prop_path if os.path.isdir(prop_path)
                    else os.path.dirname(prop_path))
        epoch = read_checkpoint_meta(ckpt_dir, 'best_prop_model').get(
            'epoch', 0)
    pcfg = _with_data_paths(pcfg, args_cfg, 'acceptance_props')
    pcfg.tIoUs = args_cfg.tIoUs
    val_ds = ProposalDataset(pcfg, 'val_1', 1)
    inference_step = make_prop_inference_step(
        pdims, 1, attention_impl(pcfg), compute_dtype(pcfg))
    avg_f1, _ = validate_prop(pcfg, inference_step, model, val_ds, epoch)
    del model

    # validate_prop's AnetPredictions wrote the submission here
    sub_dir = os.path.join(pcfg.log_path or './tmp', 'submissions')
    cands = sorted(glob.glob(os.path.join(
        sub_dir, f'prop_results_val_1_e{epoch}_maxprop*.json')),
        key=os.path.getmtime)
    if not cands:
        return {'status': 'FAIL',
                'detail': f'no prop_results json produced under {sub_dir}'}
    prop_json = cands[-1]

    eval_cfg = copy.copy(args_cfg)
    eval_cfg.prop_pred_path = prop_json
    eval_cfg.pretrained_cap_model_path = cap_path
    metrics = eval_on_learned_props(eval_cfg, device)
    avg = metrics['Average across tIoUs']
    return {
        'status': 'PASS',
        'prop_pred_path': prop_json,
        'prop_avg_f1': avg_f1,
        'learned_props_meteor': avg['METEOR'],
        'learned_props_metrics': avg,
    }


def app_device_args(device) -> list:
    '''The single-video app's device flags for ``device``.'''
    device = torch.device(device or 'cuda')
    if device.type == 'cpu':
        return ['--device', 'cpu']
    return ['--device', 'cuda', '--device_id', str(device.index or 0)]


def run_sample(args_cfg, cap_path: str, prop_path: str, sample_dir: str,
               expected_path: str, duration: float, out_dir: str) -> dict:
    '''Golden single-video check (reference README.md:160-185): the port's
    app on the bundled features, its segments against the published
    output.'''
    out_json = os.path.join(out_dir, 'sample_prediction.json')
    os.makedirs(out_dir, exist_ok=True)
    cmd = [sys.executable, '-m',
           'bmt_tpu_torch.scripts.single_video_prediction',
           '--prop_generator_model_path', prop_path,
           '--pretrained_cap_model_path', cap_path,
           '--vggish_features_path',
           os.path.join(sample_dir, 'women_long_jump_vggish.npy'),
           '--rgb_features_path',
           os.path.join(sample_dir, 'women_long_jump_rgb.npy'),
           '--flow_features_path',
           os.path.join(sample_dir, 'women_long_jump_flow.npy'),
           '--duration_in_secs', str(duration),
           '--max_prop_per_vid', '100',
           '--nms_tiou_thresh', '0.4',
           '--train_meta_path', args_cfg.train_meta_path,
           '--output_json', out_json,
           *app_device_args(getattr(args_cfg, 'device', None))]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1800,
                          cwd=REPO)
    if proc.returncode != 0:
        return {'status': 'FAIL', 'detail': 'CLI failed',
                'stderr': proc.stderr[-2000:]}
    with open(out_json) as f:
        got = json.load(f)
    with open(expected_path) as f:
        want = json.load(f)
    mismatches = []
    if len(got) != len(want):
        mismatches.append(f'{len(got)} segments != expected {len(want)}')
    for i, (g, w) in enumerate(zip(got, want)):
        if g['sentence'].strip() != w['sentence'].strip():
            mismatches.append(
                f'[{i}] sentence {g["sentence"]!r} != {w["sentence"]!r}')
        # boundaries in the README are printed at 0.1 s resolution
        for k in ('start', 'end'):
            if abs(float(g[k]) - float(w[k])) > 0.051:
                mismatches.append(f'[{i}] {k} {g[k]} != {w[k]}')
    return {'status': 'PASS' if not mismatches else 'FAIL',
            'predicted': got, 'mismatches': mismatches,
            'output_json': out_json}


def _stage(report: dict, name: str, fn) -> None:
    '''Run one stage; an exception is the stage's FAIL, with its type and
    message.'''
    try:
        report['stages'][name] = fn()
    except Exception as e:                  # noqa: BLE001 (a stage's FAIL)
        report['stages'][name] = {'status': 'FAIL',
                                  'detail': f'{type(e).__name__}: {e}'}


def run_acceptance(args_cfg) -> dict:
    stages = [s.strip() for s in
              (args_cfg.acceptance_stages or ','.join(ALL_STAGES)).split(',')]
    bad = set(stages) - set(ALL_STAGES)
    if bad:
        raise SystemExit(f'unknown acceptance stages: {sorted(bad)}; '
                         f'valid: {ALL_STAGES}')
    cap_path = args_cfg.pretrained_cap_model_path
    prop_path = args_cfg.pretrained_prop_model_path
    if not cap_path or not prop_path:
        raise SystemExit('--pretrained_cap_model_path and '
                         '--pretrained_prop_model_path are required')
    report = {'stages': {}}

    if 'md5' in stages:
        if args_cfg.skip_md5:
            report['stages']['md5'] = {
                'status': 'SKIP', 'detail': '--skip_md5 (stand-in fixtures)'}
        elif not (cap_path.endswith('.pt') and prop_path.endswith('.pt')):
            report['stages']['md5'] = {
                'status': 'SKIP',
                'detail': 'published md5s cover the reference .pt files only'}
        else:
            got_cap, got_prop = _md5(cap_path), _md5(prop_path)
            ok = got_cap == CAP_MD5 and got_prop == PROP_MD5
            report['stages']['md5'] = {
                'status': 'PASS' if ok else 'FAIL',
                'cap': {'got': got_cap, 'want': CAP_MD5},
                'prop': {'got': got_prop, 'want': PROP_MD5},
            }

    if 'import' in stages:
        def run_import():
            params, cfg_dict, _, _, embedded = _load_cap(cap_path)
            n_cap = (sum(x.size for x in _flatten(params).values())
                     if params is not None else None)
            return {'status': 'PASS', 'cap_params': n_cap,
                    'cap_embedded_avg_meteor': embedded,
                    'cap_config_keys': len(cfg_dict)}
        _stage(report, 'import', run_import)

    if 'gt_val' in stages and \
            report['stages'].get('import', {}).get('status') != 'FAIL':
        _stage(report, 'gt_val', lambda: run_gt_val(
            args_cfg, cap_path, args_cfg.meteor_tol,
            args_cfg.expected_meteor))

    if 'learned_props' in stages:
        _stage(report, 'learned_props', lambda: run_learned_props(
            args_cfg, prop_path, cap_path))

    if 'sample' in stages:
        sample_dir = args_cfg.sample_dir or os.path.join(REPO, 'sample')
        expected = args_cfg.expected_sample or os.path.join(
            sample_dir, 'expected_women_long_jump.json')
        _stage(report, 'sample', lambda: run_sample(
            args_cfg, cap_path, prop_path, sample_dir, expected,
            args_cfg.sample_duration,
            os.path.join(args_cfg.log_dir or './tmp', 'acceptance')))

    statuses = [s['status'] for s in report['stages'].values()]
    report['overall'] = ('FAIL' if 'FAIL' in statuses else
                         'PASS' if 'PASS' in statuses else 'SKIP')
    return report


def _print_report(report: dict):
    print('\n===== BMT acceptance report =====')
    for name, stage in report['stages'].items():
        line = f'  {name:<14} {stage["status"]}'
        if stage.get('detail'):
            line += f'  ({stage["detail"]})'
        if name == 'gt_val' and 'measured_avg_meteor' in stage:
            line += (f'  measured={stage["measured_avg_meteor"]:.4f}'
                     f' embedded={stage["embedded_avg_meteor"]}')
        if name == 'learned_props' and 'learned_props_meteor' in stage:
            line += f'  METEOR={stage["learned_props_meteor"]:.4f}'
        print(line)
    print(f'OVERALL: {report["overall"]}')


def add_acceptance_args(parser):
    parser.add_argument('--meteor_tol', type=float, default=0.1,
                        help='acceptance tolerance on the averaged METEOR '
                             '(reference publishes 2 decimals)')
    parser.add_argument('--expected_meteor', type=float, default=None,
                        help='target METEOR when the checkpoint embeds no '
                             'val metrics (stand-in fixtures)')
    parser.add_argument('--skip_md5', action='store_true')
    parser.add_argument('--acceptance_stages', type=str, default=None,
                        help=f'comma list of {ALL_STAGES} (default: all)')
    parser.add_argument('--sample_dir', type=str, default=None)
    parser.add_argument('--expected_sample', type=str, default=None)
    parser.add_argument('--sample_duration', type=float, default=35.155,
                        help='reference README.md:167')
    parser.add_argument('--report_path', type=str, default=None,
                        help='also write the report as JSON here')
    parser.add_argument('--device', type=str, default='cuda',
                        help='where the models run: cuda (default), cuda:N, '
                             'or cpu')
    return parser


ACCEPTANCE_FLAGS = ('meteor_tol', 'expected_meteor', 'skip_md5',
                    'acceptance_stages', 'sample_dir', 'expected_sample',
                    'sample_duration', 'report_path', 'device',
                    # the 'evaluate' Config copies only the cap path
                    'pretrained_prop_model_path')


def main(argv=None):
    from bmt_tpu_torch.config import Config, build_parser
    parser = add_acceptance_args(build_parser())
    argv = list(sys.argv[1:] if argv is None else argv)
    if '--procedure' not in argv:
        argv = ['--procedure', 'evaluate'] + argv
    args = parser.parse_args(argv)
    args_cfg = Config(args)
    for k in ACCEPTANCE_FLAGS:
        setattr(args_cfg, k, getattr(args, k))
    report = run_acceptance(args_cfg)
    _print_report(report)
    if args.report_path:
        with open(args.report_path, 'w') as f:
            json.dump(report, f, indent=1, default=float)
        print(f'report written: {args.report_path}')
    return 0 if report['overall'] != 'FAIL' else 1


if __name__ == '__main__':
    raise SystemExit(main())
