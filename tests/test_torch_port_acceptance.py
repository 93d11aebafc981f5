'''The port's acceptance chain (``bmt_tpu_torch.scripts.acceptance``) on
stand-ins, as ``tests/test_acceptance_pipeline.py`` drives the JAX script:
tiny models trained by the port's trainers on the CPU over
``tests/torch_port_tree.py``'s tree, then

  md5            SKIPs for native checkpoints;
  import         the native checkpoint's meta loads;
  gt_val         re-measures METEOR on the ground-truth proposals and must
                 equal the value the trainer embedded (greedy decoding is
                 deterministic, so the difference is 0, within the 0.1 the
                 real acceptance allows);
  learned_props  proposals -> proposals JSON -> eval_on_learned_props;
  sample         the port's own app, run as a child process, against a
                 golden JSON from one direct run of the same app.

Then the .pt route: both stand-ins exported to the reference format, where
the md5 gate FAILs (they are not the published files) and, with
--skip_md5, the import stage passes and reports the embedded METEOR. The
chain loads nothing of the JAX package.'''
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bmt_tpu_torch import __main__ as cli
from bmt_tpu_torch.config import Config, build_parser
from bmt_tpu_torch.scripts import acceptance
from bmt_tpu_torch.scripts.export import main as export_main
from tests.torch_port_tree import D_AUD, D_VID, mini_argv, mini_tree

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _common(tree, cap, prop, log, report):
    return ['--procedure', 'evaluate',
            '--pretrained_cap_model_path', str(cap),
            '--pretrained_prop_model_path', str(prop),
            '--train_meta_path', str(tree / 'train.csv'),
            '--val_1_meta_path', str(tree / 'val_1.csv'),
            '--val_2_meta_path', str(tree / 'val_2.csv'),
            '--video_features_path', str(tree / 'video_npy'),
            '--audio_features_path', str(tree / 'audio_npy'),
            '--reference_paths', str(tree / 'val_1_no_missings.json'),
            str(tree / 'val_2_no_missings.json'),
            '--avail_mp4_path', str(tree / 'available_mp4.txt'),
            '--d_vid', str(D_VID), '--d_aud', str(D_AUD),
            '--log_dir', str(log), '--max_prop_per_vid', '10',
            '--report_path', str(report), '--device', 'cpu']


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_acceptance_chain_on_standins(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / 'tree').mkdir()
    tree = mini_tree(tmp_path / 'tree')
    log = tmp_path / 'log'
    cli.main(mini_argv(tree, log, 'train_cap', device='cpu',
                       exper_name='cap'))
    cli.main(mini_argv(tree, log, 'train_prop', device='cpu',
                       exper_name='prop'))
    cap_dir = log / 'train_cap' / 'cap'
    prop_dir = log / 'train_prop' / 'prop'

    # stand-ins for the bundled women_long_jump features, at the tree's
    # widths
    rng = np.random.default_rng(3)
    sample_dir = tmp_path / 'sample'
    sample_dir.mkdir()
    np.save(sample_dir / 'women_long_jump_rgb.npy',
            rng.normal(size=(11, D_VID)).astype(np.float32))
    np.save(sample_dir / 'women_long_jump_flow.npy',
            rng.normal(size=(11, D_VID)).astype(np.float32))
    np.save(sample_dir / 'women_long_jump_vggish.npy',
            rng.normal(size=(13, D_AUD)).astype(np.float32))

    # the sample stage's golden: one direct run of the same app
    args = argparse.Namespace(train_meta_path=str(tree / 'train.csv'),
                              device='cpu')
    bootstrap = tmp_path / 'bootstrap_expected.json'
    bootstrap.write_text('[]')
    probe = acceptance.run_sample(args, str(cap_dir), str(prop_dir),
                                  str(sample_dir), str(bootstrap), 21.5,
                                  str(tmp_path / 'golden'))
    assert 'predicted' in probe, probe
    assert probe['predicted'], 'the app captioned no proposal'
    expected = tmp_path / 'expected_sample.json'
    expected.write_text(json.dumps(probe['predicted']))

    report_path = tmp_path / 'report.json'
    rc = acceptance.main(_common(tree, cap_dir, prop_dir, tmp_path / 'acc',
                                 report_path) + [
        '--sample_dir', str(sample_dir), '--expected_sample', str(expected),
        '--sample_duration', '21.5'])
    report = _read(report_path)
    stages = report['stages']
    assert rc == 0, report
    assert set(stages) == set(acceptance.ALL_STAGES)
    assert stages['md5']['status'] == 'SKIP'
    assert stages['import']['status'] == 'PASS'
    gt = stages['gt_val']
    assert gt['status'] == 'PASS', gt
    assert gt['embedded_avg_meteor'] is not None
    assert abs(gt['measured_avg_meteor'] - gt['embedded_avg_meteor']) < 1e-9
    lp = stages['learned_props']
    assert lp['status'] == 'PASS', lp
    assert os.path.exists(lp['prop_pred_path'])
    assert 'learned_props_meteor' in lp
    assert stages['sample']['status'] == 'PASS', stages['sample']
    assert report['overall'] == 'PASS'

    # the .pt route: both stand-ins in the reference format
    cap_pt, prop_pt = tmp_path / 'best_cap_model.pt', tmp_path / 'prop.pt'
    export_main(['--checkpoint', str(cap_dir), '--out', str(cap_pt),
                 '--device', 'cpu'])
    export_main(['--checkpoint', str(prop_dir), '--model', 'prop', '--out',
                 str(prop_pt), '--device', 'cpu'])
    pt_report = tmp_path / 'pt_report.json'
    common = _common(tree, cap_pt, prop_pt, tmp_path / 'acc_pt', pt_report)
    assert acceptance.main(common + ['--acceptance_stages', 'md5']) == 1
    assert _read(pt_report)['stages']['md5']['status'] == 'FAIL'
    assert acceptance.main(common + ['--acceptance_stages', 'md5,import',
                                     '--skip_md5']) == 0
    pt_stages = _read(pt_report)['stages']
    assert pt_stages['md5']['status'] == 'SKIP'
    assert pt_stages['import']['status'] == 'PASS'
    assert pt_stages['import']['cap_params'] > 0
    assert pt_stages['import']['cap_embedded_avg_meteor'] == pytest.approx(
        gt['embedded_avg_meteor'])


def test_stage_selection_and_md5(tmp_path):
    '''Unknown stage names raise; the md5 stage FAILs on wrong-content .pt
    files and SKIPs under --skip_md5.'''
    cap = tmp_path / 'best_cap_model.pt'
    prop = tmp_path / 'best_prop_model.pt'
    cap.write_bytes(b'not the reference checkpoint')
    prop.write_bytes(b'also not')

    def args(**kw):
        return argparse.Namespace(**{
            'pretrained_cap_model_path': str(cap),
            'pretrained_prop_model_path': str(prop),
            'acceptance_stages': 'md5', 'skip_md5': False, 'meteor_tol': 0.1,
            'expected_meteor': None, 'log_dir': str(tmp_path), **kw})

    report = acceptance.run_acceptance(args())
    assert report['stages']['md5']['status'] == 'FAIL'
    assert report['overall'] == 'FAIL'
    report = acceptance.run_acceptance(args(skip_md5=True))
    assert report['stages']['md5']['status'] == 'SKIP'
    assert report['overall'] == 'SKIP'
    with pytest.raises(SystemExit, match='unknown acceptance stages'):
        acceptance.run_acceptance(args(acceptance_stages='md5,frobnicate'))


def test_data_parallel_decode_raises_naming_its_item(tmp_path):
    '''--sp_devices and --fsdp have no effect on the decode assembly (the
    JAX package's evaluation is data-parallel only): with either, the
    decode gives the tokens of the decode without them; tensor parallelism
    (mp) no longer raises NotImplementedError: DataParallel takes it, and
    more than one rank asks for a process group.'''
    from bmt_tpu_torch.data.captioning import CaptioningDataset
    from bmt_tpu_torch.models import BiModalTransformer, CapModelDims
    from bmt_tpu_torch.parallel import DataParallel
    (tmp_path / 'tree').mkdir()
    tree = mini_tree(tmp_path / 'tree')
    cfgs = [Config(build_parser().parse_args(mini_argv(
        tree, tmp_path, 'evaluate', **flag)))
        for flag in ({}, {'sp_devices': 2}, {'fsdp': None})]
    ds = CaptioningDataset(cfgs[0], 'val_1')
    dims = CapModelDims.from_config(cfgs[0], ds.trg_voc_size)
    model = BiModalTransformer(
        dims, device='cpu', generator=torch.Generator().manual_seed(1)).eval()
    src = next(iter(ds.batches(epoch=0, shuffle=False)))['src']
    decoded = []
    for cfg in cfgs:
        cfg.device = 'cpu'
        decode_fn, _ = acceptance._decode_assembly(cfg, dims, ds, cfg)
        decoded.append(decode_fn(model, src).numpy())
    for got in decoded[1:]:
        np.testing.assert_array_equal(got, decoded[0])
    with pytest.raises(RuntimeError, match='one process a rank'):
        DataParallel(1, 'cpu', mp=2)


def test_dp_decode_assembly_splits_over_replicas(tmp_path):
    '''--dp_devices 2 decodes each batch's halves on two local replicas
    (the CPU twice here) and joins them in row order: the tokens of one
    replica.'''
    from bmt_tpu_torch.data.captioning import CaptioningDataset
    from bmt_tpu_torch.models import BiModalTransformer, CapModelDims
    (tmp_path / 'tree').mkdir()
    tree = mini_tree(tmp_path / 'tree')
    cfgs = {dp: Config(build_parser().parse_args(mini_argv(
        tree, tmp_path, 'evaluate', dp_devices=dp))) for dp in (1, 2)}
    ds = CaptioningDataset(cfgs[2], 'val_1')
    dims = CapModelDims.from_config(cfgs[2], ds.trg_voc_size)
    model = BiModalTransformer(
        dims, device='cpu', generator=torch.Generator().manual_seed(0)).eval()
    src = next(iter(ds.batches(epoch=0, shuffle=False)))['src']
    decoded = {}
    for dp, cfg in cfgs.items():
        cfg.device = 'cpu'
        decode_fn, _ = acceptance._decode_assembly(cfg, dims, ds, cfg)
        decoded[dp] = decode_fn(model, src).numpy()
    assert decoded[1].shape[0] % 2 == 0
    np.testing.assert_array_equal(decoded[2], decoded[1])


def test_acceptance_loads_nothing_of_the_jax_package():
    '''The script, its stages' modules and the app it runs import no
    module of bmt_tpu and no jax.'''
    code = ('import sys; import bmt_tpu_torch.scripts.acceptance as a; '
            'import bmt_tpu_torch.scripts.eval_on_learned_props, '
            'bmt_tpu_torch.scripts.single_video_prediction, '
            'bmt_tpu_torch.train.prop_trainer; '
            'bad = [m for m in sys.modules if m == "jax" or '
            'm.startswith(("jax.", "bmt_tpu.")) or m == "bmt_tpu"]; '
            'print(bad); sys.exit(1 if bad else 0)')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
