'''The port's config, tokenizer and vocabulary against the JAX package's:
``bmt_tpu_torch.config`` (Config, build_parser), ``CapModelDims`` /
``PropModelDims.from_config``, ``bmt_tpu_torch.data.tokenizer.tokenize_en``
and ``bmt_tpu_torch.data.vocab`` (build_vocab_from_meta, read_meta_csv,
load_glove). Everything is host-side, so equality is exact.'''
import dataclasses
import json
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from bmt_tpu import config as jax_config
from bmt_tpu.data import tokenizer as jax_tokenizer
from bmt_tpu.data import vocab as jax_vocab
from bmt_tpu.models import CapModelDims as JaxCapDims
from bmt_tpu.models import PropModelDims as JaxPropDims
from bmt_tpu_torch import config as port_config
from bmt_tpu_torch.data import tokenizer as port_tokenizer
from bmt_tpu_torch.data import vocab as port_vocab
from bmt_tpu_torch.models import CapModelDims, PropModelDims

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the fields that differ by design: the build time and the device name
VARYING = ('curr_time', 'device')

ARGVS = [
    ['--procedure', 'train_cap', '--dont_log'],
    ['--procedure', 'train_prop', '--dont_log'],
    ['--procedure', 'evaluate', '--dont_log',
     '--pretrained_cap_model_path', 'ckpt'],
    ['--procedure', 'train_cap', '--exper_name', 'run1', '--log_dir', 'logs',
     '--optimizer', 'sgd', '--momentum', '0.9', '--scheduler',
     'reduce_on_plateau', '--lr_patience', '3', '--lr_reduce_factor', '0.5',
     '--B', '8', '--dp_devices', '2', '--glove_path', 'g.txt'],
    ['--procedure', 'train_prop', '--dont_log', '--use_linear_embedder',
     '--d_model_audio', '64', '--d_model_video', '256', '--layer_norm',
     '--d_ff_audio', '100', '--kernel_sizes_audio', '3', '5',
     '--conv_layers_video', '64', '--pad_video_feats_up_to', '120'],
    ['--procedure', 'train_prop', '--dont_log', '--modality', 'video',
     '--feature_timespan_in_fps', '16', '--fps_at_extraction', '15'],
    ['--procedure', 'train_cap', '--dont_log', '--modality', 'audio',
     '--d_ff_caps', '77', '--scheduler', 'warmup_cosine',
     '--warmup_steps', '10'],
]


def _configs(argv):
    return (jax_config.Config(jax_config.build_parser().parse_args(argv)),
            port_config.Config(port_config.build_parser().parse_args(argv)))


def _without(d):
    return {k: v for k, v in d.items() if k not in VARYING}


@pytest.mark.parametrize('argv', ARGVS, ids=lambda a: ' '.join(a[1:3]))
def test_parser_defaults_and_derived_fields_match_jax(argv):
    '''The same argv parses to the same namespace, and Config derives the
    same fields (d_ff_*, strides, pad_feats_up_to, kernel_sizes,
    train_batch_size, ...), except the build time and the device.'''
    jparser, pparser = jax_config.build_parser(), port_config.build_parser()
    assert vars(jparser.parse_args(argv)) == vars(pparser.parse_args(argv))
    jcfg, pcfg = _configs(argv)
    assert _without(jcfg.to_dict()) == _without(pcfg.to_dict())
    assert jcfg.device == 'tpu' and pcfg.device == 'cuda'


def test_derived_fields_of_the_flagship_defaults():
    _, cap = _configs(ARGVS[0])
    assert (cap.d_ff_audio, cap.d_ff_video, cap.d_ff_caps) == (512, 4096,
                                                               1200)
    assert cap.train_batch_size == 32 and cap.inference_batch_size == 64
    _, prop = _configs(ARGVS[1])
    assert prop.strides == {'audio': 0.96, 'video': 64 / 25}
    assert prop.pad_feats_up_to == {'audio': 800, 'video': 300}
    assert prop.kernel_sizes['video'] == [1, 5, 9, 13, 19, 25, 35, 45, 61,
                                          79]


@pytest.mark.parametrize('writer', ['jax', 'port'])
@pytest.mark.parametrize('argv', ARGVS[:2], ids=['train_cap', 'train_prop'])
def test_config_json_loads_in_the_other_package(tmp_path, writer, argv):
    jcfg, pcfg = _configs(argv)
    path = str(tmp_path / 'config.json')
    if writer == 'jax':
        jcfg.save_json(path)
        got = port_config.Config.load_json(path)
        want = jcfg.to_dict()
    else:
        pcfg.save_json(path)
        got = jax_config.Config.load_json(path)
        want = pcfg.to_dict()
    # JSON keeps lists and dicts as they are (no tuples in a Config)
    assert got.to_dict() == json.loads(json.dumps(want))


@pytest.mark.parametrize('argv', [ARGVS[0], ARGVS[3]],
                         ids=['defaults', 'sgd'])
def test_cap_dims_from_config_match_jax(argv):
    jcfg, pcfg = _configs(argv)
    want = dataclasses.asdict(JaxCapDims.from_config(jcfg, 101))
    assert dataclasses.asdict(CapModelDims.from_config(pcfg, 101)) == want


def test_cap_dims_from_config_rejects_moe():
    '''A MoE config (``--moe_experts 4 --moe_capacity_factor 2``) gives the
    JAX package's MoE dims, which the port now builds rather than
    rejects.'''
    argv = ARGVS[0] + ['--moe_experts', '4', '--moe_capacity_factor', '2']
    jcfg, pcfg = _configs(argv)
    got = dataclasses.asdict(CapModelDims.from_config(pcfg, 10))
    assert got == dataclasses.asdict(JaxCapDims.from_config(jcfg, 10))
    assert got['moe_experts'] == 4 and got['moe_cf'] == 2.0


@pytest.mark.parametrize('argv', [ARGVS[1], ARGVS[4]],
                         ids=['defaults', 'linear_embedder'])
def test_prop_dims_from_config_match_jax(argv):
    jcfg, pcfg = _configs(argv)
    want = dataclasses.asdict(JaxPropDims.from_config(jcfg))
    got = dataclasses.asdict(PropModelDims.from_config(pcfg))
    assert {k: got[k] for k in want if k in got} == {
        k: want[k] for k in want if k in got}


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

STRINGS = [
    "A man can't stop; he's running.",
    "They'll go, won't they? I'm sure we'd've known.",
    'The well-known 3-2 score ... and 2.5km later!',
    'Dr. Smith met Mrs. Jones at 5 p.m. in Washington D.C.',
    '"Quoted" (parenthesized) [bracketed] {braced}',
    'e-mail me at name@example.com or see www.example.com/page?x=1',
    "gonna wanna gotta lemme cannot y'all ma'am o'clock",
    'Numbers: 1,000 3.14 +5 -7 10% 20$ $30 5kg 12mph',
    'women\'s long-jump -- athletes—run…fast',
    'and/or w/o C++ :) :-( <3 xD',
    'ALL CAPS U.S.A. ok', 'Its ill hell shed well were',
    'rock/paper/scissors a:b "x"/y', '', '   spaces   only  ',
    'Café naïve résumé — São Paulo',
]


@pytest.mark.parametrize('text', STRINGS)
def test_tokenize_en_matches_jax_on_fixed_strings(text):
    assert port_tokenizer.tokenize_en(text) == jax_tokenizer.tokenize_en(text)


@settings(max_examples=300, deadline=None)
@given(st.text(alphabet=st.sampled_from(list(
    "abcXYZ019 .,;:!?'\"-–—/()[]{}<>@#$%&*+=_…’éü\t")), max_size=40))
def test_tokenize_en_matches_jax_on_random_text(text):
    assert port_tokenizer.tokenize_en(text) == jax_tokenizer.tokenize_en(text)


# ---------------------------------------------------------------------------
# vocabulary
# ---------------------------------------------------------------------------

def _write_meta(path, captions):
    with open(path, 'w') as f:
        f.write('video_id\tcaption\tstart\tend\tduration\tphase\tidx\n')
        for i, cap in enumerate(captions):
            f.write(f'v_{i % 3}\t{cap}\t{i}.5\t{i + 2}.0\t30.0\ttrain\t{i}\n')


@pytest.mark.parametrize('min_freq', [1, 2])
def test_build_vocab_from_meta_matches_jax(tmp_path, min_freq):
    rng = np.random.default_rng(0)
    words = ['man', 'Woman', "isn't", 'run-up', 'dog', 'the', 'a', 'jumps',
             'high.', 'U.S.', 'well', "he's", '3.5', 'long']
    captions = [' '.join(rng.choice(words, size=rng.integers(3, 9)))
                for _ in range(30)] + STRINGS[:6]
    path = str(tmp_path / 'train.csv')
    _write_meta(path, captions)
    want = jax_vocab.build_vocab_from_meta(path, min_freq=min_freq)
    got = port_vocab.build_vocab_from_meta(path, min_freq=min_freq)
    assert got.itos == want.itos and got.freqs == want.freqs
    assert got.itos[:4] == ['<unk>', '<blank>', '<s>', '</s>']
    assert port_vocab.read_meta_csv(path) == jax_vocab.read_meta_csv(path)


@pytest.mark.parametrize('cached', [False, True])
def test_load_glove_matches_jax(tmp_path, cached):
    '''glove.840B.300d.txt holds tokens with embedded spaces; both split
    from the right and skip malformed lines.'''
    dim = 4
    glove = tmp_path / 'glove.6B.4d.txt'
    glove.write_text(
        'cat 1 2 3 4\n'
        '. . . 9 9 9 9\n'            # multi-word token '. . .'
        'at name@domain.com 5 6 7 8\n'
        'short 1 2\n'                # malformed: too few fields
        'dog 4 3 2 1\n'
        '. 0.5 0.25 -1 2\n')
    itos = ['<unk>', '<blank>', '<s>', '</s>', 'cat', 'dog', '.', 'owl']
    cache = str(tmp_path / 'cache') if cached else None
    want = jax_vocab.load_glove(str(glove), jax_vocab.Vocab(itos), dim)
    for _ in range(2 if cached else 1):        # the second read hits the cache
        got = port_vocab.load_glove(str(glove), port_vocab.Vocab(itos), dim,
                                    cache_dir=cache)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[4], [1, 2, 3, 4])
    np.testing.assert_array_equal(got[7], [0, 0, 0, 0])


def test_reference_vocabulary_loads():
    '''data/vocab_ref.json, the reference checkpoint's 10172-entry
    vocabulary, loads in both packages to the same index.'''
    path = os.path.join(REPO, 'data', 'vocab_ref.json')
    got = port_vocab.Vocab.load(path)
    want = jax_vocab.Vocab.load(path)
    assert len(got) == 10172 and got.itos == want.itos
    assert (got['<blank>'], got['<s>'], got['</s>']) == (1, 2, 3)
    assert got['no-such-word-here'] == got.unk_index == 0
