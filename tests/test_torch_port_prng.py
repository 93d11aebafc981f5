'''The port's threefry2x32 PRNG (``bmt_tpu_torch.ops.prng``) against
``jax.random`` (JAX 0.9, ``jax_threefry_partitionable`` on, 64-bit types
off), and the dropout it draws against the JAX package's, on the CPU.

- keys, ``fold_in``, ``bits`` (uint16 and uint32, 1-d to 4-d, odd sizes)
  and ``uniform`` bit for bit, for several seeds; a block drawn from its
  offsets equals the same slice of the whole draw;
- ``gumbel`` within 1e-6 (its -log(-log(u)) goes through torch's log, not
  XLA's, which may differ in the last bit), and ``categorical`` draws
  JAX's categories;
- ``dropout`` at the shape of each of the models' dropout sites, fp32 and
  bf16: values (so masks) bit for bit JAX's ``dropout``, and its gradient
  JAX's VJP;
- the captioners' and proposal generators' train-mode forwards under a
  key stream against JAX's with the same key: every site takes JAX's key
  in JAX's order (a wrong order changes the masks, so the outputs, by
  O(1)); fp32, 1e-4 absolute and relative (the logits reach ~55, and the
  1 / keep scales of the sites amplify the two packages' rounding
  differences to ~5e-5 there).
'''
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bmt_tpu.models import bimodal_transformer_forward
from bmt_tpu.models import proposal as jprop
from bmt_tpu.models import unimodal_transformer_forward
from bmt_tpu.ops.layers import dropout as jdropout
from bmt_tpu.ops.masks import make_masks as j_make_masks
from bmt_tpu_torch.ops import flash_attention, launches, prng
from bmt_tpu_torch.ops.layers import (Dropout, dropout_generator, key_stream,
                                      row_block, stream_block)
from bmt_tpu_torch.ops.masks import make_masks
from tests.test_torch_port_proposal import (jax_and_torch_generator,
                                            prop_batch)
from tests.test_torch_port_unimodal import captioner, generator, only
from tests.test_torch_port_unimodal import prop_batch as uni_prop_batch
from tests.test_torch_port_unimodal import features as uni_features
from tests.test_torch_port_unimodal import captions
from tests.torch_port_util import (PAD, features, jax_and_torch_model,
                                   to_jax, to_torch)

SEEDS = [0, 7, 123456789, 2 ** 31 - 1]
SHAPES = [(7,), (1,), (3, 5), (5, 1, 3), (2, 3, 5), (2, 3, 4, 5)]
FWD_TOL = dict(atol=1e-4, rtol=1e-4)


def _data(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize('seed', SEEDS)
def test_key_and_fold_in_match_jax(seed):
    jk = jax.random.key(seed)
    k = prng.key(seed, 'cpu')
    assert k.dtype == torch.uint32 and k.shape == (2,)
    np.testing.assert_array_equal(k.numpy(), _data(jk))
    np.testing.assert_array_equal(k.numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))
    for d in (0, 1, 5, 1000, 2 ** 31 + 7, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(k, d).numpy(),
                                      _data(jax.random.fold_in(jk, d)))
        assert prng.fold_in_words(prng.key_words(seed), d) == tuple(
            int(w) for w in _data(jax.random.fold_in(jk, d)))


def test_key_path_folds_in_order():
    '''``Key(base).fold_in(a, b)`` is fold_in(fold_in(base, a), b).'''
    jk = jax.random.key(3)
    want = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jk, 4), 9), 2)
    k = prng.Key(prng.key(3, 'cpu')).fold_in(4).fold_in(9, 2)
    assert k.path == (4, 9, 2)
    np.testing.assert_array_equal(k.resolve().numpy(), _data(want))


@pytest.mark.parametrize('dtype', ['uint16', 'uint32'])
@pytest.mark.parametrize('shape', SHAPES, ids=str)
@pytest.mark.parametrize('seed', SEEDS[:3])
def test_bits_match_jax(seed, shape, dtype):
    want = np.asarray(jax.random.bits(jax.random.key(seed), shape,
                                      jnp.dtype(dtype)))
    got = prng.bits(prng.key(seed, 'cpu'), shape, getattr(torch, dtype))
    assert got.shape == shape
    np.testing.assert_array_equal(got.to(torch.int64).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize('bounds', [(0.0, 1.0), (-2.0, 3.5),
                                    (float(np.finfo(np.float32).tiny), 1.0)])
@pytest.mark.parametrize('shape', SHAPES[2:], ids=str)
def test_uniform_matches_jax_bit_for_bit(shape, bounds):
    for seed in SEEDS[:2]:
        want = np.asarray(jax.random.uniform(jax.random.key(seed), shape,
                                             jnp.float32, *bounds))
        got = prng.uniform(prng.key(seed, 'cpu'), shape, *bounds).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize('shape', SHAPES[2:], ids=str)
def test_gumbel_matches_jax(shape):
    for seed in SEEDS[:3]:
        want = np.asarray(jax.random.gumbel(jax.random.key(seed), shape))
        got = prng.gumbel(prng.key(seed, 'cpu'), shape).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_categorical_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(16, 50)).astype(np.float32) * 2
    logits[3, 10:] = -np.inf
    for seed in SEEDS:
        want = np.asarray(jax.random.categorical(
            jax.random.key(seed), jnp.asarray(logits), axis=-1))
        got = prng.categorical(prng.key(seed, 'cpu'),
                               torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), want)
        # rows 4..9 of the draw: those rows' categories
        part = prng.categorical(prng.key(seed, 'cpu'),
                                torch.from_numpy(logits[4:10]), (4, 16))
        np.testing.assert_array_equal(part.numpy(), want[4:10])


BLOCKS = [((12,), (5,), (7,)), ((6, 8), (3, 8), (3, 0)),
          ((6, 8), (6, 2), (0, 4)), ((4, 6, 5), (2, 3, 5), (2, 3, 0)),
          ((2, 4, 6, 8), (1, 2, 6, 4), (1, 2, 0, 4)),
          ((3, 4, 5, 6), (3, 4, 5, 6), (0, 0, 0, 0))]


@pytest.mark.parametrize('shape,block,offsets', BLOCKS, ids=str)
def test_a_block_is_the_slice_of_the_whole_draw(shape, block, offsets):
    k = prng.Key(prng.key(11, 'cpu')).fold_in(3)
    where = tuple(slice(o, o + b) for o, b in zip(offsets, block))
    for dtype in (torch.uint16, torch.uint32):
        whole = prng.bits(k, shape, dtype)
        part = prng.bits(k, shape, dtype, block, offsets)
        assert torch.equal(part.to(torch.int64), whole[where].to(torch.int64))
    np.testing.assert_array_equal(
        prng.uniform(k, shape, block=block, offsets=offsets).numpy(),
        prng.uniform(k, shape).numpy()[where])
    x = torch.randn(shape)
    np.testing.assert_array_equal(
        prng.dropout(x[where], k, 0.3, shape, offsets).numpy(),
        prng.dropout(x, k, 0.3).numpy()[where])


def test_a_block_outside_its_tensor_raises():
    with pytest.raises(ValueError, match='not inside'):
        prng.bits(prng.key(0, 'cpu'), (4, 4), block=(3, 4), offsets=(2, 0))


def kernel_indices(args, n) -> torch.Tensor:
    '''The global index that csrc/threefry.cu hashes for each element i of
    a launch (its ``global_index``), from ``_index_args``' array.'''
    block, magic, shift, stride, offset = (args[4 * j:4 * j + 4]
                                           for j in range(5))
    i = torch.arange(n, dtype=torch.int64)
    if args[20]:
        return i
    g = torch.zeros_like(i)
    for d in range(3, -1, -1):
        q = (((i * magic[d]) >> 32) + i) >> shift[d]
        g += (i - q * block[d] + offset[d]) * stride[d]
        i = q
    return g


def test_divider_divides_every_index_a_launch_can_hold():
    '''The kernel's division of an element index i < 2**31 by a block
    extent: one high multiply, an add and a shift give i // d.'''
    rng = np.random.default_rng(0)
    n = torch.from_numpy(np.concatenate([
        np.arange(4096), 2 ** 31 - 1 - np.arange(4096),
        rng.integers(0, 2 ** 31, 20000)])).long()
    for d in [1, 2, 3, 5, 7, 21, 96, 255, 256, 300, 800, 1023, 10172,
              65537, 2 ** 20 + 7, 2 ** 30 + 1, 2 ** 31 - 1,
              *rng.integers(1, 2 ** 31, 40).tolist()]:
        magic, shift = prng.divider(d)
        assert 0 < magic < 2 ** 32 and 0 <= shift <= 31
        assert ((n * magic >> 32) + n < 2 ** 32).all()
        assert torch.equal(((n * magic >> 32) + n) >> shift, n // d), d


# (shape, block, offsets, memory order of the block's dims)
LAYOUTS = [((6, 8), (6, 8), (0, 0), (1, 0)),
           ((2, 7, 5), (2, 7, 5), (0, 0, 0), (0, 2, 1)),
           ((4, 12, 6), (2, 4, 6), (2, 8, 0), (0, 2, 1)),
           ((3, 4, 5, 6), (3, 2, 5, 6), (0, 2, 0, 0), (2, 0, 3, 1)),
           ((4, 6, 5), (2, 3, 5), (2, 3, 0), (0, 1, 2))]


@pytest.mark.parametrize('shape,block,offsets,order', LAYOUTS, ids=str)
def test_kernel_index_of_a_dense_layout_is_each_elements_global_index(
        shape, block, offsets, order):
    '''A block held in the memory order ``order`` (a transposed view):
    element i of the kernel's walk through memory hashes the global index
    of the element stored there.'''
    args, n = prng._index_args(shape, block, offsets, order)
    want = prng.global_index(shape, block, offsets).permute(order)
    assert torch.equal(kernel_indices(list(args), n), want.flatten())


def test_memory_order_of_dense_and_other_layouts():
    x = torch.zeros(2, 3, 4)
    assert prng.memory_order(x) == (0, 1, 2)
    assert prng.memory_order(x.transpose(1, 2)) == (0, 2, 1)
    assert prng.memory_order(x.permute(2, 0, 1)) == (1, 2, 0)
    assert prng.memory_order(x[:, ::2]) is None
    assert prng.memory_order(torch.zeros(3, 1).expand(3, 4)) is None


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_dropout_of_a_transposed_view_is_the_draw_of_its_elements(dtype):
    '''The proposal heads drop their (B, D, S) conv outputs through a
    (B, S, D) view: each element keeps the mask of its (B, S, D) index,
    in the forward and in the gradient.'''
    k = prng.Key(prng.key(4, 'cpu')).fold_in(2)
    conv = torch.randn(2, 8, 11).to(dtype).requires_grad_()
    got = prng.dropout(conv.transpose(1, 2), k, 0.3)
    want = prng.dropout(conv.detach().transpose(1, 2).contiguous(), k, 0.3)
    assert torch.equal(got, want)
    g = torch.randn(2, 11, 8).to(dtype)
    got.backward(g)
    assert torch.equal(conv.grad.transpose(1, 2),
                       prng.dropout(g, k, 0.3))


def test_stream_blocks_are_drawn_under_threefry_only():
    '''Outside a key stream (rbg) a sequence or expert block is no block:
    the generator draws the rank's own mask, as it did before threefry.'''
    assert stream_block(1, (1, 2)) is None
    with key_stream(prng.key(0, 'cpu')):
        assert stream_block(1, (1, 2)) == (1, 1, 2)
        assert stream_block(1, None) is None
    x = torch.randn(3, 4, 5)
    drop = Dropout(0.4).train()
    with dropout_generator(torch.Generator().manual_seed(3)):
        got = drop(x, (stream_block(1, (1, 2)),))
    keep = torch.empty_like(x).bernoulli_(
        0.6, generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, x * keep.div_(0.6))
    # an mp block is drawn under rbg too: the whole tensor's mask, sliced
    with dropout_generator(torch.Generator().manual_seed(4)):
        got = drop(x, ((-1, 1, 2), stream_block(1, (1, 2))))
    keep = torch.empty(3, 4, 10).bernoulli_(
        0.6, generator=torch.Generator().manual_seed(4))[..., 5:]
    assert torch.equal(got, x * keep.div_(0.6))


def test_one_registry_counts_every_kernel():
    '''The attention and the threefry wrappers count in one registry; a
    graph's replay adds to it, and a reset of some kernels leaves the
    rest.'''
    names = {flash_attention.KERNEL, flash_attention.KERNEL_DQ,
             flash_attention.KERNEL_DKV, prng.KERNEL_DROPOUT,
             prng.KERNEL_BITS32}
    before = launches.counts()
    assert names <= set(before)
    assert before[prng.KERNEL_DROPOUT] == prng.dropout_kernel.launches
    delta = {prng.KERNEL_DROPOUT: 3, flash_attention.KERNEL: 2}
    launches.add(delta)
    after = launches.counts()
    assert after == {n: before[n] + delta.get(n, 0) for n in before}
    assert flash_attention.flash_attention.launches == \
        before[flash_attention.KERNEL] + 2
    assert flash_attention.launch_counts() == {
        n: after[n] for n in flash_attention.ATTENTION_KERNELS}
    launches.reset([prng.KERNEL_DROPOUT])
    assert launches.counts()[prng.KERNEL_DROPOUT] == 0
    assert launches.counts()[flash_attention.KERNEL] == \
        after[flash_attention.KERNEL]
    launches.add({n: before[n] - c for n, c in launches.counts().items()})
    assert launches.counts() == before


# the models' dropout sites: the shape each draws its mask for
SITES = {'attention (B, H, Sq, d_k)': (2, 2, 5, 8),
         'moe hidden (E, B, C, F)': (4, 2, 3, 16),
         'feed-forward hidden (B, S, d_ff)': (2, 5, 24),
         'residual (B, S, D)': (2, 7, 16),
         'positional (B, S, D)': (3, 9, 8),
         'bridge (B, S, D)': (2, 5, 16),
         'proposal head (B, S, C)': (2, 11, 8)}


@pytest.mark.parametrize('rate', [0.1, 0.3, 0.5])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('site', list(SITES))
def test_dropout_matches_jax_at_each_site(site, dtype, rate):
    '''The values, and so the mask, bit for bit: fp32 x / keep correctly
    rounded, bf16 x / bf16(keep) rounded once.'''
    shape = SITES[site]
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    x = x * 10.0 ** np.random.default_rng(2).integers(-3, 4, size=shape)
    jk = jax.random.fold_in(jax.random.key(5), 17)
    want = jdropout(jnp.asarray(x, dtype), rate, jk, False)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = prng.dropout(tx, prng.Key(prng.key(5, 'cpu')).fold_in(17), rate)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    kept = (got != 0).float().mean().item()
    assert abs(kept - (1 - rate)) < 0.2


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_dropout_gradient_matches_jax_vjp(dtype):
    shape = (3, 4, 6, 8)
    rng = np.random.default_rng(4)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    jk = jax.random.key(9)
    _, vjp = jax.vjp(lambda a: jdropout(a, 0.1, jk, False),
                     jnp.asarray(x, dtype))
    want, = vjp(jnp.asarray(g, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    prng.dropout(tx, prng.key(9, 'cpu'), 0.1).backward(
        torch.from_numpy(g).to(tx.dtype))
    np.testing.assert_array_equal(tx.grad.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_dropout_module_draws_its_block_of_the_global_mask():
    '''A ``Dropout`` in a stream, its x the (i, n) blocks of an mp slice, a
    sequence block and a row block: the global mask's part; the stream
    hands out fold_in(key, 1), fold_in(key, 2), ...'''
    whole = torch.randn(4, 6, 10)
    key = prng.key(2, 'cpu')
    want = [prng.dropout(whole, prng.Key(key).fold_in(c), 0.25)
            for c in (1, 2)]
    drop = Dropout(0.25).train()
    for r in range(2):
        for s in range(3):
            for m in range(2):
                x = whole[2 * r:2 * r + 2, 2 * s:2 * s + 2, 5 * m:5 * m + 5]
                with key_stream(key), row_block(r, 2):
                    got = [drop(x, ((2, m, 2), (1, s, 3)))
                           for _ in range(2)]
                for g, w in zip(got, want):
                    assert torch.equal(
                        g, w[2 * r:2 * r + 2, 2 * s:2 * s + 2,
                             5 * m:5 * m + 5])


def test_dropout_takes_no_key_at_p_0_or_in_eval():
    drop, off = Dropout(0.2).train(), Dropout(0.0).train()
    x = torch.randn(3, 4)
    with key_stream(prng.key(1, 'cpu')):
        assert off.take() is None and off(x) is x
        drop.eval()
        assert drop.take() is None and drop(x) is x
        drop.train()
        assert drop.take().path == (1,)


# ---------------------------------------------------------------------------
# the models' train-mode forwards: JAX's keys at JAX's sites
# ---------------------------------------------------------------------------

def _cap_inputs(jdims, seed, B=3):
    rng = np.random.default_rng(seed)
    src = features(rng, B, 6, 8, jdims, pad_rows={1: (4, 5)})
    caps = rng.integers(4, jdims.voc_size, size=(B, 6)).astype(np.int32)
    caps[1, 4:] = PAD
    src_t = to_torch(src)
    trg = torch.from_numpy(caps).long()
    return src, src_t, trg, make_masks(src_t, trg, jdims.modality, PAD)


@pytest.mark.parametrize('case', ['plain', 'remat', 'moe'])
def test_bimodal_captioner_train_forward_matches_jax(case):
    kw = {'remat': dict(remat=True), 'moe': dict(moe_experts=4)}.get(case,
                                                                    {})
    jdims, params, model = jax_and_torch_model(seed=2, dout_p=0.3, **kw)
    src, src_t, trg, masks = _cap_inputs(jdims, 3)
    jmasks = {k: jnp.asarray(v.numpy()) for k, v in masks.items()}
    want = bimodal_transformer_forward(
        params, jdims, to_jax(src), jnp.asarray(trg.numpy()), jmasks,
        rng=jax.random.key(6), deterministic=False, return_logits=True)
    model.train()
    with key_stream(prng.key(6, 'cpu')):
        got = model(src_t, trg, masks, return_logits=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    # another key moves the outputs: the masks are live
    with key_stream(prng.key(7, 'cpu')):
        other = model(src_t, trg, masks, return_logits=True)
    assert (other - got).abs().max().item() > 1e-2


@pytest.mark.parametrize('modality', ['audio', 'video'])
def test_unimodal_captioner_train_forward_matches_jax(modality):
    jdims, params, model = captioner(modality, seed=4, dout_p=0.3)
    src = only(uni_features(5, jdims), modality)
    trg = torch.from_numpy(captions(5, jdims.voc_size)).long()
    masks = make_masks(to_torch(src), trg, modality, PAD)
    jmasks = {k: jnp.asarray(v.numpy()) for k, v in masks.items()}
    want = unimodal_transformer_forward(
        to_jax(params), jdims, to_jax(src), jnp.asarray(trg.numpy()),
        jmasks, rng=jax.random.key(8), deterministic=False,
        return_logits=True)
    model.train()
    with key_stream(prng.key(8, 'cpu')):
        got = model(to_torch(src), trg, masks, return_logits=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)


def _targets(batch, torch_side):
    keys = ('centers', 'lengths', 'valid')
    conv = torch.from_numpy if torch_side else jnp.asarray
    return tuple(conv(batch[k]) for k in keys)


@pytest.mark.parametrize('case', ['plain', 'remat', 'layer_norm'])
def test_bimodal_proposal_train_forward_matches_jax(case):
    kw = {'remat': dict(remat=True),
          'layer_norm': dict(layer_norm=True)}.get(case, {})
    jdims, params, model = jax_and_torch_generator(seed=3, dout_p=0.3, **kw)
    batch = prop_batch(12, jdims)
    src_t = to_torch(batch['src'])
    masks = make_masks(src_t, None, 'audio_video', PAD)
    jmasks = j_make_masks(to_jax(batch['src']), None, 'audio_video', PAD)
    want = jprop.multimodal_proposal_forward(
        params, jdims, to_jax(batch['src']), _targets(batch, False), jmasks,
        rng=jax.random.key(4), deterministic=False)
    model.train()
    with key_stream(prng.key(4, 'cpu')):
        got = model(src_t, _targets(batch, True), masks)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]),
                               **FWD_TOL)
    np.testing.assert_allclose(got[1].item(), float(want[1]), rtol=1e-5)
    for side in (2, 3):
        for k, v in want[side].items():
            np.testing.assert_allclose(got[side][k].item(), float(v),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize('modality', ['audio', 'video'])
def test_unimodal_proposal_train_forward_matches_jax(modality):
    jdims, params, model = generator(modality, seed=5, dout_p=0.3)
    batch = uni_prop_batch(6, modality, jdims)
    src_t = to_torch(batch['src'])
    masks = make_masks(src_t, None, modality, PAD)
    jmasks = j_make_masks(to_jax(batch['src']), None, modality, PAD)
    want = jprop.unimodal_proposal_forward(
        to_jax(params), jdims, to_jax(batch['src']), _targets(batch, False),
        jmasks, rng=jax.random.key(2), deterministic=False)
    model.train()
    with key_stream(prng.key(2, 'cpu')):
        got = model(src_t, _targets(batch, True), masks)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]),
                               **FWD_TOL)
    np.testing.assert_allclose(got[1].item(), float(want[1]), rtol=1e-5)
