#!/usr/bin/env python3
'''Time the attention kernels of this checkout against those built from
another copy of ``bmt_tpu_torch/csrc/`` (an earlier commit's, unpacked with
``git archive``), in turns on the same inputs, beside the library call and
the bound: the forward with lse (``--kernels fwd``) against
``F.scaled_dot_product_attention``, and the backward pair, dQ and dK/dV
(``--kernels bwd``), against one ``autograd.grad`` through it, in bf16 or
(``--dtype float32``) fp32.

    git archive <commit> bmt_tpu_torch/csrc | tar -x -C tmp/other
    python3 kernel_ab.py --other parent=tmp/other/bmt_tpu_torch/csrc \\
        [--kernels fwd,bwd] [--dtype bfloat16|float32]

Shapes, those ``chip_smoke.py`` times: the forward at the train cell's
nine calls (the decoder's Sq = 21 and the two 2048-row ones included), the
proposal cell's four at B = 16 and at B = 1 (a served video's calls, whose
key loops a build may split, the combine kernel inside their time), then
in bf16 the four sp shapes, H = 2 and d = 32, in fp32 the two H = 2 ones
(256x256 B = 32, 800x800 B = 16) and the single-video app's caption batch
(B = 100: 512x512, 192x192, 512x192, 192x512); the backward in bf16 at the
train cell's seven, the proposal cell's four (B = 16), the sp shapes, H =
2 and d = 32; in fp32 at the shapes of the fp32 train steps: the train
cell's seven (B = 32, H = 4, d = 256), the proposal cell's four (B = 16)
and the two H = 2 ones.

Runs from the root of a checkout on one CUDA device. ``--other NAME=DIR``
may be given more than once. Each other library is built with the same
nvcc flags into ``build/kernels/``; its outputs are held to this
checkout's within chip_smoke's TOL (and the forward's lse within LSE_TOL)
and BWD_TOL before it is timed. An other bf16 forward takes a call as its
C entry points take it: split by this checkout's ``key_splits`` where its
split entry accepts bf16, whole where it refuses (a build before the bf16
split). An other fp32 forward is split as its own geometry would split it
(``--other_fp32_geometry``: query rows a block, keys a tile and blocks a
query tile, the ``mma.sync`` kernel's 64,32,1 by default), by the rule of
``fp32_key_splits``. Device ms by ``chip_smoke.device_ms``, mean of two
rounds of ``--iters`` calls in turns (this, the others, the library, then
back). Prints a line a shape, the others' ms in brackets, and, last, one
JSON object of every number.
'''
from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

import chip_smoke as cs
from bmt_tpu_torch.ops import _build
from bmt_tpu_torch.ops.flash_attention import (
    KERNEL, KERNEL_DKV, KERNEL_DQ, _run, _sm_count, attention_bound_ms,
    attention_cost, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    flash_attention_forward, key_mask_and_causal, key_splits,
    one_wave_splits, row_dot)

D32 = [('d=32 23x23 causal (decoder)', cs.TB, 4, 23, 23, 32, True),
       ('d=32 800x800 (audio encoder)', cs.TB, 4, 800, 800, 32, False)]


def bwd_cases(dev, dtype=torch.bfloat16):
    '''(case, key lengths or None for random ones) of the backward in
    ``dtype``.'''
    out = [(c, None) for c in cs.TRAIN_CASES[:7]]
    out += [(c, cs.prop_key_lengths(cs.PB, c[4], dev)) for c in cs.PROP_CASES]
    if dtype == torch.float32:
        return out + [(c, None) for c in cs.MP_TIME_CASES]
    out += [(c, None) for c in cs.SP_CASES + cs.MP_TIME_CASES + D32]
    return out


# the single-video app's caption batch (fp32): the encoder's four calls
APP_CASES = [(f'app caption {sq}x{sk}', 100, 4, sq, sk, 256, False)
             for sq, sk in ((512, 512), (192, 192), (512, 192), (192, 512))]


def fwd_cases(dev, dtype=torch.bfloat16):
    '''(case, key lengths or None for random ones) of the forward in
    ``dtype``.'''
    out = [(c, None) for c in cs.TRAIN_CASES]
    for b in (cs.PB, 1):
        out += [((f'{c[0]} B={b}', b) + c[2:],
                 cs.prop_key_lengths(b, c[4], dev)) for c in cs.PROP_CASES]
    if dtype == torch.float32:
        return out + [(c, None) for c in cs.MP_TIME_CASES + APP_CASES]
    out += [(c, None) for c in cs.SP_CASES + cs.MP_TIME_CASES + D32]
    return out


def geometry_splits(geometry, B, H, Sq, Sk, n_sms):
    '''The key splits of ``fp32_key_splits``'s rule for a forward of
    another geometry: (query rows a block, keys a tile, blocks a query
    tile).'''
    bq, bk, cl = geometry
    return one_wave_splits(B * H * -(-Sq // bq) * cl, -(-Sk // bk), n_sms)


def build_lib(csrc: str, name: str) -> ctypes.CDLL:
    '''``csrc``/<name>.cu built (its headers beside it) and loaded.'''
    src = os.path.join(csrc, f'{name}.cu')
    h = hashlib.sha256()
    for fname in sorted(os.listdir(csrc)):
        if fname.endswith(('.cu', '.cuh')):
            with open(os.path.join(csrc, fname), 'rb') as f:
                h.update(fname.encode() + f.read())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / f'ab-{name}-{h.hexdigest()[:16]}.so'
    if not lib.exists():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(lib), src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            sys.exit(f'nvcc failed for {src}:\n{proc.stderr[-4000:]}')
    return ctypes.CDLL(str(lib))


def build_other(csrc: str, kernels) -> dict:
    '''The C entry points of the libraries built from ``csrc``: fwd and
    split (the forward's), dq and dkv (the backward's), as ``kernels``
    asks.'''
    fns = {}
    if 'fwd' in kernels:
        lib = build_lib(csrc, 'flash_attn_fwd')
        fns['fwd'], fns['split'] = lib.flash_attn_fwd, lib.flash_attn_fwd_split
        fns['fwd'].argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                               + [ctypes.c_void_p])
        fns['split'].argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                                 + [ctypes.c_void_p])
        fns['fwd'].restype = fns['split'].restype = ctypes.c_int
    if 'bwd' in kernels:
        lib = build_lib(csrc, 'flash_attn_bwd')
        fns['dq'], fns['dkv'] = lib.flash_attn_bwd_dq, lib.flash_attn_bwd_dkv
        fns['dq'].argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fns['dkv'].argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fns['dq'].restype = fns['dkv'].restype = ctypes.c_int
    return fns


def other_forward(fns, q, k, v, km, causal, dev, geometry):
    '''A call of another build's forward with lse: in bf16 at this
    checkout's key splits, or whole where its split entry refuses bf16; in
    fp32 at the splits of its own ``geometry``: (fn, out, lse, splits).'''
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out, lse = torch.empty_like(q), q.new_empty((b, h, sq),
                                                dtype=torch.float32)
    dims = (b, h, sq, sk, d, int(causal))
    if q.dtype == torch.float32:
        splits = geometry_splits(geometry, b, h, sq, sk, _sm_count(dev))
    else:
        splits = key_splits(b, h, sq, sk, d, q.dtype, _sm_count(dev))
    if splits > 1:
        part = torch.empty(splits * b * h * sq * (d + 2),
                           dtype=torch.float32, device=dev)
        fn = functools.partial(_run, KERNEL, fns['split'], q, k, v, km, out,
                               lse, part, *dims, splits)
        try:
            fn()
            return fn, out, lse, splits
        except RuntimeError:
            pass                     # a build without the bf16 split
    fn = functools.partial(_run, KERNEL, fns['fwd'], q, k, v, km, out, lse,
                           *dims)
    fn()
    return fn, out, lse, 1


def time_fwd(case, lengths, others, dev, iters, dtype=torch.bfloat16,
             geometry=None):
    _, b, h, sq, sk, d, _ = case
    q, k, v, mask, _ = cs.attention_inputs(case, dtype, dev, 1, lengths)
    km, causal = key_mask_and_causal(mask, b, sk, dev)
    mine = flash_attention_forward(q, k, v, km, causal, with_lse=True)
    fns = {'fwd': lambda: flash_attention_forward(q, k, v, km, causal,
                                                  with_lse=True)}
    splits = {}
    for label, o in others.items():
        fn, out, lse, splits[label] = other_forward(o, q, k, v, km, causal,
                                                    dev, geometry)
        torch.cuda.synchronize()
        cs.check(torch.equal(out.isnan(), mine[0].isnan()),
                 f'{case[0]}: NaN rows of this build and {label} differ')
        err, ok = cs.within(out.nan_to_num(0.0), mine[0].nan_to_num(0.0),
                            *cs.TOL[dtype])
        cs.check(ok, f'{case[0]}: forward of this build and {label} differ '
                     f'by {err}')
        cs.check(torch.equal(lse.isneginf(), mine[1].isneginf()),
                 f'{case[0]}: -inf lse rows of this build and {label} '
                 f'differ')
        err, ok = cs.within(lse.nan_to_num(neginf=0.0),
                            mine[1].nan_to_num(neginf=0.0), *cs.LSE_TOL)
        cs.check(ok, f'{case[0]}: lse of this build and {label} differ by '
                     f'{err}')
        fns[f'fwd {label}'] = fn
    fns['library'] = lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)
    t = cs.alternating_ms(fns, iters, cs.device_ms)
    name = str(dtype).split('.')[-1]
    bound, by = attention_bound_ms(*attention_cost(
        KERNEL, b, h, sq, sk, d, name, causal), name)
    return {'shape': f'B={b} H={h} Sq={sq} Sk={sk} d={d}'
                     f'{" causal" if causal else ""}',
            'library_ms': t['library'],
            'splits': key_splits(b, h, sq, sk, d, dtype, _sm_count(dev)),
            'fwd': {'ms': t['fwd'], 'bound_ms': bound, 'bound_by': by,
                    'share': bound / t['fwd'],
                    'others_ms': {lb: t[f'fwd {lb}'] for lb in others},
                    'others_splits': splits}}


def time_bwd(case, lengths, others, dev, iters, dtype=torch.bfloat16):
    _, b, h, sq, sk, d, _ = case
    q, k, v, mask, _ = cs.attention_inputs(case, dtype, dev, 1, lengths)
    g = torch.Generator(device=dev).manual_seed(2)
    dout = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    km, causal = key_mask_and_causal(mask, b, sk, dev)
    out, lse = flash_attention_forward(q, k, v, km, causal, with_lse=True)
    drow = row_dot(out, dout)
    args = (q, k, v, km, causal, lse, drow, dout)
    dq_o, dk_o, dv_o = (torch.empty_like(x) for x in (q, k, v))
    dims = (b, h, sq, sk, d, int(causal))
    mine = (flash_attention_bwd_dq(*args), *flash_attention_bwd_dkv(*args))
    fns = {'dq': lambda: flash_attention_bwd_dq(*args),
           'dkv': lambda: flash_attention_bwd_dkv(*args)}
    for label, o in others.items():
        fns[f'dq {label}'] = functools.partial(
            _run, KERNEL_DQ, o['dq'], q, k, v, km, dout, lse, drow, dq_o,
            *dims)
        fns[f'dkv {label}'] = functools.partial(
            _run, KERNEL_DKV, o['dkv'], q, k, v, km, dout, lse, drow, dk_o,
            dv_o, *dims)
        fns[f'dq {label}']()
        fns[f'dkv {label}']()
        torch.cuda.synchronize()
        for name, x, y in zip(('dq', 'dk', 'dv'), mine, (dq_o, dk_o, dv_o)):
            err, ok = cs.within(x, y, *cs.BWD_TOL[dtype])
            cs.check(ok, f'{case[0]}: {name} of this build and {label} '
                         f'differ by {err}')
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    fns['library'] = lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dout,
                                                 retain_graph=True)
    t = cs.alternating_ms(fns, iters, cs.device_ms)
    res = {'shape': f'B={b} H={h} Sq={sq} Sk={sk} d={d}'
                    f'{" causal" if causal else ""}',
           'library_ms': t['library']}
    name = str(dtype).split('.')[-1]
    for kname, key in ((KERNEL_DQ, 'dq'), (KERNEL_DKV, 'dkv')):
        bound, by = attention_bound_ms(*attention_cost(
            kname, b, h, sq, sk, d, name, causal), name)
        res[key] = {'ms': t[key], 'bound_ms': bound, 'bound_by': by,
                    'share': bound / t[key],
                    'others_ms': {label: t[f'{key} {label}']
                                  for label in others}}
    return res


def bracket(ms: dict) -> str:
    return '[' + ' '.join(f'{v:.4f}' for v in ms.values()) + ']'


def kernel_part(r, key):
    return (f'{key} {r[key]["ms"]:.4f} {bracket(r[key]["others_ms"])} bound '
            f'{r[key]["bound_ms"]:.4f} {r[key]["bound_by"]} '
            f'{r[key]["share"]:.1%}')


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--other', action='append', required=True,
                   metavar='NAME=DIR',
                   help='a name and a directory holding another '
                        'flash_attn_fwd.cu, flash_attn_bwd.cu and their '
                        'headers')
    p.add_argument('--kernels', default='fwd,bwd',
                   help='comma-separated: fwd (the forward with lse), bwd '
                        '(dQ and dK/dV)')
    p.add_argument('--dtype', default='bfloat16',
                   choices=('bfloat16', 'float32'),
                   help='the kernels\' dtype')
    p.add_argument('--other_fp32_geometry', default='64,32,1',
                   metavar='BQ,BK,CL',
                   help='the other builds\' fp32 forward: query rows a '
                        'block, keys a tile, blocks a query tile (their '
                        'key splits follow from it; default: the mma.sync '
                        'kernel\'s)')
    p.add_argument('--iters', type=int, default=10)
    a = p.parse_args(argv)
    kernels = a.kernels.split(',')
    dtype = getattr(torch, a.dtype)
    geometry = tuple(int(x) for x in a.other_fp32_geometry.split(','))
    if not set(kernels) <= {'fwd', 'bwd'}:
        sys.exit(f'kernel_ab: --kernels takes fwd and bwd, not {a.kernels}')
    if len(geometry) != 3:
        sys.exit('kernel_ab: --other_fp32_geometry takes BQ,BK,CL')
    if not torch.cuda.is_available():
        sys.exit('kernel_ab: no CUDA device')
    dev = torch.device('cuda:0')
    smi = cs.device_line()
    print(smi)
    others = dict(spec.split('=', 1) for spec in a.other)
    others = {label: build_other(path, kernels)
              for label, path in others.items()}
    print(f'others in brackets: {", ".join(others)}')
    rows = {'fwd': [], 'bwd': []}
    if 'fwd' in kernels:
        for case, lengths in fwd_cases(dev, dtype):
            r = time_fwd(case, lengths, others, dev, a.iters, dtype,
                         geometry)
            rows['fwd'].append({'name': case[0], **r})
            print(f'fwd {case[0]:32s} {r["shape"]:30s} splits '
                  f'{r["splits"]} {r["fwd"]["others_splits"]}; '
                  + kernel_part(r, 'fwd')
                  + f'; library {r["library_ms"]:.4f}', flush=True)
    if 'bwd' in kernels:
        for case, lengths in bwd_cases(dev, dtype):
            r = time_bwd(case, lengths, others, dev, a.iters, dtype)
            rows['bwd'].append({'name': case[0], **r})
            pair = {label: r['dq']['others_ms'][label]
                    + r['dkv']['others_ms'][label] for label in others}
            print(f'bwd {case[0]:28s} {r["shape"]:28s} ' + '; '.join(
                kernel_part(r, k) for k in ('dq', 'dkv'))
                + f'; pair {r["dq"]["ms"] + r["dkv"]["ms"]:.4f} '
                f'{bracket(pair)} library {r["library_ms"]:.4f}', flush=True)
    print(json.dumps({'device': smi, 'iters': a.iters, 'dtype': a.dtype,
                      'rows': rows}))


if __name__ == '__main__':
    main()
