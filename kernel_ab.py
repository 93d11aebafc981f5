#!/usr/bin/env python3
'''Time the bf16 backward pair (dQ and dK/dV) of this checkout against the
pair built from another copy of ``bmt_tpu_torch/csrc/`` (an earlier
commit's, unpacked with ``git archive``), in turns on the same inputs, beside
one ``autograd.grad`` through ``F.scaled_dot_product_attention`` and the
bound, at the shapes ``chip_smoke.py`` times: the train cell's seven calls,
the proposal cell's four, the four sp shapes, H = 2 and d = 32.

    git archive <commit> bmt_tpu_torch/csrc | tar -x -C tmp/other
    python3 kernel_ab.py --other parent=tmp/other/bmt_tpu_torch/csrc

Runs from the root of a checkout on one CUDA device. ``--other NAME=DIR``
may be given more than once. Each other library is built with the same
nvcc flags into ``build/kernels/``; its outputs are held to this
checkout's within chip_smoke's BWD_TOL before it is timed. Device ms by
``chip_smoke.device_ms``, mean of two rounds of ``--iters`` calls in turns
(this, the others, the library, then back). Prints a line a shape, the
others' ms in brackets, and, last, one JSON object of every number.
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
    KERNEL_DKV, KERNEL_DQ, _run, attention_bound_ms, attention_cost,
    flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_forward,
    key_mask_and_causal, row_dot)

D32 = [('d=32 23x23 causal (decoder)', cs.TB, 4, 23, 23, 32, True),
       ('d=32 800x800 (audio encoder)', cs.TB, 4, 800, 800, 32, False)]


def cases(dev):
    '''(case, key lengths or None for random ones) at every timed shape.'''
    out = [(c, None) for c in cs.TRAIN_CASES[:7]]
    out += [(c, cs.prop_key_lengths(cs.PB, c[4], dev)) for c in cs.PROP_CASES]
    out += [(c, None) for c in cs.SP_CASES + cs.MP_TIME_CASES + D32]
    return out


def build_other(csrc: str):
    '''(dq, dkv) C entry points of the backward library built from
    ``csrc``/flash_attn_bwd.cu (its headers beside it).'''
    src = os.path.join(csrc, 'flash_attn_bwd.cu')
    h = hashlib.sha256()
    for name in sorted(os.listdir(csrc)):
        if name.endswith(('.cu', '.cuh')):
            with open(os.path.join(csrc, name), 'rb') as f:
                h.update(name.encode() + f.read())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / f'ab-{h.hexdigest()[:16]}.so'
    if not lib.exists():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(lib), src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            sys.exit(f'nvcc failed for {src}:\n{proc.stderr[-4000:]}')
    cdll = ctypes.CDLL(str(lib))
    dq, dkv = cdll.flash_attn_bwd_dq, cdll.flash_attn_bwd_dkv
    dq.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    dkv.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    dq.restype = dkv.restype = ctypes.c_int
    return dq, dkv


def time_case(case, lengths, others, dev, iters):
    _, b, h, sq, sk, d, _ = case
    q, k, v, mask, _ = cs.attention_inputs(case, torch.bfloat16, dev, 1,
                                           lengths)
    g = torch.Generator(device=dev).manual_seed(2)
    dout = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
    km, causal = key_mask_and_causal(mask, b, sk, dev)
    out, lse = flash_attention_forward(q, k, v, km, causal, with_lse=True)
    drow = row_dot(out, dout)
    args = (q, k, v, km, causal, lse, drow, dout)
    dq_o, dk_o, dv_o = (torch.empty_like(x) for x in (q, k, v))
    dims = (b, h, sq, sk, d, int(causal))
    mine = (flash_attention_bwd_dq(*args), *flash_attention_bwd_dkv(*args))
    fns = {'dq': lambda: flash_attention_bwd_dq(*args),
           'dkv': lambda: flash_attention_bwd_dkv(*args)}
    for label, (dq_fn, dkv_fn) in others.items():
        fns[f'dq {label}'] = functools.partial(
            _run, KERNEL_DQ, dq_fn, q, k, v, km, dout, lse, drow, dq_o, *dims)
        fns[f'dkv {label}'] = functools.partial(
            _run, KERNEL_DKV, dkv_fn, q, k, v, km, dout, lse, drow, dk_o,
            dv_o, *dims)
        fns[f'dq {label}']()
        fns[f'dkv {label}']()
        torch.cuda.synchronize()
        for name, x, o in zip(('dq', 'dk', 'dv'), mine, (dq_o, dk_o, dv_o)):
            err, ok = cs.within(x, o, *cs.BWD_TOL[torch.bfloat16])
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
    for kname, key in ((KERNEL_DQ, 'dq'), (KERNEL_DKV, 'dkv')):
        bound, by = attention_bound_ms(*attention_cost(
            kname, b, h, sq, sk, d, 'bfloat16', causal), 'bfloat16')
        res[key] = {'ms': t[key], 'bound_ms': bound, 'bound_by': by,
                    'share': bound / t[key],
                    'others_ms': {label: t[f'{key} {label}']
                                  for label in others}}
    return res


def bracket(ms: dict) -> str:
    return '[' + ' '.join(f'{v:.4f}' for v in ms.values()) + ']'


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--other', action='append', required=True,
                   metavar='NAME=DIR',
                   help='a name and a directory holding another '
                        'flash_attn_bwd.cu and its headers')
    p.add_argument('--iters', type=int, default=10)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit('kernel_ab: no CUDA device')
    dev = torch.device('cuda:0')
    smi = cs.device_line()
    print(smi)
    others = dict(spec.split('=', 1) for spec in a.other)
    others = {label: build_other(path) for label, path in others.items()}
    print(f'others in brackets: {", ".join(others)}')
    rows = []
    for case, lengths in cases(dev):
        r = time_case(case, lengths, others, dev, a.iters)
        rows.append({'name': case[0], **r})
        pair = {label: r['dq']['others_ms'][label]
                + r['dkv']['others_ms'][label] for label in others}
        print(f'{case[0]:28s} {r["shape"]:28s} ' + '; '.join(
            f'{k} {r[k]["ms"]:.4f} {bracket(r[k]["others_ms"])} bound '
            f'{r[k]["bound_ms"]:.4f} {r[k]["bound_by"]} {r[k]["share"]:.1%}'
            for k in ('dq', 'dkv'))
            + f'; pair {r["dq"]["ms"] + r["dkv"]["ms"]:.4f} {bracket(pair)} '
            f'library {r["library_ms"]:.4f}', flush=True)
        print(json.dumps({'device': smi, 'iters': a.iters, 'rows': rows}))


if __name__ == '__main__':
    main()
