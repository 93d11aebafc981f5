'''The port's multi-chip dry run: every parallel axis over one group of
ranks, each section checked (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

    python -m bmt_tpu_torch.scripts.dryrun_multichip --n_devices N
        [--device cpu] [--backend gloo]

spawns N ranks (``parallel.launch.spawn``: a card a rank under NCCL; gloo
on the CPU, or ranks sharing cards when ``--backend gloo`` is named) and
lays them out as the JAX dry run lays out its devices: 8 -> dp 2 x sp 2 x
mp 2, 4 -> sp 2 x mp 2, 2 -> mp 2 (N must be 1 or even). On tiny models
(the JAX dry run's dims, dropout off) the ranks run:

1. a captioning train step on the grid, its loss and parameters against one
   process (the sp ranks run the rows whole: the captioner has no sequence
   parallelism);
2. a proposal train step, sequence-parallel over sp when the grid has it,
   against one process;
3. a greedy decode with whole parameters, rows split over dp: tokens equal
   to one process's; 3b. the same decode with the trained mp-sharded
   parameters: tokens in the vocabulary, and the step log-probs along the
   one-process trajectory within 5e-4;
4. a two-layer bi-modal encoder pipelined over pairs of ranks (pp 2,
   ``parallel.pipeline``) against the sequential stack;
5. a Switch-MoE captioning step with E = 4 experts over ep 2 (dp N/2),
   each rank holding two;
6. an ``--fsdp`` captioning step over dp N, every leaf cut;
7. a LoRA step on the grid (rank 2, attention and feed-forward adapters,
   the adapters sharded like their base weights): only adapters move.

8. a bundle of K = 2 captioning steps (``make_multistep``, multi-step
   dispatch) on the grid: losses of shape (2,), all finite, the state two
   steps on, and the losses those of one process's bundle, which on the
   card replays a CUDA graph of the step (under the ranks' process group
   the bundle's steps run in order).

Section 9 runs ``python -m bmt_tpu_torch.parallel.dryrun_dist`` in two processes
joined through the JAX package's ``JAX_*`` variables (started first, they
run beside sections 1-7) and holds their ``RESULT`` line to one process.
A failed check raises (exit code 1); the last line is the summary, in the
JAX dry run's form.
'''
from __future__ import annotations

import argparse
import collections
import contextlib
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

CAP = dict(voc_size=64, d_model_A=16, d_model_V=16, d_model_C=16,
           d_model=32, H=2, N=2, d_ff_A=32, d_ff_V=32, d_ff_C=32, dout_p=0.0)
PROP = dict(d_model_A=16, d_model_V=16, d_model=32, H=2, N=1, d_ff_A=32,
            d_ff_V=32, d_vid=16, d_aud=16, kernel_sizes_A=(3, 5),
            kernel_sizes_V=(3, 5), conv_layers_A=(8,), conv_layers_V=(8,),
            anchors_num_A=2, anchors_num_V=2, dout_p=0.0)
ANCHORS = ([2.0, 6.0], [3.0, 9.0])
STEPS, START, END, PAD = 6, 2, 3, 1
MULTISTEP_K = 2                          # section 8's bundle
LOGPROB_TOL = 5e-4            # the JAX dry run's mp decode tolerance
STEP_RTOL = 1e-4              # losses and checksums against one process
PP_TOL = 1e-4


class Cfg:
    optimizer = 'adam'
    lr = 1e-4
    grad_clip = 1.0
    weight_decay = 0.0
    beta1, beta2, eps = 0.9, 0.999, 1e-8
    momentum = 0.0


class LoraCfg(Cfg):
    lora_rank = 2


def layout(n: int) -> tuple:
    '''(dp, sp, mp) of N ranks, as the JAX dry run lays out N devices.'''
    if n < 1 or (n > 1 and n % 2):
        raise ValueError(f'--n_devices {n}: 1 or an even count')
    mp = 2 if n % 2 == 0 else 1
    sp = 2 if (n // mp) % 2 == 0 else 1
    return n // (sp * mp), sp, mp


def fixtures(n: int) -> dict:
    '''Every section's inputs, from numpy seeds (the same in each rank and
    in the one process).'''
    dp = layout(n)[0]
    rng = np.random.default_rng(0)

    def src(B, sv, sa):
        return {'rgb': rng.normal(size=(B, sv, 16)).astype(np.float32),
                'flow': rng.normal(size=(B, sv, 16)).astype(np.float32),
                'audio': rng.normal(size=(B, sa, 16)).astype(np.float32)}

    def cap(B):
        return {'src': src(B, 6, 8),
                'caption': rng.integers(4, 64, size=(B, 7)).astype(np.int64)}
    B, E = 2 * dp, 3
    return {
        'cap': cap(B),
        'prop': {'src': src(B, 8, 10),
                 'centers': rng.uniform(1, 15, size=(B, E)).astype(
                     np.float32),
                 'lengths': rng.uniform(1, 6, size=(B, E)).astype(np.float32),
                 'valid': np.ones((B, E), bool)},
        'decode': src(B, 6, 8),
        'pp': (rng.normal(size=(4, 8, 16)).astype(np.float32),
               rng.normal(size=(4, 6, 16)).astype(np.float32)),
        'moe': cap(2 * max(n // 2, 1)),
        'fsdp': cap(2 * n),
    }


def tensors(tree, device):
    if isinstance(tree, dict):
        return {k: tensors(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def captioner(device, seed: int, **kw):
    from bmt_tpu_torch.models import BiModalTransformer, CapModelDims
    dims = CapModelDims(**{**CAP, **kw})
    return dims, BiModalTransformer(
        dims, device='cpu',
        generator=torch.Generator().manual_seed(seed)).to(device)


def lora_captioner(device, seed: int):
    """The captioner with rank-2 adapters on its attention and feed-forward
    linears (A drawn from a seeded generator, B zeros)."""
    from bmt_tpu_torch.ops.lora import add_lora
    dims, model = captioner(device, seed)
    add_lora(model, 2, torch.Generator(device=device).manual_seed(6),
             targets='attn_ffn')
    return dims, model


def flat_tree(model) -> dict:
    """{JAX path: fp32 array} of the model's whole parameters."""
    from bmt_tpu_torch.params import named_jax_parameters
    return {'/'.join(map(str, k)): p.detach().float().cpu().numpy().copy()
            for k, p in named_jax_parameters(model)}


def proposal(device, seed: int = 1):
    from bmt_tpu_torch.models import (MultimodalProposalGenerator,
                                      PropModelDims)
    dims = PropModelDims(**PROP)
    model = MultimodalProposalGenerator(
        dims, device='cpu', generator=torch.Generator().manual_seed(seed))
    model.set_anchors(*ANCHORS)
    return dims, model.to(device)


def impl_of(device) -> str:
    return 'kernel' if torch.device(device).type == 'cuda' else 'torch'


def checksum(model) -> float:
    return float(sum(p.detach().abs().sum().item()
                     for p in model.parameters()))


def train_step(kind, device, dp=None, batch=None, seed: int = 0,
               lora: bool = False, bundle: int = 0, **kw):
    """One train step of the captioner (``kind`` 'cap') or the proposal
    generator ('prop') over ``dp``'s grid (the captioner's sp ranks run its
    rows whole), or in one process: (dims, model, state, loss). ``lora``:
    rank-2 adapters on the attention and feed-forward linears, trained
    alone. ``bundle`` K > 0: K steps on ``batch`` through
    ``make_multistep``, the loss then the (K,) losses."""
    from bmt_tpu_torch.ops.lora import lora_frozen_predicate
    from bmt_tpu_torch.train.optim import build_optimizer
    from bmt_tpu_torch.train.steps import (init_train_state,
                                           make_cap_train_step,
                                           make_multistep,
                                           make_prop_train_step, prop_frozen)
    if kind == 'cap':
        dims, model = (lora_captioner if lora else captioner)(device, seed,
                                                               **kw)
        frozen = lora_frozen_predicate if lora else None
        cfg = LoraCfg() if lora else Cfg()
        step = make_cap_train_step(dims, 0.7, PAD, impl_of(device), dp=dp,
                                   moe_aux_coeff=0.01)
    else:
        dims, model = proposal(device, seed)
        cfg, frozen = Cfg(), prop_frozen(False)
        step = make_prop_train_step(dims, PAD, impl_of(device), dp=dp)
    state = init_train_state(model, build_optimizer(cfg, model,
                                                    frozen=frozen))
    if dp is not None:
        dp.shard_params(state, 0)        # under --fsdp every leaf is cut
        batch = dp.shard(batch, seq=kind == 'prop')
    if bundle:
        state, m = make_multistep(step)(state, [batch] * bundle)
        return dims, model, state, m['loss'].cpu().numpy()
    state, m = step(state, batch)
    return dims, model, state, m['loss'].item()


@torch.inference_mode()
def trajectory_logprobs(model, src, tokens, device) -> np.ndarray:
    """The step log-probs (steps 0-2) of the KV-cached decode teacher-forced
    along ``tokens``."""
    from bmt_tpu_torch.decode.greedy import bimodal_step_setup
    state, step_fn, _ = bimodal_step_setup(model, src, PAD, STEPS,
                                           impl_of(device))
    out = []
    for s in range(3):
        lp, state = step_fn(state, tokens[:, s:s + 1], s)
        out.append(lp.float().cpu().numpy())
    return np.stack(out)


def pipeline_error(device, host: bool, fx) -> float:
    """Section 4 on this rank's pair of ranks: the two-layer bi-modal
    encoder pipelined over pp 2 (n_micro 2) against the sequential stack;
    the largest absolute error of (Av, Va)."""
    import torch.distributed as dist
    from bmt_tpu_torch.models.encoders import BiModalEncoder
    from bmt_tpu_torch.parallel.mesh import axis_group
    from bmt_tpu_torch.parallel.pipeline import (
        pipelined_bimodal_encoder_forward, stack_layer_params)
    n = dist.get_world_size()
    group = axis_group((n // 2, 2), dist.get_rank(), (1,), host)
    torch.manual_seed(2)
    enc = BiModalEncoder(16, 16, 32, 32, 32, 2, 2, device='cpu').to(device)
    A, V = (torch.from_numpy(x).to(device) for x in fx['pp'])
    Am = torch.ones(4, 1, 8, dtype=torch.bool, device=device)
    Vm = torch.ones(4, 1, 6, dtype=torch.bool, device=device)
    with torch.no_grad():
        ref = enc(A, V, Am, Vm, impl_of(device))
        got = pipelined_bimodal_encoder_forward(
            stack_layer_params(enc.layers, 2, group.rank), A, V, Am, Vm,
            group, 2, attention_impl=impl_of(device))
    return max((a - b).abs().max().item() for a, b in zip(got, ref))


def grid_worker(n: int, record, device):
    """One rank's sections 1-7 (a ``launch.spawn`` target), its kernel
    launches counted from 0 and returned under ``'launches'``. ``record``,
    when given, is a context manager taking a Counter that counts the
    launches by shape; the Counter is returned under ``'launch_shapes'``."""
    from bmt_tpu_torch.ops.flash_attention import (launch_counts,
                                                   reset_launch_counts)
    reset_launch_counts()
    seen = collections.Counter()
    with record(seen) if record else contextlib.nullcontext():
        out = grid_sections(n, device)
    return {**out, 'launches': launch_counts(), 'launch_shapes': dict(seen)}


def grid_sections(n: int, device) -> dict:
    """``grid_worker``'s sections 1-7."""
    from bmt_tpu_torch.decode import greedy_decode_bimodal
    from bmt_tpu_torch.ops.moe import MoEFeedForward
    from bmt_tpu_torch.parallel import DataParallel
    torch.set_num_threads(1)
    fx = fixtures(n)
    n_dp, n_sp, n_mp = layout(n)
    dp = DataParallel(n_dp, device, sp=n_sp, mp=n_mp)
    out = {'rank': dp.rank, 'grid': (n_dp, n_sp, n_mp)}
    # (1) the captioner step
    dims, model, _, out['cap_loss'] = train_step('cap', device, dp,
                                                 fx['cap'])
    out['cap_heads'] = model.encoder.layers[0].self_att_M1.heads
    # (3, 3b) the decode, whole and mp-sharded, rows over dp
    src = tensors(fx['decode'], device)
    rows = dp.local_rows(src['audio'].shape[0])
    local = src if rows is None else {k: v[rows[0]:rows[1]]
                                      for k, v in src.items()}
    model.eval()
    with dp.whole(True):
        out['cap_checksum'] = checksum(model)
        toks = greedy_decode_bimodal(model, local, STEPS, START, END, PAD,
                                     impl_of(device))
        lp_whole = trajectory_logprobs(model, local, toks, device)
    out['toks'] = dp.gather_rows(toks).cpu().numpy()
    toks_mp = greedy_decode_bimodal(model, local, STEPS, START, END, PAD,
                                    impl_of(device))
    out['toks_mp'] = dp.gather_rows(toks_mp).cpu().numpy()
    out['logprob_err'] = float(np.abs(trajectory_logprobs(
        model, local, toks, device) - lp_whole).max())
    # (2) the proposal step (sequence-parallel over sp)
    _, _, _, out['prop_loss'] = train_step('prop', device, dp, fx['prop'])
    # (4) the pipelined encoder over pairs of ranks
    host = dp.backend == 'gloo' and torch.device(device).type != 'cpu'
    out['pp_err'] = pipeline_error(device, host, fx) if n >= 2 else None
    # (5) MoE over ep 2
    if n >= 2:
        moe = DataParallel(n // 2, device, ep=2)
        _, mmodel, _, out['moe_loss'] = train_step(
            'cap', device, moe, fx['moe'], seed=3, moe_experts=4)
        out['moe_local'] = {m.experts.w1.shape[0] for m in mmodel.modules()
                            if isinstance(m, MoEFeedForward)}
    # (6) --fsdp over dp N, every leaf cut
    if n >= 2:
        fdp = DataParallel(n, device, fsdp=True)
        _, fmodel, _, out['fsdp_loss'] = train_step('cap', device, fdp,
                                                    fx['fsdp'], seed=4)
        out['fsdp_cut'] = all(p.dim() == 1 for p in fmodel.parameters())
    # (7) LoRA on the grid: only adapters move
    before = flat_tree(lora_captioner(device, 5)[1])
    _, lmodel, _, out['lora_loss'] = train_step('cap', device, dp, fx['cap'],
                                                seed=5, lora=True)
    with dp.whole(True):
        after = flat_tree(lmodel)
    moved = [k for k in before if not np.array_equal(before[k], after[k])]
    out['lora_moved'] = len(moved)
    out['lora_frozen_moved'] = [k for k in moved
                                if k.rsplit('/', 1)[1] not in ('lora_a',
                                                               'lora_b')]
    # (8) a bundle of MULTISTEP_K captioning steps on the grid
    _, _, mstate, losses = train_step('cap', device, dp, fx['cap'], seed=9,
                                      bundle=MULTISTEP_K)
    out['multistep_losses'], out['multistep_step'] = losses, mstate.step
    return out


def start_two_process_step(device, backend) -> list:
    """Section 9, started: ``python -m bmt_tpu_torch.parallel.dryrun_dist``
    in two processes joined through the JAX package's ``JAX_*``
    variables, their output in temporary files (``two_process_step``
    reads them). Nothing else of the dry run depends on them, so they run
    beside sections 1-7."""
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f'127.0.0.1:{port}',
               JAX_NUM_PROCESSES='2',
               PYTHONPATH=root + os.pathsep + os.environ.get('PYTHONPATH',
                                                            ''))
    argv = [sys.executable, '-m', 'bmt_tpu_torch.parallel.dryrun_dist',
            '--device', str(device)]
    if backend:
        argv += ['--backend', backend]
    procs = []
    for i in range(2):
        out, err = tempfile.TemporaryFile('w+'), tempfile.TemporaryFile('w+')
        procs.append((subprocess.Popen(
            argv, env=dict(env, JAX_PROCESS_ID=str(i)), cwd=root,
            stdout=out, stderr=err, text=True), out, err))
    return procs


def two_process_step(procs) -> list:
    """Section 9's two processes (``start_two_process_step``) waited for:
    their (loss, checksum). Raises when one fails."""
    results = []
    for proc, out, err in procs:
        proc.wait(timeout=600)
        out.seek(0)
        err.seek(0)
        if proc.returncode != 0:
            raise RuntimeError(f'dryrun_dist worker:\n{err.read()[-3000:]}')
        line = [x for x in out.read().splitlines()
                if x.startswith('RESULT')][-1]
        results.append(tuple(float(v) for v in line.split()[1:]))
    return results


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f'dryrun_multichip: {what}')


def close(a: float, b: float, rtol: float = STEP_RTOL) -> bool:
    return bool(np.isfinite(a)) and abs(a - b) <= rtol * abs(b)


def dryrun_multichip(n: int, device='cuda', backend=None,
                     record=None) -> tuple:
    """Sections 1-9 over ``n`` ranks on ``device``; returns the summary
    line and the ranks' results (``grid_worker``'s, each with its kernel
    launches, and with ``record`` its launch shapes). Raises AssertionError
    on a failed check."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('dryrun_multichip: --device cuda, but no CUDA '
                           'device is available; pass --device cpu')
    layout(n)
    procs = start_two_process_step(device, backend) if n >= 2 else []
    try:
        return sections(n, device, backend, procs, record)
    finally:
        stop(procs)


def stop(procs) -> None:
    """Kill what is left of section 9's processes and close their files."""
    for proc, out, err in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        err.close()


def sections(n: int, device, backend, procs, record=None) -> tuple:
    """``dryrun_multichip``'s sections, section 9's two processes
    started."""
    from bmt_tpu_torch.decode import greedy_decode_bimodal
    from bmt_tpu_torch.parallel.dryrun_dist import run_step
    from bmt_tpu_torch.parallel.launch import spawn
    n_dp, n_sp, n_mp = layout(n)
    fx = fixtures(n)
    # one process: the references
    _, model, _, cap_loss = train_step('cap', device, None, fx['cap'])
    cap_sum = checksum(model)
    toks_single = greedy_decode_bimodal(
        model.eval(), tensors(fx['decode'], device), STEPS, START, END, PAD,
        impl_of(device)).cpu().numpy()
    _, _, _, prop_loss = train_step('prop', device, None, fx['prop'])
    _, _, mstate, ms_losses = train_step('cap', device, None, fx['cap'],
                                         seed=9, bundle=MULTISTEP_K)
    graphs = (mstate.graphs.report() if mstate.graphs is not None
              else 'none (CPU: steps in order)')
    del model, mstate
    ranks = spawn(grid_worker, (n, record), n, device, backend)
    r0 = ranks[0]
    for r in ranks:
        check(r['cap_loss'] == r0['cap_loss'], 'the ranks\' captioner '
              'losses differ')
    # (1), (2)
    check(close(r0['cap_loss'], cap_loss), f'captioner loss '
          f'{r0["cap_loss"]} != one process {cap_loss}')
    check(close(r0['cap_checksum'], cap_sum), f'captioner parameters '
          f'{r0["cap_checksum"]} != one process {cap_sum}')
    check(r0['cap_heads'] == CAP['H'] // n_mp, f'{r0["cap_heads"]} heads '
          f'a rank under mp {n_mp}')
    check(close(r0['prop_loss'], prop_loss), f'proposal loss '
          f'{r0["prop_loss"]} != one process {prop_loss}')
    # (3), (3b)
    check(r0['toks'].shape == (toks_single.shape[0], STEPS + 1),
          f'decode shape {r0["toks"].shape}')
    check(np.array_equal(r0['toks'], toks_single), 'the dp decode\'s '
          'tokens differ from one process\'s')
    check(((r0['toks_mp'] >= 0) & (r0['toks_mp'] < CAP['voc_size'])).all(),
          'mp decode tokens out of the vocabulary')
    check(max(r['logprob_err'] for r in ranks) <= LOGPROB_TOL,
          f'mp decode log-probs off by '
          f'{max(r["logprob_err"] for r in ranks)}')
    pp_ok = moe_ok = fsdp_ok = 'skipped'
    if n >= 2:
        # (4)
        err = max(r['pp_err'] for r in ranks)
        check(err <= PP_TOL, f'pipelined encoder off by {err}')
        pp_ok = 'pp2==seq'
        # (5)
        check(all(r['moe_local'] == {2} for r in ranks), 'experts a rank: '
              f'{[r["moe_local"] for r in ranks]}')
        check(np.isfinite(r0['moe_loss']), f'MoE loss {r0["moe_loss"]}')
        moe_ok = f'ep2(E=4) loss={r0["moe_loss"]:.4f}'
        # (6)
        check(all(r['fsdp_cut'] for r in ranks), 'an fsdp leaf is whole')
        check(np.isfinite(r0['fsdp_loss']), f'fsdp loss {r0["fsdp_loss"]}')
        fsdp_ok = f'dp{n} loss={r0["fsdp_loss"]:.4f}'
    # (7)
    check(r0['lora_moved'] > 0 and not r0['lora_frozen_moved'],
          f'LoRA step moved {r0["lora_moved"]} leaves, frozen ones among '
          f'them: {r0["lora_frozen_moved"]}')
    check(np.isfinite(r0['lora_loss']), f'LoRA loss {r0["lora_loss"]}')
    # (8)
    ms_got = np.asarray(r0['multistep_losses'])
    check(ms_got.shape == (MULTISTEP_K,) and np.isfinite(ms_got).all(),
          f'multistep losses {ms_got}')
    check(all(r['multistep_step'] == MULTISTEP_K for r in ranks),
          f'multistep state at step {[r["multistep_step"] for r in ranks]}, '
          f'{MULTISTEP_K} expected')
    check(all(close(a, b) for a, b in zip(ms_got, ms_losses)),
          f'multistep losses {ms_got} != one process\'s bundle {ms_losses}')
    print(f'dryrun_multichip: section 8 multistep K={MULTISTEP_K} losses '
          f'{ms_got.tolist()} == one process {ms_losses.tolist()}; one '
          f'process\'s graphs: {graphs}', flush=True)
    # (9)
    mhost_ok = 'skipped'
    if n >= 2:
        got = two_process_step(procs)
        check(got[0] == got[1], f'the two processes differ: {got}')
        ref = run_step(None, device)
        check(close(got[0][0], ref[0], 1e-5) and close(got[0][1], ref[1],
                                                        1e-5),
              f'two processes {got[0]} != one process {ref}')
        mhost_ok = f'2proc-dp2 loss={got[0][0]:.4f}==single'
    line = (f'dryrun_multichip({n}) OK: mesh=dp{n_dp}xsp{n_sp}xmp{n_mp} '
            f'cap_loss={r0["cap_loss"]:.4f} prop_loss={r0["prop_loss"]:.4f}'
            f'{"(seq-parallel)" if n_sp > 1 else ""} '
            f'decode=dp-invariant({r0["toks"].shape[0]}x'
            f'{r0["toks"].shape[1]})+mp-tolerance pipeline={pp_ok} '
            f'moe={moe_ok} fsdp={fsdp_ok} '
            f'lora=adapters-only({r0["lora_moved"]} leaves) '
            f'loss={r0["lora_loss"]:.4f} multistep=K{MULTISTEP_K}'
            f'(losses={ms_got.shape},step={MULTISTEP_K}) '
            f'multihost={mhost_ok}')
    return line, ranks


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--n_devices', type=int, default=8)
    p.add_argument('--device', default='cuda', help="'cuda' (the default) "
                   "or 'cpu'")
    p.add_argument('--backend', default=None, help='nccl (a card a rank) '
                   'or gloo; default: nccl on the card, gloo on the CPU')
    args = p.parse_args(argv)
    line, _ = dryrun_multichip(args.n_devices, args.device, args.backend)
    print(line, flush=True)
    return line


if __name__ == '__main__':
    main()
