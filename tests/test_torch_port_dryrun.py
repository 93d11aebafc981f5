'''The port's multi-chip dry run on the CPU: ``python -m
bmt_tpu_torch.scripts.dryrun_multichip --device cpu --n_devices 4``
(four gloo ranks laid out sp 2 x mp 2, as the JAX dry run lays out four
devices) passes every section, section 8's K = 2 bundle included; its
two-process worker ``bmt_tpu_torch.parallel.dryrun_dist``, joined through
torchrun's variables, gives one process's loss and checksum (rtol 1e-5);
and its fixtures are the JAX package's (``bmt_tpu.parallel.dryrun_dist``),
dropout aside.'''
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from bmt_tpu.parallel import dryrun_dist as jdist
from bmt_tpu_torch.parallel import dryrun_dist
from bmt_tpu_torch.parallel.launch import free_port
from bmt_tpu_torch.scripts import dryrun_multichip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def dryrun():
    return dryrun_multichip.main(['--device', 'cpu', '--n_devices', '4'])


def test_dryrun_multichip_4_passes_every_section_but_8(dryrun):
    assert dryrun.startswith('dryrun_multichip(4) OK: mesh=dp1xsp2xmp2 ')
    for part in ('(seq-parallel)', 'decode=dp-invariant(2x7)+mp-tolerance',
                 'pipeline=pp2==seq', 'moe=ep2(E=4)', 'fsdp=dp4',
                 'lora=adapters-only(', 'multistep=K2(losses=(2,),step=2)',
                 'multihost=2proc-dp2'):
        assert part in dryrun, part
    assert dryrun.endswith('==single')


@pytest.mark.parametrize('n,grid', [(1, (1, 1, 1)), (2, (1, 1, 2)),
                                    (4, (1, 2, 2)), (8, (2, 2, 2))])
def test_dryrun_layout_is_the_jax_dry_runs(n, grid):
    '''8 -> dp 2 x sp 2 x mp 2, 4 -> sp 2 x mp 2, 2 -> mp 2 (the JAX dry
    run's rule: mp 2 when N is even, then sp 2 when N/mp is).'''
    assert dryrun_multichip.layout(n) == grid


def test_dryrun_layout_refuses_an_odd_count():
    with pytest.raises(ValueError, match='1 or an even count'):
        dryrun_multichip.layout(3)


def test_dryrun_dist_fixtures_are_the_jax_packages():
    '''The dims are JAX's with dropout off, the batch JAX's arrays, the
    optimizer JAX's.'''
    want = dataclasses.asdict(jdist.dryrun_dims())
    got = dataclasses.asdict(dryrun_dist.dryrun_dims())
    assert got.pop('dout_p') == 0.0
    want.pop('dout_p')
    assert got == want
    a, b = dryrun_dist.make_batch(), jdist.make_batch()
    for k in ('rgb', 'flow', 'audio'):
        np.testing.assert_array_equal(a['src'][k], b['src'][k])
    np.testing.assert_array_equal(a['caption'], b['caption'])
    for k in ('optimizer', 'lr', 'grad_clip', 'weight_decay', 'beta1',
              'beta2', 'eps'):
        assert getattr(dryrun_dist.OptCfg, k) == getattr(jdist.OptCfg, k)


def test_dryrun_dist_under_torchrun_variables_matches_one_process():
    '''Two ``python -m bmt_tpu_torch.parallel.dryrun_dist --device cpu``
    processes joined through RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT print
    the same RESULT, one process's step within rtol 1e-5.'''
    port = free_port()
    env = dict(os.environ, WORLD_SIZE='2', MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(port), PYTHONPATH=REPO)
    for k in ('JAX_COORDINATOR_ADDRESS', 'JAX_NUM_PROCESSES',
              'JAX_PROCESS_ID'):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'bmt_tpu_torch.parallel.dryrun_dist',
         '--device', 'cpu'], env=dict(env, RANK=str(r)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    results = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            line = [x for x in out.splitlines() if x.startswith('RESULT')]
            results.append(tuple(float(v) for v in line[-1].split()[1:]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    assert results[0] == results[1]
    loss, checksum = dryrun_dist.run_step()
    np.testing.assert_allclose(results[0], (loss, checksum), rtol=1e-5)


def test_dryrun_dist_without_a_group_says_so():
    env = {k: v for k, v in os.environ.items()
           if k not in ('RANK', 'WORLD_SIZE', 'JAX_COORDINATOR_ADDRESS')}
    proc = subprocess.run(
        [sys.executable, '-m', 'bmt_tpu_torch.parallel.dryrun_dist',
         '--device', 'cpu'], env=dict(env, PYTHONPATH=REPO), cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert 'no process group' in proc.stderr


def test_parallel_modules_load_nothing_of_the_jax_package():
    '''The new parallel modules and the dry run import with JAX blocked and
    load no module of the JAX package.'''
    code = ('import sys; sys.modules["jax"] = None; '
            'import bmt_tpu_torch.parallel.tensor, '
            'bmt_tpu_torch.parallel.pipeline, '
            'bmt_tpu_torch.parallel.sharding_rules, '
            'bmt_tpu_torch.parallel.dryrun_dist, '
            'bmt_tpu_torch.scripts.dryrun_multichip; '
            'from bmt_tpu_torch.parallel import DataParallel, '
            'ColumnParallelLinear; '
            'bad = [m for m in sys.modules if m == "bmt_tpu" '
            'or m.startswith(("bmt_tpu.", "jax."))]; '
            'print(bad); sys.exit(1 if bad else 0)')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
