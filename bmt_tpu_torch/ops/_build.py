'''Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes)
and its two host libraries (the host compiler -> shared library -> ctypes).

Each CUDA library is one ``bmt_tpu_torch/csrc/<name>.cu`` file with a plain C
entry point; the sources share helpers in ``csrc/*.cuh``. It is compiled on
the first CUDA call that needs it, never at import, into ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``). The library's file
name carries a hash of the source, the headers and the flags, so an edited
source or header builds anew and a stale library is never loaded. nvcc runs with ``-Xptxas -v``; what ptxas reports (registers, shared
memory and spills of each kernel) is kept beside the library as
``<library>.ptxas.txt`` and returned by ``ptxas_report``.

A host library is one ``csrc/<name>.cc`` file with a plain C interface (the
feature loader ``bmt_io`` and the METEOR aligner ``meteor_align``), built by
``load_host_library`` with ``$CXX`` (``g++`` when unset) into
``build/host/``, named by a hash of its source, the compiler, its flags and
the host CPU (``-march=native`` ties the code to it). Nothing here imports
torch: the datasets and the scorers load these libraries in processes that
never do.
'''
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
HOST_BUILD_DIR = BUILD_DIR.parent / 'host'
HOST_FLAGS = ('-O3', '-march=native', '-std=c++17', '-fPIC', '-pthread',
              '-shared')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    candidates = [os.path.join(cuda_home, 'bin', 'nvcc')] if cuda_home else []
    candidates += [shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc']
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError('nvcc not found (set CUDA_HOME): the CUDA kernels are '
                       'compiled on first use and need the CUDA toolkit')


def _lib_path(name: str) -> Path:
    '''The library's path: its name carries a hash of the source, of every
    header in ``csrc/`` (any of them may be included) and of the flags.'''
    h = hashlib.sha256((CSRC_DIR / f'{name}.cu').read_bytes())
    for header in sorted(CSRC_DIR.glob('*.cuh')):
        h.update(header.name.encode() + header.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def ptxas_report(name: str) -> str:
    '''What ptxas printed when the current library of ``name`` was built
    (empty if it has not been built).'''
    log = _lib_path(name).with_suffix('.ptxas.txt')
    return log.read_text() if log.exists() else ''


def sass(name: str) -> str:
    '''The machine code of the current library of ``name`` as ``cuobjdump
    -sass`` prints it (the toolkit's, beside nvcc): a ``Function :`` line
    before each kernel's instructions. Raises if it has not been built.'''
    cuobjdump = Path(_nvcc()).with_name('cuobjdump')
    proc = subprocess.run([str(cuobjdump), '-sass', str(_lib_path(name))],
                          capture_output=True, text=True, check=True)
    return proc.stdout


_LOCKS_LOCK = threading.Lock()
_LOCKS: dict = {}


def _build_lock(name: str) -> threading.Lock:
    '''One lock a library: threads that need the same library first at the
    same time wait for one build, and two libraries build side by side.'''
    with _LOCKS_LOCK:
        return _LOCKS.setdefault(name, threading.Lock())


def load_library(name: str) -> ctypes.CDLL:
    '''Compile ``csrc/<name>.cu`` if no library of this source exists yet,
    then load it. Cached per process; threads that launch a kernel first
    at the same time (the serving replicas) wait for one build.'''
    with _build_lock(name):
        return _load_library(name)


@functools.cache
def _load_library(name: str) -> ctypes.CDLL:
    src = CSRC_DIR / f'{name}.cu'
    lib_path = _lib_path(name)
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f'.tmp{os.getpid()}.so')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {src}:\n{" ".join(cmd)}\n'
                               f'{proc.stdout}\n{proc.stderr}')
        lib_path.with_suffix('.ptxas.txt').write_text(proc.stderr)
        os.replace(tmp, lib_path)    # atomic: concurrent builders never
        #                              load a half-written library
    return ctypes.CDLL(str(lib_path))


class HostCompileError(RuntimeError):
    '''A host library did not build: the message holds the compiler's
    command and what it printed.'''


def _host_cpu() -> bytes:
    '''The model and feature flags of this host's CPU, as ``/proc/cpuinfo``
    lists them for its first core (empty where it cannot be read).'''
    try:
        with open('/proc/cpuinfo', 'rb') as f:
            first = f.read().split(b'\n\n', 1)[0]
    except OSError:
        return b''
    return b'\n'.join(line for line in first.splitlines()
                      if line.startswith((b'model name', b'flags')))


def _host_compiler() -> str:
    return os.environ.get('CXX') or 'g++'


def host_lib_path(name: str) -> Path:
    '''The host library's path: its name carries a hash of
    ``csrc/<name>.cc``, the compiler, the flags and the host CPU.'''
    h = hashlib.sha256((CSRC_DIR / f'{name}.cc').read_bytes())
    h.update(' '.join((_host_compiler(), *HOST_FLAGS)).encode())
    h.update(_host_cpu())
    return HOST_BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def load_host_library(name: str) -> ctypes.CDLL:
    '''Compile ``csrc/<name>.cc`` if no library of this source, compiler,
    flags and CPU exists yet, then load it. The lock is held across the
    build, and the library is written to a temporary file first and moved
    into place, so neither a thread nor another process loads a
    half-written one. Raises ``HostCompileError`` when the compiler fails or
    is missing.'''
    with _build_lock(f'{name}.cc'):
        lib_path = host_lib_path(name)
        if not lib_path.exists():
            HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f'.tmp{os.getpid()}.so')
            cmd = [_host_compiler(), *HOST_FLAGS, '-o', str(tmp),
                   str(CSRC_DIR / f'{name}.cc')]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise HostCompileError(f'{" ".join(cmd)}\n{e}') from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise HostCompileError(f'{" ".join(cmd)}\n{proc.stdout}\n'
                                     f'{proc.stderr}')
            os.replace(tmp, lib_path)
        return ctypes.CDLL(str(lib_path))
