'''One count of launches for every hand-written kernel of the port.

A kernel's wrapper adds one to its count where it launches the kernel,
and nowhere else; a CUDA graph's replay adds what its capture recorded
(``train.graphs``), since a capture itself launches nothing. Each kernel
registers the function that wraps it, whose ``.launches`` holds the
count, so ``flash_attention.launches`` and the like read it directly;
``counts``, ``add`` and ``reset`` act on every registered kernel at once,
or on those named.
'''
from __future__ import annotations

import threading
from typing import Iterable, Optional

_lock = threading.Lock()         # replicas decode in threads of their own
_wrappers: dict = {}


def register(name: str, wrapper) -> None:
    '''Count ``name``'s launches in ``wrapper.launches``, from 0.'''
    with _lock:
        wrapper.launches = 0
        _wrappers[name] = wrapper


def launched(name: str) -> None:
    '''One launch of ``name``: its wrapper calls this after the launch.'''
    with _lock:
        _wrappers[name].launches += 1


def counts(names: Optional[Iterable[str]] = None) -> dict:
    '''{kernel name: launches so far} of ``names`` (default: every
    registered kernel).'''
    with _lock:
        return {n: _wrappers[n].launches for n in (names or _wrappers)}


def add(delta: dict) -> None:
    '''Add {kernel name: launches} to the counts.'''
    with _lock:
        for n, k in delta.items():
            _wrappers[n].launches += k


def reset(names: Optional[Iterable[str]] = None) -> None:
    '''The counts of ``names`` (default: every kernel) to 0.'''
    with _lock:
        for n in (names or list(_wrappers)):
            _wrappers[n].launches = 0
