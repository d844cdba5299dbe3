"""ctypes bindings for the native collate library (native/fast_collate.cc).

Loads ``libfast_collate.so`` if built (``make -C native``); falls back to
numpy so the package works without the native build. The loader's batch
assembly (data/loader.py:_collate) calls :func:`collate_stack`.

The port's copy of ``poseidon_tpu/data/native.py``.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for cand in (os.path.join(here, "native", "libfast_collate.so"),
                 "libfast_collate.so"):
        try:
            lib = ctypes.CDLL(cand)
            lib.collate_stack.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64]
            _LIB = lib
            break
        except OSError:
            continue
    return _LIB


def available() -> bool:
    return _load() is not None


def _ptr_array(samples):
    arr = (ctypes.c_void_p * len(samples))()
    for i, s in enumerate(samples):
        arr[i] = s.ctypes.data_as(ctypes.c_void_p).value
    return arr


def collate_stack(samples) -> np.ndarray:
    """Parallel stack of N equal-shape float32 arrays."""
    samples = [np.ascontiguousarray(s, np.float32) for s in samples]
    n = len(samples)
    out = np.empty((n,) + samples[0].shape, np.float32)
    lib = _load()
    if lib is not None:
        lib.collate_stack(_ptr_array(samples),
                          out.ctypes.data_as(ctypes.c_void_p),
                          n, int(np.prod(samples[0].shape)))
        return out
    out[:] = np.stack(samples)
    return out
