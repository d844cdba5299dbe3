"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` (the hash
covers the source, the ``csrc`` headers it includes and the flags) at first
use, and loaded with ``ctypes``.
:func:`build` starts one ``nvcc`` per source, all together, under a file
lock: the processes of a process group start together and share the build
directory, so one builds and the others wait and load what it built.
:func:`launch` calls an entry point with the operands' device current. Nothing
is built or loaded when this module is imported, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

SOURCES = ("window_attention", "window_attention_bwd", "window_attention_general", "mlp",
           "mlp_bwd", "mlp_cln", "mlp_cln_bwd", "mlp_general", "mlp_cln_general")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")
# Flags of one source beside NVCC_FLAGS: the general sources have the most
# kernel instantiations, so their device-code optimisation and ptxas run on
# every core (the other sources' builds are shorter and overlap).
EXTRA_FLAGS = {"window_attention_general": ("--split-compile=0",),
               "mlp_general": ("--split-compile=0",),
               "mlp_cln_general": ("--split-compile=0",)}

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "/usr/local/cuda") + "/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _sources(path: Path, seen: set) -> bytes:
    """The text of ``path`` and of every ``csrc`` header it includes, at
    any depth, each once."""
    seen.add(path.name)
    text = path.read_bytes()
    for h in re.findall(rb'^#include "([^"]+)"', text, flags=re.M):
        if h.decode() not in seen:
            text += _sources(CSRC / h.decode(), seen)
    return text


def library_path(name: str) -> Path:
    text = _sources(CSRC / f"{name}.cu", set())
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
    digest = hashlib.sha1(text + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that are not built yet, one ``nvcc`` each,
    all started together. Returns seconds per source (0 when cached, or
    built by another process while this one waited for the lock: the lock
    is the file system's, released when its holder ends, whatever way)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build(names)


def _build(names: Iterable[str]) -> Dict[str, float]:
    nvcc = None
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       tmp, out, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (rc {rc}):\n{out.with_suffix('.log').read_text()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed, with argtypes set
    for each function in ``signatures`` (all return a cudaError_t int)."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return f"CUDA error {err}: {lib.cuda_error_string(err).decode()}"


def launch(lib: ctypes.CDLL, fn: str, device: torch.device, *args) -> None:
    """``lib.fn(*args)`` with ``device`` (the operands') the current device,
    raising on the error it returns. An entry point sets its kernel's
    attributes on, and launches on, the current device, and the stream it
    is given must be that device's: in a process that holds tensors on
    another card than its current one, a launch without this would go to
    the wrong card or fail."""
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: {error_string(lib, err)}")
