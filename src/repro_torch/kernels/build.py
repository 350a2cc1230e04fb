"""Build the CUDA kernels from ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` holds one kernel behind a plain C entry point
(no PyTorch headers), so ``nvcc`` compiles it in seconds.  The shared
library goes to ``build/repro_torch/`` at the root of the checkout,
named by a hash of its source and flags: an edited source never loads
a stale library, and a finished build is reused by later processes.
Every build runs at first use, never at import — the CPU-only test
environment imports every module and has no ``nvcc``.

:func:`build` starts one ``nvcc`` per source, all at once, and waits
for them together; :func:`function` loads one entry point with its
ctypes signature.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
# the async serving engine launches from a flush and a refresh thread:
# one lock for first-use loading, one for the launch counts
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def sources() -> List[str]:
    """Names of every kernel source in ``csrc/`` (without ``.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the CUDA kernels are built on a machine with the "
                       "CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source text (headers in ``csrc/`` included in the hash)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (default: all) that have no library
    for their current text yet, one ``nvcc`` process per source, all
    started together.  Returns ``{name: ptxas report}`` for the sources
    compiled now; raises RuntimeError naming every source that failed.
    """
    names = sources() if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in todo:
        final = library_path(n)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{n}.cu")]
        procs.append((n, final, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, failed = {}, []
    for n, final, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            os.unlink(tmp)
            continue
        os.replace(tmp, final)     # atomic: concurrent builds agree
        reports[n] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build([name])
                lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def function(name: str, symbol: str, argtypes: Sequence,
             restype=ctypes.c_int):
    """Entry point ``symbol`` of ``csrc/<name>.cu`` with its ctypes
    signature set — every pointer and the stream as ``c_void_p``, so
    no 64-bit address is cut to a 32-bit int."""
    key = (name, symbol)
    fn = _FUNCS.get(key)
    if fn is None:
        lib = library(name)
        with _LOAD_LOCK:
            fn = _FUNCS.get(key)
            if fn is None:
                fn = getattr(lib, symbol)
                fn.argtypes = list(argtypes)
                fn.restype = restype
                _FUNCS[key] = fn
    return fn


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (chip_smoke.py sets the counts to
    0 around a path and reads them after).  Under a lock: ``+= 1`` is a
    read-modify-write, and two threads may launch at once."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def sm_count(device) -> int:
    """The SM count of a CUDA device, read once and then kept (the
    kernels' launch planners size their grids by it)."""
    import torch
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = _SMS.get(idx)
    if sms is None:
        sms = _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return sms


_SMS: Dict[int, int] = {}


def check(name: str, err: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if err:
        msg = function(name, "repro_error_string", [ctypes.c_int],
                       ctypes.c_char_p)(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build", "check",
           "count_launch", "function", "library", "library_path", "sm_count",
           "sources"]
