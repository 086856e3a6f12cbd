"""Build the CUDA sources in `csrc/` with `nvcc` and load them with ctypes.

Each `csrc/<name>.cu` becomes one shared library with a plain C interface,
compiled for Hopper (`sm_90a`) at first use into `build/kernels/` at the
root of the checkout.  The library's file name carries a hash of its source,
the `csrc/*.cuh` headers and the flags, so an edited source is rebuilt
and a stale library is never loaded.  Nothing here runs at import time: the
CPU tests import every module on a machine with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; "
                           "the CUDA kernels are built only on a CUDA host")
    return path


def library_path(name: str) -> pathlib.Path:
    # the headers beside the sources count too: an edited header rebuilds
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str):
    """Start one nvcc for `csrc/<name>.cu`; None when already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source, all nvcc processes started together.

    Returns each library's compiler output (ptxas register and spill
    report), empty for a library that was already built.  Raises if any
    build fails.
    """
    started = {n: _start(n) for n in names}
    logs: Dict[str, str] = {}
    failed: List[str] = []
    for name, job in started.items():
        if job is None:
            logs[name] = ""
            continue
        out, tmp, proc = job
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


def entry(name: str, argtypes, symbol: str = "") -> ctypes._CFuncPtr:
    """`symbol` (by default `<name>_launch`) of `csrc/<name>.cu`, typed:
    every pointer and the stream as c_void_p, so ctypes never cuts them to
    32 bits.  Kept by name and symbol once typed, so a launch finds its
    function in one dict lookup, without the build lock."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol or f"{name}_launch")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[(name, symbol)] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise on a non-zero `cudaError_t` returned by `<name>_launch`."""
    if err != 0:
        describe = getattr(load(name), f"{name}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({describe(err).decode()})")
