"""ctypes binding of the native (C++/libpng) batch PNG decoder.

The counterpart of `vit3d_ensemble_tpu/data/native_loader.py`.  It builds
the repo's `native/volume_loader.cpp`, unedited, with `g++ ... -lpng -lz`
into `build/native/` at the root of the checkout (never into `native/`),
under a name that carries a hash of the source and the flags, and binds it
with ctypes, checking `v3d_version() == 1`.  One C call decodes a patient
folder's slices.

Where the library cannot be built or loaded (no compiler, no libpng), or
`VIT3D_NATIVE=0`, the PNGs go through the stdlib decoder of `data/png.py`
instead of PIL, which the card's host lacks.  `decoder()` names the decoder
in use ('native' or 'zlib'); it is logged once, on first use, and
`status()` says why.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import pathlib
import subprocess
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _REPO_ROOT / "native" / "volume_loader.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "native"
CXX_FLAGS = ("-O2", "-fPIC", "-Wall", "-shared", "-pthread")
LIBS = ("-lpng", "-lz")
ABI_VERSION = 1

#: why the native library is not in use, once `load_library` has run
_failure: Optional[str] = None


def library_path() -> pathlib.Path:
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libv3dnative-{tag}.so"


def _build(out: pathlib.Path) -> Optional[str]:
    """Compile the library into `out`; the compiler's complaint on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"g++ did not run: {exc}"
    if res.returncode != 0:
        return f"g++ exit {res.returncode}: {res.stderr.strip()[-400:]}"
    os.replace(tmp, out)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _failure
    if os.environ.get("VIT3D_NATIVE", "1") == "0":
        _failure = "disabled by VIT3D_NATIVE=0"
        return None
    if not SOURCE.exists():
        _failure = f"{SOURCE} is missing"
        return None
    path = library_path()
    if not path.exists():
        _failure = _build(path)
        if _failure:
            return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:
        _failure = f"load failed: {exc}"
        return None
    if lib.v3d_version() != ABI_VERSION:
        _failure = f"ABI {lib.v3d_version()} != {ABI_VERSION}"
        return None
    lib.v3d_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.v3d_decode_batch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None -> the zlib decoder."""
    lib = _load()
    if lib is None:
        logger.warning("PNG decoder: zlib (stdlib); the native libpng "
                       "decoder is unavailable: %s", _failure)
    else:
        logger.info("PNG decoder: native (libpng), %s", library_path())
    return lib


def decoder() -> str:
    """'native' or 'zlib': the decoder that PNG folders go through."""
    return "zlib" if load_library() is None else "native"


def status() -> dict:
    """The decoder in use, the library's path, and why it is not in use."""
    lib = load_library()
    return {"decoder": decoder(),
            "library": None if lib is None else str(library_path()),
            "reason": _failure}


def decode_batch(paths: Sequence[str], size: int) -> Optional[np.ndarray]:
    """Decode n same-size grayscale PNGs -> (n, size, size) uint8, or None
    when the native path is unavailable or any image fails."""
    lib = load_library()
    if lib is None or not paths:
        return None
    n = len(paths)
    out = np.empty((n, size, size), dtype=np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = lib.v3d_decode_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), size)
    if rc != 0:
        logger.debug("native decode failed for %s", paths[rc - 1])
        return None
    return out
