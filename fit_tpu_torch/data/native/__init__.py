"""Native (C++) data path: GIL-free .npy load, fp16 decode, flip, patchify
and pad or gather into a batch.

Counterpart of ``fit_tpu/data/native/__init__.py`` with the same C
interface (``packer.cpp``, the port's own copy, called through ctypes).
``g++`` builds it at first use, never at import, into
``build/fit_tpu_torch/`` at the repository root, as a library named by a
hash of the source, the compiler command and the host CPU's flags: the
build uses ``-march=native``, so a library built on another CPU is never
loaded. A failed build raises with the compiler's output; callers that want
numpy ask for it (``LatentLoader(native=False)``).

The build has no ``-fopenmp`` (the H100 machine's ``g++`` has no
``libgomp``), so each C call packs its samples in turn: each batch is
split into contiguous runs of samples, one C call a run, on a pool of
threads (ctypes releases the GIL for the call).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["get_lib", "pack_batch_native", "pack_batch_gather_native"]

SRC = Path(__file__).resolve().parent / "packer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "fit_tpu_torch"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
WORKERS = os.cpu_count() or 1  # threads that pack one batch

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_pool: Optional[ThreadPoolExecutor] = None


def _cpu_flags() -> str:
    """The host CPU's feature flags (Linux ``/proc/cpuinfo``), which
    ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    import platform

    return platform.machine() + " " + platform.processor()


def _cxx() -> str:
    """``g++``, found on ``PATH``."""
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("the native packer needs g++ to build; pass native=False to use numpy")
    return cxx


def library_path() -> Path:
    """Where the packer for this source, compiler command and CPU lives."""
    cmd = " ".join([_cxx(), *CXX_FLAGS])
    digest = hashlib.sha256(SRC.read_bytes() + cmd.encode() + _cpu_flags().encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfitpacker_{digest}.so"


def _build(path: Path) -> None:
    """Compile into a temporary name, then rename: a concurrent or cut-off
    build never leaves a half-written library under the final name."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_cxx(), *CXX_FLAGS, "-o", tmp, str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except BaseException:
        os.unlink(tmp)
        raise
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"g++ failed to build the native packer (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)


def get_lib() -> ctypes.CDLL:
    """The native packer, built at the first call; raises if it cannot build."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.pack_batch.restype = ctypes.c_int
        lib.pack_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),  # paths
            ctypes.POINTER(ctypes.c_int),  # flips
            ctypes.c_int,  # n
            ctypes.c_int,  # patch
            ctypes.c_int,  # max_len
            ctypes.c_int,  # dtok
            ctypes.POINTER(ctypes.c_float),  # out_tokens
            ctypes.POINTER(ctypes.c_ubyte),  # out_mask
            ctypes.POINTER(ctypes.c_int),  # out_hw
            ctypes.POINTER(ctypes.c_int),  # lengths
        ]
        lib.pack_batch_gather.restype = ctypes.c_int
        lib.pack_batch_gather.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),  # paths
            ctypes.POINTER(ctypes.c_int),  # flips
            ctypes.POINTER(ctypes.c_int),  # gather (n, n_out)
            ctypes.c_int,  # n
            ctypes.c_int,  # n_out
            ctypes.c_int,  # patch
            ctypes.c_int,  # dtok
            ctypes.POINTER(ctypes.c_float),  # out_tokens
            ctypes.POINTER(ctypes.c_ubyte),  # out_mask
            ctypes.POINTER(ctypes.c_int),  # out_hw
            ctypes.POINTER(ctypes.c_int),  # lengths
        ]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _in_threads(n: int, pack, paths, lengths: np.ndarray) -> None:
    """``pack(a, b)`` packs samples a..b-1 and returns the C call's code (0,
    or -(i+1) for its first failing sample i); run it over up to WORKERS
    contiguous runs of the batch in threads and raise on a failed sample."""
    global _pool
    with _lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=WORKERS, thread_name_prefix="fitpacker")
    bounds = np.linspace(0, n, min(n, WORKERS) + 1).astype(int)
    runs = [(a, _pool.submit(pack, a, b)) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    for a, err in [(a, run.result()) for a, run in runs]:
        if err != 0:
            bad = a - err - 1
            raise IOError(f"native packer failed on {paths[bad]} (code {lengths[bad]})")


def pack_batch_native(paths, flips: np.ndarray, patch: int, max_len: int, dtok: int):
    """Pack ``paths`` -> (tokens (B,T,D) f32, mask (B,T) bool, hw (B,2) i32,
    lengths (B,) i32): each latent patchified, h-flipped where ``flips``
    says, and zero-padded (or cut) to ``max_len`` tokens."""
    lib = get_lib()
    n = len(paths)
    tokens = np.zeros((n, max_len, dtok), np.float32)
    mask = np.zeros((n, max_len), np.uint8)
    hw = np.zeros((n, 2), np.int32)
    lengths = np.zeros((n,), np.int32)
    flips = np.ascontiguousarray(flips, dtype=np.int32)
    if flips.shape != (n,):
        raise ValueError(f"flips has shape {flips.shape}, expected ({n},)")
    encoded = [os.fsencode(p) for p in paths]

    def pack(a: int, b: int) -> int:
        c_paths = (ctypes.c_char_p * (b - a))(*encoded[a:b])
        return lib.pack_batch(
            c_paths, _ptr(flips[a:b], ctypes.c_int), b - a, patch, max_len, dtok, _ptr(tokens[a:b], ctypes.c_float),
            _ptr(mask[a:b], ctypes.c_ubyte), _ptr(hw[a:b], ctypes.c_int), _ptr(lengths[a:b], ctypes.c_int),
        )

    _in_threads(n, pack, paths, lengths)
    return tokens, mask.astype(bool), hw, lengths


def pack_batch_gather_native(paths, flips: np.ndarray, gather: np.ndarray, patch: int, dtok: int):
    """Bucket packing: row ``j`` of sample ``i`` is its token ``gather[i, j]``,
    or a zero row (mask False) where that is -1. The caller draws the
    subsample permutations, so the random stream stays the numpy path's;
    C++ does the file reads, decode, flip, patchify and gather."""
    lib = get_lib()
    gather = np.ascontiguousarray(gather, dtype=np.int32)
    n, n_out = gather.shape
    if n != len(paths):
        raise ValueError(f"gather has {n} rows for {len(paths)} paths")
    flips = np.ascontiguousarray(flips, dtype=np.int32)
    if flips.shape != (n,):
        raise ValueError(f"flips has shape {flips.shape}, expected ({n},)")
    tokens = np.zeros((n, n_out, dtok), np.float32)
    mask = np.zeros((n, n_out), np.uint8)
    hw = np.zeros((n, 2), np.int32)
    lengths = np.zeros((n,), np.int32)
    encoded = [os.fsencode(p) for p in paths]

    def pack(a: int, b: int) -> int:
        c_paths = (ctypes.c_char_p * (b - a))(*encoded[a:b])
        return lib.pack_batch_gather(
            c_paths, _ptr(flips[a:b], ctypes.c_int), _ptr(gather[a:b], ctypes.c_int), b - a, n_out, patch, dtok,
            _ptr(tokens[a:b], ctypes.c_float), _ptr(mask[a:b], ctypes.c_ubyte), _ptr(hw[a:b], ctypes.c_int),
            _ptr(lengths[a:b], ctypes.c_int),
        )

    _in_threads(n, pack, paths, lengths)
    return tokens, mask.astype(bool), hw, lengths
