"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The build happens at first use, into
``build/fit_tpu_torch/`` at the repository root, and the library is named by
a hash of its source, the shared ``csrc/*.cuh`` headers and the flags, so
an edited source builds anew. Importing
this module needs no ``nvcc``; :func:`load` raises if there is none.

Each build keeps ptxas's ``-v`` report beside its library
(:func:`ptxas_log`): :func:`ptxas_usage` reads each kernel's registers and
spill bytes from it, and :func:`check_no_spill` fails on a spill.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict

__all__ = ["load", "nvcc_path", "ptxas_log", "ptxas_usage", "check_no_spill", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fit_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, else from ``PATH``, else from the
    toolkit's default prefix ``/usr/local/cuda``; raises if none exists."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels of fit_tpu_torch need the CUDA toolkit to build"
    )


def _stem(src: Path) -> str:
    """``<name>_<hash>``, the build's file name without its suffix."""
    # the shared headers count too: an edited header builds every source anew
    headers = b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return f"{src.stem}_{digest}"


def load(name: str, src_dir: Path = CSRC) -> ctypes.CDLL:
    """Compile ``<src_dir>/<name>.cu`` (``csrc/`` unless another tree's is
    given) if its library is not built yet, and load it."""
    src = Path(src_dir) / f"{name}.cu"
    if str(src) in _loaded:
        return _loaded[str(src)]
    stem = _stem(src)
    lib_path = BUILD_DIR / f"{stem}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build into a temporary name, then rename: a concurrent or cut-off
        # build never leaves a half-written library under the final name
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        (BUILD_DIR / f"{stem}.log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _loaded[str(src)] = lib
    return lib


def ptxas_log(name: str) -> str:
    """nvcc's output (ptxas ``-v``) of the build of ``csrc/<name>.cu``,
    built first if it is not yet."""
    load(name)
    return (BUILD_DIR / f"{_stem(CSRC / f'{name}.cu')}.log").read_text()


def ptxas_usage(log_text: str, pattern: str) -> Dict[tuple, Dict[str, int]]:
    """Registers and spill store / load bytes of each kernel instantiation
    in a ptxas ``-v`` log whose mangled name matches ``pattern``, keyed by
    the pattern's groups (a group of digits as an int)."""
    out, key = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inst = re.search(pattern, m.group(1))
            key = tuple(int(g) if g.isdigit() else g for g in inst.groups()) if inst else None
            if key:
                out[key] = {}
        elif key and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[key]["spill_stores"], out[key]["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif key and (m := re.search(r"Used (\d+) registers", line)):
            out[key]["registers"] = int(m.group(1))
    return out


def check_no_spill(usage: Dict[tuple, Dict[str, int]], expected: int, guarded: Callable[[tuple], bool]) -> None:
    """Raises unless ``usage`` holds ``expected`` instantiations and none
    for which ``guarded(key)`` holds spills."""
    spilled = sorted(k for k, info in usage.items()
                     if guarded(k) and (info.get("spill_stores"), info.get("spill_loads")) != (0, 0))
    if len(usage) != expected or spilled:
        raise RuntimeError(f"{len(usage)} of {expected} instantiations in the ptxas log; spills at {spilled}")
