"""Build and load the port's CUDA kernels.

Each kernel's source under ``<kernel>/csrc/`` is compiled by ``nvcc`` into
a shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <src>

Libraries are built at first use from the sources in the checkout, into
``build/kernels/`` at the repository root (listed in ``.gitignore``). The
file name carries a hash of the source and flags, so an edited kernel is
rebuilt. The compiler log (with ptxas' register and shared-memory report)
is kept beside the library as ``<name>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_KERNELS = Path(__file__).resolve().parent
SOURCES: Dict[str, Path] = {
    "decode_attention":
        _KERNELS / "decode_attention" / "csrc" / "decode_attention.cu",
}
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and "
                           "PATH); the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> float:
    """Compile the kernel's library if it is missing. Returns the seconds
    ``nvcc`` took (0.0 when the library was already built); raises with
    the compiler log if it fails."""
    out = library_path(name)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    log = out.with_suffix(".log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                             str(SOURCES[name])], stdout=f,
                            stderr=subprocess.STDOUT,
                            timeout=NVCC_TIMEOUT_S).returncode
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log.read_text()}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is missing."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
