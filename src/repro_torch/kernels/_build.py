"""Build, load and launch the port's CUDA kernels.

Each kernel's source under ``<kernel>/csrc/`` is compiled by ``nvcc`` into
a shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <src>

Libraries are built at first use from the sources in the checkout, into
``build/kernels/`` at the repository root (listed in ``.gitignore``). The
file name carries a hash of the source, the headers beside it, the shared
headers under ``kernels/csrc/`` and the flags, so an edited kernel is
rebuilt. The compiler log (with ptxas' register and shared-memory report)
is kept beside the library as ``<name>-<hash>.log``. ``build`` runs one ``nvcc`` per missing library,
all started together, each under its own time limit.

The kernel wrappers (``<kernel>/ops.py``) share the rest: ``launcher``
gives a kernel's C launch function with its signature set, ``device_of``
the one device of a wrapper's inputs (a CPU tensor takes the plain
version, a CUDA tensor the kernel), and ``DTYPE_CODES`` the dtype codes
the launch functions take.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

_KERNELS = Path(__file__).resolve().parent
SOURCES: Dict[str, Path] = {
    "decode_attention":
        _KERNELS / "decode_attention" / "csrc" / "decode_attention.cu",
    "paged_decode_attention":
        _KERNELS / "decode_attention" / "csrc" / "paged_decode_attention.cu",
    "paged_verify_attention":
        _KERNELS / "decode_attention" / "csrc" / "paged_verify_attention.cu",
    "flash_attention":
        _KERNELS / "flash_attention" / "csrc" / "flash_attention.cu",
    "bottleneck_encode":
        _KERNELS / "bottleneck" / "csrc" / "bottleneck_encode.cu",
    "bottleneck_decode":
        _KERNELS / "bottleneck" / "csrc" / "bottleneck_decode.cu",
    "ssm_scan": _KERNELS / "ssm_scan" / "csrc" / "ssm_scan.cu",
}
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

# the dtype codes of the launch functions' ``dtype`` arguments
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_loaded: Dict[str, ctypes.CDLL] = {}
_launchers: Dict[str, ctypes._CFuncPtr] = {}


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
    for header in sorted([*src.parent.glob("*.cuh"),
                          *(_KERNELS / "csrc").glob("*.cuh")]):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _compile(nvcc: str, name: str) -> bool:
    """One ``nvcc`` run for ``name``, its log beside the library; the
    library appears under its final name only once it is complete."""
    out = library_path(name)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    with open(out.with_suffix(".log"), "w") as log:
        try:
            rc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                                 str(SOURCES[name])], stdout=log,
                                stderr=subprocess.STDOUT,
                                timeout=NVCC_TIMEOUT_S).returncode
        except subprocess.TimeoutExpired:
            rc = -1
    if rc == 0:
        os.replace(tmp, out)
    return rc == 0


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile every missing library of ``names`` (default: all), one
    ``nvcc`` each, all started together. Returns the seconds the builds
    took (0.0 when nothing was missing); raises with the compiler log of
    the first that fails."""
    todo = [n for n in (SOURCES if names is None else names)
            if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(todo)) as pool:
        ok = list(pool.map(lambda n: _compile(nvcc, n), todo))
    failed = [n for n, good in zip(todo, ok) if not good]
    if failed:
        name = failed[0]
        raise RuntimeError(f"nvcc failed for {failed}; log of {name}:\n"
                           + library_path(name).with_suffix(".log")
                           .read_text())
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is missing."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def launcher(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The kernel's C function ``{name}_launch`` with its argument types
    set (pointers and the stream as ``c_void_p``, so ctypes does not cut
    them to 32 bits); it returns the launch's CUDA error, 0 on success."""
    fn = _launchers.get(name)
    if fn is None:
        fn = getattr(load(name), f"{name}_launch")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _launchers[name] = fn
    return fn


def device_of(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one device of a wrapper's inputs: cuda or cpu; raises
    otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on different devices: {devices}")
    device = devices.pop()
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {device.type}")
    return device
