"""Build and load the port's hand-written CUDA kernels.

Each `csrc/*.cu` file is one kernel with a plain C interface.  At first
use it is compiled with `nvcc` for `sm_90a` into a shared library under
`kernels/_build/` (listed in `.gitignore`) and loaded with `ctypes`;
the library name carries a hash of the source, so an edited source is
rebuilt and an unchanged one is reused.  `build_all()` starts one
`nvcc` per source, all at once.

`launches` counts kernel launches by name.  Each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its
path went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start `nvcc` for one source unless its library is current;
    returns (library path, process or None)."""
    src, lib = _target(name)
    if lib.exists():
        return lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return lib, (proc, tmp)


def _finish(name: str, lib: Path, job) -> str:
    if job is None:
        return ""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return log


def build_all() -> Dict[str, str]:
    """Compile every kernel source in parallel; returns nvcc's output
    (register and shared-memory use) per kernel, "" where current."""
    jobs = [(n, *_start(n)) for n in kernel_names()]
    return {n: _finish(n, lib, job) for n, lib, job in jobs}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, job = _start(name)
            _finish(name, path, job)
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))
