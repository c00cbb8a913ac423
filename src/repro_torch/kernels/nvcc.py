"""Build a kernel source with ``nvcc`` at first use and load it with ctypes.

Each ``csrc/*.cu`` file is compiled on its own for ``sm_90a`` into a shared
library with a plain C interface, under ``kernels/build/`` (git-ignored),
named by the hash of the source, of every ``csrc`` header it includes
(``#include "..."``, followed through headers) and of the flags, so an
edited source or header is rebuilt. The compiler's output (registers, spills) is kept beside the
library as ``<library>.log``. Nothing here runs when a module is imported.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the port's kernels are built from source")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _source_bytes(source: str, seen=None) -> bytes:
    """The bytes of ``source`` followed by those of each local header it
    includes, depth first, each file once."""
    seen = set() if seen is None else seen
    seen.add(source)
    with open(source, "rb") as f:
        data = f.read()
    out = [data]
    for name in _INCLUDE.findall(data):
        header = os.path.join(os.path.dirname(source), name.decode())
        if header not in seen:
            out.append(_source_bytes(header, seen))
    return b"".join(out)


def library_path(source: str) -> str:
    digest = hashlib.sha256(_source_bytes(source)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest[:16]}.so")


def build(source: str) -> str:
    """Compile ``source`` unless a build of it exists; return the library path."""
    path = library_path(source)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{r.stdout}{r.stderr}"
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{log}")
    with open(path + ".log", "w") as f:
        f.write(f"{log}\nbuild_s={time.perf_counter() - t0:.3f}\n")
    os.replace(tmp, path)
    return path
