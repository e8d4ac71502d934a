"""Build the CUDA sources of ``act3d_tpu_torch/csrc`` with nvcc and load
them with ctypes.

Each source is compiled on first use into a shared library with a plain
C interface, under ``act3d_tpu_torch/_build/`` (listed in .gitignore),
named by a hash of the source, every header of ``csrc/`` and the flags, so
an edited source or shared header rebuilds.  Nothing here runs at import
time.  ``NVCC_SECONDS`` counts the host seconds this process waited on
nvcc, ``LOAD_SECONDS`` those it spent loading the libraries besides
(hashing the sources, ``ctypes``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("fused_mha_fwd.cu", "fused_mha_bwd.cu", "scatter_rows.cu")
HEADER_SUFFIXES = (".cuh", ".h")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
NVCC_SECONDS = 0.0  # host seconds build() waited on nvcc in this process
LOAD_SECONDS = 0.0  # host seconds in load()'s first call of each source, nvcc's left out


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if cuda_home:
        candidates.insert(0, os.path.join(cuda_home, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: str) -> Path:
    """Library of one source, named by a hash of the source, of every
    header in CSRC_DIR (name and bytes) and of the flags."""
    h = hashlib.sha256((CSRC_DIR / source).read_bytes())
    for header in sorted(p for p in CSRC_DIR.iterdir() if p.suffix in HEADER_SUFFIXES):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source not yet built, one nvcc per source, all started
    together.  Returns {source: library path}; raises on a failed build.
    The ptxas report (registers, shared memory, spills) of each build is
    kept beside the library as ``<name>.log``."""
    global NVCC_SECONDS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: library_path(s) for s in sources}
    todo = {s: p for s, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for s, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / s)]
        procs[s] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for s, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        todo[s].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{s} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, todo[s])
    NVCC_SECONDS += time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, building it if needed."""
    global LOAD_SECONDS
    lib = _LOADED.get(source)
    if lib is None:
        t0, nvcc0 = time.perf_counter(), NVCC_SECONDS
        lib = ctypes.CDLL(str(build([source])[source]))
        LOAD_SECONDS += time.perf_counter() - t0 - (NVCC_SECONDS - nvcc0)
        _LOADED[source] = lib
    return lib
