"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C interface and compiles, with
``nvcc`` for ``sm_90a`` (Hopper), into its own shared library, loaded
with ``ctypes``.  No PyTorch header is included, so a build takes
seconds.  Libraries are built at first use into ``_build/`` beside this
file (listed in ``.gitignore``); the file name carries a hash of the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source never loads a stale library.
Several sources build concurrently, one ``nvcc`` process each.

Nothing here runs at import: the CPU-only test environment has no
``nvcc`` and imports every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES: Tuple[str, ...] = ("flash_decode", "paged_flash_decode",
                            "dense_topk", "bm25", "flash_attention",
                            "ssd_scan", "grouped_gemm")
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-lineinfo", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    which = shutil.which("nvcc")
    cands += [which] if which else []
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only on a machine with the "
                       "CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Build every missing library, one ``nvcc`` per source, all started
    together.  Returns ``{name: {"seconds", "compiler_output"}}`` (the
    ``-Xptxas -v`` register / shared-memory report) for the sources
    built by this call.  Raises with the compiler's output on failure."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        # each process writes its own temp file, renamed into place
        # atomically, so concurrent builders never load a partial file
        tmp = library_path(n).with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for n, (tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, library_path(n))
        report[n] = {"seconds": time.perf_counter() - t0,
                     "compiler_output": out}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
