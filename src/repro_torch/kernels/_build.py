"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each source under ``repro_torch/csrc/`` is compiled by ``nvcc`` into its
own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds); headers shared between sources (``csrc/*.cuh``) are
included by the sources that need them.  All sources build at once, one
``nvcc`` process each, started together.  A library's file name carries a
hash of its source, the shared headers and the flags, so an edited source
or header rebuilds and an unchanged one is reused.  The libraries land in ``build/kernels/`` at the root of the
checkout.  Nothing here runs at import time: the CPU tests import every
module, and there is no ``nvcc`` on a machine without the toolkit.
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

__all__ = ["SOURCES", "build_all", "library", "build_log"]

_ROOT = Path(__file__).resolve().parents[3]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = _ROOT / "build" / "kernels"
SOURCES = {"gathered_matmul": "gathered_matmul.cu",
           "gather_rows": "gather_rows.cu",
           "paged_decode": "paged_decode.cu",
           "flash_attention": "flash_attention.cu",
           "flash_decode": "flash_decode.cu",
           "hlog_qmatmul": "hlog_qmatmul.cu",
           "local_similarity": "local_similarity.cu",
           "spls_plan": "spls_plan.cu"}
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    # the source, the shared headers (csrc/*.cuh) and the flags
    src = (CSRC / SOURCES[name]).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``name``'s current source."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all() -> float:
    """Compile every source whose library is missing, all at once.
    Returns the wall seconds spent; raises with the compiler's output if a
    build fails."""
    todo = [n for n in SOURCES if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = _target(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        if not _target(name).exists():
            build_all()
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib
