"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source compiles to an object with its own ``nvcc`` process, all
started together; the objects link into one shared library with a plain C
interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu
    nvcc -shared -o build/volcano_tpu_torch/libvtt_kernels.so *.o

``--fmad=false`` keeps nvcc from contracting products into fused
multiply-adds; the sources write out the few fused operations the
reference performs (see ``scheduler/kernels.py``).  A failed build raises
with the compiler's output.  ``ptxas_report()`` returns ``-Xptxas -v``'s
register and shared-memory lines from the build.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = ("water_fill.cu", "allocate_solve.cu", "allocate_batch.cu")
BUILD_DIR = _PKG.parent / "build" / "volcano_tpu_torch"
LIB_NAME = "libvtt_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_report: List[str] = []


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile every source in parallel and link the library; returns its
    path.  Raises RuntimeError with the compiler output on failure."""
    nvcc = _nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        obj = build_dir / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, failed = [], []
    _report.clear()
    for src, obj, p in procs:
        out, _ = p.communicate()
        _report.extend(f"{src}: {line}" for line in out.splitlines()
                       if "registers" in line or "Compiling entry" in line
                       or "spill" in line)
        if p.returncode:
            failed.append(f"--- {src} (exit {p.returncode})\n{out}")
        objs.append(str(obj))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    lib = build_dir / LIB_NAME
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(lib), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures (pointers and the stream as
    c_void_p, so ctypes never truncates them to 32 bits)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.vtt_water_fill.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp]
    lib.vtt_water_fill.restype = ci
    for fn in (lib.vtt_allocate_solve, lib.vtt_allocate_solve_batch):
        fn.argtypes = [vp, vp]
        fn.restype = ci
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build())))
        return _lib


def ptxas_report() -> List[str]:
    return list(_report)
