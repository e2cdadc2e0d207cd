"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source compiles to an object with its own ``nvcc`` process, all
started together; the objects link into one shared library with a plain C
interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu
    nvcc -shared -o build/volcano_tpu_torch/libvtt_kernels-<hash>.so *.o

The library's name carries a hash of the sources and the flags: a process
finds the library another process of the same checkout built from the same
sources and loads it (the multi-controller workers of
``parallel/multihost.py`` do); a build compiles into a directory of its own
and moves the finished library into place, so two processes never write
one file.

``--fmad=false`` keeps nvcc from contracting products into fused
multiply-adds; the sources write out the few fused operations the
reference performs (see ``scheduler/kernels.py``).  A failed build raises
with the compiler's output.  ``ptxas_report()`` returns ``-Xptxas -v``'s
register and shared-memory lines from the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

from volcano_tpu_torch import vtprof

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = ("water_fill.cu", "allocate_solve.cu", "allocate_batch.cu",
           "reclaim_solve.cu", "preempt_solve.cu", "preempt_rounds.cu",
           "victim_step.cu")
BUILD_DIR = _PKG.parent / "build" / "volcano_tpu_torch"
LIB_STEM = "libvtt_kernels"
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


def lib_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of these sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return build_dir / f"{LIB_STEM}-{h.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile every source in parallel and link the library; returns its
    path.  Raises RuntimeError with the compiler output on failure."""
    nvcc = _nvcc()
    target = lib_path(build_dir)
    work = build_dir / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        obj = work / (Path(src).stem + ".o")
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
    lib = work / f"{LIB_STEM}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(lib), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(lib, target)
    shutil.rmtree(work, ignore_errors=True)
    return target


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures (pointers and the stream as
    c_void_p, so ctypes never truncates them to 32 bits)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.vtt_water_fill.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp, vp]
    lib.vtt_water_fill.restype = ci
    for fn in (lib.vtt_allocate_solve, lib.vtt_reclaim_solve, lib.vtt_preempt_solve):
        fn.argtypes = [vp, vp]
        fn.restype = ci
    # the batch solve's round loop runs on the host: (base args, the local
    # blocks' args, their count, stream)
    for fn in (lib.vtt_batch_begin, lib.vtt_batch_candidates, lib.vtt_batch_decide):
        fn.argtypes = [vp, vp, ci, vp]
        fn.restype = ci
    cl = ctypes.c_longlong
    # the victim groups: (args, live mask, eviction kind, stream)
    lib.vtt_victim_groups.argtypes = [vp, vp, ci, vp]
    lib.vtt_victim_groups.restype = ci
    # K7: (args, outputs, t_cls, jt, qt, mode, stream)
    lib.vtt_victim_step.argtypes = [vp, vp, ci, ci, ci, ci, vp]
    lib.vtt_victim_step.restype = ci
    # K12b: (base, device block constants, block inputs, outputs, count,
    # t_cls, jt, qt, mode, send, stream) and (base, outputs, recv, S, first
    # local row, local rows, t_cls, jt, qt, mode, stream)
    lib.vtt_victim_blocks_core.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp]
    lib.vtt_victim_blocks_core.restype = ci
    lib.vtt_victim_blocks_apply.argtypes = [vp, vp, vp, ci, cl, cl, ci, ci, ci, ci, vp]
    lib.vtt_victim_blocks_apply.restype = ci
    # K15a / K15b walks: begin and step (base, device blocks, count,
    # pending, stream), and the blocks' cores (device blocks, count, rows a
    # block, CTA records, tickets, stream)
    for fn in (lib.vtt_reclaim_blocks_begin, lib.vtt_preempt_blocks_begin,
               lib.vtt_reclaim_blocks_step, lib.vtt_preempt_blocks_step):
        fn.argtypes = [vp, vp, ci, vp, vp]
        fn.restype = ci
    lib.vtt_walk_blocks_core.argtypes = [vp, ci, ci, vp, vp, vp]
    lib.vtt_walk_blocks_core.restype = ci
    # K10 / K15c rounds: begin (base, blocks, count, ctl out, stream), the
    # two halves of a round (base, blocks, count, stream), finish (base,
    # ctl out, stream)
    lib.vtt_rounds_begin.argtypes = [vp, vp, ci, vp, vp]
    lib.vtt_rounds_begin.restype = ci
    for fn in (lib.vtt_rounds_candidates, lib.vtt_rounds_decide):
        fn.argtypes = [vp, vp, ci, vp]
        fn.restype = ci
    lib.vtt_rounds_finish.argtypes = [vp, vp, vp]
    lib.vtt_rounds_finish.restype = ci
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use unless a library
    of the same sources is already built."""
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not path.exists():
                path = build()
                # a build is compile work: vtprof's launch-shape registry
                # counts it (a steady cycle must never see one)
                vtprof.note_compile("kernel_library")
            _lib = bind(ctypes.CDLL(str(path)))
        return _lib


def ptxas_report() -> List[str]:
    return list(_report)
