"""Build and load the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` (H100),
one ``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, at first use, into ``_build/`` beside
this file, and loaded with ``ctypes``.  Nothing is built or loaded when the
module is imported: the CPU tests import every module and this machine
class has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import List, Optional

from .utils.spans import timed

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libbdf_torch_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]


_lib: Optional[ctypes.CDLL] = None
# what the build in this process did: seconds (None when an up-to-date
# library was reused) and the compiler's output
_report: dict = {"seconds": None, "log": ""}


def sources() -> List[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _run_all(cmds: List[List[str]]) -> str:
    """Run the commands concurrently; return their joined output, or raise
    with it if any failed (every process is waited for either way)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    bad = [(c[-1], p.returncode) for c, p in zip(cmds, procs)
           if p.returncode != 0]
    if bad:
        raise RuntimeError(f"nvcc failed for {bad}:\n{log}")
    return log


def build() -> str:
    """Compile ``csrc/*.cu`` into ``_build/`` unless an up-to-date library
    is there (newer than every source and header); returns the library
    path.  The library is linked to a temporary name and renamed, so
    concurrent processes never load a half-written file."""
    srcs = sources()
    deps = srcs + [os.path.join(CSRC, f) for f in os.listdir(CSRC)
                   if f.endswith(".cuh")]
    if (os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH)
            >= max(os.path.getmtime(s) for s in deps)):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with timed("bdf.build.nvcc") as t, \
            tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", o,
                         s] for s, o in zip(srcs, objs)])
        lib = os.path.join(tmp, "lib.so")
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, LIB_PATH)
    _report["seconds"] = t.seconds
    _report["log"] = log
    return LIB_PATH


def load() -> ctypes.CDLL:
    """The kernel library (built on first call), with its C signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, ll, d, i = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double,
                       ctypes.c_int)
        for fn in (lib.bdf_chol_sample_packed_f32,
                   lib.bdf_chol_sample_packed_f64,
                   lib.bdf_chol_sample_packed_slab_f32,
                   lib.bdf_chol_sample_packed_slab_f64):
            fn.restype = i
            fn.argtypes = [p, ll, ll, p, d, p, ll, ll, p, p, i, i, p]
        for fn in (lib.bdf_chol_inv_f32, lib.bdf_chol_inv_f64):
            fn.restype = i
            fn.argtypes = [p, ll, ll, p, i, i, p]
        for fn in (lib.bdf_chol_sample_full_f32,
                   lib.bdf_chol_sample_full_f64,
                   lib.bdf_chol_sample_full_slab_f32,
                   lib.bdf_chol_sample_full_slab_f64):
            fn.restype = i
            fn.argtypes = [p, p, d, p, p, p, i, i, p]
        lib.bdf_ytab_quantize.restype = i
        lib.bdf_ytab_quantize.argtypes = [p, ll, ll, i, ctypes.c_float, p, p,
                                          p, ll, p]
        lib.bdf_fused_pair_i8.restype = i
        lib.bdf_fused_pair_i8.argtypes = [p, ll, ll, i, p, i, i, ll, i, p, p,
                                          p, p, p, p, p, p]
        lib.bdf_fused_pair_f.restype = i
        lib.bdf_fused_pair_f.argtypes = [p, ll, ll, i, p, i, i, i, ll, i, p,
                                         p, p]
        lib.bdf_split_f32.restype = i
        lib.bdf_split_f32.argtypes = [p, ll, p, p]
        lib.bdf_pair_contract_i8.restype = i
        lib.bdf_pair_contract_i8.argtypes = [p, p, ll, ll, i, p, i, i, ll, i,
                                             p, p, p, p, p, p, p]
        lib.bdf_windowed_expand.restype = i
        lib.bdf_windowed_expand.argtypes = [p, ll, i, p, p, ll, p, p]
        lib.bdf_gather_gram.restype = i
        lib.bdf_gather_gram.argtypes = [p, ll, p, ll, i, i, p, p, p, p, ll, i,
                                        i, p, p, p, p, ll, p]
        _lib = lib
    return _lib


def ptxas_lines(log: str, kernel: str) -> List[str]:
    """The lines of a build log (``-Xptxas -v``) about the entry functions
    whose mangled name contains ``kernel``: each one's registers, shared
    memory and spills, and any C75xx note ptxas prints for it (a wgmma it
    serialized, which costs the kernel its overlap)."""
    out, cur = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = line
        if "C75" in line:
            if kernel in line:
                out.append(line.strip())
        elif kernel in cur and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def build_report() -> dict:
    """Seconds and compiler output (``-Xptxas -v``: registers, shared
    memory, spills) of the build this process ran; ``seconds`` is None when
    an up-to-date library was reused."""
    return dict(_report)
