"""The port's native host builder: ``layout.cpp`` built and bound with ctypes.

The port's own copy of the JAX package's ``native/`` (the bucketed layout
builder and the SBM1 reader and writer).  The source is compiled by the
host C++ compiler (``$CXX``, else ``g++``) with ``-O3 -fPIC -shared`` at
first use, into ``_build/`` beside the CUDA kernel library, and loaded
with ``ctypes``; nothing is built or loaded when the module is imported.
A library newer than the source is reused.  The build writes a temporary
file and renames it into place, so processes building at once never load
a half-written library.  A failed build raises with the compiler's output:
there is no fallback to the NumPy builders, which stay as the plain
versions the tests hold the library against.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Optional

from ..utils.spans import timed

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "layout.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libbdf_native.so")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
# seconds the build in this process took (None: an up-to-date library)
_report: dict = {"seconds": None}

_i64, _i32 = ctypes.c_int64, ctypes.c_int32
_p_i64 = ctypes.POINTER(ctypes.c_int64)
_p_i32 = ctypes.POINTER(ctypes.c_int32)
_p_f32 = ctypes.POINTER(ctypes.c_float)
_p_f64 = ctypes.POINTER(ctypes.c_double)


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (set CXX or put g++ on PATH): "
                           "the native layout builder needs one")
    return cxx


def build(src: str = SOURCE, out: str = LIB_PATH) -> str:
    """Compile ``src`` into the shared library ``out`` unless one newer
    than the source is there; returns ``out``.  Raises RuntimeError with
    the compiler's output when it fails."""
    if (os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(src)):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with timed("bdf.build.native") as t:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
        os.close(fd)
        try:
            proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"the native builder's source {src} did "
                                   f"not compile:\n{proc.stdout}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    _report["seconds"] = t.seconds
    return out


def build_seconds() -> Optional[float]:
    """Seconds of the build this process ran (None: a library was
    reused)."""
    return _report["seconds"]


def lib() -> ctypes.CDLL:
    """The native library (built on first call), with its C signatures."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(build())
        L.bdf_plan_layout.restype = _i64
        L.bdf_plan_layout.argtypes = [_i64, _i32, _i32, _i64, _p_i32,
                                      _p_i64, _i32, _p_i64, _p_i64]
        L.bdf_fill_layout.restype = _i32
        L.bdf_fill_layout.argtypes = [
            _i64, _i32, _i32, _i64, _p_i32, _p_f64, ctypes.c_double,
            _p_i64, _i32, _p_i64, ctypes.POINTER(_p_i32),
            ctypes.POINTER(_p_i32), ctypes.POINTER(_p_f32),
            ctypes.POINTER(_p_f32)]
        L.bdf_read_sbm_header.restype = _i64
        L.bdf_read_sbm_header.argtypes = [ctypes.c_char_p, _p_i64]
        L.bdf_read_sbm.restype = _i32
        L.bdf_read_sbm.argtypes = [ctypes.c_char_p, _i64, _p_i32, _p_i32]
        L.bdf_write_sbm.restype = _i32
        L.bdf_write_sbm.argtypes = [ctypes.c_char_p, _i64, _i64, _i64,
                                    _p_i32, _p_i32]
        _lib = L
    return _lib
