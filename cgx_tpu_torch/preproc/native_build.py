"""Build/load the native host library (ctypes).

The C++ source is the port's own ``native/sa_native.cpp`` beside this module
(a copy of the JAX package's), compiled with ``g++`` at first use into
``build/cgx_tpu_torch/`` at the repository root.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "sa_native.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "cgx_tpu_torch")
_SO = os.path.join(BUILD_DIR, "libcgx_native.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _compile() -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, _SO)
    return True


def load_native():
    """Returns the ctypes library, compiling on first use; None when g++ or
    the source is unavailable (callers then take their numpy paths)."""
    global _lib, _tried
    with _lock:
        if _lib is not None:
            return _lib
        if _tried or not os.path.exists(_SRC):
            return None
        _tried = True
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _compile():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.cgx_build_sa.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32, i32p]
        lib.cgx_build_sa.restype = ctypes.c_int
        lib.cgx_build_lcp.argtypes = [i32p, i32p, ctypes.c_int64, i32p]
        lib.cgx_build_lcp.restype = ctypes.c_int
        lib.cgx_build_interval_tree.argtypes = [i32p, ctypes.c_int64, i32p, i32p]
        lib.cgx_build_interval_tree.restype = ctypes.c_int
        lib.cgx_tokenize.argtypes = [
            ctypes.c_char_p, ctypes.c_long, i32p, i32p, i64p, i32p,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)]
        lib.cgx_tokenize.restype = ctypes.c_long
        lib.cgx_format_rule_lines.argtypes = [
            ctypes.c_char_p, i64p, f32p, f32p, f32p, f32p, f32p, i64p, i64p,
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64, i64p]
        lib.cgx_format_rule_lines.restype = ctypes.c_int64
        lib.cgx_dedup_rules.argtypes = [
            i64p, i64p, i64p, i64p, i64p, i64p, i64p, ctypes.c_int64,
            i32p, ctypes.c_int64, i64p, i64p, i32p]
        lib.cgx_dedup_rules.restype = ctypes.c_int64
        _lib = lib
        return _lib


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def native_build_index(lib, s: np.ndarray):
    n = len(s)
    sa = np.empty(n, dtype=np.int32)
    lcp = np.empty(n, dtype=np.int32)
    lcpleft = np.empty(n, dtype=np.int32)
    lcpright = np.empty(n, dtype=np.int32)
    K = int(s.max()) if n else 0
    lib.cgx_build_sa(_i32ptr(s), n, K, _i32ptr(sa))
    lib.cgx_build_lcp(_i32ptr(s), _i32ptr(sa), n, _i32ptr(lcp))
    lib.cgx_build_interval_tree(_i32ptr(lcp), n, _i32ptr(lcpleft), _i32ptr(lcpright))
    return sa, lcp, lcpleft, lcpright
