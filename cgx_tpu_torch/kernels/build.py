"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` on first use into a shared
library with a plain C interface under ``build/cgx_tpu_torch/`` at the
repository root, and loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  Every C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; ``check`` turns a non-zero code into an
exception.  Nothing here runs at import time: the CPU tests import every
module of the package on a machine without ``nvcc``.

``LAUNCHES`` counts launches per kernel id (the ids of the JAX package's
device kernels: A1, A2f and A2b for A2's forward and backward scans, A3,
A4, A5, A6, A7, A8, A9, A10, B1p1 and B1p2 for B1's two passes, and the
sharded index's B2r and B2g (refinement, SA gather) and B3f, B3b, B3p, B3t
and B3c (the per-item scans, verification, second-gap scan and contiguous
extraction), the column-upload lookups' C1f, C1b, C1p and C1t, the
query-DP step's B4 (one per shard) and the gather probe's P1 and P2); A4,
A7 and A8 count as A4v, A7v and A8v when they read a shard's
``OffsetView``s (``launch_id``).  A wrapper adds one right after it launched
its kernel, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cgx_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_V = [_P, _I, _I, _I]   # a view: words, local length, global offset, length
# C entry points per source file: name -> argtypes (pointers and the stream as
# c_void_p, so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "refine": {
        "cgx_refine": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                       _P, _P, _P, _P, _P],
    },
    "lcp": {
        "cgx_pass1": [_P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _P, _I, _I, _P,
                      _P],
        "cgx_pass2": [_P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P,
                      _I, _P, _P],
    },
    "gapcheck": {
        "cgx_gap_check": _V + _V + [_P, _I, _I, _I, _I, _P, _P],
    },
    "scan": {
        "cgx_scan": [_P, _I, _P, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I,
                     _I, _P, _P],
        "cgx_pcs": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _P, _P],
        "cgx_two": [_P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _P, _P, _I, _I,
                    _I, _I, _P, _P],
        "cgx_fwd_items": _V * 3 + [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P,
                                   _P],
        "cgx_bwd_items": _V * 3 + [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P,
                                   _P],
        "cgx_pcs_items": _V + [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P,
                               _P],
        "cgx_two_items": _V * 3 + [_P, _P, _I, _I, _I, _P, _P],
        "cgx_scan_cols": [_P, _I, _P, _I, _P, _I] + [_P] * 6
                         + [_I, _I, _I, _I, _P, _P],
        "cgx_pcs_cols": [_P, _I] + [_P] * 8 + [_I, _I, _P, _P],
        "cgx_two_packed": [_P, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _P,
                           _P],
    },
    "contig": {
        "cgx_contig": [_P, _I, _P, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I,
                       _P, _P],
        "cgx_contig_pos": _V * 3 + [_P, _P, _I, _I, _I, _P, _P],
    },
    "onegap": {
        "cgx_onegap": _V * 3 + [_P, _P, _P, _P, _I, _I, _I, _P, _P],
    },
    "twogap": {
        "cgx_twogap": _V * 3 + [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    },
    "sharded": {
        "cgx_refine_sharded": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I,
                               _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                               _P],
        "cgx_gather_sa_sharded": [_P, _P, _I, _I, _I, _P, _I, _P, _P],
    },
    "dist": {
        "cgx_dp_step": [_P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _I, _P, _I,
                        _P, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    },
    "probe": {
        "cgx_probe_sum": [_P, _I, _P, _I, _I, _P, _P],
        "cgx_probe_rows": [_P, _I, _P, _I, _I, _P, _P],
    },
    "maxlex": {
        "cgx_maxlex_dense": [_P, _P, _I, _I, _P, _I, _F, _P, _P, _P, _P, _P,
                             _P, _P, _I, _P, _P, _P],
        "cgx_maxlex_range": [_P, _P, _I, _P, _P, _P, _I, _I, _P, _I, _F, _P,
                             _P, _P, _P, _P, _P, _P, _I, _P, _P, _P],
    },
}

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the port's "
                           "kernels are compiled with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _so_path(name: str) -> str:
    """Library path keyed by the sources' and flags' content hash, so an
    edited kernel is never served from a stale build."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        if f == f"{name}.cu" or f.endswith(".cuh"):
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _compile_cmd(name: str, out: str) -> list:
    return [_nvcc(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC, f"{name}.cu")]


def build(names=None) -> float:
    """Compile the named kernels (default: all) that are not built yet, in
    parallel; returns the seconds taken.  The compiler's register and spill
    report goes to ``<library>.ptxas.txt`` beside each library."""
    names = list(SIGNATURES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in names:
        so = _so_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        procs.append((name, so, tmp, subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            errors.append(f"{name}.cu:\n{log}")
            continue
        with open(so + ".ptxas.txt", "w", encoding="utf-8") as fh:
            fh.write(log)
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_so_path(name))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.cgx_error_string.argtypes = [ctypes.c_int]
            lib.cgx_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def view(v) -> tuple:
    """A kernel's view arguments (words, local length, global offset, global
    length) of an ``OffsetView`` or of a whole tensor (an identity view)."""
    if isinstance(v, torch.Tensor):
        return ptr(v), v.shape[0], 0, v.shape[0]
    return ptr(v.arr), v.arr.shape[0], int(v.off), int(v.glen)


def launch_id(kernel: str, v) -> str:
    """The launch id of ``kernel`` reading the corpus through ``v``:
    ``kernel + "v"`` on a shard's ``OffsetView``, else ``kernel``."""
    return kernel if isinstance(v, torch.Tensor) else kernel + "v"


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(lib_name: str, rc: int) -> None:
    """Raise on a refused or failed launch (the C entry returned
    ``cudaGetLastError()``)."""
    if rc != 0:
        msg = library(lib_name).cgx_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel in {lib_name}.cu: error {rc} ({msg})")


def check_inputs(kernel: str, device: torch.device, dtype: torch.dtype,
                 **tensors) -> None:
    """Every tensor a kernel reads (or the slice under a view) must be
    contiguous, on ``device`` and of the dtype its C signature declares."""
    for arg, t in tensors.items():
        t = getattr(t, "arr", t)
        if t.device != device:
            raise ValueError(f"{kernel}: {arg} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{kernel}: {arg} has dtype {t.dtype}, "
                             f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {arg} is not contiguous")


def check_count(kernel: str, n: int) -> None:
    """The C entry points take item counts as int32."""
    if not 0 <= n < 2**31:
        raise ValueError(f"{kernel}: {n} items do not fit in int32")


def route(kernel: str, device: torch.device) -> bool:
    """True: launch the CUDA kernel; False: the tensors lie on the CPU, take
    the plain PyTorch version.  Any other device is refused."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{kernel}: no kernel for device {device}")
