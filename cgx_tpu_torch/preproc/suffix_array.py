"""Suffix-array / LCP / interval-LCP-tree construction.

The reference builds these on the host CPU (DC3 skew algorithm + Kasai LCP + a
midpoint-interval LCP tree, ``SuffixArray.c:51-193``).  Because the extended token
string ends in a unique sentinel (max_id + 1) the suffix array is unique, so *any*
correct construction matches the reference's DC3 output exactly.  We provide:

* a fast C++ backend (``cgx_tpu_torch/preproc/native/sa_native.cpp``, built
  by ``native_build`` and loaded via ctypes) doing SA-IS + Kasai
  + the interval tree in native code — used when the shared library is built;
* a NumPy fallback (rank-doubling via ``np.lexsort`` for the SA; linear-time Kasai).

The interval tree ``lcpleft/lcpright`` is the reference's non-standard structure
(``SuffixArray.c:131-179``): for every canonical binary-search interval (L, R) of
[0, n-1] with midpoint M = (L+R)//2, ``lcpleft[M]`` = LCP of suffixes SA[L..M] interval
(min of lcp over (L, M]) and ``lcpright[M]`` likewise over (M, R].  It lets the GPU/TPU
binary search skip re-comparing prefixes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cgx_tpu_torch.preproc import native_build


@dataclasses.dataclass
class SAIndex:
    sa: np.ndarray        # int32 [n]
    rank: np.ndarray      # int32 [n]
    lcp: np.ndarray       # int32 [n]   lcp[i] = LCP(SA[i-1], SA[i]); lcp[0] = 0
    lcpleft: np.ndarray   # int32 [n]
    lcpright: np.ndarray  # int32 [n]


def suffix_array_numpy(s: np.ndarray) -> np.ndarray:
    """Rank-doubling suffix array over an int array with a unique max sentinel at the
    end (so all suffixes are distinct and the SA is unique)."""
    n = len(s)
    if n == 0:
        return np.empty(0, dtype=np.int32)
    rank = np.asarray(s, dtype=np.int64)
    k = 1
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        # recompute ranks
        r1 = rank[order]
        r2 = key2[order]
        new = np.empty(n, dtype=np.int64)
        changed = np.ones(n, dtype=bool)
        changed[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new[order] = np.cumsum(changed) - 1
        rank = new
        if rank[order[-1]] == n - 1:
            return order.astype(np.int32)
        k *= 2


def kasai_lcp(s: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Kasai LCP; lcp[i] = LCP between SA[i-1] and SA[i] (SuffixArray.c:157-168).

    The reference's comparison loop runs off the end of the token array into the DC3
    padding; equivalently we bound by n (the sentinel guarantees early mismatch).
    """
    n = len(s)
    rank = np.empty(n, dtype=np.int64)
    rank[sa] = np.arange(n)
    lcp = np.zeros(n, dtype=np.int32)
    h = 0
    s_ = np.asarray(s)
    for i in range(n):
        r = rank[i]
        if r > 0:
            j = sa[r - 1]
            m = n - max(i, j)
            while h < m and s_[i + h] == s_[j + h]:
                h += 1
            lcp[r] = h
            h = 0
    return lcp


def interval_lcp_tree(lcp: np.ndarray):
    """lcpleft/lcpright midpoint tree (SuffixArray.c:131-179), iterative post-order."""
    n = len(lcp)
    lcpleft = np.zeros(n, dtype=np.int32)
    lcpright = np.zeros(n, dtype=np.int32)
    if n < 2:
        return lcpleft, lcpright
    # Iterative emulation of recursion_lcp(0, n-1).
    # Returns min(lcp[L+1..R]) for interval (L, R) and fills midpoints.
    stack = [(0, n - 1, False)]
    results: dict = {}
    while stack:
        L, R, expanded = stack.pop()
        if L == R - 1:
            results[(L, R)] = int(lcp[R])
            continue
        M = (L + R) // 2
        if not expanded:
            stack.append((L, R, True))
            stack.append((L, M, False))
            stack.append((M, R, False))
        else:
            a = results.pop((L, M))
            b = results.pop((M, R))
            lcpleft[M] = a
            lcpright[M] = b
            results[(L, R)] = min(a, b)
    return lcpleft, lcpright


def build_index(s: np.ndarray, use_native: bool = True) -> SAIndex:
    s = np.ascontiguousarray(s, dtype=np.int32)
    lib = native_build.load_native() if use_native else None
    if lib is not None:
        sa, lcp, lcpleft, lcpright = native_build.native_build_index(lib, s)
    else:
        sa = suffix_array_numpy(s)
        lcp = kasai_lcp(s, sa)
        lcpleft, lcpright = interval_lcp_tree(lcp)
    rank = np.empty(len(s), dtype=np.int32)
    rank[sa] = np.arange(len(s), dtype=np.int32)
    return SAIndex(sa=sa, rank=rank, lcp=lcp, lcpleft=lcpleft, lcpright=lcpright)
