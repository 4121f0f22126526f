"""Power-of-two bucket padding of the index arrays (from ``cgx_tpu/utils/batching.py``),
and ``in_calls``, which cuts a launch's item columns into calls of a fixed
most, so that a launch's device memory follows that size and not the
request's.

The CUDA kernels take their lengths at run time, so the port needs none of the
JAX package's per-shape program ladder.  The padding itself is kept: every
kernel clamps its reads to ``len - 1`` of these padded arrays, exactly as the
JAX gathers do, so a different padding would change which word a clamped read
returns.
"""

from __future__ import annotations

import numpy as np

MIN_BUCKET = 64


def bucket_size(n: int) -> int:
    if n <= MIN_BUCKET:
        return MIN_BUCKET
    return 1 << (n - 1).bit_length()


def pad_tokens(tokens: np.ndarray, fill) -> np.ndarray:
    """Bucket-pad a token array with a fill value."""
    n = len(tokens)
    m = bucket_size(n)
    if m == n:
        return tokens
    return np.concatenate([tokens, np.full(m - n, fill, tokens.dtype)])


def in_calls(call, size: int, *cols):
    """``call(*cols)`` over consecutive slices of at most ``size`` items
    (rows of the columns) -> its output columns (numpy arrays), each
    concatenated in item order."""
    n = len(cols[0])
    if n <= size:
        return call(*cols)
    parts = [call(*(c[lo:lo + size] for c in cols))
             for lo in range(0, n, size)]
    return tuple(np.concatenate(p) for p in zip(*parts))
