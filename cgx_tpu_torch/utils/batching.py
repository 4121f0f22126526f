"""Power-of-two bucket padding of the index arrays (from ``cgx_tpu/utils/batching.py``).

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
