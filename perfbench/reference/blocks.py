"""Host stage: contiguous-block dedup (GenerateBlocks, ExtractPair.cu:2742-2903)
and the occurrence-sampling rule; a frozen copy."""

from __future__ import annotations

import numpy as np

from perfbench.reference.corpus import QuerySet
from perfbench.reference.corpus import SAIndex
from perfbench.reference.types import Blocks, Pass1Result, Pass2Result

LONGESTCHSOURCE = 5  # max block matchlen (ExtractPair.cu:16, GenerateBlocks :2832)


def generate_blocks(sa: SAIndex, queries: QuerySet, p1: Pass1Result,
                    p2: Pass2Result, sa_values=None) -> Blocks:
    """Vectorized: one work item per (token, matchlen) candidate in the
    reference's traversal order (query asc, token asc, len 1 then 2..5), dedup
    by (up, down, len) key with first-appearance ids, per-query id lists by
    first encounter — identical observable output to the sequential loop.

    ``sa_values``: rank -> SA-value resolver; defaults to the host SA copy
    (the sharded index passes its distributed gather, kernel B2g)."""
    lm = p1.longestmatch.astype(np.int64)
    c1 = (lm > 0).astype(np.int64)
    c2 = np.maximum(np.minimum(lm, LONGESTCHSOURCE) - 1, 0)
    cnt = c1 + c2
    total = int(cnt.sum())
    if total == 0:
        z = np.empty(0, dtype=np.int32)
        return Blocks(start=z, end=z.copy(), matchlen=z.copy(),
                      string_start=z.copy(),
                      qry_global=[[] for _ in range(queries.qryscount)])
    tok = np.repeat(np.arange(len(lm), dtype=np.int64), cnt)
    ends_c = np.cumsum(cnt)
    k = np.arange(total, dtype=np.int64) - np.repeat(ends_c - cnt, cnt)
    lens = k + 1                 # slot 0 = len 1, slot j>=1 = len j+1
    is1 = k == 0
    p2n = max(len(p2.up), 1)
    cc = np.clip(p2.connectoffset.astype(np.int64)[tok] + k - 1, 0, p2n - 1)
    p2up = p2.up if len(p2.up) else np.zeros(1, np.int32)
    p2dn = p2.down if len(p2.down) else np.zeros(1, np.int32)
    up = np.where(is1, p1.up.astype(np.int64)[tok], p2up.astype(np.int64)[cc])
    down = np.where(is1, p1.down.astype(np.int64)[tok],
                    p2dn.astype(np.int64)[cc])

    keys = np.stack([up, down, lens], axis=1)
    _, first, inv = np.unique(keys, axis=0, return_index=True,
                              return_inverse=True)
    order = np.argsort(first, kind="stable")       # by first appearance
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    gid = rank[inv.ravel()]
    first_o = first[order]
    G = len(first_o)

    qv = np.asarray(queries.tok_to_qry, dtype=np.int64)[tok]
    _, pfirst = np.unique(qv * G + gid, return_index=True)
    order2 = np.lexsort((pfirst, qv[pfirst]))
    gids_sorted = gid[pfirst[order2]]
    counts_q = np.bincount(qv[pfirst], minlength=queries.qryscount)
    parts = np.split(gids_sorted, np.cumsum(counts_q)[:-1])
    if sa_values is None:
        string_start = np.asarray(sa.sa)[up[first_o]]
    else:
        string_start = np.asarray(sa_values(up[first_o]))
    return Blocks(
        start=up[first_o].astype(np.int32),
        end=down[first_o].astype(np.int32),
        matchlen=lens[first_o].astype(np.int32),
        string_start=string_start.astype(np.int32),
        qry_global=[p.tolist() for p in parts])


def sample_indices(dis: int, sampler: int, is_sample: bool):
    """The reference's uniform occurrence sampling (ExtractPair.cu:1133-1160):
    occurrence j participates iff j == ROUND(d * stepsize) for some d < sampler,
    with stepsize computed in float32 and ROUND(X) = (int)(X + 0.5)."""
    if not is_sample or dis <= sampler:
        return range(dis)
    step = np.float32(dis) / np.float32(sampler)
    sel = []
    prev = -1
    for d in range(sampler):
        togo = int(np.float64(np.float32(d) * step) + 0.5)
        if togo != prev and togo < dis:
            sel.append(togo)
            prev = togo
    return sel
