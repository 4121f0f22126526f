"""Frequent-pair precomputation (SuffixArray.cu:1132-1340,
GappyLook.cu:740-869).

Port of ``cgx_tpu/search/precompute.py``.  Every occurrence of each of the
top-P tokens is scanned once per direction on the host; each move yields at
most one partner token, and cell membership and ownership are resolved with
a binary search into the sorted top list:

* forward from an occurrence of ``a``: partner ``b`` owns cell (a, b) iff
  count(b) >= count(a);
* backward from an occurrence of ``b``: partner ``a`` owns cell (a, b) iff
  count(a) > count(b).

Kernel A4 (``gap_check``) runs the target-side gap check of all 16 moves of
every occurrence that owns a candidate; failures are tallied per cell in
``feature_missing`` (ExtractPair.c:899-908 correction).
"""

from __future__ import annotations

import numpy as np
import torch

from cgx_tpu_torch.config import ExtractorConfig, check_capacity
from cgx_tpu_torch.kernels import build as kb
from cgx_tpu_torch.preproc.corpus import SourceCorpus
from cgx_tpu_torch.preproc.suffix_array import SAIndex
from cgx_tpu_torch.search.lookup import MMOV, gap_check_grow, pack_moves
from cgx_tpu_torch.types import Precomp


def gap_check_plain(rlp, lr_tar, gostart, mrs: int, mgs: int, fwd: bool):
    """Plain PyTorch version of kernel A4 -> int32 [n] move masks."""
    anchor = gostart + 1 if fwd else gostart - 1
    return pack_moves(gap_check_grow(rlp, lr_tar, anchor, mgs - 1, mrs, fwd))


def gap_check(rlp, lr_tar, gostart, mrs: int, mgs: int, fwd: bool):
    """Kernel A4 (``csrc/gapcheck.cu``): for each occurrence ``gostart[i]``
    the int32 mask of the gap moves (forward after it, backward before it)
    whose target-side gap check passes.  ``rlp`` and ``lr_tar`` are the
    whole arrays or ``OffsetView``s of one shard's slices (utils/views.py),
    as JAX passes ``offs``.

    Replaces ``_gc_batch`` (cgx_tpu/search/precompute.py:38).  On CUDA
    tensors it launches the kernel; on CPU tensors it runs
    ``gap_check_plain``."""
    device = gostart.device
    if not kb.route("A4", device):
        return gap_check_plain(rlp, lr_tar, gostart, mrs, mgs, fwd)
    kb.check_inputs("A4", device, torch.int32, rlp=rlp, lr_tar=lr_tar,
                    gostart=gostart)
    n = gostart.shape[0]
    kb.check_count("A4", n)
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        lib = kb.library("gapcheck")
        kb.check("gapcheck", lib.cgx_gap_check(
            *kb.view(rlp), *kb.view(lr_tar), kb.ptr(gostart), n, mrs, mgs,
            int(fwd), kb.ptr(out), kb.stream(device)))
        kb.LAUNCHES[kb.launch_id("A4", rlp)] += 1
    return out


def gc_bit(gc_words, mm) -> np.ndarray:
    """Move ``mm[i]``'s bit of occurrence i's gap-check mask."""
    return ((np.asarray(gc_words).view(np.uint32) >> np.asarray(mm)) & 1) == 1


def _host_scan(refstr, tokens, counts, tok_idx, gostart, mrs, mgs, fwd):
    """Vectorized host transcription of the per-occurrence partner scan
    (GappyLook.cu:787-822 fwd / :824-861 bwd): partner token per move,
    sequential early exit (prefix-AND), top-list membership, and cell
    ownership."""
    n = len(gostart)
    P = len(tokens)
    moves = np.arange(MMOV)
    if fwd:
        pos = gostart[:, None] + 1 + mgs + moves[None, :]
        # mask past-the-end reads (else they clamp to the sentinel, which is
        # >= 2 and would keep a scan alive that the reference stops)
        oob = pos >= len(refstr)
        gap0_bad = (gostart + mgs >= len(refstr)) | \
            (refstr[np.minimum(gostart + mgs, len(refstr) - 1)] < 2)
    else:
        pos = gostart[:, None] - 1 - mgs - moves[None, :]
        oob = pos < 0
        gap0_bad = (gostart - mgs >= 0) & \
            (refstr[np.maximum(gostart - mgs, 0)] < 2)
    temp = np.where(oob, -1, refstr[np.clip(pos, 0, len(refstr) - 1)])
    bad = temp < 2
    reach = np.ones((n, MMOV), dtype=bool)
    reach[:, 1:] = np.cumprod(~bad[:, :-1], axis=1).astype(bool)
    span_ok = 1 + mgs + moves + 1 <= mrs
    scan_ok = reach & ~bad & span_ok[None, :] & ~gap0_bad[:, None]
    ib = np.searchsorted(tokens, temp)
    member = (ib < P) & (tokens[np.minimum(ib, P - 1)] == temp)
    cnt_p = counts[np.minimum(ib, P - 1)]
    mine = counts[tok_idx][:, None]
    if fwd:
        owns = scan_ok & member & (cnt_p >= mine)
        cell = tok_idx[:, None] * P + ib
        start = np.broadcast_to(gostart[:, None], (n, MMOV))
    else:
        owns = scan_ok & member & (cnt_p > mine)
        cell = ib * P + tok_idx[:, None]
        start = pos
    length = np.broadcast_to(moves + 1 + mgs, (n, MMOV))
    return owns, cell, start, length


def top_tokens(source: SourceCorpus, sa: SAIndex, cfg: ExtractorConfig):
    """Top-P frequent tokens via SA runs (SuffixArray.cu:1148-1198), ties
    broken by ascending token id."""
    first = np.asarray(source.str_)[np.asarray(sa.sa)]
    valid = first >= 2
    v = first[valid]
    pos = np.flatnonzero(valid)
    change = np.empty(len(v), dtype=bool)
    change[0] = True
    change[1:] = v[1:] != v[:-1]
    starts = np.flatnonzero(change)
    tokens = v[starts]
    counts = np.diff(np.concatenate([starts, [len(v)]]))
    run_start = pos[starts]
    P = min(cfg.precompute_count, len(tokens))
    order = np.argsort(-counts, kind="stable")[:P]
    order = order[np.argsort(tokens[order], kind="stable")]
    return tokens[order], counts[order], run_start[order]


def precompute(engine, source: SourceCorpus, sa: SAIndex,
               cfg: ExtractorConfig) -> Precomp:
    """The precomputed occurrences of every owned frequent pair, with the
    gap checks (A4) run by ``engine`` (``cgx_tpu_torch.engine``), forward
    then backward; a ``ShardedEngine`` runs each check on the shard that
    owns its occurrence."""
    tokens, counts, run_start = top_tokens(source, sa, cfg)
    P = len(tokens)
    mrs, mgs = cfg.max_rule_span, cfg.min_gap_size
    sa_host = np.asarray(sa.sa)

    # every occurrence of every top token, once
    tok_idx = np.repeat(np.arange(P), counts)
    offs = np.concatenate([[0], np.cumsum(counts)])[:-1]
    tx = np.arange(int(counts.sum())) - np.repeat(offs, counts)
    gostart = sa_host[np.repeat(run_start, counts) + tx].astype(np.int32)

    refstr_host = np.asarray(source.str_)
    rows_parts = []
    missing = np.zeros(P * P, dtype=np.int32)
    for fwd in (True, False):
        owns, cell, start, length = _host_scan(
            refstr_host, tokens, counts, tok_idx, gostart.astype(np.int64),
            mrs, mgs, fwd)
        live = np.flatnonzero(owns.any(axis=1))
        if not len(live):
            continue
        gc = engine.gap_check(gostart[live], fwd)
        ii_l, mm = np.nonzero(owns[live])
        ii = live[ii_l]
        hit = gc_bit(gc[ii_l], mm)
        np.add.at(missing, cell[ii, mm][~hit], 1)
        if hit.any():
            rows_parts.append(np.stack([
                cell[ii, mm][hit], start[ii, mm][hit].astype(np.int64),
                length[ii, mm][hit].astype(np.int64)], axis=1))

    if rows_parts:
        rows = np.concatenate(rows_parts, axis=0)
        check_capacity("precomp", len(rows), cfg.cap_precomp)
        rows = rows[np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))]
    else:
        rows = np.empty((0, 3), dtype=np.int64)

    index_start = np.ones(P * P, dtype=np.int32)
    index_end = np.zeros(P * P, dtype=np.int32)
    if len(rows):
        uniq, first_idx, cnts = np.unique(rows[:, 0], return_index=True,
                                          return_counts=True)
        index_start[uniq] = first_idx.astype(np.int32)
        index_end[uniq] = (first_idx + cnts - 1).astype(np.int32)
    return Precomp(
        frequent_list=tokens.astype(np.int32),
        tok_start=run_start.astype(np.int32),
        tok_len=counts.astype(np.int32),
        index_start=index_start, index_end=index_end,
        onegap_start=rows[:, 1].astype(np.int32),
        onegap_length=rows[:, 2].astype(np.int32),
        feature_missing=missing, count=len(rows))
