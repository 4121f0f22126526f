"""MaxLex feature scoring (lexicalTaskMaxEF, ExtractPair.cu:2144-2432).

Port of the device backend of ``cgx_tpu/features/maxlex.py``.  Per distinct
rule: the max lexical probability of each source word over the rule's
terminal target words plus NULL, and vice versa, accumulated as ``-log10``
in the reference's sequential float32 order.  The probes run against
NEG-LOG tables precomputed on the host (``-log10`` with numpy bits, +inf for
missing pairs), so ``max(prob)`` becomes ``min(neglog)`` -- bit-identical
because ``-log10`` is monotone decreasing -- and only the final [T] feature
columns come back to the host.

Table layout by the JAX package's size rule (``DEV_DENSE_LIMIT``):

* dense [ns, nt] matrices when the (src, tgt) id square fits -> kernel A9;
* per-source row ranges over the sorted target column otherwise -> kernel A10.

On CUDA the kernels always run; on the CPU their plain PyTorch versions do,
bit-equal to the JAX package's host loop (maxlex.py:382-399).

The sharded index scores on the host backend instead (copied from the JAX
package: ``_lookup``, the sorted-key half of ``_probe_bests_host`` and the
sequential float32 loop, maxlex.py:48-130, 365-399), as the JAX package
does for that layout, so that no O(corpus) array is replicated on the
device: ``compute_maxlex`` takes it when it is given a ``HostLexIndex``.
"""

from __future__ import annotations

import numpy as np
import torch

from cgx_tpu_torch.config import ExtractorConfig
from cgx_tpu_torch.index.container import HostLexIndex, pack_lex_key
from cgx_tpu_torch.kernels import build as kb
from cgx_tpu_torch.utils.batching import in_calls
from cgx_tpu_torch.utils.views import take

TPOSW = 16   # target span width (end offset < max_rule_span)
SRCW = 5     # max source words (MAX_rule_symbols)

# max dense-matrix entries per direction (2 x 512 MB of device memory)
DEV_DENSE_LIMIT = 1 << 27
# the most rules one launch of A9 or A10 scores (52 B of columns and
# features each on the device): an unsampled request's million distinct
# rules are scored in several, so MaxLex's device memory stays bounded
CALL_RULES = 1 << 19


def _neglog(v: np.ndarray) -> np.ndarray:
    """Host-precomputed ``-log10`` (numpy bits, f32): +inf for non-positive
    entries, so a zero/absent probability can never win a min.

    ``-log10(1.0) = -0.0``: the host accumulator's ``0.0 + (-0.0)`` yields
    ``+0.0``; canonicalising ``±0 -> +0`` here makes every device add
    bit-equal to the host's whatever the compiler does with ``0 + term``
    (x + 0.0 == x + (-0.0) for every x the accumulator can hold)."""
    v = np.asarray(v, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(v > 0, (-np.log10(np.where(v > 0, v, 1.0)))
                       .astype(np.float32), np.float32(np.inf))
    return np.where(out == 0, np.float32(0.0), out)


def lex_tables(index):
    """The index's NEG-LOG probe tables on its device, built once:
    ("dense", (L1, L2)) or ("range", (rs, re, lt, lnv1, lnv2, steps))."""
    if index.maxlex_tables is not None:
        return index.maxlex_tables
    dev = index.device
    lex_key = index.lex_key
    src = (lex_key >> 32).astype(np.int64)
    tgt = ((lex_key & 0xFFFFFFFF) - 2**31).astype(np.int64)
    n = len(src)
    ns = int(src.max()) + 2 if n else 1
    nt = int(tgt.max()) + 2 if n else 1
    l1 = _neglog(index.lex_val1_host)
    l2 = _neglog(index.lex_val2_host)

    def put(a):
        return kb.to_device(a, dev)

    if ns * nt <= DEV_DENSE_LIMIT:
        L1 = np.full((ns, nt), np.inf, dtype=np.float32)
        L2 = np.full((ns, nt), np.inf, dtype=np.float32)
        L1[src[::-1] + 1, tgt[::-1] + 1] = l1[::-1]   # first row wins
        L2[src[::-1] + 1, tgt[::-1] + 1] = l2[::-1]
        out = ("dense", (put(L1), put(L2)))
    else:
        # per-src row ranges over the (src, tgt)-sorted columns
        rs = np.searchsorted(src + 1, np.arange(ns)).astype(np.int32)
        re = np.searchsorted(src + 1, np.arange(ns) + 1).astype(np.int32)
        max_rows = int((re - rs).max()) if n else 1
        steps = max(int(max_rows).bit_length(), 1)
        out = ("range", (put(rs), put(re), put(tgt.astype(np.int32)),
                         put(l1), put(l2), steps))
    index.maxlex_tables = out
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions of kernels A9 and A10 (lanes = rules)
# ---------------------------------------------------------------------------

def _probe_masks(tgt_str, t0, tend, g1, g11, g2, g21):
    pos = t0[:, None] + torch.arange(TPOSW, dtype=torch.int32,
                                     device=t0.device)
    ttok = take(tgt_str, pos)
    inside = pos <= (t0 + tend)[:, None]
    out1 = (g1 < 0)[:, None] | (pos < (t0 + g1)[:, None]) | \
        (pos > (t0 + g11)[:, None])
    out2 = (g2 < 0)[:, None] | (pos < (t0 + g2)[:, None]) | \
        (pos > (t0 + g21)[:, None])
    tmask = inside & out1 & out2
    return ttok, tmask, tmask.any(dim=1)


def _terms_and_accumulate(l2, l2null, l1, l1null, sp, tmask, any_t, maxscore):
    """Masked minimums, +inf -> maxscore, then the sequential f32
    accumulation: j ascending, then p ascending (maxlex.py:146-158)."""
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=sp.device)
    ms = torch.tensor(maxscore, dtype=torch.float32, device=sp.device)
    best2 = torch.where(tmask[:, None, :], l2, inf).amin(dim=2)
    best2 = torch.where(any_t[:, None], torch.minimum(best2, l2null), best2)
    term_fge = torch.where(torch.isfinite(best2), best2, ms)
    best1 = torch.where((sp >= -1)[:, :, None], l1, inf).amin(dim=1)
    best1 = torch.minimum(best1, l1null)
    term_egf = torch.where(torch.isfinite(best1), best1, ms)
    nsrc = (sp != -99).sum(dim=1)
    fge = torch.zeros(sp.shape[0], dtype=torch.float32, device=sp.device)
    for j in range(SRCW):
        fge = torch.where(j < nsrc, fge + term_fge[:, j], fge)
    egf = torch.zeros_like(fge)
    for p in range(TPOSW):
        egf = torch.where(tmask[:, p], egf + term_egf[:, p], egf)
    return fge, egf


def accum_dense_plain(L1, L2, tgt_str, maxscore, sp, t0, tend, g1, g11, g2,
                      g21):
    """Plain PyTorch version of kernel A9."""
    ttok, tmask, any_t = _probe_masks(tgt_str, t0, tend, g1, g11, g2, g21)
    ns, nt = L1.shape
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=sp.device)
    si = sp + 1                                      # NULL src -> row 0
    ti = ttok + 1                                    # NULL tgt -> col 0
    oks = (si >= 0) & (si < ns)
    okt = (ti >= 0) & (ti < nt)
    sic = torch.where(oks, si, 0).long()
    tic = torch.where(okt, ti, 0).long()
    okb = oks[:, :, None] & okt[:, None, :]
    l2 = torch.where(okb, L2[sic[:, :, None], tic[:, None, :]], inf)
    l2null = torch.where(oks, L2[sic, 0], inf)
    l1 = torch.where(okb, L1[sic[:, :, None], tic[:, None, :]], inf)
    l1null = torch.where(okt, L1[0, tic], inf)
    return _terms_and_accumulate(l2, l2null, l1, l1null, sp, tmask, any_t,
                                 maxscore)


def _range_lookup(lt, lv, lo, hi, t, steps: int):
    """neg-log value at target id ``t`` within the sorted row range
    [lo, hi), +inf when absent; exactly ``steps`` bisection steps."""
    lo, hi, t = torch.broadcast_tensors(lo, hi, t)
    hi_init = hi
    for _ in range(steps):
        mid = (lo + hi) >> 1
        less = take(lt, mid) < t
        sel = lo < hi
        lo, hi = (torch.where(sel & less, mid + 1, lo),
                  torch.where(sel & ~less, mid, hi))
    found = (lo < hi_init) & (take(lt, lo) == t)
    return torch.where(found, take(lv, lo),
                       torch.tensor(float("inf"), dtype=torch.float32,
                                    device=lo.device))


def accum_range_plain(rs, re, lt, lnv1, lnv2, tgt_str, maxscore, sp, t0,
                      tend, g1, g11, g2, g21, steps: int):
    """Plain PyTorch version of kernel A10."""
    ttok, tmask, any_t = _probe_masks(tgt_str, t0, tend, g1, g11, g2, g21)
    ns = rs.shape[0]
    si = sp + 1
    oks = (si >= 0) & (si < ns)
    sic = torch.where(oks, si, 0)
    lo = torch.where(oks, take(rs, sic), 0)          # empty range when invalid
    hi = torch.where(oks, take(re, sic), 0)
    t3 = ttok[:, None, :]
    l2 = _range_lookup(lt, lnv2, lo[:, :, None], hi[:, :, None], t3, steps)
    l1 = _range_lookup(lt, lnv1, lo[:, :, None], hi[:, :, None], t3, steps)
    l2null = _range_lookup(lt, lnv2, lo, hi, torch.full_like(sp, -1), steps)
    # src NULL = id -1 = row range 0
    l1null = _range_lookup(lt, lnv1, rs[0], re[0], ttok, steps)
    return _terms_and_accumulate(l2, l2null, l1, l1null, sp, tmask, any_t,
                                 maxscore)


def _check_rules(kernel, device, sp, cols):
    kb.check_inputs(kernel, device, torch.int32, sp=sp,
                    **{f"col{k}": c for k, c in enumerate(cols)})
    T = sp.shape[0]
    if sp.dim() != 2 or sp.shape[1] != SRCW or any(c.shape != (T,)
                                                    for c in cols):
        raise ValueError(f"{kernel}: expected sp [T, {SRCW}] and six [T] "
                         "columns")
    return T


def accum_dense(L1, L2, tgt_str, maxscore: float, sp, t0, tend, g1, g11, g2,
                g21):
    """Kernel A9 (``csrc/maxlex.cu``): MaxLexFgivenE / MaxLexEgivenF f32 [T]
    per rule from the dense neg-log tables L1, L2 [ns, nt].

    Replaces ``_accum_batch_dense`` (cgx_tpu/features/maxlex.py:161).  On
    CUDA tensors it launches the kernel; on CPU tensors it runs
    ``accum_dense_plain``."""
    device = sp.device
    cols = (t0, tend, g1, g11, g2, g21)
    if not kb.route("A9", device):
        return accum_dense_plain(L1, L2, tgt_str, maxscore, sp, *cols)
    T = _check_rules("A9", device, sp, cols)
    kb.check_inputs("A9", device, torch.int32, tgt_str=tgt_str)
    kb.check_inputs("A9", device, torch.float32, L1=L1, L2=L2)
    if L1.shape != L2.shape or L1.dim() != 2:
        raise ValueError("A9: L1 and L2 must be equal [ns, nt] tables")
    fge = torch.empty(T, dtype=torch.float32, device=device)
    egf = torch.empty_like(fge)
    if T:
        kb.launch(
            "maxlex", "cgx_maxlex_dense", device, kb.ptr(L1), kb.ptr(L2),
            L1.shape[0], L1.shape[1], kb.ptr(tgt_str), tgt_str.shape[0],
            maxscore, kb.ptr(sp), *(kb.ptr(c) for c in cols), T, kb.ptr(fge),
            kb.ptr(egf))
        kb.counted("A9", T, kb.nbytes(sp, *cols, fge, egf))
    return fge, egf


def accum_range(rs, re, lt, lnv1, lnv2, tgt_str, maxscore: float, sp, t0,
                tend, g1, g11, g2, g21, steps: int):
    """Kernel A10 (``csrc/maxlex.cu``): as A9, over per-source row ranges
    [rs, re) of the sorted target column ``lt`` with a ``steps``-step binary
    search.

    Replaces ``_accum_batch_range`` (cgx_tpu/features/maxlex.py:216).  On
    CUDA tensors it launches the kernel; on CPU tensors it runs
    ``accum_range_plain``."""
    device = sp.device
    cols = (t0, tend, g1, g11, g2, g21)
    if not kb.route("A10", device):
        return accum_range_plain(rs, re, lt, lnv1, lnv2, tgt_str, maxscore,
                                 sp, *cols, steps)
    T = _check_rules("A10", device, sp, cols)
    kb.check_inputs("A10", device, torch.int32, rs=rs, re=re, lt=lt,
                    tgt_str=tgt_str)
    kb.check_inputs("A10", device, torch.float32, lnv1=lnv1, lnv2=lnv2)
    if rs.shape != re.shape or not (lt.shape == lnv1.shape == lnv2.shape) \
            or lt.shape[0] == 0:
        raise ValueError("A10: inconsistent or empty row-range tables")
    fge = torch.empty(T, dtype=torch.float32, device=device)
    egf = torch.empty_like(fge)
    if T:
        kb.launch(
            "maxlex", "cgx_maxlex_range", device, kb.ptr(rs), kb.ptr(re),
            rs.shape[0], kb.ptr(lt), kb.ptr(lnv1), kb.ptr(lnv2), lt.shape[0],
            steps, kb.ptr(tgt_str), tgt_str.shape[0], maxscore, kb.ptr(sp),
            *(kb.ptr(c) for c in cols), T, kb.ptr(fge), kb.ptr(egf))
        kb.counted("A10", T, kb.nbytes(sp, *cols, fge, egf))
    return fge, egf


# ---------------------------------------------------------------------------
# Host backend (the sharded index's)
# ---------------------------------------------------------------------------

def _lookup(lex_key, lex_val, keys):
    """Batched searchLexFile: value at key or 0.0 (ExtractPair.cu:2108-2142)."""
    i = np.searchsorted(lex_key, keys)
    ic = np.minimum(i, len(lex_key) - 1)
    found = (i < len(lex_key)) & (lex_key[ic] == keys)
    return np.where(found, lex_val[ic], np.float32(0)).astype(np.float32)


def _probe_bests_host(lex_key, lex_val1, lex_val2, src_pat, ttok, tmask,
                      any_t):
    """(fge_best [T, SRCW], egf_best [T, TPOSW]) on the host by batched
    ``np.searchsorted`` over the packed keys (the first table row wins on
    duplicate pairs)."""
    sp = src_pat.astype(np.int64)
    tt = ttok.astype(np.int64)
    keys = pack_lex_key(sp[:, :, None], tt[:, None, :])         # [T, 5, 16]
    v2 = _lookup(lex_key, lex_val2, keys)                       # P(t|s) side
    v1 = _lookup(lex_key, lex_val1, keys)                       # P(s|t) side
    v2null = _lookup(lex_key, lex_val2, pack_lex_key(sp, np.full_like(sp, -1)))
    v1null = _lookup(lex_key, lex_val1, pack_lex_key(np.full_like(tt, -1), tt))
    fge_best = np.max(np.where(tmask[:, None, :], v2, np.float32(0)), axis=2)
    fge_best = np.where(any_t[:, None], np.maximum(fge_best, v2null), fge_best)
    src_valid = src_pat >= -1  # padded entries are -99
    egf_best = np.max(np.where(src_valid[:, :, None], v1, np.float32(0)),
                      axis=1)
    egf_best = np.maximum(egf_best, v1null)
    return fge_best, egf_best


def maxlex_host(index: HostLexIndex, cfg: ExtractorConfig, src_pat, t0, tend,
                g1, g11, g2, g21):
    """The host backend: the probes on numpy and the reference's sequential
    float32 ``-log10`` accumulation -> (fge, egf) float32 [T]."""
    src_pat = np.asarray(src_pat)
    t0, tend, g1, g11, g2, g21 = (np.asarray(a, np.int64)
                                  for a in (t0, tend, g1, g11, g2, g21))
    T = len(t0)
    nsrc = (src_pat != -99).sum(axis=1).astype(np.int64)
    pos = t0[:, None] + np.arange(TPOSW, dtype=np.int64)[None, :]
    inside = pos <= (t0 + tend)[:, None]
    out1 = (g1 < 0)[:, None] | (pos < (t0 + g1)[:, None]) | \
        (pos > (t0 + g11)[:, None])
    out2 = (g2 < 0)[:, None] | (pos < (t0 + g2)[:, None]) | \
        (pos > (t0 + g21)[:, None])
    tmask = inside & out1 & out2
    any_t = tmask.any(axis=1)
    tgt_str = index.tgt_str_host
    ttok = tgt_str[np.clip(pos, 0, len(tgt_str) - 1)].astype(np.int64)
    fge_best, egf_best = _probe_bests_host(
        index.lex_key, index.lex_val1_host, index.lex_val2_host, src_pat,
        ttok, tmask, any_t)

    maxscore = np.float32(cfg.max_score)
    fge = np.zeros(T, dtype=np.float32)
    with np.errstate(divide="ignore"):
        for j in range(SRCW):
            m = j < nsrc
            best = fge_best[:, j]
            term = np.where(best > 0,
                            (-np.log10(np.where(best > 0, best, 1.0))
                             ).astype(np.float32), maxscore)
            fge = np.where(m, (fge + term).astype(np.float32), fge)
        egf = np.zeros(T, dtype=np.float32)
        for p in range(TPOSW):
            m = tmask[:, p]
            best = egf_best[:, p]
            term = np.where(best > 0,
                            (-np.log10(np.where(best > 0, best, 1.0))
                             ).astype(np.float32), maxscore)
            egf = np.where(m, (egf + term).astype(np.float32), egf)
    return fge, egf


def compute_maxlex(task_arrays: dict, index, rules_one, rules_two,
                   rules_contig, cfg: ExtractorConfig):
    """Scores the families' TaskArrays and scatters the features into the
    rules (row d of a family's TaskArrays is its distinct rule d): on the
    index's device (A9 / A10, in launches of at most ``CALL_RULES`` rules)
    for a ``TorchGrammarIndex``, on the host for a ``HostLexIndex`` (the
    sharded index's)."""
    by_kind = {"onegap": rules_one, "twogap": rules_two, "contig": rules_contig}
    kinds = [k for k in ("onegap", "twogap", "contig")
             if len(task_arrays[k].t0)]
    if not kinds:
        return
    if isinstance(index, HostLexIndex):
        fge, egf = maxlex_host(
            index, cfg, np.concatenate([task_arrays[k].src_pat
                                        for k in kinds]),
            *(np.concatenate([getattr(task_arrays[k], f) for k in kinds])
              for f in ("t0", "tend", "g1", "g11", "g2", "g21")))
        _scatter(by_kind, kinds, fge, egf)
        return
    dev = index.device
    src = np.concatenate([task_arrays[k].src_pat for k in kinds])
    cols = [np.concatenate([getattr(task_arrays[k], f) for k in kinds])
            for f in ("t0", "tend", "g1", "g11", "g2", "g21")]
    mode, tabs = lex_tables(index)

    def launch(*host_cols):
        sp, *cs = (kb.to_device(np.ascontiguousarray(c, np.int32), dev)
                   for c in host_cols)
        if mode == "dense":
            f, e = accum_dense(*tabs, index.tgt_str, cfg.max_score, sp, *cs)
        else:
            rs, re, lt, lnv1, lnv2, steps = tabs
            f, e = accum_range(rs, re, lt, lnv1, lnv2, index.tgt_str,
                               cfg.max_score, sp, *cs, steps)
        return kb.to_host(f).numpy(), kb.to_host(e).numpy()
    fge, egf = in_calls(launch, CALL_RULES, src, *cols)
    _scatter(by_kind, kinds, fge, egf)


def _scatter(by_kind, kinds, fge, egf):
    off = 0
    for k in kinds:
        rules = by_kind[k]
        nk = len(rules)
        rules.max_lex_fge[:] = fge[off:off + nk]
        rules.max_lex_egf[:] = egf[off:off + nk]
        off += nk
