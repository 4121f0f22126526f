"""The words of their inputs that the kernels' functions need, per item:
what the bounds in ``chip_smoke.py`` count.

A function that stops early (a scan at its first dead move, the growth
state machine at its first inactive step, the gap check when no move
passes its first test) needs only the words that decide its result.  Each
counter here takes them from the plain version's own flags, maps them to
the slots of the arrays that the reads land in (clamped as the plain
version clamps them), and counts each distinct slot once over the whole
launch: a word that several items read (a shared table's, the corpus
around overlapping occurrences) is one word to move.  ``*_need`` returns
the slots and which of them are needed, so that a test can redraw every
other word and find the result unchanged.

* ``contig_reads``: A6, B3c and B4's extraction (``_extract_contig_item``);
* ``onegap_reads``: A7 on the whole arrays or a shard's views
  (``_extract_onegap_item``);
* ``twogap_reads``: A8 likewise (``_extract_twogap_item``);
* ``two_reads``: A5, C1t and B3t (``_two_item``);
* ``gap_reads``: the fused gap check alone (A4, and lookup1's scans for
  the items with a candidate);
* ``scan_reads``: lookup1's scans (A2, B3f/B3b, C1f/C1b);
* ``maxlex_reads``: A10 (``_accum_batch_range``);
* ``maxlex_dense_reads``: A9 (``_accum_batch_dense``);
* ``lcp_reads``: B1's passes (``_search_body`` and ``_bound_walk``), with
  the chain of dependent read rounds that the kernel's warp body takes;
* ``dp_reads``: B4, B1's pass 1 on its lanes and A6's body on its items;
* ``refine_reads``: A1 and B2r, the seeded refinement's binary lower
  bounds (B2r also the shards' meta rows);
* ``pcs_reads``: A3, B3p and C1p (``_pcs_item``), with ``pcs_rounds``, the
  rounds in which A3's warp resolves its items' patterns;
* ``probe_reads``: P1 and P2, the corpus words under the union of the
  probe's windows.
"""

from __future__ import annotations

import numpy as np
import torch

from cgx_tpu_torch.extract import device as xdev
from cgx_tpu_torch.features import maxlex as ml
from cgx_tpu_torch.parallel import sharded as shx
from cgx_tpu_torch.search import lookup, passes
from cgx_tpu_torch.tools import gather_probe as gp
from cgx_tpu_torch.utils.views import as_view, take


def _slots(arr, pos, bounded: bool = True):
    """The slots of ``arr``'s storage that reads at ``pos`` land in: a read
    the plain version bounds (``take``) is clamped into the global array
    first, every read then into the local slice (``utils.views``)."""
    v = as_view(arr)
    if bounded:
        pos = pos.clamp(0, v.glen - 1)
    return (pos - v.off).clamp(0, v.arr.shape[0] - 1)


def _distinct(pairs) -> int:
    """Distinct kept slots of (slots, keep) pairs of [N, K], over all rows
    and pairs."""
    return int(torch.unique(torch.cat(
        [slots[keep].reshape(-1) for slots, keep in pairs])).numel())


def count(*needs: dict, arrays=("refstr", "rlp", "lr_tar")) -> int:
    """The words of ``*_need`` records of one launch: each array's distinct
    slots over all the records' rows counted once."""
    return sum(_distinct([n[a] for n in needs if a in n]) for a in arrays
               if any(a in n for n in needs))


def _range(lo, hi, looked, H: int):
    """[N, 2H + 1] window offsets -H..H that lookups at offsets -lo..hi
    ([N, K] each, ``looked`` where made) read."""
    d = torch.arange(-H, H + 1, dtype=torch.int32, device=lo.device)
    return (looked[..., None] & (d >= -lo[..., None])
            & (d <= hi[..., None])).any(dim=1)


def contig_need(refstr, rlp, lr_tar, cs, lm, mrs: int, msym: int) -> dict:
    """What ``_extract_contig_item`` needs for the occurrences at corpus
    positions ``cs`` with block lengths ``lm`` -> {array: (slots, keep)}
    and the growth steps run (``steps``, ``inner``, int [N]).

    * RLP: the block's lm span words (word 0 also gives the sentence
      anchor) and the anchor word; each side's step words up to the first
      step at which its family is dead or the outer loop ends;
    * refstr: each side's step tokens while its family is alive;
    * lr_tar: only the window entries that a check looks up, from the
      offsets -lo..hi it reads: the base window for the ab span and each
      whole-span part-vector used, each side's window for its X gap checks
      (made only past an aligned step)."""
    need: dict = {}
    xdev._contig_body(refstr, rlp, lr_tar, cs, lm, mrs, msym, need)
    dev, i32 = cs.device, torch.int32
    H = mrs - 1
    IMAX = xdev.IMAX
    k = torch.arange(xdev.CWID, dtype=i32, device=dev)
    steps = torch.arange(1, IMAX + 1, dtype=i32, device=dev)
    span = cs[:, None] + k
    span_keep = ((k < lm[:, None]) & (span >= 0)) | (k == 0)
    tempind = (need["sentstart"] - 1)[:, None]
    left = cs[:, None] - steps
    right = (cs + lm - 1)[:, None] + steps
    rlp_pos = torch.cat([span, tempind, left, right], dim=1)
    rlp_keep = torch.cat([span_keep, tempind != -1,
                          need["l_rlp"] & (left >= 0),
                          need["r_rlp"] & (right >= 0)], dim=1)
    ref_pos = torch.cat([left, right], dim=1)
    ref_keep = torch.cat([need["l_tok"] & (left >= 0),
                          need["r_tok"] & (right >= 0)], dim=1)

    stb, mL, mR = need["stb"], need["min_L"], need["max_R"]
    anchor = stb + mL.clamp(max=255)
    # the ab check looks up [ts, te] = stb + [min_L, max_R] (``_win_check``)
    ab_lo = (anchor - stb - mL).clamp(0, H)[:, None]
    ab_hi = (stb + mR - anchor).clamp(0, H)[:, None]
    anchors = [anchor]
    keeps = [_range(ab_lo, ab_hi, need["ab"][:, None], H)]
    for s in "lr":
        al, pmin, pmax = need[s]
        # the whole-span part-vectors (``_whole_span``)
        lo = (mL[:, None] - pmin).clamp(0, H)
        hi = (torch.maximum(pmax, mR[:, None]) - mL[:, None]).clamp(0, H)
        keeps[0] = keeps[0] | _range(lo, hi, need[f"{s}_part"], H)
        # the X gap checks on the side's own window, anchored at its first
        # aligned step (where a check is made there is one)
        first = al.to(i32).argmax(dim=1, keepdim=True)
        a = stb + pmin.gather(1, first)[:, 0]
        ts, te = stb[:, None] + pmin, stb[:, None] + pmax
        lo = (a[:, None] - ts).clamp(0, H)
        hi = (te - a[:, None]).clamp(0, H)
        anchors.append(a)
        keeps.append(_range(lo, hi, need[f"{s}_gap"] & (ts <= te), H))
    d = torch.arange(-H, H + 1, dtype=i32, device=dev)
    tar_pos = torch.cat([a[:, None] + d for a in anchors], dim=1)
    return {"refstr": (_slots(refstr, ref_pos), ref_keep),
            "rlp": (_slots(rlp, rlp_pos), rlp_keep),
            "lr_tar": (_slots(lr_tar, tar_pos), torch.cat(keeps, dim=1)),
            "steps": need["steps"], "inner": need["inner"]}


def contig_reads(refstr, rlp, lr_tar, cs, lm, mrs: int,
                 msym: int) -> tuple:
    """(words, outer growth steps, inner growth steps) that
    ``_extract_contig_item`` needs over the items (``contig_need``)."""
    need = contig_need(refstr, rlp, lr_tar, cs, lm, mrs, msym)
    return (count(need), int(need["steps"].sum()),
            int(need["inner"].sum()))


def _span(start, ender, keep):
    """[N, CWID] positions of a source span's RLP words and those needed:
    the words up to ``ender`` (positions < 0 read as unaligned, so no word)
    where ``keep``."""
    k = torch.arange(xdev.CWID, dtype=torch.int32, device=start.device)
    pos = start[:, None] + k
    return pos, (pos <= ender[:, None]) & (pos >= 0) & keep[:, None]


def onegap_need(refstr, rlp, lr_tar, cs, first_end, sl, el, mrs: int,
                msym: int) -> dict:
    """What ``_extract_onegap_item`` needs for the aXb occurrences (corpus
    start ``cs``, span end offset ``first_end``, a and b lengths ``sl``,
    ``el``) -> {array: (slots, keep)} and the growth steps run (``steps``,
    int [N], both sides).  A side runs while its flag holds and the span
    limit allows, so to its first event (``_onegap_body``):

    * RLP: checkBoundary's span words and its anchor word (its ts is
      always written); the first gap's span words where a family is valid
      (only then are the gap's offsets packed), its word 0 and anchor word
      also where a side reaches its X gap check (the item's sentence
      anchor); each side's step words where the step runs and its token
      passes;
    * refstr: each side's step tokens where the step runs;
    * lr_tar: consistent()'s words where checkBoundary calls it; each
      side's window entries that its X gap checks look up; the base
      window's entries that the whole-span checks (``w_ok``) look up."""
    need: dict = {}
    xdev._onegap_body(refstr, rlp, lr_tar, cs, first_end, sl, el, mrs, msym,
                      need)
    dev, i32 = cs.device, torch.int32
    H = mrs - 1
    k = torch.arange(xdev.CWID, dtype=i32, device=dev)
    steps = torch.arange(1, xdev.IMAX + 1, dtype=i32, device=dev)
    ender = cs + first_end
    stb, mL, mR = need["stb"], need["min_L"], need["max_R"]
    d = torch.arange(-H, H + 1, dtype=i32, device=dev)
    base = stb + mL.clamp(max=255)
    base_keep = torch.zeros((cs.shape[0], 2 * H + 1), dtype=torch.bool,
                            device=dev)
    anchors, tar_keep = [], []
    checked_any = torch.zeros_like(cs, dtype=torch.bool)
    for s in "lr":
        has, al, pmin, pmax = (need[f"{s}_{f}"]
                               for f in ("has", "al", "pmin", "pmax"))
        run = need[f"{s}_run"]
        # the X gap check is made where the step runs, its token passes, it
        # is aligned and its aligned span is not too wide
        checked = run & has & al & (pmax - pmin < mrs)
        checked_any |= checked.any(dim=1)
        # the whole-span check where the X gap passes and the grown span is
        # not too wide (``_whole_span``)
        looked = checked & need[f"{s}_gap"] & (
            need[f"{s}_wte"] - need[f"{s}_wts"] < mrs)
        lo = (mL[:, None] - pmin).clamp(0, H)
        hi = (torch.maximum(pmax, mR[:, None]) - mL[:, None]).clamp(0, H)
        base_keep |= _range(lo, hi, looked, H)
        # the side's window, anchored at its first aligned step (where a
        # check is made there is one)
        first = al.to(i32).argmax(dim=1, keepdim=True)
        a = stb + pmin.gather(1, first)[:, 0]
        ts, te = stb[:, None] + pmin, stb[:, None] + pmax
        anchors.append(a)
        tar_keep.append(_range((a[:, None] - ts).clamp(0, H),
                               (te - a[:, None]).clamp(0, H),
                               checked & (ts <= te), H))
    valid = need["valid"][0] | need["valid"][1] | need["valid"][2]
    b_pos, b_keep = _span(cs, ender, torch.ones_like(valid))
    b_keep[:, 0] = True                  # al_first and the sentence anchor
    g_pos, g_keep = _span(cs + sl, ender - el, valid)
    g_keep[:, 0] = valid | checked_any   # also the item's sentence anchor
    b_temp = xdev._sent_anchor(rlp, cs)[0] - 1     # stb = rlp[tempind]
    g_temp = need["sentstart"] - 1
    left = cs[:, None] - steps
    right = ender[:, None] + steps
    rlp_pos = torch.cat([b_pos, b_temp[:, None], g_pos, g_temp[:, None],
                         left, right], dim=1)
    rlp_keep = torch.cat([b_keep, (b_temp != -1)[:, None], g_keep,
                          (g_keep[:, :1] & (g_temp != -1)[:, None]),
                          need["l_run"] & need["l_has"],
                          need["r_run"] & need["r_has"]], dim=1)
    ref_pos = torch.cat([left, right], dim=1)
    ref_keep = torch.cat([need["l_run"] & (left >= 0),
                          need["r_run"] & (right >= 0)], dim=1)
    c_pos = need["ts"][:, None] + k
    c_keep = need["check"][:, None] & (c_pos <= need["te"][:, None])
    tar_pos = torch.cat([c_pos] + [x[:, None] + d
                                   for x in [base] + anchors], dim=1)
    return {"refstr": (_slots(refstr, ref_pos), ref_keep),
            "rlp": (_slots(rlp, rlp_pos), rlp_keep),
            "lr_tar": (_slots(lr_tar, tar_pos),
                       torch.cat([c_keep, base_keep] + tar_keep, dim=1)),
            "steps": need["l_run"].sum(dim=1) + need["r_run"].sum(dim=1)}


def onegap_reads(refstr, rlp, lr_tar, cs, first_end, sl, el, mrs: int,
                 msym: int) -> tuple:
    """(words, growth steps run) that ``_extract_onegap_item`` needs over
    the items (``onegap_need``)."""
    need = onegap_need(refstr, rlp, lr_tar, cs, first_end, sl, el, mrs, msym)
    return count(need), int(need["steps"].sum())


def twogap_need(refstr, rlp, lr_tar, cs, first_end, second_end, sl, el, cl,
                mrs: int) -> dict:
    """What ``_extract_twogap_item`` needs for the aXbXc occurrences ->
    {array: (slots, keep)} and ``valid`` (bool [N]): checkBoundary's span
    words and anchor word over [cs, cs + second_end] (its ts is always
    written) and consistent()'s lr_tar words where it is called; each gap's
    span words and anchor word only where the rule is valid (only then are
    the gaps' offsets packed)."""
    ender = cs + second_end
    code, ts, te, check = xdev.check_boundary(rlp, lr_tar, cs, ender, mrs)
    valid = code == 1
    b_pos, b_keep = _span(cs, ender, torch.ones_like(valid))
    b_keep[:, 0] = True
    g1, g2 = cs + sl, cs + first_end + 1
    s1_pos, s1_keep = _span(g1, cs + first_end - el, valid)
    s2_pos, s2_keep = _span(g2, ender - cl, valid)
    s1_keep[:, 0] |= valid
    s2_keep[:, 0] |= valid
    temps = [xdev._sent_anchor(rlp, p)[0] - 1 for p in (cs, g1, g2)]
    rlp_pos = torch.cat([b_pos, s1_pos, s2_pos]
                        + [t[:, None] for t in temps], dim=1)
    rlp_keep = torch.cat([b_keep, s1_keep, s2_keep]
                         + [((t != -1) & w)[:, None] for t, w in
                            zip(temps, (torch.ones_like(valid), valid,
                                        valid))], dim=1)
    k = torch.arange(xdev.CWID, dtype=torch.int32, device=cs.device)
    c_pos = ts[:, None] + k
    c_keep = check[:, None] & (c_pos <= te[:, None])
    return {"rlp": (_slots(rlp, rlp_pos), rlp_keep),
            "lr_tar": (_slots(lr_tar, c_pos), c_keep), "valid": valid}


def twogap_reads(refstr, rlp, lr_tar, cs, first_end, second_end, sl, el, cl,
                 mrs: int) -> tuple:
    """(words, valid rules) that ``_extract_twogap_item`` needs over the
    items (``twogap_need``)."""
    need = twogap_need(refstr, rlp, lr_tar, cs, first_end, second_end, sl,
                       el, cl, mrs)
    return count(need), int(need["valid"].sum())


def gap_need(rlp, lr_tar, fixed, base_off: int, mrs: int,
             grow_right: bool) -> dict:
    """What the fused gap check (``lookup.gap_check_grow``) needs ->
    {array: (slots, keep)} and ``ok`` (bool [N], some move passes the first
    test):

    * RLP: window word 0; if it is aligned, the words up to the widest
      move's span; if some move passes the first test, the spans' start
      token and its sentence anchor;
    * lr_tar: only if some move passes the first test, the window words
      that lie in such a move's target span."""
    ks, unal, ok1, ts, te, tempind = lookup._gap_first_test(
        rlp, fixed, base_off, mrs, grow_right)
    dev = fixed.device
    w = torch.arange(mrs, dtype=torch.int32, device=dev)
    last = min(base_off + lookup.MMOV - 1, mrs - 1)
    ok = ok1.any(dim=1)
    win_keep = ((w == 0) | ((w <= last) & ~unal[:, :1])) & (ks >= 0)
    start_tok = fixed if grow_right else fixed - base_off
    rlp_pos = torch.cat([ks, start_tok[:, None], tempind[:, None]], dim=1)
    rlp_keep = torch.cat([win_keep, ok[:, None],
                          (ok & (tempind != -1))[:, None]], dim=1)
    moves = torch.arange(lookup.MMOV, dtype=torch.int32, device=dev)
    win = lookup._gap_anchor(ok1, ts)[:, None] + moves
    in_span = ((win[:, None, :] >= ts[:, :, None])
               & (win[:, None, :] <= te[:, :, None]) & ok1[:, :, None])
    return {"rlp": (_slots(rlp, rlp_pos), rlp_keep),
            "lr_tar": (_slots(lr_tar, win), in_span.any(dim=1)), "ok": ok}


def gap_reads(rlp, lr_tar, fixed, base_off: int, mrs: int,
              grow_right: bool) -> tuple:
    """(words, items where some move passes the first test) of the fused
    gap check over the items (``gap_need``)."""
    need = gap_need(rlp, lr_tar, fixed, base_off, mrs, grow_right)
    return count(need), int(need["ok"].sum())


def two_need(refstr, rlp, lr_tar, pstart, plen, mrs: int, mgs: int) -> dict:
    """What ``_two_item`` needs for the aXb occurrences (``pstart``,
    ``plen``) -> {array: (slots, keep)} and ``ok`` (``gap_need``): the
    gap-0 token, the move words up to the first that stops the scan or
    the span limit (none after a bad gap-0 token), and the gap check's
    words (gc is half the output, so every item runs it)."""
    _, read = lookup._two_cand(refstr, pstart, plen, mrs, mgs)
    gostart = pstart + plen
    glen = as_view(refstr).glen
    moves = torch.arange(lookup.MMOV, dtype=torch.int32, device=pstart.device)
    ref_pos = torch.cat([
        _slots(refstr, (gostart + mgs)[:, None], bounded=False),
        _slots(refstr, ((gostart + 1 + mgs)[:, None] + moves).clamp(
            max=glen - 1), bounded=False)], dim=1)
    ref_keep = torch.cat([torch.ones_like(read[:, :1]), read], dim=1)
    need = gap_need(rlp, lr_tar, gostart + 1, mgs - 1, mrs, True)
    need["refstr"] = (ref_pos, ref_keep)
    return need


def two_reads(refstr, rlp, lr_tar, pstart, plen, mrs: int,
              mgs: int) -> tuple:
    """(words, items where some move passes the gap check's first test)
    that ``_two_item`` needs over the items (``two_need``)."""
    need = two_need(refstr, rlp, lr_tar, pstart, plen, mrs, mgs)
    return count(need), int(need["ok"].sum())


def scan_reads(refstr, rlp, lr_tar, gostart, sl, el, want, mrs: int,
               mgs: int, fwd: bool) -> tuple:
    """What lookup1's scan needs for N items (occurrence ``gostart``,
    lengths ``sl``, ``el``, compared tokens ``want`` [N, 3]), besides one
    gap-0 token each -> (items with a candidate, window words that decide
    the candidates, the gap check's words and its items past the first test
    over the items with a candidate: only those need it)."""
    gap0_bad, win = lookup._scan_window(refstr, gostart, sl, mgs, fwd)
    cand, read = lookup._scan_cand(win, gap0_bad, sl, el, want, mrs, mgs,
                                   fwd)
    has = cand.any(dim=1)
    fixed = (gostart + sl if fwd else gostart - 1)[has]
    gap_words, gap_ok = gap_reads(rlp, lr_tar, fixed, mgs - 1, mrs, fwd)
    ks = torch.arange(lookup.MMOV + 2, dtype=torch.int32,
                      device=gostart.device)
    if fwd:
        pos = (gostart + sl + mgs)[:, None] + ks
    else:
        pos = (gostart - 1 - mgs)[:, None] - ks
        read = read & (pos >= 0)      # off the corpus start: no read
    window = _distinct([(_slots(refstr, pos), read)])
    return int(has.sum()), window, gap_words, gap_ok


MAXLEX_ARRAYS = ("rs", "re", "lt", "lnv1", "lnv2")


def maxlex_need(rs, re, lt, lnv1, lnv2, tgt_str, sp, t0, tend, g1, g11, g2,
                g21, steps: int) -> dict:
    """What ``_accum_batch_range`` needs per rule -> {array: (slots,
    keep)}, ``searches`` (int [T], the distinct searches) and ``steps_run``
    (int [T], their bisection steps).

    The searches are the distinct (row, target) pairs: each valid source
    row x the kept target positions, each valid source row counted in
    ``nsrc`` x the target -1 when any position is kept, and the NULL row x
    the kept positions.  Each needs the lt words of its bisection path
    while lo < hi (at most ceil(log2(hi - lo + 1)) of them) and its found
    word; a present pair its value words: lnv2 for the P(t|s) side (rows
    counted in ``nsrc``), lnv1 for the P(s|t) side (source rows and the
    NULL row).  rs and re: each valid source's two words and the NULL
    row's."""
    ttok, tmask, any_t = ml._probe_masks(tgt_str, t0, tend, g1, g11, g2, g21)
    T = sp.shape[0]
    ns = rs.shape[0]
    si = sp + 1
    oks = (si >= 0) & (si < ns)
    sic = torch.where(oks, si, 0)
    lo = torch.where(oks, take(rs, sic), 0)
    hi = torch.where(oks, take(re, sic), 0)
    counted = (sp != -99).sum(dim=1, keepdim=True) > torch.arange(
        ml.SRCW, device=sp.device)
    P = ml.TPOSW
    pairs = (oks[:, :, None] & tmask[:, None, :]).reshape(T, -1)
    los = torch.cat([lo[:, :, None].expand(T, ml.SRCW, P).reshape(T, -1), lo,
                     rs[0].expand(T, P)], dim=1)
    his = torch.cat([hi[:, :, None].expand(T, ml.SRCW, P).reshape(T, -1), hi,
                     re[0].expand(T, P)], dim=1)
    keys = torch.cat([ttok[:, None, :].expand(T, ml.SRCW, P).reshape(T, -1),
                      torch.full_like(sp, -1), ttok], dim=1)
    need_v2 = torch.cat([(pairs.reshape(T, ml.SRCW, P)
                          & counted[:, :, None]).reshape(T, -1),
                         oks & counted & any_t[:, None],
                         torch.zeros_like(tmask)], dim=1)
    need_v1 = torch.cat([pairs, torch.zeros_like(oks), tmask], dim=1)
    needed = need_v1 | need_v2
    l, h = los, torch.where(needed, his, los)   # an unneeded search: no read
    h_init = h
    mids, acts = [], []
    for _ in range(steps):
        mid = (l + h) >> 1
        act = l < h
        mids.append(mid)
        acts.append(act)
        less = take(lt, mid) < keys
        l, h = (torch.where(act & less, mid + 1, l),
                torch.where(act & ~less, mid, h))
    looked = l < h_init
    found = looked & (take(lt, l) == keys)
    lt_pos = torch.cat(mids + [l], dim=1)
    lt_keep = torch.cat(acts + [looked], dim=1)
    src_pos = torch.cat([sic, torch.zeros_like(sic[:, :1])], dim=1)
    src_keep = torch.cat([oks, torch.ones_like(oks[:, :1])], dim=1)
    return {"lt": (_slots(lt, lt_pos), lt_keep),
            "lnv1": (_slots(lnv1, l), found & need_v1),
            "lnv2": (_slots(lnv2, l), found & need_v2),
            "rs": (_slots(rs, src_pos), src_keep),
            "re": (_slots(re, src_pos), src_keep),
            "searches": needed.sum(dim=1),
            "steps_run": sum(a.sum(dim=1) for a in acts)}


def maxlex_reads(rs, re, lt, lnv1, lnv2, tgt_str, sp, t0, tend, g1, g11, g2,
                 g21, steps: int) -> tuple:
    """(words, searches, bisection steps) that ``_accum_batch_range`` needs
    over the rules beyond each rule's fixed input, target and output words
    (``maxlex_need``)."""
    need = maxlex_need(rs, re, lt, lnv1, lnv2, tgt_str, sp, t0, tend, g1, g11,
                       g2, g21, steps)
    return (count(need, arrays=MAXLEX_ARRAYS), int(need["searches"].sum()),
            int(need["steps_run"].sum()))


def maxlex_dense_need(L1, L2, tgt_str, sp, t0, tend, g1, g11, g2,
                      g21) -> dict:
    """What ``_accum_batch_dense`` needs per rule -> {table: (slots,
    keep)}, slots into the flattened [ns * nt] tables.

    L2 (the P(t|s) side): each source row counted in ``nsrc`` at each kept
    target position, and its NULL column where any position is kept; L1
    (P(s|t)): each valid source row at each kept position, and the NULL
    row there.  A probe off the table (an invalid id) reads nothing."""
    ttok, tmask, any_t = ml._probe_masks(tgt_str, t0, tend, g1, g11, g2, g21)
    T = sp.shape[0]
    ns, nt = L1.shape
    si, ti = (sp + 1).long(), (ttok + 1).long()
    oks = (si >= 0) & (si < ns)
    okt = (ti >= 0) & (ti < nt) & tmask
    counted = (sp != -99).sum(dim=1, keepdim=True) > torch.arange(
        ml.SRCW, device=sp.device)
    pair = oks[:, :, None] & okt[:, None, :]
    at = (si[:, :, None] * nt + ti[:, None, :]).reshape(T, -1)
    l2_pos = torch.cat([at, si * nt], dim=1)
    l2_keep = torch.cat([(pair & counted[:, :, None]).reshape(T, -1),
                         oks & counted & any_t[:, None]], dim=1)
    l1_pos = torch.cat([at, ti], dim=1)
    l1_keep = torch.cat([pair.reshape(T, -1), okt], dim=1)
    return {"L1": (_slots(L1.reshape(-1), l1_pos), l1_keep),
            "L2": (_slots(L2.reshape(-1), l2_pos), l2_keep)}


def maxlex_dense_reads(L1, L2, tgt_str, sp, t0, tend, g1, g11, g2,
                       g21) -> int:
    """The table words that ``_accum_batch_dense`` needs over the rules
    beyond each rule's fixed input, target and output words
    (``maxlex_dense_need``)."""
    return count(maxlex_dense_need(L1, L2, tgt_str, sp, t0, tend, g1, g11,
                                   g2, g21), arrays=("L1", "L2"))


LCP_ARRAYS = ("refstr", "sa", "lcpl", "lcpr", "qtok")
# kernel B1's warp body (csrc/lcp.cuh kSearchLevels, kWalkLevels): a round
# of the search loads the words of the next SEARCH_LEVELS levels (31 nodes),
# one of a bound walk WALK_LEVELS (15); a compare round COMPARE_WIDTH tokens
SEARCH_LEVELS = 5
WALK_LEVELS = 4
COMPARE_WIDTH = 32


def lcp_need(refstr, sa, lcpleft, lcpright, qtok, *lanes) -> dict:
    """What B1's lanes need: pass 1 for ``lanes`` = (toks, suffixlens,
    reflen), pass 2 for (toks, matches, LLs, MMs, RRs) -> {array: (slots,
    keep)}, and per lane its search steps (``steps``), both walks' steps
    (``walk_steps``) and the chain of dependent read rounds that the
    kernel's warp body takes (``chain``).

    Per search step the skip words of the flavour it uses (the direct word
    where the bound is adjacent, else the midpoint tree's two words), and
    where the step compares (eq): its SA word and the query and corpus
    tokens up to where the compare stops; per walk step its skip words;
    pass 1 also the lane's first query token (the OOV test).  The chain:
    one round a ``SEARCH_LEVELS`` search steps, one a ``COMPARE_WIDTH``
    positions of each compare, and one a ``WALK_LEVELS`` steps of the
    longer walk (the two run side by side)."""
    need: dict = {}
    if len(lanes) == 3:
        passes.pass1_plain(refstr, sa, lcpleft, lcpright, qtok, *lanes,
                           need=need)
    else:
        passes.pass2_plain(refstr, sa, lcpleft, lcpright, qtok, *lanes,
                           need=need)
    arrays = dict(zip(LCP_ARRAYS, (refstr, sa, lcpleft, lcpright, qtok)))
    out = {name: (_slots(arr, torch.stack([p for p, _ in need[name]], 1)),
                  torch.stack([k for _, k in need[name]], 1))
           for name, arr in arrays.items() if name in need}
    zero = torch.zeros_like(lanes[0])

    def steps(key):
        return sum((act.to(zero.dtype) for act, _, _ in need.get(key, [])),
                   zero)
    up, down = steps("walk_up"), steps("walk_down")
    out["steps"] = steps("search")
    out["walk_steps"] = up + down
    compares = sum((torch.where(eq, d // COMPARE_WIDTH + 1, 0)
                    for eq, d in need.get("compare", [])), zero)
    out["chain"] = (-(-out["steps"] // SEARCH_LEVELS) + compares
                    + -(-torch.maximum(up, down) // WALK_LEVELS))
    return out


def lcp_reads(refstr, sa, lcpleft, lcpright, qtok, *lanes) -> tuple:
    """(words, search and walk steps, longest chain, mean chain) of B1's
    lanes (``lcp_need``)."""
    need = lcp_need(refstr, sa, lcpleft, lcpright, qtok, *lanes)
    chain = need["chain"]
    return (count(need, arrays=LCP_ARRAYS),
            int(need["steps"].sum() + need["walk_steps"].sum()),
            int(chain.max()) if chain.numel() else 0,
            float(chain.double().mean()) if chain.numel() else 0.0)


def dp_reads(refstr, sa, lcpleft, lcpright, qtok, toks, sls, reflen: int,
             cs, lm, rlp, lr_tar, mrs: int, msym: int) -> tuple:
    """B4's launch: B1's pass 1 on the lanes (``toks``, ``sls``) and A6's
    body on the items at corpus positions ``cs`` -> (words, lane search and
    walk steps, outer and inner growth steps, longest and mean chain); a
    corpus word that both halves read is one word."""
    lanes = lcp_need(refstr, sa, lcpleft, lcpright, qtok, toks, sls, reflen)
    items = contig_need(refstr, rlp, lr_tar, cs, lm, mrs, msym)
    chain = lanes["chain"]
    return (count(lanes, items, arrays=LCP_ARRAYS + ("rlp", "lr_tar")),
            int(lanes["steps"].sum() + lanes["walk_steps"].sum()),
            int(items["steps"].sum()), int(items["inner"].sum()),
            int(chain.max()) if chain.numel() else 0,
            float(chain.double().mean()) if chain.numel() else 0.0)


REFINE_ARRAYS = ("sa", "refstr", "qtok", "rmeta", "smeta")
# B2r's meta words a shard whose row it reads: rmeta's 2 and the rank
# slice's pointer (2 words), smeta's 3 and the token slice's pointer
RMETA_WORDS, SMETA_WORDS = 4, 5


def refine_need(*args) -> dict:
    """What the seeded refinement needs: A1 for ``args`` = (sa, refstr,
    qtok, toks, sls, lo, hi, d0, depths), B2r for (sidx, qtok, toks, sls,
    lo, hi, d0, depths) -> {array: (slots, keep)} and ``steps`` (int [n],
    the bisection steps of each lane).

    The words that the plain version's binary lower bounds read: each
    step's SA row and key token, and each depth's query token where the
    depth is inside the query and the interval is not empty.  The kernels'
    16-ary searches read more pivots; that is their choice, not the
    function's need.  On the sharded index the slots are those of the
    shards' slices (``sa``: shard s's rank slice at s * BR + loc,
    ``refstr``: its token slice), an index no shard owns reads nothing, and
    each read also needs its owner's meta row and slice pointer
    (``rmeta``, ``smeta``: ``RMETA_WORDS``, ``SMETA_WORDS`` a shard)."""
    need: dict = {}
    sharded = isinstance(args[0], shx.ShardedGrammarIndex)
    if sharded:
        shx.refine_sharded_plain(*args, need=need)
        qtok = args[1]
    else:
        passes.refine_chunk_plain(*args, need=need)
        sa, refstr, qtok = args[:3]
    rows = {name: (torch.stack([p for p, _ in need[name]], 1),
                   torch.stack([k for _, k in need[name]], 1))
            for name in need}
    qpos, qkeep = rows["qtok"]
    out = {"qtok": (_slots(qtok, qpos), qkeep),
           "steps": rows["sa"][1].sum(dim=1)}
    if not sharded:
        out["sa"] = (_slots(sa, rows["sa"][0]), rows["sa"][1])
        out["refstr"] = (_slots(refstr, rows["refstr"][0]),
                         rows["refstr"][1])
        return out
    sidx = args[0]
    S = sidx.S
    for name, per, meta, words in (("sa", sidx.BR, sidx.rmeta, RMETA_WORDS),
                                   ("refstr", sidx.B, sidx.smeta,
                                    SMETA_WORDS)):
        pos, keep = rows[name]
        length = (sidx.sa_l if name == "sa" else sidx.ref_l)[0].shape[0]
        m = torch.from_numpy(np.asarray(meta, np.int64)).to(pos.device)
        s = (pos.long() // per).clamp(max=S - 1).clamp(min=0)
        if name == "sa":     # (rank_start, rank_count)
            loc = pos.long() - m[s, 0]
            owned = (pos >= 0) & (loc >= 0) & (loc < m[s, 1])
        else:                # (src_off, own_lo, own_hi)
            loc = pos.long() - m[s, 0]
            owned = (pos >= 0) & (pos >= m[s, 1]) & (pos < m[s, 2])
        out[name] = (s * length + loc.clamp(0, length - 1), keep & owned)
        k = torch.arange(words, device=pos.device)
        meta_name = "rmeta" if name == "sa" else "smeta"
        out[meta_name] = ((s[..., None] * words + k).reshape(len(s), -1),
                          (keep & (pos >= 0))[..., None].expand(
                              *keep.shape, words).reshape(len(s), -1))
    return out


def refine_reads(*args) -> tuple:
    """(words, bisection steps) of the refinement's launch
    (``refine_need``)."""
    need = refine_need(*args)
    return (count(need, arrays=REFINE_ARRAYS), int(need["steps"].sum()))


def _pcs_words(refstr, pstart, plen, sl, el, mrs: int) -> tuple:
    """The corpus words ``_pcs_item`` needs, as the kernels' ``pcs_warp``
    reads them -> (positions, keep) [N, 4] for prefix words 1, 2 and suffix
    words 2, 3: none where the span budget fails, prefix word k
    (refstr[max(pstart - k, 0)]) where sl > k and pstart - k >= 0, suffix
    word k (refstr[pstart + plen + k - 1]) where el >= k."""
    budget = plen + 1 + sl - 1 + el - 1 <= mrs
    end = pstart + plen
    pos = torch.stack([pstart - 1, pstart - 2, end + 1, end + 2], dim=1)
    keep = torch.stack([budget & (sl > 1) & (pstart >= 1),
                        budget & (sl > 2) & (pstart >= 2),
                        budget & (el >= 2), budget & (el >= 3)], dim=1)
    return pos, keep


def pcs_need(kernel: str, *args) -> dict:
    """What the verification needs for one launch of ``kernel``: A3 with
    ``args`` = (refstr, pcrows, pattab, offs, n, mrs), B3p with (refstr,
    qtok, pstart, plen, sl, el, tok, stok, mrs), C1p with (refstr, pstart,
    plen, sl, el, pa1, pa2, pb2, pb3, mrs) -> {array: (slots, keep)}:

    * refstr: the corpus words ``_pcs_words`` names;
    * A3: every offs word (D + 1), the pattab rows (their 7 fields) of the
      patterns the items belong to, each item's precomputed row (2 words);
    * B3p: the query tokens compared with the needed corpus words.

    The item-axis columns (B3p's and C1p's) are each item's own inputs."""
    if kernel == "A3":
        refstr, pcrows, pattab, offs, n, mrs = args
        j = torch.arange(n, dtype=torch.int32, device=offs.device)
        p = (torch.searchsorted(offs, j, right=True) - 1).clamp(
            0, pattab.shape[0] - 1)
        f = pattab[p]
        row = (f[:, 0] + j - offs[p]).clamp(0, pcrows.shape[0] - 1)
        pstart, plen = pcrows[row, 0], pcrows[row, 1]
        sl, el = f[:, 1], f[:, 2]
        dev = offs.device
        offs_slots = torch.arange(offs.shape[0], device=dev)[None, :]
        need = {"offs": (offs_slots, torch.ones_like(offs_slots,
                                                     dtype=torch.bool)),
                "pattab": (p[:, None] * 8 + torch.arange(7, device=dev),
                           torch.ones((n, 7), dtype=torch.bool, device=dev)),
                "pcrows": (row[:, None].long() * 2
                           + torch.arange(2, device=dev),
                           torch.ones((n, 2), dtype=torch.bool, device=dev))}
    elif kernel == "B3p":
        refstr, qtok, pstart, plen, sl, el, tok, stok, mrs = args
        need = {}
    else:
        refstr, pstart, plen, sl, el = args[:5]
        mrs = args[9]
        need = {}
    pos, keep = _pcs_words(refstr, pstart, plen, sl, el, mrs)
    need["refstr"] = (_slots(refstr, pos, bounded=False), keep)
    if kernel == "B3p":
        qpos = torch.stack([tok + (sl - 2).clamp(min=0),
                            tok + (sl - 3).clamp(min=0), stok + 1, stok + 2],
                           dim=1)
        need["qtok"] = (_slots(qtok, qpos), keep)
    return need


PCS_ARRAYS = ("refstr", "offs", "pattab", "pcrows", "qtok")


def pcs_reads(kernel: str, *args) -> int:
    """The words the verification needs over one launch of ``kernel``
    (``pcs_need``), each distinct slot once."""
    return count(pcs_need(kernel, *args), arrays=PCS_ARRAYS)


# kernel A3's item resolution (csrc/scan.cu kPcsPivots, kPcsWindow): the
# warp's first item's search probes PCS_PIVOTS pivots a round, a window
# holds PCS_WINDOW patterns a round
PCS_PIVOTS = 32
PCS_WINDOW = 32
_OFFS_PAST = 2**31 - 1


def _window_start(offs, D: int, j: int) -> tuple:
    """``window_start_warp``: (the first window's start for item j, the
    search rounds it took): a 32-ary search over offs for the first word
    > j that stops once its range holds under PCS_WINDOW words."""
    a, b, rounds = 0, D + 1, 0
    while b - a >= PCS_WINDOW:
        rounds += 1
        piv = a + np.arange(PCS_PIVOTS) * (b - a) // PCS_PIVOTS
        gt = offs[piv] > j
        if not gt.any():
            a = int(piv[-1]) + 1
            continue
        f = int(gt.argmax())
        if f == 0:
            break
        a, b = int(piv[f - 1]) + 1, int(piv[f])
    return max(a - 1, 0), rounds


def pcs_rounds(offs, n: int) -> tuple:
    """A model of kernel A3's item resolution (``pcs_kernel``) on a
    launch's count prefix ``offs`` (int [D + 1]) and ``n`` items -> (the
    pattern row of each item, int64 [n]; the search rounds of each warp;
    the window rounds of each warp).  Per warp of 32 consecutive items: a
    32-ary search near its first item j0 gives the first window's start,
    at most 31 patterns before j0's; each window round holds the patterns
    base .. base + 31, and every item finds the last of them whose offs
    word is <= j by a bisection over the window; an item whose next word
    offs[base + 32] is still <= j waits for the next window, from base +
    32."""
    offs = np.asarray(offs, np.int64)
    D = len(offs) - 1
    pat = np.zeros(n, np.int64)
    searches, windows = [], []
    slot = np.arange(PCS_WINDOW)
    for j0 in range(0, n, 32):
        base, rounds = _window_start(offs, D, j0)
        js = np.arange(j0, min(j0 + 32, n))
        open_ = np.ones(len(js), bool)
        w = 0
        while open_.any():
            w += 1
            q = base + slot
            lo = np.where(q <= D, offs[np.minimum(q, D)], _OFFS_PAST)
            last = base + PCS_WINDOW
            hi = np.append(lo[1:], offs[last] if last <= D else _OFFS_PAST)
            k = np.zeros(len(js), np.int64)
            s = PCS_WINDOW // 2
            while s >= 1:
                k = np.where(lo[k + s] <= js, k + s, k)
                s //= 2
            here = open_ & (hi[k] > js)
            pat[js[here]] = np.minimum(base + k[here], D - 1)
            open_ &= ~here
            base += PCS_WINDOW
        searches.append(rounds)
        windows.append(w)
    return pat, np.array(searches), np.array(windows)


def probe_reads(ref_len: int, pos) -> int:
    """P1 and P2: the distinct words of a ``ref_len``-word corpus that the
    windows ``pos[i] + 0 .. pos[i] + 31``, each read clamped into it, cover.
    Clamping keeps a window one run of words, [clamp(p), clamp(p + 31)],
    and both ends grow with p, so the union is summed over the runs in
    the order of their positions: each run adds the words past the ends of
    the runs before it."""
    p = torch.sort(pos.long().reshape(-1)).values
    lo = p.clamp(0, ref_len - 1)
    hi = (p + gp.W - 1).clamp(0, ref_len - 1)
    before = torch.cat([hi.new_full((1,), -1), hi[:-1]])
    return int((hi - torch.maximum(lo, before + 1) + 1).clamp(min=0).sum())
