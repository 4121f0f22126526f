"""lookup1 and lookup2: the occurrences of every distinct one-gap pattern aXb
and two-gap pattern aXbXc.

Port of ``cgx_tpu/search/lookup.py`` (``one_gap_lookup_tpu``,
``two_gap_lookup_tpu``, ``_fill_salist``) and of the replicated engine's item
expansion (``cgx_tpu/engine.py``: ``_offsets``, ``expand_hits``,
``scan_expanded``, ``pcs_expanded``, ``two_expanded``).

lookup1: each one-gap pattern takes one of three routes, chosen on the host
from its SA intervals and the precomputed frequent pairs exactly as the JAX
package does:

* ``pc_ref``: a one-token a and b whose pair is precomputed -- one reference
  row to the precomp cell, no device work;
* ``pc_seed``: a longer pattern whose (last a, first b) pair is precomputed
  and rarer than both phrases -- kernel A3 (``pcs``) verifies each
  precomputed occurrence of the pair;
* scan: kernel A2 (``scan``) scans the 16 gap moves from every occurrence of
  the rarer phrase, forward from a or backward from b, with the target-side
  gap check fused in.  The JAX package's two-phase variant (``do_gap=False``,
  then a second dispatch for the candidates) lives inside A2: it runs the
  gap check only for items whose candidate mask is non-zero, which gives
  the same rows by construction.  ``scan_plain(..., gap=False)`` returns the
  candidate masks alone.

lookup2: kernel A5 (``two``) scans right from every occurrence of every
distinct one-gap pattern (precomputed cells expanded) for the second gap,
with the gap check fused in; the c token of each hit is resolved on the host
against the two-gap patterns that extend the core.

The kernels expand their item axis on the device from a per-pattern table
(``pattab``) and the exclusive count prefix (``offs``), and launch once over
all items.  The sharded index runs the same item bodies per item on one
shard's views (kernels B3f, B3b, B3p and B3t: ``fwd_items``, ``bwd_items``,
``pcs_items``, ``two_items``).  The column-upload variant (``scan_cols``,
the JAX package's ``CGX_SCAN_COLS``) materialises the items on the host and
uploads one column per field (kernels C1f, C1b and C1t: ``scan_cols``,
``two_packed``; C1p, ``pcs_cols``, has no caller, as in the JAX package).
The orchestrators reach each through an engine (``cgx_tpu_torch.engine``).
"""

from __future__ import annotations

import numpy as np
import torch

from cgx_tpu_torch.config import ExtractorConfig
from cgx_tpu_torch.kernels import build as kb
from cgx_tpu_torch.types import GapOnSA, OneGapSearch, Precomp, TwoGapSearch
from cgx_tpu_torch.utils.views import as_view, take

MMOV = 16  # move-axis width; real moves are bounded by max_rule_span - 2


def _mask_hits(mask, nbits=MMOV):
    """(item, move) indices of the set bits of a packed per-item bitmask."""
    m = np.ascontiguousarray(np.asarray(mask).view(np.uint32))
    bits = np.unpackbits(m.view(np.uint8).reshape(len(m), 4),
                         axis=1, bitorder="little")[:, :nbits]
    return np.nonzero(bits)


def _offsets(counts) -> np.ndarray:
    """Exclusive prefix [D+1] of per-pattern item counts."""
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def expand_hits(hit_idx, counts, ids=None):
    """Map flat item indices back to (pattern, tx) using the count prefix.
    ``ids`` optionally maps local pattern index -> caller pattern id."""
    cum = np.cumsum(counts)
    pi = np.searchsorted(cum, hit_idx, side="right")
    tx = hit_idx - (cum[pi] - counts[pi])
    pat = ids[pi] if ids is not None else pi
    return pat, tx, pi


# ---------------------------------------------------------------------------
# Plain PyTorch versions: every per-item quantity carries a leading item axis.
# ---------------------------------------------------------------------------

def pack_moves(ok: torch.Tensor) -> torch.Tensor:
    """[N, MMOV] bool -> int32 [N] bitmask (bit m = move m)."""
    moves = torch.arange(ok.shape[1], dtype=torch.int32, device=ok.device)
    return (ok.to(torch.int32) << moves).sum(dim=1, dtype=torch.int32)


def _pack_bits32(ok: torch.Tensor) -> torch.Tensor:
    """bool [N] -> int32 [ceil(N / 32)] holding uint32 words, bit k of word w
    = item 32 w + k."""
    n = ok.shape[0]
    pad = torch.zeros(-n % 32, dtype=torch.bool, device=ok.device)
    b = torch.cat([ok, pad]).view(-1, 32).to(torch.int64)
    w = (b << torch.arange(32, device=ok.device)).sum(dim=1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def _gap_first_test(rlp, fixed, base_off: int, mrs: int, grow_right: bool):
    """The RLP half of the fused gap check: the window positions ``ks``
    [N, mrs], their ``unal`` flags, the moves' first test ``ok1`` and target
    spans ``ts``, ``te`` [N, MMOV], and ``tempind``, the sentence anchor of
    the spans' start token [N]."""
    dev = fixed.device
    moves = torch.arange(MMOV, dtype=torch.int32, device=dev)
    w = torch.arange(mrs, dtype=torch.int32, device=dev)
    ks = fixed[:, None] + w if grow_right else fixed[:, None] - w
    t = take(rlp, ks)
    L = (t >> 24) & 0xFF
    R = (t >> 16) & 0xFF
    unal = (L == 255) | (R == 255) | (ks < 0)
    minL_pref = torch.cummin(torch.where(unal, 256, L), dim=1).values
    maxR_pref = torch.cummax(torch.where(unal, -1, R), dim=1).values
    span = base_off + moves
    off = span.clamp(0, mrs - 1).long()
    minL = minL_pref[:, off]
    maxR = maxR_pref[:, off]
    fail0 = unal[:, :1] | unal[:, off] | (span < 0) | (span > mrs - 1)
    start_tok = fixed if grow_right else fixed - base_off
    tempind = start_tok - ((take(rlp, start_tok) >> 8) & 0xFF) - 1
    stb = torch.where(tempind == -1, 0, take(rlp, tempind))
    ok1 = ~fail0 & (minL <= maxR) & (maxR - minL < mrs)
    return ks, unal, ok1, minL + stb[:, None], maxR + stb[:, None], tempind


def _gap_anchor(ok1, ts):
    """The lr_tar window's anchor: every valid target span lies in 16
    positions from the smallest start (0 with none)."""
    anchor = torch.where(ok1, ts, 2**30).amin(dim=1)
    return torch.where(anchor == 2**30, 0, anchor)


def gap_check_grow(rlp, lr_tar, fixed, base_off: int, mrs: int,
                   grow_right: bool):
    """Plain version of the fused gap check (``_gap_check_grow``;
    csrc/gapcheck.cuh ``gap_check_half``) -> bool [N, MMOV]: move m's
    span is [fixed, fixed + base_off + m] (grow_right) or
    [fixed - base_off - m, fixed]."""
    _, _, ok1, ts, te, tempind = _gap_first_test(rlp, fixed, base_off, mrs,
                                                 grow_right)
    moves = torch.arange(MMOV, dtype=torch.int32, device=fixed.device)
    win = _gap_anchor(ok1, ts)[:, None] + moves
    w2 = take(lr_tar, win)
    L2 = w2 >> 8
    R2 = w2 & 255
    al2 = (L2 != 255) & (R2 != 255)
    m2 = (win[:, None, :] >= ts[:, :, None]) \
        & (win[:, None, :] <= te[:, :, None]) & al2[:, None, :]
    bmin = torch.where(m2, L2[:, None, :], 256).amin(dim=2)
    bmax = torch.where(m2, R2[:, None, :], -1).amax(dim=2)
    f = fixed[:, None]
    span = base_off + moves
    src_start = f if grow_right else f - span
    src_end = f + span if grow_right else f
    s = (tempind + 1)[:, None]
    return ok1 & (s + bmin == src_start) & (s + bmax == src_end)


def _expand(pattab, offs, n: int):
    """Item j -> (pattern row of pattab, tx): the last pattern p with
    offs[p] <= j, clamped to [0, D - 1] (``_cumsum_expand``)."""
    j = torch.arange(n, dtype=torch.int32, device=offs.device)
    p = (torch.searchsorted(offs, j, right=True) - 1).clamp(
        0, pattab.shape[0] - 1)
    return pattab[p], j - offs[p]


def _scan_window(refstr, gostart, sl, mgs: int, fwd: bool):
    """-> (gap0_bad bool [N], win [N, MMOV + 2]): the gap-0 token's test and
    the corpus words that the moves and their verify shifts compare.  The
    reads keep the JAX bounds: ``ref[i]`` where the JAX body leaves ``i``
    unbounded, ``take`` or an explicit clamp where it bounds it
    (utils/views.py)."""
    ref = as_view(refstr)
    ks = torch.arange(MMOV + 2, dtype=torch.int32, device=gostart.device)
    if fwd:
        gap0_bad = ref[gostart + sl] < 2
        win = ref[((gostart + sl + mgs)[:, None] + ks).clamp(
            max=ref.shape[0] - 1)]
    else:
        gap0_bad = ref[(gostart - 1).clamp(min=0)] < 2
        pos = (gostart - 1 - mgs)[:, None] - ks
        win = torch.where(pos < 0, -1, ref[pos.clamp(min=0)])
    return gap0_bad, win


def _scan_cand(win, gap0_bad, sl, el, want, mrs: int, mgs: int, fwd: bool):
    """The scan of ``_fwd_item`` / ``_bwd_item`` on the window -> (cand bool
    [N, MMOV], read bool [N, MMOV + 2]): the candidate moves, and the window
    words that decide them.  Word m decides while move m is reached inside
    the span (a scan stops at its first dead move), word m + k where a
    live move m compares it."""
    side, other = (el, sl) if fwd else (sl, el)   # the compared side, the other
    moves = torch.arange(MMOV, dtype=torch.int32, device=win.device)
    temp = win[:, :MMOV]
    bad = temp < 2
    is_w = temp == want[:, 0:1]
    verify_ok = torch.ones_like(bad)
    verify_kill = torch.zeros_like(bad)
    compared = []
    for k in (1, 2):
        need = (side > k)[:, None]
        in_span = other[:, None] + mgs + moves + 1 + k <= mrs
        bo = win[:, k:MMOV + k]
        match = bo == want[:, k:k + 1]
        cmp_here = is_w & need & verify_ok & in_span
        compared.append(cmp_here)
        verify_ok = verify_ok & (~need | (in_span & match))
        verify_kill = verify_kill | (cmp_here & ~match & (bo < 2))
    # reach[m]: every earlier move survived (exclusive prefix AND)
    alive = torch.cumprod((~bad & ~verify_kill).to(torch.int32), dim=1) == 1
    reach = torch.cat([torch.ones_like(alive[:, :1]), alive[:, :-1]], dim=1)
    span_ok = (sl + mgs + el)[:, None] + moves <= mrs
    looked = reach & span_ok & ~gap0_bad[:, None]
    read = torch.nn.functional.pad(looked, (0, 2))
    for k, cmp_here in zip((1, 2), compared):
        read[:, k:MMOV + k] |= looked & ~bad & cmp_here
    return looked & ~bad & is_w & verify_ok, read


def _scan_body(refstr, rlp, lr_tar, gostart, sl, el, want, mrs: int,
               mgs: int, fwd: bool, gap: bool = True):
    """``_fwd_item`` / ``_bwd_item`` over N items -> bool [N, MMOV] of the
    moves whose scan and gap check pass (``gap=False``: whose scan passes,
    the candidates, as ``do_gap=False``); ``want`` holds the three compared
    query tokens per item ([N, 3])."""
    gap0_bad, win = _scan_window(refstr, gostart, sl, mgs, fwd)
    cand = _scan_cand(win, gap0_bad, sl, el, want, mrs, mgs, fwd)[0]
    if not gap:
        return cand
    fixed = gostart + sl if fwd else gostart - 1
    return cand & gap_check_grow(rlp, lr_tar, fixed, mgs - 1, mrs, fwd)


def _pcs_body(refstr, pstart, plen, sl, el, pa1, pa2, pb2, pb3, mrs: int):
    """``_pcs_item`` over N precomputed occurrences -> bool [N]."""
    ref = as_view(refstr)
    ok = plen + 1 + sl - 1 + el - 1 <= mrs
    for k, want in ((1, pa1), (2, pa2)):     # prefix: backoff 1..sl-1
        p = pstart - k
        good = (p >= 0) & (ref[p.clamp(min=0)] == want)
        ok = ok & (~(sl > k) | good)
    for k, want in ((2, pb2), (3, pb3)):     # suffix: forward 2..el
        good = ref[pstart + plen + k - 1] == want
        ok = ok & (~(el >= k) | good)
    return ok


def _two_cand(refstr, pstart, plen, mrs: int, mgs: int):
    """The scan of ``_two_item`` over N aXb occurrences -> (cand bool [N,
    MMOV], read bool [N, MMOV]): the candidate moves, and the move words
    that decide them (a scan stops at its first bad or killed move)."""
    ref = as_view(refstr)
    gostart = pstart + plen
    moves = torch.arange(MMOV, dtype=torch.int32, device=pstart.device)
    gap0_bad = ref[gostart + mgs] < 2
    temp = ref[((gostart + 1 + mgs)[:, None] + moves).clamp(
        max=ref.shape[0] - 1)]
    span_kill = (plen + 1 + mgs + 1)[:, None] + moves > mrs
    bad = temp < 2
    # reach[m]: every earlier move survived (exclusive prefix AND)
    alive = torch.cumprod((~bad & ~span_kill).to(torch.int32), dim=1) == 1
    reach = torch.cat([torch.ones_like(alive[:, :1]), alive[:, :-1]], dim=1)
    read = reach & ~gap0_bad[:, None] & ~span_kill
    return read & ~bad, read


def _two_body(refstr, rlp, lr_tar, pstart, plen, mrs: int, mgs: int):
    """``_two_item`` over N aXb occurrences -> (cand, gc) bool [N, MMOV]."""
    cand = _two_cand(refstr, pstart, plen, mrs, mgs)[0]
    return cand, gap_check_grow(rlp, lr_tar, pstart + plen + 1, mgs - 1, mrs,
                                True)


def scan_plain(refstr, rlp, lr_tar, sa, pattab, offs, n: int, mrs: int,
               mgs: int, fwd: bool, gap: bool = True):
    """Plain PyTorch version of kernel A2 -> int32 [n] move masks
    (``gap=False``: the candidate masks, before the gap check)."""
    f, tx = _expand(pattab, offs, n)
    return pack_moves(_scan_body(refstr, rlp, lr_tar, take(sa, f[:, 0] + tx),
                                 f[:, 1], f[:, 2], f[:, 3:6], mrs, mgs, fwd,
                                 gap))


def two_plain(refstr, rlp, lr_tar, ogrows, pcrows, pattab, offs, n: int,
              mrs: int, mgs: int):
    """Plain PyTorch version of kernel A5 -> int32 [n] words holding the
    uint32 bits ``cand | (gc << 16)``."""
    f, tx = _expand(pattab, offs, n)
    row = f[:, 0] + tx
    # both reads are clamped; the pcmode flag selects one
    sel = torch.where((f[:, 1] > 0)[:, None], take(pcrows, row),
                      take(ogrows, row))
    return two_packed_plain(refstr, rlp, lr_tar, sel[:, 0], sel[:, 1], mrs,
                            mgs)


def pcs_plain(refstr, pcrows, pattab, offs, n: int, mrs: int):
    """Plain PyTorch version of kernel A3 -> int32 [ceil(n / 32)] packed ok
    bits."""
    f, tx = _expand(pattab, offs, n)
    pr = take(pcrows, f[:, 0] + tx)
    return _pack_bits32(_pcs_body(refstr, pr[:, 0], pr[:, 1], f[:, 1],
                                  f[:, 2], f[:, 3], f[:, 4], f[:, 5], f[:, 6],
                                  mrs))


def _scan_want(qtok, qpos, sl, fwd: bool):
    """The compared query tokens of the per-item scans, gathered with the
    JAX clamp (``_qtok_fwd`` / ``_qtok_bwd``) -> [N, 3]."""
    if fwd:
        idx = [qpos, qpos + 1, qpos + 2]
    else:
        idx = [qpos + sl - 1, qpos + (sl - 2).clamp(min=0),
               qpos + (sl - 3).clamp(min=0)]
    return torch.stack([take(qtok, i) for i in idx], dim=1)


def scan_items_plain(refstr, rlp, lr_tar, qtok, gostart, sl, el, qpos,
                     mrs: int, mgs: int, fwd: bool, gap: bool = True):
    """Plain PyTorch version of kernels B3f (``fwd``, ``qpos`` = b's start)
    and B3b (``qpos`` = a's start) -> int32 [n] move masks (``gap=False``:
    the candidate masks, before the gap check)."""
    return pack_moves(_scan_body(refstr, rlp, lr_tar, gostart, sl, el,
                                 _scan_want(qtok, qpos, sl, fwd), mrs, mgs,
                                 fwd, gap))


def pcs_items_plain(refstr, qtok, pstart, plen, sl, el, tok, stok, mrs: int):
    """Plain PyTorch version of kernel B3p -> int32 [n] ok flags."""
    return _pcs_body(refstr, pstart, plen, sl, el,
                     take(qtok, tok + (sl - 2).clamp(min=0)),
                     take(qtok, tok + (sl - 3).clamp(min=0)),
                     take(qtok, stok + 1), take(qtok, stok + 2),
                     mrs).to(torch.int32)


def two_items_plain(refstr, rlp, lr_tar, pstart, plen, mrs: int, mgs: int):
    """Plain PyTorch version of kernel B3t -> int32 [2, n]: the candidate
    masks, then the gap-check masks."""
    cand, gc = _two_body(refstr, rlp, lr_tar, pstart, plen, mrs, mgs)
    return torch.stack([pack_moves(cand), pack_moves(gc)])


def _check_items(kernel, pattab, offs, n, width=8):
    if pattab.dim() != 2 or pattab.shape[1] != width or pattab.shape[0] < 1:
        raise ValueError(f"{kernel}: pattab must be int32 [D >= 1, {width}]")
    if offs.shape[0] != pattab.shape[0] + 1:
        raise ValueError(f"{kernel}: offs must have D + 1 entries")
    kb.check_count(kernel, n)


def scan(refstr, rlp, lr_tar, sa, pattab, offs, n: int, mrs: int, mgs: int,
         fwd: bool):
    """Kernel A2 (``csrc/scan.cu``, ``cgx_scan``): for each of the ``n``
    items of the patterns in ``pattab`` (int32 [D, 8]: SA-range lo, sl, el
    and the three compared query tokens) with count prefix ``offs`` (int32
    [D + 1]), the int32 mask of the gap moves whose scan and gap check pass.

    Replaces ``_scan_batch_exp`` (cgx_tpu/search/lookup.py:337).  On CUDA
    tensors it launches the kernel; on CPU tensors it runs ``scan_plain``."""
    device = offs.device
    if not kb.route("A2", device):
        return scan_plain(refstr, rlp, lr_tar, sa, pattab, offs, n, mrs, mgs,
                          fwd)
    kb.check_inputs("A2", device, torch.int32, refstr=refstr, rlp=rlp,
                    lr_tar=lr_tar, sa=sa, pattab=pattab, offs=offs)
    _check_items("A2", pattab, offs, n)
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        lib = kb.library("scan")
        kb.check("scan", lib.cgx_scan(
            kb.ptr(refstr), refstr.shape[0], kb.ptr(rlp), rlp.shape[0],
            kb.ptr(lr_tar), lr_tar.shape[0], kb.ptr(sa), sa.shape[0],
            kb.ptr(pattab), kb.ptr(offs), pattab.shape[0], n, mrs, mgs,
            int(fwd), kb.ptr(out), kb.stream(device)))
        kb.LAUNCHES["A2f" if fwd else "A2b"] += 1
    return out


def pcs(refstr, pcrows, pattab, offs, n: int, mrs: int):
    """Kernel A3 (``csrc/scan.cu``, ``cgx_pcs``): for each of the ``n``
    items (the precomputed occurrences ``pcrows`` (int32 [m, 2]: start, len)
    of each pattern's frequent pair, from row ``pattab[p, 0]`` on), whether
    the pattern's remaining a prefix and b suffix match; bits packed 32 per
    int32 word.

    Replaces ``_pcs_batch_exp`` (cgx_tpu/search/lookup.py:315).  On CUDA
    tensors it launches the kernel; on CPU tensors it runs ``pcs_plain``."""
    device = offs.device
    if not kb.route("A3", device):
        return pcs_plain(refstr, pcrows, pattab, offs, n, mrs)
    kb.check_inputs("A3", device, torch.int32, refstr=refstr, pcrows=pcrows,
                    pattab=pattab, offs=offs)
    _check_items("A3", pattab, offs, n)
    _check_rows("A3", pcrows=pcrows)
    out = torch.empty((n + 31) // 32, dtype=torch.int32, device=device)
    if n:
        lib = kb.library("scan")
        kb.check("scan", lib.cgx_pcs(
            kb.ptr(refstr), refstr.shape[0], kb.ptr(pcrows), pcrows.shape[0],
            kb.ptr(pattab), kb.ptr(offs), pattab.shape[0], n, mrs,
            kb.ptr(out), kb.stream(device)))
        kb.LAUNCHES["A3"] += 1
    return out


def _check_rows(kernel, **rows):
    for name, t in rows.items():
        if t.dim() != 2 or t.shape[1] != 2 or t.shape[0] < 1:
            raise ValueError(f"{kernel}: {name} must be int32 [m >= 1, 2]")


def two(refstr, rlp, lr_tar, ogrows, pcrows, pattab, offs, n: int, mrs: int,
        mgs: int):
    """Kernel A5 (``csrc/scan.cu``, ``cgx_two``): for each of the ``n``
    items (occurrence row ``pattab[p, 0] + tx`` of pattern p, read from the
    precomputed rows ``pcrows`` when ``pattab[p, 1]`` is set, else from the
    one-gap rows ``ogrows``, both int32 [m, 2] (start, len)), the scan for a
    second gap right of the aXb core and its fused gap check, as one int32
    word holding the uint32 bits ``cand | (gc << 16)``.

    Replaces ``_two_batch_exp`` (cgx_tpu/search/lookup.py:662).  On CUDA
    tensors it launches the kernel; on CPU tensors it runs ``two_plain``."""
    device = offs.device
    if not kb.route("A5", device):
        return two_plain(refstr, rlp, lr_tar, ogrows, pcrows, pattab, offs, n,
                         mrs, mgs)
    kb.check_inputs("A5", device, torch.int32, refstr=refstr, rlp=rlp,
                    lr_tar=lr_tar, ogrows=ogrows, pcrows=pcrows,
                    pattab=pattab, offs=offs)
    _check_items("A5", pattab, offs, n, width=2)
    _check_rows("A5", ogrows=ogrows, pcrows=pcrows)
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        lib = kb.library("scan")
        kb.check("scan", lib.cgx_two(
            kb.ptr(refstr), refstr.shape[0], kb.ptr(rlp), rlp.shape[0],
            kb.ptr(lr_tar), lr_tar.shape[0], kb.ptr(ogrows), ogrows.shape[0],
            kb.ptr(pcrows), pcrows.shape[0], kb.ptr(pattab), kb.ptr(offs),
            pattab.shape[0], n, mrs, mgs, kb.ptr(out), kb.stream(device)))
        kb.LAUNCHES["A5"] += 1
    return out


def _check_cols(kernel, n, *cols):
    if any(c.dim() != 1 or c.shape[0] != n for c in cols):
        raise ValueError(f"{kernel}: item arrays differ in length")
    kb.check_count(kernel, n)


def _scan_items(kernel, fn, refstr, rlp, lr_tar, qtok, gostart, sl, el, qpos,
                mrs, mgs, fwd):
    device = gostart.device
    if not kb.route(kernel, device):
        return scan_items_plain(refstr, rlp, lr_tar, qtok, gostart, sl, el,
                                qpos, mrs, mgs, fwd)
    kb.check_inputs(kernel, device, torch.int32, refstr=refstr, rlp=rlp,
                    lr_tar=lr_tar, qtok=qtok, gostart=gostart, sl=sl, el=el,
                    qpos=qpos)
    n = gostart.shape[0]
    _check_cols(kernel, n, sl, el, qpos)
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        lib = kb.library("scan")
        kb.check("scan", getattr(lib, fn)(
            *kb.view(refstr), *kb.view(rlp), *kb.view(lr_tar), kb.ptr(qtok),
            qtok.shape[0], kb.ptr(gostart), kb.ptr(sl), kb.ptr(el),
            kb.ptr(qpos), n, mrs, mgs, kb.ptr(out), kb.stream(device)))
        kb.LAUNCHES[kernel] += 1
    return out


def fwd_items(refstr, rlp, lr_tar, qtok, gostart, sl, el, stok, mrs: int,
              mgs: int):
    """Kernel B3f (``csrc/scan.cu``, ``cgx_fwd_items``): the forward scan of
    A2 for explicit items (occurrence ``gostart[i]`` of a, lengths ``sl[i]``,
    ``el[i]``, b's query position ``stok[i]`` into the padded query tokens
    ``qtok``) on views of one shard's slices -> int32 [n] move masks.  It
    runs A2's warp body ``scan_warp`` (a warp per 32 rows, a half-warp per
    item's window, the gap check only for items with a candidate) on rows
    loaded one column at a time.

    Replaces ``_fwd_batch`` (cgx_tpu/search/lookup.py:237).  On CUDA tensors
    it launches the kernel; on CPU tensors it runs ``scan_items_plain``."""
    return _scan_items("B3f", "cgx_fwd_items", refstr, rlp, lr_tar, qtok,
                       gostart, sl, el, stok, mrs, mgs, True)


def bwd_items(refstr, rlp, lr_tar, qtok, gostart, sl, el, tok, mrs: int,
              mgs: int):
    """Kernel B3b (``cgx_bwd_items``): the backward scan from occurrence
    ``gostart[i]`` of b, with a's query position ``tok[i]``, on the same
    warp body ``scan_warp`` as B3f.

    Replaces ``_bwd_batch`` (cgx_tpu/search/lookup.py:246)."""
    return _scan_items("B3b", "cgx_bwd_items", refstr, rlp, lr_tar, qtok,
                       gostart, sl, el, tok, mrs, mgs, False)


def pcs_items(refstr, qtok, pstart, plen, sl, el, tok, stok, mrs: int):
    """Kernel B3p (``csrc/scan.cu``, ``cgx_pcs_items``): A3's verification
    of explicit precomputed occurrences (``pstart[i]``, ``plen[i]``) of
    patterns with lengths ``sl[i]``, ``el[i]`` and query positions
    ``tok[i]``, ``stok[i]`` -> int32 [n], 1 where it verifies.

    Replaces ``_pcs_batch`` (cgx_tpu/search/lookup.py:255).  On CUDA tensors
    it launches the kernel; on CPU tensors it runs ``pcs_items_plain``."""
    device = pstart.device
    if not kb.route("B3p", device):
        return pcs_items_plain(refstr, qtok, pstart, plen, sl, el, tok, stok,
                               mrs)
    kb.check_inputs("B3p", device, torch.int32, refstr=refstr, qtok=qtok,
                    pstart=pstart, plen=plen, sl=sl, el=el, tok=tok,
                    stok=stok)
    n = pstart.shape[0]
    _check_cols("B3p", n, plen, sl, el, tok, stok)
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        lib = kb.library("scan")
        kb.check("scan", lib.cgx_pcs_items(
            *kb.view(refstr), kb.ptr(qtok), qtok.shape[0], kb.ptr(pstart),
            kb.ptr(plen), kb.ptr(sl), kb.ptr(el), kb.ptr(tok), kb.ptr(stok),
            n, mrs, kb.ptr(out), kb.stream(device)))
        kb.LAUNCHES["B3p"] += 1
    return out


def two_items(refstr, rlp, lr_tar, pstart, plen, mrs: int, mgs: int):
    """Kernel B3t (``csrc/scan.cu``, ``cgx_two_items``): A5's second-gap scan
    and gap check for explicit aXb occurrences (``pstart[i]``, ``plen[i]``)
    -> int32 [2, n]: the candidate masks, then the gap-check masks.

    Replaces ``_two_batch`` (cgx_tpu/search/lookup.py:643).  On CUDA tensors
    it launches the kernel; on CPU tensors it runs ``two_items_plain``."""
    device = pstart.device
    if not kb.route("B3t", device):
        return two_items_plain(refstr, rlp, lr_tar, pstart, plen, mrs, mgs)
    kb.check_inputs("B3t", device, torch.int32, refstr=refstr, rlp=rlp,
                    lr_tar=lr_tar, pstart=pstart, plen=plen)
    n = pstart.shape[0]
    _check_cols("B3t", n, plen)
    out = torch.empty((2, n), dtype=torch.int32, device=device)
    if n:
        lib = kb.library("scan")
        kb.check("scan", lib.cgx_two_items(
            *kb.view(refstr), *kb.view(rlp), *kb.view(lr_tar), kb.ptr(pstart),
            kb.ptr(plen), n, mrs, mgs, kb.ptr(out), kb.stream(device)))
        kb.LAUNCHES["B3t"] += 1
    return out


def scan_cols_plain(refstr, rlp, lr_tar, gostart, sl, el, w0, w1, w2,
                    mrs: int, mgs: int, fwd: bool, gap: bool = True):
    """Plain PyTorch version of kernels C1f (``fwd``) and C1b -> int32 [n]
    move masks (``gap=False``: the candidate masks, before the gap
    check)."""
    return pack_moves(_scan_body(refstr, rlp, lr_tar, gostart, sl, el,
                                 torch.stack([w0, w1, w2], dim=1), mrs, mgs,
                                 fwd, gap))


def pcs_cols_plain(refstr, pstart, plen, sl, el, pa1, pa2, pb2, pb3,
                   mrs: int):
    """Plain PyTorch version of kernel C1p -> int32 [ceil(n / 32)] packed ok
    bits."""
    return _pack_bits32(_pcs_body(refstr, pstart, plen, sl, el, pa1, pa2,
                                  pb2, pb3, mrs))


def two_packed_plain(refstr, rlp, lr_tar, pstart, plen, mrs: int, mgs: int):
    """Plain PyTorch version of kernel C1t -> int32 [n] words holding the
    uint32 bits ``cand | (gc << 16)``."""
    cand, gc = _two_body(refstr, rlp, lr_tar, pstart, plen, mrs, mgs)
    w = pack_moves(cand).long() | (pack_moves(gc).long() << 16)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def scan_cols(refstr, rlp, lr_tar, gostart, sl, el, w0, w1, w2, mrs: int,
              mgs: int, fwd: bool):
    """Kernels C1f (``fwd``) and C1b (``csrc/scan.cu``, ``cgx_scan_cols``):
    A2's scan for items given as columns materialised on the host: the
    occurrence ``gostart[i]`` (a's start forward, b's start backward),
    ``sl[i]``, ``el[i]`` and the three compared query tokens ``w0..w2[i]``
    (b's first three forward, a's last three reversed backward) -> int32
    [n] move masks, on A2's warp body ``scan_warp`` (a warp per 32 rows, a
    half-warp per item's window, the gap check only for items with a
    candidate).

    Replaces ``_scan_batch_cols`` (cgx_tpu/search/lookup.py:274).  On CUDA
    tensors it launches the kernel; on CPU tensors it runs
    ``scan_cols_plain``."""
    kernel = "C1f" if fwd else "C1b"
    device = gostart.device
    if not kb.route(kernel, device):
        return scan_cols_plain(refstr, rlp, lr_tar, gostart, sl, el, w0, w1,
                               w2, mrs, mgs, fwd)
    kb.check_inputs(kernel, device, torch.int32, refstr=refstr, rlp=rlp,
                    lr_tar=lr_tar, gostart=gostart, sl=sl, el=el, w0=w0,
                    w1=w1, w2=w2)
    n = gostart.shape[0]
    _check_cols(kernel, n, sl, el, w0, w1, w2)
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        lib = kb.library("scan")
        kb.check("scan", lib.cgx_scan_cols(
            kb.ptr(refstr), refstr.shape[0], kb.ptr(rlp), rlp.shape[0],
            kb.ptr(lr_tar), lr_tar.shape[0], kb.ptr(gostart), kb.ptr(sl),
            kb.ptr(el), kb.ptr(w0), kb.ptr(w1), kb.ptr(w2), n, mrs, mgs,
            int(fwd), kb.ptr(out), kb.stream(device)))
        kb.LAUNCHES[kernel] += 1
    return out


def pcs_cols(refstr, pstart, plen, sl, el, pa1, pa2, pb2, pb3, mrs: int):
    """Kernel C1p (``csrc/scan.cu``, ``cgx_pcs_cols``): A3's verification
    for items given as columns: the precomputed occurrence (``pstart[i]``,
    ``plen[i]``), ``sl[i]``, ``el[i]`` and the four compared query tokens
    -> int32 [ceil(n / 32)], the ok bits packed 32 per word (tail bits 0).

    Replaces ``_pcs_batch_cols`` (cgx_tpu/search/lookup.py:285), which no
    path of the JAX package calls; no path of the port does either.  On
    CUDA tensors it launches the kernel; on CPU tensors it runs
    ``pcs_cols_plain``."""
    device = pstart.device
    if not kb.route("C1p", device):
        return pcs_cols_plain(refstr, pstart, plen, sl, el, pa1, pa2, pb2,
                              pb3, mrs)
    kb.check_inputs("C1p", device, torch.int32, refstr=refstr, pstart=pstart,
                    plen=plen, sl=sl, el=el, pa1=pa1, pa2=pa2, pb2=pb2,
                    pb3=pb3)
    n = pstart.shape[0]
    _check_cols("C1p", n, plen, sl, el, pa1, pa2, pb2, pb3)
    out = torch.empty((n + 31) // 32, dtype=torch.int32, device=device)
    if n:
        lib = kb.library("scan")
        kb.check("scan", lib.cgx_pcs_cols(
            kb.ptr(refstr), refstr.shape[0], kb.ptr(pstart), kb.ptr(plen),
            kb.ptr(sl), kb.ptr(el), kb.ptr(pa1), kb.ptr(pa2), kb.ptr(pb2),
            kb.ptr(pb3), n, mrs, kb.ptr(out), kb.stream(device)))
        kb.LAUNCHES["C1p"] += 1
    return out


def two_packed(refstr, rlp, lr_tar, pstart, plen, mrs: int, mgs: int):
    """Kernel C1t (``csrc/scan.cu``, ``cgx_two_packed``): A5's second-gap
    scan and gap check for aXb occurrences given as columns (``pstart[i]``,
    ``plen[i]``) -> int32 [n] words holding the uint32 bits
    ``cand | (gc << 16)``.

    Replaces ``_two_batch_packed`` (cgx_tpu/search/lookup.py:650).  On CUDA
    tensors it launches the kernel; on CPU tensors it runs
    ``two_packed_plain``."""
    device = pstart.device
    if not kb.route("C1t", device):
        return two_packed_plain(refstr, rlp, lr_tar, pstart, plen, mrs, mgs)
    kb.check_inputs("C1t", device, torch.int32, refstr=refstr, rlp=rlp,
                    lr_tar=lr_tar, pstart=pstart, plen=plen)
    n = pstart.shape[0]
    _check_cols("C1t", n, plen)
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        lib = kb.library("scan")
        kb.check("scan", lib.cgx_two_packed(
            kb.ptr(refstr), refstr.shape[0], kb.ptr(rlp), rlp.shape[0],
            kb.ptr(lr_tar), lr_tar.shape[0], kb.ptr(pstart), kb.ptr(plen), n,
            mrs, mgs, kb.ptr(out), kb.stream(device)))
        kb.LAUNCHES["C1t"] += 1
    return out


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------

def one_gap_lookup(engine, queries, p1, p2, search: OneGapSearch,
                   pc: Precomp, cfg: ExtractorConfig) -> GapOnSA:
    """The occurrences of every distinct one-gap pattern, as rows
    (pattern, corpus start, length) sorted by (pattern, start, length);
    fills ``search.start_on_salist``/``end_on_salist``.  A precomp reference
    row has length 0 and the precomp cell as its start.  ``engine``
    (``cgx_tpu_torch.engine``) runs the device work."""
    mgs = cfg.min_gap_size
    qtok = np.asarray(queries.tokens)
    qpad = np.asarray(queries.padded_tokens()).astype(np.int64)
    sl_all = search.qrystart_len.astype(np.int64)
    el_all = search.qryend_len.astype(np.int64)
    tok_all = search.qrystart.astype(np.int64)
    stok_all = tok_all + search.gap.astype(np.int64) + sl_all

    # precomp cell per pattern (existPrecomputation)
    a_last = qtok[tok_all + sl_all - 1]
    b_first = qtok[stok_all]
    ia = np.searchsorted(pc.frequent_list, a_last)
    ib = np.searchsorted(pc.frequent_list, b_first)
    P = pc.P
    ok_a = (ia < P) & (pc.frequent_list[np.minimum(ia, P - 1)] == a_last)
    ok_b = (ib < P) & (pc.frequent_list[np.minimum(ib, P - 1)] == b_first)
    pci = np.where(ok_a & ok_b, ia * P + ib, -1)

    # SA ranges of the a and b phrases
    p2_up = p2.up if len(p2.up) else np.zeros(1, np.int32)
    p2_down = p2.down if len(p2.down) else np.zeros(1, np.int32)

    def rng(tk, ln):
        u = np.where(ln == 1, p1.up[tk], 0)
        d = np.where(ln == 1, p1.down[tk], 0)
        cc = np.where(ln > 1, p2.connectoffset[tk] + ln - 2, 0)
        u = np.where(ln == 1, u, p2_up[cc])
        d = np.where(ln == 1, d, p2_down[cc])
        return u.astype(np.int64), d.astype(np.int64)

    r1u, r1d = rng(tok_all, sl_all)
    r2u, r2d = rng(stok_all, el_all)
    dis1 = r1d - r1u
    dis2 = r2d - r2u
    use_fwd = dis1 <= dis2
    has_pc = pci != -1
    pc_dis = np.where(has_pc,
                      pc.index_end[np.maximum(pci, 0)]
                      - pc.index_start[np.maximum(pci, 0)], -1)
    pc_ref = has_pc & (sl_all == 1) & (el_all == 1) & (pc_dis >= 0)
    pc_seed = has_pc & ~pc_ref

    # cell-vs-interval routing: a pc_seed pattern whose rarer phrase has
    # fewer occurrences than its pair's cell takes the scan instead (the
    # scan covers every legal gap and checks the same target span, so the
    # rows are the same); a pattern whose phrase does not occur has no hits
    lm64 = p1.longestmatch.astype(np.int64)

    def phrase_valid(tk, ln):
        return np.where(ln == 1, p1.up[tk] >= 0, ln <= lm64[tk])

    phrase_ok = phrase_valid(tok_all, sl_all) \
        & phrase_valid(stok_all, el_all) & (dis1 >= 0) & (dis2 >= 0)
    routed = pc_seed & (~phrase_ok
                        | (np.minimum(dis1, dis2) + 1 < pc_dis + 1))
    pc_seed = pc_seed & ~routed
    scan_member = ~has_pc | (routed & phrase_ok)

    rows_parts = []
    # 1) precomp references: one row per pattern
    ref_ids = np.flatnonzero(pc_ref)
    if len(ref_ids):
        rows_parts.append(np.stack([
            ref_ids, pci[ref_ids], np.zeros(len(ref_ids), dtype=np.int64)],
            axis=1))

    # 2) precomp-seed verification (A3).  Jobs with equal kernel inputs
    # (cell, sl, el, the four compared tokens) run once; their hits go to
    # every member pattern.
    seed_ids = np.flatnonzero(pc_seed)
    if len(seed_ids):
        s64, e64 = sl_all[seed_ids], el_all[seed_ids]
        t64, st64 = tok_all[seed_ids], stok_all[seed_ids]
        key = np.stack([pci[seed_ids], s64, e64,
                        qpad[t64 + np.maximum(s64 - 2, 0)],
                        qpad[t64 + np.maximum(s64 - 3, 0)],
                        qpad[st64 + 1], qpad[st64 + 2]], axis=1)
        _, rep_ix, inv = np.unique(key, axis=0, return_index=True,
                                   return_inverse=True)
        inv = inv.reshape(-1)
        reps = seed_ids[rep_ix]
        counts_s = (pc_dis[reps] + 1).clip(min=0)
        ok = engine.pcs_expanded(queries, pc, pc.index_start[pci[reps]],
                                 counts_s, sl_all[reps], el_all[reps],
                                 tok_all[reps], stok_all[reps])
        hit = np.flatnonzero(ok)
        if len(hit):
            rgrp, tx, _ = expand_hits(hit, counts_s)
            hit_counts = np.bincount(rgrp, minlength=len(reps))
            gstart = np.concatenate([[0], np.cumsum(hit_counts)])[:-1]
            order = np.argsort(inv, kind="stable")
            members = seed_ids[order]
            mcounts = hit_counts[inv[order]]
            pat = np.repeat(members, mcounts)
            if len(pat):
                moffs = np.concatenate([[0], np.cumsum(mcounts)])[:-1]
                idx = (np.repeat(gstart[inv[order]], mcounts)
                       + np.arange(int(mcounts.sum()))
                       - np.repeat(moffs, mcounts))
                row = pc.index_start[pci[pat]] + tx[idx]
                spos = pc.onegap_start[row].astype(np.int64) - sl_all[pat] + 1
                length = pc.onegap_length[row].astype(np.int64) \
                    + sl_all[pat] - 1 + el_all[pat] - 1
                rows_parts.append(np.stack([pat, spos, length], axis=1))

    # 3) forward and backward scans (A2) from the rarer phrase
    for fwd in (True, False):
        ids = np.flatnonzero(scan_member & (use_fwd == fwd))
        if not len(ids):
            continue
        lo = np.where(fwd, r1u, r2u)[ids]
        counts = (np.where(fwd, dis1, dis2)[ids] + 1).clip(min=0)
        side = (stok_all if fwd else tok_all)[ids]
        mask = engine.scan_expanded(queries, fwd, lo, counts, sl_all[ids],
                                    el_all[ids], side)
        ii, mm = _mask_hits(mask)
        if not len(ii):
            continue
        pat, tx, pi = expand_hits(ii, counts, ids)
        gostart = engine.sa_values(lo[pi] + tx)
        if fwd:
            length = sl_all[pat] + mgs + mm + el_all[pat] - 1
            rows_parts.append(np.stack([pat, gostart, length], axis=1))
        else:
            spos = gostart - 1 - mgs - mm - sl_all[pat] + 1
            length = el_all[pat] + mgs + mm + sl_all[pat] - 1
            rows_parts.append(np.stack([pat, spos, length], axis=1))

    if rows_parts:
        rows = np.concatenate(rows_parts, axis=0)
        rows = rows[np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))]
    else:
        rows = np.empty((0, 3), dtype=np.int64)
    out = GapOnSA(position=rows[:, 0].astype(np.int32),
                  str_position=rows[:, 1].astype(np.int32),
                  length=rows[:, 2].astype(np.int32),
                  length2=np.zeros(len(rows), dtype=np.int32))
    _fill_salist(search.start_on_salist, search.end_on_salist, out.position)
    return out


def two_gap_items(search1: OneGapSearch, onegap_sa: GapOnSA, pc: Precomp):
    """Kernel A5's per-pattern table over the distinct one-gap patterns:
    (first occurrence row, item count, pcmode), int64/bool numpy [D].  A
    pattern whose lookup1 result is one precomp reference row (pcmode)
    reads its cell's precomputed occurrences, every other pattern its own
    lookup1 rows."""
    lo0 = search1.start_on_salist.astype(np.int64)
    hi0 = search1.end_on_salist.astype(np.int64)
    has = lo0 >= 0
    loc = np.clip(lo0, 0, max(len(onegap_sa.length) - 1, 0))
    if len(onegap_sa.length):
        pcmode = has & (hi0 == lo0) & (onegap_sa.length[loc] == 0)
        pci_t = onegap_sa.str_position[loc].astype(np.int64)
    else:
        pcmode = np.zeros_like(has)
        pci_t = np.zeros_like(lo0)
    pcic = np.clip(pci_t, 0, len(pc.index_start) - 1)
    lo = np.where(pcmode, pc.index_start[pcic], lo0)
    hi = np.where(pcmode, pc.index_end[pcic], hi0)
    return lo, np.where(has & (hi >= lo), hi - lo + 1, 0), pcmode


def two_gap_lookup(engine, queries, search1: OneGapSearch,
                   onegap_sa: GapOnSA, search2: TwoGapSearch, pc: Precomp,
                   cfg: ExtractorConfig, refstr_host: np.ndarray) -> GapOnSA:
    """The occurrences of every distinct two-gap pattern, as rows (pattern,
    corpus start, b's end offset, c's end offset) sorted by all four; fills
    ``search2.start_on_salist``/``end_on_salist``.

    Every distinct one-gap pattern's occurrences (precomputed cells
    expanded, unsampled) are scanned once by kernel A5; the c token of each
    hit is read from ``refstr_host`` (the host copy of the source token
    string) and matched against the (one-gap pattern, c token) pairs of the
    two-gap patterns.  ``engine`` as in ``one_gap_lookup``."""
    D2 = len(search2.blockid)
    mgs = cfg.min_gap_size
    empty = GapOnSA(*(np.empty(0, np.int32) for _ in range(4)))
    lo, counts, pcmode = two_gap_items(search1, onegap_sa, pc)
    if D2 == 0 or counts.sum() == 0:
        return empty
    cand_mask, gc_mask = engine.two_expanded(onegap_sa, pc, lo, counts,
                                             pcmode)
    # sorted (oneId, c-token) -> twoId table; distinct patterns are unique
    # pairs
    ctok = np.asarray(queries.tokens)[search2.gap2].astype(np.int64)
    keys = (search2.blockid.astype(np.int64) << 32) | ctok
    korder = np.argsort(keys, kind="stable")
    keys_sorted = keys[korder]
    ii, mm = _mask_hits(cand_mask)
    if not len(ii):
        return empty
    # occurrence fields and the scanned c token, recomputed at the hits only
    pat, tx, _ = expand_hits(ii, counts)
    row = lo[pat] + tx
    pcm_i = pcmode[pat]
    og_sp = onegap_sa.str_position if len(onegap_sa.str_position) \
        else np.zeros(1, np.int32)
    og_ln = onegap_sa.length if len(onegap_sa.length) \
        else np.zeros(1, np.int32)
    pc_sp = pc.onegap_start if len(pc.onegap_start) else np.zeros(1, np.int32)
    pc_ln = pc.onegap_length if len(pc.onegap_length) \
        else np.zeros(1, np.int32)
    css = np.where(pcm_i, pc_sp[np.clip(row, 0, len(pc_sp) - 1)],
                   og_sp[np.clip(row, 0, len(og_sp) - 1)]).astype(np.int64)
    fes = np.where(pcm_i, pc_ln[np.clip(row, 0, len(pc_ln) - 1)],
                   og_ln[np.clip(row, 0, len(og_ln) - 1)]).astype(np.int64)
    pos = css + fes + 1 + mgs + mm
    temp_hit = refstr_host[np.minimum(pos, len(refstr_host) - 1)]
    want = (pat.astype(np.int64) << 32) | temp_hit.astype(np.int64)
    ki = np.searchsorted(keys_sorted, want)
    found = (ki < len(keys_sorted)) & \
        (keys_sorted[np.minimum(ki, len(keys_sorted) - 1)] == want)
    hit = found & (((gc_mask[ii].astype(np.int64) >> mm) & 1) == 1)
    two_id = korder[np.minimum(ki, len(korder) - 1)][hit]
    length2 = fes + 1 + mgs + mm
    rows = np.stack([two_id, css[hit], fes[hit],
                     length2[hit].astype(np.int64)], axis=1)
    rows = rows[np.lexsort((rows[:, 3], rows[:, 2], rows[:, 1], rows[:, 0]))]
    out = GapOnSA(position=rows[:, 0].astype(np.int32),
                  str_position=rows[:, 1].astype(np.int32),
                  length=rows[:, 2].astype(np.int32),
                  length2=rows[:, 3].astype(np.int32))
    _fill_salist(search2.start_on_salist, search2.end_on_salist, out.position)
    return out


def _fill_salist(start_arr, end_arr, positions):
    if len(positions):
        uniq, first, counts = np.unique(positions, return_index=True,
                                        return_counts=True)
        start_arr[uniq] = first.astype(np.int32)
        end_arr[uniq] = (first + counts - 1).astype(np.int32)
