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
  candidate masks alone.  On the replicated engine kernel A2m
  (``scan_count``, ``scan_keys``; ``scan_rows`` with the sort) runs A2's
  body and writes each kept move as one packed int64 row key on the
  device, and only the sorted rows come down.

lookup2: kernel A5 (``two``) scans right from every occurrence of every
distinct one-gap pattern (precomputed cells expanded) for the second gap,
with the gap check fused in; the c token of each hit is resolved on the host
against the two-gap patterns that extend the core.  On the replicated
engine kernel A5m (``two_rows``) runs A5's body and resolves the c tokens
on the device, and only the kept rows come down.

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

import dataclasses

import numpy as np
import torch

from cgx_tpu_torch.config import ExtractorConfig
from cgx_tpu_torch.kernels import build as kb
from cgx_tpu_torch.types import GapOnSA, OneGapSearch, Precomp, TwoGapSearch
from cgx_tpu_torch.utils.timing import child
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


def _pattern_of(pattab, offs, j):
    """Items ``j`` -> their patterns: the last p with offs[p] <= j, clamped
    to [0, D - 1] (``_cumsum_expand``)."""
    return (torch.searchsorted(offs, j, right=True) - 1).clamp(
        0, pattab.shape[0] - 1)


def _expand(pattab, offs, n: int):
    """Item j -> (pattern row of pattab, tx) (``_pattern_of``)."""
    j = torch.arange(n, dtype=torch.int32, device=offs.device)
    p = _pattern_of(pattab, offs, j)
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


def _two_occurrences(ogrows, pcrows, pattab, offs, j):
    """A5's items ``j`` -> (their patterns, the occurrence rows (start, len)
    [N, 2]): row pattab[p, 0] + j - offs[p] of the precomputed rows where
    the pattern's pcmode flag is set, else of the one-gap rows."""
    p = _pattern_of(pattab, offs, j)
    f = pattab[p]
    row = f[:, 0] + j - offs[p]
    # both reads are clamped; the pcmode flag selects one
    return p, torch.where((f[:, 1] > 0)[:, None], take(pcrows, row),
                          take(ogrows, row))


def two_plain(refstr, rlp, lr_tar, ogrows, pcrows, pattab, offs, n: int,
              mrs: int, mgs: int):
    """Plain PyTorch version of kernel A5 -> int32 [n] words holding the
    uint32 bits ``cand | (gc << 16)``."""
    j = torch.arange(n, dtype=torch.int32, device=offs.device)
    sel = _two_occurrences(ogrows, pcrows, pattab, offs, j)[1]
    return two_packed_plain(refstr, rlp, lr_tar, sel[:, 0], sel[:, 1], mrs,
                            mgs)


def two_rows_plain(refstr, rlp, lr_tar, ogrows, pcrows, pattab, offs, n: int,
                   mrs: int, mgs: int, kptr, kctok, kid):
    """Plain PyTorch version of kernel A5m -> its rows, int32 [R, 3]: two_id,
    pstart, plen | (move << 16), in (item, move) order.  A move is kept
    where it is A5's candidate, passes the gap check, and its move word
    (the c token) is one of its pattern's keys kctok[kptr[p] .. kptr[p +
    1]) (clamped into the keys; ascending, distinct), found by an int32
    lower-bound bisection; the row's two_id is that key's ``kid``."""
    j = torch.arange(n, dtype=torch.int32, device=offs.device)
    p, occ = _two_occurrences(ogrows, pcrows, pattab, offs, j)
    pstart, plen = occ[:, 0], occ[:, 1]
    cand, gc = _two_body(refstr, rlp, lr_tar, pstart, plen, mrs, mgs)
    ii, mm = torch.nonzero(cand & gc, as_tuple=True)
    ref = as_view(refstr)
    word = ref[(pstart[ii] + plen[ii] + 1 + mgs + mm).clamp(
        max=ref.shape[0] - 1)]
    nk = kctok.shape[0]
    klo = kptr[p[ii]].clamp(0, nk)
    khi = torch.maximum(kptr[p[ii] + 1].clamp(0, nk), klo)
    lo, hi = klo.clone(), khi.clone()
    while bool((lo < hi).any()):
        live = lo < hi
        mid = (lo + hi) >> 1
        less = take(kctok, mid) < word
        lo = torch.where(live & less, mid + 1, lo)
        hi = torch.where(live & ~less, mid, hi)
    found = (lo < khi) & (take(kctok, lo) == word)
    ii, mm, k = ii[found], mm[found], lo[found]
    return torch.stack([take(kid, k), pstart[ii],
                        plen[ii] | (mm.to(torch.int32) << 16)],
                       dim=1).to(torch.int32)


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
        kb.launch(
            "scan", "cgx_scan", device, kb.ptr(refstr), refstr.shape[0],
            kb.ptr(rlp), rlp.shape[0], kb.ptr(lr_tar), lr_tar.shape[0],
            kb.ptr(sa), sa.shape[0], kb.ptr(pattab), kb.ptr(offs),
            pattab.shape[0], n, mrs, mgs, int(fwd), kb.ptr(out))
        kb.counted("A2f" if fwd else "A2b", n,
                   kb.nbytes(pattab, offs, out))
    return out


@dataclasses.dataclass(frozen=True)
class RowKey:
    """lookup1's row (pattern, start, length) packed into one int64 key,
    ``(pattern << sh_pat) | ((start + bias) << sh_len) | length``, with
    field widths taken from the data (``fit``).  A lookup's rows are unique,
    so sorting their keys gives the order of the lexsort by (pattern,
    start, length), and no argsort or stable sort is needed.  ``pack`` and
    ``unpack`` take numpy or torch int64 arrays; kernel A2m packs the same
    way."""
    sh_len: int
    sh_pat: int
    bias: int
    bits: int       # the key's width: sh_pat and the pattern's bits

    @classmethod
    def fit(cls, n_patterns: int, start_lo: int, start_hi: int,
            length_hi: int) -> "RowKey":
        """The layout of patterns in [0, n_patterns), starts in
        [start_lo, start_hi] and lengths in [0, length_hi].  Starts are
        int32 and lengths below the span limit, so the key passes 63 bits
        only past about 2^26 patterns in one lookup: ValueError then."""
        bias = max(-int(start_lo), 0)
        sh_len = max(int(length_hi).bit_length(), 1)
        sh_pat = sh_len + max(int(start_hi + bias).bit_length(), 1)
        bits = sh_pat + max(int(n_patterns) - 1, 1).bit_length()
        if bits > 63:
            raise ValueError(f"lookup1's row key needs {bits} bits "
                             f"({n_patterns} patterns)")
        return cls(sh_len, sh_pat, bias, bits)

    def pack(self, pat, start, length):
        return (pat << self.sh_pat) | ((start + self.bias) << self.sh_len) \
            | length

    def unpack(self, keys) -> tuple:
        """-> (pattern, start, length), int64 each."""
        smask = (1 << (self.sh_pat - self.sh_len)) - 1
        return (keys >> self.sh_pat,
                ((keys >> self.sh_len) & smask) - self.bias,
                keys & ((1 << self.sh_len) - 1))


def device_row_key(n_patterns: int, corpus_len: int, mrs: int,
                   host_rows) -> RowKey:
    """The layout of A2m's route, fixed before its kernels run: its scan
    rows start in [1 - mrs, corpus_len - 1] (a backward row's a phrase ends
    at or after the corpus start, its sl <= mrs) and are shorter than mrs
    (the scan's span limit); the host rows ``host_rows`` (int64 [R, 3]) are
    fitted as they are."""
    lo, hi, ln = 1 - mrs, corpus_len - 1, mrs - 1
    if len(host_rows):
        lo = min(lo, int(host_rows[:, 1].min()))
        hi = max(hi, int(host_rows[:, 1].max()))
        ln = max(ln, int(host_rows[:, 2].max()))
    return RowKey.fit(n_patterns, lo, hi, ln)


def _scan_hits(refstr, rlp, lr_tar, sa, pattab, offs, n: int, mrs: int,
               mgs: int, fwd: bool):
    """A2's items and their kept moves -> (pattern rows f [n, 8], SA words
    [n], ok bool [n, MMOV])."""
    f, tx = _expand(pattab, offs, n)
    gostart = take(sa, f[:, 0] + tx)
    return f, gostart, _scan_body(refstr, rlp, lr_tar, gostart, f[:, 1],
                                  f[:, 2], f[:, 3:6], mrs, mgs, fwd)


def scan_count_plain(refstr, rlp, lr_tar, sa, pattab, offs, n: int, mrs: int,
                     mgs: int, fwd: bool):
    """Plain PyTorch version of kernel A2m's count pass -> int32
    [ceil(n / 32)], the kept moves of each warp's 32 items."""
    ok = _scan_hits(refstr, rlp, lr_tar, sa, pattab, offs, n, mrs, mgs,
                    fwd)[2]
    c = ok.sum(dim=1, dtype=torch.int32)
    pad = torch.zeros(-n % 32, dtype=torch.int32, device=c.device)
    return torch.cat([c, pad]).view(-1, 32).sum(dim=1, dtype=torch.int32)


def scan_rows_plain(refstr, rlp, lr_tar, sa, pattab, offs, n: int, mrs: int,
                    mgs: int, fwd: bool, key: RowKey):
    """Plain PyTorch version of kernel A2m's write pass over all its rows
    -> int64 [R] keys in (item, move) order: each kept move m of an item of
    pattern row p (A2's table, with the caller's pattern id in pattab[p,
    6]) as the row (pattern id, start, length), start = the SA word
    forward, the word - mgs - m - sl backward, length = sl + mgs + m + el -
    1, packed by ``key``."""
    f, gostart, ok = _scan_hits(refstr, rlp, lr_tar, sa, pattab, offs, n,
                                mrs, mgs, fwd)
    ii, mm = torch.nonzero(ok, as_tuple=True)
    g, sl, el = (c[ii].long() for c in (gostart, f[:, 1], f[:, 2]))
    start = g if fwd else g - mgs - mm - sl
    return key.pack(f[ii, 6].long(), start, sl + mgs + mm + el - 1)


def scan_count(refstr, rlp, lr_tar, sa, pattab, offs, n: int, mrs: int,
               mgs: int, fwd: bool):
    """Kernel A2m's count pass (``csrc/scan.cu``, ``cgx_scan_count``) over
    A2's items (arguments as ``scan``, the caller's pattern id in pattab
    column 6) -> int64 [ceil(n / 32) + 1] on the items' device: the
    exclusive prefix of each warp's rows, the total last.  On CPU tensors
    the counts come from ``scan_count_plain``."""
    device = offs.device
    if not kb.route("A2m", device):
        counts = scan_count_plain(refstr, rlp, lr_tar, sa, pattab, offs, n,
                                  mrs, mgs, fwd)
    else:
        kb.check_inputs("A2m", device, torch.int32, refstr=refstr, rlp=rlp,
                        lr_tar=lr_tar, sa=sa, pattab=pattab, offs=offs)
        _check_items("A2m", pattab, offs, n)
        counts = torch.empty((n + 31) // 32, dtype=torch.int32,
                             device=device)
        if n:
            kb.launch(
                "scan", "cgx_scan_count", device, kb.ptr(refstr),
                refstr.shape[0], kb.ptr(rlp), rlp.shape[0], kb.ptr(lr_tar),
                lr_tar.shape[0], kb.ptr(sa), sa.shape[0], kb.ptr(pattab),
                kb.ptr(offs), pattab.shape[0], n, mrs, mgs, int(fwd),
                kb.ptr(counts))
            # the per-pattern tables once a scan
            kb.counted("A2m", n, kb.nbytes(pattab, offs, counts))
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                      torch.cumsum(counts, 0, dtype=torch.int64)])


def scan_keys(refstr, rlp, lr_tar, sa, pattab, offs, n: int, mrs: int,
              mgs: int, fwd: bool, woff, key: RowKey, out) -> None:
    """Kernel A2m's write pass (``csrc/scan.cu``, ``cgx_scan_rows``): the
    scan's rows (as many as ``woff``, the count pass's prefix, totals), in
    (item, move) order, as int64 keys packed by ``key`` into ``out`` (an
    int64 tensor of that many keys on the items' device).  On CPU tensors
    it runs ``scan_rows_plain``."""
    device = offs.device
    if not kb.route("A2m", device):
        out[:] = scan_rows_plain(refstr, rlp, lr_tar, sa, pattab, offs, n,
                                 mrs, mgs, fwd, key)
        return
    kb.check_inputs("A2m", device, torch.int64, woff=woff, out=out)
    if out.dim() != 1:
        raise ValueError("A2m: out must be int64 [rows]")
    if out.shape[0]:
        kb.launch(
            "scan", "cgx_scan_rows", device, kb.ptr(refstr), refstr.shape[0],
            kb.ptr(rlp), rlp.shape[0], kb.ptr(lr_tar), lr_tar.shape[0],
            kb.ptr(sa), sa.shape[0], kb.ptr(pattab), kb.ptr(offs),
            pattab.shape[0], n, mrs, mgs, int(fwd), kb.ptr(woff), key.sh_pat,
            key.sh_len, key.bias, kb.ptr(out))
        # every warp reads its prefix pair; each row 8 bytes
        kb.counted("A2m", n, kb.nbytes(woff) + 8 * out.shape[0])


# the keys a block of kernel A2s's passes sorts (csrc/sort.cu kTile)
SORT_TILE = 4096


def sort_keys_plain(keys, bits: int):
    """Plain PyTorch version of kernel A2s's passes -> ``keys`` sorted."""
    return torch.sort(keys).values


def unpack_keys_plain(keys, key: RowKey):
    """Plain PyTorch version of kernel A2s's unpacking -> int32 [3, n]."""
    return torch.stack(key.unpack(keys)).to(torch.int32)


def sort_keys(keys, bits: int):
    """Kernel A2s's passes (``csrc/sort.cu``, ``cgx_sort_hist`` and
    ``cgx_sort_scatter``): the non-negative int64 ``keys`` below
    ``2**bits``, sorted ascending by a least-significant-digit radix sort
    over 8-bit digits, one pass a digit, between ``keys`` and one more
    buffer (which of the two holds the result depends on the passes'
    parity: drop ``keys`` after the call).  Replaces no TPU kernel (the
    JAX package lexsorts lookup1's rows on the host).  On CUDA tensors it
    launches the kernels; on CPU tensors it runs ``sort_keys_plain``."""
    device = keys.device
    if not kb.route("A2s", device):
        return sort_keys_plain(keys, bits)
    kb.check_inputs("A2s", device, torch.int64, keys=keys)
    n = keys.shape[0]
    kb.check_count("A2s", n)
    if n == 0 or not 1 <= bits <= 63:
        return keys
    tiles = -(-n // SORT_TILE)
    hist = torch.empty(256 * tiles, dtype=torch.int32, device=device)
    src, dst = keys, torch.empty_like(keys)
    for shift in range(0, bits, 8):
        kb.launch("sort", "cgx_sort_hist", device, kb.ptr(src), n, shift,
                  kb.ptr(hist))
        kb.counted("A2s", n, kb.nbytes(src, hist))
        offs = torch.cumsum(hist, 0, dtype=torch.int32) - hist
        kb.launch("sort", "cgx_sort_scatter", device, kb.ptr(src), n, shift,
                  kb.ptr(offs), kb.ptr(dst))
        kb.counted("A2s", n, kb.nbytes(src, offs, dst))
        src, dst = dst, src
    return src


def unpack_keys(keys, key: RowKey):
    """Kernel A2s's unpacking (``csrc/sort.cu``, ``cgx_unpack_rows``): the
    int64 row keys packed by ``key`` -> int32 [3, n] on their device:
    pattern, start, length.  On CPU tensors it runs
    ``unpack_keys_plain``."""
    device = keys.device
    if not kb.route("A2s", device):
        return unpack_keys_plain(keys, key)
    kb.check_inputs("A2s", device, torch.int64, keys=keys)
    n = keys.shape[0]
    kb.check_count("A2s", n)
    cols = torch.empty((3, n), dtype=torch.int32, device=device)
    if n:
        kb.launch("sort", "cgx_unpack_rows", device, kb.ptr(keys), n,
                  key.sh_pat, key.sh_len, key.bias, kb.ptr(cols))
        kb.counted("A2s", n, kb.nbytes(keys, cols))
    return cols


def scan_rows(refstr, rlp, lr_tar, sa, scans, host_keys, key: RowKey,
              mrs: int, mgs: int):
    """Kernel A2m over lookup1's scans and the sort of all its rows on
    their device -> int32 numpy [3, R]: the rows' pattern, start and
    length, sorted by ``key``.

    ``scans`` lists (pattab, offs, n, fwd): A2's tables on the device (the
    caller's pattern id in pattab column 6); ``host_keys`` (int64 numpy)
    the keys of the rows built on the host (precomputed references and
    A3's).  Each scan's count pass runs and the totals come down in one
    copy; every key is written into one device buffer after the host
    keys, sorted and unpacked there (kernel A2s), and the columns come
    down once.  The working set, 16 bytes a key in the sort and 20 in the
    unpacking, stays under A2's mask column of 4 bytes an item of the
    larger scan while a lookup keeps fewer than a fifth as many rows as
    it scans items (a Europarl request: 0.18).  Replaces no TPU kernel
    (the JAX package builds and lexsorts the rows on the host,
    cgx_tpu/search/lookup.py one_gap_lookup_tpu).  On CPU tensors the
    passes run ``scan_count`` and ``scan_keys``'s plain versions."""
    device = sa.device
    ix = (refstr, rlp, lr_tar, sa)
    woffs = [scan_count(*ix, pattab, offs, n, mrs, mgs, fwd)
             for pattab, offs, n, fwd in scans]
    totals = (kb.to_host(torch.cat([w[-1:] for w in woffs])).tolist()
              if woffs else [])
    nh = len(host_keys)
    keys = torch.empty(nh + sum(totals), dtype=torch.int64, device=device)
    keys[:nh] = kb.to_device(np.asarray(host_keys, np.int64), device)
    r = nh
    for (pattab, offs, n, fwd), t in zip(scans, totals):
        # each prefix is freed once its write pass has run
        scan_keys(*ix, pattab, offs, n, mrs, mgs, fwd, woffs.pop(0), key,
                  keys[r:r + t])
        r += t
    keys = sort_keys(keys, key.bits)
    cols = unpack_keys(keys, key)
    del keys
    return kb.to_host(cols).numpy()


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
        kb.launch(
            "scan", "cgx_pcs", device, kb.ptr(refstr), refstr.shape[0],
            kb.ptr(pcrows), pcrows.shape[0], kb.ptr(pattab), kb.ptr(offs),
            pattab.shape[0], n, mrs, kb.ptr(out))
        kb.counted("A3", n, kb.nbytes(pattab, offs, out))
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
        kb.launch(
            "scan", "cgx_two", device, kb.ptr(refstr), refstr.shape[0],
            kb.ptr(rlp), rlp.shape[0], kb.ptr(lr_tar), lr_tar.shape[0],
            kb.ptr(ogrows), ogrows.shape[0], kb.ptr(pcrows), pcrows.shape[0],
            kb.ptr(pattab), kb.ptr(offs), pattab.shape[0], n, mrs, mgs,
            kb.ptr(out))
        kb.counted("A5", n, kb.nbytes(pattab, offs, out))
    return out


def _row_budget(n: int) -> int:
    """A5m's write-pass rows a range by default: what A5's word column of
    ``n`` items (4 bytes an item) holds, less the warp counts and their
    exclusive prefix (4 and 8 bytes a warp, 8 more), at 12 bytes a row; at
    least 1."""
    W = (n + 31) // 32
    return max(1, (4 * n - 12 * W - 8) // 12)


def two_rows(refstr, rlp, lr_tar, ogrows, pcrows, pattab, offs, n: int,
             mrs: int, mgs: int, kptr, kctok, kid, row_budget: int = None):
    """Kernel A5m (``csrc/scan.cu``, ``cgx_two_count`` and
    ``cgx_two_rows``): A5's scan and gap check over A5's items (arguments as
    ``two``), each kept move's c token matched on the device against its
    one-gap pattern's keys (``kptr`` int32 [D + 1]: pattern p's keys are
    ``kctok[kptr[p] .. kptr[p + 1])``, ascending; ``kid`` each key's
    two-gap id) -> the kept rows on the host, int32 [R, 3]: two_id,
    pstart, plen | (move << 16), in (item, move) order.

    The count pass gives each warp's rows, their exclusive prefix is taken
    on the device and its total copied down; the write pass then runs over
    row ranges of at most ``row_budget`` rows (default ``_row_budget``, so
    that lookup2 holds no more on the device than A5's word column) into
    one reused buffer, each range copied down.  Replaces no TPU kernel (the
    JAX package matches on the host, cgx_tpu/search/lookup.py:727-757).
    On CUDA tensors it launches the kernel; on CPU tensors it runs
    ``two_rows_plain`` (all rows at once)."""
    device = offs.device
    if not kb.route("A5m", device):
        return two_rows_plain(refstr, rlp, lr_tar, ogrows, pcrows, pattab,
                              offs, n, mrs, mgs, kptr, kctok, kid)
    kb.check_inputs("A5m", device, torch.int32, refstr=refstr, rlp=rlp,
                    lr_tar=lr_tar, ogrows=ogrows, pcrows=pcrows,
                    pattab=pattab, offs=offs, kptr=kptr, kctok=kctok,
                    kid=kid)
    _check_items("A5m", pattab, offs, n, width=2)
    _check_rows("A5m", ogrows=ogrows, pcrows=pcrows)
    if kptr.shape[0] != pattab.shape[0] + 1:
        raise ValueError("A5m: kptr must have D + 1 entries")
    if kctok.dim() != 1 or kctok.shape[0] < 1 or kid.shape != kctok.shape:
        raise ValueError("A5m: kctok and kid must be int32 [nk >= 1]")
    ix = (kb.ptr(refstr), refstr.shape[0], kb.ptr(rlp), rlp.shape[0],
          kb.ptr(lr_tar), lr_tar.shape[0], kb.ptr(ogrows), ogrows.shape[0],
          kb.ptr(pcrows), pcrows.shape[0], kb.ptr(pattab), kb.ptr(offs),
          pattab.shape[0], kb.ptr(kptr), kb.ptr(kctok))
    W = (n + 31) // 32
    counts = torch.empty(W, dtype=torch.int32, device=device)
    if n:
        kb.launch("scan", "cgx_two_count", device, *ix, kctok.shape[0], n,
                  mrs, mgs, kb.ptr(counts))
        # the per-pattern tables once a lookup2 (kctok is only bisected)
        kb.counted("A5m", n, kb.nbytes(pattab, offs, kptr, counts))
    woff = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                      torch.cumsum(counts, 0, dtype=torch.int64)])
    total = int(kb.to_host(woff[W:])[0])
    budget = row_budget or _row_budget(n)
    out = np.empty((total, 3), np.int32)
    if total:
        buf = torch.empty((min(budget, total), 3), dtype=torch.int32,
                          device=device)
    for r0 in range(0, total, budget):
        r1 = min(r0 + budget, total)
        kb.launch("scan", "cgx_two_rows", device, *ix, kb.ptr(kid),
                  kctok.shape[0], n, mrs, mgs, kb.ptr(woff), r0, r1,
                  kb.ptr(buf))
        # every warp reads its prefix pair; each row its kid and 12 bytes
        kb.counted("A5m", n, kb.nbytes(woff) + 16 * (r1 - r0))
        out[r0:r1] = kb.to_host(buf[:r1 - r0]).numpy()
    return torch.from_numpy(out)


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
        kb.launch(
            "scan", fn, device, *kb.view(refstr), *kb.view(rlp),
            *kb.view(lr_tar), kb.ptr(qtok), qtok.shape[0], kb.ptr(gostart),
            kb.ptr(sl), kb.ptr(el), kb.ptr(qpos), n, mrs, mgs, kb.ptr(out))
        kb.counted(kernel, n, kb.nbytes(gostart, sl, el, qpos, out))
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
        kb.launch(
            "scan", "cgx_pcs_items", device, *kb.view(refstr), kb.ptr(qtok),
            qtok.shape[0], kb.ptr(pstart), kb.ptr(plen), kb.ptr(sl),
            kb.ptr(el), kb.ptr(tok), kb.ptr(stok), n, mrs, kb.ptr(out))
        kb.counted("B3p", n,
                   kb.nbytes(pstart, plen, sl, el, tok, stok, out))
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
        kb.launch(
            "scan", "cgx_two_items", device, *kb.view(refstr), *kb.view(rlp),
            *kb.view(lr_tar), kb.ptr(pstart), kb.ptr(plen), n, mrs, mgs,
            kb.ptr(out))
        kb.counted("B3t", n, kb.nbytes(pstart, plen, out))
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
        kb.launch(
            "scan", "cgx_scan_cols", device, kb.ptr(refstr), refstr.shape[0],
            kb.ptr(rlp), rlp.shape[0], kb.ptr(lr_tar), lr_tar.shape[0],
            kb.ptr(gostart), kb.ptr(sl), kb.ptr(el), kb.ptr(w0), kb.ptr(w1),
            kb.ptr(w2), n, mrs, mgs, int(fwd), kb.ptr(out))
        kb.counted(kernel, n,
                   kb.nbytes(gostart, sl, el, w0, w1, w2, out))
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
        kb.launch(
            "scan", "cgx_pcs_cols", device, kb.ptr(refstr), refstr.shape[0],
            kb.ptr(pstart), kb.ptr(plen), kb.ptr(sl), kb.ptr(el), kb.ptr(pa1),
            kb.ptr(pa2), kb.ptr(pb2), kb.ptr(pb3), n, mrs, kb.ptr(out))
        kb.counted("C1p", n, kb.nbytes(pstart, plen, sl, el, pa1, pa2,
                                       pb2, pb3, out))
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
        kb.launch(
            "scan", "cgx_two_packed", device, kb.ptr(refstr), refstr.shape[0],
            kb.ptr(rlp), rlp.shape[0], kb.ptr(lr_tar), lr_tar.shape[0],
            kb.ptr(pstart), kb.ptr(plen), n, mrs, mgs, kb.ptr(out))
        kb.counted("C1t", n, kb.nbytes(pstart, plen, out))
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
    (``cgx_tpu_torch.engine``) runs the device work.

    The scans' rows take one of two routes.  An engine that declares
    ``scan_rows_on_device`` turns them into rows on the device (kernel
    A2m, ``engine.scan_rows``): the precomputed references' and A3's rows
    go up as keys, every key is sorted there (kernel A2s) and the sorted
    columns come down.  Any other engine runs A2
    (``engine.scan_expanded``), its hits are expanded on the host and
    their SA words read (``engine.sa_values``).  Either route sorts one
    packed key per row (``RowKey``), which orders the unique rows as the
    lexsort by (pattern, start, length) does.  With the engine's ``timer``
    (a ``utils.timing.PhaseTimer``) the host stages are child phases of
    the phase open: ``route`` (precomp cells, SA ranges, routing),
    ``pcs_rows`` (A3's jobs and their hits to rows), ``scan_rows`` (the
    scans' tables; on the host route A2's hits to rows) and ``sort``."""
    mgs = cfg.min_gap_size
    with child(engine.timer, "route"):
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
        ok_b = (ib < P) & (pc.frequent_list[np.minimum(ib, P - 1)]
                           == b_first)
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
        # scan covers every legal gap and checks the same target span, so
        # the rows are the same); a pattern whose phrase does not occur has
        # no hits
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
                ref_ids, pci[ref_ids],
                np.zeros(len(ref_ids), dtype=np.int64)], axis=1))

    # 2) precomp-seed verification (A3).  Jobs with equal kernel inputs
    # (cell, sl, el, the four compared tokens) run once; their hits go to
    # every member pattern.
    seed_ids = np.flatnonzero(pc_seed)
    if len(seed_ids):
        with child(engine.timer, "pcs_rows"):
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
        with child(engine.timer, "pcs_rows"):
            hit = np.flatnonzero(ok)
            if len(hit):
                rows_parts += _pcs_rows(hit, counts_s, reps, inv, seed_ids,
                                        pc, pci, sl_all, el_all)

    # 3) forward and backward scans (A2, or A2m on the device) from the
    # rarer phrase
    scans = []
    with child(engine.timer, "scan_rows"):
        for fwd in (True, False):
            ids = np.flatnonzero(scan_member & (use_fwd == fwd))
            if len(ids):
                scans.append((fwd, np.where(fwd, r1u, r2u)[ids],
                              (np.where(fwd, dis1, dis2)[ids] + 1).clip(
                                  min=0),
                              sl_all[ids], el_all[ids],
                              (stok_all if fwd else tok_all)[ids], ids))
        items = int(sum(s[2].sum() for s in scans))
        kb.COUNTS["lookup1.items"] += items
        on_device = bool(scans) and getattr(engine, "scan_rows_on_device",
                                            False)
        if on_device:
            host_rows = (np.concatenate(rows_parts, axis=0) if rows_parts
                         else np.empty((0, 3), np.int64))
    cols = None
    if on_device:
        cols = engine.scan_rows(queries, scans, host_rows, len(sl_all))
        kb.COUNTS["lookup1.device_items"] += items
    else:
        for fwd, lo, counts, sl, el, side, ids in scans:
            rows_parts += _scan_hit_rows(engine, queries, fwd, lo, counts,
                                         sl, el, side, ids, sl_all, el_all,
                                         mgs)

    with child(engine.timer, "sort"):
        if cols is None:
            cols = _sort_rows(rows_parts, len(sl_all))
        out = GapOnSA(position=cols[0].astype(np.int32),
                      str_position=cols[1].astype(np.int32),
                      length=cols[2].astype(np.int32),
                      length2=np.zeros(len(cols[0]), dtype=np.int32))
        _fill_salist(search.start_on_salist, search.end_on_salist,
                     out.position)
    return out


def _scan_hit_rows(engine, queries, fwd, lo, counts, sl, el, side, ids,
                   sl_all, el_all, mgs):
    """The host route of one scan: A2's masks, their hits expanded and
    each hit's SA word read -> its rows (pattern, start, length), as a list
    of at most one array."""
    mask = engine.scan_expanded(queries, fwd, lo, counts, sl, el, side)
    with child(engine.timer, "scan_rows"):
        ii, mm = _mask_hits(mask)
        if len(ii):
            pat, tx, pi = expand_hits(ii, counts, ids)
    if not len(ii):
        return []
    gostart = engine.sa_values(lo[pi] + tx)
    with child(engine.timer, "scan_rows"):
        length = sl_all[pat] + mgs + mm + el_all[pat] - 1
        spos = gostart if fwd else gostart - mgs - mm - sl_all[pat]
        return [np.stack([pat, spos, length], axis=1)]


def _sort_rows(rows_parts, n_patterns: int) -> tuple:
    """The host route's rows (int64 [R, 3] parts: pattern, start, length)
    sorted by (pattern, start, length) -> the three columns, by sorting
    their packed keys (``RowKey``)."""
    rows = (np.concatenate(rows_parts, axis=0) if rows_parts
            else np.empty((0, 3), np.int64))
    key = RowKey.fit(n_patterns, rows[:, 1].min(initial=0),
                     rows[:, 1].max(initial=0), rows[:, 2].max(initial=0))
    keys = key.pack(rows[:, 0], rows[:, 1], rows[:, 2])
    keys.sort()
    return key.unpack(keys)


def _pcs_rows(hit, counts_s, reps, inv, seed_ids, pc, pci, sl_all, el_all):
    """A3's hits (flat item indices over the jobs ``reps``) expanded to
    every member pattern of each job -> the rows (pattern, start, length),
    as a list of at most one array."""
    rgrp, tx, _ = expand_hits(hit, counts_s)
    hit_counts = np.bincount(rgrp, minlength=len(reps))
    gstart = np.concatenate([[0], np.cumsum(hit_counts)])[:-1]
    order = np.argsort(inv, kind="stable")
    members = seed_ids[order]
    mcounts = hit_counts[inv[order]]
    pat = np.repeat(members, mcounts)
    if not len(pat):
        return []
    moffs = np.concatenate([[0], np.cumsum(mcounts)])[:-1]
    idx = (np.repeat(gstart[inv[order]], mcounts)
           + np.arange(int(mcounts.sum()))
           - np.repeat(moffs, mcounts))
    row = pc.index_start[pci[pat]] + tx[idx]
    spos = pc.onegap_start[row].astype(np.int64) - sl_all[pat] + 1
    length = pc.onegap_length[row].astype(np.int64) \
        + sl_all[pat] - 1 + el_all[pat] - 1
    return [np.stack([pat, spos, length], axis=1)]


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
                   cfg: ExtractorConfig,
                   refstr_host: np.ndarray) -> GapOnSA:
    """The occurrences of every distinct two-gap pattern, as rows (pattern,
    corpus start, b's end offset, c's end offset) sorted by all four; fills
    ``search2.start_on_salist``/``end_on_salist``.

    Every distinct one-gap pattern's occurrences (precomputed cells
    expanded, unsampled) are scanned once for a second gap, and the c token
    of each hit is matched against the (one-gap pattern, c token) pairs of
    the two-gap patterns.  An engine that declares ``two_rows_on_device``
    does both on the device (kernel A5m, ``engine.two_rows``); any other
    engine runs kernel A5 (``engine.two_expanded``), and the hits are
    matched on the host, the c token read from ``refstr_host`` (the host
    copy of the source token string).  Either route gives the rows in
    (item, move) order, and since each pattern's items are in (start,
    length) order and the moves ascend, a stable sort by two-gap id alone
    gives the four-column order.  ``engine`` as in
    ``one_gap_lookup``; with its ``timer`` the host stages are child
    phases: ``items`` (A5's table), ``keys`` (the sorted (one-gap pattern,
    c token) table), ``match`` (on the host route A5's hits to occurrences,
    their c tokens matched, the gap check's bit tested; on the device
    route the rows' columns unpacked) and ``sort``."""
    D2 = len(search2.blockid)
    mgs = cfg.min_gap_size
    empty = GapOnSA(*(np.empty(0, np.int32) for _ in range(4)))
    with child(engine.timer, "items"):
        lo, counts, pcmode = two_gap_items(search1, onegap_sa, pc)
    if D2 == 0 or counts.sum() == 0:
        return empty
    n = int(counts.sum())
    kb.COUNTS["lookup2.items"] += n
    on_device = getattr(engine, "two_rows_on_device", False)
    if not on_device:
        cand_mask, gc_mask = engine.two_expanded(onegap_sa, pc, lo, counts,
                                                 pcmode)
    with child(engine.timer, "keys"):
        # sorted (oneId, c-token) -> twoId table; distinct patterns are
        # unique pairs
        ctok = np.asarray(queries.tokens)[search2.gap2].astype(np.int64)
        keys = (search2.blockid.astype(np.int64) << 32) | ctok
        korder = np.argsort(keys, kind="stable")
        if on_device:   # the table as int32 columns: pattern p's c tokens
            kptr = np.searchsorted(search2.blockid[korder],
                                   np.arange(len(lo) + 1))
            kctok = ctok[korder]
        else:
            keys_sorted = keys[korder]
    if on_device:
        kb.COUNTS["lookup2.device_items"] += n
        two_id, css, word = engine.two_rows(onegap_sa, pc, lo, counts, pcmode,
                                            kptr, kctok, korder)
        if not len(two_id):
            return empty
        with child(engine.timer, "match"):
            fes = word & 0xFFFF
            cols = (two_id, css, fes, fes + 1 + mgs + (word >> 16))
    else:
        with child(engine.timer, "match"):
            ii, mm = _mask_hits(cand_mask)
            if len(ii):
                cols = _two_gap_rows(ii, mm, lo, counts, pcmode, onegap_sa,
                                     pc, gc_mask, keys_sorted, korder,
                                     refstr_host, mgs).T
        if not len(ii):
            return empty
    with child(engine.timer, "sort"):
        order = np.argsort(cols[0], kind="stable")
        out = GapOnSA(*(c[order].astype(np.int32) for c in cols))
        _fill_salist(search2.start_on_salist, search2.end_on_salist,
                     out.position)
    kb.COUNTS["lookup2.rows"] += len(order)
    return out


def _two_gap_rows(ii, mm, lo, counts, pcmode, onegap_sa, pc, gc_mask,
                  keys_sorted, korder, refstr_host, mgs):
    """A5's candidate hits (item ``ii``, move ``mm``) to the unsorted rows
    (two-gap id, start, b's end offset, c's end offset) of those whose c
    token matches a two-gap pattern and whose gap check passed."""
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
    return np.stack([two_id, css[hit], fes[hit],
                     length2[hit].astype(np.int64)], axis=1)


def _fill_salist(start_arr, end_arr, positions):
    """Each pattern's first and last row of the rows sorted by pattern
    ``positions``: the prefix of the rows' per-pattern counts (patterns
    with none are left as they are)."""
    if len(positions):
        counts = np.bincount(positions, minlength=len(start_arr))
        end = np.cumsum(counts)
        has = np.flatnonzero(counts)
        start_arr[has] = (end[has] - counts[has]).astype(np.int32)
        end_arr[has] = (end[has] - 1).astype(np.int32)
