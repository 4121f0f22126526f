"""Dispatch engines for the device stages.

Port of ``cgx_tpu/engine.py``.  The lookup, precompute and extraction
orchestrators express their device work against a small engine protocol, so
the same host logic drives both index layouts:

* ``ReplicatedEngine`` -- the whole index on one device
  (``index.container.TorchGrammarIndex``); the items of each stage expand on
  the device from per-pattern tables (kernels A2, A3, A5) or go up as
  columns (A4, A6, A7, A8); with ``scan_cols`` (the JAX package's
  ``CGX_SCAN_COLS``) the scans of lookup1 and lookup2 take their items as
  host-materialised columns instead (kernels C1f, C1b, C1t), each
  occurrence's start read from the host SA;
* ``parallel.sharded.ShardedEngine`` -- every O(corpus) array split into
  shards; work items go to the shard that owns the corpus position they read
  around, and SA values come from the rank-sharded SA (kernels B2 and B3).

* ``parallel.localdp.LocalDPEngine`` -- one ``ReplicatedEngine`` per
  device over replicas of the index; every stage's items split across them.

Methods (all take and return host numpy; device placement is the engine's
business): ``sa_values``, ``pcs_expanded``, ``scan_expanded``,
``two_expanded``, ``gap_check``, ``contig``, ``onegap``, ``twogap``.  An
engine whose ``two_rows_on_device`` is true (``ReplicatedEngine`` without
``scan_cols``) also has ``two_rows`` (kernel A5m: lookup2's scan and its
c-token match on the device), which lookup2 then takes in place of
``two_expanded`` and its host match; the others have neither.  Likewise
``scan_rows_on_device`` and ``scan_rows`` (kernel A2m: lookup1's scan
hits as rows, and the sort of all its rows, on the device), which lookup1
takes in place of ``scan_expanded``, its host expansion and
``sa_values``.
Each protocol method is a child phase ``engine.<method>`` of the phase
that called it (``traced``) when the engine's ``timer`` is set
(``pipeline.build_artifact`` and ``_make_context`` set it, ``serve`` per
request): the span holds the host tables, the upload, the launch, the
wait and the copy down, so a phase's time less its ``engine.*`` children
is its host time apart from its kernels.  The orchestrators (the lookups,
``precompute``) open their host stages' child phases on the same timer.

``ReplicatedEngine``'s kernel methods, and its ``pass1_items`` and
``pass2_items`` (kernel B1 over explicit items), also take ``fetch``: with
``fetch=False`` they launch and return a function that copies the result to
the host and returns what ``fetch=True`` would have, so that a caller
fanning over several devices launches on every one before the first copy
(the JAX engine's ``Pending``).  The JAX engine's ``do_gap`` knob and its
dispatch pools have no counterpart: the port always fuses the gap check.
"""

from __future__ import annotations

import functools

import numpy as np

from cgx_tpu_torch.extract import device as xdev
from cgx_tpu_torch.kernels import build as kb
from cgx_tpu_torch.search import lookup, passes
from cgx_tpu_torch.search import precompute as pcx


def split_two(words) -> tuple:
    """(cand, gc) int32 masks from words holding the uint32 bits
    ``cand | (gc << 16)``."""
    w = np.asarray(words).view(np.uint32)
    return (w & 0xFFFF).astype(np.int32), (w >> 16).astype(np.int32)


def two_gap_occurrences(onegap_sa, pc, lo, counts, pcmode):
    """Per item of lookup2's expansion, the aXb occurrence (corpus start,
    length) from the one-gap rows or, for a pcmode pattern, the precomputed
    rows (the host materialisation of ``ShardedEngine.two_expanded`` and of
    the column path) -> int64 numpy [N] each."""
    item_pat, tx = materialize_items(counts)
    row = np.asarray(lo, np.int64)[item_pat] + tx
    pcm = np.asarray(pcmode, bool)[item_pat]

    def col(a):
        return a if len(a) else np.zeros(1, np.int32)
    og_sp, og_len = col(onegap_sa.str_position), col(onegap_sa.length)
    pc_sp, pc_len = col(pc.onegap_start), col(pc.onegap_length)
    row_sa = np.clip(row, 0, len(og_sp) - 1)
    row_pc = np.clip(row, 0, len(pc_sp) - 1)
    css = np.where(pcm, pc_sp[row_pc], og_sp[row_sa]).astype(np.int64)
    fes = np.where(pcm, pc_len[row_pc], og_len[row_sa]).astype(np.int64)
    return css, fes


def materialize_items(counts):
    """Flat item list from per-pattern counts: (item_pat, tx), where
    ``item_pat[i]`` is item i's pattern and ``tx[i]`` its occurrence offset
    within that pattern."""
    counts = np.asarray(counts, np.int64)
    item_pat = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    cum = np.cumsum(counts)
    tx = np.arange(len(item_pat), dtype=np.int64) \
        - np.repeat(cum - counts, counts)
    return item_pat, tx


def _scan_tokens(queries, fwd, sl, side) -> tuple:
    """A2's three compared query tokens per pattern: b's first three
    forward (``side`` = b's start), a's last three reversed backward
    (``side`` = a's start)."""
    qtok = np.asarray(queries.padded_tokens()).astype(np.int64)
    if fwd:
        return qtok[side], qtok[side + 1], qtok[side + 2]
    return (qtok[side + sl - 1], qtok[side + np.maximum(sl - 2, 0)],
            qtok[side + np.maximum(sl - 3, 0)])


def on(device, *cols):
    """int32 copies of numpy columns on ``device``."""
    return [kb.to_device(np.ascontiguousarray(c, np.int32), device)
            for c in cols]


def host(t) -> np.ndarray:
    """A device tensor's values as numpy (``kernels.build.to_host``)."""
    return kb.to_host(t).numpy()


def traced(method):
    """An engine protocol method timed as the child phase
    ``engine.<name>`` of the phase open on the calling thread, where the
    engine has a ``timer``; no span without one, or inside another engine
    call."""
    name = "engine." + method.__name__

    @functools.wraps(method)
    def call(self, *args, **kw):
        timer = self.timer
        parent = timer.open_phase() if timer is not None else None
        if parent is None or parent.rsplit("/", 1)[-1].startswith("engine."):
            return method(self, *args, **kw)
        with timer.phase(name, sync=False):
            return method(self, *args, **kw)
    return call


def _done(get, fetch: bool):
    """``get()``, the result on the host, or with ``fetch=False`` ``get``
    itself for the caller to call once it has launched elsewhere."""
    return get() if fetch else get


class ReplicatedEngine:
    """Single-device dispatch against a whole ``TorchGrammarIndex``.
    ``scan_cols=True`` runs ``scan_expanded`` and ``two_expanded`` on the
    column-upload kernels (the JAX engine's ``_scan_expanded_cols`` and
    ``_two_expanded_cols``); it needs ``sa_host``, the host suffix array
    the index was built from (numpy)."""

    timer = None

    def __init__(self, index, cfg, scan_cols: bool = False, sa_host=None):
        if scan_cols and sa_host is None:
            raise ValueError("scan_cols reads each occurrence's start from "
                             "the host suffix array: pass sa_host")
        self.index = index
        self.cfg = cfg
        self.scan_cols = scan_cols
        self.sa_host = sa_host

    @traced
    def sa_values(self, rows) -> np.ndarray:
        """``sa[rows]`` read from the index's device copy -> int64 numpy."""
        r = kb.to_device(np.asarray(rows, np.int64), self.index.device)
        return host(self.index.sa[r]).astype(np.int64)

    def _pattern_tables(self, counts, cols, width=8):
        """(pattab, offs, n) on the index's device for per-pattern item
        counts and up to ``width`` int32 field columns."""
        offs = lookup._offsets(counts)
        pattab = np.zeros((len(counts), width), np.int32)
        for c, v in enumerate(cols):
            pattab[:, c] = v
        kb.check_count("lookup", int(offs[-1]))   # before the int32 cast
        dev = self.index.device
        return (kb.to_device(pattab, dev),
                kb.to_device(offs.astype(np.int32), dev), int(offs[-1]))

    def pass1_items(self, queries, toks, suffixlens, fetch=True):
        """B1's pass 1 (``passes.pass1``) over explicit query-token items
        -> its six numpy int32 columns."""
        ix = self.index
        lcpleft, lcpright = ix.lcp_tables()
        out = passes.pass1(ix.refstr_padded, ix.sa, lcpleft, lcpright,
                           ix.query_tokens(queries),
                           *on(ix.device, toks, suffixlens), ix.reflen)
        return _done(lambda: tuple(host(t) for t in out), fetch)

    def pass2_items(self, queries, toks, matches, LLs, MMs, RRs, fetch=True):
        """B1's pass 2 (``passes.pass2``) over explicit (token, match
        length) items and their pass-1 windows -> (up, down) numpy int32."""
        ix = self.index
        lcpleft, lcpright = ix.lcp_tables()
        out = passes.pass2(ix.refstr_padded, ix.sa, lcpleft, lcpright,
                           ix.query_tokens(queries),
                           *on(ix.device, toks, matches, LLs, MMs, RRs))
        return _done(lambda: tuple(host(t) for t in out), fetch)

    @traced
    def pcs_expanded(self, queries, pc, base, counts, sl, el, tok, stok,
                     fetch=True):
        """A3 over the precomputed occurrences -> numpy bool [sum(counts)]."""
        qtok = np.asarray(queries.padded_tokens()).astype(np.int64)
        pattab, offs, n = self._pattern_tables(counts, (
            base, sl, el, qtok[tok + np.maximum(sl - 2, 0)],
            qtok[tok + np.maximum(sl - 3, 0)], qtok[stok + 1],
            qtok[stok + 2]))
        ix = self.index
        words = lookup.pcs(ix.refstr_padded, ix.precomp_rows(pc), pattab,
                           offs, n, self.cfg.max_rule_span)
        return _done(lambda: np.unpackbits(
            host(words).view(np.uint8),
            bitorder="little")[:n].astype(bool), fetch)

    @traced
    def scan_expanded(self, queries, fwd, lo, counts, sl, el, side,
                      fetch=True):
        """A2 over the patterns' SA ranges (with ``scan_cols``: C1f/C1b over
        the items materialised on the host, each occurrence read from the
        host SA) -> numpy int32 [sum(counts)] masks."""
        toks = _scan_tokens(queries, fwd, sl, side)
        ix, cfg = self.index, self.cfg
        if self.scan_cols:
            item_pat, tx = materialize_items(counts)
            cols = [c[item_pat] for c in (sl, el) + toks]
            mask = lookup.scan_cols(
                ix.refstr_padded, ix.rlp, ix.lr_tar,
                *on(ix.device, self.sa_host[lo[item_pat] + tx], *cols),
                cfg.max_rule_span, cfg.min_gap_size, fwd)
        else:
            pattab, offs, n = self._pattern_tables(counts,
                                                   (lo, sl, el) + toks)
            mask = lookup.scan(ix.refstr_padded, ix.rlp, ix.lr_tar, ix.sa,
                               pattab, offs, n, cfg.max_rule_span,
                               cfg.min_gap_size, fwd)
        return _done(lambda: host(mask), fetch)

    @property
    def scan_rows_on_device(self) -> bool:
        """Whether lookup1 turns its scans' hits into rows on the device
        (``scan_rows``): on the expanded items, not with ``scan_cols``."""
        return not self.scan_cols

    @traced
    def scan_rows(self, queries, scans, host_rows, n_patterns):
        """A2m over lookup1's scans ``scans`` ((fwd, lo, counts, sl, el,
        side, ids) each: ``scan_expanded``'s arguments and the scanned
        patterns' ids) and the sort of those rows with the host-built rows
        ``host_rows`` (int64 [R, 3]: pattern, start, length), keys packed
        by ``lookup.device_row_key`` (``lookup.scan_rows``) -> the sorted
        rows' (pattern, start, length), numpy int32 [3, R]."""
        ix, cfg = self.index, self.cfg
        mrs = cfg.max_rule_span
        key = lookup.device_row_key(n_patterns, ix.reflen, mrs, host_rows)
        tables = []
        for fwd, lo, counts, sl, el, side, ids in scans:
            pattab, offs, n = self._pattern_tables(
                counts, (lo, sl, el) + _scan_tokens(queries, fwd, sl, side)
                + (ids,))
            tables.append((pattab, offs, n, fwd))
        return lookup.scan_rows(ix.refstr_padded, ix.rlp, ix.lr_tar, ix.sa,
                                tables,
                                key.pack(host_rows[:, 0], host_rows[:, 1],
                                         host_rows[:, 2]),
                                key, mrs, cfg.min_gap_size)

    @traced
    def two_expanded(self, onegap_sa, pc, lo, counts, pcmode, fetch=True):
        """A5 (or with ``scan_cols`` C1t) over every one-gap occurrence ->
        (cand, gc) numpy int32 [sum(counts)] masks."""
        ix, cfg = self.index, self.cfg
        if self.scan_cols:
            css, fes = two_gap_occurrences(onegap_sa, pc, lo, counts, pcmode)
            words = lookup.two_packed(ix.refstr_padded, ix.rlp, ix.lr_tar,
                                      *on(ix.device, css, fes),
                                      cfg.max_rule_span, cfg.min_gap_size)
        else:
            pattab, offs, n = self._pattern_tables(counts, (lo, pcmode),
                                                   width=2)
            words = lookup.two(ix.refstr_padded, ix.rlp, ix.lr_tar,
                               self._onegap_rows(onegap_sa),
                               ix.precomp_rows(pc), pattab, offs, n,
                               cfg.max_rule_span, cfg.min_gap_size)
        return _done(lambda: split_two(host(words)), fetch)

    @property
    def two_rows_on_device(self) -> bool:
        """Whether lookup2 matches on the device (``two_rows``): on the
        expanded items, not with ``scan_cols``."""
        return not self.scan_cols

    @traced
    def two_rows(self, onegap_sa, pc, lo, counts, pcmode, kptr, kctok, kid):
        """A5m over every one-gap occurrence, the c tokens matched against
        the (one-gap pattern, c token) table ``kptr``, ``kctok``, ``kid``
        (``lookup.two_rows``) -> the kept rows' (two_id, pstart, plen |
        (move << 16)), numpy int32 [R] each, in (item, move) order."""
        ix, cfg = self.index, self.cfg
        pattab, offs, n = self._pattern_tables(counts, (lo, pcmode), width=2)
        rows = lookup.two_rows(ix.refstr_padded, ix.rlp, ix.lr_tar,
                               self._onegap_rows(onegap_sa),
                               ix.precomp_rows(pc), pattab, offs, n,
                               cfg.max_rule_span, cfg.min_gap_size,
                               *on(ix.device, kptr, kctok, kid)).numpy()
        return rows[:, 0], rows[:, 1], rows[:, 2]

    def _onegap_rows(self, onegap_sa):
        """The one-gap occurrences (start, len) as A5's int32 [m >= 1, 2]
        table on the index's device."""
        rows = np.zeros((max(len(onegap_sa.str_position), 1), 2), np.int32)
        rows[:len(onegap_sa.str_position), 0] = onegap_sa.str_position
        rows[:len(onegap_sa.length), 1] = onegap_sa.length
        return kb.to_device(rows, self.index.device)

    @traced
    def gap_check(self, gostart, fwd, fetch=True):
        """A4 -> numpy int32 [n] move masks."""
        ix, cfg = self.index, self.cfg
        (g,) = on(ix.device, gostart)
        gc = pcx.gap_check(ix.rlp, ix.lr_tar, g, cfg.max_rule_span,
                           cfg.min_gap_size, fwd)
        return _done(lambda: host(gc), fetch)

    @traced
    def contig(self, sa_pos, lm, fetch=True):
        """A6 -> the 8 numpy int32 columns (ts, packed) per family."""
        ix, cfg = self.index, self.cfg
        out = xdev.contig(ix.refstr_padded, ix.sa, ix.rlp, ix.lr_tar,
                          *on(ix.device, sa_pos, lm), cfg.max_rule_span,
                          cfg.max_rule_symbols)
        return _done(lambda: tuple(host(out)), fetch)

    @traced
    def onegap(self, css, fes, sls, els, fetch=True):
        """A7 -> the 6 numpy int32 columns."""
        ix, cfg = self.index, self.cfg
        out = xdev.onegap(ix.refstr_padded, ix.rlp, ix.lr_tar,
                          *on(ix.device, css, fes, sls, els),
                          cfg.max_rule_span, cfg.max_rule_symbols)
        return _done(lambda: tuple(host(out)), fetch)

    @traced
    def twogap(self, css, fes, ses, sls, els, cls, fetch=True):
        """A8 -> the 2 numpy int32 columns."""
        ix = self.index
        out = xdev.twogap(ix.refstr_padded, ix.rlp, ix.lr_tar,
                          *on(ix.device, css, fes, ses, sls, els, cls),
                          self.cfg.max_rule_span)
        return _done(lambda: tuple(host(out)), fetch)
