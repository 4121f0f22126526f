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

Methods (all take and return host numpy; device placement is the engine's
business): ``sa_values``, ``pcs_expanded``, ``scan_expanded``,
``two_expanded``, ``gap_check``, ``contig``, ``onegap``, ``twogap``.  The
JAX engine's ``fetch``/``do_gap`` knobs and its dispatch pools have no
counterpart: the port always fuses the gap check, and a kernel's result is
read back when the engine returns.
"""

from __future__ import annotations

import numpy as np
import torch

from cgx_tpu_torch.extract import device as xdev
from cgx_tpu_torch.kernels import build as kb
from cgx_tpu_torch.search import lookup
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


def on(device, *cols):
    """int32 copies of numpy columns on ``device``."""
    return [torch.from_numpy(np.ascontiguousarray(c, np.int32)).to(device)
            for c in cols]


class ReplicatedEngine:
    """Single-device dispatch against a whole ``TorchGrammarIndex``.
    ``scan_cols=True`` runs ``scan_expanded`` and ``two_expanded`` on the
    column-upload kernels (the JAX engine's ``_scan_expanded_cols`` and
    ``_two_expanded_cols``); it needs ``sa_host``, the host suffix array
    the index was built from (numpy)."""

    def __init__(self, index, cfg, scan_cols: bool = False, sa_host=None):
        if scan_cols and sa_host is None:
            raise ValueError("scan_cols reads each occurrence's start from "
                             "the host suffix array: pass sa_host")
        self.index = index
        self.cfg = cfg
        self.scan_cols = scan_cols
        self.sa_host = sa_host

    def sa_values(self, rows) -> np.ndarray:
        """``sa[rows]`` read from the index's device copy -> int64 numpy."""
        r = torch.from_numpy(np.asarray(rows, np.int64)).to(self.index.device)
        return self.index.sa[r].cpu().numpy().astype(np.int64)

    def _pattern_tables(self, counts, cols, width=8):
        """(pattab, offs, n) on the index's device for per-pattern item
        counts and up to ``width`` int32 field columns."""
        offs = lookup._offsets(counts)
        pattab = np.zeros((len(counts), width), np.int32)
        for c, v in enumerate(cols):
            pattab[:, c] = v
        kb.check_count("lookup", int(offs[-1]))   # before the int32 cast
        dev = self.index.device
        return (torch.from_numpy(pattab).to(dev),
                torch.from_numpy(offs.astype(np.int32)).to(dev),
                int(offs[-1]))

    def pcs_expanded(self, queries, pc, base, counts, sl, el, tok, stok):
        """A3 over the precomputed occurrences -> numpy bool [sum(counts)]."""
        qtok = np.asarray(queries.padded_tokens()).astype(np.int64)
        pattab, offs, n = self._pattern_tables(counts, (
            base, sl, el, qtok[tok + np.maximum(sl - 2, 0)],
            qtok[tok + np.maximum(sl - 3, 0)], qtok[stok + 1],
            qtok[stok + 2]))
        ix = self.index
        words = lookup.pcs(ix.refstr_padded, ix.precomp_rows(pc), pattab,
                           offs, n, self.cfg.max_rule_span).cpu().numpy()
        return np.unpackbits(words.view(np.uint8),
                             bitorder="little")[:n].astype(bool)

    def scan_expanded(self, queries, fwd, lo, counts, sl, el, side):
        """A2 over the patterns' SA ranges (with ``scan_cols``: C1f/C1b over
        the items materialised on the host, each occurrence read from the
        host SA) -> numpy int32 [sum(counts)] masks."""
        qtok = np.asarray(queries.padded_tokens()).astype(np.int64)
        if fwd:
            toks = (qtok[side], qtok[side + 1], qtok[side + 2])
        else:
            toks = (qtok[side + sl - 1], qtok[side + np.maximum(sl - 2, 0)],
                    qtok[side + np.maximum(sl - 3, 0)])
        ix, cfg = self.index, self.cfg
        if self.scan_cols:
            item_pat, tx = materialize_items(counts)
            cols = [c[item_pat] for c in (sl, el) + toks]
            return lookup.scan_cols(
                ix.refstr_padded, ix.rlp, ix.lr_tar,
                *on(ix.device, self.sa_host[lo[item_pat] + tx], *cols),
                cfg.max_rule_span, cfg.min_gap_size, fwd).cpu().numpy()
        pattab, offs, n = self._pattern_tables(counts, (lo, sl, el) + toks)
        return lookup.scan(ix.refstr_padded, ix.rlp, ix.lr_tar, ix.sa, pattab,
                           offs, n, cfg.max_rule_span, cfg.min_gap_size,
                           fwd).cpu().numpy()

    def two_expanded(self, onegap_sa, pc, lo, counts, pcmode):
        """A5 (or with ``scan_cols`` C1t) over every one-gap occurrence ->
        (cand, gc) numpy int32 [sum(counts)] masks."""
        ix, cfg = self.index, self.cfg
        if self.scan_cols:
            css, fes = two_gap_occurrences(onegap_sa, pc, lo, counts, pcmode)
            words = lookup.two_packed(ix.refstr_padded, ix.rlp, ix.lr_tar,
                                      *on(ix.device, css, fes),
                                      cfg.max_rule_span, cfg.min_gap_size)
            return split_two(words.cpu().numpy())
        pattab, offs, n = self._pattern_tables(counts, (lo, pcmode), width=2)
        rows = np.zeros((max(len(onegap_sa.str_position), 1), 2), np.int32)
        rows[:len(onegap_sa.str_position), 0] = onegap_sa.str_position
        rows[:len(onegap_sa.length), 1] = onegap_sa.length
        words = lookup.two(ix.refstr_padded, ix.rlp, ix.lr_tar,
                           torch.from_numpy(rows).to(ix.device),
                           ix.precomp_rows(pc), pattab, offs, n,
                           cfg.max_rule_span, cfg.min_gap_size)
        return split_two(words.cpu().numpy())

    def gap_check(self, gostart, fwd):
        """A4 -> numpy int32 [n] move masks."""
        ix, cfg = self.index, self.cfg
        (g,) = on(ix.device, gostart)
        return pcx.gap_check(ix.rlp, ix.lr_tar, g, cfg.max_rule_span,
                             cfg.min_gap_size, fwd).cpu().numpy()

    def contig(self, sa_pos, lm):
        """A6 -> the 8 numpy int32 columns (ts, packed) per family."""
        ix, cfg = self.index, self.cfg
        out = xdev.contig(ix.refstr_padded, ix.sa, ix.rlp, ix.lr_tar,
                          *on(ix.device, sa_pos, lm), cfg.max_rule_span,
                          cfg.max_rule_symbols)
        return tuple(out.cpu().numpy())

    def onegap(self, css, fes, sls, els):
        """A7 -> the 6 numpy int32 columns."""
        ix, cfg = self.index, self.cfg
        out = xdev.onegap(ix.refstr_padded, ix.rlp, ix.lr_tar,
                          *on(ix.device, css, fes, sls, els),
                          cfg.max_rule_span, cfg.max_rule_symbols)
        return tuple(out.cpu().numpy())

    def twogap(self, css, fes, ses, sls, els, cls):
        """A8 -> the 2 numpy int32 columns."""
        ix = self.index
        out = xdev.twogap(ix.refstr_padded, ix.rlp, ix.lr_tar,
                          *on(ix.device, css, fes, ses, sls, els, cls),
                          self.cfg.max_rule_span)
        return tuple(out.cpu().numpy())
