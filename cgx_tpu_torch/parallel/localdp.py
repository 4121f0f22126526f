"""Single-process query data parallelism over several local devices.

Port of ``cgx_tpu/parallel/localdp.py`` (``run_pipeline(...,
dp_devices=N)``, ``--dp-devices N``).  ``LocalDPEngine`` replicates the
corpus index once per device and splits every device stage's flat work
axis into contiguous per-device slices.  Each device runs the same
per-item kernel on its slice and the results concatenate back in item
order, so the grammars equal the one-device run's byte for byte by
construction: every kernel is a pure per-item map.  The host stages
(lexicon, formatting) and MaxLex (on the first replica) stay as they are.

Each fan launches on every replica before it copies the first result to
the host (the engines' ``fetch=False``), so N cards run at once; each
replica's work is queued with its device current, and each of its
launches makes that device current again (``kernels.build.launch``).  An
explicit device list may repeat a device (``["cuda:0"] * 2``): the
replicas then share the device's
tensors and its stream, which is how one card checks the fan.  On the CPU,
N CPU placements stand in for N devices.

The other two scaling axes: ``parallel.multihost`` splits the queries over
processes, and ``parallel.sharded`` splits the index itself for corpora
beyond one device's memory.  Local DP is the layout when the index fits
one device and the host has several: one process, one index build, one
set of kernel libraries.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cgx_tpu_torch.engine import ReplicatedEngine, host, on, traced
from cgx_tpu_torch.kernels import build as kb
from cgx_tpu_torch.search import passes
from cgx_tpu_torch.types import Pass1Result, Pass2Result

# the per-device caches of a TorchGrammarIndex, which a replica rebuilds on
# its own device rather than share the source index's
_CACHES = ("maxlex_tables", "_qtok", "_pcrows", "_lcp")


def _normal(device) -> torch.device:
    """``device`` with its index: a bare "cuda" is the current card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def dp_device_list(n_devices: int, device="cuda") -> list:
    """The devices of an ``n_devices``-way run on ``device``'s type: the
    first N cards (ValueError past the visible ones), or N CPU
    placements."""
    kind = torch.device(device).type
    if kind != "cuda":
        return [torch.device(kind)] * max(n_devices, 1)
    visible = torch.cuda.device_count()
    n = n_devices or visible
    if n > visible:
        raise ValueError(f"--dp-devices {n} exceeds the {visible} local "
                         f"devices visible to this process")
    return [torch.device("cuda", k) for k in range(n)]


def clone_index(index, device):
    """A replica of a ``TorchGrammarIndex`` on ``device``: each device
    tensor moved there (the same tensor, no copy, when it already lies
    there), the host fields shared, the per-device caches empty."""
    device = _normal(device)
    moved = {f.name: getattr(index, f.name).to(device)
             for f in dataclasses.fields(index)
             if isinstance(getattr(index, f.name), torch.Tensor)}
    return dataclasses.replace(index, device=device, **moved,
                               **{c: None for c in _CACHES})


def _concat(parts):
    """Per-replica results (an array or a tuple of columns each) joined in
    replica order."""
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts)
    return tuple(np.concatenate(cols) for cols in zip(*parts))


class LocalDPEngine:
    """The engine protocol of ``ReplicatedEngine`` (plus ``refine_passes``,
    ``pass1`` and ``pass2``, which the pipeline routes through the engine
    so the searches fan out too) over replicas of one index.  Replica k
    takes the k-th contiguous slice of the item (or pattern) axis, and the
    result is the in-order concatenation: bit-equal to one device's.

    ``devices`` (a list, which may repeat a device) or else
    ``dp_device_list(n_devices, index.device)`` names the replicas."""

    timer = None

    def __init__(self, index, sa_host: np.ndarray, cfg, n_devices: int = 0,
                 devices=None, scan_cols: bool = False):
        if devices is None:
            devices = dp_device_list(n_devices, index.device)
        self.devices = [_normal(d) for d in devices]
        self.indices = [clone_index(index, d) for d in self.devices]
        self.engines = [ReplicatedEngine(ix, cfg, scan_cols, sa_host)
                        for ix in self.indices]
        self.index = self.indices[0]
        self.sa_host = sa_host
        self.cfg = cfg

    # ------------------------------------------------------------------
    # splitting and merging
    # ------------------------------------------------------------------

    def _item_spans(self, n: int) -> list:
        """Equal contiguous spans (replica, start, end) of a flat item axis;
        a replica past the last item gets none."""
        D = len(self.engines)
        if n <= 0:
            return []
        per = -(-n // D)
        return [(k, k * per, min((k + 1) * per, n))
                for k in range(D) if k * per < n]

    def _pattern_spans(self, counts) -> list:
        """Contiguous spans (replica, start, end) of the pattern axis,
        balanced by item count (the expanded kernels' work axis); a
        replica may get none."""
        counts = np.asarray(counts, np.int64)
        total = int(counts.sum())
        D = len(self.engines)
        if len(counts) == 0 or total <= 0:
            return []
        cum = np.cumsum(counts)
        bounds = [0]
        for k in range(1, D):
            b = int(np.searchsorted(cum, (total * k) // D, side="left"))
            bounds.append(max(b, bounds[-1]))
        bounds.append(len(counts))
        return [(k, bounds[k], bounds[k + 1])
                for k in range(D) if bounds[k] < bounds[k + 1]]

    def _fan(self, spans, launch):
        """``launch(engine, start, end)`` on every span's replica with its
        device current, each returning its fetch function; then every
        fetch, in span order -> the concatenated host result."""
        gets = []
        for k, s, e in spans:
            with kb.current(self.devices[k]):
                gets.append(launch(self.engines[k], s, e))
        return _concat([g() for g in gets])

    def _fan_arrays(self, meth: str, spans, arrays, *args, **kw):
        """``meth`` of one replica over whole ``arrays`` when at most one
        span has work, else fanned over the spans' slices of them."""
        arrays = [np.asarray(a) for a in arrays]
        if len(spans) <= 1:
            with kb.current(self.devices[0]):
                return getattr(self.engines[0], meth)(*args, *arrays, **kw)
        return self._fan(spans, lambda eng, s, e: getattr(eng, meth)(
            *args, *(a[s:e] for a in arrays), **kw, fetch=False))

    # ------------------------------------------------------------------
    # search passes (the pipeline routes them through the engine)
    # ------------------------------------------------------------------

    def refine_passes(self, queries):
        """Pass 1 and 2 by the interval refinement (``passes.
        drive_refinement``), each ladder step's alive lanes split across
        the replicas (kernel A1 on each)."""
        def dispatch(toks, sls, lo, hi, depth, dchunk):
            def launch(eng, s, e):
                ix = eng.index
                out = passes.refine_chunk(
                    ix.sa, ix.refstr_padded, ix.query_tokens(queries),
                    *on(ix.device, toks[s:e], sls[s:e], lo[s:e], hi[s:e]),
                    depth, dchunk)
                return lambda: tuple(host(t) for t in out)
            return self._fan(self._item_spans(len(toks)), launch)

        ix0 = self.index
        return passes.drive_refinement(queries, ix0.reflen, ix0.seed_host,
                                       dispatch)

    def pass1(self, queries) -> Pass1Result:
        """Pass 1 by the LCP search (kernel B1p1), tokens split across the
        replicas."""
        n = queries.totaltokens
        toks = np.arange(n, dtype=np.int32)
        sls = passes._suffix_lens(queries)
        spans = self._item_spans(n)
        if not spans:   # no query token: B1 on one replica, as one device
            spans = [(0, 0, 0)]
        lm, up, down, ffh, ffl, ffr = self._fan(
            spans, lambda eng, s, e: eng.pass1_items(
                queries, toks[s:e], sls[s:e], fetch=False))
        return Pass1Result(up=up, down=down, firstfindhit=ffh,
                           firstfindhitL=ffl, firstfindhitR=ffr,
                           longestmatch=lm)

    def pass2(self, queries, p1: Pass1Result) -> Pass2Result:
        """Pass 2 by the LCP search (kernel B1p2), items split across the
        replicas."""
        connectoffset, toks, matches = passes.pass2_work_items(p1)
        if len(toks) == 0:
            return Pass2Result(connectoffset=connectoffset,
                               up=np.empty(0, np.int32),
                               down=np.empty(0, np.int32))
        cols = (toks, matches, p1.firstfindhitL[toks], p1.firstfindhit[toks],
                p1.firstfindhitR[toks])
        up, down = self._fan(
            self._item_spans(len(toks)), lambda eng, s, e: eng.pass2_items(
                queries, *(c[s:e] for c in cols), fetch=False))
        return Pass2Result(connectoffset=connectoffset, up=up, down=down)

    # ------------------------------------------------------------------
    # the engine protocol
    # ------------------------------------------------------------------

    @traced
    def sa_values(self, rows) -> np.ndarray:
        """``sa[rows]`` from the host SA -> int64 numpy."""
        return self.sa_host[np.asarray(rows, np.int64)].astype(np.int64)

    @traced
    def pcs_expanded(self, queries, pc, base, counts, sl, el, tok, stok):
        return self._fan_arrays("pcs_expanded", self._pattern_spans(counts),
                                (base, counts, sl, el, tok, stok),
                                queries, pc)

    @traced
    def scan_expanded(self, queries, fwd, lo, counts, sl, el, side):
        return self._fan_arrays("scan_expanded", self._pattern_spans(counts),
                                (lo, counts, sl, el, side), queries, fwd)

    @traced
    def two_expanded(self, onegap_sa, pc, lo, counts, pcmode):
        return self._fan_arrays("two_expanded", self._pattern_spans(counts),
                                (lo, counts, pcmode), onegap_sa, pc)

    @traced
    def gap_check(self, gostart, fwd):
        return self._fan_arrays("gap_check", self._item_spans(len(gostart)),
                                (gostart,), fwd=fwd)

    @traced
    def contig(self, sa_pos, lm):
        return self._fan_arrays("contig", self._item_spans(len(sa_pos)),
                                (sa_pos, lm))

    @traced
    def onegap(self, css, fes, sls, els):
        return self._fan_arrays("onegap", self._item_spans(len(css)),
                                (css, fes, sls, els))

    @traced
    def twogap(self, css, fes, ses, sls, els, cls):
        return self._fan_arrays("twogap", self._item_spans(len(css)),
                                (css, fes, ses, sls, els, cls))
