#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cgx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each on stdout:

1. card   -- the card's name and power limit (nvidia-smi) and torch's name;
2. build  -- nvcc builds every kernel of the main path from csrc/, one
   process per source, all at once, and each kernel's registers, stack and
   spills are printed from ptxas's report;
3. e2e    -- ``cgx_tpu_torch.pipeline.run_pipeline(..., device="cuda")`` on
   the ``medium`` corpus (20k sentences, 32 queries; dense MaxLex tables, so
   kernel A9) and the ``europarl`` corpus (1M sentences, 20k vocabulary, 64
   queries; row-range tables, so A10), both made from seeds by the generators
   in tools/, then europarl again with ``sa_shards=4`` (the sharded index,
   all four shards on the card; its corpus text is reused), europarl again
   with ``scan_cols=True`` (the column-upload lookups), then medium again
   with ``lcp_passes=True`` (``RUNS``).
   Each run must launch its path's kernels and no other (launch counts
   reset just before it, see ``RUNS``): A1 or B1's two passes, A4, A2
   forward and backward (C1f and C1b with ``scan_cols``), A3, A5 (C1t with
   ``scan_cols``), A6, A7, A8 and A9 or A10 on the replicated index; B2r,
   B2g, B3f, B3b, B3p, B3t, B3c and A4, A7, A8 on shard views on the
   sharded one (MaxLex on the host there).  Its counters must equal the
   JAX package's and its grammar hash the golden in
   tests/golden_torch_hashes.json (the JAX package's full grammar).  On
   europarl's index and queries both LCP passes must then give the
   refinement's up, down and longestmatch (their launches, B1's largest,
   counted with the launch counts reset just before them); the sharded run
   prints each shard's bytes and its peak device memory beside the
   replicated run's.  Then, all under a scratch dir in ``build/`` that is
   deleted at the end (``run_paths``):
   3b. index_save -- europarl's default run above passes ``index_dir``, so
       it persists its index (``preproc.index_io``): the ``indexsave``
       seconds and the dir's bytes;
   3c. the loaded runs (``LOAD_RUNS``) -- ``run_pipeline(...,
       index_dir=...)`` on that dir, replicated and with ``sa_shards=4``:
       no corpus parsed, no suffix array built, no precompute, so no A4 or
       A4v; each must launch exactly its path's kernels and give the
       golden hash and counters;
   3d. serve -- europarl's corpus and two query files (all 64 queries;
       the first 3) written out, ``serve.serve_loop`` over the index dir
       with the default ``auto`` prewarm and three requests (all, first
       3, all): every reply ``ok``, both full requests the golden hash,
       the small one the first 3 queries' lines of 3c's run, each full
       request the kernels of 3c's replicated run, the small one (no item
       for A3) and the prewarm nothing else;
       ``ready`` and each request's seconds and launches printed;
   3e. medium with ``query_batches=4`` (``run_pipeline_overlap``): the
       golden hash and line count, A4, A1, A2f, A2b, A3, A5, A6, A7 and A8
       and no A9 or A10 (MaxLex on the host, on the worker thread);
   3f. profile -- ``cli.main([..., "--profile", DIR])`` on medium's
       files: the grammar files the golden hash, medium's path launched,
       and DIR's ``torch.profiler`` trace naming each of that path's
       ``__global__`` functions; the trace's csrc kernel time, its device
       busy time (the union of kernels, copies and sets) and that busy
       time's share of the run's wall and of its phases' sum printed,
       beside the wall of the same CLI run without ``--profile``;
4. query_dp -- ``parallel.dist.run_sharded_search`` on the europarl run's
   index, pass-1 tokens and sampled block occurrences, over four shards on
   the one card (kernel B4, one launch per shard, and nothing else):
   longestmatch must equal the refinement's, the match count the number of
   tokens that match, every shard's outputs and counts its plain
   version's, the extraction of the real items A6's on the same SA
   positions, and the rule count the plain shards' sum; then (4b,
   dense_large) kernel A9 on europarl's lexicon as dense tables (20,001^2
   floats each, past DEV_DENSE_LIMIT, which no pipeline run builds: the
   A9L row) on the rules of A10's largest launch, whose features must be
   A10's bit for bit;
5. columns -- kernel C1p (``lookup.pcs_cols``, which no pipeline path
   calls, as in the JAX package) on the items of A3's largest launch,
   materialised into columns on the host: its ok bits must equal A3's;
6. probe -- the gather probe (``tools.gather_probe.run_probe``: P1, P2,
   their plain versions and the one-call library form) at the probe's
   defaults and on europarl's corpus at the scan starts of A2b's largest
   launch: every checksum and every P2 row equal the plain version's;
   milliseconds and words per second printed;
7. kernels -- each kernel against its plain PyTorch version on the card, on
   the inputs of its largest launch in phases 3 to 6 (A2 and C1 once per
   direction, B1 once per pass, A4, A7 and A8 also on a shard's views, as
   A4v, A7v and A8v, and A9 on the dense europarl tables as A9L), and
   every kernel that reads a shard's views (A4v,
   A7v, A8v, B3f, B3b, B3p, B3t, B3c) also on its largest launch on each
   shard, the first (negative global offset) and the last (reads clamped to
   the global end) included: the outputs must be bit-equal (float32
   compared by bit pattern); times of both, the time of one PyTorch call
   that computes the same function where there is one (P1, P2), the
   kernel's time by the device's own clock (``device_ms``: the timed calls
   once more under ``torch.profiler``, the CUDA time of the csrc kernels
   they launched over the calls; null, with the reason, where the profiler
   records none), and the
   least time the card could take for the same work (``bound_ms``: the
   larger of the bytes over the memory rate and the integer operations over
   the peak rate, counted per item from the kernel's loops, see ``WORK``;
   where a function stops early, only the words its result needs, counted
   from this launch's items by ``tools.reads`` and printed: lookup1's scans
   the corpus words that decide each item's candidates and the gap check
   only for the items whose candidate mask is non-zero; A4, A5, C1t and B3t
   the gap check's words; A5, C1t and B3t the move words up to the first
   stop; A6, B3c and B4's extraction the words and growth steps of
   ``_extract_contig_item`` up to each loop's exit; A7 and A7v each side's
   step words up to its first event and the window entries its checks look
   up; A8 and A8v the gaps' words only where the rule is valid; A10 the
   bisection path and found words of each distinct search; A9 the table
   words of each kept position and NULL probe; B1 and B4's lanes each
   search and walk step's skip words and the compares' SA, corpus and
   query words, with the chain of read rounds of the warp body; A1 and
   B2r the binary searches' SA, corpus and query words, B2r also the
   shards' meta rows; A3, B3p and C1p the corpus words each item's
   verification compares, A3 also its offs words, pattern rows and
   precomputed rows, with the rounds a warp takes to resolve its items'
   patterns; P1 and P2 the corpus words under the union of their windows,
   each once), and the time
   of one launch of A8 on one item (by the device's clock A8's own
   one-item chain, ``launch_floor``).  Then the warp and half-warp kernels
   (A1, B2r, A2f, A2b, A3, A4, A4v, C1f, C1b, C1p, B3f, B3b, B3p, A6, B3c,
   A5, C1t, B3t, A7, A7v, A8, A8v, A10, A9, B1p1, B1p2) against their plain
   versions on synthetic edge inputs over europarl's index arrays and
   tables (A9 over medium's dense tables; B1 also over a small index of
   70-token sentences, for matches past 32 tokens; B2r also on 1 and 3
   shards), and P1 and P2 on short corpora, ragged item counts and grids
   (``check_edges``).

Then the script's total seconds, a JSON line with every kernel's numbers
(``launches``: every phase's, 3b-3f included), and last the line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before it.
The script imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden_torch_hashes.json")

# kernel id -> (source in the repo, file:line of the JAX function it replaces:
# _refine_chunk_local, _gc_batch, _scan_batch_exp (forward, backward),
# _pcs_batch_exp, _two_batch_exp, _contig_batch, _onegap_batch,
# _twogap_batch, _accum_batch_dense, _accum_batch_range, _pass1_batch,
# _pass2_batch; the sharded index's _refine_chunk, _gather_sa_chunk,
# _fwd_batch, _bwd_batch, _pcs_batch, _two_batch, _contig_batch_pos, and
# _gc_batch, _onegap_batch, _twogap_batch on a shard's views; the column
# path's _scan_batch_cols (forward, backward), _pcs_batch_cols,
# _two_batch_packed; the query-DP step; the probe's two pl.pallas_call
# kernels)
KERNELS = {
    "A1": ("cgx_tpu_torch/csrc/refine.cu", "cgx_tpu/search/passes.py:371"),
    "A4": ("cgx_tpu_torch/csrc/gapcheck.cu",
           "cgx_tpu/search/precompute.py:38"),
    "A2f": ("cgx_tpu_torch/csrc/scan.cu", "cgx_tpu/search/lookup.py:337"),
    "A2b": ("cgx_tpu_torch/csrc/scan.cu", "cgx_tpu/search/lookup.py:337"),
    "A3": ("cgx_tpu_torch/csrc/scan.cu", "cgx_tpu/search/lookup.py:315"),
    "A5": ("cgx_tpu_torch/csrc/scan.cu", "cgx_tpu/search/lookup.py:662"),
    "A6": ("cgx_tpu_torch/csrc/contig.cu", "cgx_tpu/extract/device.py:382"),
    "A7": ("cgx_tpu_torch/csrc/onegap.cu", "cgx_tpu/extract/device.py:616"),
    "A8": ("cgx_tpu_torch/csrc/twogap.cu", "cgx_tpu/extract/device.py:744"),
    "A9": ("cgx_tpu_torch/csrc/maxlex.cu", "cgx_tpu/features/maxlex.py:161"),
    "A9L": ("cgx_tpu_torch/csrc/maxlex.cu", "cgx_tpu/features/maxlex.py:161"),
    "A10": ("cgx_tpu_torch/csrc/maxlex.cu", "cgx_tpu/features/maxlex.py:216"),
    "B1p1": ("cgx_tpu_torch/csrc/lcp.cu", "cgx_tpu/search/passes.py:221"),
    "B1p2": ("cgx_tpu_torch/csrc/lcp.cu", "cgx_tpu/search/passes.py:229"),
    "B2r": ("cgx_tpu_torch/csrc/sharded.cu",
            "cgx_tpu/parallel/sharded.py:261"),
    "B2g": ("cgx_tpu_torch/csrc/sharded.cu",
            "cgx_tpu/parallel/sharded.py:324"),
    "B3f": ("cgx_tpu_torch/csrc/scan.cu", "cgx_tpu/search/lookup.py:237"),
    "B3b": ("cgx_tpu_torch/csrc/scan.cu", "cgx_tpu/search/lookup.py:246"),
    "B3p": ("cgx_tpu_torch/csrc/scan.cu", "cgx_tpu/search/lookup.py:255"),
    "B3t": ("cgx_tpu_torch/csrc/scan.cu", "cgx_tpu/search/lookup.py:643"),
    "B3c": ("cgx_tpu_torch/csrc/contig.cu", "cgx_tpu/extract/device.py:391"),
    "A4v": ("cgx_tpu_torch/csrc/gapcheck.cu",
            "cgx_tpu/search/precompute.py:38"),
    "A7v": ("cgx_tpu_torch/csrc/onegap.cu", "cgx_tpu/extract/device.py:616"),
    "A8v": ("cgx_tpu_torch/csrc/twogap.cu", "cgx_tpu/extract/device.py:744"),
    "C1f": ("cgx_tpu_torch/csrc/scan.cu", "cgx_tpu/search/lookup.py:274"),
    "C1b": ("cgx_tpu_torch/csrc/scan.cu", "cgx_tpu/search/lookup.py:274"),
    "C1p": ("cgx_tpu_torch/csrc/scan.cu", "cgx_tpu/search/lookup.py:285"),
    "C1t": ("cgx_tpu_torch/csrc/scan.cu", "cgx_tpu/search/lookup.py:650"),
    "B4": ("cgx_tpu_torch/csrc/dist.cu", "cgx_tpu/parallel/dist.py:56"),
    "P1": ("cgx_tpu_torch/csrc/probe.cu", "tools/pallas_probe.py:51"),
    "P2": ("cgx_tpu_torch/csrc/probe.cu", "tools/pallas_probe.py:97"),
}
# the rows on a shard's views: the same kernel as their replicated row,
# counted under its own launch id (kernels/build.py ``launch_id``)
VIEW_ROWS = {"A4v": "A4", "A7v": "A7", "A8v": "A8"}
# the kernels every replicated end-to-end run launches, besides its
# pass-1/2 and MaxLex kernels
PATH_KERNELS = ("A4", "A2f", "A2b", "A3", "A5", "A6", "A7", "A8")
SHARDED_KERNELS = ("B2r", "B2g", "B3f", "B3b", "B3p", "B3t", "B3c", "A4v",
                   "A7v", "A8v")
# the column path's scans, and the kernels no end-to-end run launches (A9L:
# kernel A9 on europarl's lexicon as dense tables of 20,001^2 floats each,
# past DEV_DENSE_LIMIT, so no pipeline run builds them; phase 4b)
COLS_KERNELS = ("C1f", "C1b", "C1t")
OFF_PATH = ("C1p", "B4", "P1", "P2", "A9L")
# the end-to-end runs: (size, lcp_passes, sa_shards, scan_cols, must launch,
# must not)
RUNS = (
    ("medium", False, 0, False, PATH_KERNELS + ("A1", "A9"),
     ("B1p1", "B1p2") + SHARDED_KERNELS + COLS_KERNELS + OFF_PATH),
    ("europarl", False, 0, False, PATH_KERNELS + ("A1", "A10"),
     ("B1p1", "B1p2") + SHARDED_KERNELS + COLS_KERNELS + OFF_PATH),
    ("europarl", False, 4, False, SHARDED_KERNELS,
     ("A1", "A9", "A10", "B1p1", "B1p2") + PATH_KERNELS + COLS_KERNELS
     + OFF_PATH),
    ("europarl", False, 0, True,
     ("A1", "A4", "A3", "A6", "A7", "A8", "A10") + COLS_KERNELS,
     ("A2f", "A2b", "A5", "B1p1", "B1p2") + SHARDED_KERNELS + OFF_PATH),
    ("medium", True, 0, False, PATH_KERNELS + ("B1p1", "B1p2", "A9"),
     ("A1",) + SHARDED_KERNELS + COLS_KERNELS + OFF_PATH),
)

# the runs over europarl's persisted index (saved by RUNS' europarl run):
# (sa_shards, must launch); each must launch nothing else, so no A4 or A4v
# (the precompute is loaded, not run)
LOAD_RUNS = (
    (0, ("A1", "A2f", "A2b", "A3", "A5", "A6", "A7", "A8", "A10")),
    (4, ("B2r", "B2g", "B3f", "B3b", "B3p", "B3t", "B3c", "A7v", "A8v")),
)
# medium with query_batches=4: MaxLex scores on the host, so no A9 or A10
OVERLAP_KERNELS = PATH_KERNELS + ("A1",)
# the __global__ functions of medium's default path (``cli --profile``),
# by launch id
PROFILE_GLOBALS = {
    "A1": "refine_warp_kernel", "A4": "gap_check_kernel",
    "A2f": "scan_kernel", "A2b": "scan_kernel", "A3": "pcs_kernel",
    "A5": "two_kernel", "A6": "contig_kernel", "A7": "onegap_kernel",
    "A8": "twogap_kernel", "A9": "dense_quad_kernel",
}


def others(expect) -> tuple:
    """Every kernel id but those of ``expect``."""
    return tuple(k for k in KERNELS if k not in expect)

# The least time the card could take for a kernel's work: the larger of the
# bytes it must move over the memory rate and its integer operations over the
# peak rate (one H100 SXM: 3.35 TB/s, and 67 T/s, the data sheet's rate
# outside the tensor cores).  Per kernel id: (words read per item from the
# item-axis inputs, words gathered per item from the index, words written
# per item, integer operations per item), each counted once from the
# kernel's loops (the csrc notes); the per-pattern tables are counted once
# whole.  The searches' gathers depend on the data and are counted from
# this run's inputs (``tools.reads``, ``data_reads``: A1's and B2r's binary
# searches, A3's, B3p's and C1p's verification words, and the corpus words
# under the union of P1's and P2's windows), and so are the words of the
# functions that stop early: lookup1's scans count the corpus words that
# decide a candidate (up to the first dead move and the span limit), and
# the gap check only for an item whose candidate mask is non-zero; the gap
# check (A4, and in A2, A5, B3, C1) its RLP window up to
# the widest span, and its lr_tar words only where some move passes the
# first test; A5's scan its move words up to the first stop; A6's and A7's
# bodies the words of each growth step that runs and each window entry
# looked up; A8's the gaps' words only where the rule is valid.
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
WORK = {
    "A4": (1, 0, 1, 0),          # (+ the gap check's words)
    "A2f": (0, 2, 1, 300),       # SA word, gap-0 token (+ the window)
    "A2b": (0, 2, 1, 300),
    "A3": (0, 0, 1 / 32, 40),    # (+ pcs_reads: offs, pattab, rows, corpus)
    "A5": (0, 2, 1, 150),        # occurrence row (+ scan, gap check)
    "A6": (2, 1, 8, 0),          # SA word (+ contig_reads)
    "A7": (4, 0, 6, 200),        # (+ onegap_reads)
    "A8": (6, 0, 2, 150),        # (+ twogap_reads)
    "A9": (11, 16, 2, 200),      # 16 target tokens (+ maxlex_dense_reads)
    "A9L": (11, 16, 2, 200),
    "A10": (11, 16, 2, 200),     # 16 target tokens (+ maxlex_reads)
    "B2g": (1, 1, 1, 10),        # the owner's SA word (meta rows in L1)
    "B3f": (4, 4, 1, 300),       # 3 query tokens, gap-0 token (+ window)
    "B3b": (4, 4, 1, 300),
    "B3p": (6, 0, 1, 40),        # (+ pcs_reads: query tokens, corpus)
    "B3t": (2, 0, 2, 150),       # (+ scan, gap check)
    "B3c": (2, 0, 8, 0),         # A6 without its SA word
    "C1f": (6, 1, 1, 300),       # 6 columns, gap-0 token (+ the window)
    "C1b": (6, 1, 1, 300),
    "C1p": (8, 0, 1 / 32, 40),   # 8 columns (+ pcs_reads: corpus words)
    "C1t": (2, 0, 1, 150),       # (+ scan, gap check)
    "P1": (1, 0, 0, 32),         # the position (+ probe_reads), 32 adds
    "P2": (1, 0, 32, 0),         # and the row written
}
for _v, _k in VIEW_ROWS.items():
    WORK[_v] = WORK[_k]
# the rows whose words are counted from each launch's items (``data_reads``):
# lookup1's scans, the gap check, A5's, A6's, A7's and A8's bodies
SCAN_ROWS = ("A2f", "A2b", "C1f", "C1b", "B3f", "B3b")
GAP_ROWS = ("A4", "A4v")
TWO_ROWS = ("A5", "C1t", "B3t")
CONTIG_ROWS = ("A6", "B3c", "B4")
ONEGAP_ROWS = ("A7", "A7v")
TWOGAP_ROWS = ("A8", "A8v")
MAXLEX_ROWS = ("A10",)
DENSE_ROWS = ("A9", "A9L")
LCP_ROWS = ("B1p1", "B1p2")
REFINE_ROWS = ("A1", "B2r")
PCS_ROWS = ("A3", "B3p", "C1p")
PROBE_ROWS = ("P1", "P2")
# integer operations: the gap check's RLP window, prefix scan and first test
# per item, and its 16 x 16 fold over the lr_tar window per item where some
# move passes the first test; A6's body per needed word (unpack, compare,
# min/max, prefix), per outer growth step run (both sides' tests, flag
# updates, the whole-span checks) and per inner step run; A7's and A8's
# bodies per needed word as A6's, and A7's per side step run (its tests and
# checks)
GAP_OPS, FOLD_OPS = 200, 1500
CONTIG_WORD_OPS, CONTIG_STEP_OPS, CONTIG_INNER_OPS = 10, 100, 30
ONEGAP_STEP_OPS = 50
# A10 per bisection step: midpoint, compare, two selects
MAXLEX_STEP_OPS = 4
# B1 per search or walk step: the midpoint, the skip and its compares, the
# state updates (the compare's per-token work is in its words)
LCP_STEP_OPS = 30
# A1 and B2r per bisection step: the midpoint, the compare, two selects
REFINE_STEP_OPS = 8
# ``check_edges``: item counts that leave partial half-warps and warps, and
# span limits from the narrowest to the default
EDGE_ITEMS = (1, 15, 17, 33)
EDGE_MRS = (1, 2, 8, 15)
EDGE_MSYM = (2, 3, 5)    # A6, B3c, A7, A7v
# argument positions of the per-pattern table and count prefix (A3's:
# pcs_reads)
TABLE_ARGS = {"A2f": (4, 5), "A2b": (4, 5), "A5": (5, 6)}
# A3's, B3p's and C1p's edge launches: item counts around a warp
PCS_EDGE_ITEMS = (1, 15, 17, 31, 32, 33)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _load_tool(name: str):
    """A generator module from tools/, imported by its path."""
    spec = importlib.util.spec_from_file_location(
        f"_smoke_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_corpus(size: str):
    """(f, e, a, lex_tokens, queries) of a benchmark size, from its seeds."""
    if size == "medium":
        import random
        mf = _load_tool("make_fixture")
        rng = random.Random(20260817)
        f_lines, e_lines, a_lines = mf.make_parallel_corpus(rng, 20000)
        lex_lines = mf.make_lex_file(rng, f_lines, e_lines, a_lines)
        q_lines = mf.make_queries(rng, f_lines, 32)
        return f_lines, e_lines, a_lines, " ".join(lex_lines).split(), q_lines
    if size == "europarl":
        mb = _load_tool("make_bigcorpus")
        f_text, e_text, a_lines, lex_tokens = mb.make_big_corpus(
            1_000_000, vocab=20000, seed=20260817)
        return f_text, e_text, a_lines, lex_tokens, mb.make_big_queries(
            f_text, 64)
    raise ValueError(size)


def grammar_hash(per_query_lines) -> str:
    h = hashlib.sha256()
    for lines in per_query_lines:
        for ln in lines:
            h.update(ln.encode())
            h.update(b"\n")
        h.update(b"\x00")
    return h.hexdigest()


class Capture:
    """Wraps the kernel wrappers the pipeline calls, keeping the arguments of
    each kernel's largest launch and, for a kernel on a shard's views, of
    its largest launch on each shard (for phase 4), and the items per
    kernel since ``items`` was last cleared."""

    def __init__(self):
        from cgx_tpu_torch.extract import device as xdev
        from cgx_tpu_torch.features import maxlex as ml
        from cgx_tpu_torch.parallel import dist
        from cgx_tpu_torch.parallel import sharded as shx
        from cgx_tpu_torch.search import lookup, passes
        from cgx_tpu_torch.search import precompute as pcx
        from cgx_tpu_torch.tools import gather_probe as gp
        from cgx_tpu_torch.utils.views import OffsetView

        def on_view(k):     # A4, A7 and A8 on a shard's views count as Kv
            return lambda a: k + "v" if isinstance(a[0], OffsetView) else k
        # wrapper -> (kernel id of a call, item count of a call)
        self.sites = {
            (passes, "refine_chunk"): (lambda a: "A1", lambda a: a[3].shape[0]),
            (pcx, "gap_check"): (on_view("A4"), lambda a: a[2].shape[0]),
            (lookup, "scan"): (lambda a: "A2f" if a[9] else "A2b",
                               lambda a: a[6]),
            (lookup, "pcs"): (lambda a: "A3", lambda a: a[4]),
            (lookup, "two"): (lambda a: "A5", lambda a: a[7]),
            (xdev, "contig"): (lambda a: "A6", lambda a: a[4].shape[0]),
            (xdev, "onegap"): (on_view("A7"), lambda a: a[3].shape[0]),
            (xdev, "twogap"): (on_view("A8"), lambda a: a[3].shape[0]),
            (ml, "accum_dense"): (lambda a: "A9", lambda a: a[4].shape[0]),
            (ml, "accum_range"): (lambda a: "A10", lambda a: a[7].shape[0]),
            (passes, "pass1"): (lambda a: "B1p1", lambda a: a[5].shape[0]),
            (passes, "pass2"): (lambda a: "B1p2", lambda a: a[5].shape[0]),
            (shx, "refine_sharded"): (lambda a: "B2r",
                                      lambda a: a[2].shape[0]),
            (shx, "gather_sa_sharded"): (lambda a: "B2g",
                                         lambda a: a[1].shape[0]),
            (lookup, "fwd_items"): (lambda a: "B3f", lambda a: a[4].shape[0]),
            (lookup, "bwd_items"): (lambda a: "B3b", lambda a: a[4].shape[0]),
            (lookup, "pcs_items"): (lambda a: "B3p", lambda a: a[2].shape[0]),
            (lookup, "two_items"): (lambda a: "B3t", lambda a: a[3].shape[0]),
            (xdev, "contig_pos"): (lambda a: "B3c", lambda a: a[3].shape[0]),
            (lookup, "scan_cols"): (lambda a: "C1f" if a[11] else "C1b",
                                    lambda a: a[3].shape[0]),
            (lookup, "pcs_cols"): (lambda a: "C1p", lambda a: a[1].shape[0]),
            (lookup, "two_packed"): (lambda a: "C1t",
                                     lambda a: a[3].shape[0]),
            (dist, "dp_step"): (lambda a: "B4",
                                lambda a: a[7].shape[0] + a[9].shape[0]),
            (gp, "gather_sum"): (lambda a: "P1", lambda a: a[1].shape[0]),
            (gp, "gather_rows"): (lambda a: "P2", lambda a: a[1].shape[0]),
        }
        self.calls = {}          # kernel -> (n, args)
        self.shard_calls = {}    # (kernel, view offset) -> (n, args)
        self.dp_calls = []       # every B4 call's args, in shard order
        self.items = {}          # kernel -> items
        self.originals = {site: getattr(*site) for site in self.sites}
        self.view_type = OffsetView

    def __enter__(self):
        for site, (kernel_of, count_of) in self.sites.items():
            real = self.originals[site]

            def hook(*args, _real=real, _k=kernel_of, _n=count_of):
                k, n = _k(args), _n(args)
                self.items[k] = self.items.get(k, 0) + n
                if n > self.calls.get(k, (-1, None))[0]:
                    self.calls[k] = (n, args)
                if k == "B4":
                    self.dp_calls.append(args)
                if isinstance(args[0], self.view_type):
                    key = (k, int(args[0].off))
                    if n > self.shard_calls.get(key, (-1, None))[0]:
                        self.shard_calls[key] = (n, args)
                return _real(*args)
            setattr(*site, hook)
        return self

    def __exit__(self, *exc):
        for site, real in self.originals.items():
            setattr(*site, real)


_CORPORA = {}


def run_e2e(size: str, device: str, capture: Capture, golden: dict,
            expect: tuple, lcp_passes: bool = False, forbid: tuple = (),
            sa_shards: int = 0, scan_cols: bool = False,
            index_dir: str = None, query_batches: int = 0):
    """One end-to-end run -> (its launch counts, its PipelineResult, its
    own peak device bytes: the peak less what was allocated before it, such
    as the earlier runs' tensors the capture holds).  ``index_dir``: the run
    saves its index there, or loads it when the dir holds one;
    ``query_batches``: ``run_pipeline_overlap`` over that many batches, whose
    summed pattern counters are not the golden's (its lines are)."""
    import torch
    from cgx_tpu_torch.config import DEFAULT_CONFIG
    from cgx_tpu_torch.kernels import build as kb
    from cgx_tpu_torch.pipeline import run_pipeline, run_pipeline_overlap
    t0 = time.perf_counter()
    if size not in _CORPORA:
        _CORPORA[size] = make_corpus(size)
    data = _CORPORA[size]
    gen_s = time.perf_counter() - t0
    kb.LAUNCHES.clear()
    capture.items.clear()
    cuda = torch.device(device).type == "cuda"
    held = torch.cuda.memory_allocated() if cuda else 0
    t0 = time.perf_counter()
    kw = dict(device=device, lcp_passes=lcp_passes, sa_shards=sa_shards,
              scan_cols=scan_cols, index_dir=index_dir)
    if query_batches:
        res = run_pipeline_overlap(*data, DEFAULT_CONFIG,
                                   query_batches=query_batches, **kw)
    else:
        res = run_pipeline(*data, DEFAULT_CONFIG, **kw)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_peak = res.timing.peak_memory() - held
    loaded = "indexload" in res.timing.as_dict()
    what = size + (" (index loaded)" if loaded else "") + (
        f" ({query_batches} query batches)" if query_batches else "")
    launches = check_launches(what, expect, forbid)
    lines = res.per_query_lines
    ok_shape = len(lines) == len(data[4]) and all(
        ln.startswith("[X] ||| ") for q in lines for ln in q)
    ghash = grammar_hash(lines)
    want = golden[size]
    counters_off = {k: (res.counters[k], v) for k, v in want.items()
                    if k in res.counters and res.counters[k] != v
                    and not query_batches}
    lines_ok = res.counters["total_lines"] == want["lines"]
    print(json.dumps({
        "phase": "e2e", "size": size, "device": device,
        "lcp_passes": lcp_passes, "sa_shards": sa_shards,
        "scan_cols": scan_cols, "index_dir": index_dir is not None,
        "index_loaded": loaded, "query_batches": query_batches,
        "corpus_gen_s": gen_s, "wall_s": wall,
        "phases_s": res.timing.as_dict(),
        "peak_mem_bytes": res.timing.peak_memory(),
        "held_before_bytes": held, "run_peak_mem_bytes": run_peak,
        "counters": res.counters, "launches": launches,
        "items": dict(capture.items),
        "grammar_sha256": ghash, "golden_ok": ghash == want["sha256"]}),
        flush=True)
    if not ok_shape:
        fail(f"{what}: malformed grammar lines")
    if counters_off or not lines_ok:
        fail(f"{what}: counters (port, JAX) differ: {counters_off}, lines "
             f"{res.counters['total_lines']} vs {want['lines']}")
    if ghash != want["sha256"]:
        fail(f"{what}: grammar hash {ghash[:16]} != golden "
             f"{want['sha256'][:16]}")
    return launches, res, run_peak


def check_launches(what: str, expect, forbid, counts=None) -> dict:
    """The launch counts since the last reset (or ``counts``, read
    earlier); fails unless every kernel in ``expect`` launched and none in
    ``forbid`` did."""
    from cgx_tpu_torch.kernels import build as kb
    counts = kb.LAUNCHES if counts is None else counts
    launches = {k: counts.get(k, 0) for k in KERNELS}
    missing = [k for k in expect if launches[k] == 0]
    if missing:
        fail(f"{what}: kernels {missing} never launched on the main path "
             f"(launches {launches})")
    stray = [k for k in forbid if launches[k] != 0]
    if stray:
        fail(f"{what}: kernels {stray} launched on a path without them "
             f"(launches {launches})")
    return launches


def check_lcp_passes(res) -> dict:
    """Both LCP passes on a run's index and queries give the refinement's
    up, down and longestmatch (pass 2: every range) -> the passes' launch
    counts (B1p1, B1p2: the launches of europarl's largest ones)."""
    import numpy as np
    import torch
    from cgx_tpu_torch.kernels import build as kb
    from cgx_tpu_torch.search import passes
    t0 = time.perf_counter()
    r1, r2 = passes.refine_passes(res.index, res.queries)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    kb.LAUNCHES.clear()
    l1 = passes.pass1_lcp(res.index, res.queries)
    l2 = passes.pass2_lcp(res.index, res.queries, l1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = check_launches("lcp_passes", LCP_ROWS,
                              [k for k in KERNELS if k not in LCP_ROWS])
    off = [f for f in ("up", "down", "longestmatch")
           if not np.array_equal(getattr(l1, f), getattr(r1, f))]
    off += [f"pass2.{f}" for f in ("connectoffset", "up", "down")
            if not np.array_equal(getattr(l2, f), getattr(r2, f))]
    print(json.dumps({
        "phase": "lcp_passes", "reflen": res.index.reflen,
        "pass1_tokens": len(l1.up), "pass2_items": len(l2.up),
        "refine_s": t1 - t0, "lcp_s": t2 - t1, "equal": not off,
        "launches": {k: v for k, v in launches.items() if v}}), flush=True)
    if off:
        fail(f"LCP passes differ from the refinement in {off}")
    return launches


def check_dense_large(res, capture: Capture) -> dict:
    """Phase 4b: kernel A9 over europarl's lexicon as dense [ns, nt] tables
    (built by ``lex_tables`` with DEV_DENSE_LIMIT lifted past ns * nt; no
    pipeline run builds them) on the rules of A10's largest launch: its
    features must be A10's, bit for bit -> its launch counts (as A9L)."""
    import types
    import torch
    from cgx_tpu_torch.features import maxlex as ml
    from cgx_tpu_torch.kernels import build as kb
    index = res.index
    lex = types.SimpleNamespace(lex_key=index.lex_key,
                                lex_val1_host=index.lex_val1_host,
                                lex_val2_host=index.lex_val2_host,
                                device=torch.device("cuda"),
                                maxlex_tables=None)
    t0 = time.perf_counter()
    limit = ml.DEV_DENSE_LIMIT
    ml.DEV_DENSE_LIMIT = 1 << 62
    try:
        mode, (L1, L2) = ml.lex_tables(lex)
    finally:
        ml.DEV_DENSE_LIMIT = limit
    build_s = time.perf_counter() - t0
    _, rng_args = capture.calls["A10"]
    args = (L1, L2, *rng_args[5:14])
    dense = capture.originals[(ml, "accum_dense")]     # not captured again
    kb.LAUNCHES.clear()
    fge, egf = dense(*args)
    torch.cuda.synchronize()
    launches = check_launches("dense_large", ("A9",),
                              [k for k in KERNELS if k != "A9"])
    want = capture.originals[(ml, "accum_range")](*rng_args)
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip((fge, egf), want))
    capture.calls["A9L"] = (len(fge), args)
    print(json.dumps({
        "phase": "dense_large", "mode": mode, "ns": L1.shape[0],
        "nt": L1.shape[1], "table_bytes": 2 * L1.numel() * 4,
        "dense_limit": limit, "rules": len(fge), "build_s": build_s,
        "equals_A10": same}), flush=True)
    if mode != "dense" or L1.numel() <= limit:
        fail(f"dense_large: tables {mode} {tuple(L1.shape)} are not dense "
             f"past the limit {limit}")
    if not same:
        fail("dense_large: A9's features on the dense tables differ from "
             "A10's on the row ranges")
    return {"A9L": launches["A9"]}


def check_query_dp(res, capture: Capture) -> dict:
    """Phase 4: the query-DP step over four shards on the card, on a run's
    index, queries and blocks -> its launch counts."""
    import numpy as np
    import torch
    from cgx_tpu_torch.config import DEFAULT_CONFIG as cfg
    from cgx_tpu_torch.extract import device as xdev
    from cgx_tpu_torch.kernels import build as kb
    from cgx_tpu_torch.parallel import dist
    from cgx_tpu_torch.search import passes
    index, queries = res.index, res.queries
    want_lm = passes.refine_passes(index, queries)[0].longestmatch
    _, sa_pos, lms = dist.contig_occurrences(res.blocks, cfg)
    devices = dist.make_mesh(devices=["cuda:0"] * 4)
    kb.LAUNCHES.clear()
    capture.items.clear()
    capture.dp_calls.clear()
    t0 = time.perf_counter()
    lm, n_match, n_rules = dist.run_sharded_search(devices, index, queries,
                                                   res.blocks, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_launches("query_dp", ("B4",),
                              [k for k in KERNELS if k != "B4"])
    if launches["B4"] != len(devices):
        fail(f"query_dp: B4 launched {launches['B4']} times, not once per "
             f"shard ({len(devices)})")
    # every shard against its plain version; the real items' extraction
    # against A6 on the same SA positions; the counts against the plain sum
    step = capture.originals[(dist, "dp_step")]    # not captured again
    err, ex, plain_rules = 0.0, [], 0
    for s, args in enumerate(capture.dp_calls):
        err = max(err, _bit_equal(f"B4@shard{s}", step, dist.dp_step_plain,
                                  args, "cuda"))
        ex.append(step(*args)[1])
        plain_rules += int(dist.dp_step_plain(*args)[2][1])
    m = len(sa_pos)
    ex = torch.cat(ex, dim=1)[:, :m]
    a6 = xdev.contig(index.refstr_padded, index.sa, index.rlp, index.lr_tar,
                     *(torch.from_numpy(x).cuda() for x in (sa_pos, lms)),
                     cfg.max_rule_span, cfg.max_rule_symbols)
    torch.cuda.synchronize()
    checks = {
        "lm_equals_refinement": bool(np.array_equal(lm, want_lm)),
        "n_match_equals_matches": n_match == int((lm > 0).sum()),
        "extraction_equals_A6": bool(torch.equal(ex, a6)),
        "n_rules_equals_plain": n_rules == dist.wrap32(plain_rules),
    }
    print(json.dumps({
        "phase": "query_dp", "shards": len(devices),
        "devices": [str(d) for d in devices], "pass1_tokens": len(lm),
        "items": m, "n_match": n_match, "n_rules": n_rules, "wall_s": wall,
        "launches": {k: v for k, v in launches.items() if v},
        "max_abs_err": err, **checks}), flush=True)
    off = [k for k, v in checks.items() if not v]
    if off:
        fail(f"query_dp: {off}")
    return launches


def check_pcs_cols(capture: Capture) -> dict:
    """Phase 5: C1p on A3's largest launch, its items materialised into
    columns on the host -> its launch counts."""
    import numpy as np
    import torch
    from cgx_tpu_torch.engine import materialize_items
    from cgx_tpu_torch.kernels import build as kb
    from cgx_tpu_torch.search import lookup
    refstr, pcrows, pattab, offs, n, mrs = capture.calls["A3"][1]
    tab, rows = pattab.cpu().numpy(), pcrows.cpu().numpy()
    item_pat, tx = materialize_items(np.diff(offs.cpu().numpy()))
    occ = rows[np.clip(tab[item_pat, 0] + tx, 0, len(rows) - 1)]
    cols = [occ[:, 0], occ[:, 1]] + [tab[item_pat, c] for c in range(1, 7)]
    cols = [torch.from_numpy(np.ascontiguousarray(c, np.int32)).cuda()
            for c in cols]
    kb.LAUNCHES.clear()
    capture.items.clear()
    got = lookup.pcs_cols(refstr, *cols, mrs)
    torch.cuda.synchronize()
    launches = check_launches("columns", ("C1p",),
                              [k for k in KERNELS if k != "C1p"])
    want = lookup.pcs(refstr, pcrows, pattab, offs, n, mrs)

    def bits(words):
        return np.unpackbits(words.cpu().numpy().view(np.uint8),
                             bitorder="little")[:n]
    same = bool(np.array_equal(bits(got), bits(want)))
    print(json.dumps({"phase": "columns", "kernel": "C1p", "items": n,
                      "ok_bits": int(bits(got).sum()),
                      "equals_A3": same}), flush=True)
    if not same:
        fail("columns: C1p's ok bits differ from A3's on the same items")
    return launches


def probe_inputs(capture: Capture) -> dict:
    """The gather probe's inputs on the card: its defaults, and europarl's
    corpus at the scan starts of A2b's largest launch -> {name: (ref,
    pos)}."""
    import numpy as np
    import torch
    from cgx_tpu_torch.engine import materialize_items
    from cgx_tpu_torch.tools import gather_probe as gp
    refstr, _, _, sa, pattab, offs = capture.calls["A2b"][1][:6]
    tab, sa_h = pattab.cpu().numpy(), sa.cpu().numpy()
    item_pat, tx = materialize_items(np.diff(offs.cpu().numpy()))
    starts = sa_h[np.clip(tab[item_pat, 0] + tx, 0, len(sa_h) - 1)]
    starts = np.minimum(starts[:len(starts) // gp.BLK * gp.BLK],
                        refstr.shape[0] - gp.W).astype(np.int32)
    return {"defaults": tuple(torch.from_numpy(a).cuda() for a in
                              gp.probe_data(131072, 1_000_000)),
            "europarl_A2b": (refstr, torch.from_numpy(starts).cuda())}


def check_probe(capture: Capture) -> dict:
    """Phase 6: the gather probe at its defaults and on europarl's corpus
    at the scan starts of A2b's largest launch -> its launch counts."""
    import torch
    from cgx_tpu_torch.kernels import build as kb
    from cgx_tpu_torch.tools import gather_probe as gp
    inputs = probe_inputs(capture)
    kb.LAUNCHES.clear()
    capture.items.clear()
    results = {name: gp.run_probe(ref, pos, reps=10)
               for name, (ref, pos) in inputs.items()}
    torch.cuda.synchronize()
    launches = check_launches("probe", ("P1", "P2"),
                              [k for k in KERNELS if k not in ("P1", "P2")])
    for name, (ref, pos) in inputs.items():
        res = results[name]
        want = res["plain_gather"][2]
        bad = [k for k in ("library_unfold", "P1", "P2") if res[k][2] != want]
        for k, kernel, plain in (("P1", gp.gather_sum, gp.gather_sum_plain),
                                 ("P2", gp.gather_rows,
                                  gp.gather_rows_plain)):
            _bit_equal(f"{k}@{name}", kernel, plain, (ref, pos), "cuda")
        print(json.dumps({
            "phase": "probe", "inputs": name, "items": int(pos.shape[0]),
            "corpus_words": int(ref.shape[0]),
            **{k: {"ms": ms, "words_per_s": rate, "checksum": ck}
               for k, (ms, rate, ck) in res.items()},
            "checksums_equal": not bad}), flush=True)
        if bad:
            fail(f"probe {name}: checksums of {bad} differ from the plain "
                 f"gather's")
    return launches


def _time_ms(fn, device) -> tuple:
    """(mean milliseconds per call on the device timeline, the calls timed):
    events around a run of calls after one warm-up call."""
    import torch
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3, 1
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(3, min(50, int(200.0 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, reps


def _kernel_names() -> list:
    """The ``__global__`` names that the csrc/ sources launch
    (``name<<<...>>>``)."""
    import re
    csrc = os.path.join(ROOT, "cgx_tpu_torch", "csrc")
    names = set()
    for f in sorted(os.listdir(csrc)):
        if f.endswith(".cu"):
            with open(os.path.join(csrc, f), encoding="utf-8") as fh:
                names |= set(re.findall(r"(\w+)\s*<<<", fh.read()))
    return sorted(names)


def _device_ms(fn, reps: int) -> dict:
    """``fn`` run ``reps`` times more under ``torch.profiler``: the device's
    own time of the csrc kernels it launched, summed by kernel name and
    divided by the calls -> {"device_ms": ms or None, "device_kernels":
    the names seen} (None, with "device_ms_why", where two profiler windows
    saw no device time for them)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    pat = re.compile(r"\b(" + "|".join(_kernel_names()) + r")\b")
    total, seen = 0.0, set()
    for windows in (1, 2):      # a second window where the first saw none
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            m = pat.search(ev.key)
            if m is None:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            total += us
            seen.add(m.group(1))
        if total > 0:
            break
    if total <= 0:
        return {"device_ms": None, "device_kernels": sorted(seen),
                "device_ms_why": "two profiler windows recorded no device "
                                 "time for the csrc kernels"}
    return {"device_ms": total / 1e3 / reps, "device_kernels": sorted(seen),
            "device_windows": windows}


def data_reads(k: str, n: int, args) -> tuple:
    """(words, integer operations, printed counts) that the data of one
    launch of kernel ``k`` decides, beyond ``WORK``'s fixed counts per item
    (``tools.reads``)."""
    import torch
    from cgx_tpu_torch.search import lookup
    from cgx_tpu_torch.tools import reads
    from cgx_tpu_torch.utils.views import take
    if k in SCAN_ROWS:
        if k in ("A2f", "A2b"):
            refstr, rlp, lr_tar, sa, pattab, offs, _, mrs, mgs, fwd = args
            f, tx = lookup._expand(pattab, offs, n)
            items = (take(sa, f[:, 0] + tx), f[:, 1], f[:, 2], f[:, 3:6])
        elif k in ("C1f", "C1b"):
            refstr, rlp, lr_tar, gostart, sl, el, w0, w1, w2, mrs, mgs, \
                fwd = args
            items = (gostart, sl, el, torch.stack([w0, w1, w2], dim=1))
        else:
            refstr, rlp, lr_tar, qtok, gostart, sl, el, qpos, mrs, mgs = args
            fwd = k == "B3f"
            items = (gostart, sl, el,
                     lookup._scan_want(qtok, qpos, sl, fwd))
        cand, window, gap, ok = reads.scan_reads(refstr, rlp, lr_tar, *items,
                                                 mrs, mgs, fwd)
        return (window + gap, cand * GAP_OPS + ok * FOLD_OPS,
                {"candidate_items": cand, "candidate_share": cand / n,
                 "window_words": window, "window_words_per_item": window / n,
                 "gap_words": gap, "gap_first_test_items": ok})
    if k in ONEGAP_ROWS:
        words, steps = reads.onegap_reads(*args)
        return (words, CONTIG_WORD_OPS * words + ONEGAP_STEP_OPS * steps,
                {"words": words, "words_per_item": words / max(n, 1),
                 "growth_steps": steps})
    if k in TWOGAP_ROWS:
        words, valid = reads.twogap_reads(*args)
        return (words, CONTIG_WORD_OPS * words,
                {"words": words, "words_per_item": words / max(n, 1),
                 "valid_rules": valid})
    if k in DENSE_ROWS:
        words = reads.maxlex_dense_reads(*args[:3], *args[4:])
        return (words, 0, {"words": words,
                           "words_per_rule": words / max(n, 1)})
    if k in REFINE_ROWS:
        words, steps = reads.refine_reads(*args)
        return (words, REFINE_STEP_OPS * steps,
                {"words": words, "words_per_lane": words / max(n, 1),
                 "bisection_steps": steps})
    if k in PCS_ROWS:
        words = reads.pcs_reads(k, *args)
        extra = {"words": words, "words_per_item": words / max(n, 1)}
        if k == "A3":   # the rounds a warp takes to resolve its patterns
            _, search, windows = reads.pcs_rounds(args[3].cpu().numpy(), n)
            rounds = search + windows
            extra.update(rounds_mean=float(rounds.mean()),
                         rounds_max=int(rounds.max()),
                         windows_max=int(windows.max()),
                         wide_warps=int((windows > 1).sum()),
                         warps=len(windows))
        return words, 0, extra
    if k in PROBE_ROWS:     # the corpus words under the windows' union
        ref, pos = args[:2]
        words = reads.probe_reads(ref.shape[0], pos)
        return words, 0, {"words": words, "words_per_item": words / max(n, 1)}
    if k in LCP_ROWS:
        words, steps, chain_max, chain_mean = reads.lcp_reads(*args)
        return (words, LCP_STEP_OPS * steps,
                {"words": words, "words_per_lane": words / max(n, 1),
                 "steps": steps, "chain_max": chain_max,
                 "chain_mean": chain_mean})
    if k in MAXLEX_ROWS:
        words, searches, steps = reads.maxlex_reads(*args[:6], *args[7:])
        return (words, MAXLEX_STEP_OPS * steps,
                {"words": words, "searches": searches,
                 "searches_per_rule": searches / max(n, 1),
                 "bisection_steps": steps})
    if k in GAP_ROWS:
        rlp, lr_tar, gostart, mrs, mgs, fwd = args
        words, ok = reads.gap_reads(rlp, lr_tar,
                                    gostart + 1 if fwd else gostart - 1,
                                    mgs - 1, mrs, fwd)
    elif k in TWO_ROWS:
        if k == "A5":
            refstr, rlp, lr_tar, ogrows, pcrows, pattab, offs, _, mrs, mgs = \
                args
            f, tx = lookup._expand(pattab, offs, n)
            row = f[:, 0] + tx
            occ = torch.where((f[:, 1] > 0)[:, None], take(pcrows, row),
                              take(ogrows, row))
            items = (occ[:, 0], occ[:, 1])
        else:
            refstr, rlp, lr_tar, pstart, plen, mrs, mgs = args
            items = (pstart, plen)
        words, ok = reads.two_reads(refstr, rlp, lr_tar, *items, mrs, mgs)
    elif k == "B4":     # B1's pass 1 on the lanes, A6's body on the items
        refstr, sa, lcpl, lcpr, rlp, lr_tar, qtok, toks, sls, sa_pos, lm, \
            reflen, mrs, msym = args[:14]
        words, lsteps, steps, inner, chain_max, chain_mean = reads.dp_reads(
            refstr, sa, lcpl, lcpr, qtok, toks, sls, reflen,
            take(sa, sa_pos), lm, rlp, lr_tar, mrs, msym)
        n = sa_pos.shape[0]
        return (words, CONTIG_WORD_OPS * words + CONTIG_STEP_OPS * steps
                + CONTIG_INNER_OPS * inner + LCP_STEP_OPS * lsteps,
                {"words": words, "words_per_item": words / max(n, 1),
                 "growth_steps": steps, "inner_steps": inner,
                 "lane_steps": lsteps, "chain_max": chain_max,
                 "chain_mean": chain_mean})
    else:
        if k == "A6":
            refstr, sa, rlp, lr_tar, sa_pos, lm, mrs, msym = args
            items = (take(sa, sa_pos), lm)
        else:
            refstr, rlp, lr_tar, cs, lm, mrs, msym = args
            items = (cs, lm)
        words, steps, inner = reads.contig_reads(refstr, rlp, lr_tar, *items,
                                                 mrs, msym)
        return (words, CONTIG_WORD_OPS * words + CONTIG_STEP_OPS * steps
                + CONTIG_INNER_OPS * inner,
                {"words": words, "words_per_item": words / max(n, 1),
                 "growth_steps": steps, "inner_steps": inner})
    return (words, n * GAP_OPS + ok * FOLD_OPS,
            {"words": words, "words_per_item": words / max(n, 1),
             "gap_first_test_items": ok})


def work(k: str, n: int, args, words: int = 0, ops: int = 0) -> tuple:
    """(bytes, integer operations) that kernel ``k`` must move and do on
    the inputs of one launch over ``n`` items: ``WORK``'s counts per item,
    and ``words`` gathered and ``ops`` done in all as the data decides
    (``data_reads``)."""
    if k in REFINE_ROWS:   # the lanes' columns and outputs (+ refine_reads)
        depths = args[8] if k == "A1" else args[7]
        return 4 * (n * (4 + 2 * depths + 2) + words), ops
    if k in LCP_ROWS:   # the lanes' columns and outputs (+ lcp_reads)
        io = 2 + 6 if k == "B1p1" else 5 + 2
        return 4 * (n * io + words), ops
    if k == "B4":    # B1 pass 1 on the lanes, A6 on the items (+ both
        # bodies' words, data_reads)
        lanes, items = args[7].shape[0], args[9].shape[0]
        w_in, w_gather, w_out, _ = WORK["A6"]
        return (4 * (lanes * 8 + items * (w_in + w_gather + w_out) + words
                     + 2), ops)
    w_in, w_gather, w_out, per_item = WORK[k]
    tables = sum(args[i].numel() for i in TABLE_ARGS.get(k, ()))
    nbytes = 4 * (n * (w_in + w_gather + w_out) + tables + words)
    return nbytes, n * per_item + ops


def _bit_equal(k: str, kernel, plain, args, device: str) -> float:
    """Runs ``kernel`` and ``plain`` on ``args``; fails unless every output
    is bit-equal (float32 by bit pattern) -> the max abs difference."""
    import torch

    def outputs(fn):
        out = fn(*args)
        return list(out) if isinstance(out, (tuple, list)) else [out]
    ko = outputs(kernel)
    po = outputs(plain)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(ko, po):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{k}: output {tuple(a.shape)}/{a.dtype} vs plain "
                 f"{tuple(b.shape)}/{b.dtype}")
        if a.dtype == torch.float32:
            same = torch.equal(a.view(torch.int32), b.view(torch.int32))
            if not bool(torch.isfinite(a).all()):
                fail(f"{k}: non-finite features")
        else:
            same = torch.equal(a, b)
        d = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
        err = max(err, d)
        if not same:
            fail(f"{k}: kernel and plain version differ (max abs {d})")
    return err


def compare_kernels(capture: Capture, device: str, launches: dict,
                    shard_offsets: list) -> list:
    import functools
    import torch
    from cgx_tpu_torch.extract import device as xdev
    from cgx_tpu_torch.features import maxlex as ml
    from cgx_tpu_torch.parallel import dist
    from cgx_tpu_torch.parallel import sharded as shx
    from cgx_tpu_torch.search import lookup, passes
    from cgx_tpu_torch.search import precompute as pcx
    from cgx_tpu_torch.tools import gather_probe as gp
    pairs = {"A1": (passes.refine_chunk, passes.refine_chunk_plain),
             "A4": (pcx.gap_check, pcx.gap_check_plain),
             "A2f": (lookup.scan, lookup.scan_plain),
             "A2b": (lookup.scan, lookup.scan_plain),
             "A3": (lookup.pcs, lookup.pcs_plain),
             "A5": (lookup.two, lookup.two_plain),
             "A6": (xdev.contig, xdev.contig_plain),
             "A7": (xdev.onegap, xdev.onegap_plain),
             "A8": (xdev.twogap, xdev.twogap_plain),
             "A9": (ml.accum_dense, ml.accum_dense_plain),
             "A9L": (ml.accum_dense, ml.accum_dense_plain),
             "A10": (ml.accum_range, ml.accum_range_plain),
             "B1p1": (passes.pass1, passes.pass1_plain),
             "B1p2": (passes.pass2, passes.pass2_plain),
             "B2r": (shx.refine_sharded, shx.refine_sharded_plain),
             "B2g": (shx.gather_sa_sharded, shx.gather_sa_sharded_plain),
             "B3f": (lookup.fwd_items,
                     functools.partial(lookup.scan_items_plain, fwd=True)),
             "B3b": (lookup.bwd_items,
                     functools.partial(lookup.scan_items_plain, fwd=False)),
             "B3p": (lookup.pcs_items, lookup.pcs_items_plain),
             "B3t": (lookup.two_items, lookup.two_items_plain),
             "B3c": (xdev.contig_pos, xdev.contig_pos_plain),
             "A4v": (pcx.gap_check, pcx.gap_check_plain),
             "A7v": (xdev.onegap, xdev.onegap_plain),
             "A8v": (xdev.twogap, xdev.twogap_plain),
             "C1f": (lookup.scan_cols, lookup.scan_cols_plain),
             "C1b": (lookup.scan_cols, lookup.scan_cols_plain),
             "C1p": (lookup.pcs_cols, lookup.pcs_cols_plain),
             "C1t": (lookup.two_packed, lookup.two_packed_plain),
             "B4": (dist.dp_step, dist.dp_step_plain),
             "P1": (gp.gather_sum, gp.gather_sum_plain),
             "P2": (gp.gather_rows, gp.gather_rows_plain)}
    # one PyTorch call computing a kernel's function (P1: with its sum, a
    # second call), timed beside it only
    library = {"P1": lambda ref, pos: gp.library_rows(ref, pos).sum(
        dtype=torch.int32), "P2": gp.library_rows}
    rows = []
    for k, (kernel, plain) in pairs.items():
        if k not in capture.calls:
            fail(f"{k}: no launch captured on the main path")
        n, args = capture.calls[k]
        err = _bit_equal(k, kernel, plain, args, device)
        # the same kernel on each shard's largest launch: the first shard
        # (negative offset) and the last (clamped at the global end) must
        # be among them
        shards = []
        for (sk, off), (sn, sargs) in sorted(capture.shard_calls.items()):
            if sk == k:
                if sargs is not args:
                    err = max(err, _bit_equal(f"{k}@{off}", kernel, plain,
                                              sargs, device))
                shards.append({"view_offset": off, "lanes": sn})
        offs = {s["view_offset"] for s in shards}
        if shards and not {shard_offsets[0], shard_offsets[-1]} <= offs:
            fail(f"{k}: no launch on the first or last shard (offsets "
                 f"{sorted(offs)} of {shard_offsets})")
        ms, reps = _time_ms(lambda: kernel(*args), device)
        dev = _device_ms(lambda: kernel(*args), reps)
        plain_ms = _time_ms(lambda: plain(*args), device)[0]
        library_ms = (_time_ms(lambda: library[k](*args), device)[0]
                      if k in library else None)
        src, replaces = KERNELS[k]
        words = ops = 0
        extra = {}
        if k in (SCAN_ROWS + GAP_ROWS + TWO_ROWS + CONTIG_ROWS + ONEGAP_ROWS
                 + TWOGAP_ROWS + MAXLEX_ROWS + DENSE_ROWS + LCP_ROWS
                 + REFINE_ROWS + PCS_ROWS + PROBE_ROWS):
            words, ops, extra = data_reads(k, n, args)
        nbytes, ops = work(k, n, args, words, ops)
        bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
        ops_ms = ops / OPS_PER_S * 1e3
        row = {"name": k, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[k],
               "max_abs_err": err, "ms": ms,
               "device_ms": dev["device_ms"], "plain_ms": plain_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": library_ms}
        if k in VIEW_ROWS:     # the timed launch's view offset
            extra["view_offset"] = args[0].off
        if shards:
            extra["shards"] = shards
        print(json.dumps({"phase": "kernel", **row, "lanes": n,
                          "bytes": nbytes, "ops": ops, "bit_equal": True,
                          **{f: v for f, v in dev.items() if f != "device_ms"},
                          **extra}), flush=True)
        rows.append(row)
    return rows


def _edge_offs(rng, n: int):
    """The count prefix of ``n`` items over a few patterns, with empty
    patterns first, last and between -> int32 [D + 1]."""
    import numpy as np
    counts, left = [0], n
    while left:
        c = int(rng.integers(1, left + 1))
        counts += [c, 0] if rng.random() < 0.5 else [c]
        left -= c
    if counts[-1]:
        counts.append(0)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def _edge_starts(rng, edges, n: int, lo: int, hi: int):
    """Launches of ``n`` occurrences, each led by the edge positions
    rotated so that every edge comes first in one of them (all of them in
    one launch when they fit), the rest drawn from [lo, hi)."""
    import numpy as np
    turns = len(edges) if n < len(edges) else 1
    return [np.concatenate([np.roll(edges, -r), rng.integers(lo, hi, n)])[:n]
            .astype(np.int32) for r in range(turns)]


def _edge_picks(rng, n_edges: int, n_fill: int, n: int, turn: int):
    """Item picks of the launches of ``n`` items for span limit number
    ``turn``, as indices into the edges followed by the fill: one launch
    per edge for one item (the edges spread over the span limits), else one
    launch led by all edges, rotated, the rest drawn from the fill."""
    import numpy as np
    if n == 1:
        return [np.array([e]) for e in range(turn, n_edges, len(EDGE_MRS))]
    lead = np.roll(np.arange(n_edges), -int(rng.integers(n_edges)))
    return [np.concatenate([lead, n_edges + rng.integers(0, n_fill, n)])[:n]]


def _sentence_edges(refstr, reflen: int):
    """Corpus positions at the ends of a few sentences: either side of the
    first two separators and of one in the middle."""
    import numpy as np
    import torch
    sep = torch.nonzero(refstr[:reflen] == 1).flatten().cpu().numpy()
    pick = sep[[0, 1, len(sep) // 2]]
    return np.concatenate([pick - 1, pick + 1])


def _b2r_views(sidx, sa, refstr, reflen: int) -> dict:
    """B2r's tables of the europarl sharded index ``sidx`` laid out again
    for 1, 3 and 4 shards over the replicated SA and padded corpus (its
    first ``ref_glen`` words) by ``build_sharded_index``'s own slicing,
    ``rank_token_slices`` (fails unless the 4-shard layout equals
    ``sidx``'s) -> {S: index}."""
    import dataclasses
    import numpy as np
    import torch
    from cgx_tpu_torch.parallel.sharded import rank_token_slices
    dev = sa.device
    BH = sidx.BH
    FH = sidx.ref_l[0].shape[0] - sidx.B - BH
    # the replicated index pads its copy further
    refstr = refstr[:sidx.ref_glen].cpu().numpy()
    sa = sa.cpu().numpy()

    def rows(x):
        return [torch.from_numpy(r).to(dev) for r in x]
    views = {}
    for S in (1, 3, 4):
        sl = rank_token_slices(refstr, sa, reflen, S, BH, FH)
        views[S] = dataclasses.replace(
            sidx, S=S, B=sl["B"], BR=sl["BR"], sa_l=rows(sl["sa_l"]),
            ref_l=rows(sl["ref_l"]), rlp_l=[], lrt_l=[],
            src_off=sl["src_off"], rmeta=sl["rmeta"].astype(np.int32),
            smeta=sl["smeta"].astype(np.int32), _tables=None)
    v = views[4]
    same = (v.B == sidx.B and v.BR == sidx.BR
            and np.array_equal(v.rmeta, sidx.rmeta)
            and np.array_equal(v.smeta, sidx.smeta)
            and all(torch.equal(x, y) for x, y in zip(v.sa_l, sidx.sa_l))
            and all(torch.equal(x, y) for x, y in zip(v.ref_l, sidx.ref_l)))
    if not same:
        fail("B2r@edge: the 4-shard layout over the replicated arrays "
             "differs from the sharded run's index")
    views[4] = sidx
    return views


def refine_edges(capture: Capture, rng, reflen: int, sent) -> dict:
    """A1 and B2r against their plain versions on edge lanes over europarl's
    SA, the padded corpus as the query tokens: lanes at the corpus ends,
    either side of sentence separators and at the suffixes of the SA's
    first and last rows, empty intervals ([0, 0), [reflen, reflen) and
    inside), query tokens replaced by the largest token id, the sentinel and
    an id past both, and the query's end at and before d0; d0 0 (the whole
    SA) and 3 (each lane's own interval, from the plain version), 4 and 16
    depths, 1-33 lanes.  B2r runs the same lanes on the sharded run's index
    and on its layout for 1 and 3 shards (``_b2r_views``), with lanes also
    at the suffixes of the rows either side of each rank-shard boundary and
    at the positions just before each token-shard boundary, so that
    intervals' rows and their positions straddle shards; B2g on the same
    1, 3 and 4 shards, at ranks either side of each boundary and past both
    ends -> counts per kernel (B2r's per shard count too).  Every interval is an SA interval
    of suffixes that share their first d0 tokens, as on the main path
    (csrc/refine.cuh's premise)."""
    import numpy as np
    import torch
    from cgx_tpu_torch.parallel import sharded as shx
    from cgx_tpu_torch.search import passes
    sa, refstr = capture.calls["A1"][1][:2]
    top = int(refstr[:reflen - 1].max())
    head = sa[:reflen].cpu().numpy()
    edges = np.concatenate([[0, 1, reflen - 2, reflen - 1], sent,
                            head[[0, 1, reflen - 2, reflen - 1]]])
    views = _b2r_views(capture.calls["B2r"][1][0], sa[:reflen].contiguous(),
                       refstr, reflen)
    # some lanes' tokens replaced (at the lane's own depth d0 .. d0 + 2)
    swaps = np.array([top, top + 1, top + 2, top, 0])
    names = ("launches", "lanes", "empty_lanes", "past_end", "collapsed",
             "narrowed")
    stats = {"A1": dict.fromkeys(names, 0),
             "B2r": dict.fromkeys(names + ("rows_straddle",
                                           "positions_straddle"), 0)}
    stats["B2r"]["shards"] = {S: 0 for S in views}

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()

    # B2g, which shares B2r's owner division: ranks either side of every
    # rank-shard boundary, at both ends of the SA, past them (the last
    # shard's padding and beyond) and at int32's ends
    stats["B2g"] = {"launches": 0, "rows": 0, "unowned": 0}
    for S, v in views.items():
        rb = np.arange(1, S + 1) * v.BR
        rows = np.concatenate([
            [-2**31, -1, 0, 1, reflen - 1, reflen, 2**31 - 1],
            rb - 1, rb, rb + 1, rng.integers(0, reflen, 64)])
        _bit_equal(f"B2g@edge(S={S})", shx.gather_sa_sharded,
                   shx.gather_sa_sharded_plain, (v, dev(rows)), "cuda")
        st = stats["B2g"]
        st["launches"] += 1
        st["rows"] += len(rows)
        st["unowned"] += int(((rows < 0) | (rows >= reflen)).sum())

    def run(k, kernel, plain, args, lanes, what):
        outs = []

        def plain_once(*a):
            outs.append(plain(*a))
            return outs[-1]
        _bit_equal(f"{k}@edge({what})", kernel, plain_once, args, "cuda")
        toks, sls, lo, hi, d0, depths = lanes
        lo_f, hi_f = outs[-1][2].cpu().numpy(), outs[-1][3].cpu().numpy()
        live = hi > lo
        st = stats[k]
        st["launches"] += 1
        st["lanes"] += len(toks)
        st["empty_lanes"] += int((~live).sum())
        st["past_end"] += int((live & (sls < d0 + depths)).sum())
        st["collapsed"] += int((live & (hi_f <= lo_f)).sum())
        st["narrowed"] += int((live & (hi_f > lo_f)
                               & (hi_f - lo_f < hi - lo)).sum())
        return live

    for d0 in (0, 3):
        q = refstr.clone()
        for k, t in enumerate(swaps):
            q[int(min(edges[k] + d0 + k % 3, q.shape[0] - 1))] = int(t)
        for n in EDGE_ITEMS:
            for depths in (4, 16):
                for S in (None,) + tuple(views):
                    lane_edges = edges
                    if S is not None:   # rows and positions at the shards'
                        v = views[S]    # boundaries
                        rb = np.arange(1, S) * v.BR
                        tb = np.arange(1, S) * v.B
                        lane_edges = np.concatenate([
                            head[np.concatenate([rb - 1, rb])],
                            tb - 1, tb - 2, edges])
                    toks = np.concatenate([np.roll(lane_edges, -n),
                                           rng.integers(0, reflen, n)])[:n]
                    lo = np.zeros(n, np.int64)
                    hi = np.full(n, reflen, np.int64)
                    if d0:
                        _, _, lo_d, hi_d = passes.refine_chunk_plain(
                            sa, refstr, q, dev(toks), dev(np.full(n, 99)),
                            dev(lo), dev(hi), 0, d0)
                        lo, hi = lo_d.cpu().numpy(), hi_d.cpu().numpy()
                    sls = rng.choice([d0 - 1, d0, d0 + 1, d0 + 3, 40], n)
                    empty = rng.random(n) < 0.2
                    at = rng.choice([0, reflen, int(rng.integers(0, reflen))],
                                    n)
                    lo, hi = np.where(empty, at, lo), np.where(empty, at, hi)
                    lanes = (toks, sls, lo, hi, d0, depths)
                    lane_args = (dev(toks), dev(sls), dev(lo), dev(hi), d0,
                                 depths)
                    what = f"n={n},d0={d0},depths={depths}"
                    if S is None:
                        run("A1", passes.refine_chunk,
                            passes.refine_chunk_plain,
                            (sa, refstr, q, *lane_args), lanes, what)
                        continue
                    live = run("B2r", shx.refine_sharded,
                               shx.refine_sharded_plain,
                               (views[S], q, *lane_args), lanes,
                               f"S={S},{what}")
                    st = stats["B2r"]
                    st["shards"][S] += 1
                    for b in np.arange(1, S) * views[S].BR:
                        st["rows_straddle"] += int(
                            (live & (lo < b) & (hi > b)).sum())
                    first = head[np.clip(lo, 0, reflen - 1)]
                    last = head[np.clip(hi - 1, 0, reflen - 1)]
                    st["positions_straddle"] += int((live & (
                        first // views[S].B != last // views[S].B)).sum())
    return stats


def maxlex_edges(capture: Capture, rng, k: str) -> dict:
    """A10 (``k``, over europarl's row-range tables) or A9 (over medium's
    dense tables) against its plain version on edge rules over the tables
    and the target corpus of its largest launch: nsrc 0 and 5, the NULL
    source (-1), sources with no rows and ids past every row, the source
    with the most rows (A10: its range is exactly max_rows long; steps =
    bit_length(max_rows)) with target spans that hold its first and its
    last row's target, every target position kept and none, spans at and
    past both ends of the target corpus; the rest the main path's own
    rules; 1-33 rules a launch -> counts (rules with a probe found and
    none)."""
    import numpy as np
    import torch
    from cgx_tpu_torch.features import maxlex as ml
    args = capture.calls[k][1]
    if k == "A10":
        rs, re, lt, lnv1, lnv2, tgt, maxscore = args[:7]
        tables, real = args[:7], [a.cpu().numpy() for a in args[7:14]]
        steps = args[14]
        rows = (re - rs).cpu().numpy()
        big = int(rows.argmax())
        if steps != max(int(rows.max()).bit_length(), 1):
            fail(f"A10@edge: steps {steps} is not bit_length(max_rows "
                 f"{int(rows.max())})")
        lt_h = lt.cpu().numpy()
        # the targets of its first and last row
        big_tgt = [lt_h[int(rs[big])], lt_h[int(re[big]) - 1]]
        kernel, plain, tail = ml.accum_range, ml.accum_range_plain, (steps,)
    else:
        L2, tgt, maxscore = args[1], args[2], args[3]
        tables, real, tail = args[:4], [a.cpu().numpy()
                                        for a in args[4:11]], ()
        found = torch.isfinite(L2).cpu().numpy()
        rows = found.sum(axis=1)                # row s + 1: source id s
        big = int(rows.argmax())
        cols = np.flatnonzero(found[big])       # column t + 1: target t
        big_tgt = [cols[0] - 1, cols[-1] - 1]
        kernel, plain = ml.accum_dense, ml.accum_dense_plain
    tgt_h = tgt.cpu().numpy()
    nt = len(tgt_h)

    def first_at(t):        # a span start that holds target t at position 3
        hit = np.flatnonzero(tgt_h == t)
        return int(hit[0]) - 3 if len(hit) else 0
    big_t0 = [first_at(t) for t in big_tgt]
    empty_src = np.flatnonzero(rows == 0)
    srcs = [big - 1, -1, len(rows) - 1, len(rows) + 5] + (
        [int(empty_src[0]) - 1] if len(empty_src) else [])
    E = 16
    sp = np.full((E, ml.SRCW), -99)
    sp[1] = (srcs * 2)[:ml.SRCW]              # nsrc 5
    sp[2:, 0] = big - 1
    sp[2:, 1] = rng.choice(srcs, E - 2)
    sp[3, :] = -99                            # nsrc 0
    t0 = np.array([0, nt - 1, nt - 2, nt + 3] + big_t0 * 2
                  + list(rng.integers(0, nt, E - 8)))
    tend = rng.integers(0, ml.TPOSW, E)
    tend[:8] = ml.TPOSW - 1                   # every position kept
    g1, g11 = np.full(E, -1), np.full(E, -1)
    g1[8:10], g11[8:10] = 0, ml.TPOSW - 1     # none kept
    edge = [sp, t0, tend, g1, g11, np.full(E, -1), np.full(E, -1)]
    stats = {"launches": 0, "rules": 0, "found": 0, "none_found": 0,
             "max_rows": int(rows.max())}

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
    for n in EDGE_ITEMS:
        for turn in range(2):
            pick = rng.integers(0, len(real[1]), n)
            cols = [np.concatenate([np.roll(e, -(n + 7 * turn), 0), r[pick]])
                    [:n] for e, r in zip(edge, real)]
            call = (*tables, *map(dev, cols), *tail)
            _bit_equal(f"{k}@edge(n={n},turn={turn})", kernel, plain, call,
                       "cuda")
            fge, egf = (x.cpu().numpy() for x in plain(*call))
            hit = ((fge % np.float32(maxscore) != 0)
                   | (egf % np.float32(maxscore) != 0))
            stats["launches"] += 1
            stats["rules"] += n
            stats["found"] += int(hit.sum())
            stats["none_found"] += int((~hit).sum())
    return stats


def lcp_edges(capture: Capture, rng) -> dict:
    """B1p1 and B1p2 against their plain versions on edge lanes, over
    europarl's index and queries and over a small index of 70-token
    sentences (``long_corpus``: matches past 32 tokens, the warp's compare
    round): ``lcp_edge_lanes``, the rest the queries' own lanes; pass-2
    items of those lanes (``lcp_edge_items``), all from
    ``cgx_tpu_torch.tools.edges``; 1-33 lanes a launch
    -> counts per pass (lanes OOV, missing, hit, matched to the suffix end,
    stopped by an OOV token inside, past 32 tokens; items found and not,
    pinned off the midpoint, on width-2 windows, past 32 tokens)."""
    import numpy as np
    import torch
    from cgx_tpu_torch.config import ExtractorConfig
    from cgx_tpu_torch.index import container as tic
    from cgx_tpu_torch.preproc import corpus as tcp
    from cgx_tpu_torch.preproc import suffix_array as tsab
    from cgx_tpu_torch.search import passes
    from cgx_tpu_torch.tools import edges

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
    refstr, sa, lcpl, lcpr, qtok, toks, sls, reflen = \
        capture.calls["B1p1"][1]
    worlds = [("europarl", (refstr, sa, lcpl, lcpr, qtok, reflen), toks,
               sls)]
    f, e, a, lex, qlines = edges.long_corpus()
    src, tgt = tcp.load_source_corpus(f), tcp.load_target_corpus(e)
    idx = tic.build_index(src, tgt, tsab.build_index(src.str_),
                          tcp.load_alignment_fast(a, src, tgt),
                          tcp.load_lex_table(lex, src.vocab, tgt.vocab),
                          ExtractorConfig(), "cuda")
    qs = tcp.load_queries(qlines, src.vocab)
    worlds.append(("long", (idx.refstr_padded, idx.sa, *idx.lcp_tables(),
                            idx.query_tokens(qs), idx.reflen),
                   dev(np.arange(qs.totaltokens)),
                   dev(passes._suffix_lens(qs))))
    stats = {k: {"launches": 0, "lanes": 0} for k in LCP_ROWS}

    def add(k, name, count):
        stats[k][name] = stats[k].get(name, 0) + int(count)
    for name, arrays, toks, sls in worlds:
        q, edge_t, edge_sl = edges.lcp_edge_lanes(rng, arrays, toks,
                                                     sls)
        refstr, sa, lcpl, lcpr, _, reflen = arrays
        qd = dev(q)
        all_t = np.concatenate([edge_t, toks.cpu().numpy()])
        all_sl = np.concatenate([edge_sl, sls.cpu().numpy()])
        n_edge, n_fill = len(edge_t), len(toks)
        for n in EDGE_ITEMS:
            for turn in range(len(EDGE_MRS)):
                for pick in _edge_picks(rng, n_edge, n_fill, n, turn):
                    args = (refstr, sa, lcpl, lcpr, qd, dev(all_t[pick]),
                            dev(all_sl[pick]), reflen)
                    _bit_equal(f"B1p1@edge({name},n={n},first="
                               f"{all_t[pick[0]]})", passes.pass1,
                               passes.pass1_plain, args, "cuda")
                    lm = passes.pass1_plain(*args)[0].cpu().numpy()
                    t, sl = all_t[pick], all_sl[pick]
                    oov = q[t] == -1
                    add("B1p1", "launches", 1)
                    add("B1p1", "lanes", n)
                    add("B1p1", "oov", oov.sum())
                    add("B1p1", "missing", (~oov & (lm == 0)).sum())
                    add("B1p1", "hit", (lm > 0).sum())
                    add("B1p1", "suffix_end", ((lm > 0) & (lm == sl)).sum())
                    add("B1p1", "oov_inside",
                        ((lm > 0) & (lm < sl)
                         & (q[np.minimum(t + lm, len(q) - 1)] == -1)).sum())
                    add("B1p1", "past_32", (lm > 32).sum())
        p1 = [x.cpu().numpy() for x in passes.pass1_plain(
            refstr, sa, lcpl, lcpr, qd, dev(all_t), dev(all_sl), reflen)]
        edge, real = edges.lcp_edge_items(rng, all_t, p1)
        items = np.concatenate([edge, real])
        for n in EDGE_ITEMS:
            for turn in range(len(EDGE_MRS)):
                for pick in _edge_picks(rng, len(edge), len(real), n, turn):
                    it = items[pick]
                    args = (refstr, sa, lcpl, lcpr, qd,
                            *(dev(it[:, c]) for c in range(5)))
                    _bit_equal(f"B1p2@edge({name},n={n},first={it[0]})",
                               passes.pass2, passes.pass2_plain, args,
                               "cuda")
                    up = passes.pass2_plain(*args)[0].cpu().numpy()
                    add("B1p2", "launches", 1)
                    add("B1p2", "lanes", n)
                    add("B1p2", "found", (up >= 0).sum())
                    add("B1p2", "missing", (up == -1).sum())
                    add("B1p2", "pin_off_mid",
                        (it[:, 3] != (it[:, 2] + it[:, 4]) >> 1).sum())
                    add("B1p2", "width_2", (it[:, 4] - it[:, 2] == 2).sum())
                    add("B1p2", "past_32", (it[:, 1] > 32).sum())
    return stats


def _pcs_exits(cols, ok, mrs: int) -> dict:
    """The exits of ``pcs_warp`` that items (columns pstart, plen, sl, el)
    reach, from the plain version's ok bits -> counts."""
    import numpy as np
    ps, pl, sl, el = (np.asarray(c, np.int64) for c in cols[:4])
    budget = pl + sl + el - 1 <= mrs
    before = budget & (((sl > 1) & (ps < 1)) | ((sl > 2) & (ps < 2)))
    return {"items": len(ps), "budget_fail": int((~budget).sum()),
            "budget_exact": int((pl + sl + el - 1 == mrs).sum()),
            "before_start": int(before.sum()),
            "mismatch": int((budget & ~before & ~ok).sum()),
            "ok": int(ok.sum()),
            "suffix_3": int((budget & (el == 3) & ok).sum())}


def pcs_edges(capture: Capture, rng, refstr, reflen: int, sent,
              first_last) -> dict:
    """A3, C1p and B3p against their plain versions on edge items over
    europarl's padded corpus: occurrences at 0, 1, the corpus end and either
    side of sentence separators, the rest drawn from the corpus; sl and el
    1-3; occurrence lengths that make the span budget just fit and just fail
    (mrs 2, 5, 8, 15); the compared tokens read from the corpus around each
    pattern's first item, so that some items match, some shifted to
    mismatch.  A3 on count prefixes of D = 1, of runs of empty patterns,
    of one pattern an item between empty ones (a warp's items span more
    than 32 patterns), and of fewer items than n (items past offs[D]); n =
    1, 15, 17, 31, 32 and 33.  C1p on A3's items as columns, which must
    also give A3's bits; B3p on the first and the last shard's views (from
    ``first_last``), at their own ends too, the padded corpus as the query
    tokens -> counts of each kernel's exits (``_pcs_exits``) and A3's
    layouts."""
    import numpy as np
    import torch
    from cgx_tpu_torch.search import lookup
    from cgx_tpu_torch.tools import reads
    ref_h = refstr.cpu().numpy().astype(np.int64)
    glen = len(ref_h)
    ends = np.concatenate([[0, 1, 2, reflen - 2, reflen - 1, glen - 2,
                            glen - 1], sent])
    stats = {k: {"launches": 0} for k in ("A3", "C1p", "B3p")}
    for k in ("wide_warps", "d1_launches", "empty_runs", "past_offs"):
        stats["A3"][k] = 0

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()

    def bits(words, n):
        return np.unpackbits(words.cpu().numpy().view(np.uint8),
                             bitorder="little")[:n].astype(bool)

    def add(k, counts):
        st = stats[k]
        st["launches"] += 1
        for name, v in counts.items():
            st[name] = st.get(name, 0) + v

    def lengths(sl, el, mrs):
        """occurrence lengths that just fit the budget, just fail, or
        fit with room (plen >= 1)"""
        d = rng.choice([0, 0, 1, -1, -3], len(sl))
        return np.maximum(mrs - sl - el + 1 + d, 1)

    def tokens(ps, pl):
        """the corpus words pcs_warp compares, some shifted to mismatch"""
        toks = [ref_h[np.clip(ps - 1, 0, glen - 1)],
                ref_h[np.clip(ps - 2, 0, glen - 1)],
                ref_h[np.clip(ps + pl + 1, 0, glen - 1)],
                ref_h[np.clip(ps + pl + 2, 0, glen - 1)]]
        return [np.where(rng.random(len(ps)) < 0.15, t + 1, t) for t in toks]

    def layout(kind, n):
        """the count prefix of n items: one pattern (d1); a few patterns,
        each after a run of 1-3 empty ones (runs); one item a pattern, each
        after 1-2 empty ones (wide); patterns holding n - 2 items, so that
        the last two items lie past offs[D] (past)"""
        if kind == "d1":
            counts = [n]
        elif kind == "past":
            counts = [0, n // 2, 0, n - n // 2 - 2, 0]
        else:
            if kind == "wide":
                sizes = [1] * n
            else:
                cuts = np.sort(rng.choice(np.arange(1, n), min(n - 1, 5),
                                          replace=False))
                sizes = np.diff(np.concatenate([[0], cuts, [n]]))
            counts = []
            for c in sizes:
                gap = int(rng.integers(1, 4 if kind == "runs" else 3))
                counts += [0] * gap + [int(c)]
            counts.append(0)
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    for n in PCS_EDGE_ITEMS:
        for turn, mrs in enumerate((2, 5, 8, 15)):
            kinds = ["d1", "runs", "wide"] + (["past"] if n >= 4 else [])
            kind = kinds[(n + turn) % len(kinds)]
            offs = layout(kind, n)
            D = len(offs) - 1
            # the items' occurrences: the edges rotated first, then random
            ps = np.concatenate([np.roll(ends, -(n + turn)),
                                 rng.integers(0, reflen, n)])[:n]
            sl, el = rng.integers(1, 4, D), rng.integers(1, 4, D)
            j = np.arange(n)
            p = np.clip(np.searchsorted(offs, j, side="right") - 1, 0, D - 1)
            pl = lengths(sl[p], el[p], mrs)
            rows = np.stack([ps, pl], axis=1)
            # pattern p's rows from offs[p] on (a few bases past the rows)
            base = offs[:D].copy()
            base[rng.random(D) < 0.1] += n + 3
            first = np.clip(offs[:D], 0, n - 1)
            toks = tokens(ps[first], pl[first])
            pattab = np.stack([base, sl, el, *toks, np.zeros(D)],
                              axis=1).astype(np.int32)
            args = (refstr, dev(rows), dev(pattab), dev(offs), n, mrs)
            what = f"n={n},mrs={mrs},layout={kind}"
            got = lookup.pcs(*args)
            _bit_equal(f"A3@edge({what})", lookup.pcs, lookup.pcs_plain,
                       args, "cuda")
            # the items as columns (the rows read as A3 reads them)
            tab = pattab[p]
            occ = rows[np.clip(tab[:, 0] + j - offs[p], 0, n - 1)]
            cols = [occ[:, 0], occ[:, 1]] + [tab[:, c] for c in range(1, 7)]
            ok = bits(got, n)
            add("A3", _pcs_exits(cols, ok, mrs))
            _, _, windows = reads.pcs_rounds(offs, n)
            st = stats["A3"]
            st["wide_warps"] += int((windows > 1).sum())
            st["d1_launches"] += int(D == 1)
            st["empty_runs"] += int(((np.diff(offs)[:-1] == 0)
                                     & (np.diff(offs)[1:] == 0)).any())
            st["past_offs"] += int(max(n - int(offs[-1]), 0))
            c1p = (refstr, *map(dev, cols), mrs)
            got_c = lookup.pcs_cols(*c1p)
            _bit_equal(f"C1p@edge({what})", lookup.pcs_cols,
                       lookup.pcs_cols_plain, c1p, "cuda")
            if not np.array_equal(bits(got_c, n), ok):
                fail(f"C1p@edge({what}): A3's items as columns give other "
                     f"bits than A3")
            add("C1p", _pcs_exits(cols, ok, mrs))
    # B3p on the first and the last shard's views: occurrences at the
    # corpus ends and the shard's own ends; the padded corpus as the query
    # tokens, so that tok = pstart - sl + 1 and stok = pstart + plen compare
    # each item with its own neighbours (some shifted to mismatch)
    for args in first_last("B3p"):
        vr = args[0]
        lo, hi = int(vr.off), int(vr.off) + vr.arr.shape[0]
        shard_ends = np.array([0, 1, 2, glen - 2, glen - 1, lo, lo + 1,
                               hi - 2, hi - 1])
        for n in PCS_EDGE_ITEMS:
            for turn, mrs in enumerate((2, 5, 8, 15)):
                ps = np.concatenate([np.roll(shard_ends, -(n + turn)),
                                     rng.integers(max(lo, 0),
                                                  min(hi, reflen), n)])[:n]
                sl, el = rng.integers(1, 4, n), rng.integers(1, 4, n)
                pl = lengths(sl, el, mrs)
                shift = (rng.random(n) < 0.15).astype(np.int64)
                tok = np.maximum(ps - sl + 1 + shift, 0)
                stok = ps + pl - (rng.random(n) < 0.15).astype(np.int64)
                call = (vr, refstr, *map(dev, (ps, pl, sl, el, tok, stok)),
                        mrs)
                outs = []

                def plain_once(*a):
                    outs.append(lookup.pcs_items_plain(*a))
                    return outs[-1]
                _bit_equal(f"B3p@edge(off={lo},n={n},mrs={mrs})",
                           lookup.pcs_items, plain_once, call, "cuda")
                add("B3p", _pcs_exits((ps, pl, sl, el),
                                      outs[-1].cpu().numpy() != 0, mrs))
    return stats


def _first_events(need, first_end, mrs: int) -> dict:
    """Each growth side's first event within the span limit, from
    ``_onegap_body``'s record -> {side: (alive with a step in the limit,
    some event, step of the first, whether that step emits)}."""
    import torch
    from cgx_tpu_torch.extract import device as xdev
    k = torch.arange(xdev.IMAX, device=first_end.device)
    lim = (mrs - first_end - 1).clamp(max=xdev.IMAX)
    out = {}
    for s in "lr":
        has, al, pmin, pmax, gap, wts, wte, wok = (
            need[f"{s}_{f}"] for f in ("has", "al", "pmin", "pmax", "gap",
                                       "wts", "wte", "wok"))
        spank = pmax - pmin >= mrs
        nxt = has & al & ~spank & gap
        wkill = wte - wts >= mrs
        event = (k < lim[:, None]) & (~has | ((k == 0) & ~al) | spank
                                      | (nxt & (wkill | wok)))
        first = event.to(torch.int32).argmax(dim=1)
        emit = (nxt & ~wkill & wok).gather(1, first.long()[:, None])[:, 0]
        out[s] = (need[f"{s}_alive"] & (lim > 0), event.any(dim=1), first,
                  emit)
    return out


def gap_edges(rng, launches) -> dict:
    """A7, A7v, A8 and A8v against their plain versions on edge
    occurrences, over the arrays of each ``launches`` entry (kernel id, a
    captured call: the largest launch's whole arrays, medium's, or the
    first or the last europarl shard's views): cs at 0, 1, glen - 2,
    glen - 1, the last two tokens of the corpus (of the shard's slice) and
    either side of three sentence separators in it, and just before each
    of those with the gap (cs + sl = the separator + 1) in the next
    sentence, and A8's second gap likewise (cs + first_end + 1); on the
    views also at the shard's own ends.  a, b and c are 1-3 tokens, each
    gap 1-4; beyond the edges the launch's own main-path items; 1, 15, 17
    and 33 items, mrs 1, 2, 8 and 15, msym 2, 3 and 5 (A7).  Then, at the
    call's own mrs (and msym), 1-33 of its own items picked by class, in
    turn: A7's by each growth side's first event within the span limit (a
    death at step 0, an emission after step 0, none), A8's by
    checkBoundary code (0-4) -> counts: each A7 family's emissions, A7's
    growth sides (alive, with a step within the span limit) by their first
    event, A8's items by code."""
    import numpy as np
    import torch
    from cgx_tpu_torch.extract import device as xdev
    from cgx_tpu_torch.utils.views import as_view

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()

    def rows(cs, sl=None):
        """(cs, first_end, sl, el, second_end, cl) of occurrences at cs"""
        m = len(cs)
        sl = rng.integers(1, 4, m) if sl is None else np.full(m, sl)
        el, cl = rng.integers(1, 4, m), rng.integers(1, 4, m)
        fe = sl + el - 1 + rng.integers(1, 5, m)
        se = fe + cl + rng.integers(1, 5, m)
        return np.stack([cs, fe, sl, el, se, cl], axis=1)

    def classes(k, call):
        """The call's items of each class (bool [N] per class)"""
        if k.startswith("A7"):
            need: dict = {}
            xdev._onegap_body(*call, need)
            ev = _first_events(need, call[4], call[7]).values()
            return [sum(alive & any_ev & (first == 0) & ~emit
                        for alive, any_ev, first, emit in ev).bool(),
                    sum(alive & any_ev & (first > 0) & emit
                        for alive, any_ev, first, emit in ev).bool(),
                    sum(alive & ~any_ev for alive, any_ev, _, _ in ev).bool()]
        code = xdev.check_boundary(call[1], call[2], call[3],
                                   call[3] + call[5], call[9])[0]
        return [code == c for c in range(5)]

    stats = {}

    def launch(k, arrays, r, mrs, msym, what):
        st = stats.setdefault(k, {"launches": 0})

        def add(name, count):
            st[name] = st.get(name, 0) + int(count)
        cs, fe, sl, el, se, cl = (dev(c) for c in r.T)
        st["launches"] += 1
        if k.startswith("A7"):
            call = (*arrays, cs, fe, sl, el, mrs, msym)
            _bit_equal(f"{k}@edge({what},msym={msym})", xdev.onegap,
                       xdev.onegap_plain, call, "cuda")
            need: dict = {}
            out = xdev._onegap_body(*call, need)
            for i, fam in enumerate(("aXb", "XaXb", "aXbX")):
                add(fam, (out[2 * i + 1] & 1).sum())
            for alive, any_ev, first, emit in _first_events(need, fe,
                                                            mrs).values():
                add("side_dies_at_step_0",
                    (alive & any_ev & (first == 0) & ~emit).sum())
                add("side_emits_after_step_0",
                    (alive & any_ev & (first > 0) & emit).sum())
                add("side_no_event", (alive & ~any_ev).sum())
        else:
            call = (*arrays, cs, fe, se, sl, el, cl, mrs)
            _bit_equal(f"{k}@edge({what})", xdev.twogap, xdev.twogap_plain,
                       call, "cuda")
            code = xdev.check_boundary(arrays[1], arrays[2], cs, cs + se,
                                       mrs)[0]
            for c in range(5):
                add(f"code_{c}", (code == c).sum())

    for k, args in launches:
        arrays, is7 = args[:3], k.startswith("A7")
        ref = as_view(arrays[0])
        glen, lo = ref.glen, ref.off
        words = ref.arr.cpu().numpy()
        nz = np.flatnonzero(words)                       # zeros pad the end
        end = lo + (int(nz[-1]) + 1 if len(nz) else 0)
        seps = lo + np.flatnonzero(words == 1)
        seps = seps[[0, 1, len(seps) // 2]] if len(seps) > 1 else seps
        ends = [0, 1, glen - 2, glen - 1, end - 2, end - 1, *(seps - 1),
                *(seps + 1)]
        if k.endswith("v"):
            hi = lo + words.shape[0]
            ends += [lo, lo + 1, hi - 2, hi - 1]
        cross2 = rows(seps)                       # cs + first_end = sep
        cross2[:, 0] = seps - cross2[:, 1]
        edge = np.concatenate([rows(np.array(ends)), rows(seps - 1, sl=2),
                               cross2])
        own = [a.cpu().numpy() for a in args[3:7 if is7 else 9]]
        if is7:     # (cs, first_end, sl, el), no second gap
            own += [np.zeros_like(own[0])] * 2
        else:       # (cs, first_end, second_end, sl, el, cl)
            own = [own[i] for i in (0, 1, 3, 4, 2, 5)]
        own = np.stack(own, axis=1)
        table = np.concatenate([edge, own])
        for n in EDGE_ITEMS:
            for turn, mrs in enumerate(EDGE_MRS):
                msym = EDGE_MSYM[(n + turn) % len(EDGE_MSYM)]
                for pick in _edge_picks(rng, len(edge), len(own), n, turn):
                    launch(k, arrays, table[pick], mrs, msym,
                           f"n={n},mrs={mrs},first={table[pick[0]][0]}")
        # the call's own items by class, in turn, at its own settings
        pools = [torch.nonzero(c).flatten()[:12].cpu().numpy()
                 for c in classes(k, args)]
        turns = [p[i] for i in range(12) for p in pools if i < len(p)]
        mrs, msym = (args[7], args[8]) if is7 else (args[9], 0)
        for n in EDGE_ITEMS:
            pick = np.roll(np.array(turns), -n)[:n]
            launch(k, arrays, own[pick], mrs, msym, f"n={n},classes")
    return stats


def probe_edges(rng) -> dict:
    """P1 and P2 (``gather_probe.launch``, the kernels' own entry) against
    their plain versions on corpora of 1, 31, 32, 33 and 4,096 words
    (shorter than a window, one window, one word more), item counts 512
    and 1,536 and ragged counts 1, 31, 33, 257 and 700 (a chunk of 32
    items cut short; not a multiple of a block's 256), positions at len -
    32 .. len - 1 among random ones and past both ends, words near 2^31
    and -2^31 (so that the sums wrap), on grids of 1, 2 and 3 blocks, one
    block fewer than the items fill (capped below: warps that walk more
    chunks than others), the card's resident blocks and 5 more than the
    items fill (capped above) -> counts (launches, sums that wrapped,
    grids below and above the items)."""
    import functools

    import numpy as np
    import torch
    from cgx_tpu_torch.tools import gather_probe as gp
    stats = {"P1": {"launches": 0, "wrapped": 0, "grid_below": 0,
                    "grid_above": 0}, "P2": {"launches": 0}}
    plain = {"P1": lambda r, p: gp.checksum(gp.windows(r, p)),
             "P2": gp.windows}
    for length in (1, 31, 32, 33, 4096):
        words = rng.integers(2**31 - 2**16, 2**31, length)
        ref_h = np.where(rng.random(length) < 0.25, -words, words - 1)
        ref = torch.from_numpy(ref_h.astype(np.int32)).cuda()
        for n in (512, 1536, 1, 31, 33, 257, 700):
            pos_h = rng.integers(-8, length + 8, n)
            at = rng.choice(n, min(n, 36), replace=False)
            pos_h[at] = np.concatenate([np.arange(length - 32, length),
                                        [-40, 0, length, length + 40]])[
                                            :len(at)]
            pos = torch.from_numpy(pos_h.astype(np.int32)).cuda()
            exact = int(ref_h[np.clip(pos_h[:, None] + np.arange(gp.W), 0,
                                      length - 1)].sum())
            fill = -(-n // (gp.W * gp.WARPS))
            blocks = {gp.grid(n, b): b for b in
                      (1, 2, 3, fill - 1, gp.resident_blocks(ref.device),
                       fill + 5) if b >= 1}
            for g, b in blocks.items():
                for k in ("P1", "P2"):
                    _bit_equal(f"{k}@edge(len={length},n={n},blocks={b})",
                               functools.partial(gp.launch, k, blocks=b),
                               plain[k], (ref, pos), "cuda")
                    stats[k]["launches"] += 1
                st = stats["P1"]
                st["grid_below"] += g < fill
                st["grid_above"] += b > fill
                st["wrapped"] += int(gp.launch("P1", ref, pos, b)) != exact
    return stats


def check_edges(capture: Capture):
    """The warp and half-warp kernels against their plain versions on
    synthetic inputs over europarl's index arrays, item counts 1, 15, 17
    and 33 (partial half-warps and warps) and mrs 1, 2, 8 and 15:

    * A2f, A2b: occurrences at 0, 1, glen - 2 and glen - 1, per-pattern
      tables whose first, last and some inner patterns are empty; the
      compared query tokens are read from the corpus at a random move of
      each pattern's first item, so that moves match and the gap check runs;
    * A4, A4v: the same occurrences (A4v: also at its shard's own ends, on
      the first and the last shard);
    * C1f, C1b: A2's items materialised as columns, which must also give
      A2's masks; B3f, B3b on the first and the last shard's views, at the
      corpus ends and the shard's own ends, the compared query tokens read
      from the corpus (the padded corpus as the query tokens) at a random
      move of each item;
    * A6: occurrences (by SA position, from the inverse SA) at 0, 1,
      reflen - 2, reflen - 1 and either side of a few sentence separators,
      SA positions past both ends, block lengths 1 and mrs, msym 2, 3 and
      5, the rest the main path's own items; B3c the same by corpus
      position, at glen - 2 and glen - 1 too, on the first and the last
      shard's views, and at each one's own ends;
    * A5: (start, len) rows at those corpus positions and ending at the
      corpus end, in both row tables, under tables with empty patterns as
      A2's; C1t the same rows as columns, and B3t on the first and the last
      shard's views at their own ends too;
    * A7, A8 on the whole arrays, A7v, A8v on the first and the last
      shard's views: ``gap_edges`` (occurrences at the corpus, sentence
      and shard ends, the gaps in another sentence than cs, msym 2, 3 and
      5);
    * A1, B2r, B2g, A10 and A9: ``refine_edges`` (B2r and B2g on the
      sharded run's index and on 1 and 3 shards) and ``maxlex_edges`` (A9
      over medium's dense tables);
    * B1p1, B1p2: ``lcp_edges`` (over europarl's index and a small index of
      70-token sentences);
    * A3, C1p, B3p: ``pcs_edges`` (1, 15, 17, 31, 32 and 33 items; D = 1,
      runs of empty patterns, warps over more than 32 patterns; span
      budgets that just fit and just fail);
    * P1, P2: ``probe_edges`` (corpora of 1, 31, 32 and 33 words, ragged
      item counts, positions at and past the corpus end, sums that wrap,
      grids capped below and above the items).

    Fails unless every output is bit-equal, the inputs of A2, A4, C1f, C1b,
    B3f and B3b reach the gap check (lookup1's scans: items with a candidate
    and items with a non-zero mask), A6's emit each of its four families,
    A5's set both halves of its word (cand and gc), A7's emit each of its
    three families and have growth sides that die at step 0, that emit after
    step 0 and that meet no event within the span limit, A8's items have
    every checkBoundary code (0-4), A1's and B2r's lanes hold empty
    intervals, lanes past the query's end, and lanes that collapse and
    narrow (B2r's also intervals whose rows and whose positions straddle
    shards), A10's and A9's rules with a probe found and none, B1p1's lanes
    OOV, missing, hit, matched to the suffix end, stopped by an OOV token
    inside and matched past 32 tokens, and B1p2's items found and missing,
    pinned off the midpoint, on width-2 windows and past 32 tokens, and
    A3's, C1p's and B3p's items reach every exit of ``pcs_warp``
    (``_pcs_exits``), A3's on every layout, and P1's sums wrap and its
    grids fall below and above the items."""
    import functools

    import numpy as np
    import torch
    from cgx_tpu_torch.extract import device as xdev
    from cgx_tpu_torch.search import lookup
    from cgx_tpu_torch.search import precompute as pcx
    t0 = time.perf_counter()
    rng = np.random.default_rng(20260817)
    refstr, rlp, lr_tar = capture.calls["A2b"][1][:3]
    mgs = capture.calls["A2b"][1][8]
    ref_h = refstr.cpu().numpy().astype(np.int64)
    glen = len(ref_h)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
    stats = {k: {"launches": 0} for k in ("A2f", "A2b", "A4", "A4v", "C1f",
                                          "C1b", "B3f", "B3b", "A6", "B3c",
                                          "A5", "C1t", "B3t")}
    scans = ("A2f", "A2b", "C1f", "C1b", "B3f", "B3b")

    def compare(k, kernel, plain, args, what):
        outs = []

        def plain_once(*a):
            outs.append(plain(*a))
            return outs[-1]
        _bit_equal(f"{k}@edge({what})", kernel, plain_once, args, "cuda")
        out, st = outs[-1], stats[k]
        st["launches"] += 1

        def add(name, count):
            st[name] = st.get(name, 0) + int(count)
        if k in ("A6", "B3c"):
            for r, fam in enumerate(("ab", "Xab", "abX", "XabX")):
                add(fam, (out[2 * r + 1] & 1).sum())
        elif k in ("A5", "C1t", "B3t"):
            cand, gc = (out[0], out[1]) if k == "B3t" else (
                out & 0xFFFF, (out >> 16) & 0xFFFF)
            add("cand_items", (cand != 0).sum())
            add("gc_items", (gc != 0).sum())
        else:
            add("mask_items", (out != 0).sum())
            if k in scans:
                add("candidate_items", (plain(*args, gap=False) != 0).sum())
        return out
    edges = np.array([0, 1, glen - 2, glen - 1])
    a2_items = []     # A2's launches: (fwd, mrs, columns, masks)
    for fwd in (True, False):
        k = "A2f" if fwd else "A2b"
        for n in EDGE_ITEMS:
            for mrs in EDGE_MRS:
                for r in range(len(edges)):
                    offs = _edge_offs(rng, n)
                    D = len(offs) - 1
                    pos = np.concatenate([np.roll(edges, -r),
                                          rng.integers(0, glen, 12)])
                    lo = rng.integers(0, len(pos) + 2, D)   # some past the end
                    lo[1] = 0          # the first items: the edges in turn
                    sl, el = rng.integers(1, 4, D), rng.integers(1, 4, D)
                    mv = rng.integers(0, 4, D)
                    g = pos[np.minimum(lo, len(pos) - 1)]
                    if fwd:
                        p0 = g + sl + mgs + mv
                        toks = [ref_h[np.clip(p0 + i, 0, glen - 1)]
                                for i in range(3)]
                    else:
                        p0 = g - 1 - mgs - mv
                        toks = [np.where(p0 - i < 0, -1,
                                         ref_h[np.clip(p0 - i, 0, None)])
                                for i in range(3)]
                    pattab = np.stack([lo, sl, el] + toks + [0 * lo] * 2,
                                      axis=1)
                    args = (refstr, rlp, lr_tar, dev(pos), dev(pattab),
                            dev(offs), n, mrs, mgs, fwd)
                    masks = compare(k, lookup.scan, lookup.scan_plain, args,
                                    f"n={n},mrs={mrs},r={r}")
                    # the items as columns: item j of pattern p (the last
                    # with offs[p] <= j) starts at pos[lo[p] + j - offs[p]],
                    # clamped as the SA read is
                    j = np.arange(n)
                    p = np.clip(np.searchsorted(offs, j, side="right") - 1,
                                0, D - 1)
                    g_j = pos[np.clip(lo[p] + j - offs[p], 0, len(pos) - 1)]
                    a2_items.append((fwd, mrs, [g_j] + [pattab[p, c] for c in
                                                        range(1, 6)], masks))
    # A4 on the whole arrays, A4v on the first and the last shard's views
    def first_last(k):
        got = [a for (sk, _), (_, a) in sorted(capture.shard_calls.items())
               if sk == k]
        return got[0], got[-1]
    for k, (vr, vt) in [("A4", (rlp, lr_tar))] + [
            ("A4v", a[:2]) for a in first_last("A4v")]:
        if k == "A4":
            ends, lo, hi = [], 0, vr.shape[0]
        else:
            lo, hi = int(vr.off), int(vr.off) + vr.arr.shape[0]
            ends = [lo, lo + 1, hi - 2, hi - 1]
        g_len = vr.shape[0] if k == "A4" else int(vr.glen)
        ends = np.array([0, 1, g_len - 2, g_len - 1] + ends)
        for fwd in (True, False):
            for n in EDGE_ITEMS:
                for mrs in EDGE_MRS:
                    for starts in _edge_starts(rng, ends, n, lo, hi):
                        compare(k, pcx.gap_check, pcx.gap_check_plain,
                                (vr, vt, dev(starts), mrs, mgs, fwd),
                                f"n={n},mrs={mrs},fwd={fwd},first="
                                f"{starts[0]}")

    # C1f, C1b on A2's items as columns: equal to their plain version and
    # to A2's masks
    t1 = time.perf_counter()
    for fwd, mrs, cols, masks in a2_items:
        k = "C1f" if fwd else "C1b"
        got = compare(k, lookup.scan_cols, lookup.scan_cols_plain,
                      (refstr, rlp, lr_tar, *map(dev, cols), mrs, mgs, fwd),
                      f"n={len(cols[0])},mrs={mrs},first={cols[0][0]}")
        if not torch.equal(got, masks):
            fail(f"{k}@edge: the masks of A2's items as columns differ from "
                 f"A2's (mrs={mrs}, first={cols[0][0]})")
    # B3f, B3b on the first and the last shard's views: occurrences at the
    # corpus ends and the shard's own ends, the rest drawn from its slice;
    # the padded corpus serves as the query tokens, so a query position is
    # the corpus position of a compared token (b's first forward, a's first
    # backward, a random move away)
    for k, fwd, kernel in (("B3f", True, lookup.fwd_items),
                           ("B3b", False, lookup.bwd_items)):
        plain = functools.partial(lookup.scan_items_plain, fwd=fwd)
        for args in first_last(k):
            vr = args[0]
            lo, hi = int(vr.off), int(vr.off) + vr.arr.shape[0]
            ends = np.array([0, 1, vr.glen - 2, vr.glen - 1, lo, lo + 1,
                             hi - 2, hi - 1])
            for n in EDGE_ITEMS:
                for mrs in EDGE_MRS:
                    for g in _edge_starts(rng, ends, n, lo, hi):
                        sl, el = rng.integers(1, 4, n), rng.integers(1, 4, n)
                        mv = rng.integers(0, 4, n)
                        qpos = g + sl + mgs + mv if fwd \
                            else np.maximum(g - mgs - mv - sl, 0)
                        compare(k, kernel, plain,
                                (*args[:3], refstr, dev(g), dev(sl), dev(el),
                                 dev(qpos), mrs, mgs),
                                f"n={n},mrs={mrs},off={lo},first={g[0]}")

    # A6 by SA position: the edges' positions from the inverse SA, SA
    # positions past both ends, then the main path's items
    t2 = time.perf_counter()
    _, sa, _, _, real_pos, real_lm = capture.calls["A6"][1][:6]
    reflen = int(capture.calls["B4"][1][11])
    sent = _sentence_edges(refstr, reflen)
    corpus_edges = np.concatenate([[0, 1, reflen - 2, reflen - 1], sent])
    head = sa[:reflen]
    sa_edges = [int(torch.nonzero(head == int(p))[0]) for p in corpus_edges]
    sa_edges += [sa.shape[0] - 1, sa.shape[0] + 3, -1]

    contig_pairs = {"A6": (xdev.contig, xdev.contig_plain),
                    "B3c": (xdev.contig_pos, xdev.contig_pos_plain)}

    def contig_launches(k, arrays, edge_at, fill_at, fill_lm):
        """A6 or B3c over ``arrays`` (the captured call's first arrays):
        ``edge_at`` its item words at the edges, ``fill_at``/``fill_lm``
        the main path's items."""
        n_edges = len(edge_at)
        at = np.concatenate([edge_at, fill_at.cpu().numpy()])
        lms_fill = fill_lm.cpu().numpy()
        for n in EDGE_ITEMS:
            for turn, mrs in enumerate(EDGE_MRS):
                for pick in _edge_picks(rng, n_edges, len(fill_at), n, turn):
                    # block lengths 1 and mrs at the edges, the main path's
                    # own beyond them
                    lm = np.where(pick < n_edges,
                                  np.where((pick + n + turn) % 2, mrs, 1),
                                  lms_fill[np.maximum(pick - n_edges, 0)])
                    msym = EDGE_MSYM[(n + turn) % len(EDGE_MSYM)]
                    compare(k, *contig_pairs[k],
                            (*arrays, dev(at[pick]), dev(lm), mrs, msym),
                            f"n={n},mrs={mrs},msym={msym},first={at[pick[0]]}")
    contig_launches("A6", (refstr, sa, rlp, lr_tar), np.array(sa_edges),
                    real_pos, real_lm)
    for args in first_last("B3c"):
        vr = args[0]
        g_ends = [0, 1, vr.glen - 2, vr.glen - 1, args[1].glen - 2,
                  args[1].glen - 1]
        lo, hi = int(vr.off), int(vr.off) + vr.arr.shape[0]
        at = np.concatenate([g_ends, [lo, lo + 1, hi - 2, hi - 1], sent])
        contig_launches("B3c", args[:3], at, args[3], args[4])

    # A5 over (start, len) rows: the edges (starting there, or ending at the
    # corpus end) lead both row tables, the main path's rows follow
    a5 = capture.calls["A5"][1]
    ends_at = np.array([glen, reflen, reflen - 1])
    plen = rng.integers(1, 4, len(corpus_edges) + 4)
    starts = np.concatenate([corpus_edges, [glen - 2, glen - 1, 0, 1]])
    edge_rows = np.stack([starts, plen], axis=1)
    tail = np.stack([np.repeat(ends_at, 3) - np.tile([1, 2, 3], 3),
                     np.tile([1, 2, 3], 3)], axis=1)
    edge_rows = np.concatenate([edge_rows, tail])
    n_edges = len(edge_rows)
    real_rows = {t: a5[i].cpu().numpy() for t, i in (("og", 3), ("pc", 4))}
    for n in EDGE_ITEMS:
        for turn, mrs in enumerate(EDGE_MRS):
            for pick in _edge_picks(rng, n_edges, 64, n, turn):
                e = int(pick[0]) if n == 1 else int(rng.integers(n_edges))
                tables = []
                for t in ("og", "pc"):
                    fill = real_rows[t][rng.integers(0, len(real_rows[t]),
                                                     64)]
                    tables.append(np.concatenate([np.roll(edge_rows, -e, 0),
                                                  fill]))
                offs = _edge_offs(rng, n)
                D = len(offs) - 1
                lo = rng.integers(0, n_edges + 66, D)   # some past the end
                lo[1] = 0
                pattab = np.stack([lo, rng.integers(0, 2, D)], axis=1)
                compare("A5", lookup.two, lookup.two_plain,
                        (refstr, rlp, lr_tar, dev(tables[0]), dev(tables[1]),
                         dev(pattab), dev(offs), n, mrs, mgs),
                        f"n={n},mrs={mrs},first={edge_rows[e]}")
                rows = np.concatenate([edge_rows, tables[0][n_edges:]])[
                    pick]
                compare("C1t", lookup.two_packed, lookup.two_packed_plain,
                        (refstr, rlp, lr_tar, dev(rows[:, 0]),
                         dev(rows[:, 1]), mrs, mgs),
                        f"n={n},mrs={mrs},first={rows[0]}")
    for args in first_last("B3t"):
        vr = args[0]
        lo, hi = int(vr.off), int(vr.off) + vr.arr.shape[0]
        shard_rows = np.concatenate([edge_rows, np.stack(
            [[lo, lo + 1, hi - 2, hi - 1, hi - 3], [1, 2, 1, 1, 3]], axis=1)])
        fill = np.stack([args[3].cpu().numpy(), args[4].cpu().numpy()], 1)
        rows_all = np.concatenate([shard_rows, fill])
        for n in EDGE_ITEMS:
            for turn, mrs in enumerate(EDGE_MRS):
                for pick in _edge_picks(rng, len(shard_rows), len(fill), n,
                                        turn):
                    rows = rows_all[pick]
                    compare("B3t", lookup.two_items, lookup.two_items_plain,
                            (*args[:3], dev(rows[:, 0]), dev(rows[:, 1]),
                             mrs, mgs),
                            f"n={n},mrs={mrs},off={lo},first={rows[0]}")

    t3 = time.perf_counter()
    stats.update(gap_edges(
        rng, [("A7", capture.calls["A7"][1])]
        + [("A7v", a) for a in first_last("A7v")]
        + [("A8", capture.calls["A8"][1])]
        + [("A8v", a) for a in first_last("A8v")]))
    t4 = time.perf_counter()
    stats.update(refine_edges(capture, rng, reflen, sent))
    stats["A10"] = maxlex_edges(capture, rng, "A10")
    stats["A9"] = maxlex_edges(capture, rng, "A9")
    t5 = time.perf_counter()
    stats.update(lcp_edges(capture, rng))
    t6 = time.perf_counter()
    stats.update(pcs_edges(capture, rng, refstr, reflen, sent, first_last))
    t7 = time.perf_counter()
    stats.update(probe_edges(rng))
    t8 = time.perf_counter()
    print(json.dumps({"phase": "edges", "items": EDGE_ITEMS,
                      "pcs_items": PCS_EDGE_ITEMS,
                      "mrs": EDGE_MRS, "msym": EDGE_MSYM, **stats,
                      "seconds_a2_a4": t1 - t0, "seconds_c1_b3": t2 - t1,
                      "seconds_a6_a5": t3 - t2, "seconds_a7_a8": t4 - t3,
                      "seconds_a1_b2r_a10_a9": t5 - t4, "seconds_b1": t6 - t5,
                      "seconds_a3_c1p_b3p": t7 - t6,
                      "seconds_p1_p2": t8 - t7,
                      "bit_equal": True}), flush=True)
    idle = [k for k in scans + ("A4", "A4v")
            if stats[k]["mask_items"] == 0
            or stats[k].get("candidate_items") == 0]
    if idle:
        fail(f"edges: the inputs of {idle} never reached the gap check")
    silent = [f"{k}.{f}" for k, fams in (
        ("A6", ("ab", "Xab", "abX", "XabX")), ("A5", ("cand_items", "gc_items")))
        for f in fams if stats[k][f] == 0]
    silent += [f"{k}.{f}" for k in ("A1", "B2r")
               for f in ("empty_lanes", "past_end", "collapsed", "narrowed",
                         "rows_straddle", "positions_straddle")
               if stats[k].get(f, 1) == 0]
    silent += [f"{k}.{f}" for k in ("A10", "A9")
               for f in ("found", "none_found") if stats[k][f] == 0]
    silent += [f"B1p1.{f}" for f in ("oov", "missing", "hit", "suffix_end",
                                      "oov_inside", "past_32")
               if stats["B1p1"].get(f, 0) == 0]
    silent += [f"B1p2.{f}" for f in ("found", "missing", "pin_off_mid",
                                      "width_2", "past_32")
               if stats["B1p2"].get(f, 0) == 0]
    silent += [f"A7.{f}" for f in ("aXb", "XaXb", "aXbX",
                                    "side_dies_at_step_0",
                                    "side_emits_after_step_0",
                                    "side_no_event")
               if stats["A7"].get(f, 0) == 0]
    silent += [f"A8.code_{c}" for c in range(5)
               if stats["A8"].get(f"code_{c}", 0) == 0]
    silent += [f"{k}.{f}" for k in ("A3", "C1p", "B3p")
               for f in ("budget_fail", "budget_exact", "before_start",
                         "mismatch", "ok", "suffix_3")
               if stats[k].get(f, 0) == 0]
    silent += [f"A3.{f}" for f in ("wide_warps", "d1_launches", "empty_runs",
                                    "past_offs") if stats["A3"][f] == 0]
    silent += [f"P1.{f}" for f in ("wrapped", "grid_below", "grid_above")
               if stats["P1"][f] == 0]
    if silent:
        fail(f"edges: the inputs never set {silent}")


def write_corpus_files(size: str, d: str, queries: dict) -> dict:
    """A size's corpus as the CLI's files under ``d``, and each query file
    of ``queries`` (name -> query lines) -> {file name: path}."""
    f, e, a, lex, _ = _CORPORA[size]
    os.makedirs(d, exist_ok=True)
    bodies = {"corpus.f": f, "corpus.e": e, "corpus.a": a,
              "lex.txt": [" ".join(lex)], **queries}
    paths = {}
    for name, body in bodies.items():
        paths[name] = os.path.join(d, name)
        with open(paths[name], "w", encoding="utf-8") as fh:
            fh.write(body if isinstance(body, str)
                     else "\n".join(body) + "\n")
    return paths


def read_grammars(d: str, n: int) -> list:
    """The per-query lines of the ``grammar.<i>.s`` files under ``d``."""
    out = []
    for q in range(n):
        with open(os.path.join(d, f"grammar.{q}.s"), encoding="utf-8") as fh:
            out.append(fh.read().splitlines())
    return out


def dir_bytes(d: str) -> dict:
    return {f: os.path.getsize(os.path.join(d, f))
            for f in sorted(os.listdir(d))}


def check_index_dir(res, index_dir: str):
    """The europarl run saved its index: the ``indexsave`` seconds and the
    dir's bytes."""
    files = dir_bytes(index_dir)
    if "meta.json" not in files or "arrays.npz" not in files:
        fail(f"index dir {index_dir} holds {sorted(files)}")
    print(json.dumps({"phase": "index_save", "size": "europarl",
                      "indexsave_s": res.timing.as_dict()["indexsave"],
                      "bytes": sum(files.values()), "files": files}),
          flush=True)


def check_serve(index_dir: str, work: str, golden: dict, first3: list,
                expect: tuple, device: str = "cuda") -> dict:
    """``serve.serve_loop`` over europarl's index dir with the default
    ``auto`` prewarm and three requests (all 64 queries, the first 3, all
    again): every reply ``ok``, the full requests' grammars the golden, the
    small one the first 3 queries' lines of the one-shot run; each full
    request launches exactly ``expect``, the small one and the prewarm
    nothing else -> the launch counts of the prewarm and the requests."""
    import io
    from cgx_tpu_torch import serve
    from cgx_tpu_torch.kernels import build as kb
    q_lines = _CORPORA["europarl"][4]
    paths = write_corpus_files("europarl", os.path.join(work, "serve"),
                               {"all.q": q_lines, "first3.q": q_lines[:3]})
    dests = [os.path.join(work, "serve", f"out{i}") for i in range(3)]
    reqs = [(paths["all.q"], dests[0]), (paths["first3.q"], dests[1]),
            (paths["all.q"], dests[2])]
    counts = []

    def requests():
        # the launch counts of the prewarm, then of each request: read and
        # reset before the next line is handed out, and after the last
        for qry, dest in reqs:
            counts.append(dict(kb.LAUNCHES))
            kb.LAUNCHES.clear()
            yield f"{qry} {dest}\n"
        counts.append(dict(kb.LAUNCHES))

    out = io.StringIO()
    kb.LAUNCHES.clear()
    t0 = time.perf_counter()
    served = serve.serve_loop(paths["corpus.f"], paths["corpus.e"],
                              paths["corpus.a"], paths["lex.txt"],
                              index_dir=index_dir, inp=requests(), out=out,
                              device=device)
    wall = time.perf_counter() - t0
    replies = out.getvalue().splitlines()
    ok = [r.split() for r in replies[1:]]
    hashes = [grammar_hash(read_grammars(d, n)) for d, n in
              ((dests[0], len(q_lines)), (dests[2], len(q_lines)))]
    small = read_grammars(dests[1], 3)
    print(json.dumps({
        "phase": "serve", "size": "europarl", "served": served,
        "replies": replies, "wall_s": wall,
        "ready_s": float(replies[0].split()[1])
        if replies and replies[0].startswith("ready ") else None,
        "request_s": [float(r[3]) for r in ok if r and r[0] == "ok"],
        "prewarm_launches": counts[0] if counts else None,
        "request_launches": counts[1:],
        "golden_ok": [h == golden["europarl"]["sha256"] for h in hashes],
        "first3_ok": small == first3}), flush=True)
    if served != 3 or not replies[0].startswith("ready ") or len(ok) != 3 \
            or any(r[0] != "ok" for r in ok):
        fail(f"serve: replies {replies}")
    if [int(r[1]) for r in ok] != [len(q_lines), 3, len(q_lines)] or \
            int(ok[0][2]) != golden["europarl"]["lines"]:
        fail(f"serve: counts in the replies {replies}")
    if any(h != golden["europarl"]["sha256"] for h in hashes):
        fail(f"serve: grammar hashes {[h[:16] for h in hashes]} != golden")
    if small != first3:
        fail("serve: the first 3 queries' grammars differ from the one-shot "
             "run's")
    # the small request has no item for A3 (no precomputed pair), so it
    # is held to the path's set, the full ones to all of it
    per_request = [check_launches(f"serve request {i}",
                                  () if qry == paths["first3.q"] else expect,
                                  others(expect), c)
                   for i, ((qry, _), c) in enumerate(zip(reqs, counts[1:]))]
    prewarm = check_launches("serve prewarm", (), others(expect), counts[0])
    return {k: prewarm[k] + sum(p[k] for p in per_request) for k in KERNELS}


def check_profile(work: str, golden: dict, device: str = "cuda") -> dict:
    """``cli.main([... "--profile", DIR])`` on medium's files: the
    grammar files hash to the golden, the run launches medium's default
    path (A9 for MaxLex), and DIR's trace names each of its __global__
    functions; prints the trace's kernel time and busy share of the run,
    and the wall of the same run without the profiler just before it
    (not counted) -> the profiled run's launch counts."""
    import re
    from cgx_tpu_torch import cli
    from cgx_tpu_torch.kernels import build as kb
    q_lines = _CORPORA["medium"][4]
    paths = write_corpus_files("medium", os.path.join(work, "profile_in"),
                               {"query.f": q_lines})
    prof = os.path.join(work, "profile")
    out = os.path.join(work, "profile_out")
    expect = PATH_KERNELS + ("A1", "A9")
    files = [paths["corpus.f"], paths["query.f"], paths["corpus.e"],
             paths["corpus.a"], paths["lex.txt"]]
    # the same run without the profiler first: what the trace costs
    timefile = os.path.join(work, "plain_times")
    if cli.main(["--device", device, "-s", timefile, *files,
                 os.path.join(work, "plain_out")]) != 0:
        fail("cli without --profile failed")
    with open(timefile, encoding="utf-8") as fh:
        plain_line = fh.read().strip()
    timefile = os.path.join(work, "profile_times")
    kb.LAUNCHES.clear()
    t0 = time.perf_counter()
    rc = cli.main(["--device", device, "--profile", prof, "-s", timefile,
                   *files, out])
    call_s = time.perf_counter() - t0
    with open(timefile, encoding="utf-8") as fh:
        timeline = fh.read().strip()
    # the run's wall as the CLI measured it, the trace's export excluded,
    # and the sum of its phases (the pipeline's own time)
    wall = float(timeline.split()[1].rstrip("s"))
    phases_s = float(timeline.split("total: ")[1].split("s")[0])
    launches = check_launches("medium (cli --profile)", expect,
                              others(expect))
    if rc != 0:
        fail(f"cli --profile: exit code {rc}")
    ghash = grammar_hash(read_grammars(out, len(q_lines)))
    trace_path = os.path.join(prof, "trace.json")
    if not os.path.exists(trace_path):
        fail(f"cli --profile wrote no {trace_path}")
    with open(trace_path, encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    dev = [ev for ev in events if ev.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in ev]
    pat = re.compile(r"\b(" + "|".join(_kernel_names()) + r")\b")
    own = {}                     # csrc __global__ name -> its events
    for ev in dev:
        m = pat.search(ev["name"]) if ev.get("cat") == "kernel" else None
        if m:
            own.setdefault(m.group(1), []).append(ev)
    seen = sorted(own)
    timed = [ev for ev in events if "ts" in ev and "dur" in ev]
    span_us = (max(ev["ts"] + ev["dur"] for ev in timed)
               - min(ev["ts"] for ev in timed)) if timed else 0.0
    busy_us, end = 0.0, None       # the union of the device intervals
    for ts, dur in sorted((ev["ts"], ev["dur"]) for ev in dev):
        if end is None or ts > end:
            busy_us += dur
            end = ts + dur
        elif ts + dur > end:
            busy_us += ts + dur - end
            end = ts + dur
    print(json.dumps({
        "phase": "profile", "size": "medium", "wall_s": wall,
        "with_export_s": call_s, "timefile": timeline,
        "without_profile_wall_s": float(plain_line.split()[1].rstrip("s")),
        "without_profile_timefile": plain_line,
        "trace_bytes": os.path.getsize(trace_path),
        "trace_span_s": span_us / 1e6,
        "csrc_kernel_ms": sum(ev["dur"] for evs in own.values()
                              for ev in evs) / 1e3,
        "csrc_kernel_ms_by_name": {k: sum(ev["dur"] for ev in evs) / 1e3
                                   for k, evs in own.items()},
        "csrc_kernel_events": {k: len(evs) for k, evs in own.items()},
        "all_kernel_ms": sum(ev["dur"] for ev in dev
                             if ev.get("cat") == "kernel") / 1e3,
        "memcpy_ms": sum(ev["dur"] for ev in dev
                         if ev.get("cat") == "gpu_memcpy") / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "phases_total_s": phases_s,
        "busy_share_of_wall": busy_us / 1e6 / wall,
        "busy_share_of_phases": busy_us / 1e6 / phases_s,
        "busy_share_of_trace": busy_us / span_us if span_us else None,
        "launches": {k: v for k, v in launches.items() if v},
        "grammar_sha256": ghash,
        "golden_ok": ghash == golden["medium"]["sha256"]}), flush=True)
    missing = sorted({PROFILE_GLOBALS[k] for k in expect} - set(seen))
    if missing:
        fail(f"cli --profile: the trace names no {missing}")
    if ghash != golden["medium"]["sha256"]:
        fail(f"cli --profile: grammar hash {ghash[:16]} != golden")
    return launches


def launch_floor(capture: Capture, device: str):
    """The time of one launch of A8 (plain C entry, ctypes) on the first
    item of its captured inputs: by CUDA events the floor that host issue
    puts under every kernel time above; by the device's clock A8's own
    one-item chain (three dependent rounds of reads on one half-warp), not
    the card's empty-launch time."""
    from cgx_tpu_torch.extract import device as xdev
    args = list(capture.calls["A8"][1])
    args[3:9] = [a[:1].contiguous() for a in args[3:9]]
    ms, reps = _time_ms(lambda: xdev.twogap(*args), device)
    print(json.dumps({"phase": "launch_floor", "kernel": "A8", "items": 1,
                      "ms": ms,
                      **_device_ms(lambda: xdev.twogap(*args), reps)}),
          flush=True)


def main():
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, ROOT)
    from cgx_tpu_torch.kernels import build as kb

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    print(json.dumps({"phase": "card", "torch_device": kind,
                      "count": torch.cuda.device_count(),
                      "torch": torch.__version__, "cuda": torch.version.cuda}),
          flush=True)

    # 2. build
    build_s = kb.build()
    ptxas = {}
    for f in sorted(os.listdir(kb.BUILD_DIR)):
        if f.endswith(".ptxas.txt"):
            with open(os.path.join(kb.BUILD_DIR, f), encoding="utf-8") as fh:
                ptxas[f] = [ln.strip() for ln in fh
                            if "Function properties" in ln
                            or "registers" in ln or "spill" in ln]
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "ptxas": ptxas}), flush=True)

    # 3. end to end (the launch counts of the main path)
    with open(GOLDEN, encoding="utf-8") as fh:
        golden = json.load(fh)
    totals = {k: 0 for k in KERNELS}
    peaks = {}

    def count(launches):
        for k, v in launches.items():
            totals[k] += v
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_",
                            dir=os.path.join(ROOT, "build"))
    index_dir = os.path.join(work, "europarl_index")
    try:
        with Capture() as cap:
            shard_offsets = run_paths(cap, golden, count, peaks, work,
                                      index_dir)
            # 5. C1p on A3's largest launch, as columns; 6. the gather probe
            count(check_pcs_cols(cap))
            count(check_probe(cap))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 7. kernels against their plain versions at the main path's shapes
    rows = compare_kernels(cap, "cuda", totals, shard_offsets)
    check_edges(cap)
    launch_floor(cap, "cuda")

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "cgx_tpu"))
    if leaked:
        fail(f"the port imported {leaked[:5]}")
    print(json.dumps({"total_s": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def run_paths(cap: Capture, golden: dict, count, peaks: dict, work: str,
              index_dir: str) -> list:
    """Phases 3 and 4 -> the shard offsets of the sharded run."""
    shard_offsets = []
    for size, lcp, shards, cols, expect, forbid in RUNS:
        # europarl's default run also persists its index (phase 3b)
        saves = size == "europarl" and not (shards or cols)
        launches, res, peaks[(size, shards, cols)] = run_e2e(
            size, "cuda", cap, golden, expect, lcp, forbid, shards, cols,
            index_dir=index_dir if saves else None)
        count(launches)
        if saves:
            check_index_dir(res, index_dir)
            count(check_lcp_passes(res))
            # 4. query-DP on the same index, queries and blocks; 4b.
            # A9 on its lexicon as dense tables
            count(check_query_dp(res, cap))
            count(check_dense_large(res, cap))
        if shards:
            shard_offsets = [int(o) for o in res.index.src_off]
            print(json.dumps({
                "phase": "sharded_memory", "size": size,
                "sa_shards": shards,
                "bytes_per_shard": res.index.memory_per_device(),
                "run_peak_mem_bytes": peaks[(size, shards, cols)],
                "replicated_run_peak_mem_bytes":
                    peaks[(size, 0, False)]}),
                flush=True)
        del res
    # 3c. europarl from its persisted index, replicated and sharded
    first3 = None
    for shards, expect in LOAD_RUNS:
        launches, res, _ = run_e2e("europarl", "cuda", cap, golden, expect,
                                   forbid=others(expect), sa_shards=shards,
                                   index_dir=index_dir)
        count(launches)
        if not shards:
            first3 = res.per_query_lines[:3]
        del res
    # 3d. a server over that index; 3e. medium's queries in four batches;
    # 3f. medium through the CLI under --profile
    count(check_serve(index_dir, work, golden, first3, LOAD_RUNS[0][1]))
    launches, res, _ = run_e2e("medium", "cuda", cap, golden,
                               OVERLAP_KERNELS,
                               forbid=others(OVERLAP_KERNELS),
                               query_batches=4)
    count(launches)
    del res
    count(check_profile(work, golden))
    return shard_offsets


if __name__ == "__main__":
    main()
