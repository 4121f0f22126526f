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
   with ``scan_cols=True`` (the column-upload lookups), medium again
   with ``lcp_passes=True``, and medium with ``sa_shards=["cuda:0"] * 4``
   (the index on a device list, the card standing in for four: the
   refinement's round form, B2s and B2t, in place of B2r; A4 on the
   shards' views in its build) (``RUNS``).
   Each run must launch its path's kernels and no other (launch counts
   reset just before it, see ``RUNS``): A1 or B1's two passes, A4, A2m
   and A2s (A2's scan with lookup1's rows as keys on the device, and
   their sort there; C1f and C1b with ``scan_cols``),
   A3, A5m (A5's scan with lookup2's match; C1t with ``scan_cols``), A6,
   A7, A8 and A9 or A10 on the replicated index; B2r,
   B2g, B3f, B3b, B3p, B3t, B3c and A4, A7, A8 on shard views on the
   sharded one (MaxLex on the host there).  Its counters must equal the
   JAX package's and its grammar hash the golden in
   tests/golden_torch_hashes.json (the JAX package's full grammar); its
   line prints each kernel's items and bytes (``kernels.build.ITEMS``,
   ``BYTES``).  On europarl's index and queries both LCP passes must then give the
   refinement's up, down and longestmatch (their launches, B1's largest,
   counted with the launch counts reset just before them); the sharded run
   prints each shard's bytes and its peak device memory beside the
   replicated run's.  Then, all under a scratch dir in ``build/`` that is
   deleted at the end (``run_paths``):
   3b. index_save -- europarl's default run above passes ``index_dir``, so
       it persists its index (``preproc.index_io``): the ``indexsave``
       seconds and the dir's bytes;
   3c. the loaded runs (``LOAD_RUNS``) -- ``run_pipeline(...,
       index_dir=...)`` on that dir, replicated, with ``sa_shards=4`` (all
       on the card, B2r) and with ``sa_shards=["cuda:0"] * 4`` and ``* 2``
       (device lists: B2s, B2t, B2g and B3 per owning shard, no B2r; each
       device's bytes printed, ``memory_per_device`` per shard and
       ``bytes_per_device``): no corpus parsed, no suffix array built, no
       precompute, so no A4 or A4v; each must launch exactly its path's
       kernels and give the golden hash and counters;
   3d. serve -- europarl's corpus and two query files (all 64 queries;
       the first 3) written out, ``serve.serve_loop`` over the index dir
       with the default ``auto`` prewarm and three requests (all, first
       3, all): every reply ``ok``, both full requests the golden hash,
       the small one the first 3 queries' lines of 3c's run, each full
       request the kernels of 3c's replicated run, the small one (no item
       for A3) and the prewarm nothing else;
       ``ready`` and each request's seconds and launches printed;
   3e. medium with ``query_batches=4`` (``run_pipeline_overlap``): the
       golden hash and line count, A4, A1, A2m, A3, A5m, A6, A7 and A8
       and no A9 or A10 (MaxLex on the host, on the worker thread);
   3f. profile -- ``cli.main([..., "--profile", DIR])`` on medium's
       files: the grammar files the golden hash, medium's path launched,
       and DIR's ``torch.profiler`` trace naming each of that path's
       ``__global__`` functions; the trace's csrc kernel time, its device
       busy time (the union of kernels, copies and sets) and that busy
       time's share of the run's wall and of its phases' sum printed,
       beside the wall of the same CLI run without ``--profile``;
   3g. budget -- ``utils.budget`` on the card: the card's budget,
       europarl's footprint equal to its index's tensor bytes and at most
       its run's peak, ``auto`` replicated at europarl; then, each in its
       own process and all at once, the CLI under ``CGX_DEVICE_MEM_MB``
       budgets: on medium's files, ``--sa-shards 0`` and ``auto`` under
       half the footprint each exit 1 with one line naming ROADMAP item
       10b (every shard would share the card); on europarl's index dir,
       ``--sa-shards 4`` under a budget that holds its whole 4-shard
       layout gives the golden (the loaded sharded path's kernels only),
       and under one 4 KiB short exits 1 with one such line; and
       ``--dp-devices 2`` exits 1 past the one card (3h's check);
   3h. local_dp -- ``parallel.localdp.LocalDPEngine`` over ``cuda:0``
       repeated: europarl from its index dir over 2 and 3 replicas, and
       medium, fresh, over 2 with ``lcp_passes`` (B1 fanned): the golden
       hash and counters, each kernel launched at least as often as in
       the one-device run (3c's loaded run, 3's ``lcp_passes`` run; the
       replicas take lookup1's and lookup2's host routes, A2f and A2b and
       A5, where one device takes A2m and A5m: the one run that launches
       A2 and A5), no A4
       where the index is loaded, and a peak within the one-device run's
       plus each further replica's own cached rows and 8 MiB; walls beside
       the one-device walls;
   3i. multiprocess -- two ``cgx_tpu_torch.cli --coordinator`` processes
       (gloo on loopback) both on the card: on europarl's index dir (both
       load), then on medium with a fresh dir (process 0 builds and saves
       it, process 1 waits for its word and loads), then the composed
       mode on europarl's dir with ``--sa-shards 2`` (one shard a
       process, both on the card); the union of their files the golden
       hash, each stderr its ``queries [lo, hi)`` line, the ``-s``
       timefile the ``global max-across-processes`` suffix, their
       launches together the path's kernels, and in the composed pair
       each process's B2s and B2t half of the one-process ``* 2`` run's
       and their B2g, B3 and A7v/A8v launches together that run's (each
       launches only its own shard's).  The CLI
       processes of 3g and 3i print their launch counts at exit
       (``LAUNCH_WRAPPER``), which count as the in-process runs' do;
   3j. unsampled -- medium with ``is_sample`` off (every occurrence
       extracted, as ``--no-sample``): the sampled medium run's kernels
       (A1, A4, A2m, A3, A5m, A6, A7, A8, A9) and no other, every
       query's lines equal to the port's plain path on the CPU and
       ``UNSAMPLED_REF_QUERIES``' to ``perfbench.reference``'s (the text
       turned into its arrays, ``tools/reference_text.py``), the files
       ``grammar.<i>.n`` and some SampleCountF past log10(301); its line
       prints the items each kernel took and the extraction's counters.
       It runs after the capture closes, so the kernel rows of phase 7
       keep the sampled paths' largest launches;
4. query_dp -- ``parallel.dist.run_sharded_search`` on the europarl run's
   index, pass-1 tokens and sampled block occurrences, over four shards and
   then two on the one card (kernel B4, one launch per shard with its
   device current, and nothing else):
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
   direction, A2 on A2m's largest launch's items, B1 once per pass, A4, A7 and A8 also on a shard's views, as
   A4v, A7v and A8v, and A9 on the dense europarl tables as A9L), and
   every kernel that reads a shard's views (A4v,
   A7v, A8v, B3f, B3b, B3p, B3t, B3c) also on its largest launch on each
   shard (B2s on a launch that applies a token, on copies of the lanes it
   updates in place), the first (negative global offset) and the last (reads clamped to
   the global end) included, and A5m also with its write pass in ranges
   of 1, 7 and a third of its rows (``row_budget_ranges``, ranges that
   start inside a warp), and A2m's route (``lookup.scan_rows``, its keys
   sorted on the device by A2s) against A2 and the host route
   (``route_rows``): the outputs must be bit-equal (float32
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
   only for the items whose candidate mask is non-zero; A4, A5, A5m, C1t
   and B3t the gap check's words; A5, A5m, C1t and B3t the move words up
   to the first stop (A5m also its tables and 3 words a row it keeps);
   A6, B3c and B4's extraction the words and growth steps of
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
   (A1, B2r, A2f, A2b, A2m, A2s, A3, A4, A4v, C1f, C1b, C1p, B3f, B3b,
   B3p, A6, B3c, A5, A5m, C1t, B3t, A7, A7v, A8, A8v, A10, A9, B1p1, B1p2)
   against their plain versions on synthetic edge inputs over europarl's
   index arrays and tables (A2m on A2's edge items with pattern ids up to
   2^20, its route as on its kernel row at 33 items and mrs 15; A2s on
   1-13,288 unique keys of 1-63 bits; A5m also with its write pass in
   ranges of 1, 7 and a third of the rows, as on its kernel row; A9 over
   medium's dense tables; B1
   also over a small index of
   70-token sentences, for matches past 32 tokens; B2r also on 1 and 3
   shards; B2s and B2t at every step of the round form on the same lanes
   over 1, 3 and 4 shards on the card repeated, and on ``round_edges``'
   intervals 0-257 rows wide whose keys are not sorted, off both ends of
   the SA, and single-row dispatches of 1, 4 and 16 depths), and P1 and
   P2 on short corpora, ragged item counts and grids (``check_edges``).
   Every round-form run's B2s and B2t launches must equal its
   dispatches' plans (``check_round_launches``), and its e2e line prints
   each dispatch's plan (``round_dispatches``: R, T).

Then the script's total seconds, a JSON line with every kernel's numbers
(``launches``: every phase's, 3b-3i included), and last the line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before it.
The script imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
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
# _pass2_batch; the sharded index's _refine_chunk (B2r, and its round form
# on a device list, B2s and B2t), _gather_sa_chunk,
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
    "A2m": ("cgx_tpu_torch/csrc/scan.cu",
            "none (the host rows, cgx_tpu/search/lookup.py:546-583)"),
    "A2s": ("cgx_tpu_torch/csrc/sort.cu",
            "none (the host lexsort, cgx_tpu/search/lookup.py:585-590)"),
    "A3": ("cgx_tpu_torch/csrc/scan.cu", "cgx_tpu/search/lookup.py:315"),
    "A5": ("cgx_tpu_torch/csrc/scan.cu", "cgx_tpu/search/lookup.py:662"),
    "A5m": ("cgx_tpu_torch/csrc/scan.cu",
            "none (the host match, cgx_tpu/search/lookup.py:727-757)"),
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
    "B2s": ("cgx_tpu_torch/csrc/sharded.cu",
            "cgx_tpu/parallel/sharded.py:261"),
    "B2t": ("cgx_tpu_torch/csrc/sharded.cu",
            "cgx_tpu/parallel/sharded.py:261"),
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
PATH_KERNELS = ("A4", "A2m", "A2s", "A3", "A5m", "A6", "A7", "A8")
# lookup1's host route (A2 forward and backward, its hits expanded on the
# host), which of the end-to-end runs only local DP's replicas take
HOST_SCANS = ("A2f", "A2b")
# the host routes of lookup1 and lookup2 (A5, then the match on the host),
# which of the end-to-end runs only local DP's replicas take
# (``check_local_dp``): in place of A2m and A5m on one device
DP_ROUTE = {"A2m": HOST_SCANS, "A2s": (), "A5m": ("A5",)}
SHARDED_KERNELS = ("B2r", "B2g", "B3f", "B3b", "B3p", "B3t", "B3c", "A4v",
                   "A7v", "A8v")
# the sharded index on a device list: the refinement's round form (B2s,
# B2t) in place of B2r, the rest per owning shard
ROUND = ("B2s", "B2t")
ROUND_KERNELS = ROUND + SHARDED_KERNELS[1:]


def round_T(args) -> int:
    """The step count T of the dispatch a B2s launch (``args`` as
    ``sharded.refine_step`` takes them) belongs to: 2 depths R, or 1 on
    the single-row plan (R = 0)."""
    R, depths = args[11], args[13]
    return 2 * depths * R if R else 1


# one card standing in for a device list of 4 and 2 shards
CARD4, CARD2 = ["cuda:0"] * 4, ["cuda:0"] * 2
# the column path's scans, and the kernels no end-to-end run launches (A9L:
# kernel A9 on europarl's lexicon as dense tables of 20,001^2 floats each,
# past DEV_DENSE_LIMIT, so no pipeline run builds them; phase 4b)
COLS_KERNELS = ("C1f", "C1b", "C1t")
OFF_PATH = ("C1p", "B4", "P1", "P2", "A9L")
# the end-to-end runs: (size, lcp_passes, sa_shards, scan_cols, must launch,
# must not)
RUNS = (
    ("medium", False, 0, False, PATH_KERNELS + ("A1", "A9"),
     ("A5", "B1p1", "B1p2") + HOST_SCANS + SHARDED_KERNELS + ROUND
     + COLS_KERNELS + OFF_PATH),
    ("europarl", False, 0, False, PATH_KERNELS + ("A1", "A10"),
     ("A5", "B1p1", "B1p2") + HOST_SCANS + SHARDED_KERNELS + ROUND
     + COLS_KERNELS + OFF_PATH),
    ("europarl", False, 4, False, SHARDED_KERNELS,
     ("A1", "A5", "A9", "A10", "B1p1", "B1p2") + HOST_SCANS + ROUND
     + PATH_KERNELS + COLS_KERNELS + OFF_PATH),
    ("europarl", False, 0, True,
     ("A1", "A4", "A3", "A6", "A7", "A8", "A10") + COLS_KERNELS,
     ("A2m", "A2s", "A5", "A5m", "B1p1", "B1p2") + HOST_SCANS
     + SHARDED_KERNELS
     + ROUND + OFF_PATH),
    ("medium", True, 0, False, PATH_KERNELS + ("B1p1", "B1p2", "A9"),
     ("A1", "A5") + HOST_SCANS + SHARDED_KERNELS + ROUND + COLS_KERNELS
     + OFF_PATH),
    # the index on a device list (the card four times), built fresh, so
    # that A4 runs on the shards' views too
    ("medium", False, CARD4, False, ROUND_KERNELS,
     ("B2r",) + ("A1", "A5", "A9", "A10", "B1p1", "B1p2") + HOST_SCANS
     + PATH_KERNELS + COLS_KERNELS + OFF_PATH),
)

# the runs over europarl's persisted index (saved by RUNS' europarl run):
# (sa_shards, must launch); each must launch nothing else, so no A4 or A4v
# (the precompute is loaded, not run)
LOAD_RUNS = (
    (0, ("A1", "A2m", "A2s", "A3", "A5m", "A6", "A7", "A8", "A10")),
    (4, ("B2r", "B2g", "B3f", "B3b", "B3p", "B3t", "B3c", "A7v", "A8v")),
    # on a device list: the round form, no B2r
    (CARD4, ROUND + ("B2g", "B3f", "B3b", "B3p", "B3t", "B3c", "A7v",
                     "A8v")),
    (CARD2, ROUND + ("B2g", "B3f", "B3b", "B3p", "B3t", "B3c", "A7v",
                     "A8v")),
)
# medium with query_batches=4: MaxLex scores on the host, so no A9 or A10
OVERLAP_KERNELS = PATH_KERNELS + ("A1",)
# the __global__ functions of medium's default path (``cli --profile``),
# by launch id
PROFILE_GLOBALS = {
    "A1": "refine_warp_kernel", "A4": "gap_check_kernel",
    "A2m": "scan_rows_kernel", "A2s": "sort_scatter_kernel",
    "A3": "pcs_kernel",
    "A5m": "two_rows_kernel", "A6": "contig_kernel",
    "A7": "onegap_kernel",
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
    "A2m": (0, 2, 1 / 32, 300),  # A2's, warp counts (+ 2 words a key kept)
    "A2s": (2, 0, 2, 0),         # a key read and written once
    "A3": (0, 0, 1 / 32, 40),    # (+ pcs_reads: offs, pattab, rows, corpus)
    "A5": (0, 2, 1, 150),        # occurrence row (+ scan, gap check)
    "A5m": (0, 2, 1 / 32, 150),  # occurrence row, warp counts (+ scan, gap
    #                              check, 3 words a row kept)
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
SCAN_ROWS = ("A2f", "A2b", "A2m", "C1f", "C1b", "B3f", "B3b")
GAP_ROWS = ("A4", "A4v")
TWO_ROWS = ("A5", "A5m", "C1t", "B3t")
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
TABLE_ARGS = {"A2f": (4, 5), "A2b": (4, 5), "A2m": (4, 5), "A5": (5, 6),
              "A5m": (5, 6, 10, 11, 12)}
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
            # A2m's count pass takes A2's arguments: the main path's A2
            # rows run on its items
            (lookup, "scan_count"): (
                lambda a: ("A2m", "A2f" if a[9] else "A2b"),
                lambda a: a[6]),
            (lookup, "sort_keys"): (lambda a: "A2s",
                                    lambda a: a[0].shape[0]),
            (lookup, "pcs"): (lambda a: "A3", lambda a: a[4]),
            (lookup, "two"): (lambda a: "A5", lambda a: a[7]),
            (lookup, "two_rows"): (lambda a: "A5m", lambda a: a[7]),
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
            (shx, "refine_step"): (lambda a: "B2s", lambda a: a[4].shape[0]),
            (shx, "token_partial"): (lambda a: "B2t",
                                     lambda a: a[5].shape[0]),
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
        self.ranks = {}          # kernel -> the rank of its kept call
        self.shard_calls = {}    # (kernel, view offset) -> (n, args)
        self.dp_calls = []       # every B4 call's args, in shard order
        self.rounds = []         # each round-form dispatch's plan
        self.originals = {site: getattr(*site) for site in self.sites}
        self.originals[(shx, "refine_round")] = shx.refine_round
        self.view_type = OffsetView
        self.shx = shx

    def __enter__(self):
        for site, (kernel_of, count_of) in self.sites.items():
            real = self.originals[site]

            def hook(*args, _real=real, _k=kernel_of, _n=count_of):
                ks, n = _k(args), _n(args)
                ks = ks if isinstance(ks, tuple) else (ks,)
                k = ks[0]
                # the largest launch; of B2s's, a tree step that both
                # applies tokens and reads (0 < g < T).  B2s updates its
                # lanes in place and a later step B2t's, so theirs are kept
                # as copies
                rank = (n, k == "B2s" and 0 < args[10] < round_T(args))
                for kk in ks:
                    if rank > self.ranks.get(kk, (-1, False)):
                        self.ranks[kk] = rank
                        self.calls[kk] = (n, tuple(
                            a.clone() if k in ROUND and hasattr(a, "clone")
                            else a for a in args))
                if k == "B4":
                    self.dp_calls.append(args)
                if isinstance(args[0], self.view_type):
                    key = (k, int(args[0].off))
                    if n > self.shard_calls.get(key, (-1, None))[0]:
                        self.shard_calls[key] = (n, args)
                return _real(*args)
            setattr(*site, hook)
        shx = self.shx
        real_round = self.originals[(shx, "refine_round")]

        def round_hook(sidx, qtok, toks, sls, lo, hi, d0, depths):
            R, T = shx.round_plan(lo, hi, depths)
            self.rounds.append({"lanes": len(toks), "d0": d0,
                                "depths": depths, "R": R, "T": T,
                                "shards": len(sidx.local_shards())})
            return real_round(sidx, qtok, toks, sls, lo, hi, d0, depths)
        shx.refine_round = round_hook
        return self

    def __exit__(self, *exc):
        for site, real in self.originals.items():
            setattr(*site, real)


_CORPORA = {}


def run_e2e(size: str, device: str, capture: Capture, golden: dict,
            expect: tuple, lcp_passes: bool = False, forbid: tuple = (),
            sa_shards: int = 0, scan_cols: bool = False,
            index_dir: str = None, query_batches: int = 0,
            dp_devices: list = None):
    """One end-to-end run -> (its launch counts, its PipelineResult, its
    own peak device bytes: the peak less what was allocated before it, such
    as the earlier runs' tensors the capture holds, and its wall seconds).
    ``index_dir``: the run saves its index there, or loads it when the dir
    holds one; ``query_batches``: ``run_pipeline_overlap`` over that many
    batches, whose summed pattern counters are not the golden's (its lines
    are); ``dp_devices``: the devices of a ``LocalDPEngine``."""
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
    kb.ITEMS.clear()
    kb.BYTES.clear()
    capture.rounds.clear()
    cuda = torch.device(device).type == "cuda"
    held = torch.cuda.memory_allocated() if cuda else 0
    t0 = time.perf_counter()
    kw = dict(device=device, lcp_passes=lcp_passes, sa_shards=sa_shards,
              scan_cols=scan_cols, index_dir=index_dir,
              dp_devices=dp_devices or 0)
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
        f" ({query_batches} query batches)" if query_batches else "") + (
        f" (dp over {len(dp_devices)})" if dp_devices else "")
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
        "dp_devices": [str(d) for d in dp_devices] if dp_devices else None,
        "corpus_gen_s": gen_s, "wall_s": wall,
        "phases_s": res.timing.as_dict(),
        "peak_mem_bytes": res.timing.peak_memory(),
        "held_before_bytes": held, "run_peak_mem_bytes": run_peak,
        "counters": res.counters, "launches": launches,
        "items": dict(kb.ITEMS), "bytes": dict(kb.BYTES),
        **({"round_dispatches": capture.rounds} if capture.rounds else {}),
        "grammar_sha256": ghash, "golden_ok": ghash == want["sha256"]}),
        flush=True)
    check_round_launches(what, launches, capture.rounds)
    if not ok_shape:
        fail(f"{what}: malformed grammar lines")
    if counters_off or not lines_ok:
        fail(f"{what}: counters (port, JAX) differ: {counters_off}, lines "
             f"{res.counters['total_lines']} vs {want['lines']}")
    if ghash != want["sha256"]:
        fail(f"{what}: grammar hash {ghash[:16]} != golden "
             f"{want['sha256'][:16]}")
    return launches, res, run_peak, wall


def check_round_launches(what: str, launches: dict, rounds: list):
    """The round form's launches equal its dispatches' plans: B2s T + 1
    times a dispatch on each local shard, B2t T times."""
    want = (sum(r["shards"] * (r["T"] + 1) for r in rounds),
            sum(r["shards"] * r["T"] for r in rounds))
    if (launches["B2s"], launches["B2t"]) != want:
        fail(f"{what}: B2s/B2t launched {launches['B2s']}/"
             f"{launches['B2t']} times, the dispatches' plans {want}")


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
    """Phase 4: the query-DP step over four shards and over two on the
    card, on a run's index, queries and blocks -> its launch counts."""
    totals = {k: 0 for k in KERNELS}
    for shards in (4, 2):
        for k, v in _query_dp(res, capture, shards).items():
            totals[k] += v
    return totals


def _query_dp(res, capture: Capture, shards: int) -> dict:
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
    devices = dist.make_mesh(devices=["cuda:0"] * shards)
    kb.LAUNCHES.clear()
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
        if k in ("A2f", "A2b", "A2m"):
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
        cand, window, gap, ok, kept = reads.scan_rows_reads(
            refstr, rlp, lr_tar, *items, mrs, mgs, fwd)
        got = {"candidate_items": cand, "candidate_share": cand / n,
               "window_words": window, "window_words_per_item": window / n,
               "gap_words": gap, "gap_first_test_items": ok}
        if k == "A2m":     # and the keys it writes, 2 words each
            got.update(rows=kept, rows_per_item=kept / max(n, 1))
            window += 2 * kept
        return (window + gap, cand * GAP_OPS + ok * FOLD_OPS, got)
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
    if k in ROUND:
        words, live = reads.refine_round_reads(k, *args)
        return (words, REFINE_STEP_OPS * live,
                {"words": words, "words_per_lane": words / max(n, 1),
                 "live_lanes": live})
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
        if k in ("A5", "A5m"):
            refstr, rlp, lr_tar, ogrows, pcrows, pattab, offs, _, mrs, mgs = \
                args[:10]
            f, tx = lookup._expand(pattab, offs, n)
            row = f[:, 0] + tx
            occ = torch.where((f[:, 1] > 0)[:, None], take(pcrows, row),
                              take(ogrows, row))
            items = (occ[:, 0], occ[:, 1])
        else:
            refstr, rlp, lr_tar, pstart, plen, mrs, mgs = args
            items = (pstart, plen)
        words, ok = reads.two_reads(refstr, rlp, lr_tar, *items, mrs, mgs)
        if k == "A5m":     # and the rows it keeps, 3 words each
            kept = lookup.two_rows_plain(*args).shape[0]
            return (words + 3 * kept, n * GAP_OPS + ok * FOLD_OPS,
                    {"words": words, "words_per_item": words / max(n, 1),
                     "gap_first_test_items": ok, "rows": kept,
                     "rows_per_item": kept / max(n, 1)})
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
    if k in ROUND:         # every word is counted by refine_round_reads
        return 4 * words, ops
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


def _a5m_ranges(what: str, args, device: str) -> dict:
    """A5m with its write pass split into ranges of 1 row, 7 rows and a
    third of the rows (so that ranges start and end inside a warp), each
    bit-equal to the plain version -> {row budget: ranges}."""
    import functools
    from cgx_tpu_torch.search import lookup
    total = lookup.two_rows_plain(*args).shape[0]
    ranges = {}
    for b in sorted({1, 7, max(1, total // 3)}):
        _bit_equal(f"A5m@{what},row_budget={b}",
                   functools.partial(lookup.two_rows, row_budget=b),
                   lambda *a: lookup.two_rows_plain(*a).cpu(), args, device)
        ranges[b] = -(-total // b)
    return ranges


_A2M_KEYS = {}


def _a2m_key(args):
    """The key layout of A2m's route on one launch's items (A2's
    arguments), as ``lookup.device_row_key`` fixes it: the launch's pattern
    ids and its SA's words bound the fields (kept per launch, so that the
    timed calls do not recompute it)."""
    import numpy as np
    from cgx_tpu_torch.search import lookup
    sa, pattab, mrs = args[3], args[4], args[7]
    at = (id(sa), id(pattab), mrs)
    if at not in _A2M_KEYS:     # the tensors kept, so no id is reused
        _A2M_KEYS[at] = (lookup.device_row_key(
            int(pattab[:, 6].max()) + 1, int(sa.max()) + 1, mrs,
            np.empty((0, 3), np.int64)), sa, pattab)
    return _A2M_KEYS[at][0]


def _a2m_kernel(*args):
    """A2m's two passes on A2's arguments -> [the count pass's prefix,
    every key of the write pass, (item, move) order]."""
    import torch
    from cgx_tpu_torch.search import lookup
    woff = lookup.scan_count(*args)
    keys = torch.empty(int(woff[-1]), dtype=torch.int64, device=woff.device)
    lookup.scan_keys(*args, woff, _a2m_key(args), keys)
    return [woff, keys]


def _a2m_plain(*args):
    """``_a2m_kernel``'s outputs from A2m's plain versions."""
    import torch
    from cgx_tpu_torch.search import lookup
    c = lookup.scan_count_plain(*args)
    woff = torch.cat([torch.zeros(1, dtype=torch.int64, device=c.device),
                      torch.cumsum(c, 0, dtype=torch.int64)])
    return [woff, lookup.scan_rows_plain(*args, _a2m_key(args))]


def _a2m_route(what: str, args, device: str) -> int:
    """A2m's route (``lookup.scan_rows``: both passes, its keys sorted and
    unpacked on the device by A2s) on one launch's items, bit-equal to A2
    and the host route (A2's masks, their hits expanded on the host, the SA
    words read, the rows sorted by ``lookup._sort_rows``) -> its rows."""
    import numpy as np
    import torch
    from cgx_tpu_torch.search import lookup
    refstr, rlp, lr_tar, sa, pattab, offs, n, mrs, mgs, fwd = args
    tab = pattab.cpu().numpy().astype(np.int64)
    counts = np.diff(offs.cpu().numpy().astype(np.int64))
    ii, mm = lookup._mask_hits(lookup.scan(*args).cpu().numpy())
    pat, tx, pi = lookup.expand_hits(ii, counts, tab[:, 6])
    rows = np.clip(tab[pi, 0] + tx, 0, sa.shape[0] - 1)
    g = sa[torch.from_numpy(rows).to(sa.device)].cpu().numpy().astype(
        np.int64)
    sl, el = tab[pi, 1], tab[pi, 2]
    start = g if fwd else g - mgs - mm - sl
    want = torch.from_numpy(np.stack(lookup._sort_rows(
        [np.stack([pat, start, sl + mgs + mm + el - 1], axis=1)],
        int(tab[:, 6].max()) + 1)).astype(np.int32))
    _bit_equal(f"A2m@{what},route",
               lambda *a: torch.from_numpy(lookup.scan_rows(
                   refstr, rlp, lr_tar, sa, [(pattab, offs, n, fwd)],
                   np.empty(0, np.int64), _a2m_key(args), mrs, mgs)),
               lambda *a: want, args, device)
    return want.shape[1]


def _step_outputs(step):
    """B2s's function (``step``: the kernel's wrapper or its plain version)
    as outputs: the part it writes and the lanes' state, ups and downs after
    the step, on copies of the inputs it updates in place."""
    def run(*args):
        args = list(args)
        args[6:9] = [t.clone() for t in args[6:9]]
        out = step(*args)
        return ([] if out is None else [out]) + args[6:9]
    return run


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
             "A2m": (_a2m_kernel, _a2m_plain),
             # on a permutation of the keys: the kernel uses its input as
             # scratch
             "A2s": (lookup.sort_keys, lookup.sort_keys_plain),
             "A3": (lookup.pcs, lookup.pcs_plain),
             "A5": (lookup.two, lookup.two_plain),
             # the kernel's wrapper returns its rows on the host
             "A5m": (lookup.two_rows,
                     lambda *a: lookup.two_rows_plain(*a).cpu()),
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
             "B2s": (_step_outputs(shx.refine_step),
                     _step_outputs(shx.refine_step_plain)),
             "B2t": (shx.token_partial, shx.token_partial_plain),
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
    flat = {}

    def b2g_take(sidx, rows, shard=None):
        """B2g's function as one PyTorch call, ``torch.take`` over the
        stacked rank slices at the clamped ranks (stacked once, outside the
        timed calls); B2g's own 0 at a rank no shard owns is not in it."""
        key = (id(sidx), shard)
        if key not in flat:
            flat[key] = ((torch.stack(sidx.sa_l).reshape(-1), 0, sidx.reflen)
                         if shard is None else
                         (sidx.sa_l[shard], *(int(x)
                                              for x in sidx.rmeta[shard])))
        words, start, count = flat[key]
        return torch.take(words, (rows - start).clamp(0, count - 1).long())
    # one PyTorch call computing a kernel's function (P1: with its sum, a
    # second call), timed beside it only
    library = {"P1": lambda ref, pos: gp.library_rows(ref, pos).sum(
        dtype=torch.int32), "P2": gp.library_rows, "B2g": b2g_take}
    # B2s is timed as the pipeline calls it (its in-place update on the
    # kept copies of its inputs), and compared on copies of them
    timed = {"B2s": (shx.refine_step, shx.refine_step_plain)}
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
        src, replaces = KERNELS[k]
        words = ops = 0
        extra = {}
        if k in (SCAN_ROWS + GAP_ROWS + TWO_ROWS + CONTIG_ROWS + ONEGAP_ROWS
                 + TWOGAP_ROWS + MAXLEX_ROWS + DENSE_ROWS + LCP_ROWS
                 + REFINE_ROWS + PCS_ROWS + PROBE_ROWS + ROUND):
            words, ops, extra = data_reads(k, n, args)
        if k == "A5m":    # the write pass in ranges, as the cells split it
            extra["row_budget_ranges"] = _a5m_ranges("main", args, device)
        if k == "A2m":    # the route: its keys sorted on the device
            extra["route_rows"] = _a2m_route("main", args, device)
        nbytes, ops = work(k, n, args, words, ops)
        # timed after the bound is counted: B2s's timed calls update its
        # kept lanes in place
        tk, tp = timed.get(k, (kernel, plain))
        ms, reps = _time_ms(lambda: tk(*args), device)
        dev = _device_ms(lambda: tk(*args), reps)
        plain_ms = _time_ms(lambda: tp(*args), device)[0]
        library_ms = None
        if k in library:
            if k == "B2g" and not torch.equal(library[k](*args),
                                              kernel(*args)):
                extra["library_why"] = ("torch.take differs from B2g on "
                                        "this launch's rows")
            else:
                library_ms = _time_ms(lambda: library[k](*args), device)[0]
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
    ends; B2r's round form (``sharded.refine_round``) on the same lanes over
    the same 1, 3 and 4 shards placed on the card repeated (4 depths, and
    16 for 33 lanes), B2s and B2t each against its plain version at every
    step on every shard (``round_checked``), and the dispatch's result
    against B2r's plain version -> counts per kernel (B2r's per shard count
    too).  Every interval is an SA interval of suffixes that share their
    first d0 tokens, as on the main path (csrc/refine.cuh's premise)."""
    import dataclasses
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
    stats["B2s"] = {"dispatches": 0, "launches": 0, "lanes": 0,
                    "shards": {S: 0 for S in views}}
    stats["B2t"] = {"launches": 0}
    listed = {S: dataclasses.replace(
        v, devices=[torch.device("cuda", 0)] * S, listed=True,
        _shard_tables={}, _qtok=None) for S, v in views.items()}

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
                    if depths == 4 or n == EDGE_ITEMS[-1]:
                        with round_checked(stats):
                            got = shx.refine_round(
                                listed[S], q, *(np.asarray(x, np.int32)
                                                for x in lanes[:4]),
                                d0, depths)
                        want = shx.refine_sharded_plain(views[S], q,
                                                        *lane_args)
                        if not all(torch.equal(a, b)
                                   for a, b in zip(got, want)):
                            fail(f"B2s/B2t@edge(S={S},{what}): the round "
                                 f"form differs from B2r's plain version")
                        stats["B2s"]["dispatches"] += 1
                        stats["B2s"]["lanes"] += n
                        stats["B2s"]["shards"][S] += 1
                    st = stats["B2r"]
                    st["shards"][S] += 1
                    for b in np.arange(1, S) * views[S].BR:
                        st["rows_straddle"] += int(
                            (live & (lo < b) & (hi > b)).sum())
                    first = head[np.clip(lo, 0, reflen - 1)]
                    last = head[np.clip(hi - 1, 0, reflen - 1)]
                    st["positions_straddle"] += int((live & (
                        first // views[S].B != last // views[S].B)).sum())
    round_edges(listed, views, refstr, rng, reflen, stats)
    return stats


# the interval widths of ``round_edges``' tree-step dispatches: a tree
# step's 5 levels end within 31 rows, so 31-33 and 255-257 straddle one and
# four steps a bound
ROUND_EDGE_WIDTHS = (0, 1, 2, 15, 16, 31, 32, 33, 255, 256, 257)


def round_edges(listed: dict, views: dict, refstr, rng, reflen: int,
                stats: dict):
    """B2s and B2t at every step of the round form (``round_checked``) on
    intervals that are not SA intervals of a shared prefix, so that the
    keys they read are not sorted: ``ROUND_EDGE_WIDTHS`` rows at random
    ranks, off the SA's front and off its back, a dispatch a width (tree
    steps from 2 rows on, R = 1 and 2; d0 0 and 3, 4 depths), and dispatches of single-row intervals (empty, inverted,
    one row, a row off each end of the SA) with 1, 4 and 16 depths from
    d0 0, 5 and 7; every lane's query ends at, before or after d0 (depths
    past its end), the padded corpus as the query tokens; over 1, 3 and 4
    shards on the card repeated; each dispatch's result against B2r's
    plain version (JAX's bisection through the shards).  Counts into
    ``stats``: dispatches per plan and per shard count, lanes per width,
    lanes off each end."""
    import numpy as np
    import torch
    from cgx_tpu_torch.parallel import sharded as shx
    st = stats["B2s"]
    st.update(tree_dispatches=0, row_dispatches=0, off_front=0, off_back=0,
              widths={w: 0 for w in ROUND_EDGE_WIDTHS}, row_depths=[])

    def dispatch(S, lo, hi, d0, depths):
        n = len(lo)
        toks = rng.integers(0, reflen, n).astype(np.int32)
        sls = rng.choice([0, d0 - 1, d0, d0 + 1, d0 + 3, 40], n).astype(
            np.int32)
        lanes = [np.asarray(x, np.int32) for x in (toks, sls, lo, hi)]
        with round_checked(stats):
            got = shx.refine_round(listed[S], refstr, *lanes, d0, depths)
        want = shx.refine_sharded_plain(
            views[S], refstr, *(torch.from_numpy(x).cuda() for x in lanes),
            d0, depths)
        what = f"S={S},d0={d0},depths={depths}"
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"B2s/B2t@round_edges({what}): the round form differs "
                 f"from B2r's plain version")
        R, _ = shx.round_plan(lo, hi, depths)
        st["row_dispatches" if R == 0 else "tree_dispatches"] += 1
        st["dispatches"] += 1
        st["lanes"] += n
        st["shards"][S] += 1
        st["off_front"] += int((lo < 0).sum())
        st["off_back"] += int((hi > reflen).sum())
        return R

    for S in listed:
        for d0 in (0, 3):
            for w in ROUND_EDGE_WIDTHS:
                # three lanes w rows wide (at a random rank, off the front,
                # off the back) and five narrower ones; the widest decides
                # the plan
                lo = np.concatenate([[rng.integers(0, reflen - w),
                                      -(w // 2) - 1, reflen - w // 2],
                                     rng.integers(0, reflen - w, 5)])
                hi = lo + np.concatenate([[w] * 3,
                                          rng.integers(0, w + 1, 5)])
                st["widths"][w] += 3
                if (dispatch(S, lo, hi, d0, 4) == 0) != (w <= 1):
                    fail(f"B2s@round_edges: a dispatch {w} rows wide took "
                         f"the wrong plan")
        for d0, depths in ((0, 1), (5, 4), (7, 16)):
            lo = rng.integers(0, reflen, 40)
            hi = lo + rng.integers(0, 2, 40)
            lo[:4] = [-1, reflen, reflen - 1, 9]
            hi[:4] = [0, reflen + 1, reflen, 7]
            if dispatch(S, lo, hi, d0, depths) != 0:
                fail("B2s@round_edges: a single-row dispatch took tree "
                     "steps")
            st["row_depths"].append(depths)


@contextlib.contextmanager
def round_checked(stats: dict):
    """Within the block every step of the round form runs kernel B2s and
    B2t and, on copies of the same inputs, their plain versions, and fails
    unless every output (B2s's part, and the lanes' state, ups and downs it
    updates) is bit-equal; each launch counted in ``stats``."""
    from cgx_tpu_torch.parallel import sharded as shx
    real_step, real_tok = shx.refine_step, shx.token_partial

    def step(*args):
        want = _step_outputs(shx.refine_step_plain)(*args)
        out = real_step(*args)
        got = ([] if out is None else [out]) + list(args[6:9])
        if not all(torch_equal(a, b) for a, b in zip(got, want)):
            fail(f"B2s@edge: step {args[10]} of R={args[11]} differs from "
                 f"its plain version")
        stats["B2s"]["launches"] += 1
        return out

    def tok(*args):
        out = real_tok(*args)
        if not torch_equal(out, shx.token_partial_plain(*args)):
            fail("B2t@edge: differs from its plain version")
        stats["B2t"]["launches"] += 1
        return out
    shx.refine_step, shx.token_partial = step, tok
    try:
        yield
    finally:
        shx.refine_step, shx.token_partial = real_step, real_tok


def torch_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


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
      A2's; A5m on the same items, each pattern's keys about half the c
      tokens of the moves A5 keeps for its items and other corpus words
      (none for about a fifth of the patterns), also with its write pass
      in ranges of 1, 7 and a third of the rows; C1t the
      same rows as columns, and B3t on the first and the last shard's
      views at their own ends too;
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
    A5's set both halves of its word (cand and gc), A5m's keep rows, with
    some warp keeping two or more (so that its write ranges start inside
    a warp), A7's emit each of its
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
    stats = {k: {"launches": 0} for k in ("A2f", "A2b", "A2m", "A2s", "A4",
                                          "A4v", "C1f", "C1b", "B3f", "B3b",
                                          "A6", "B3c", "A5", "A5m", "C1t",
                                          "B3t")}
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
        elif k == "A5m":
            add("rows", out.shape[0])
        elif k == "A2m":
            add("rows", out[1].shape[0])
        elif k == "A2s":
            add("keys", out.shape[0])
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
                    # column 6: A2m's pattern ids, up to 2^20
                    pattab = np.stack([lo, sl, el] + toks
                                      + [rng.integers(0, 1 << 20, D),
                                         0 * lo], axis=1)
                    args = (refstr, rlp, lr_tar, dev(pos), dev(pattab),
                            dev(offs), n, mrs, mgs, fwd)
                    what = f"n={n},mrs={mrs},r={r}"
                    masks = compare(k, lookup.scan, lookup.scan_plain, args,
                                    what)
                    compare("A2m", _a2m_kernel, _a2m_plain, args,
                            f"{k},{what}")
                    if n == EDGE_ITEMS[-1] and mrs == EDGE_MRS[-1]:
                        stats["A2m"][f"route_rows_{k},r={r}"] = \
                            _a2m_route(f"edge({k},{what})", args, "cuda")
                    # the items as columns: item j of pattern p (the last
                    # with offs[p] <= j) starts at pos[lo[p] + j - offs[p]],
                    # clamped as the SA read is
                    j = np.arange(n)
                    p = np.clip(np.searchsorted(offs, j, side="right") - 1,
                                0, D - 1)
                    g_j = pos[np.clip(lo[p] + j - offs[p], 0, len(pos) - 1)]
                    a2_items.append((fwd, mrs, [g_j] + [pattab[p, c] for c in
                                                        range(1, 6)], masks))
    # A2s on unique keys of 1 to 63 bits, tiles of 4,096 keys full and
    # ragged (its input a scratch buffer: each call on a copy)
    for n in (1, 255, 4095, 4096, 4097, 3 * 4096 + 1000):
        for bits in (1, 8, 9, 31, 47, 63):
            got = np.unique(rng.integers(0, 1 << bits, 2 * n, dtype=np.int64)
                            if bits < 63 else rng.integers(
                                0, np.iinfo(np.int64).max, 2 * n))[:n]
            keys = torch.from_numpy(rng.permutation(got)).cuda()
            compare("A2s", lambda k, b: lookup.sort_keys(k.clone(), b),
                    lookup.sort_keys_plain, (keys, bits),
                    f"n={len(got)},bits={bits}")
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
                word = compare("A5", lookup.two, lookup.two_plain,
                               (refstr, rlp, lr_tar, dev(tables[0]),
                                dev(tables[1]), dev(pattab), dev(offs), n,
                                mrs, mgs),
                               f"n={n},mrs={mrs},first={edge_rows[e]}")
                # A5m on the same items: each pattern's keys (none for about
                # a fifth) are about half the c tokens of the moves A5 keeps
                # for its items and two other corpus words, ascending, then
                # one key that no pattern owns
                word = word.cpu().numpy().astype(np.int64)
                ii, mm = np.nonzero(((word & (word >> 16))[:, None]
                                     >> np.arange(16)) & 1)
                p_j, occ = (t.cpu().numpy() for t in lookup._two_occurrences(
                    dev(tables[0]), dev(tables[1]), dev(pattab), dev(offs),
                    torch.arange(n, dtype=torch.int32, device="cuda")))
                ctok = ref_h[np.minimum(occ[ii, 0] + occ[ii, 1] + 1 + mgs
                                        + mm, glen - 1)]
                keys, matched = [], np.zeros(len(ii), bool)
                for p in range(D):
                    own = np.unique(ctok[p_j[ii] == p])
                    own = own[rng.random(len(own)) < 0.5]
                    keys.append(np.unique(np.concatenate(
                        [own, ref_h[rng.integers(0, glen, 2)]]))
                        if rng.random() >= 0.2 else np.empty(0, np.int64))
                    at = p_j[ii] == p
                    matched[at] = np.isin(ctok[at], keys[-1])
                kptr = np.concatenate([[0], np.cumsum([len(k) for k in keys])])
                kctok = np.concatenate(keys + [ref_h[:1]])
                st = stats["A5m"]
                st["fullest_warp"] = max(st.get("fullest_warp", 0), int(
                    np.bincount(ii[matched] // 32, minlength=1).max()))
                a5m = (refstr, rlp, lr_tar, dev(tables[0]), dev(tables[1]),
                       dev(pattab), dev(offs), n, mrs, mgs, dev(kptr),
                       dev(kctok), dev(rng.integers(0, 1 << 20, len(kctok))))
                what = f"n={n},mrs={mrs},first={edge_rows[e]}"
                compare("A5m", lookup.two_rows,
                        lambda *a: lookup.two_rows_plain(*a).cpu(), a5m, what)
                st["ranges"] = st.get("ranges", 0) + sum(
                    _a5m_ranges(f"edge({what})", a5m, "cuda").values())
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
    silent += [f"{k}.{f}" for k, f in (("A2m", "rows"), ("A2s", "keys"))
               if stats[k].get(f, 0) == 0]
    # A5m's edges keep rows, and some warp keeps two or more, so that the
    # write ranges of 1 and 7 rows start inside a warp
    silent += [f"A5m.{f}" for f in ("rows", "ranges")
               if stats["A5m"].get(f, 0) == 0]
    if stats["A5m"].get("fullest_warp", 0) < 2:
        silent.append("A5m.fullest_warp")
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


# 3j: medium with ``is_sample`` off; the queries compared with the
# reference (every query: under 1 s each on the host)
UNSAMPLED_REF_QUERIES = tuple(range(32))


def check_unsampled(work: str) -> dict:
    """3j. medium with ``is_sample`` off (every occurrence extracted) on
    the card: the sampled medium run's kernels and no other, every query's
    lines equal to the port's plain path on the CPU and
    ``UNSAMPLED_REF_QUERIES``' to ``perfbench.reference``'s, the files
    ``grammar.<i>.n``, and some rule's SampleCountF past log10(301), which
    a sampled run cannot give -> the launch counts."""
    import dataclasses
    import math
    import re
    import torch
    from cgx_tpu_torch.config import DEFAULT_CONFIG
    from cgx_tpu_torch.grammar import writer as gw
    from cgx_tpu_torch.kernels import build as kb
    from cgx_tpu_torch.pipeline import run_pipeline
    cfg = dataclasses.replace(DEFAULT_CONFIG, is_sample=False)
    data = _CORPORA["medium"]
    kb.LAUNCHES.clear()
    kb.ITEMS.clear()
    kb.BYTES.clear()
    counts0 = dict(kb.COUNTS)
    t0 = time.perf_counter()
    res = run_pipeline(*data, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect, forbid = RUNS[0][4], RUNS[0][5]
    launches = check_launches("medium (unsampled)", expect, forbid)
    items = dict(kb.ITEMS)
    grew = {k: v - counts0.get(k, 0) for k, v in kb.COUNTS.items()
            if k.startswith(("extract.", "grammar."))}
    t0 = time.perf_counter()
    plain = run_pipeline(*data, cfg, device="cpu")
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = _load_tool("reference_text").reference_grammar(
        data, {"is_sample": False}, UNSAMPLED_REF_QUERIES)
    ref_s = time.perf_counter() - t0
    lines = res.per_query_lines
    dest = os.path.join(work, "medium_unsampled")
    gw.write_grammars(dest, res.queries.qryscount, cfg.is_sample, lines)
    files = sorted(os.listdir(dest))
    counts = [float(m.group(1)) for q in lines for ln in q
              for m in [re.search(r"SampleCountF=([0-9.]+)", ln)] if m]
    plain_off = [q for q in range(len(lines))
                 if lines[q] != plain.per_query_lines[q]]
    ref_off = [q for q, want in zip(UNSAMPLED_REF_QUERIES, ref)
               if lines[q] != want]
    print(json.dumps({
        "phase": "e2e_unsampled", "size": "medium", "wall_s": wall,
        "plain_cpu_s": plain_s, "reference_s": ref_s,
        "reference_queries": list(UNSAMPLED_REF_QUERIES),
        "phases_s": res.timing.as_dict(), "counters": res.counters,
        "launches": launches, "items": items, "bytes": dict(kb.BYTES),
        "counted": grew, "max_sample_count_f": max(counts, default=None),
        "grammar_sha256": grammar_hash(lines),
        "plain_queries_off": plain_off, "reference_queries_off": ref_off}),
        flush=True)
    if files != sorted(f"grammar.{q}.n" for q in range(len(lines))):
        fail(f"medium (unsampled): files {files[:3]} are not grammar.<i>.n")
    if plain_off:
        fail(f"medium (unsampled): queries {plain_off[:5]} differ from the "
             "port's plain path on the CPU")
    if ref_off:
        fail(f"medium (unsampled): queries {ref_off} differ from "
             "perfbench.reference")
    if not counts or max(counts) <= math.log10(301):
        fail("medium (unsampled): no SampleCountF past log10(301): the "
             "run was sampled")
    return launches


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


# ``python -c`` body that runs a module as ``__main__`` and prints its
# kernels' launch counts as the last line of its stderr, so the CLI runs in
# their own processes (3g-3i) are counted as the in-process runs are
LAUNCH_WRAPPER = (
    "import atexit, json, runpy, sys\n"
    "from cgx_tpu_torch.kernels import build as kb\n"
    "from cgx_tpu_torch.parallel import sharded as shx\n"
    "steps, real = [], shx.refine_round\n"
    "def hook(sidx, qtok, toks, sls, lo, hi, d0, depths):\n"
    "    steps.append(shx.round_plan(lo, hi, depths)[1])\n"
    "    return real(sidx, qtok, toks, sls, lo, hi, d0, depths)\n"
    "shx.refine_round = hook\n"
    "atexit.register(lambda: print('launches ' + json.dumps(dict("
    "kb.LAUNCHES)) + '\\nround_steps ' + json.dumps(steps), "
    "file=sys.stderr, flush=True))\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n")


def run_clis(cmds: dict, timeout: float = 600) -> dict:
    """Each named command, (arguments of ``python -m cgx_tpu_torch.cli``,
    extra environment), as its own process, all started together ->
    name: dict(rc, seconds, stderr lines, launches).  Every process is
    waited for or killed before it returns."""
    procs = {}
    t0 = time.perf_counter()
    try:
        for name, (args, env) in cmds.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", LAUNCH_WRAPPER, "cgx_tpu_torch.cli",
                 *args], cwd=ROOT, env={**os.environ, **env},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        out = {}
        for name, proc in procs.items():
            _, err = proc.communicate(timeout=timeout)
            lines = err.splitlines()
            counts = [json.loads(ln[len("launches "):]) for ln in lines
                      if ln.startswith("launches ")]
            steps = [json.loads(ln[len("round_steps "):]) for ln in lines
                     if ln.startswith("round_steps ")]
            out[name] = dict(rc=proc.returncode,
                             seconds=time.perf_counter() - t0,
                             stderr=lines,
                             launches={k: (counts[-1] if counts else {})
                                       .get(k, 0) for k in KERNELS},
                             round_steps=steps[-1] if steps else [])
        return out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _error_lines(res: dict) -> list:
    return [ln for ln in res["stderr"] if ln.startswith("error: ")]


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def index_tensor_bytes(index) -> int:
    """Bytes of the index tensors a ``TorchGrammarIndex`` placed on the
    device, or a ``ShardedGrammarIndex`` in its shards."""
    import torch
    tensors = [v for v in vars(index).values() if isinstance(v, torch.Tensor)]
    tensors += [t for v in vars(index).values() if isinstance(v, list)
                for t in v if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in tensors)


def replica_cache_bytes(index) -> int:
    """Bytes of the per-device caches a run filled on an index (query
    tokens, precomputed rows, LCP tables): what each further replica of
    3h uploads again (MaxLex's tables stay on the first)."""
    import torch
    caches = [index._qtok, index._pcrows, index._lcp]
    return sum(t.numel() * t.element_size() for c in caches if c
               for t in c if isinstance(t, torch.Tensor))


def check_budget(work: str, golden: dict, fp: dict, index_dir: str,
                 device: str = "cuda") -> tuple:
    """3g.  ``utils.budget`` on the card: its budget; europarl's footprint
    (``fp``: per layout, the toklens, the index's tensor bytes and the
    run's own peak, from phase 3) equal to its index's tensors and at most
    the run's peak, and ``auto`` replicated there; then the CLI under
    ``CGX_DEVICE_MEM_MB`` budgets: on medium's files, ``--sa-shards 0`` and
    ``--sa-shards auto`` under a budget that holds half the replicated
    index each exit 1 with one line ending in ``budget.ONE_DEVICE`` (every
    shard would share the one card); on europarl's index dir,
    ``--sa-shards 4`` under a budget that holds its whole 4-shard layout
    (phase 3's tensor bytes of it, all on the one card) runs to the golden
    on the loaded sharded kernels, and under one 4 KiB short of it exits 1
    with one line naming the card it does not fit; and, in the
    same batch, ``--dp-devices 2`` exits non-zero past the card count (3h)
    -> (the launch counts, the ``--dp-devices 2`` run's result)."""
    from cgx_tpu_torch.config import DEFAULT_CONFIG
    from cgx_tpu_torch.utils import budget as bd
    cfg = DEFAULT_CONFIG
    eu, md, sh = fp["europarl"], fp["medium"], fp["europarl_sharded"]
    eu_need = bd.replicated_footprint_bytes(eu["src"], eu["tgt"],
                                            cfg.qry_max_length,
                                            cfg.max_rule_span)
    need = bd.replicated_footprint_bytes(md["src"], md["tgt"],
                                         cfg.qry_max_length,
                                         cfg.max_rule_span)
    auto = bd.resolve_shards("auto", eu["src"], eu["tgt"], cfg, device)
    paths = write_corpus_files("medium", os.path.join(work, "budget"),
                               {"query.f": _CORPORA["medium"][4]})
    files = [paths[n] for n in ("corpus.f", "query.f", "corpus.e",
                                "corpus.a", "lex.txt")]
    eu_paths = write_corpus_files("europarl", os.path.join(work, "budget_eu"),
                                  {"query.f": _CORPORA["europarl"][4]})
    eu_files = ["--index-dir", index_dir] + [
        eu_paths[n] for n in ("corpus.f", "query.f", "corpus.e", "corpus.a",
                              "lex.txt")]

    def mb(usable):      # the budget whose usable share is ``usable`` bytes
        return {"CGX_DEVICE_MEM_MB":
                str(usable / bd.REF_INDEX_RATIO / 1024**2)}
    out = {k: os.path.join(work, "budget", k) for k in
           ("replicated", "auto", "four", "four_short", "dp")}
    dev = ["--device", device]
    four = dev + ["--sa-shards", "4"] + eu_files
    res = run_clis({
        "replicated": (dev + ["--sa-shards", "0", *files, out["replicated"]],
                       mb(need / 2)),
        "auto": (dev + ["--sa-shards", "auto", *files, out["auto"]],
                 mb(need / 2)),
        "four": (four + [out["four"]], mb(sh["tensor_bytes"] + 4096)),
        "four_short": (four + [out["four_short"]],
                       mb(sh["tensor_bytes"] - 4096)),
        "dp": (dev + ["--dp-devices", "2", *files, out["dp"]], {})})
    four_hash = (grammar_hash(read_grammars(out["four"],
                                            len(_CORPORA["europarl"][4])))
                 if res["four"]["rc"] == 0 else None)
    print(json.dumps({
        "phase": "budget", "device_budget_bytes": bd.device_budget_bytes(
            device),
        "europarl_footprint_bytes": eu_need,
        "europarl_index_tensor_bytes": eu["tensor_bytes"],
        "europarl_run_peak_mem_bytes": eu["peak"],
        "europarl_4_shard_tensor_bytes": sh["tensor_bytes"],
        "europarl_4_shard_run_peak_mem_bytes": sh["peak"],
        "europarl_auto_shards": auto, "medium_footprint_bytes": need,
        "cli": {k: {"rc": r["rc"], "seconds": r["seconds"],
                    "errors": _error_lines(r),
                    "launches": {a: b for a, b in r["launches"].items() if b}}
                for k, r in res.items() if k != "dp"},
        "four_shards_sha256": four_hash,
        "golden_ok": four_hash == golden["europarl"]["sha256"]}), flush=True)
    if eu_need != eu["tensor_bytes"]:
        fail(f"budget: europarl's footprint {eu_need} != its index tensors' "
             f"{eu['tensor_bytes']} bytes")
    if eu_need > eu["peak"]:
        fail(f"budget: europarl's footprint {eu_need} > its run's peak "
             f"{eu['peak']}")
    if auto != 0:
        fail(f"budget: 'auto' resolved europarl to {auto} shards")
    for name, want, why in (
            ("replicated", "error: replicated corpus index", bd.ONE_DEVICE),
            ("auto", "error: replicated corpus index", bd.ONE_DEVICE),
            ("four_short", "error: 4-shard corpus index",
             f" MB on {device}:0 but the device budget is")):
        errs = _error_lines(res[name])
        if res[name]["rc"] != 1 or len(errs) != 1 \
                or not errs[0].startswith(want) or why not in errs[0]:
            fail(f"budget: {name} exited {res[name]['rc']} with "
                 f"{res[name]['stderr'][-5:]}")
        check_launches(f"cli {name} (refused)", (), KERNELS,
                       res[name]["launches"])
    if res["four"]["rc"] != 0 or four_hash != golden["europarl"]["sha256"]:
        fail(f"budget: --sa-shards 4 exited {res['four']['rc']}, hash "
             f"{four_hash}: {res['four']['stderr'][-5:]}")
    launches = check_launches("cli --sa-shards 4", LOAD_RUNS[1][1],
                              others(LOAD_RUNS[1][1]),
                              res["four"]["launches"])
    return launches, res["dp"]


def check_local_dp(cap: Capture, golden: dict, index_dir: str, base: dict,
                   dp_cli: dict, device: str = "cuda") -> dict:
    """3h.  ``LocalDPEngine`` over one card repeated: europarl from its
    index dir over 2 and 3 replicas (``base["loaded"]``: the one-device
    loaded run's launches, peak and wall, and its precomputed rows' bytes)
    and medium, fresh, over 2 with ``lcp_passes`` (``base["medium_lcp"]``):
    each the golden hash and counters, each fanned kernel launched at least
    as often as on one device, no A4 on the loaded runs, and a peak no more
    than the one-device run's plus each further replica's own cached rows
    (the replicas share the index's tensors: ``replica_cache_bytes``);
    ``dp_cli``, the CLI's
    ``--dp-devices 2`` from 3g's batch, must exit non-zero naming the cards
    it exceeds -> the launch counts."""
    import torch
    totals = {k: 0 for k in KERNELS}
    rows = []
    runs = [("europarl", n, False, "loaded") for n in (2, 3)] + \
        [("medium", 2, True, "medium_lcp")]
    for size, n, lcp, key in runs:
        b_launch, b_peak, b_wall, b_cache = base[key]
        expect = [r for k, v in b_launch.items() if v
                  for r in DP_ROUTE.get(k, (k,))]
        launches, res, peak, wall = run_e2e(
            size, device, cap, golden, expect, lcp, others(expect),
            index_dir=index_dir if key == "loaded" else None,
            dp_devices=[torch.device(device, 0)
                        if device == "cuda" else torch.device(device)] * n)
        del res
        fewer = [k for k in expect if launches[k] < b_launch[k]]
        limit = b_peak + (n - 1) * b_cache + 8 * 2**20
        rows.append({"size": size, "replicas": n, "lcp_passes": lcp,
                     "wall_s": wall, "one_device_wall_s": b_wall,
                     "run_peak_mem_bytes": peak,
                     "one_device_run_peak_mem_bytes": b_peak,
                     "peak_limit_bytes": limit,
                     "launches": {k: v for k, v in launches.items() if v},
                     "one_device_launches": {k: v for k, v in
                                             b_launch.items() if v}})
        if fewer:
            fail(f"local dp {size} x{n}: {fewer} launched fewer times than "
                 f"on one device")
        if device == "cuda" and peak > limit:
            fail(f"local dp {size} x{n}: peak {peak} > {limit} (the "
                 f"one-device run's {b_peak})")
        for k, v in launches.items():
            totals[k] += v
    errs = [ln for ln in dp_cli["stderr"] if "exceeds" in ln]
    print(json.dumps({"phase": "local_dp", "runs": rows,
                      "cli_dp2": {"rc": dp_cli["rc"],
                                  "seconds": dp_cli["seconds"],
                                  "errors": _error_lines(dp_cli)}}),
          flush=True)
    if device == "cuda" and (dp_cli["rc"] == 0 or not errs):
        fail(f"cli --dp-devices 2 on one card: exit {dp_cli['rc']}, "
             f"{dp_cli['stderr'][-5:]}")
    return totals


def run_two(size: str, work: str, index_dir: str, device: str = "cuda",
            extra: tuple = ()):
    """Two processes of the CLI (``--coordinator`` on loopback, both on the
    card, ``extra`` arguments) over ``size``'s files and ``index_dir`` ->
    (each process's result from ``run_clis``, the output dir, the
    timefile).  A failure of the process group's bootstrap is retried
    once, a crash never."""
    q_lines = _CORPORA[size][4]
    d = os.path.join(work, f"two_{size}" + ("_composed" if extra else ""))
    paths = write_corpus_files(size, d, {"query.f": q_lines})
    files = [paths[n] for n in ("corpus.f", "query.f", "corpus.e",
                                "corpus.a", "lex.txt")]
    markers = ("DistNetworkError", "Connection refused", "timed out",
               "Address already in use")
    for attempt in range(2):
        out = os.path.join(d, f"out{attempt}")
        timefile = os.path.join(d, f"times{attempt}")
        port = _free_port()
        res = run_clis({pid: (
            ["--device", device, "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid),
             "--index-dir", index_dir, "-s", timefile, *extra, *files,
             out],
            {"GLOO_SOCKET_IFNAME": "lo"}) for pid in (0, 1)})
        boot = any(m in ln for r in res.values() for ln in r["stderr"]
                   for m in markers)
        if all(r["rc"] == 0 for r in res.values()) or attempt or not boot:
            return res, out, timefile


def check_multiprocess(work: str, golden: dict, index_dir: str,
                       round2: tuple, device: str = "cuda") -> dict:
    """3i.  Two CLI processes joined over gloo, both on the card: on
    europarl's index dir (both load), then on medium with a fresh dir
    (process 0 builds and saves it, process 1 waits for its word
    and loads), then the composed mode on europarl's dir, ``--sa-shards
    2``: one shard a process, every query through both.  Each writes its
    contiguous query slice; the union of the files must hash to the
    golden, each stderr name its ``queries [lo, hi)``, the timefile hold
    each process's line with the ``global max-across-processes`` suffix,
    and the processes' launches together the path's kernels (no A4 where
    both load).  In the composed pair each process launches only its own
    shard's kernels: its B2s and B2t half of those of the one-process run
    over ``["cuda:0"] * 2`` (``round2``: its launches, wall and steps per
    dispatch; one launch a step a shard) and its steps per dispatch that
    run's, and the two processes' launches of B2g, B3f, B3b, B3p, B3t,
    B3c, A7v and A8v together that run's -> the launch counts."""
    totals = {k: 0 for k in KERNELS}
    rows = {}
    for name, size, idx, expect, extra in (
            ("europarl", "europarl", index_dir, LOAD_RUNS[0][1], ()),
            ("medium", "medium", os.path.join(work, "two_medium_index"),
             PATH_KERNELS + ("A1", "A9"), ()),
            ("europarl_composed", "europarl", index_dir, LOAD_RUNS[3][1],
             ("--sa-shards", "2"))):
        res, out, timefile = run_two(size, work, idx, device, extra)
        n = len(_CORPORA[size][4])
        ok = all(r["rc"] == 0 for r in res.values())
        ghash = grammar_hash(read_grammars(out, n)) if ok else None
        times = []
        if os.path.exists(timefile):
            with open(timefile, encoding="utf-8") as fh:
                times = fh.read().splitlines()
        both = {k: res[0]["launches"][k] + res[1]["launches"][k]
                for k in KERNELS}
        slices = [[ln for ln in res[p]["stderr"]
                   if ln.startswith(f"multihost: process {p}: queries")]
                  for p in (0, 1)]
        rows[name] = {
            "rc": [res[p]["rc"] for p in (0, 1)],
            "seconds": [res[p]["seconds"] for p in (0, 1)],
            "slices": slices, "timefile": times,
            "launches": [{k: v for k, v in res[p]["launches"].items() if v}
                         for p in (0, 1)],
            "grammar_sha256": ghash,
            "golden_ok": ghash == golden[size]["sha256"]}
        if not ok:
            fail(f"two processes, {name}: exit codes {rows[name]['rc']}: "
                 f"{res[0]['stderr'][-5:]} {res[1]['stderr'][-5:]}")
        if ghash != golden[size]["sha256"]:
            fail(f"two processes, {name}: grammar hash {ghash[:16]} != "
                 f"golden")
        half = -(-n // 2)
        want = [f"multihost: process 0: queries [0, {half}) done; "
                f"{golden[size]['lines']} grammar lines globally",
                f"multihost: process 1: queries [{half}, {n}) done; "
                f"{golden[size]['lines']} grammar lines globally"]
        if [s[-1] if s else None for s in slices] != want:
            fail(f"two processes, {name}: slice lines {slices}")
        if len(times) != 2 or not all(
                " | global max-across-processes: " in t for t in times):
            fail(f"two processes, {name}: timefile {times}")
        local = [t.split(" | ")[0] for t in times]
        loaded = sum("indexload" in t for t in local)
        if loaded != (2 if idx == index_dir else 1) or (
                idx != index_dir and not any("indexsave" in t
                                             for t in local)):
            fail(f"two processes, {name}: index built or loaded wrongly: "
                 f"{local}")
        check_launches(f"two processes, {name}", expect, others(expect),
                       both)
        if extra:
            one = round2[0]
            own = {k: [res[p]["launches"][k] for p in (0, 1)] for k in ROUND}
            shared = {k: both[k] for k in ROUND_KERNELS[2:]}
            rows[name]["one_process_launches"] = {
                k: v for k, v in one.items() if v}
            rows[name]["one_process_wall_s"] = round2[1]
            steps = [res[p]["round_steps"] for p in (0, 1)]
            rows[name]["round_steps"] = steps
            rows[name]["one_process_round_steps"] = round2[2]
            if any(v != [one[k] // 2] * 2 for k, v in own.items()) or any(
                    v != one[k] for k, v in shared.items()):
                fail(f"two processes, {name}: launches {own} {shared}, "
                     f"the one-process 2-shard run's {one}")
            if steps != [round2[2]] * 2:
                fail(f"two processes, {name}: steps per dispatch {steps}, "
                     f"the one-process 2-shard run's {round2[2]}")
        for k in KERNELS:
            totals[k] += both[k]
    print(json.dumps({"phase": "multiprocess", "runs": rows}), flush=True)
    return totals


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
        # 3j. medium unsampled, outside the capture: the kernel rows keep
        # the sampled paths' largest launches
        count(check_unsampled(work))
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
    fp = {}        # per size: toklens, the index's tensor bytes, the peak
    base = {}      # the one-device runs 3h compares with
    for size, lcp, shards, cols, expect, forbid in RUNS:
        # europarl's default run also persists its index (phase 3b)
        saves = size == "europarl" and not (shards or cols)
        listed = isinstance(shards, list)
        key = (size, len(shards) if listed else shards, cols, listed, lcp)
        launches, res, peaks[key], wall = run_e2e(
            size, "cuda", cap, golden, expect, lcp, forbid, shards, cols,
            index_dir=index_dir if saves else None)
        count(launches)
        if not (lcp or shards or cols):
            fp[size] = dict(src=res.index.reflen,
                            tgt=res.index.tgt_str.numel(),
                            tensor_bytes=index_tensor_bytes(res.index),
                            peak=peaks[key])
        if shards and not listed:
            fp[f"{size}_sharded"] = dict(
                tensor_bytes=index_tensor_bytes(res.index),
                peak=peaks[key])
        if lcp:
            base["medium_lcp"] = (launches, peaks[key], wall,
                                  replica_cache_bytes(res.index))
        if saves:
            check_index_dir(res, index_dir)
            count(check_lcp_passes(res))
            # 4. query-DP on the same index, queries and blocks; 4b.
            # A9 on its lexicon as dense tables
            count(check_query_dp(res, cap))
            count(check_dense_large(res, cap))
        if shards and not listed:
            shard_offsets = [int(o) for o in res.index.src_off]
        if shards:
            sharded_memory(size, shards, res.index, peaks[key],
                           peaks[(size, 0, False, False, False)], wall)
        del res
    # 3c. europarl from its persisted index, replicated and sharded (on
    # one device, and on the card repeated 4 and 2 times)
    first3 = None
    for shards, expect in LOAD_RUNS:
        launches, res, peak, wall = run_e2e(
            "europarl", "cuda", cap, golden, expect, forbid=others(expect),
            sa_shards=shards, index_dir=index_dir)
        count(launches)
        if not shards:
            first3 = res.per_query_lines[:3]
            base["loaded"] = (launches, peak, wall,
                              replica_cache_bytes(res.index))
        elif isinstance(shards, list):
            sharded_memory("europarl (index loaded)", shards, res.index,
                           peak, base["loaded"][1], wall)
            base[f"round{len(shards)}"] = (launches, wall,
                                           [r["T"] for r in cap.rounds])
        del res
    # 3d. a server over that index; 3e. medium's queries in four batches;
    # 3f. medium through the CLI under --profile
    count(check_serve(index_dir, work, golden, first3, LOAD_RUNS[0][1]))
    launches, res, _, _ = run_e2e("medium", "cuda", cap, golden,
                                  OVERLAP_KERNELS,
                                  forbid=others(OVERLAP_KERNELS),
                                  query_batches=4)
    count(launches)
    del res
    count(check_profile(work, golden))
    # 3g. the device budget; 3h. local DP over the card repeated; 3i. two
    # processes on the card
    launches, dp_cli = check_budget(work, golden, fp, index_dir)
    count(launches)
    count(check_local_dp(cap, golden, index_dir, base, dp_cli))
    count(check_multiprocess(work, golden, index_dir, base["round2"]))
    return shard_offsets


def sharded_memory(size: str, shards, index, peak: int, replicated_peak: int,
                   wall: float):
    """The line of a sharded run's memory: each shard's bytes
    (``memory_per_device``), each device's (``bytes_per_device``), the run's
    own peak beside the replicated run's, and its wall."""
    print(json.dumps({
        "phase": "sharded_memory", "size": size,
        "sa_shards": shards, "listed": index.listed,
        "bytes_per_shard": index.memory_per_device(),
        "bytes_per_device": index.bytes_per_device(),
        "run_peak_mem_bytes": peak,
        "replicated_run_peak_mem_bytes": replicated_peak,
        "wall_s": wall}), flush=True)


if __name__ == "__main__":
    main()
