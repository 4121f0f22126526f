#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cgx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each on stdout:

1. card   -- the card's name and power limit (nvidia-smi) and torch's name;
2. build  -- nvcc builds every kernel of the main path from csrc/, one
   process per source, all at once;
3. e2e    -- ``cgx_tpu_torch.pipeline.run_pipeline(..., device="cuda")`` on
   the ``medium`` corpus (20k sentences, 32 queries; dense MaxLex tables, so
   kernel A9) and the ``europarl`` corpus (1M sentences, 20k vocabulary, 64
   queries; row-range tables, so A10), both made from seeds by the generators
   in tools/, then medium again with ``lcp_passes=True``.  Each run must
   launch its path's kernels (launch counts reset just before it: A1 or B1's
   two passes, A4, A2 forward and backward, A3, A5, A6, A7, A8 and A9 or
   A10; the LCP run must not launch A1), its counters must equal the JAX
   package's and its grammar hash the golden in
   tests/golden_torch_hashes.json (the JAX package's full grammar).  On
   europarl's index and queries both LCP passes must then give the
   refinement's up, down and longestmatch;
4. kernels -- each kernel against its plain PyTorch version on the card, on
   the inputs of its largest launch in phase 3 (A2 once per direction, B1
   once per pass): the outputs must be bit-equal (float32 compared by bit
   pattern); times of both, and the least time the card could take for the
   same work (``bound_ms``: the larger of the bytes over the memory rate and
   the integer operations over the peak rate, counted per item from the
   kernel's loops, see ``WORK``), and the time of one launch on one item.

Then a JSON line with every kernel's numbers, and last the line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before it.
The script imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden_torch_hashes.json")

# kernel id -> (source in the repo, file:line of the JAX function it replaces:
# _refine_chunk_local, _gc_batch, _scan_batch_exp (forward, backward),
# _pcs_batch_exp, _two_batch_exp, _contig_batch, _onegap_batch,
# _twogap_batch, _accum_batch_dense, _accum_batch_range, _pass1_batch,
# _pass2_batch)
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
    "A10": ("cgx_tpu_torch/csrc/maxlex.cu", "cgx_tpu/features/maxlex.py:216"),
    "B1p1": ("cgx_tpu_torch/csrc/lcp.cu", "cgx_tpu/search/passes.py:221"),
    "B1p2": ("cgx_tpu_torch/csrc/lcp.cu", "cgx_tpu/search/passes.py:229"),
}
# the kernels every end-to-end run must launch, besides its pass-1/2 and
# MaxLex kernels
PATH_KERNELS = ("A4", "A2f", "A2b", "A3", "A5", "A6", "A7", "A8")

# The least time the card could take for a kernel's work: the larger of the
# bytes it must move over the memory rate and its integer operations over the
# peak rate (one H100 SXM: 3.35 TB/s, and 67 T/s, the data sheet's rate
# outside the tensor cores).  Per kernel id: (words read per item from the
# item-axis inputs, words gathered per item from the index, words written
# per item, integer operations per item), each counted once from the
# kernel's loops (the csrc notes); the per-pattern tables are counted once
# whole.  The searches' gathers depend on the data and are counted from
# this run's inputs in ``work``.
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
WORK = {
    "A4": (1, 33, 1, 1700),      # mrs + 2 RLP words, 16 lr_tar words
    "A2f": (0, 52, 1, 2000),     # SA word, 18 corpus words, the gap check
    "A2b": (0, 52, 1, 2000),
    "A3": (0, 6, 1 / 32, 40),    # one occurrence row, 4 corpus words
    "A5": (0, 52, 1, 1850),      # occurrence row, 17 corpus words, gap check
    "A6": (2, 101, 8, 3000),     # SA word, RLP and target windows
    "A7": (4, 100, 6, 2000),
    "A8": (6, 70, 2, 300),       # 3 x 16 RLP, 16 lr_tar, 3 sentence anchors
    "A9": (11, 48, 2, 200),      # 16 target tokens, 2 x 16 table probes
    "A10": (11, 48, 2, 200),
}
# argument positions of the per-pattern table and count prefix
TABLE_ARGS = {"A2f": (4, 5), "A2b": (4, 5), "A3": (2, 3), "A5": (5, 6)}


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
    each kernel's largest launch (for phase 4) and the items per kernel
    since ``items`` was last cleared."""

    def __init__(self):
        from cgx_tpu_torch.extract import device as xdev
        from cgx_tpu_torch.features import maxlex as ml
        from cgx_tpu_torch.search import lookup, passes
        from cgx_tpu_torch.search import precompute as pcx
        # wrapper -> (kernel id of a call, item count of a call)
        self.sites = {
            (passes, "refine_chunk"): (lambda a: "A1", lambda a: a[3].shape[0]),
            (pcx, "gap_check"): (lambda a: "A4", lambda a: a[2].shape[0]),
            (lookup, "scan"): (lambda a: "A2f" if a[9] else "A2b",
                               lambda a: a[6]),
            (lookup, "pcs"): (lambda a: "A3", lambda a: a[4]),
            (lookup, "two"): (lambda a: "A5", lambda a: a[7]),
            (xdev, "contig"): (lambda a: "A6", lambda a: a[4].shape[0]),
            (xdev, "onegap"): (lambda a: "A7", lambda a: a[3].shape[0]),
            (xdev, "twogap"): (lambda a: "A8", lambda a: a[3].shape[0]),
            (ml, "accum_dense"): (lambda a: "A9", lambda a: a[4].shape[0]),
            (ml, "accum_range"): (lambda a: "A10", lambda a: a[7].shape[0]),
            (passes, "pass1"): (lambda a: "B1p1", lambda a: a[5].shape[0]),
            (passes, "pass2"): (lambda a: "B1p2", lambda a: a[5].shape[0]),
        }
        self.calls = {}          # kernel -> (n, args)
        self.items = {}          # kernel -> items
        self.originals = {site: getattr(*site) for site in self.sites}

    def __enter__(self):
        for site, (kernel_of, count_of) in self.sites.items():
            real = self.originals[site]

            def hook(*args, _real=real, _k=kernel_of, _n=count_of):
                k, n = _k(args), _n(args)
                self.items[k] = self.items.get(k, 0) + n
                if n > self.calls.get(k, (-1, None))[0]:
                    self.calls[k] = (n, args)
                return _real(*args)
            setattr(*site, hook)
        return self

    def __exit__(self, *exc):
        for site, real in self.originals.items():
            setattr(*site, real)


_CORPORA = {}


def run_e2e(size: str, device: str, capture: Capture, golden: dict,
            expect: tuple, lcp_passes: bool = False, forbid: tuple = ()):
    """One end-to-end run -> (its launch counts, its PipelineResult)."""
    import torch
    from cgx_tpu_torch.config import DEFAULT_CONFIG
    from cgx_tpu_torch.kernels import build as kb
    from cgx_tpu_torch.pipeline import run_pipeline
    t0 = time.perf_counter()
    if size not in _CORPORA:
        _CORPORA[size] = make_corpus(size)
    data = _CORPORA[size]
    gen_s = time.perf_counter() - t0
    kb.LAUNCHES.clear()
    capture.items.clear()
    t0 = time.perf_counter()
    res = run_pipeline(*data, DEFAULT_CONFIG, device=device,
                       lcp_passes=lcp_passes)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kb.LAUNCHES[k] for k in KERNELS}
    missing = [k for k in expect if launches[k] == 0]
    if missing:
        fail(f"{size}: kernels {missing} never launched on the main path "
             f"(launches {launches})")
    stray = [k for k in forbid if launches[k] != 0]
    if stray:
        fail(f"{size}: kernels {stray} launched on a path without them "
             f"(launches {launches})")
    lines = res.per_query_lines
    ok_shape = len(lines) == len(data[4]) and all(
        ln.startswith("[X] ||| ") for q in lines for ln in q)
    ghash = grammar_hash(lines)
    want = golden[size]
    counters_off = {k: (res.counters[k], v) for k, v in want.items()
                    if k in res.counters and res.counters[k] != v}
    lines_ok = res.counters["total_lines"] == want["lines"]
    print(json.dumps({
        "phase": "e2e", "size": size, "device": device,
        "lcp_passes": lcp_passes,
        "corpus_gen_s": gen_s, "wall_s": wall,
        "phases_s": res.timing.as_dict(),
        "peak_mem_bytes": res.timing.peak_memory(),
        "counters": res.counters, "launches": launches,
        "items": dict(capture.items),
        "grammar_sha256": ghash, "golden_ok": ghash == want["sha256"]}),
        flush=True)
    if not ok_shape:
        fail(f"{size}: malformed grammar lines")
    if counters_off or not lines_ok:
        fail(f"{size}: counters (port, JAX) differ: {counters_off}, lines "
             f"{res.counters['total_lines']} vs {want['lines']}")
    if ghash != want["sha256"]:
        fail(f"{size}: grammar hash {ghash[:16]} != golden "
             f"{want['sha256'][:16]}")
    return launches, res


def check_lcp_passes(res):
    """Both LCP passes on a run's index and queries give the refinement's
    up, down and longestmatch (pass 2: every range)."""
    import numpy as np
    import torch
    from cgx_tpu_torch.search import passes
    t0 = time.perf_counter()
    r1, r2 = passes.refine_passes(res.index, res.queries)
    t1 = time.perf_counter()
    l1 = passes.pass1_lcp(res.index, res.queries)
    l2 = passes.pass2_lcp(res.index, res.queries, l1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    off = [f for f in ("up", "down", "longestmatch")
           if not np.array_equal(getattr(l1, f), getattr(r1, f))]
    off += [f"pass2.{f}" for f in ("connectoffset", "up", "down")
            if not np.array_equal(getattr(l2, f), getattr(r2, f))]
    print(json.dumps({
        "phase": "lcp_passes", "reflen": res.index.reflen,
        "pass1_tokens": len(l1.up), "pass2_items": len(l2.up),
        "refine_s": t1 - t0, "lcp_s": t2 - t1, "equal": not off}),
        flush=True)
    if off:
        fail(f"LCP passes differ from the refinement in {off}")


def _time_ms(fn, device) -> float:
    """Mean milliseconds per call on the device timeline (events around a
    run of calls after one warm-up call)."""
    import torch
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
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
    return start.elapsed_time(end) / reps


def _log2(x):
    """ceil(log2(x + 1)) per element of an int tensor: bisection steps."""
    import torch
    return torch.ceil(torch.log2(x.double().clamp(min=0) + 1))


def work(k: str, n: int, args) -> tuple:
    """(bytes, integer operations) that kernel ``k`` must move and do on
    the inputs of one launch over ``n`` items (see ``WORK``)."""
    if k == "A1":          # per depth a query token, two bisections
        depths = args[8]
        steps = 2 * _log2(args[6] - args[5])
        gathered = float((depths + 2 * steps).sum())
        nbytes = 4 * (n * (4 + 2 * depths + 2) + gathered)
        return nbytes, 8 * gathered
    if k in ("B1p1", "B1p2"):   # ~5 words per search step, both walks
        if k == "B1p1":
            steps = _log2(args[0].new_full((n,), args[7]))
            io = 2 + 6
        else:
            steps = _log2(args[9] - args[7])
            io = 5 + 2
        gathered = float((5 * steps + 2 * 2 * steps).sum())
        return 4 * (n * io + gathered), 10 * gathered
    w_in, w_gather, w_out, ops = WORK[k]
    tables = sum(args[i].numel() for i in TABLE_ARGS.get(k, ()))
    nbytes = 4 * (n * (w_in + w_gather + w_out) + tables)
    return nbytes, n * ops


def compare_kernels(capture: Capture, device: str, launches: dict) -> list:
    import torch
    from cgx_tpu_torch.extract import device as xdev
    from cgx_tpu_torch.features import maxlex as ml
    from cgx_tpu_torch.search import lookup, passes
    from cgx_tpu_torch.search import precompute as pcx
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
             "A10": (ml.accum_range, ml.accum_range_plain),
             "B1p1": (passes.pass1, passes.pass1_plain),
             "B1p2": (passes.pass2, passes.pass2_plain)}
    rows = []
    for k, (kernel, plain) in pairs.items():
        if k not in capture.calls:
            fail(f"{k}: no launch captured on the main path")
        n, args = capture.calls[k]

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
        ms = _time_ms(lambda: kernel(*args), device)
        plain_ms = _time_ms(lambda: plain(*args), device)
        src, replaces = KERNELS[k]
        nbytes, ops = work(k, n, args)
        bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
        ops_ms = ops / OPS_PER_S * 1e3
        row = {"name": k, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[k],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": None}
        print(json.dumps({"phase": "kernel", **row, "lanes": n,
                          "bytes": nbytes, "ops": ops, "bit_equal": True}),
              flush=True)
        rows.append(row)
    return rows


def launch_floor(capture: Capture, device: str):
    """The time of one launch that does almost no work: A8 (plain C entry,
    ctypes) on the first item of its captured inputs, the floor under every
    kernel time above."""
    from cgx_tpu_torch.extract import device as xdev
    args = list(capture.calls["A8"][1])
    args[3:9] = [a[:1].contiguous() for a in args[3:9]]
    ms = _time_ms(lambda: xdev.twogap(*args), device)
    print(json.dumps({"phase": "launch_floor", "kernel": "A8", "items": 1,
                      "ms": ms}), flush=True)


def main():
    import torch
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
                            if "registers" in ln or "spill" in ln]
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "ptxas": ptxas}), flush=True)

    # 3. end to end (the launch counts of the main path)
    with open(GOLDEN, encoding="utf-8") as fh:
        golden = json.load(fh)
    totals = {k: 0 for k in KERNELS}
    with Capture() as cap:
        for size, lcp, expect, forbid in (
                ("medium", False, ("A1", "A9"), ("B1p1", "B1p2")),
                ("europarl", False, ("A1", "A10"), ("B1p1", "B1p2")),
                ("medium", True, ("B1p1", "B1p2", "A9"), ("A1",))):
            launches, res = run_e2e(size, "cuda", cap, golden,
                                    PATH_KERNELS + expect, lcp, forbid)
            for k, v in launches.items():
                totals[k] += v
            if size == "europarl":
                check_lcp_passes(res)
            del res

    # 4. kernels against their plain versions at the main path's shapes
    rows = compare_kernels(cap, "cuda", totals)
    launch_floor(cap, "cuda")

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "cgx_tpu"))
    if leaked:
        fail(f"the port imported {leaked[:5]}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
